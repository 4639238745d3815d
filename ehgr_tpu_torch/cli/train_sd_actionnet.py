"""SD-from-ACTION-Net trainer CLI (counterpart of
``cli/train_sd_actionnet.py``; ref ``train_sd_actionnet.py``, recipe
``sh/train_ego.sh:17``): the loss structure of ``train_sd``, with the
teacher weights from a plain baseline (83-class ACTION-Net) checkpoint
rather than an MTMM one.  The difference is only which checkpoint is
passed, so this is ``train_sd`` under another name.

  python -m ehgr_tpu_torch.cli.train_sd_actionnet --preset ego_sd \
      --checkpoint_path <baseline .pth> --annot_path <dir> [--synthetic] \
      [--device cuda|cpu]
"""

import sys

from ehgr_tpu_torch.cli.train_sd import main

__all__ = ["main"]


if __name__ == "__main__":
    print(main(sys.argv[1:]))
