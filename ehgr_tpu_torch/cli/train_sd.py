"""Stage-2 self-distillation trainer CLI (counterpart of
``cli/train_sd.py``; ref ``train_sd.py``, recipe ``sh/train_ego.sh:16``):
per-exit CE + KD(T=3) + masked-L2 hints, initialized non-strict from a
Stage-1 checkpoint through ``--checkpoint_path``.

  python -m ehgr_tpu_torch.cli.train_sd --preset ego_sd \
      --checkpoint_path <mtmm .pth> --annot_path <dir> [--synthetic] \
      [--device cuda|cpu]
"""

import sys

from ehgr_tpu_torch.cli import train


def main(argv=None):
    return train.main(argv, default_preset="ego_sd", stage="sd")


if __name__ == "__main__":
    print(main(sys.argv[1:]))
