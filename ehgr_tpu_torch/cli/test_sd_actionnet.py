"""Slimmer SD evaluation CLI (counterpart of
``cli/test_sd_actionnet.py``; ref ``test_sd_actionnet.py``): per-exit
top-1/5 of the SD model's four heads, without confusion matrices.  The
port's ``test_sd`` already returns its result without them, so this is
``test_sd`` under another name.

  python -m ehgr_tpu_torch.cli.test_sd_actionnet --preset ego_sd \
      --checkpoint_path <file.pth> --annot_path <dir> [--synthetic] \
      [--device cuda|cpu]
"""

from ehgr_tpu_torch.cli.test_sd import main

__all__ = ["main"]


if __name__ == "__main__":
    print(main())
