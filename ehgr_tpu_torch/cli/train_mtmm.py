"""Stage-1 MTMM trainer CLI (counterpart of ``cli/train_mtmm.py``; ref
``train_mtmm.py``, recipe ``sh/train_ego.sh:13``): CE + 0.01 * MSE on the
next segment's depth.

  python -m ehgr_tpu_torch.cli.train_mtmm --preset ego_mtmm \
      --modal rgb_depth --annot_path <dir> [--synthetic] \
      [--device cuda|cpu]
"""

import sys

from ehgr_tpu_torch.cli import train


def main(argv=None):
    return train.main(argv, default_preset="ego_mtmm", stage="mtmm")


if __name__ == "__main__":
    print(main(sys.argv[1:]))
