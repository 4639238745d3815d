"""Joint MTMM+SD trainer CLI (counterpart of ``cli/train_mtmm_sd.py``; ref
``train_mtmm_sd.py``, recipe ``sh/train_ego.sh:20``): the SD losses plus
0.01 * MSE of the global transposed decoder's map against the current
clip's depth, one backbone traversal, warm-started non-strict from a
Stage-1 checkpoint through ``--checkpoint_path``.

  python -m ehgr_tpu_torch.cli.train_mtmm_sd --preset ego_mtmm_sd \
      --checkpoint_path <mtmm .pth> --annot_path <dir> [--synthetic] \
      [--device cuda|cpu]
"""

import sys

from ehgr_tpu_torch.cli import train


def main(argv=None):
    return train.main(argv, default_preset="ego_mtmm_sd", stage="mtmm_sd")


if __name__ == "__main__":
    print(main(sys.argv[1:]))
