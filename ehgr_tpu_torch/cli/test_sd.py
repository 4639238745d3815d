"""SD-model evaluation CLI (counterpart of ``cli/test_sd.py``): the final
head and the three middle exits, top-1/5 with a confusion matrix each.

  python -m ehgr_tpu_torch.cli.test_sd --preset ego_sd \
      --checkpoint_path <file.pth> --annot_path <dir> [--synthetic] \
      [--device cuda|cpu]
"""

import sys

from ehgr_tpu_torch.cli import test


def main(argv=None):
    return test.main(argv, default_preset="ego_sd", arch="tsn_sd", heads=4)


if __name__ == "__main__":
    print(main(sys.argv[1:]))
