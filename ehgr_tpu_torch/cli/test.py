"""Multi-clip evaluation CLI (counterpart of ``cli/test.py``): 10 random
clips per video, softmax-mean voting, top-1/5 and a confusion matrix.

  python -m ehgr_tpu_torch.cli.test --preset ego_baseline \
      --checkpoint_path <file.pth> --annot_path <dir> [--synthetic] \
      [--device cuda|cpu]

The flags are those of ``cli/test.py``, plus ``--device`` (default
``cuda``).
"""

import argparse
import sys


def main(argv=None, default_preset: str = "ego_baseline", arch: str = "tsn",
         heads: int = 1):
    from ehgr_tpu_torch.configs import config_from_args
    from ehgr_tpu_torch.eval.runner import run_test

    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda")
    args, rest = dev.parse_known_args(
        sys.argv[1:] if argv is None else list(argv))
    cfg = config_from_args(rest, default_preset=default_preset)
    res = run_test(cfg, arch=arch, heads=heads, device=args.device)
    res.pop("confusion", None)
    return res


if __name__ == "__main__":
    print(main())
