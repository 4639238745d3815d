"""Early-exit cascade evaluation CLI (counterpart of
``cli/test_cascade.py``): exit-K for every video, the full net only below
a confidence threshold, and the whole threshold operating curve printed.

  python -m ehgr_tpu_torch.cli.test_cascade --preset ego_sd \
      --checkpoint_path <sd_ckpt.pth> [--synthetic] [--cascade_exit 1] \
      [--device cuda|cpu]
"""

import argparse
import sys


def main(argv=None):
    from ehgr_tpu_torch.configs import config_from_args
    from ehgr_tpu_torch.eval.cascade import run_cascade_test

    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--cascade_exit", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args, rest = p.parse_known_args(
        sys.argv[1:] if argv is None else list(argv))
    cfg = config_from_args(rest, default_preset="ego_sd")
    return run_cascade_test(cfg, exit_k=args.cascade_exit,
                            device=args.device)


if __name__ == "__main__":
    print(main())
