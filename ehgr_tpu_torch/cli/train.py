"""Baseline ACTION-Net trainer CLI (counterpart of ``cli/train.py``; ref
``train.py``, recipe ``sh/train_ego.sh:4``).

  python -m ehgr_tpu_torch.cli.train --preset ego_baseline \
      --annot_path <dir> [--synthetic] [--device cuda|cpu]

The flags are those of ``cli/train.py``, plus ``--device`` (default
``cuda``).
"""

import argparse
import sys


def main(argv=None, default_preset: str = "ego_baseline",
         stage: str = "baseline"):
    from ehgr_tpu_torch.configs import config_from_args
    from ehgr_tpu_torch.data.factory import build_train_datasets
    from ehgr_tpu_torch.train.loop import run_training

    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda")
    args, rest = dev.parse_known_args(
        sys.argv[1:] if argv is None else list(argv))
    cfg = config_from_args(rest, default_preset=default_preset)
    train_ds, val_ds = build_train_datasets(cfg, stage)
    return run_training(cfg, stage, train_ds, val_ds, device=args.device)


if __name__ == "__main__":
    print(main())
