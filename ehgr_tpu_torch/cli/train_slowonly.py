"""SlowOnly baseline trainer CLI (counterpart of ``cli/train_slowonly.py``;
ref ``train_slowonly.py``, recipe ``sh/train_ego.sh:7``): SlowFast's Slow
pathway at R50 depth, one parameter group (plain SGD with momentum and
weight decay), stage ``baseline``.

  python -m ehgr_tpu_torch.cli.train_slowonly --preset ego_baseline \
      --annot_path <dir> [--synthetic] [--device cuda|cpu]

The flags are those of ``cli/train_slowonly.py``, plus ``--device``
(default ``cuda``).
"""

import argparse
import dataclasses
import sys


def main(argv=None):
    from ehgr_tpu_torch.configs import config_from_args
    from ehgr_tpu_torch.data.factory import build_train_datasets
    from ehgr_tpu_torch.train.loop import run_training

    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda")
    args, rest = dev.parse_known_args(
        sys.argv[1:] if argv is None else list(argv))
    cfg = config_from_args(rest, default_preset="ego_baseline")
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, arch="slowonly"),
        optim=dataclasses.replace(cfg.optim, policies=False),
    ).validate()
    train_ds, val_ds = build_train_datasets(cfg, "baseline")
    return run_training(cfg, "baseline", train_ds, val_ds,
                        device=args.device)


if __name__ == "__main__":
    print(main())
