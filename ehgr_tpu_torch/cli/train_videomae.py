"""VideoMAE fine-tune CLI (counterpart of ``cli/train_videomae.py``; ref
``train_videomae.py``: HF Trainer over ``VideoMAEForVideoClassification``,
16-frame clips): VideoMAE-Base (or ``--vit DIM DEPTH HEADS``), one
parameter group, stage ``baseline``.  An odd ``--clip_len`` becomes 16.

  python -m ehgr_tpu_torch.cli.train_videomae --preset ego_baseline \
      --clip_len 16 --annot_path <dir> [--synthetic] [--device cuda|cpu]

The flags are those of ``cli/train_videomae.py``, plus ``--device``
(default ``cuda``).  ``--checkpoint_path`` loads a port state dict
non-strictly; to start from HF pretraining, load the HF state dict into the
model with ``ehgr_tpu_torch.models.videomae.convert_hf_videomae`` and save
its ``state_dict()`` as that file.
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
    clip_len = cfg.data.clip_len if cfg.data.clip_len % 2 == 0 else 16
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, clip_len=clip_len),
        model=dataclasses.replace(cfg.model, arch="videomae",
                                  num_segments=clip_len, is_shift=False),
        optim=dataclasses.replace(cfg.optim, policies=False),
    ).validate()
    train_ds, val_ds = build_train_datasets(cfg, "baseline")
    return run_training(cfg, "baseline", train_ds, val_ds,
                        device=args.device)


if __name__ == "__main__":
    print(main())
