"""Qualitative case-study exporter CLI (counterpart of
``cli/case_study.py``; ref ``case_study.py``): annotated GIFs of the first
ten test videos under ``<run_dir>/case_study``.

  python -m ehgr_tpu_torch.cli.case_study --preset ego_baseline \
      --checkpoint_path <file.pth> --annot_path <dir> [--synthetic] \
      [--device cuda|cpu]

The flags are those of ``cli/case_study.py``, plus ``--device`` (default
``cuda``).
"""

import argparse
import os
import sys


def main(argv=None):
    from ehgr_tpu_torch.configs import config_from_args
    from ehgr_tpu_torch.data.factory import build_test_dataset
    from ehgr_tpu_torch.eval.case_study import export_case_study
    from ehgr_tpu_torch.eval.runner import _build_model

    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda")
    args, rest = dev.parse_known_args(
        sys.argv[1:] if argv is None else list(argv))
    cfg = config_from_args(rest, default_preset="ego_baseline")
    model, _ = _build_model(cfg, "tsn", args.device)
    dataset = build_test_dataset(cfg)
    out_dir = os.path.join(cfg.run.run_dir, "case_study")
    return export_case_study(model, dataset, out_dir, mean=cfg.data.mean,
                             std=cfg.data.std)


if __name__ == "__main__":
    print(main())
