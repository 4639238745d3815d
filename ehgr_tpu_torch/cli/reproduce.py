"""Reproduction harness, one command per BASELINE.md row (counterpart of
``cli/reproduce.py``).

Maps every reference headline number to its full invocation chain,
prepare_data -> train stage(s) -> test, each stage the port's CLI
(``ehgr_tpu_torch.cli.<verb>``), with the expected top-1 asserted at the
end and a wall-clock estimate from the port's measured H100 rates:

  python -m ehgr_tpu_torch.cli.reproduce --list       # rows + ETA + chains
  python -m ehgr_tpu_torch.cli.reproduce --row ego_mtmm \
      --frame_path <frames> --label_path <labels> --annot_path <dir> \
      --work_dir <dir>
  python -m ehgr_tpu_torch.cli.reproduce --row nv_mtmm_sd \
      --dataset_path <nv root> --annot_path <dir> --work_dir <dir>
  python -m ehgr_tpu_torch.cli.reproduce --row ego_mtmm_sd --smoke
                                                       # synthetic dress run

``--device`` (default ``cuda``) goes to every train and test stage.
Reference chains: ``sh/train_ego.sh`` / ``sh/train_nv.sh`` /
``sh/test_ego.sh`` / ``sh/test_nv.sh`` (stage order and flags), expected
numbers from the ``runs/**/test.log`` lines quoted in BASELINE.md.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

# The port's rates on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit,
# read from chip_smoke.py (PERF.md); estimates scale from these.  Train:
# its loop_mtmm phase, cli.train_mtmm on the recipe's 8 clips a step
# (bf16, the 'vjp' kernel region), 128 clips over the train parts of two
# epochs (41.89 and 34.79 clips/s), host bound.  Test: its test_ego phase,
# run_test at 10 clips a video over the whole run, bound by the host
# loader (the synthetic clips are rendered in numpy; a JPEG decode of the
# real datasets is not measured on the card's host).
TRAIN_CLIPS_PER_S = 38.0
EVAL_CLIPS_PER_S = 51.5
EGO_TRAIN_CLIPS = 19_184          # train_plus_val (BASELINE.md)
EGO_TEST_VIDEOS = 2_081
NV_TRAIN_CLIPS = 1_050
NV_TEST_VIDEOS = 482


@dataclasses.dataclass(frozen=True)
class Stage:
    verb: str                     # cli module suffix, e.g. "train_mtmm"
    argv: tuple                   # extra args beyond the dataset paths
    uses_ckpt_from: int = -1      # index of earlier stage providing --checkpoint_path


@dataclasses.dataclass(frozen=True)
class Row:
    name: str
    baseline_row: str             # BASELINE.md description
    expected_top1: float          # reference number to match
    tolerance: float              # acceptance band (seed-to-seed spread)
    dataset: str                  # "ego" | "nv"
    train_epochs: int
    stages: tuple                 # Stage chain after prepare_data
    heads: int = 1                # eval heads (4 for SD chains)


def _ego(name, desc, top1, tol, stages, heads=1):
    return Row(name, desc, top1, tol, "ego", 25, stages, heads)


def _nv(name, desc, top1, tol, stages, heads=1):
    return Row(name, desc, top1, tol, "nv", 80, stages, heads)


ROWS = {r.name: r for r in [
    _ego("ego_baseline",
         "EgoGesture ACTION-Net baseline (runs/EgoGesture/Paper/.../test.log:2)",
         94.53, 0.5,
         (Stage("train", ("--preset", "ego_baseline")),
          Stage("test", ("--preset", "ego_baseline"), uses_ckpt_from=0))),
    _ego("ego_mtmm",
         "EgoGesture MTMM (runs/EgoGesture/MTMM/2023-5-16.../test.log:2)",
         95.20, 0.5,
         (Stage("train_mtmm", ("--preset", "ego_mtmm", "--modal", "rgb_depth")),
          Stage("test", ("--preset", "ego_mtmm"), uses_ckpt_from=0))),
    _ego("ego_mtmm_depthest",
         "EgoGesture MTMM w/ pseudo-depth (runs/.../rgb_depthest/test.log:2)",
         95.06, 0.6,
         (Stage("train_mtmm",
                ("--preset", "ego_mtmm", "--modal", "rgb_depthest")),
          Stage("test", ("--preset", "ego_mtmm"), uses_ckpt_from=0))),
    _ego("ego_mtmm_sd",
         "EgoGesture MTMM+SD final exit (runs/EgoGesture/SD/.../test.log:4)",
         95.26, 0.5,
         (Stage("train_mtmm", ("--preset", "ego_mtmm", "--modal", "rgb_depth")),
          Stage("train_sd", ("--preset", "ego_sd"), uses_ckpt_from=0),
          Stage("test_sd", ("--preset", "ego_sd"), uses_ckpt_from=1)),
         heads=4),
    _ego("ego_action_sd",
         "EgoGesture ACTION-Net+SD final exit (runs/.../ACTION-Net_SD/test.log:2)",
         95.58, 0.5,
         (Stage("train", ("--preset", "ego_baseline")),
          Stage("train_sd", ("--preset", "ego_sd"), uses_ckpt_from=0),
          Stage("test_sd", ("--preset", "ego_sd"), uses_ckpt_from=1)),
         heads=4),
    _nv("nv_baseline",
        "NvGesture baseline, 3-crop 256 (runs/NVGesture/Baseline/.../test.log:2)",
        82.78, 1.7,       # seeds spread 81.12-82.78
        (Stage("train", ("--preset", "nv_baseline")),
         Stage("test", ("--preset", "nv_baseline"), uses_ckpt_from=0))),
    _nv("nv_mtmm",
        "NvGesture MTMM (runs/NVGesture/MTMM/.../test.log:2)",
        81.33, 1.5,
        (Stage("train_mtmm", ("--preset", "nv_mtmm", "--modal", "rgb_depth")),
         Stage("test", ("--preset", "nv_mtmm"), uses_ckpt_from=0))),
    _nv("nv_mtmm_sd",
        "NvGesture MTMM+SD (runs/NVGesture/SD/.../test.log:2)",
        85.06, 1.1,       # seeds spread 84.02-85.06
        (Stage("train_mtmm", ("--preset", "nv_mtmm", "--modal", "rgb_depth")),
         Stage("train_sd", ("--preset", "nv_sd"), uses_ckpt_from=0),
         Stage("test_sd", ("--preset", "nv_sd"), uses_ckpt_from=1)),
        heads=4),
]}


def eta_seconds(row: Row) -> float:
    clips = EGO_TRAIN_CLIPS if row.dataset == "ego" else NV_TRAIN_CLIPS
    vids = EGO_TEST_VIDEOS if row.dataset == "ego" else NV_TEST_VIDEOS
    train_stages = sum(1 for s in row.stages if s.verb.startswith("train"))
    train_s = train_stages * row.train_epochs * clips / TRAIN_CLIPS_PER_S
    eval_s = vids * 10 / EVAL_CLIPS_PER_S     # 10-clip protocol
    return train_s + eval_s


def _fmt_eta(s: float) -> str:
    return f"{s / 3600:.1f} h" if s >= 3600 else f"{s / 60:.0f} min"


def _chain_argv(row: Row, args) -> list:
    """Resolve the row into concrete (module, argv) pairs."""
    out = []
    if not args.smoke:
        if row.dataset == "ego":
            prep = ["ego", "--frame_path", args.frame_path,
                    "--label_path", args.label_path,
                    "--save_path", args.annot_path]
            if any("depthest" in a for st in row.stages for a in st.argv):
                prep.append("--pseudo_depth")
        else:
            prep = ["nv", "--dataset_path", args.dataset_path,
                    "--save_path", args.annot_path]
        out.append(("prepare_data", prep))
    for si, st in enumerate(row.stages):
        argv = list(st.argv)
        if args.smoke:
            argv += ["--synthetic", "--clip_len", "4", "--batch_size", "4",
                     "--epochs", "1", "--crop_size", "32",
                     "--scale_size", "32", "--train_crop_size", "32",
                     "--clip_num", "2", "--test_crops", "1"]
        else:
            argv += ["--annot_path", args.annot_path]
        argv += ["--model_name", f"repro_{row.name}_s{si}"]
        out.append((st.verb, argv))
    return out


def run_row(row: Row, args) -> dict:
    """Execute the chain in-process on ``args.device``; returns the final
    eval metrics and each train stage's last loss."""
    import importlib

    ckpts = []          # best-checkpoint file per chain stage (train stages)
    result = {}
    for i, (verb, argv) in enumerate(_chain_argv(row, args)):
        stage_idx = i - (0 if args.smoke else 1)    # index into row.stages
        if stage_idx >= 0:
            st = row.stages[stage_idx]
            if st.uses_ckpt_from >= 0:
                argv = argv + ["--checkpoint_path", ckpts[st.uses_ckpt_from]]
        print(f"[reproduce:{row.name}] stage {i}: {verb} {' '.join(argv)}",
              flush=True)
        mod = importlib.import_module(f"ehgr_tpu_torch.cli.{verb}")
        if verb == "prepare_data":
            mod.main(argv)
            continue
        if verb.startswith("train"):
            os.makedirs(args.work_dir, exist_ok=True)
            res = _run_train(verb, argv, args, stage_idx)
            ckpts.append(os.path.join(
                res["run_dir"],
                f"repro_{row.name}_s{stage_idx}_best_ckpt.pth"))
            result.update({f"stage{stage_idx}_train_loss":
                           res["final_train_loss"]})
        else:
            result.update(mod.main(argv + ["--device", args.device]))
    return result


def _run_train(verb, argv, args, stage_idx):
    # the train CLIs take --run_dir; the chain routes every run to work_dir
    from ehgr_tpu_torch.configs import config_from_args
    from ehgr_tpu_torch.data.factory import build_train_datasets
    from ehgr_tpu_torch.train.loop import run_training

    default = {"train": "ego_baseline", "train_mtmm": "ego_mtmm",
               "train_sd": "ego_sd", "train_mtmm_sd": "ego_mtmm_sd"}[verb]
    cfg = config_from_args(argv, default_preset=default)
    cfg = cfg.replace(run=dataclasses.replace(cfg.run, run_dir=args.work_dir))
    stage = {"train": "baseline", "train_mtmm": "mtmm", "train_sd": "sd",
             "train_mtmm_sd": "mtmm_sd"}[verb]
    ds = build_train_datasets(cfg, stage)
    kw = {"max_steps_per_epoch": 3} if args.smoke else {}
    return run_training(cfg, stage, *ds, device=args.device, **kw)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--list", action="store_true")
    p.add_argument("--row", choices=sorted(ROWS))
    p.add_argument("--smoke", action="store_true",
                   help="synthetic tiny-geometry dress run (no accuracy "
                        "assertion; verifies the chain plumbing)")
    p.add_argument("--frame_path", default="")
    p.add_argument("--label_path", default="")
    p.add_argument("--dataset_path", default="")
    p.add_argument("--annot_path", default="")
    p.add_argument("--work_dir",
                   default=os.path.join(tempfile.gettempdir(), "ehgr_repro"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])

    if args.list or not args.row:
        print(f"{'row':18s} {'expected':>9s} {'ETA':>8s}  chain")
        for r in ROWS.values():
            chain = " -> ".join(s.verb for s in r.stages)
            print(f"{r.name:18s} {r.expected_top1:9.2f} "
                  f"{_fmt_eta(eta_seconds(r)):>8s}  prepare_data -> {chain}")
            print(f"{'':18s} {r.baseline_row}")
        return 0

    row = ROWS[args.row]
    if not args.smoke:
        need = ("frame_path", "label_path") if row.dataset == "ego" \
            else ("dataset_path",)
        missing = [n for n in need if not getattr(args, n)]
        if missing or not args.annot_path:
            p.error(f"--row {args.row} needs --annot_path and "
                    f"--{' --'.join(need)} (or --smoke)")

    res = run_row(row, args)
    got = res.get("final_top1")
    print(f"[reproduce:{row.name}] result: {res}")
    if args.smoke:
        print(f"[reproduce:{row.name}] smoke chain OK (top1={got})")
        return 0
    lo = row.expected_top1 - row.tolerance
    status = "OK" if got is not None and got >= lo else "BELOW"
    print(f"[reproduce:{row.name}] top1={got} expected>="
          f"{lo:.2f} (ref {row.expected_top1}) -> {status}")
    return 0 if status == "OK" else 1


if __name__ == "__main__":
    sys.exit(main())
