"""Protocol-scale dress rehearsal on the card, one command (counterpart of
``cli/dress_rehearsal.py``).

Runs the whole two-stage recipe at the reference's PROTOCOL geometry,
224^2 / T=8 / 32 clips a step (the reference's headline configs,
``train_mtmm.py:469-471`` + ``train_sd.py`` stage 2), on the synthetic
backend, end to end on ``--device`` (default ``cuda``):

  stage 1: train_mtmm, a few steps    (CE + 0.01*MSE depth)
  transfer: non-strict checkpoint load (SD initialized from MTMM best)
  stage 2: train_sd, a few steps      (KD T=3 + hint losses)
  test:    multi-clip 4-head protocol (clip_num votes per video)

  python -m ehgr_tpu_torch.cli.dress_rehearsal [--batch 32] [--steps 3] \
      [--out <dir>] [--device cuda|cpu]

``--learnable`` is the end-to-end LEARNING proof: the clips come from
``LearnableClipSource`` (label = motion direction x speed of a target among
distractors for ``--task motion_hard``), each stage trains long enough to
fit it, and the 4-head test must reach the bar of the JAX package: final
top-1 >= 70, the exits on a strict ladder mid1 < mid2 < mid3 <= final with
a margin of 0.5, and no head above 99.5 (``--task motion``: the legacy bar,
final >= 90 with the exits ordered within 2 points).  ``--pretrain_epochs``
runs stage 0 first, a short easy-task MTMM run that plays the role of the
reference's ImageNet init.

The flags and the report's keys are those of ``cli/dress_rehearsal.py``,
plus ``--device`` and the report's ``card`` (name and power limit as
``nvidia-smi`` gives them, or ``cpu``).  Checkpoints are the port's files,
``<run_dir>/<model_name>_<tag>_ckpt.pth``: ``--init``, ``--stage1_ckpt``
and ``--test_ckpt`` take such a file.  Prints ONE JSON line with losses,
accuracies and walls; with ``--out`` also writes it to
``<out>/rehearsal_report.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--clip_len", type=int, default=8)
    p.add_argument("--crop", type=int, default=224)
    p.add_argument("--classes", type=int, default=83)
    p.add_argument("--out", default="")
    p.add_argument("--action_fused", default="vjp",
                   help="'vjp' (the kernel region in training, the plain "
                        "formulation at eval: the config default) | 'none' "
                        "(plain) | 'mega'")
    p.add_argument("--learnable", action="store_true")
    p.add_argument("--task", default="motion_hard",
                   choices=["motion", "motion_hard"],
                   help="learnable-mode synthetic task")
    p.add_argument("--epochs", type=int, default=0,
                   help="epochs per stage (learnable mode; 0 = default)")
    p.add_argument("--pretrain_epochs", type=int, default=0,
                   help="easy-task stage-0 epochs (learnable mode)")
    p.add_argument("--test_ckpt", default="",
                   help="skip training; run only the 4-head test + bar "
                        "on this SD checkpoint file")
    p.add_argument("--init", default="",
                   help="stage-1 warm-start checkpoint file (reuse an "
                        "existing stage-0 run instead of --pretrain_epochs)")
    p.add_argument("--stage1_ckpt", default="",
                   help="skip stages 0-1; run stage 2 + test from this "
                        "MTMM checkpoint file")
    p.add_argument("--sd_epochs", type=int, default=0,
                   help="override stage-2 epochs (0 = same as --epochs)")
    p.add_argument("--videos", type=int, default=512,
                   help="train videos (learnable mode)")
    p.add_argument("--distractors", type=int, default=2,
                   help="motion_hard: distractor count K (train mixes "
                        "0..K, eval renders exactly K)")
    p.add_argument("--occlude", type=int, default=0,
                   help="motion_hard: frames per clip with the target "
                        "hidden")
    p.add_argument("--lr", type=float, default=0.0,
                   help="override base lr (0 = stage defaults)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    if args.learnable:
        # learnable-mode geometry defaults: small crop, 16 classes (the
        # proof is about learning dynamics; the plain rehearsal covers the
        # protocol shapes)
        if args.crop == 224:
            args.crop = 64
        if args.classes == 83:
            args.classes = 16

    import numpy as np

    from ehgr_tpu_torch.configs import (Config, DataConfig, ModelConfig,
                                        OptimConfig, RunConfig)
    from ehgr_tpu_torch.data.factory import build_train_datasets
    from ehgr_tpu_torch.train.loop import run_training

    out_dir = args.out or tempfile.mkdtemp(prefix="rehearsal_")

    learn = args.learnable
    base_lr = args.lr or (0.01 if learn else 0.002)
    n_epochs = args.epochs or (15 if learn else 1)

    def cfg(arch, epochs=None, task=None, **run_kw):
        stage_epochs = epochs or n_epochs
        run_kw.setdefault("display", 1 if not learn else 8)
        run_kw.setdefault("model_name", "rehearsal")
        return Config(
            data=DataConfig(dataset="synthetic", backend="synthetic",
                            synthetic_task=(task or args.task
                                            if learn else "random"),
                            synthetic_distractors=args.distractors,
                            synthetic_occlude=args.occlude,
                            synthetic_videos=args.videos,
                            clip_len=args.clip_len, batch_size=args.batch,
                            num_classes=args.classes, crop_size=args.crop,
                            scale_size=args.crop + 32, clip_num=2,
                            num_workers=2),
            model=ModelConfig(arch=arch, num_segments=args.clip_len,
                              num_classes=args.classes, partial_bn=False,
                              action_fused=args.action_fused or None),
            optim=OptimConfig(lr=base_lr, epochs=stage_epochs,
                              lr_steps=(max(stage_epochs * 2 // 3, 1),),
                              ema_decay=0.999),
            run=RunConfig(run_dir=out_dir, ckpt_light=learn, **run_kw),
        ).validate()

    report = {"batch": args.batch, "clip_len": args.clip_len,
              "crop": args.crop, "classes": args.classes,
              "learnable": learn, "task": args.task if learn else "random",
              "lr": base_lr, "epochs": n_epochs,
              "videos": args.videos, "distractors": args.distractors,
              "occlude": args.occlude, "card": card_name(args.device)}

    max_steps = None if learn else args.steps

    if args.test_ckpt:
        best2 = args.test_ckpt
        _require_file(best2, "--test_ckpt")
        report["test_ckpt"] = best2
        return _run_test_protocol(args, cfg, report, best2, out_dir, learn)

    if args.stage1_ckpt:
        _require_file(args.stage1_ckpt, "--stage1_ckpt")
        report["stage1_ckpt"] = args.stage1_ckpt
        best = args.stage1_ckpt
        return _run_sd_and_test(args, cfg, report, best, out_dir, learn,
                                max_steps)

    # stage 0 (learnable only): easy-task pretrain, the ImageNet proxy
    stage1_init = {}
    if args.init:
        _require_file(args.init, "--init")
        report["init"] = args.init
        stage1_init = {"checkpoint_path": args.init}
    elif learn and args.pretrain_epochs:
        c0 = cfg("tsn_mtmm", epochs=args.pretrain_epochs, task="motion",
                 model_name="rehearsal_pre")
        t0 = time.perf_counter()
        res0 = run_training(c0, "mtmm", *build_train_datasets(c0, "mtmm"),
                            device=args.device)
        report["pretrain_wall_s"] = round(time.perf_counter() - t0, 1)
        report["pretrain_val_top1"] = round(float(res0.get("best_top1",
                                                           -1)), 2)
        report["pretrain_epochs"] = args.pretrain_epochs
        pre_best = _ckpt(res0, "rehearsal_pre")
        _require_file(pre_best, "the stage-0 checkpoint")
        stage1_init = {"checkpoint_path": pre_best}

    # stage 1: MTMM
    c1 = cfg("tsn_mtmm", **stage1_init)
    t0 = time.perf_counter()
    res1 = run_training(c1, "mtmm", *build_train_datasets(c1, "mtmm"),
                        max_steps_per_epoch=max_steps, device=args.device)
    report["mtmm_wall_s"] = round(time.perf_counter() - t0, 1)
    report["mtmm_loss"] = round(float(res1["final_train_loss"]), 4)
    report["mtmm_val_top1"] = round(float(res1.get("best_top1", -1)), 2)
    if not np.isfinite(res1["final_train_loss"]):
        raise FloatingPointError("MTMM loss diverged")
    best = _ckpt(res1, "rehearsal")
    _require_file(best, "the stage-1 checkpoint")

    return _run_sd_and_test(args, cfg, report, best, out_dir, learn,
                            max_steps)


def card_name(device) -> str:
    """``'<name>, <power limit>'`` of the card, as ``nvidia-smi --query-gpu
    =name,power.limit --format=csv,noheader`` prints it, for a CUDA
    ``device``; ``'cpu'`` otherwise."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def _ckpt(res, model_name: str) -> str:
    return os.path.join(res["run_dir"], f"{model_name}_best_ckpt.pth")


def _require_file(path: str, what: str) -> None:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{what}: no checkpoint file {path!r}")


def _run_sd_and_test(args, cfg, report, best, out_dir, learn, max_steps):
    # stage 2: SD, initialized non-strict from the MTMM checkpoint
    import numpy as np

    from ehgr_tpu_torch.data.factory import build_train_datasets
    from ehgr_tpu_torch.train.loop import run_training

    c2 = cfg("tsn_sd", epochs=args.sd_epochs or None, checkpoint_path=best)
    t0 = time.perf_counter()
    res2 = run_training(c2, "sd", *build_train_datasets(c2, "sd"),
                        max_steps_per_epoch=max_steps, device=args.device)
    report["sd_wall_s"] = round(time.perf_counter() - t0, 1)
    report["sd_loss"] = round(float(res2["final_train_loss"]), 4)
    report["sd_val_top1"] = round(float(res2.get("best_top1", -1)), 2)
    if not np.isfinite(res2["final_train_loss"]):
        raise FloatingPointError("SD loss diverged")

    # the test protocol: multi-clip, 4 heads, on the stage-2 weights
    best2 = _ckpt(res2, "rehearsal")
    _require_file(best2, "the stage-2 checkpoint")
    return _run_test_protocol(args, cfg, report, best2, out_dir, learn)


def _run_test_protocol(args, cfg, report, best2, out_dir, learn):
    from ehgr_tpu_torch.eval.runner import run_test

    c3 = cfg("tsn_sd", checkpoint_path=best2)
    t0 = time.perf_counter()
    res3 = run_test(c3, arch="tsn_sd", heads=4, device=args.device)
    report["test_wall_s"] = round(time.perf_counter() - t0, 1)
    for k in ("final", "mid1", "mid2", "mid3"):
        report[f"{k}_top1"] = round(float(res3[f"{k}_top1"]), 2)
    report["n_videos"] = int(res3["n_videos"])
    if learn:
        tops = [report[f"{k}_top1"] for k in ("mid1", "mid2", "mid3",
                                              "final")]
        if args.task == "motion_hard":
            # a STRICT accuracy ladder with real gaps and no saturated
            # head: the shape of the reference's 90.62/91.92/94.96/95.26
            # (runs/EgoGesture/SD/.../test.log:4)
            margin = 0.5
            report["exits_ordered"] = bool(
                tops[0] + margin <= tops[1]
                and tops[1] + margin <= tops[2]
                and tops[2] <= tops[3] + margin)
            report["no_head_saturated"] = bool(max(tops) <= 99.5)
            report["learnable_pass"] = bool(
                report["final_top1"] >= 70.0 and report["exits_ordered"]
                and report["no_head_saturated"])
        else:
            # the legacy bar: high final accuracy and exits ordered (ties
            # allowed; 2 points of slack for vote noise)
            report["exits_ordered"] = bool(
                all(a <= b + 2.0 for a, b in zip(tops, tops[1:])))
            report["learnable_pass"] = bool(report["final_top1"] >= 90.0
                                            and report["exits_ordered"])
    report["ok"] = True

    if args.out:
        # the record lands beside the run directories, not only on stdout
        with open(os.path.join(out_dir, "rehearsal_report.json"), "w") as f:
            json.dump(report, f, indent=1)
    else:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
