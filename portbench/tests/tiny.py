"""A copy of the benchmark with tiny cells that run on the CPU in seconds:
the real cells' files, and beside them a configuration of each temporal
module at 32x32 and 4 frames, 5 classes, float32, with small serve and
train traffic."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

SERVE = "tiny_action.serve"
TRAIN = "tiny_action.train"
TSM_SERVE = "tiny_tsm.serve"
TSM_TRAIN = "tiny_tsm.train"
CELLS = (SERVE, TRAIN, TSM_SERVE, TSM_TRAIN)


def _dump(path: Path, data) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=1) + "\n")


def copy(root: Path) -> Path:
    """The benchmark's files under ``root`` plus the tiny cells; returns
    ``root``."""
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    for temporal in ("action", "tsm"):
        name = f"tiny_{temporal}"
        cfg = json.loads((pb / "configs" / f"{temporal}_r50_ego.json")
                         .read_text())
        cfg["name"] = name
        cfg["model"].update(num_classes=5, num_segments=4, crop=32,
                            dtype="float32")
        cfg["loss"]["depth_size"] = 8
        # a tiny random model's gradients are large: at the recipe's rate its
        # float32 runs part by percents within three steps, at this one not
        cfg["optim"]["lr"] = 1e-6
        _dump(pb / "configs" / f"{name}.json", cfg)
        bench["configs"].append(
            {"name": name, "source": "test", "reduced": [],
             "file": f"portbench/configs/{name}.json", "why": "test"})
    _dump(pb / "traffic" / "tiny_serve.json",
          {"kind": "serve", "arch": "tsn", "videos": 2, "clips": 2,
           "frame": [32, 32], "pool": 2, "trace_calls": 2,
           "reference_videos": 1})
    for stage, arch, depth in (("mtmm", "tsn_mtmm", True),
                               ("baseline", "tsn", False)):
        _dump(pb / "traffic" / f"tiny_{stage}.json",
              {"kind": "train", "arch": arch, "stage": stage, "clips": 4,
               "depth": depth, "frame": [32, 32], "pool": 4,
               "checked_steps": 3, "trace_steps": 1,
               "steps_per_epoch": 100})
    cells = {SERVE: ("tiny_action", "tiny_serve"),
             TRAIN: ("tiny_action", "tiny_mtmm"),
             TSM_SERVE: ("tiny_tsm", "tiny_serve"),
             TSM_TRAIN: ("tiny_tsm", "tiny_baseline")}
    for cell, (config, traffic) in cells.items():
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        serve = traffic == "tiny_serve"
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and ("serve" if serve else "train") in \
                    m["name"]:
                m["workloads"].append(cell)
        _dump(pb / "workloads" / f"{cell}.json", {"limits": (
            {"video_logprob_gap": 1e-3, "video_kl": 1e-6} if serve else
            {"loss_gap": 1e-3, "grad_gap": 0.01, "update_gap": 0.01})})
    _dump(root / "BENCHMARK.json", bench)
    return root


def cell(root: Path, name: str, seed: int = 7, seconds: float = 0.3,
         trace: bool = False):
    """The harness's view of a tiny cell, on the CPU."""
    from portbench import harness

    c = harness.find_cell(root, name)
    c.seed, c.seconds, c.trace, c.device = seed, seconds, trace, "cpu"
    return c
