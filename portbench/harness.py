"""Finds everything a run needs by the names in ``BENCHMARK.json``, so that a
configuration, a traffic mix, a cell, a metric or a kind of traffic is added
as a file of its own with no edit here:

* ``BENCHMARK.json`` at the checkout's root: a cell (``workloads``) names
  its configuration and its traffic;
* the configuration: the file that its entry's ``file`` names;
* the traffic: ``portbench/traffic/<traffic>.json``, read by the one
  generator of ``traffic.py``; its ``kind`` names the code that runs it,
  ``portbench/kinds/<kind>.py`` (``run(cell)``);
* the cell: ``portbench/workloads/<cell>.json``, its limits for ``correct``;
* each metric: ``portbench/metrics/<metric>.py``, whose ``read(run)``
  returns the value or ``None`` where the run has nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

PACKAGE = "portbench"


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub_seed(seed: int, stream: int) -> int:
    """A seed below 2**63 for one stream of draws (weights, traffic,
    dropout) of the run's ``--seed``, any whole number."""
    state = np.random.SeedSequence([seed % 2 ** 64, stream]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


@dataclass
class Cell:
    """One cell as a run sees it: its entry, its configuration, its
    traffic, its own file, and the run's arguments."""

    root: Path
    name: str
    entry: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: str = "cuda"
    started: float = 0.0

    @property
    def model(self) -> Dict:
        return self.config["model"]

    def kind(self) -> ModuleType:
        return _module(self.root / PACKAGE / "kinds" /
                       f"{self.traffic['kind']}.py", self.traffic["kind"])


def load_benchmark(root: Path) -> Dict:
    return _json(Path(root) / "BENCHMARK.json")


def find_cell(root: Path, name: str, bench: Optional[Dict] = None) -> Cell:
    root = Path(root)
    bench = bench or load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[entry["config"]]["file"])
    traffic = _json(root / PACKAGE / "traffic" / f"{entry['traffic']}.json")
    own = _json(root / PACKAGE / "workloads" / f"{name}.json")
    return Cell(root=root, name=name, entry=entry, config=config,
                traffic=traffic, limits=own["limits"])


def metrics_of(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: with ``trace`` the per-layer
    ones, else the end-to-end ones; a metric with ``workloads`` only in the
    cells it lists, one without it in every cell that reports the metric
    it moves (end-to-end: in every cell)."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def listed(m):
        return cell in m["workloads"] if "workloads" in m else None

    if not trace:
        return [m for m in bench["end_to_end"] if listed(m) is not False]
    out = []
    for m in bench["per_layer"]:
        inside = listed(m)
        if inside is None:
            inside = listed(e2e[m["moves"]]) is not False
        if inside:
            out.append(m)
    return out


def reader(root: Path, metric: str):
    return _module(Path(root) / PACKAGE / "metrics" / f"{metric}.py",
                   metric).read
