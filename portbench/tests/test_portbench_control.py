"""The control of ``correct`` comes out not correct, on the card, at each
cell's own size, on three seeds: serve cells answer through the program's
own int8 path, in a short window at the cell's load; train cells put the
float32 reference, computed in float8, in the program's place for the
first three steps.  Run on the card:

    python -m pytest -q -m card portbench/tests/test_portbench_control.py
"""

import json
import time
from pathlib import Path

import pytest

from portbench import controls, correct, harness

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (9001, 9002, 9003)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(cuda_card, name, seed):
    from portbench import run

    run.prepare_process(REPO)
    cell = harness.find_cell(REPO, name)
    cell.seed, cell.seconds, cell.device = seed, 3.0, cuda_card
    cell.started = time.time()
    out = controls.run(cell, controls.CONTROL[cell.traffic["kind"]])
    assert not correct.verdict(out["values"], cell.limits)["ok"], \
        out["values"]
