"""The harness finds every configuration, cell and metric by its name;
a cell or a metric added as files of its own is picked up with no code
edit; the result line holds exactly the contract's keys; without a card,
or without the program beside it, the command fails with no result."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import harness, run
from portbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = harness.find_cell(REPO, name, BENCH)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.limits
    assert callable(cell.kind().run)
    assert harness.metrics_of(BENCH, name, False)
    assert harness.metrics_of(BENCH, name, True)


@pytest.mark.parametrize("name", METRICS)
def test_metric_found_by_name(name):
    assert callable(harness.reader(REPO, name))


def test_every_cell_reports_setup_and_another_e2e_metric():
    for name in CELLS:
        e2e = {m["name"] for m in harness.metrics_of(BENCH, name, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in harness.metrics_of(BENCH, name, True):
            assert m["moves"] in e2e


def test_new_cell_and_metric_are_picked_up(root, tmp_path):
    """The tiny cells are files added beside the real ones; a new metric is
    one file and one entry, read in the cells it lists."""
    new = tmp_path / "copy"
    shutil.copytree(root, new)
    (new / "portbench" / "metrics" / "calls.serve.py").write_text(
        "def read(rec):\n    return float(rec['calls'])\n")
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["per_layer"].append(
        {"name": "calls.serve", "unit": "calls", "better": "higher",
         "source": "host_clock", "layer": "entry (serve)",
         "moves": "serve_clips_per_s", "workloads": [tiny.TSM_SERVE]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = tiny.cell(new, tiny.TSM_SERVE, trace=True)
    cell.started = time.time()
    result = run.run_cell(cell, harness.load_benchmark(new))
    assert result["metrics"]["calls.serve"]["value"] >= 1
    assert result["correct"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(root, trace):
    cell = tiny.cell(root, tiny.TSM_SERVE, trace=trace)
    cell.started = time.time()
    result = run.run_cell(cell, harness.load_benchmark(root))
    line = run.result_line(result, {"platform": "gpu", "kind": "test",
                                    "count": 1, "memory_peak_bytes": 0})
    want = ["correct", "attempted", "failed", "metrics", "device"] + \
        (["breakdown"] if trace else []) + ["compared"]
    assert list(line) == want
    assert set(line["metrics"]) == {
        m["name"] for m in harness.metrics_of(
            harness.load_benchmark(root), tiny.TSM_SERVE, trace)} - \
        ({"kernel_roofline.serve"} if trace else set())
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(line)


def _command(cwd, env):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         CELLS[0], "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _command(REPO, env)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def test_without_the_program_exits_nonzero(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _command(tmp_path, env)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
