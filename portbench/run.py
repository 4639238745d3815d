"""One run of one cell:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It needs a CUDA card (as many as the cell
asks for) and exits non-zero without a result line when there is none.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` the
``breakdown``, and last ``compared``: each number ``correct`` was decided by
beside its limit, also the last lines of standard error.

The program's build and kernel caches stay inside the checkout: the
kernels build into ``ehgr_tpu_torch/_build/``, and Triton, torch's
extensions and CUDA's JIT cache are pointed at ``.portbench_cache/``.
The process keeps one CPU thread for torch's and OpenMP's pools, as the
configurations' ``assumed.host`` states the deployment: the measured work
runs on the card, and on a host whose cores other machines' work shares,
idle pool threads only contend with the thread that dispatches it (on an
H100 machine one thread read 5-17% more clips/s in the host-bound train
cell, every pair).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

# modules that must not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "ehgr_tpu")


def process_start() -> float:
    """Wall-clock time at which this process started (``/proc``); the
    module's import time where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        ticks = os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - int(fields[19]) / ticks)
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = process_start()


def prepare_process(root: Path):
    """Caches inside the checkout and one host thread; returns torch."""
    cache = root / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)
    return torch


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(torch, chips: int, peak: int) -> dict:
    import subprocess

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def run_cell(cell, bench) -> dict:
    """Run ``cell`` (a ``harness.Cell``) and assemble the result line's
    fields (without ``device``)."""
    from portbench import correct, harness

    out = cell.kind().run(cell)
    rec = out["record"]
    rec["model"] = cell.model
    rec["traffic"] = cell.traffic
    rec["loss"] = cell.config["loss"]
    metrics = {}
    for m in harness.metrics_of(bench, cell.name, cell.trace):
        value = harness.reader(cell.root, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    v = correct.verdict(out["values"], cell.limits)
    result = {"correct": v["ok"] and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if cell.trace and rec.get("trace"):
        t = rec["trace"]
        result["busy_s"], result["window_s"] = t["busy_s"], t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["compared"] = v["checks"]
    return result


def result_line(result: dict, device: dict) -> dict:
    """The last line: ``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device`` (with the trace's ``busy_s`` and ``window_s``), the
    ``breakdown`` where traced, and ``compared`` last."""
    device = dict(device)
    for key in ("busy_s", "window_s"):
        if key in result:
            device[key] = result[key]
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics")}
    line["device"] = device
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["compared"] = result["compared"]
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    root = Path.cwd()
    torch = prepare_process(root)
    from portbench import harness

    bench = harness.load_benchmark(root)
    cell = harness.find_cell(root, args.workload, bench)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    cell.seed, cell.seconds, cell.trace = args.seed, args.seconds, \
        bool(args.trace)
    cell.device, cell.started = "cuda", STARTED

    result = run_cell(cell, bench)
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line = result_line(result, device_info(
        torch, chips, result["memory_peak_bytes"]))
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
