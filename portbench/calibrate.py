"""The readings that the limits of ``correct`` are set from: for one cell
and many seeds in one process, the numbers that ``correct`` compares in
each mode of ``controls.py`` (the program as the cell runs it, its
control, a planted fault, a witness).  Needs the card.

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 \\
        --seconds 4 --modes program int8 --out readings.json

``--seconds`` is the serve cells' short window (it has to cover the pool)
and the train cells' too (their checked steps come before it).
``--detail`` also keeps what the numbers were taken from: each video's
probabilities on both sides (serve), each leaf's norms (train).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from portbench import controls, run as run_mod


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--modes", nargs="+", default=["program"])
    p.add_argument("--out", required=True)
    p.add_argument("--detail", action="store_true")
    args = p.parse_args(argv)

    root = Path.cwd()
    torch = run_mod.prepare_process(root)
    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(root, args.workload)
    cell.seconds, cell.device = args.seconds, "cuda"
    out = {"cell": cell.name, "limits": cell.limits, "readings": []}
    for seed in args.seeds:
        for mode in args.modes:
            cell.seed, cell.started = seed, time.time()
            t0 = time.perf_counter()
            res = controls.run(cell, mode)
            row = {"seed": seed, "mode": mode, "values": res["values"],
                   "attempted": res["attempted"], "failed": res["failed"],
                   "seconds": time.perf_counter() - t0}
            if args.detail:
                row["readings"] = res["readings"]
            out["readings"].append(row)
            print(json.dumps({k: v for k, v in row.items()
                              if k != "readings"}), flush=True)
            Path(args.out).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
