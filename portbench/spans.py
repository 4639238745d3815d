"""The program's own spans (``ehgr.*``, ``ehgr_tpu_torch/utils/profiling.py``
``span``) in a profiled stretch: what the card did and how long it waited
under each.

``spans_of(events)`` reads the same kineto events as ``trace.reduce``, in
the same window, and gives for each program span name, and for ``none``
(the stretch under no program span):

* ``count`` and ``host_s``: the spans of that name and their summed
  length;
* ``launches``: the runtime calls that enqueue work on the card
  (``RUNTIME_CALLS``) that started while that span was the innermost
  program span open;
* ``device_s``: the device time of the kernels, copies and fills that
  those calls enqueued, matched to them by CUPTI correlation id;
* ``idle_s``: the card's idle time (the stretch less the union of its
  operations) while that span was the innermost program span open.

The program opens its spans on the calling thread; autograd launches the
backward's kernels from its own device thread while the caller waits inside
``ehgr.step.backward``.  So a launch is charged by its time to the span then
innermost, whatever thread made it.

``per_call(rec, kind, span, field)`` reads a run's record: ``field``
summed over ``span`` and the spans under it by name (``ehgr.step`` holds
``ehgr.step.copy``), over the count of the kind's outer span
(``ehgr.score``, ``ehgr.step``).  ``READINGS`` names the per-call numbers
that the per-layer metrics of the program's layers would report.

This module reads a ``spans`` entry of the trace's record; ``trace.reduce``
does not make one yet, so until it does ``per_call`` returns ``None`` in a
plain run.  One run of a cell with the spans read from its traced stretch:

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s> \\
        --trace 1

prints ``portbench.run``'s result line, then one line with the stretch's
``spans`` and the ``READINGS`` of the cell's kind (``per_call``).
"""

from __future__ import annotations

import bisect
import json
import sys
from typing import Dict, List, Optional, Tuple

import torch

from portbench.trace import STRETCH, _is_device, _union

PREFIX = "ehgr."
OUTER = {"serve": "ehgr.score", "train": "ehgr.step"}
NONE = "none"
RUNTIME_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
    "cudaGraphLaunch"))
FIELDS = ("count", "host_s", "device_s", "launches", "idle_s")
# reading -> (kind, span, field, scale) for ``per_call``
READINGS = {
    "upload_ms.serve": ("serve", "ehgr.score.upload", "device_s", 1e3),
    "preprocess_ms.serve": ("serve", "ehgr.score.preprocess", "device_s",
                            1e3),
    "model_ms.serve": ("serve", "ehgr.score.model", "device_s", 1e3),
    "upload_ms.train": ("train", "ehgr.step.copy", "device_s", 1e3),
    "forward_idle_ms.train": ("train", "ehgr.step.forward", "idle_s", 1e3),
    "backward_idle_ms.train": ("train", "ehgr.step.backward", "idle_s", 1e3),
    "update_idle_ms.train": ("train", "ehgr.step.update", "idle_s", 1e3),
    "launches.train": ("train", "ehgr.step", "launches", 1),
}


def _innermost(spans: List[Tuple[int, int, str]]
               ) -> List[Tuple[int, int, str]]:
    """The host clock cut into pieces ``(start, end, name)``, each under one
    innermost program span (the open one that started last)."""
    cuts = sorted({x for a, b, _ in spans for x in (a, b)})
    pieces = []
    for a, b in zip(cuts, cuts[1:]):
        open_ = [(s, n) for s, e, n in spans if s <= a and e >= b]
        if open_:
            pieces.append((a, b, max(open_)[1]))
    return pieces


def _span_at(pieces, starts: List[int], at: int) -> str:
    i = bisect.bisect_right(starts, at) - 1
    if i >= 0 and at < pieces[i][1]:
        return pieces[i][2]
    return NONE


def spans_of(events) -> Dict[str, Dict]:
    """Program span name (and ``none``) -> ``FIELDS`` over the stretch."""
    spans, calls, dev, window = [], [], [], None
    for e in events:
        a, d = e.start_ns(), e.duration_ns()
        if _is_device(e):
            dev.append((a, a + d, e.correlation_id()))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            name = e.name()
            if name == STRETCH:
                window = (a, a + d)
            elif name.startswith(PREFIX):
                spans.append((a, a + d, name))
            elif name in RUNTIME_CALLS:
                calls.append((a, e.correlation_id()))
    if window is None:
        window = (min(a for a, _, _ in dev), max(b for _, b, _ in dev))
    lo, hi = window
    spans = [s for s in spans if s[0] >= lo and s[1] <= hi]
    out = {n: dict.fromkeys(FIELDS, 0.0) for n in
           sorted({n for _, _, n in spans}) + [NONE]}
    for a, b, name in spans:
        out[name]["count"] += 1
        out[name]["host_s"] += (b - a) * 1e-9

    pieces = _innermost(spans)
    starts = [a for a, _, _ in pieces]
    covered = sum(b - a for a, b, _ in pieces)
    out[NONE]["host_s"] = (hi - lo - covered) * 1e-9
    charged = {}
    for at, corr in calls:
        if lo <= at <= hi:
            name = _span_at(pieces, starts, at)
            charged[corr] = name
            out[name]["launches"] += 1
    dev = [(max(a, lo), min(b, hi), c) for a, b, c in dev
           if b > lo and a < hi]
    for a, b, corr in dev:
        out[charged.get(corr, NONE)]["device_s"] += (b - a) * 1e-9

    busy = _union([(a, b) for a, b, _ in dev])
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        under = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(pieces) and pieces[i][0] < b:
            s, e, name = pieces[i]
            part = min(b, e) - max(a, s)
            if part > 0:
                out[name]["idle_s"] += part * 1e-9
                under += part
            i += 1
        out[NONE]["idle_s"] += (b - a - under) * 1e-9
    for v in out.values():
        v["count"], v["launches"] = int(v["count"]), int(v["launches"])
    return out


def per_call(rec: dict, kind: str, span: str, field: str
             ) -> Optional[float]:
    """``field`` of ``span`` and the spans under it, per call or step of
    the run's traced stretch; ``None`` for another kind of run, without a
    trace, or without the kind's outer span."""
    t = rec.get("trace")
    if rec.get("kind") != kind or not t or not t.get("spans"):
        return None
    spans = t["spans"]
    calls = spans.get(OUTER[kind], {}).get("count", 0)
    if not calls:
        return None
    return sum(v[field] for name, v in spans.items()
               if name == span or name.startswith(span + ".")) / calls


def readings(table: Dict[str, Dict], kind: str) -> Dict[str, float]:
    """``READINGS`` of ``kind`` over one stretch's ``spans_of`` table."""
    rec = {"kind": kind, "trace": {"spans": table}}
    out = {}
    for name, (k, span, field, scale) in READINGS.items():
        value = per_call(rec, kind, span, field) if k == kind else None
        if value is not None:
            out[name] = value * scale
    return out


def main(argv=None) -> int:
    from portbench import run, trace

    tables, reduce = [], trace.reduce

    def with_spans(events):
        tables.append(spans_of(events))
        return reduce(events)

    trace.reduce = with_spans
    rc = run.main(argv)
    if tables:
        kind = "serve" if OUTER["serve"] in tables[-1] else "train"
        print(json.dumps({"spans": tables[-1],
                          "per_call": readings(tables[-1], kind)}),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
