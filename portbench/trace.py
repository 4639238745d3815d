"""A bounded profiled stretch of a run (``torch.profiler`` with CPU and CUDA
activity), reduced in memory to what the per-layer metrics and the
``breakdown`` read; nothing is written to disk.

* ``busy_s``: the union of the device's operations (kernels, copies,
  fills) inside the stretch; ``window_s``: the stretch's length on the
  host clock, from the benchmark's own span around it.
* ``kernels``: seconds and launches of each hand-written kernel of the
  program, by the launch it belongs to (``work/kernels.py``).
* ``device_ops``: the ten device operations that took most time.
* ``idle_gaps``: the device's idle time by what the host was doing (the
  innermost host operation open at the gap's middle, under the
  benchmark's span around the call), the ten largest.
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Tuple

import torch

from portbench.work.kernels import FIRST_KERNEL, launch_of

STRETCH = "portbench.stretch"


def _short(name: str) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:120]


def _is_device(e) -> bool:
    """A kernel, copy or fill on the card (not the card's copy of a host
    annotation)."""
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    annotation = getattr(e, "is_user_annotation", None)
    return not e.name().startswith("portbench.") and \
        not (annotation is not None and annotation())


def profile_stretch(fn: Callable[[int], None], count: int,
                    sync: Callable[[], None]) -> Dict:
    """Run ``fn(i)`` for ``i < count`` under the profiler and reduce."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        pass            # collects records of earlier launches delivered late
    sync()
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(STRETCH):
            for i in range(count):
                fn(i)
            sync()
    return reduce(prof.profiler.kineto_results.events())


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce(events) -> Dict:
    dev, host, window = [], [], None
    for e in events:
        a, d = e.start_ns(), e.duration_ns()
        if _is_device(e):
            dev.append((a, a + d, e.name()))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            if e.name() == STRETCH:
                window = (a, a + d)
            host.append((a, a + d, e.name()))
    if window is None:
        window = (min(a for a, _, _ in dev), max(b for _, b, _ in dev))
    lo, hi = window
    dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev if b > lo and a < hi]
    busy = _union([(a, b) for a, b, _ in dev])
    busy_ns = sum(b - a for a, b in busy)

    by_op: Dict[str, float] = {}
    kernels: Dict[str, Dict] = {}
    for a, b, name in dev:
        short = _short(name)
        by_op[short] = by_op.get(short, 0.0) + (b - a) * 1e-9
        found = launch_of(name)
        if found:
            launch, word = found
            k = kernels.setdefault(launch, {"seconds": 0.0, "launches": 0})
            k["seconds"] += (b - a) * 1e-9
            k["launches"] += int(word == FIRST_KERNEL[launch])

    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    idle: Dict[str, float] = {}
    labels = _host_labels([h for h in host if h[2] != STRETCH],
                          [(a + b) // 2 for a, b in gaps])
    for (a, b), label in zip(gaps, labels):
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]

    return {"busy_s": busy_ns * 1e-9, "window_s": (hi - lo) * 1e-9,
            "kernels": kernels,
            "device_ops": top(by_op), "idle_gaps": top(idle)}


def _host_labels(spans, points: List[int]) -> List[str]:
    """For each time in ``points`` (ascending), ``outer/inner``: the
    benchmark's span (``portbench.*``) and the shortest other host
    operation open then (``host`` and ``python`` where there is none)."""
    spans = sorted(spans)
    open_, j, out = [], 0, []
    for at in points:
        while j < len(spans) and spans[j][0] <= at:
            heapq.heappush(open_, (spans[j][1], spans[j][0], spans[j][2]))
            j += 1
        while open_ and open_[0][0] <= at:
            heapq.heappop(open_)
        outer = [n for _, _, n in open_ if n.startswith("portbench.")]
        inner = [(b - a, n) for b, a, n in open_
                 if not n.startswith("portbench.")]
        out.append(f"{outer[-1] if outer else 'host'}/"
                   f"{min(inner)[1] if inner else 'python'}")
    return out
