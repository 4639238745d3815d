"""Profiling and tracing utilities (counterpart of
``ehgr_tpu/utils/profiling.py``).

* ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes one Chrome trace (``trace.json``) of what runs inside it, CPU and,
  where a card is present, CUDA activity.
* ``span(name, args)``: a span of the program in that trace, and in any
  other ``torch.profiler`` run.  While a profiler records it is a
  ``torch.profiler.record_function``, which lands on the clock of the
  card's trace; otherwise it is one shared no-op, so a span off costs one
  flag check.  The program opens its spans at the boundaries of its layers:

  - ``ehgr.score`` (``eval/inference.py``, one scorer call, ``args`` its
    sequence number) around ``ehgr.score.upload`` (the host batch to the
    card), ``ehgr.score.preprocess`` (normalise and resize) and
    ``ehgr.score.model`` (the forward); the softmax and the vote are
    ``ehgr.score``'s own time;
  - ``ehgr.step`` (``train/steps.py``, one train step, ``args`` the step
    number) around ``ehgr.step.copy`` (the batch to the card),
    ``ehgr.step.forward`` (``normalize_clip``, forward and loss) and
    ``ehgr.step.backward``, once each a microbatch, and
    ``ehgr.step.update`` (the gradients, their all-reduce on a mesh, the
    optimizer and both EMA blends).

  The backward's kernels are launched from autograd's device thread while
  the caller waits inside ``ehgr.step.backward``: a reader of the trace
  charges a launch to the program span open at its time, not to the
  thread's own nesting.
* ``launch_counts()``: a snapshot of every hand-written kernel's launch
  counters (``ops/kernels/registry.py`` ``KERNELS``).
* ``time_fn``: steady-state wall-clock timing with warm-up and
  percentiles; it waits for the card after each call, where the JAX
  function blocks on its outputs.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Sequence

import numpy as np
import torch
from torch.autograd import _profiler_enabled


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body; on exit write ``<logdir>/trace.json`` (Chrome
    trace format).  Yields the profiler, whose ``key_averages()`` and
    ``events()`` stay readable after the block."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        _sync()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_OFF = contextlib.nullcontext()


def span(name: str, args: object = None):
    """A span named ``name`` (``args``: a value the trace keeps beside it as
    a string, such as a call's sequence number) while a ``torch.profiler``
    records; the shared no-op otherwise, with ``args`` left as it is."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(
        name, None if args is None else str(args))


def launch_counts() -> Dict[str, int]:
    """Every hand-written kernel's launches so far, by wrapper
    (``action_stats``) and, where it counts them, by route
    (``action_stats/window``) or by direction (``tsm_shift/reverse``); a
    later snapshot less an earlier one counts the launches between."""
    from ehgr_tpu_torch.ops.kernels.registry import KERNELS

    out = {}
    for name, wrapper in KERNELS.items():
        out[name] = wrapper.launches
        for route, n in getattr(wrapper, "route_launches", {}).items():
            out[f"{name}/{route}"] = n
        if hasattr(wrapper, "reverse_launches"):
            out[f"{name}/reverse"] = wrapper.reverse_launches
    return out


def time_fn(fn: Callable, *args, warmup: int = 3, iters: int = 10,
            percentiles: Sequence[int] = (50, 90, 99)) -> Dict[str, float]:
    """Time a function of tensors; waits for the card after every call.
    Returns ms stats: ``mean_ms``, ``min_ms`` and ``p{q}_ms`` for each
    percentile ``q``."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append((time.perf_counter() - t0) * 1000.0)
    arr = np.asarray(times)
    out = {"mean_ms": float(arr.mean()), "min_ms": float(arr.min())}
    for p in percentiles:
        out[f"p{p}_ms"] = float(np.percentile(arr, p))
    return out
