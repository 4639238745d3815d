"""Profiling and tracing utilities (counterpart of
``ehgr_tpu/utils/profiling.py``).

* ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes one Chrome trace (``trace.json``) of what runs inside it, CPU and,
  where a card is present, CUDA activity.
* ``annotate(name)``: a labelled host span in that trace
  (``torch.profiler.record_function``).
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


def annotate(name: str):
    return torch.profiler.record_function(name)


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
