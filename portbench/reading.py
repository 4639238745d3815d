"""What the metric readers (``metrics/<name>.py``) share: each takes the
run's record and returns its number, or ``None`` where the record has
nothing for it (another kind of traffic, or no trace)."""

from __future__ import annotations

import statistics
from typing import Optional

from portbench.work import flops, kernels

BF16_PEAK = kernels.PEAK_FLOPS["bfloat16"]


def of_kind(rec: dict, kind: str) -> bool:
    return rec.get("kind") == kind and rec.get("calls", 0) > 0


def clips_per_s(rec: dict, kind: str) -> Optional[float]:
    if not of_kind(rec, kind):
        return None
    return rec["clips"] / rec["window_s"]


def percentile_ms(rec: dict, kind: str, q: int) -> Optional[float]:
    """The ``q``-th percentile of the window's call latencies (linear
    between order statistics)."""
    if not of_kind(rec, kind):
        return None
    lat = rec["latencies_s"]
    if len(lat) == 1:
        return lat[0] * 1e3
    return statistics.quantiles(lat, n=100, method="inclusive")[q - 1] * 1e3


def idle_share(rec: dict, kind: str) -> Optional[float]:
    t = rec.get("trace")
    if not of_kind(rec, kind) or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(rec: dict, kind: str) -> Optional[float]:
    """The reference's FLOPs of a call or step times the untraced window's
    rate, over the card's bf16 peak, in percent."""
    if not of_kind(rec, kind) or not rec.get("trace"):
        return None
    m, tr = rec["model"], rec["traffic"]
    if kind == "serve":
        work = flops.call_flops(m, rec["clips_per_call"], m["crop"])
    else:
        work = flops.step_flops(m, rec["clips_per_call"], m["crop"],
                                tr["arch"] == "tsn_mtmm",
                                rec["loss"]["depth_weight"])
    return 100.0 * work * rec["calls"] / rec["window_s"] / BF16_PEAK


def kernel_roofline(rec: dict, kind: str) -> Optional[float]:
    """Sum of the least times of the hand-written kernels' launches in the
    trace over the sum of their device times, in percent.  A launch of the
    program's kernels that the cell's arithmetic does not cover raises:
    its time would otherwise drop out of the sum."""
    t = rec.get("trace")
    if not of_kind(rec, kind) or not t or not t["kernels"]:
        return None
    bounds = kernels.bounds_per_call(rec["model"], rec["clips_per_call"],
                                     kind == "train")
    least = spent = 0.0
    for launch, k in t["kernels"].items():
        if launch not in bounds or k["launches"] == 0:
            raise ValueError(
                f"kernel_roofline: the trace holds {k['launches']} launches "
                f"and {k['seconds']!r} s of {launch!r}, which "
                f"work/kernels.py does not bound for this cell")
        per_call, seconds = bounds[launch]
        least += k["launches"] * seconds / per_call
        spent += k["seconds"]
    return 100.0 * least / spent
