"""The numbers that decide ``correct``, each held against its cell's limit
(``workloads/<cell>.json``), and the program's state read as the
comparison needs it.

Serve, ``p`` the program's video probabilities (the clips' softmax
voted) and ``p_ref`` the float32 reference's on the same frames:
``video_logprob_gap``, the largest ``|log p - log p_ref|`` over every
video and class of every call the run made (one answer altered shows
here); ``video_kl``, the mean over every video of every call of
``KL(p_ref || p)`` in nats (the program's int8 path shows here, not in
the largest gap).

Train, over the first three steps, which the run drives through its own
step in set-up: ``loss_gap``, the largest relative gap of a step's loss;
``grad_gap``, the median over the leaves of the first gradient's norm gap,
the gradient as the optimizer holds it after step 1 (the momentum less the
weight decay's part); ``update_gap``, the median over the leaves of the
norm gap of each parameter's change over the three steps.  A leaf's norm
gap ``| |a| - |r| |`` is taken over the larger of the reference leaf's norm
and the median leaf's; leaves whose reference gradient is under a
thousandth of the median leaf's are left out (they move by rounding
alone).  The median leaf and not the worst: the worst is the first
block's ACTION gate heads, whose small gradients bf16 rounds alike with
the kernels or with plain PyTorch in their place (PERF.md).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List

import torch

NEGLIGIBLE = 1e-3


def logprob_gap(p: torch.Tensor, ref: torch.Tensor) -> float:
    lp = torch.log(p.double().clamp_min(1e-300))
    lr = torch.log(ref.double().clamp_min(1e-300))
    return float((lp - lr).abs().max())


def video_kl(p: torch.Tensor, ref: torch.Tensor) -> float:
    """The mean over the videos (rows) of ``KL(ref || p)``."""
    lp = torch.log(p.double().clamp_min(1e-300))
    lr = torch.log(ref.double().clamp_min(1e-300))
    return float((ref.double() * (lr - lp)).sum(-1).mean())


@torch.no_grad()
def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = list(tensors)
    norms = torch._foreach_norm([tensors[k].float() for k in keys])
    return dict(zip(keys, torch.stack(norms).tolist()))


def kept_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= NEGLIGIBLE * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Iterable[str]) -> List[float]:
    keep = list(keep)
    med = statistics.median(ref[k] for k in keep)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep]


def loss_gaps(prog: List[float], ref: List[float]) -> List[float]:
    return [abs(a - b) / abs(b) for a, b in zip(prog, ref)]


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``loss_gap``, ``grad_gap`` and ``update_gap`` of the program's
    readings ``prog`` against the reference's ``ref``."""
    keep = kept_leaves(ref["grad1"])
    grad = leaf_gaps(prog["grad1"], ref["grad1"], keep)
    update = leaf_gaps(prog["update"], ref["update"], keep)
    return {"loss_gap": max(loss_gaps(prog["losses"], ref["losses"])),
            "grad_gap": statistics.median(grad),
            "update_gap": statistics.median(update)}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """``{name: {"value", "limit"}}`` of the numbers that have a limit, and
    whether each is finite and within it."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return {"checks": checks, "ok": ok}
