"""TSN segment consensus (counterpart of ``ehgr_tpu/ops/consensus.py``)."""

from __future__ import annotations

import torch


def consensus(x: torch.Tensor, consensus_type: str = "avg",
              axis: int = 1) -> torch.Tensor:
    """``[N, T, ...] -> [N, ...]`` (avg) or identity."""
    if consensus_type == "avg":
        return x.mean(dim=axis)
    if consensus_type == "identity":
        return x
    raise ValueError(f"unknown consensus type: {consensus_type}")
