"""Temporal shift (TSM), learnable shift and temporal pooling on
``[N, T, ..., C]`` tensors (counterpart of ``ehgr_tpu/ops/temporal_shift.py``).
"""

from __future__ import annotations

import torch


def temporal_shift(x: torch.Tensor, fold_div: int = 8,
                   reverse: bool = False) -> torch.Tensor:
    """TSM shift: the first ``C/fold_div`` channels read t+1, the next
    ``C/fold_div`` read t-1, the rest pass through; zeros at clip edges.
    ``reverse`` swaps the two directions (the shift's transpose, its VJP).
    ``x``: ``[N, T, ..., C]``."""
    fold = x.shape[-1] // fold_div
    left, right = (slice(None, -1), slice(1, None))
    if reverse:
        left, right = right, left
    out = torch.zeros_like(x)
    out[:, left, ..., :fold] = x[:, right, ..., :fold]
    out[:, right, ..., fold:2 * fold] = x[:, left, ..., fold:2 * fold]
    out[..., 2 * fold:] = x[..., 2 * fold:]
    return out


def temporal_pool(x: torch.Tensor) -> torch.Tensor:
    """Max-pool T by 2 with kernel 3, padding 1:
    ``[N, T, ..., C] -> [N, ceil(T/2), ..., C]``."""
    t = x.shape[1]
    pad = torch.full_like(x[:, :1], float("-inf"))
    xp = torch.cat([pad, x, pad], dim=1)                  # [N, T+2, ...]
    return torch.stack([xp[:, s:s + 3].amax(dim=1)
                        for s in range(0, t, 2)], dim=1)


def learnable_shift(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise length-3 conv over T per channel (the ACTION shift):
    ``out[t] = w[0]*x[t-1] + w[1]*x[t] + w[2]*x[t+1]``, zero-padded.
    ``x``: ``[N, T, ..., C]``; ``w``: ``[3, C]``."""
    zeros = torch.zeros_like(x[:, :1])
    x_prev = torch.cat([zeros, x[:, :-1]], dim=1)
    x_next = torch.cat([x[:, 1:], zeros], dim=1)
    return x_prev * w[0] + x * w[1] + x_next * w[2]


def tsm_shift_init(c: int, fold_div: int = 8,
                   dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """``[3, C]`` taps of the TSM pattern: the first C/fold_div channels take
    w[2]=1 (read t+1), the next C/fold_div w[0]=1 (read t-1), the rest
    w[1]=1."""
    fold = c // fold_div
    w = torch.zeros((3, c), dtype=dtype, device=device)
    w[2, :fold] = 1.0
    w[0, fold:2 * fold] = 1.0
    w[1, 2 * fold:] = 1.0
    return w
