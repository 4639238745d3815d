"""Model EMA (counterpart of ``ehgr_tpu/train/ema.py``): the parameters and
the BN running statistics blended each step, ``ema = d*ema + (1-d)*new``."""

from __future__ import annotations

from typing import Dict

import torch


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
               decay: float) -> None:
    """Blend ``new`` into ``ema`` in place (no second copy of the model),
    as multi-tensor ops."""
    keys = list(ema)
    targets = [ema[k] for k in keys]
    torch._foreach_mul_(targets, decay)
    torch._foreach_add_(targets, [new[k] for k in keys], alpha=1.0 - decay)
