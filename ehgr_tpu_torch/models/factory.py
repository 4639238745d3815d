"""Model factory (counterpart of ``ehgr_tpu/models/factory.py``): a
``ModelConfig`` -> the model, for the families the port has (the TSN
surfaces over the ResNet family)."""

from __future__ import annotations

from typing import Optional

import torch

from ehgr_tpu_torch.configs import ModelConfig
from ehgr_tpu_torch.device import DeviceLike
from ehgr_tpu_torch.models.tsn import TSN, variant


def build_model(m: ModelConfig, arch: Optional[str] = None,
                device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> TSN:
    """``m.arch`` (or ``arch``) built from ``m`` on ``device`` (default
    CUDA), weights drawn from ``generator``, with ``m.modal``,
    ``m.temporal_pool`` and ``m.before_softmax`` as the JAX ``build_model``
    applies them.  ``m.consensus_type`` is not passed, as the JAX
    ``build_model`` does not pass it: the model keeps ``'avg'`` (``variant``
    takes the option).  Quantized inference is not ported and raises."""
    if m.quantize:
        raise NotImplementedError(
            f"quantize={m.quantize!r}: int8 inference is not ported yet "
            "(ROADMAP: queue 1, item 5)")
    return variant(arch or m.arch, num_class=m.num_classes,
                   num_segments=m.num_segments, base_model=m.base_model,
                   temporal=(m.temporal_module if m.is_shift else "none"),
                   shift_div=m.shift_div, dropout=m.dropout,
                   partial_bn=m.partial_bn, modal=m.modal,
                   action_fused=(m.action_fused or None),
                   action_stages=tuple(m.action_stages), remat=m.remat,
                   temporal_pool=m.temporal_pool,
                   before_softmax=m.before_softmax,
                   dtype=getattr(torch, m.dtype), device=device,
                   generator=generator)
