"""Model factory (counterpart of ``ehgr_tpu/models/factory.py``): a
``ModelConfig`` -> the model, for every family: the TSN surfaces over
ResNet-50/101, Res2Net-50, MobileNetV2 and BN-Inception (``m.base_model``),
the 3-D models (``slowonly``, ``r2plus1d``, ``r2plus1d_mtmm``) and
VideoMAE (``videomae``, sized by ``m.vit``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ehgr_tpu_torch.configs import ModelConfig
from ehgr_tpu_torch.device import DeviceLike
from ehgr_tpu_torch.models.tsn import variant
from ehgr_tpu_torch.models.video3d import R2Plus1D18, SlowOnlyR50
from ehgr_tpu_torch.models.videomae import VideoMAE

NON_TSN = ("slowonly", "r2plus1d", "r2plus1d_mtmm", "videomae")


def build_model(m: ModelConfig, arch: Optional[str] = None,
                device: DeviceLike = None,
                generator: Optional[torch.Generator] = None,
                quantize=False) -> nn.Module:
    """``m.arch`` (or ``arch``) built from ``m`` on ``device`` (default
    CUDA), weights drawn from ``generator``, with ``m.modal``,
    ``m.temporal_pool`` and ``m.before_softmax`` as the JAX ``build_model``
    applies them.  ``m.consensus_type`` is not passed, as the JAX
    ``build_model`` does not pass it: the model keeps ``'avg'`` (``variant``
    takes the option).  Nor is ``m.quantize``: the trainers build through
    here and train float, as JAX's do; the test runner, which applies int8
    inference, passes it as ``quantize``, which only the TSN surfaces
    take."""
    arch = arch or m.arch
    dtype = getattr(torch, m.dtype)
    kw = dict(num_class=m.num_classes, dropout=m.dropout, dtype=dtype,
              device=device, generator=generator)
    if arch in NON_TSN and quantize:
        raise ValueError(f"int8 inference covers the TSN backbones, not "
                         f"{arch}")
    if arch == "slowonly":
        return SlowOnlyR50(**kw)
    if arch in ("r2plus1d", "r2plus1d_mtmm"):
        return R2Plus1D18(with_depth=arch == "r2plus1d_mtmm", **kw)
    if arch == "videomae":
        size = dict(zip(("dim", "depth", "heads"), m.vit)) if m.vit else {}
        return VideoMAE(**kw, **size)
    return variant(arch, num_class=m.num_classes,
                   num_segments=m.num_segments, base_model=m.base_model,
                   temporal=(m.temporal_module if m.is_shift else "none"),
                   shift_div=m.shift_div, dropout=m.dropout,
                   partial_bn=m.partial_bn, modal=m.modal,
                   action_fused=(m.action_fused or None),
                   action_stages=tuple(m.action_stages), remat=m.remat,
                   temporal_pool=m.temporal_pool,
                   before_softmax=m.before_softmax, quantize=quantize,
                   dtype=dtype, device=device, generator=generator)
