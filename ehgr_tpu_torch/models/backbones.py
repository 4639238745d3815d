"""Backbone factory (counterpart of ``ehgr_tpu/models/backbones.py``):
ResNet-50/101, Res2Net-50, MobileNetV2 and BN-Inception.  Every backbone
returns a tap dict with at least ``pool``; the ResNet family's (ResNet and
Res2Net) also has ``stem`` and ``layer1..4``, which the MTMM / SD heads
need.  ``action_fused`` reaches every ACTION site; int8 inference
(``quantize``), ``temporal_pool``, ``remat`` and ``action_stages`` are
ResNet options, as in the JAX package (which raises for the first two on
another family and ignores the others there)."""

from __future__ import annotations

from torch import nn

from ehgr_tpu_torch.models.bn_inception import BNInceptionBackbone
from ehgr_tpu_torch.models.mobilenet_v2 import MobileNetV2Backbone
from ehgr_tpu_torch.models.res2net import Res2NetBackbone
from ehgr_tpu_torch.models.resnet import STAGE_SIZES, ResNetBackbone

RESNET_FAMILY = ("resnet50", "resnet101", "res2net50")
ALL_BACKBONES = RESNET_FAMILY + ("mobilenet_v2", "bn_inception")


def get_backbone(base_model: str, temporal: str, n_segment: int,
                 shift_div: int, action_fused=None,
                 action_stages=(1, 2, 3, 4), partial_bn: bool = True,
                 stages: int = 4, remat: bool = False,
                 temporal_pool: bool = False, quantize=False,
                 device=None) -> nn.Module:
    kw = dict(temporal=temporal, n_segment=n_segment, shift_div=shift_div,
              action_fused=action_fused, partial_bn=partial_bn,
              device=device)
    if base_model in STAGE_SIZES:
        return ResNetBackbone(
            stage_sizes=STAGE_SIZES[base_model],
            action_stages=tuple(action_stages), stages=stages, remat=remat,
            temporal_pool=temporal_pool, quantize=quantize, **kw)
    if quantize:
        raise ValueError("int8 inference is resnet-only for now")
    if temporal_pool:
        raise ValueError("temporal_pool is resnet-only (as in the reference)")
    if base_model in ("res2net50", "res2net50_26w_4s"):
        return Res2NetBackbone(stages=stages, **kw)
    if base_model in ("mobilenet_v2", "mobilenetv2"):
        return MobileNetV2Backbone(**kw)
    if base_model in ("bn_inception", "BNInception"):
        return BNInceptionBackbone(**kw)
    raise ValueError(f"unknown base model: {base_model}")


def supports_taps(base_model: str) -> bool:
    """Whether the backbone exposes layer1..4 taps (needed by MTMM/SD)."""
    return base_model in RESNET_FAMILY or base_model in ("res2net50_26w_4s",)
