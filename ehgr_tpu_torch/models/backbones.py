"""Backbone factory (counterpart of ``ehgr_tpu/models/backbones.py``).  The
ResNet family is ported; the other backbones are ROADMAP items and raise."""

from __future__ import annotations

from ehgr_tpu_torch.models.resnet import STAGE_SIZES, ResNetBackbone

_NOT_PORTED = ("res2net50", "res2net50_26w_4s", "mobilenet_v2",
               "mobilenetv2", "bn_inception", "BNInception")


def get_backbone(base_model: str, temporal: str, n_segment: int,
                 shift_div: int, action_fused=None,
                 action_stages=(1, 2, 3, 4), partial_bn: bool = True,
                 stages: int = 4, remat: bool = False,
                 temporal_pool: bool = False, device=None) -> ResNetBackbone:
    if base_model in STAGE_SIZES:
        return ResNetBackbone(
            stage_sizes=STAGE_SIZES[base_model], temporal=temporal,
            n_segment=n_segment, shift_div=shift_div,
            action_fused=action_fused, action_stages=tuple(action_stages),
            partial_bn=partial_bn, stages=stages, remat=remat,
            temporal_pool=temporal_pool, device=device)
    if base_model in _NOT_PORTED:
        raise NotImplementedError(
            f"backbone {base_model!r} is not ported yet (ROADMAP: other "
            "backbones)")
    raise ValueError(f"unknown base model: {base_model}")
