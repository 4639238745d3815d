"""Flow / RGBDiff modality support (counterpart of
``ehgr_tpu/models/modality.py``).

``adapt_first_conv`` re-derives a backbone's stem conv weight in a torch
``state_dict`` for another input width (stacked flow, 2L channels, or frame
differences), as the reference's ``_construct_flow_model`` /
``_construct_diff_model`` rebuild the pretrained first conv by averaging
the RGB kernel; ``rgb_diff`` and ``stack_flow`` compute those inputs.
The clips here are channels-first, ``[N, T, C, H, W]``, the reference's
layout (the JAX functions take the same data channels-last).
"""

from __future__ import annotations

from typing import Dict

import torch

# the stem conv's key in a TSN state_dict, by backbone
STEM_KEYS = {
    "resnet50": "base_model.conv1.weight",
    "resnet101": "base_model.conv1.weight",
    "res2net50": "base_model.conv1.weight",
    "res2net50_26w_4s": "base_model.conv1.weight",
    "mobilenet_v2": "base_model.features.0.0.weight",
    "mobilenetv2": "base_model.features.0.0.weight",
    "bn_inception": "base_model.conv1_7x7_s2.weight",
    "BNInception": "base_model.conv1_7x7_s2.weight",
}


def adapt_first_conv(state_dict: Dict[str, torch.Tensor],
                     new_in_channels: int, keep_rgb: bool = False,
                     base_model: str = "resnet50",
                     key: str = None) -> Dict[str, torch.Tensor]:
    """A copy of ``state_dict`` whose stem conv weight (``key``, default
    ``STEM_KEYS[base_model]``, ``[out, 3, kh, kw]``) takes
    ``new_in_channels`` inputs.  Flow: the mean over the RGB inputs, tiled
    to the new width.  RGBDiff with ``keep_rgb``: the RGB kernel, then
    mean tiles for the difference channels.  The mean is numpy's over the
    f32 kernel, as the JAX function takes it; the result has the weight's
    dtype and device."""
    key = key or STEM_KEYS[base_model]
    k = state_dict[key]
    kf = k.detach().cpu().float()
    mean_k = kf.numpy().mean(axis=1, keepdims=True)
    if keep_rgb:
        extra = new_in_channels - kf.shape[1]
        new_k = torch.cat([kf, torch.from_numpy(mean_k).expand(
            -1, extra, -1, -1)], dim=1)
    else:
        new_k = torch.from_numpy(mean_k).expand(-1, new_in_channels, -1, -1)
    out = dict(state_dict)
    out[key] = new_k.to(dtype=k.dtype, device=k.device).contiguous()
    return out


def rgb_diff(clip: torch.Tensor, keep_rgb: bool = False) -> torch.Tensor:
    """RGBDiff input: per-step frame differences along T.
    ``clip [N, T, 3, H, W]`` -> ``[N, T-1, 3, H, W]``, or with ``keep_rgb``
    ``[N, T-1, 6, H, W]`` (each frame, then its difference to the next)."""
    diff = clip[:, 1:] - clip[:, :-1]
    if keep_rgb:
        return torch.cat([clip[:, :-1], diff], dim=2)
    return diff


def stack_flow(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x / y optical-flow fields ``[N, T, H, W]`` each -> the 2-channel
    Flow input ``[N, T, 2, H, W]``."""
    return torch.stack([u, v], dim=2)
