"""On-device preprocessing of uint8 frames (counterpart of
``ehgr_tpu/ops/preprocess_device.py``: ``normalize_clip``,
``preprocess_eval_batch`` and ``depth_to_target``)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_clip(x: torch.Tensor,
                   mean: Sequence[float] = IMAGENET_MEAN,
                   std: Sequence[float] = IMAGENET_STD,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8/float ``[..., H, W, C]`` -> normalized ``[..., H, W, C]``:
    /255, -mean, /std folded into one f32 multiply-add."""
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    scale = (1.0 / 255.0) / std
    bias = -mean / std
    return (x.to(torch.float32) * scale + bias).to(dtype)


def preprocess_eval_batch(frames_u8: torch.Tensor, *, scale_size: int = 224,
                          crop_size: int = 224, square_resize: bool = True,
                          dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """uint8 ``[..., H, W, 3]`` already at ``crop_size`` -> normalized.

    The JAX version resizes with ``jax.image.resize``, which antialiases on
    downsample; an exact port of that resize is its own ROADMAP item
    ("preprocess resize"), so frames that need one are refused here."""
    h, w = frames_u8.shape[-3], frames_u8.shape[-2]
    if not square_resize or h != crop_size or w != crop_size:
        raise NotImplementedError(
            f"frames of {h}x{w} need a resize to {crop_size} (scale "
            f"{scale_size}, square={square_resize}); the antialiased resize "
            "is not ported yet (ROADMAP: preprocess resize)")
    return normalize_clip(frames_u8, dtype=dtype)


def depth_to_target(depth_u8: torch.Tensor, size: int = 56) -> torch.Tensor:
    """uint8 depth ``[N, T, H, W, 1]`` -> f32 [0, 1] targets at ``size`` x
    ``size``: non-antialiased bilinear with half-pixel centres, torch's
    ``interpolate`` (the reference's depth-target math, which the JAX
    package rebuilds as a gather)."""
    x = depth_u8.to(torch.float32) / 255.0
    h, w = x.shape[-3], x.shape[-2]
    if h == size and w == size:
        return x
    lead = x.shape[:-3]
    x = x.reshape((-1, h, w, 1)).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1).reshape(lead + (size, size, 1))
