"""On-device preprocessing of uint8 frames (counterpart of
``ehgr_tpu/ops/preprocess_device.py``: ``normalize_clip``, ``resize_clip``,
``center_crop_clip``, ``preprocess_eval_batch`` and ``depth_to_target``).

The resize is the library's antialiased bilinear (``F.interpolate``): the
JAX package computes it with XLA, not with a Pallas kernel."""

from __future__ import annotations

from typing import Sequence, Tuple

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


def resize_clip(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of ``[..., H, W, C]`` to f32 ``[..., H', W', C]``,
    ``size = (H', W')``: half-pixel centres, antialiased when it shrinks
    and plain bilinear when it grows, the function ``jax.image.resize(...,
    method='bilinear')`` computes."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    x = x.to(torch.float32).reshape((-1, h, w, c)).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).reshape(lead + (size[0], size[1], c))


def center_crop_clip(x: torch.Tensor, crop: Tuple[int, int]) -> torch.Tensor:
    """Center crop of ``[..., H, W, C]`` to ``crop = (th, tw)``, the offsets
    rounded as the JAX version rounds them (Python's ``round``, half to
    even)."""
    h, w = x.shape[-3], x.shape[-2]
    th, tw = crop
    y0 = int(round((h - th) / 2.0))
    x0 = int(round((w - tw) / 2.0))
    return x[..., y0:y0 + th, x0:x0 + tw, :]


def preprocess_eval_batch(frames_u8: torch.Tensor, *, scale_size: int = 224,
                          crop_size: int = 224, square_resize: bool = True,
                          dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """uint8 ``[..., H, W, 3]`` -> normalized ``[..., crop, crop, 3]``.

    ``square_resize=True`` is the EgoGesture protocol (a plain resize to
    ``crop_size`` square, none when the frames are already that size);
    otherwise the short side is resized to ``scale_size`` and the centre
    ``crop_size`` square is cut (the NvGesture single-crop protocol)."""
    x = frames_u8
    h, w = x.shape[-3], x.shape[-2]
    if square_resize:
        if h != crop_size or w != crop_size:
            x = resize_clip(x, (crop_size, crop_size))
    else:
        short = min(h, w)
        size = (scale_size, int(round(scale_size * w / short))) if h < w \
            else (int(round(scale_size * h / short)), scale_size)
        x = center_crop_clip(resize_clip(x, size), (crop_size, crop_size))
    return normalize_clip(x, dtype=dtype)


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
