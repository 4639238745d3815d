"""3-D conv video models (counterpart of ``ehgr_tpu/models/video3d.py``):
R(2+1)D-18, with the MTMM depth decoder (``with_depth``), and SlowOnly-R50.

The input is ``[N, T, H, W, C]``, as the JAX models and the train step take
it; it is permuted once to ``[N, C, T, H, W]`` for ``Conv3d``, a view with
``channels_last_3d`` strides, so the convs run channels-last.  Every conv
pads ``(k-1)//2`` on each side of each axis, as JAX's ``_conv3d`` does; BN
is the port's (momentum 0.9 in flax terms, eps 1e-5).

The MTMM decoder's transposed convs are flax ``ConvTranspose(padding=
'SAME', transpose_kernel=True)``: at k=4, s=2 that is torch's
``ConvTranspose3d(padding=1)``, and at ``(4,1,1)``, s=``(2,1,1)``
``padding=(1,0,0)``, with the converted kernel as it is (no flip).  Its
depth output is ``[N, 8, 56, 56, 1]`` at T=8, 224^2: the decoder grows
layer4's T=1 back to 8.

Weight names are the torch keys of ``models/convert.py``'s rules applied to
the JAX variable paths (``layer{i}_{j}`` -> ``layer{i}.{j}``,
``downsample_conv/bn`` -> ``downsample.0/1``), so converted JAX variables
load with ``strict=True``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ehgr_tpu_torch.device import DeviceLike, resolve_device
from ehgr_tpu_torch.models.layers import (Conv3d, ConvTranspose3d, Linear,
                                          dropout, init_params)
from ehgr_tpu_torch.models.norm import BatchNorm3d


def _conv3d(c_in: int, c_out: int, kernel: Sequence[int],
            stride: Sequence[int] = (1, 1, 1), bias: bool = False) -> Conv3d:
    return Conv3d(c_in, c_out, tuple(kernel), stride=tuple(stride),
                  padding=tuple((k - 1) // 2 for k in kernel), bias=bias)


def _midplanes(c_in: int, c_out: int) -> int:
    """torchvision Conv2Plus1D intermediate width."""
    return (c_in * c_out * 3 * 3 * 3) // (c_in * 3 * 3 + 3 * c_out)


class Conv2Plus1D(nn.Module):
    """(1,3,3) spatial -> BN+ReLU -> (3,1,1) temporal factorized conv."""

    def __init__(self, c_in: int, features: int,
                 stride: Tuple[int, int, int] = (1, 1, 1)):
        super().__init__()
        mid = _midplanes(c_in, features)
        st, sh, sw = stride
        self.spatial = _conv3d(c_in, mid, (1, 3, 3), (1, sh, sw))
        self.bn = BatchNorm3d(mid)
        self.temporal = _conv3d(mid, features, (3, 1, 1), (st, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.temporal(F.relu(self.bn(self.spatial(x))))


class R2Plus1DBlock(nn.Module):
    def __init__(self, c_in: int, features: int,
                 stride: Tuple[int, int, int] = (1, 1, 1),
                 has_downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2Plus1D(c_in, features, stride)
        self.bn1 = BatchNorm3d(features)
        self.conv2 = Conv2Plus1D(features, features)
        self.bn2 = BatchNorm3d(features)
        self.downsample = nn.Sequential(
            _conv3d(c_in, features, (1, 1, 1), stride),
            BatchNorm3d(features)) if has_downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(h + residual)


class SlowOnlyBottleneck(nn.Module):
    def __init__(self, c_in: int, planes: int, t_kernel: int = 1,
                 stride: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = _conv3d(c_in, planes, (t_kernel, 1, 1))
        self.bn1 = BatchNorm3d(planes)
        self.conv2 = _conv3d(planes, planes, (1, 3, 3), (1, stride, stride))
        self.bn2 = BatchNorm3d(planes)
        self.conv3 = _conv3d(planes, planes * 4, (1, 1, 1))
        self.bn3 = BatchNorm3d(planes * 4)
        self.downsample = nn.Sequential(
            _conv3d(c_in, planes * 4, (1, 1, 1), (1, stride, stride)),
            BatchNorm3d(planes * 4)) if has_downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(h + residual)


class _Video3D(nn.Module):
    """What both families share: the input cast and permute, the mean pool
    over T, H and W, dropout and the f32 logits of the head."""

    def __init__(self, dropout: float, dtype: torch.dtype):
        super().__init__()
        self.dropout = dropout
        self.dtype = dtype

    def _finish(self, device: DeviceLike,
                generator: Optional[torch.Generator]) -> None:
        """lecun-normal init from ``generator`` (default: a CPU generator
        seeded 0), then onto ``device`` (default CUDA), in eval mode."""
        dev = resolve_device(device)
        init_params(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))
        self.to(dev).eval()

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        """``[N, T, H, W, C]`` -> ``[N, C, T, H, W]`` in the compute dtype
        (channels_last_3d strides)."""
        return x.to(self.dtype).permute(0, 4, 1, 2, 3)

    def _head(self, fc: nn.Module, h: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        pooled = h.mean((2, 3, 4))                          # [N, C]
        pooled = dropout(pooled, self.dropout, self.training, generator)
        return fc(pooled).float()


class R2Plus1D18(_Video3D):
    """torchvision-architecture R(2+1)D-18 clip classifier; ``with_depth``
    adds the MTMM global depth decoder over layer4 and returns
    ``(logits, depth [N, T', H/4, W/4, 1])``."""

    def __init__(self, num_class: int, dropout: float = 0.5,
                 with_depth: bool = False,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dropout, dtype)
        self.with_depth = with_depth
        self.stem_spatial = _conv3d(3, 45, (1, 7, 7), (1, 2, 2))
        self.stem_bn1 = BatchNorm3d(45)
        self.stem_temporal = _conv3d(45, 64, (3, 1, 1))
        self.stem_bn2 = BatchNorm3d(64)
        c = 64
        for i, planes in enumerate((64, 128, 256, 512), 1):
            blocks = []
            for j in range(2):
                first = i > 1 and j == 0
                blocks.append(R2Plus1DBlock(
                    c, planes, (2, 2, 2) if first else (1, 1, 1),
                    has_downsample=first))
                c = planes
            setattr(self, f"layer{i}", nn.Sequential(*blocks))
        self.fc = Linear(512, num_class)
        if with_depth:
            for k, (c_in, feats, kern, st, pad) in enumerate((
                    (512, 256, (4, 4, 4), (2, 2, 2), (1, 1, 1)),
                    (256, 128, (4, 4, 4), (2, 2, 2), (1, 1, 1)),
                    (128, 64, (4, 1, 1), (2, 1, 1), (1, 0, 0)))):
                setattr(self, f"dec_ct{k}", ConvTranspose3d(
                    c_in, feats, kern, stride=st, padding=pad, bias=False))
                setattr(self, f"dec_ctbn{k}", BatchNorm3d(feats))
            for k, (c_in, feats) in enumerate(((64, 32), (32, 1))):
                setattr(self, f"dec_conv{k}", _conv3d(c_in, feats,
                                                      (3, 3, 3)))
                setattr(self, f"dec_bn{k}", BatchNorm3d(feats))
        self._finish(device, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """``[N, T, H, W, 3]`` -> f32 logits ``[N, classes]`` (and, with
        depth, the f32 map ``[N, T', H/4, W/4, 1]``).  Training with
        dropout needs ``generator``."""
        h = F.relu(self.stem_bn1(self.stem_spatial(self._input(x))))
        h = F.relu(self.stem_bn2(self.stem_temporal(h)))
        for i in range(1, 5):
            h = getattr(self, f"layer{i}")(h)
        logits = self._head(self.fc, h, generator)
        if not self.with_depth:
            return logits
        d = h                                       # layer4 [N, 512, 1, h, w]
        for k in range(3):
            d = F.relu(getattr(self, f"dec_ctbn{k}")(
                getattr(self, f"dec_ct{k}")(d)))
        for k in range(2):
            d = F.relu(getattr(self, f"dec_bn{k}")(
                getattr(self, f"dec_conv{k}")(d)))
        return logits, d.permute(0, 2, 3, 4, 1).float()


class SlowOnlyR50(_Video3D):
    """SlowFast's Slow pathway at R50 depth (``slow_r50``): 1x7x7 stem,
    temporal kernel 1 in res2/res3 and 3 in res4/res5, no temporal
    downsampling."""

    def __init__(self, num_class: int, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dropout, dtype)
        self.stem_conv = _conv3d(3, 64, (1, 7, 7), (1, 2, 2))
        self.stem_bn = BatchNorm3d(64)
        self.pool = nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        c = 64
        for i, (n, tk) in enumerate(zip((3, 4, 6, 3), (1, 1, 3, 3)), 1):
            planes = 64 * 2 ** (i - 1)
            blocks = []
            for j in range(n):
                blocks.append(SlowOnlyBottleneck(
                    c, planes, t_kernel=tk,
                    stride=2 if (i > 1 and j == 0) else 1,
                    has_downsample=j == 0))
                c = planes * 4
            setattr(self, f"layer{i}", nn.Sequential(*blocks))
        self.proj = Linear(2048, num_class)
        self._finish(device, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``[N, T, H, W, 3]`` -> f32 logits ``[N, classes]``."""
        h = F.relu(self.stem_bn(self.stem_conv(self._input(x))))
        h = self.pool(h)
        for i in range(1, 5):
            h = getattr(self, f"layer{i}")(h)
        return self._head(self.proj, h, generator)
