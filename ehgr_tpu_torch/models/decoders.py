"""Auxiliary heads (counterpart of ``ehgr_tpu/models/decoders.py``): the MTMM
global depth decoder, the SD exits (``SepConv``, ``Scala``) and the joint
stage's heads (``TransposedDecoder`` for depth and skeleton maps,
``TextEncoder`` for the clip's text embedding).

These BNs sit outside ``base_model``, so partial BN never freezes them: they
train on batch statistics whatever ``partial_bn`` says, while the
optimizer's walk still labels their scale and bias ``frozen`` under partial
BN (``train/optim.py``), as the reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ehgr_tpu_torch.models.layers import Conv1d, Conv2d, ConvTranspose2d
from ehgr_tpu_torch.models.norm import BatchNorm


class _Upsample2x(nn.Module):
    """Nearest-neighbour x2 (``nn.Upsample(scale_factor=2)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=2, mode="nearest")


class GlobalDepthDecoder(nn.Sequential):
    """layer4 ``[NT, 2048, 7, 7]`` -> sigmoid depth ``[NT, 1, 56, 56]``:
    (conv3x3 + BN + ReLU + nearest x2) for 256, 64, 32 channels, conv3x3 32
    + BN + ReLU, then a 1x1 conv with bias to one channel.  The module
    indices are the reference's ``nn.Sequential`` keys
    (``global_decoder.{0,1,4,5,8,9,12,13,15}``) that ``export_state_dict``
    emits."""

    def __init__(self, in_channels: int = 2048, device=None):
        layers = []
        c = in_channels
        for w in (256, 64, 32):
            layers += [Conv2d(c, w, 3, padding=1, bias=False, device=device),
                       BatchNorm(w, device=device), nn.ReLU(), _Upsample2x()]
            c = w
        layers += [Conv2d(c, 32, 3, padding=1, bias=False, device=device),
                   BatchNorm(32, device=device), nn.ReLU(),
                   Conv2d(32, 1, 1, bias=True, device=device), nn.Sigmoid()]
        super().__init__(*layers)


class TransposedDecoder(nn.Sequential):
    """The joint stage's decoder: (ConvTranspose 4x4 stride 2 + BN) through
    ``widths``, a last ConvTranspose to ``out_features`` (1 = depth, 42 =
    skeleton heatmaps) and a sigmoid, no ReLU; each stage doubles H and W.
    flax's ``ConvTranspose(padding='SAME', transpose_kernel=True)`` at k4 s2
    is torch's ``ConvTranspose2d(k=4, s=2, padding=1)``; keys ``2i`` (the
    i-th transposed conv) and ``2i+1`` (its BN), as the reference's
    ``nn.Sequential``."""

    def __init__(self, in_channels: int, widths, out_features: int = 1,
                 device=None):
        layers, c = [], in_channels
        for w in widths:
            layers += [ConvTranspose2d(c, w, 4, stride=2, padding=1,
                                       device=device),
                       BatchNorm(w, device=device)]
            c = w
        layers += [ConvTranspose2d(c, out_features, 4, stride=2, padding=1,
                                   device=device), nn.Sigmoid()]
        super().__init__(*layers)


class TextEncoder(nn.Sequential):
    """The clip-level text embedding: ``Conv1d(in_features -> features,
    kernel=T)`` + BN over the pooled per-frame features, ``[N, T, C] ->
    [N, features]``; keys ``0`` (the conv) and ``1`` (the BN)."""

    def __init__(self, in_features: int, t: int, features: int = 512,
                 device=None):
        super().__init__(Conv1d(in_features, features, t, device=device),
                         BatchNorm(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self
        y = conv(x.transpose(1, 2))                    # [N, features, 1]
        return bn(y[..., None])[:, :, 0, 0]


class SepConv(nn.Module):
    """Depthwise-separable double conv: (dw 3x3 stride 2 + pw) + BN + ReLU +
    (dw 3x3 + pw to ``features``) + BN + ReLU, as the reference's
    ``nn.Sequential`` ``op`` (keys ``op.{0,1,2,4,5,6}``)."""

    def __init__(self, in_channels: int, features: int, stride: int = 2,
                 device=None):
        super().__init__()
        c = in_channels
        kw = dict(bias=False, device=device)
        self.op = nn.Sequential(
            Conv2d(c, c, 3, stride=stride, padding=1, groups=c, **kw),
            Conv2d(c, c, 1, **kw), BatchNorm(c, device=device), nn.ReLU(),
            Conv2d(c, c, 3, padding=1, groups=c, **kw),
            Conv2d(c, features, 1, **kw), BatchNorm(features, device=device),
            nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Scala(nn.Sequential):
    """Stack of stride-2 ``SepConv`` layers through ``widths`` (``scala1``:
    256 -> 512, 1024, 2048), bringing a stage's taps to 2048 channels at
    the layer4 resolution; keys ``scala{k}.{i}.op.*``."""

    def __init__(self, in_channels: int, widths, device=None):
        layers, c = [], in_channels
        for w in widths:
            layers.append(SepConv(c, w, device=device))
            c = w
        super().__init__(*layers)
