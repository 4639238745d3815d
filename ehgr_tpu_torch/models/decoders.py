"""Auxiliary heads (counterpart of ``ehgr_tpu/models/decoders.py``): the MTMM
global depth decoder.  ``Scala``, ``TransposedDecoder`` and ``TextEncoder``
(the SD and joint-stage heads) are ROADMAP items.

The decoder's BNs sit outside ``base_model``, so partial BN never freezes
them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ehgr_tpu_torch.models.layers import Conv2d
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
