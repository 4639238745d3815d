"""Res2Net-50 (26w x 4s) backbone with a temporal ``conv1`` in every block
(counterpart of ``ehgr_tpu/models/res2net.py``).

``Bottle2neck``: width = floor(planes * 26 / 64), scale 4; ``conv1`` (the
1x1 to width * 4, an ``ActionConv`` or ``TSMConv`` by ``temporal``), then
3x3 convs over the first three width-slices (``stype='normal'``: each slice
plus the previous conv's output; ``'stage'``, the first block of a stage:
each slice alone, and the fourth slice average-pooled with the stride),
the 1x1 ``conv3`` to planes * 4, the downsample in the first block of a
stage, stride on the 3x3s.  ``Res2NetBackbone`` has the ResNet backbone's
tap contract (``stem``, ``layer1..4``, ``pool``; ``stages < 4`` builds
only the first ones), so the SD exits and the depth decoder take its
taps.  Module names are the reference's torch keys (``layer{i}.{j}``,
``convs.{k}``, ``bns.{k}``, ``downsample.0/1``).

Every BN trains on batch statistics whatever ``partial_bn`` says, as the
JAX backbone builds them (its optimizer policy then gives them lr 0 under
partial BN); each ACTION site's ME BN stays on its running statistics, as
the JAX ``ActionConv``'s default has it.  Activations are
``[N*T, C, H, W]`` channels_last.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ehgr_tpu_torch.models.layers import Conv2d
from ehgr_tpu_torch.models.norm import BatchNorm
from ehgr_tpu_torch.ops.action import ActionConv, TSMConv


def _avg_pool_3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """AvgPool2d(3, stride, padding=1), padding counted in the mean."""
    return F.avg_pool2d(x, 3, stride=stride, padding=1,
                        count_include_pad=True)


class Bottle2neck(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, stype: str = "normal",
                 base_width: int = 26, scale: int = 4,
                 temporal: str = "none", n_segment: int = 8,
                 shift_div: int = 8, action_fused=None, device=None):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64.0)))
        ws = width * scale
        self.width, self.scale, self.stype = width, scale, stype
        self.stride = stride
        kw = dict(bias=False, device=device)
        if temporal == "action":
            self.conv1 = ActionConv(in_planes, ws, n_segment,
                                    shift_div=shift_div, fused=action_fused,
                                    device=device)
        elif temporal == "tsm":
            self.conv1 = TSMConv(in_planes, ws, n_segment,
                                 shift_div=shift_div, device=device)
        elif temporal == "none":
            self.conv1 = Conv2d(in_planes, ws, 1, **kw)
        else:
            raise ValueError(f"unknown temporal module {temporal!r}")
        self.bn1 = BatchNorm(ws, device=device)
        nums = 1 if scale == 1 else scale - 1
        self.convs = nn.ModuleList(
            Conv2d(width, width, 3, stride=stride, padding=1, **kw)
            for _ in range(nums))
        self.bns = nn.ModuleList(BatchNorm(width, device=device)
                                 for _ in range(nums))
        self.conv3 = Conv2d(ws, planes * 4, 1, **kw)
        self.bn3 = BatchNorm(planes * 4, device=device)
        self.downsample = nn.Sequential(
            Conv2d(in_planes, planes * 4, 1, stride=stride, **kw),
            BatchNorm(planes * 4, device=device)) if has_downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        spx = torch.split(out, self.width, dim=1)
        pieces, sp = [], None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = spx[i] if i == 0 or self.stype == "stage" else sp + spx[i]
            sp = torch.relu(bn(conv(sp)))
            pieces.append(sp)
        if self.scale != 1:
            tail = spx[len(self.convs)]
            if self.stype == "stage":
                tail = _avg_pool_3x3(tail, self.stride)
            pieces.append(tail)
        out = self.bn3(self.conv3(torch.cat(pieces, dim=1)))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class Res2NetBackbone(nn.Module):
    """res2net50_26w_4s with the ResNet backbone's tap dict (see the module
    docstring); ``partial_bn`` is taken for the factory's sake and changes
    no BN's mode."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 temporal: str = "none", n_segment: int = 8,
                 shift_div: int = 8, action_fused=None,
                 partial_bn: bool = True, stages: int = 4, device=None):
        super().__init__()
        self.stages = stages
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            device=device)
        self.bn1 = BatchNorm(64, device=device)
        in_planes = 64
        for i, (n_blocks, p) in enumerate(
                zip(stage_sizes[:stages], (64, 128, 256, 512)), 1):
            blocks = []
            for j in range(n_blocks):
                blocks.append(Bottle2neck(
                    in_planes, p, stride=2 if (i > 1 and j == 0) else 1,
                    has_downsample=(j == 0),
                    stype="stage" if j == 0 else "normal",
                    temporal=temporal, n_segment=n_segment,
                    shift_div=shift_div, action_fused=action_fused,
                    device=device))
                in_planes = p * 4
            setattr(self, f"layer{i}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        taps: Dict[str, torch.Tensor] = {"stem": x}
        for i in range(1, self.stages + 1):
            x = getattr(self, f"layer{i}")(x)
            taps[f"layer{i}"] = x
        if self.stages == 4:
            taps["pool"] = x.mean((2, 3))
        return taps
