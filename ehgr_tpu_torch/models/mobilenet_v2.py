"""MobileNetV2 backbone with ACTION on the residual expand convs
(counterpart of ``ehgr_tpu/models/mobilenet_v2.py``).

Width-multiplier-1 MobileNetV2; when ``temporal='action'``, ``ActionConv``
takes the place of ``conv.0`` (the 1x1 expand conv) of every
residual-connected ``InvertedResidual`` with expand ratio != 1: 10 sites,
at C = 24, 32 (x2), 64 (x3), 96 (x2) and 160 (x2).  ``temporal='tsm'``
adds nothing here, as in the JAX package.

Module names are the reference's torch keys: ``features.{i}.conv.{j}``
inside an inverted residual (a ``nn.Sequential`` with its ReLU6 at the
indices between), ``features.{i}.{0,1}`` for the conv and BN of the stem
(``features.0``) and of the last 1x1 conv (``features.18``).

Every BN trains on batch statistics whatever ``partial_bn`` says: the JAX
backbone gives its BNs no frozen mode, and its optimizer policy freezes
none of them either, since their flax names (``c1``, ``conv_{j}``) lack
"bn" (``BatchNorm.policy_bn``).  The ACTION sites' own ME BN stays on its
running statistics, as the JAX ``ActionConv``'s default has it.
Activations are ``[N*T, C, H, W]`` channels_last.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ehgr_tpu_torch.models.layers import Conv2d
from ehgr_tpu_torch.models.norm import BatchNorm
from ehgr_tpu_torch.ops.action import ActionConv

# t (expand), c (out), n (repeat), s (stride) of each stage
_SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def _bn(c: int, device) -> BatchNorm:
    bn = BatchNorm(c, device=device)
    bn.policy_bn = False               # its flax name lacks "bn"
    return bn


def _conv_bn(c_in: int, c_out: int, kernel: int, stride: int,
             device) -> nn.Sequential:
    """Conv (no bias) + BN + ReLU6: the stem and the last 1x1 conv."""
    return nn.Sequential(
        Conv2d(c_in, c_out, kernel, stride=stride, padding=(kernel - 1) // 2,
               bias=False, device=device),
        _bn(c_out, device), nn.ReLU6())


class InvertedResidual(nn.Module):
    """[expand 1x1 + BN + ReLU6] + depthwise 3x3 + BN + ReLU6 + 1x1 + BN,
    with the identity added when the block keeps its shape; the expand conv
    is an ``ActionConv`` when ``temporal='action'`` and it does."""

    def __init__(self, c_in: int, c_out: int, stride: int, expand: int,
                 temporal: str = "none", n_segment: int = 8,
                 shift_div: int = 8, action_fused=None, device=None):
        super().__init__()
        hidden = c_in * expand
        self.use_res = stride == 1 and c_in == c_out
        kw = dict(bias=False, device=device)
        layers = []
        if expand != 1:
            if temporal == "action" and self.use_res:
                layers.append(ActionConv(c_in, hidden, n_segment,
                                         shift_div=shift_div,
                                         fused=action_fused, device=device))
            else:
                layers.append(Conv2d(c_in, hidden, 1, **kw))
            layers += [_bn(hidden, device), nn.ReLU6()]
        layers += [Conv2d(hidden, hidden, 3, stride=stride, padding=1,
                          groups=hidden, **kw),
                   _bn(hidden, device), nn.ReLU6(),
                   Conv2d(hidden, c_out, 1, **kw), _bn(c_out, device)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        return x + h if self.use_res else h


class MobileNetV2Backbone(nn.Module):
    """``forward`` returns ``pool`` (``[NT, 1280]``, the global average)
    and ``final`` (the last feature map): the plain TSN surface only.
    ``partial_bn`` is taken for the factory's sake and changes nothing
    (see the module docstring)."""

    def __init__(self, temporal: str = "none", n_segment: int = 8,
                 shift_div: int = 8, action_fused=None,
                 partial_bn: bool = True, device=None):
        super().__init__()
        if temporal not in ("action", "tsm", "none"):
            raise ValueError(f"unknown temporal module {temporal!r}")
        blocks = [_conv_bn(3, 32, 3, 2, device)]
        c_in = 32
        for t, c, n, s in _SETTING:
            for k in range(n):
                blocks.append(InvertedResidual(
                    c_in, c, s if k == 0 else 1, t, temporal=temporal,
                    n_segment=n_segment, shift_div=shift_div,
                    action_fused=action_fused, device=device))
                c_in = c
        blocks.append(_conv_bn(c_in, 1280, 1, 1, device))
        self.features = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.features(x)
        return {"pool": x.mean((2, 3)), "final": x}
