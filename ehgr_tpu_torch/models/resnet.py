"""ResNet-50/101 backbone with temporal-module injection (counterpart of
``ehgr_tpu/models/resnet.py``).

torchvision ResNet v1 (stride on ``conv2``, 1x1 downsample); ``temporal``
decides what ``conv1`` of each bottleneck is at build time; ``partial_bn``
keeps every BN but the stem's on its running statistics in training,
the ACTION ``p3_bn1`` included; ``quantize`` makes the block convs int8
sites at eval (``ops/quantize.py``): ``conv2``, ``conv3``, the downsample
conv and a plain ``conv1`` (the ACTION and TSM ``conv1`` stay float, and so
do the stem and the heads); ``remat`` recomputes each bottleneck's
forward in the backward pass instead of keeping its activations (the JAX
``nn.remat(Bottleneck)``); ``temporal_pool`` max-pools T by 2 after
stage 2, so the temporal modules of stages 3-4 see T/2 frames.  Module
names follow the torch keys of ``export_state_dict`` (``layer{i}.{j}``,
``downsample.0/1``).  Activations are ``[N*T, C, H, W]`` channels_last.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ehgr_tpu_torch.models.layers import Conv2d
from ehgr_tpu_torch.models.norm import BatchNorm
from ehgr_tpu_torch.ops.action import ActionConv, TSMConv
from ehgr_tpu_torch.ops.quantize import QuantConv
from ehgr_tpu_torch.ops.temporal_shift import temporal_pool as _tpool

STAGE_SIZES = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
}


class Bottleneck(nn.Module):
    """torchvision Bottleneck (expansion 4) with a temporal ``conv1``;
    ``quantize`` (False, True = ``'dynamic'``, ``'dynamic'``, ``'static'``
    or ``'calib'``) builds its int8 sites as ``QuantConv``."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, temporal: str = "none",
                 n_segment: int = 8, shift_div: int = 8, action_fused=None,
                 bn_frozen: bool = True, quantize=False, device=None):
        super().__init__()
        kw = dict(bias=False, device=device)
        bn = dict(frozen=bn_frozen, device=device)
        if quantize:
            mode = "dynamic" if quantize is True else str(quantize)

            def conv(*a, **k):
                return QuantConv(*a, quantize=mode, device=device, **k)
        else:
            def conv(*a, **k):
                return Conv2d(*a, **kw, **k)
        if temporal == "action":
            self.conv1 = ActionConv(in_planes, planes, n_segment,
                                    shift_div=shift_div, fused=action_fused,
                                    bn_frozen=bn_frozen, device=device)
        elif temporal == "tsm":
            self.conv1 = TSMConv(in_planes, planes, n_segment,
                                 shift_div=shift_div, device=device)
        elif temporal == "none":
            self.conv1 = conv(in_planes, planes, 1)
        else:
            raise ValueError(f"unknown temporal module {temporal!r}")
        self.bn1 = BatchNorm(planes, **bn)
        # explicit pad 1 on the strided 3x3, torch's own semantics
        self.conv2 = conv(planes, planes, 3, stride=stride, padding=1)
        self.bn2 = BatchNorm(planes, **bn)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm(planes * 4, **bn)
        self.downsample = nn.Sequential(
            conv(in_planes, planes * 4, 1, stride=stride),
            BatchNorm(planes * 4, **bn)) if has_downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


@contextlib.contextmanager
def _buffers_kept(module: nn.Module):
    """Restore ``module``'s buffers (BN running statistics and counters) on
    exit.  Around a rematerialised block's recompute: torch's BN, and the
    ACTION region's ME BN, update their statistics on every training
    forward, and the recompute is a second forward of the same batch;
    flax's remat returns the statistics of the first forward alone."""
    kept = [(b, b.clone()) for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in kept:
                b.copy_(v)


def _run_remat(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return checkpoint(block, x, use_reentrant=False,
                      preserve_rng_state=False,   # a block draws nothing
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _buffers_kept(block)))


class ResNetBackbone(nn.Module):
    """ResNet with per-stage taps: ``forward`` returns ``stem``
    (post-maxpool), ``layer1..4`` and ``pool`` (global average,
    ``[NT, C]``).  ``stages < 4`` builds and runs only the first ones (a
    truncated deploy model has no deeper weights, and no ``pool`` tap).
    ``remat`` takes effect where autograd records (training).
    ``temporal_pool``: after stage 2 (its tap keeps T frames) the frames of
    each clip are max-pooled by 2 (kernel 3, padding 1), and every
    temporal module of stages 3-4 is built for ``n_segment // 2``.
    ``quantize``: each bottleneck's int8 sites (see ``Bottleneck``)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 temporal: str = "action", n_segment: int = 8,
                 shift_div: int = 8, action_fused=None,
                 action_stages: Sequence[int] = (1, 2, 3, 4),
                 partial_bn: bool = True, stages: int = 4,
                 remat: bool = False, temporal_pool: bool = False,
                 quantize=False, device=None):
        super().__init__()
        self.stages = stages
        self.remat = remat
        self.temporal_pool = temporal_pool
        self.n_segment = n_segment
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            device=device)
        self.bn1 = BatchNorm(64, device=device)
        in_planes = 64
        for i, (n_blocks, p) in enumerate(
                zip(stage_sizes[:stages], (64, 128, 256, 512)), 1):
            # ACTION on every block; every other one for >=23-block stages
            n_round = 2 if n_blocks >= 23 else 1
            seg = n_segment // 2 if temporal_pool and i > 2 else n_segment
            blocks = []
            for j in range(n_blocks):
                blocks.append(Bottleneck(
                    in_planes, p, stride=2 if (i > 1 and j == 0) else 1,
                    has_downsample=(j == 0),
                    temporal=temporal if (j % n_round == 0 and
                                          i in action_stages) else "none",
                    n_segment=seg, shift_div=shift_div,
                    action_fused=action_fused, bn_frozen=partial_bn,
                    quantize=quantize, device=device))
                in_planes = p * 4
            setattr(self, f"layer{i}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        taps: Dict[str, torch.Tensor] = {"stem": x}
        for i in range(1, 5):
            if i > self.stages:
                return taps
            layer = getattr(self, f"layer{i}")
            if self.remat and torch.is_grad_enabled():
                for block in layer:
                    x = _run_remat(block, x)
            else:
                x = layer(x)
            taps[f"layer{i}"] = x
            if self.temporal_pool and i == 2 and self.stages > 2:
                nt, c, h, w = x.shape
                x = _tpool(x.permute(0, 2, 3, 1).reshape(
                    nt // self.n_segment, self.n_segment, h, w, c))
                x = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        taps["pool"] = x.mean((2, 3))          # AdaptiveAvgPool2d(1)
        return taps
