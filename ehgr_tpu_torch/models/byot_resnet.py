"""The image-level BYOT self-distillation ResNet (counterpart of
``ehgr_tpu/models/byot_resnet.py``): a ResNet-50 whose stages 1-3 each feed
an attention-gated early exit (``SepConv`` + BN + ReLU + bilinear x2
upsample + sigmoid mask, times the stage's output), then a stack of
stride-2 ``SepConv``s to 2048 channels (``scala{i}_sep{k}``), a global
average and a linear head ``fc{i}``; stage 4 feeds ``fc4`` directly.  The
video self-distillation model is ``TSN`` with ``with_sd``; this one
classifies images.

Module names follow the port's converter (``models/convert.py``):
``layer{i}.{j}``, ``attention{i}.sep.op.*`` / ``attention{i}.bn``,
``scala{i}_sep{k}.op.*``, ``fc{i}``.  Every BN trains on batch statistics.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ehgr_tpu_torch.device import DeviceLike, resolve_device
from ehgr_tpu_torch.models.decoders import SepConv
from ehgr_tpu_torch.models.layers import Conv2d, Linear, init_params
from ehgr_tpu_torch.models.norm import BatchNorm
from ehgr_tpu_torch.models.resnet import Bottleneck

# SepConv widths of the exit of each of stages 1-3
_WIDTHS = {1: (512, 1024, 2048), 2: (1024, 2048), 3: (2048,)}


def _upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear, half-pixel centres, edges clamped (``jax.image.resize``
    'bilinear' upsampling)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class _Attention(nn.Module):
    """SepConv (C -> C, stride 2) + BN + ReLU + bilinear x2 + sigmoid."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.sep = SepConv(c, c, device=device)
        self.bn = BatchNorm(c, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn(self.sep(x)))
        return torch.sigmoid(_upsample2x_bilinear(h))


class BYOTResNet(nn.Module):
    """``forward(x [N, H, W, 3])`` -> ``(out1, ..., out4, fea1, ...,
    fea4)``: each exit's f32 logits ``[N, num_class]`` and pooled feature
    ``[N, 2048]``; ``out4`` (the deepest head) is the teacher.  Parameters
    are f32 on ``device`` (default CUDA), drawn from ``generator`` (default
    a CPU generator seeded 0) as ``init_params`` draws them; ``dtype`` is
    the compute dtype."""

    def __init__(self, num_class: int,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: torch.Generator = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            device=dev)
        self.bn1 = BatchNorm(64, device=dev)
        in_planes = 64
        for i, (n_blocks, p) in enumerate(zip(stage_sizes,
                                              (64, 128, 256, 512)), 1):
            blocks = []
            for j in range(n_blocks):
                blocks.append(Bottleneck(
                    in_planes, p, stride=2 if (i > 1 and j == 0) else 1,
                    has_downsample=(j == 0), bn_frozen=False, device=dev))
                in_planes = p * 4
            setattr(self, f"layer{i}", nn.Sequential(*blocks))
            if i < 4:
                setattr(self, f"attention{i}", _Attention(p * 4, dev))
                c = p * 4
                for k, w in enumerate(_WIDTHS[i]):
                    setattr(self, f"scala{i}_sep{k}", SepConv(c, w,
                                                              device=dev))
                    c = w
            setattr(self, f"fc{i}", Linear(2048, num_class, device=dev))
        init_params(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))
        self.eval()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = x.to(self.dtype).permute(0, 3, 1, 2)       # channels_last view
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs, feas = [], []
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            h = x
            if i < 4:
                h = getattr(self, f"attention{i}")(x) * x
                for k in range(len(_WIDTHS[i])):
                    h = getattr(self, f"scala{i}_sep{k}")(h)
            pooled = h.mean((2, 3))
            feas.append(pooled.float())
            outs.append(getattr(self, f"fc{i}")(pooled).float())
        return tuple(outs) + tuple(feas)
