"""The plain reference model: TSN over ResNet-50 with ACTION or TSM sites,
the MTMM global depth decoder, written from the published descriptions in
plain PyTorch and float32.

* ResNet-50: torchvision's v1 bottleneck (stride on the 3x3 conv, 1x1
  downsample), the temporal module in place of each bottleneck's first 1x1
  conv ("residual shift": the identity path is not shifted).
* ACTION (Wang, She, Smolic, CVPR 2021, arXiv:2103.07372), as its official
  code computes it: a depthwise temporal ``Conv1d`` shift, then
  ``net(x_shift * (sigmoid(STE) + 1) + x_shift * (sigmoid(CE) + 1) +
  x_shift * (sigmoid(ME) + 1))`` with STE a ``Conv3d`` over the channel
  mean, CE a squeeze, temporal ``Conv1d``, ReLU and expand of the pooled
  feature, and ME the difference between the depthwise-convolved next frame
  and the current one of the squeezed, batch-normalised feature, zero for
  the last frame, pooled and expanded.
* TSM (Lin, Gan, Han, ICCV 2019, arXiv:1811.08383): the first ``C/div``
  channels read frame t+1, the next ``C/div`` frame t-1, zeros at the
  clip's edges.
* TSN: the pooled frame features, dropout in training, the linear head per
  frame and the mean over the frames (segment consensus).
* The MTMM decoder (the reference recipe's ``global_decoder``): three
  (3x3 conv, BN, ReLU, nearest x2) stages to 256, 64, 32 channels, a 3x3
  conv to 32 with BN and ReLU, a 1x1 conv with bias and a sigmoid.

Parameter and buffer names are those of the measured program's state dict,
so one seeded state dict loads into both with ``strict=True``.  Nothing here
imports the program.  ``fp8`` on a model (``set_fp8``) holds every
convolution's and the head's operands and output, every BN's output,
ACTION's gates and each block's output in float8 e4m3 with one scale a
tensor, and the gradients that flow back through them: the reference
computed in the lower precision that the benchmark's control asks for.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0          # largest finite float8 e4m3fn value


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _RoundFp8(torch.autograd.Function):
    """Round to float8 e4m3 with one scale a tensor, forward, and the
    gradient that passes back the same way: a layer's operands and their
    gradients held in float8."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g)


def held(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x`` as ``module`` holds it: in float8 where it is set to."""
    return _RoundFp8.apply(x) if getattr(module, "fp8", False) else x


class _Rounded:
    """Mixin of the layers whose operands the float8 control rounds."""

    def operands(self, x: torch.Tensor):
        return held(self, x), held(self, self.weight)


class Conv1d(_Rounded, nn.Conv1d):
    def forward(self, x):
        x, w = self.operands(x)
        return held(self, self._conv_forward(x, w, self.bias))


class Conv2d(_Rounded, nn.Conv2d):
    def forward(self, x):
        x, w = self.operands(x)
        return held(self, self._conv_forward(x, w, self.bias))


class Conv3d(_Rounded, nn.Conv3d):
    def forward(self, x):
        x, w = self.operands(x)
        return held(self, self._conv_forward(x, w, self.bias))


class Linear(_Rounded, nn.Linear):
    def forward(self, x):
        x, w = self.operands(x)
        return held(self, F.linear(x, w, self.bias))


class BatchNorm(nn.Module):
    """BatchNorm2d at momentum 0.1 and eps 1e-5 (unbiased running
    variance), without the ``num_batches_tracked`` counter."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    def forward(self, x):
        return held(self, F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            self.training, 0.1, 1e-5))


class ActionConv(nn.Module):
    """ACTION around a 1x1 conv ``c -> f`` over clips of ``t`` frames;
    input and output ``[N*T, C, H, W]``."""

    def __init__(self, c: int, f: int, t: int, device=None):
        super().__init__()
        cr = c // 16
        self.t = t
        kw = dict(bias=False, device=device)
        self.action_shift = Conv1d(c, c, 3, padding=1, groups=c, **kw)
        self.action_p1_conv1 = Conv3d(1, 1, 3, padding=1, **kw)
        self.action_p2_squeeze = Conv2d(c, cr, 1, **kw)
        self.action_p2_conv1 = Conv1d(cr, cr, 3, padding=1, **kw)
        self.action_p2_expand = Conv2d(cr, c, 1, **kw)
        self.action_p3_squeeze = Conv2d(c, cr, 1, **kw)
        self.action_p3_bn1 = BatchNorm(cr, device=device)
        self.action_p3_conv1 = Conv2d(cr, cr, 3, padding=1, groups=cr, **kw)
        self.action_p3_expand = Conv2d(cr, c, 1, **kw)
        self.net = Conv2d(c, f, 1, **kw)

    def forward(self, x):
        nt, c, h, w = x.shape
        t = self.t
        n = nt // t
        # temporal shift: a depthwise Conv1d over each pixel's frames
        xs = x.reshape(n, t, c, h, w).permute(0, 3, 4, 2, 1) \
            .reshape(n * h * w, c, t)
        xs = self.action_shift(xs).reshape(n, h, w, c, t) \
            .permute(0, 4, 3, 1, 2).reshape(nt, c, h, w)
        # STE: 3x3x3 conv of the channel mean
        p1 = xs.reshape(n, t, c, h, w).mean(2)[:, None]          # [n,1,t,h,w]
        p1 = held(self, torch.sigmoid(self.action_p1_conv1(p1)))[:, 0] \
            .reshape(nt, 1, h, w)
        # CE: squeeze, Conv1d over T, ReLU, expand of the pooled feature
        p2 = self.action_p2_squeeze(F.adaptive_avg_pool2d(xs, 1))
        cr = p2.shape[1]
        p2 = p2.reshape(n, t, cr).transpose(1, 2)                # [n,cr,t]
        p2 = torch.relu(self.action_p2_conv1(p2))
        p2 = p2.transpose(1, 2).reshape(nt, cr, 1, 1)
        p2 = held(self, torch.sigmoid(self.action_p2_expand(p2)))
        # ME: next frame's depthwise conv minus this frame, last frame 0
        x3 = self.action_p3_bn1(self.action_p3_squeeze(xs))
        x3c = self.action_p3_conv1(x3)
        x3 = x3.reshape(n, t, cr, h, w)
        x3c = x3c.reshape(n, t, cr, h, w)
        p3 = F.pad(x3c[:, 1:] - x3[:, :-1], (0, 0, 0, 0, 0, 0, 0, 1))
        p3 = F.adaptive_avg_pool2d(p3.reshape(nt, cr, h, w), 1)
        p3 = held(self, torch.sigmoid(self.action_p3_expand(p3)))
        out = (xs * p1 + xs) + (xs * p2 + xs) + (xs * p3 + xs)
        return self.net(out)


def tsm_shift(x: torch.Tensor, t: int, div: int) -> torch.Tensor:
    """TSM's zero-padded shift of ``[N*T, C, H, W]``."""
    nt, c, h, w = x.shape
    x = x.reshape(nt // t, t, c, h, w)
    fold = c // div
    out = torch.zeros_like(x)
    out[:, :-1, :fold] = x[:, 1:, :fold]
    out[:, 1:, fold:2 * fold] = x[:, :-1, fold:2 * fold]
    out[:, :, 2 * fold:] = x[:, :, 2 * fold:]
    return out.reshape(nt, c, h, w)


class TsmConv(nn.Module):
    def __init__(self, c: int, f: int, t: int, div: int, device=None):
        super().__init__()
        self.t, self.div = t, div
        self.net = Conv2d(c, f, 1, bias=False, device=device)

    def forward(self, x):
        return self.net(tsm_shift(x, self.t, self.div))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, down: bool,
                 temporal: str, t: int, shift_div: int, device=None):
        super().__init__()
        kw = dict(bias=False, device=device)
        if temporal == "action":
            self.conv1 = ActionConv(cin, planes, t, device=device)
        elif temporal == "tsm":
            self.conv1 = TsmConv(cin, planes, t, shift_div, device=device)
        else:
            self.conv1 = Conv2d(cin, planes, 1, **kw)
        self.bn1 = BatchNorm(planes, device=device)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, **kw)
        self.bn2 = BatchNorm(planes, device=device)
        self.conv3 = Conv2d(planes, planes * 4, 1, **kw)
        self.bn3 = BatchNorm(planes * 4, device=device)
        self.downsample = nn.Sequential(
            Conv2d(cin, planes * 4, 1, stride=stride, **kw),
            BatchNorm(planes * 4, device=device)) if down else None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return held(self, torch.relu(out + res))


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], temporal: str, t: int,
                 shift_div: int, device=None):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            device=device)
        self.bn1 = BatchNorm(64, device=device)
        cin = 64
        for i, (blocks, planes) in enumerate(
                zip(stage_sizes, (64, 128, 256, 512)), 1):
            layer = []
            for j in range(blocks):
                layer.append(Bottleneck(cin, planes,
                                        2 if i > 1 and j == 0 else 1, j == 0,
                                        temporal, t, shift_div,
                                        device=device))
                cin = planes * 4
            setattr(self, f"layer{i}", nn.Sequential(*layer))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x


class DepthDecoder(nn.Sequential):
    def __init__(self, cin: int, widths: Sequence[int], device=None):
        layers, c = [], cin
        for w in widths[:-1]:
            layers += [Conv2d(c, w, 3, padding=1, bias=False, device=device),
                       BatchNorm(w, device=device), nn.ReLU(),
                       nn.Upsample(scale_factor=2, mode="nearest")]
            c = w
        layers += [Conv2d(c, widths[-1], 3, padding=1, bias=False,
                          device=device),
                   BatchNorm(widths[-1], device=device), nn.ReLU(),
                   Conv2d(widths[-1], 1, 1, bias=True, device=device),
                   nn.Sigmoid()]
        super().__init__(*layers)


class TSN(nn.Module):
    """``[N, T, H, W, 3]`` normalised frames -> logits ``[N, classes]``
    (and, with the decoder, the depth map ``[N*T, h, w, 1]``)."""

    def __init__(self, model: Dict, with_depth: bool, device=None):
        super().__init__()
        self.t = model["num_segments"]
        self.dropout = model["dropout"]
        self.base_model = ResNet(model["stage_sizes"], model["temporal"],
                                 self.t, model["shift_div"], device=device)
        self.new_fc = Linear(model["feature_width"], model["num_classes"],
                             device=device)
        self.global_decoder = DepthDecoder(
            model["feature_width"], model["decoder_widths"],
            device=device) if with_depth else None

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        n, t = x.shape[:2]
        x = x.reshape((n * t,) + x.shape[2:]).permute(0, 3, 1, 2)
        f4 = self.base_model(x.contiguous())
        feat = f4.mean((2, 3))
        if mask is not None:
            feat = feat * mask / (1.0 - self.dropout)
        logits = self.new_fc(feat).reshape(n, t, -1).mean(1)
        if self.global_decoder is None:
            return logits
        return logits, self.global_decoder(f4).permute(0, 2, 3, 1)


def set_fp8(model: nn.Module, on: bool = True) -> nn.Module:
    for m in model.modules():
        m.fp8 = on
    return model


def normalize(frames_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 ``[..., H, W, 3]`` -> float32 ``(x / 255 - mean) / std``."""
    mean = torch.tensor(mean, dtype=torch.float32, device=frames_u8.device)
    std = torch.tensor(std, dtype=torch.float32, device=frames_u8.device)
    return (frames_u8.float() / 255.0 - mean) / std


def resize_square(x: torch.Tensor, size: int) -> torch.Tensor:
    """Antialiased bilinear resize of float ``[..., H, W, 3]`` to
    ``size`` x ``size`` (none where the frames have that size)."""
    h, w = x.shape[-3:-1]
    if (h, w) == (size, size):
        return x
    lead = x.shape[:-3]
    y = x.reshape((-1, h, w, 3)).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).reshape(lead + (size, size, 3))


def depth_target(depth_u8: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 depth ``[N, T, H, W, 1]`` -> ``[N*T, size, size, 1]`` in [0, 1],
    bilinear without antialiasing (the recipe's target)."""
    n, t, h, w, _ = depth_u8.shape
    d = depth_u8.float().reshape(n * t, 1, h, w) / 255.0
    if (h, w) != (size, size):
        d = F.interpolate(d, size=(size, size), mode="bilinear",
                          align_corners=False)
    return d.permute(0, 2, 3, 1)
