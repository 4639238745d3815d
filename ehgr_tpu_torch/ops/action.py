"""ACTION temporal module (counterpart of ``ehgr_tpu/ops/action.py``): a
wrapper around a bottleneck's 1x1 ``conv1`` adding a learnable temporal
shift and three multiplicative gates, then the wrapped conv on the gated
sum.

  x_shift = learnable_shift(x)
  STE: sigmoid(conv3d_3x3x3(mean_c(x_shift)))
  CE : sigmoid(expand(relu(conv1d_T(squeeze(gap(x_shift))))))
  ME : sigmoid(expand(gap(pad_T(dwconv3x3(x3)[1:] - x3[:-1])))),
       x3 = bn(x_shift @ W_p3)
  out = net(x_shift * (g_ste + g_ce + g_me + 3))

Modules take ``[N*T, C, H, W]`` in ``channels_last``; the gates work on the
free ``[N, T, S, C]`` view.  At eval, mode ``'mega'`` runs the two-sweep
kernels and ``'prologue'`` the one-pass prologue kernel (``x_shift``, the
gate statistics and the ME squeeze), its tail in PyTorch.  In training, mode
``'vjp'`` runs the gate block as one autograd region on the kernels
(``ops/action_vjp.py``); the other modes take plain autograd of the
formulation above, as the JAX package does (``'mega'`` and ``'prologue'``
are eval formulations).  ``quantize='static'`` / ``'calib'`` is the
opt-in int8 wrapped 1x1 (``ops/quantize.py``), at eval in the plain and
prologue formulations; ``'mega'`` and training ignore it, as in the JAX
package, whose ResNet leaves it off.  Submodule names are the reference's
torch keys (``action_shift``, ``action_p1_conv1``, ..., ``net``), which
``export_state_dict`` emits, so converted JAX weights load strictly.
Weights are cast to the input's dtype at use, as flax does.

The gate-only ``ActionGate`` (``features=0``, BN-Inception's block
entries) returns the gated sum itself: at eval in ``'mega'`` and
``'prologue'`` it takes ``x_shift`` and its statistics from the
``action_prologue`` kernel, and in training in ``'vjp'`` its shift runs on
the shift kernels (``LearnableShift``) with autograd for the rest; the
values are the plain formulation's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ehgr_tpu_torch.models.layers import Conv2d
from ehgr_tpu_torch.models.norm import BatchNorm
from ehgr_tpu_torch.ops.action_vjp import ActionRegion
from ehgr_tpu_torch.ops.kernels.action_fused import action_prologue
from ehgr_tpu_torch.ops.kernels.action_mega import (action_apply,
                                                    action_stats,
                                                    ste_stencil)
from ehgr_tpu_torch.ops.kernels.shift import LearnableShift
from ehgr_tpu_torch.ops.kernels.tsm_shift import TsmShift
from ehgr_tpu_torch.ops.quantize import (MIN_SCALE, WeightCodes,
                                         int8_forward, record_amax)
from ehgr_tpu_torch.ops.temporal_shift import learnable_shift, tsm_shift_init
from ehgr_tpu_torch.parallel.collectives import group_size

_MODES = {None: "none", False: "none", "none": "none", "vjp": "vjp",
          True: "prologue", "prologue": "prologue", "mega": "mega"}


def _nchw(x4: torch.Tensor, nt: int, h: int, w: int) -> torch.Tensor:
    """``[N, T, S, C]`` -> ``[N*T, C, H, W]`` channels_last view."""
    return x4.reshape(nt, h, w, x4.shape[-1]).permute(0, 3, 1, 2)


class _ShiftTaps(nn.Module):
    """Holder of the learnable shift's ``weight [C, 1, 3]`` (the reference's
    grouped ``Conv1d``), TSM-initialized."""

    def __init__(self, c: int, shift_div: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            tsm_shift_init(c, shift_div, device=device).t()[:, None, :]
            .contiguous())

    def taps(self, dtype: torch.dtype) -> torch.Tensor:
        """``[3, C]`` cross-correlation taps in ``dtype``."""
        return self.weight[:, 0, :].t().to(dtype).contiguous()


class ActionConv(nn.Module):
    """ACTION wrapper owning the conv it feeds.

    ``fused`` selects the formulation: at eval ``'mega'`` runs the
    ``action_stats``/``action_apply`` kernels, ``True``/``'prologue'`` the
    ``action_prologue`` kernel and ``None``/``False``/``'none'``/``'vjp'``
    the same math as PyTorch ops; in training ``'vjp'`` runs
    ``ActionRegion`` (the kernels forward, a hand-structured backward) and
    every other mode plain autograd.
    ``bn_frozen`` keeps the ME branch's BN on its running statistics in
    training (partial BN).  ``features=0`` is the gate-only ``ActionGate``.
    ``quantize`` (False, ``'static'`` or ``'calib'``): the wrapped conv's
    int8 path at eval outside ``'mega'``, with its per-tensor scale of the
    gated sum in the non-persistent buffer ``act_scale``."""

    def __init__(self, in_channels: int, features: int, n_segment: int,
                 shift_div: int = 8, fused=None, bn_frozen: bool = True,
                 quantize=False, device=None):
        super().__init__()
        if fused not in _MODES:
            raise ValueError(f"unknown ActionConv mode {fused!r}")
        if quantize not in (False, None, "static", "calib"):
            raise ValueError(f"unknown ActionConv quantize {quantize!r}")
        self.mode = _MODES[fused]
        self.quantize = quantize or False
        if self.quantize:
            self.register_buffer("act_scale", torch.zeros((), device=device),
                                 persistent=False)
            self.codes = WeightCodes()
        c, cr = in_channels, in_channels // 16
        self.features = features
        self.n_segment = n_segment
        kw = dict(bias=False, device=device)
        self.action_shift = _ShiftTaps(c, shift_div, device=device)
        self.action_p1_conv1 = nn.Conv3d(1, 1, 3, padding=1, **kw)
        self.action_p2_squeeze = nn.Conv2d(c, cr, 1, **kw)
        self.action_p2_conv1 = nn.Conv1d(cr, cr, 3, padding=1, **kw)
        self.action_p2_expand = nn.Conv2d(cr, c, 1, **kw)
        self.action_p3_squeeze = nn.Conv2d(c, cr, 1, **kw)
        self.action_p3_bn1 = BatchNorm(cr, frozen=bn_frozen, device=device)
        self.action_p3_conv1 = nn.Conv2d(cr, cr, 3, padding=1, groups=cr,
                                         **kw)
        self.action_p3_expand = nn.Conv2d(cr, c, 1, **kw)
        if features:
            self.net = nn.Conv2d(c, features, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nt, c, h, w = x.shape
        t = self.n_segment
        n, s, dt = nt // t, h * w, x.dtype
        # the kernels need the [N,T,S,C] view dense; cuDNN may hand back
        # another layout
        x4 = x.contiguous(memory_format=torch.channels_last) \
            .permute(0, 2, 3, 1).reshape(n, t, s, c)
        if self.training and self.mode == "vjp" and self.features > 0:
            return _nchw(self._region(x4, h, w), nt, h, w)
        shift_w = self.action_shift.taps(dt)                    # [3, C]
        w_p3 = self.action_p3_squeeze.weight[:, :, 0, 0].t().to(dt) \
            .contiguous()                                       # [C, Cr]
        k_p1 = self.action_p1_conv1.weight[0, 0]                # [3,3,3]
        use_mega = self.mode == "mega" and self.features > 0 and \
            not self.training

        if use_mega:
            mc, pooled, x3 = action_stats(x4, shift_w, w_p3)
        elif not self.training and self.mode in ("prologue", "mega"):
            # 'mega' lands here gate-only: no wrapped conv for its sweep 2
            xs, mc, pooled, x3 = action_prologue(x4, shift_w, w_p3)
        else:
            # training in 'vjp' lands here gate-only (ActionGate)
            shift = LearnableShift.apply if self.training and \
                self.mode == "vjp" else learnable_shift
            xs = shift(x4, shift_w)                             # [N,T,S,C]
            pooled = xs.mean(2)                                 # [N,T,C]
            x3 = xs @ w_p3                                      # [N,T,S,Cr]
            mc = xs.mean(-1)
        g1 = torch.sigmoid(ste_stencil(mc.reshape(n, t, h, w),
                                       k_p1))                   # [N,T,H,W]

        # CE: channel excitation
        p2 = F.linear(pooled, self.action_p2_squeeze.weight[:, :, 0, 0]
                      .to(dt))                                  # [N,T,Cr]
        p2 = F.conv1d(p2.transpose(1, 2), self.action_p2_conv1.weight.to(dt),
                      padding=1).transpose(1, 2)                # conv over T
        p2 = F.linear(torch.relu(p2),
                      self.action_p2_expand.weight[:, :, 0, 0].to(dt))
        g2 = torch.sigmoid(p2)                                  # [N,T,C]

        # ME: motion excitation on the squeezed x_shift
        x3 = self.action_p3_bn1(_nchw(x3, nt, h, w))           # [NT,Cr,H,W]
        x3c = F.conv2d(x3, self.action_p3_conv1.weight.to(dt), padding=1,
                       groups=x3.shape[1])
        m3 = x3.mean((2, 3)).reshape(n, t, -1)
        m3c = x3c.mean((2, 3)).reshape(n, t, -1)
        p3 = torch.cat([m3c[:, 1:] - m3[:, :-1],
                        torch.zeros_like(m3[:, :1])], dim=1)    # pad last t
        g3 = torch.sigmoid(F.linear(
            p3, self.action_p3_expand.weight[:, :, 0, 0].to(dt)))

        g1 = g1.reshape(n, t, s, 1)
        if use_mega:
            gch = (g2 + g3 + 3.0).to(dt)                        # [N,T,C]
            w_net = self.net.weight[:, :, 0, 0].t().to(dt).contiguous()
            return _nchw(action_apply(x4, shift_w, g1, gch, w_net), nt, h, w)

        gated = xs * (g1 + g2[:, :, None, :] + g3[:, :, None, :]) + 3.0 * xs
        if self.features == 0:                                  # ActionGate
            return _nchw(gated, nt, h, w)
        if self.quantize == "calib" and not self.training:
            record_amax(self.act_scale, gated)
        elif self.quantize == "static" and not self.training:
            return int8_forward(_nchw(gated, nt, h, w),
                                self.codes(self.net.weight),
                                torch.clamp_min(self.act_scale, MIN_SCALE),
                                1, 0)
        out = gated @ self.net.weight[:, :, 0, 0].t().to(dt)
        return _nchw(out, nt, h, w)

    def _region(self, x4: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """Training in mode ``'vjp'``: the gate block as ``ActionRegion``,
        then torch's running-statistics update of the ME BN (momentum 0.1,
        unbiased variance, the global count on a mesh) when it trains."""
        bn = self.action_p3_bn1
        small = (self.action_p1_conv1.weight, self.action_p2_squeeze.weight,
                 self.action_p2_conv1.weight, self.action_p2_expand.weight,
                 bn.weight, bn.bias, self.action_p3_conv1.weight,
                 self.action_p3_expand.weight)
        out, mean, var = ActionRegion.apply(
            x4, (h, w), bn.training, bn.data_group, bn.eps,
            self.action_shift.weight[:, 0, :].t(),
            self.action_p3_squeeze.weight[:, :, 0, 0].t(),
            self.net.weight[:, :, 0, 0].t(), bn.running_mean,
            bn.running_var, *small)
        if bn.training:
            cnt = x4.numel() // x4.shape[-1] * (
                1 if bn.data_group is None else group_size(bn.data_group))
            with torch.no_grad():
                bn.running_mean.mul_(1.0 - bn.momentum).add_(
                    mean, alpha=bn.momentum)
                bn.running_var.mul_(1.0 - bn.momentum).add_(
                    var * (cnt / max(cnt - 1, 1)), alpha=bn.momentum)
        return out


def ActionGate(in_channels: int, n_segment: int, shift_div: int = 8,
               fused=None, device=None) -> ActionConv:
    """ACTION gating without a wrapped conv (channel-preserving gated
    sum), its ME BN on batch statistics in training."""
    return ActionConv(in_channels, 0, n_segment, shift_div=shift_div,
                      fused=fused, bn_frozen=False, device=device)


def tsm_shift_nchw(x: torch.Tensor, n_segment: int,
                   shift_div: int) -> torch.Tensor:
    """The TSM shift of ``[N*T, C, H, W]`` on the ``tsm_shift`` kernel
    (``TsmShift``, forward and backward) over its ``[N, T, S, C]`` view,
    returned as a ``channels_last`` view."""
    nt, c, h, w = x.shape
    # the kernel needs the [N,T,S,C] view dense (as in ActionConv)
    x4 = x.contiguous(memory_format=torch.channels_last) \
        .permute(0, 2, 3, 1).reshape(nt // n_segment, n_segment, h * w, c)
    return _nchw(TsmShift.apply(x4, shift_div), nt, h, w)


class TSMConv(nn.Module):
    """TSM wrapper: the zero-pad channel shift (the ``tsm_shift`` kernel on
    the ``[N, T, S, C]`` view, forward and backward), then the wrapped 1x1
    conv."""

    def __init__(self, in_channels: int, features: int, n_segment: int,
                 shift_div: int = 8, device=None):
        super().__init__()
        self.n_segment = n_segment
        self.shift_div = shift_div
        self.net = Conv2d(in_channels, features, 1, bias=False,
                          device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(tsm_shift_nchw(x, self.n_segment, self.shift_div))
