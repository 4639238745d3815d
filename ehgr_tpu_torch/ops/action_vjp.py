"""The ACTION gate block as one autograd region with a hand-structured
backward (counterpart of ``ehgr_tpu/ops/action_vjp.py``, the JAX package's
default training backward, ``action_fused='vjp'``).

Forward, on ``x4 [N,T,S,C]``:

  ``action_stats`` (kernel)   -> mc [N,T,S,1], pooled [N,T,C], x3r [N,T,S,Cr]
  gate heads (small, PyTorch) -> g1 [N,T,S,1], g2, g3 [N,T,C], BN stats
  ``action_apply`` (kernel)   -> (x_shift * (g1 + g2 + g3 + 3)) @ W_net

Only the input and the small tensors are saved.  The backward recomputes
``x_shift`` with ``learnable_shift_fwd``, takes the wrapped conv's transposes
as ``torch.matmul``, the gate heads' VJP as autograd over the small segment,
sums the four contributions to ``d x_shift`` in one expression and ends in
``learnable_shift_bwd`` (dx and the taps' gradient).  The BN statistics the
region returns get no cotangent.  On the CPU every kernel call takes its
plain version.  On a mesh the ME BN's training statistics are the global
batch's (``bn_group``: the BN's data group), their VJP through the
differentiable ``all_reduce``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ehgr_tpu_torch.ops.kernels.action_mega import (action_apply,
                                                    action_stats,
                                                    ste_stencil)
from ehgr_tpu_torch.ops.kernels.shift import (learnable_shift_bwd,
                                              learnable_shift_fwd)
from ehgr_tpu_torch.parallel.collectives import all_reduce, group_size

# the gate heads' parameters, in the order the region takes them (torch
# module layouts: Conv3d [1,1,3,3,3], Conv2d [Cr,C,1,1], Conv1d [Cr,Cr,3],
# Conv2d [C,Cr,1,1], BN weight/bias [Cr], depthwise Conv2d [Cr,1,3,3],
# Conv2d [C,Cr,1,1])
SMALL = ("k_p1", "w_sq", "k_ce", "w_exp", "bn_scale", "bn_bias", "k_dw",
         "w_me")


def gates_from_stats(mc: torch.Tensor, pooled: torch.Tensor,
                     x3r: torch.Tensor, small: Sequence[torch.Tensor],
                     bn_mean: torch.Tensor, bn_var: torch.Tensor, *,
                     hw: Tuple[int, int], bn_train: bool, bn_group=None,
                     eps: float = 1e-5):
    """Gate heads from the three ``x_shift`` reductions (the JAX
    ``_gates_from_stats``): small tensors only, so the backward can take
    their VJP by autograd.  With ``bn_train`` the ME BN normalizes with the
    batch's f32 ``E[x]`` and ``E[x^2] - E[x]^2``, else with ``bn_mean`` /
    ``bn_var``; with ``bn_group`` too (a data group), the global batch's
    over it.  Returns ``(g1 [N,T,S,1], g2, g3
    [N,T,C], mean, var)``."""
    k_p1, w_sq, k_ce, w_exp, scale, bias, k_dw, w_me = small
    n, t, s, cr = x3r.shape
    h, w = hw
    dt = x3r.dtype
    # STE
    g1 = torch.sigmoid(ste_stencil(mc.reshape(n, t, h, w), k_p1[0, 0]))
    # CE
    ce = F.linear(pooled, w_sq[:, :, 0, 0].to(dt))              # [N,T,Cr]
    ce = F.conv1d(ce.transpose(1, 2), k_ce.to(dt), padding=1).transpose(1, 2)
    g2 = torch.sigmoid(F.linear(torch.relu(ce), w_exp[:, :, 0, 0].to(dt)))
    # ME
    if bn_train:
        xf = x3r.float()
        mean, ex2 = xf.mean((0, 1, 2)), (xf * xf).mean((0, 1, 2))
        if bn_group is not None:
            mean, ex2 = all_reduce(torch.stack([mean, ex2]),
                                   bn_group) / group_size(bn_group)
        var = torch.clamp(ex2 - mean * mean, min=0.0)
    else:
        mean, var = bn_mean, bn_var
    a = scale * torch.rsqrt(var + eps)
    b = bias - mean * a
    x3 = x3r * a.to(dt) + b.to(dt)                               # [N,T,S,Cr]
    x3n = x3.reshape(n * t, h, w, cr).permute(0, 3, 1, 2)        # NCHW view
    x3c = F.conv2d(x3n, k_dw.to(dt), padding=1, groups=cr)
    m3 = x3.mean(2)                                              # [N,T,Cr]
    m3c = x3c.mean((2, 3)).reshape(n, t, cr)
    p3 = torch.cat([m3c[:, 1:] - m3[:, :-1], torch.zeros_like(m3[:, :1])],
                   dim=1)                                        # pad last t
    g3 = torch.sigmoid(F.linear(p3, w_me[:, :, 0, 0].to(dt)))
    return g1.reshape(n, t, s, 1), g2, g3, mean, var


class ActionRegion(torch.autograd.Function):
    """``ActionRegion.apply(x4, hw, bn_train, bn_group, eps, shift_w [3,C],
    w_p3 [C,Cr], w_net [C,F], bn_mean, bn_var, *small)`` ->
    ``(out [N,T,S,F], mean, var)``; ``bn_group``: the ME BN's data group on
    a mesh, else ``None``.  Parameters arrive in f32 and are cast
    to ``x4``'s dtype inside, as the module path does; their gradients
    leave in their own dtype."""

    @staticmethod
    def forward(ctx, x4, hw, bn_train, bn_group, eps, shift_w, w_p3, w_net,
                bn_mean, bn_var, *small):
        dt = x4.dtype
        sw, wp3, wn = (v.to(dt).contiguous() for v in (shift_w, w_p3, w_net))
        mc, pooled, x3r = action_stats(x4, sw, wp3)
        g1, g2, g3, mean, var = gates_from_stats(
            mc, pooled, x3r, small, bn_mean, bn_var, hw=hw,
            bn_train=bn_train, bn_group=bn_group, eps=eps)
        out = action_apply(x4, sw, g1, (g2 + g3 + 3.0).to(dt).contiguous(),
                           wn)
        ctx.hw, ctx.bn_train, ctx.bn_group, ctx.eps = (hw, bn_train,
                                                       bn_group, eps)
        # the running statistics are saved only where the backward reads
        # them: with bn_train the caller updates them in place next
        stats = () if bn_train else (bn_mean, bn_var)
        ctx.save_for_backward(x4, shift_w, w_p3, w_net, mc, pooled, x3r, g1,
                              g2, g3, *stats, *small)
        # fresh tensors even when they are the running statistics
        mean, var = mean.clone(), var.clone()
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, d_out, _d_mean, _d_var):
        (x4, shift_w, w_p3, w_net, mc, pooled, x3r, g1, g2, g3,
         *rest) = ctx.saved_tensors
        bn_mean, bn_var = (None, None) if ctx.bn_train else rest[:2]
        small = rest[-len(SMALL):]
        dt = x4.dtype
        n, t, s, c = x4.shape
        rows = n * t * s
        sw, wp3, wn = (v.to(dt).contiguous() for v in (shift_w, w_p3, w_net))
        d_out2 = d_out.to(dt).reshape(rows, -1)

        # recompute x_shift from the saved input
        xs = learnable_shift_fwd(x4, sw)
        gsum = g1 + g2[:, :, None, :] + g3[:, :, None, :]        # [N,T,S,C]

        # wrapped-conv backward
        gated = (xs * gsum + 3.0 * xs).reshape(rows, c)
        d_w_net = gated.t() @ d_out2                             # [C,F]
        d_gated = (d_out2 @ wn.t()).reshape(n, t, s, c)

        # gate cotangents: one full-size product, reduced two ways
        dg_full = xs * d_gated
        dg1 = dg_full.sum(-1, keepdim=True)                      # [N,T,S,1]
        dg_ch = dg_full.sum(2)                                   # [N,T,C]

        # gate heads: autograd over the small segment
        with torch.enable_grad():
            leaves = [v.detach().requires_grad_()
                      for v in (mc, pooled, x3r, *small)]
            outs = gates_from_stats(*leaves[:3], leaves[3:], bn_mean, bn_var,
                                    hw=ctx.hw, bn_train=ctx.bn_train,
                                    bn_group=ctx.bn_group, eps=ctx.eps)[:3]
            grads = torch.autograd.grad(outs, leaves, (dg1, dg_ch, dg_ch))
        d_mc, d_pooled, d_x3r, *d_small = grads

        # the ME squeeze's transpose
        d_x3r2 = d_x3r.to(dt).reshape(rows, -1)
        d_w_p3 = xs.reshape(rows, c).t() @ d_x3r2                # [C,Cr]

        # the four contributions to d x_shift in one expression
        d_s = ((gsum + 3.0) * d_gated
               + d_mc.to(dt) / c
               + (d_pooled.to(dt) / s)[:, :, None, :]
               + (d_x3r2 @ wp3.t()).reshape(n, t, s, c))

        # the shift's transpose: dx and the taps' gradient
        dx, d_sw = learnable_shift_bwd(x4, d_s.contiguous(), sw)
        return (dx, None, None, None, None, d_sw.to(shift_w.dtype),
                d_w_p3.to(w_p3.dtype), d_w_net.to(w_net.dtype), None, None,
                *(g.to(p.dtype) for g, p in zip(d_small, small)))
