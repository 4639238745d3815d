"""ACTION prologue kernel: the wrapper of ``ehgr_action_prologue_window`` in
``csrc/action_stats.cu`` (and of ``ehgr_action_prologue`` in
``csrc/action_mega.cu`` off the main path) beside its plain PyTorch version
(counterpart of ``ehgr_tpu/ops/pallas/action_fused.py``).

  ``action_prologue(x4, w_shift, w_p3)`` — one pass over ``x [N,T,S,C]``:
      ``x_shift`` (stored), ``mc [N,T,S,1]`` (channel mean), ``pool
      [N,T,C]`` (spatial mean) and ``x3 = x_shift @ W_p3 [N,T,S,C/16]``
      (the ME squeeze before its BN).

It is ``action_stats``' sweep with one more store (the same device code,
built with ``XS = true``, on the same route, ``_stats_route``).  ``pool``
and ``mc`` are summed in f32 and divided at the end, as ``action_stats``
does; the TPU kernel summed ``pool`` in the input dtype.

The kernel is the custom op ``ehgr::action_prologue`` (CPU: the plain
version; CUDA: the launch, with its route, scratch and counters; a fake
implementation for ``torch.export``), which the wrapper calls after its
checks, as ``action_mega.py`` does.  So the plain version serves CPU tensors
only; a CUDA tensor launches the kernel or raises.
``action_prologue.launches`` counts kernel launches (the plain path does
not count), ``route_launches`` each route's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ehgr_tpu_torch.ops.kernels.action_mega import (_aligned, _stats_route,
                                                    stats_scratch)
from ehgr_tpu_torch.ops.kernels.build import check_operands, launch, load
from ehgr_tpu_torch.ops.temporal_shift import learnable_shift


def action_prologue_plain(x4: torch.Tensor, w_shift: torch.Tensor,
                          w_p3: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """Plain version of ``action_prologue``, computed in f32 and cast to
    the input dtype like the kernel."""
    xs = learnable_shift(x4.float(), w_shift.float())
    out = (xs, xs.mean(-1, keepdim=True), xs.mean(2), xs @ w_p3.float())
    return tuple(v.to(x4.dtype) for v in out)


def action_prologue(x4: torch.Tensor, w_shift: torch.Tensor,
                    w_p3: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """``x4 [N,T,S,C], w_shift [3,C], w_p3 [C,Cr]`` -> ``(x_shift
    [N,T,S,C], mc [N,T,S,1], pooled_mean [N,T,C], x3 [N,T,S,Cr])``."""
    c = x4.shape[-1]
    if x4.dim() != 4 or w_shift.shape != (3, c) or w_p3.dim() != 2 or \
            w_p3.shape[0] != c:
        raise ValueError(f"action_prologue: shapes {tuple(x4.shape)}, "
                         f"{tuple(w_shift.shape)}, {tuple(w_p3.shape)}")
    check_operands("action_prologue", x4, w_shift=w_shift, w_p3=w_p3)
    return prologue_op(x4, w_shift, w_p3)


@torch.library.custom_op(
    "ehgr::action_prologue", mutates_args=(), device_types="cpu",
    schema="(Tensor x4, Tensor w_shift, Tensor w_p3) -> "
           "(Tensor, Tensor, Tensor, Tensor)")
def prologue_op(x4, w_shift, w_p3):
    return action_prologue_plain(x4, w_shift, w_p3)


@prologue_op.register_kernel("cuda")
def _prologue_cuda(x4, w_shift, w_p3):
    n, t, s, c = x4.shape
    cr = w_p3.shape[1]
    route = _stats_route(x4.dtype, c, cr, _aligned(x4, w_shift, w_p3))
    lib = "action_stats" if route == "window" else "action_mega"
    load(lib)                          # a failed build raises here
    xs = torch.empty_like(x4)
    mc = x4.new_empty((n, t, s, 1))
    pool = x4.new_empty((n, t, c))
    x3 = x4.new_empty((n, t, s, cr))
    args = (x4.data_ptr(), w_shift.data_ptr(), w_p3.data_ptr(), xs.data_ptr(),
            mc.data_ptr(), pool.data_ptr(), x3.data_ptr(),
            stats_scratch(x4, lib).data_ptr(), n, t, s, c, cr)
    launch(lib, "ehgr_action_prologue_window" if route == "window"
           else "ehgr_action_prologue", x4, *args)
    action_prologue.launches += 1
    action_prologue.route_launches[route] += 1
    return xs, mc, pool, x3


@prologue_op.register_fake
def _prologue_fake(x4, w_shift, w_p3):
    n, t, s, c = x4.shape
    return (torch.empty_like(x4), x4.new_empty((n, t, s, 1)),
            x4.new_empty((n, t, c)), x4.new_empty((n, t, s, w_p3.shape[1])))


action_prologue.launches = 0
action_prologue.route_launches = dict(window=0, fma_sweep=0)
