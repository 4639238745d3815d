"""ACTION two-sweep kernels: wrappers of the CUDA kernels in
``csrc/action_mega.cu`` beside their plain PyTorch versions (counterpart of
``ehgr_tpu/ops/pallas/action_mega.py``).

  sweep 1  ``action_stats``  — read ``x`` once, recompute the 3-tap shift and
      emit ``mc [N,T,S,1]`` (channel mean), ``pool [N,T,C]`` (spatial mean)
      and ``x3 = x_shift @ W_p3 [N,T,S,C/16]``.
  (small middle in PyTorch: STE stencil + CE MLP + ME tail -> per-pixel gate
      ``g1`` and per-channel gate ``gch = g2 + g3 + 3``)
  sweep 2  ``action_apply``  — read ``x`` again, recompute the shift and
      write only ``(x_shift * (g1 + gch)) @ W_net [N,T,S,F]``.

A wrapper takes the plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises.  ``<wrapper>.launches`` counts kernel
launches (the plain path does not count).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ehgr_tpu_torch.ops.temporal_shift import learnable_shift

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(name: str, x4: torch.Tensor, **operands: torch.Tensor) -> None:
    """Same device and dtype (fp32 or bf16) for every operand, each
    contiguous, with the shapes the caller already asserted."""
    if x4.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x4.dtype} (fp32 or bf16 only)")
    for k, v in dict(x4=x4, **operands).items():
        if v.dtype != x4.dtype or v.device != x4.device:
            raise TypeError(f"{name}: {k} is {v.dtype} on {v.device}, x4 is "
                            f"{x4.dtype} on {x4.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")
    if x4.device.type == "cuda" and \
            x4.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {x4.device}, current device "
                         f"is cuda:{torch.cuda.current_device()}")
    if x4.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x4.device}")


def _launch(fn, x4: torch.Tensor, *args) -> None:
    from ehgr_tpu_torch.ops.kernels.build import load

    stream = torch.cuda.current_stream(x4.device).cuda_stream
    err = getattr(load("action_mega"), fn)(_DTYPE_CODE[x4.dtype], *args,
                                           stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed (cudaError {err})")


# ---------------------------------------------------------------------------
# sweep 1: gate statistics
# ---------------------------------------------------------------------------

def action_stats_plain(x4: torch.Tensor, w_shift: torch.Tensor,
                       w_p3: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``action_stats``, computed in f32 and cast to the
    input dtype like the kernel."""
    xs = learnable_shift(x4.float(), w_shift.float())
    out = (xs.mean(-1, keepdim=True), xs.mean(2), xs @ w_p3.float())
    return tuple(v.to(x4.dtype) for v in out)


def action_stats(x4: torch.Tensor, w_shift: torch.Tensor, w_p3: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x4 [N,T,S,C], w_shift [3,C], w_p3 [C,Cr]`` ->
    ``(mc [N,T,S,1], pooled_mean [N,T,C], x3 [N,T,S,Cr])``."""
    n, t, s, c = x4.shape
    if w_shift.shape != (3, c) or w_p3.dim() != 2 or w_p3.shape[0] != c:
        raise ValueError(f"action_stats: shapes {tuple(x4.shape)}, "
                         f"{tuple(w_shift.shape)}, {tuple(w_p3.shape)}")
    _check("action_stats", x4, w_shift=w_shift, w_p3=w_p3)
    if x4.device.type == "cpu":
        return action_stats_plain(x4, w_shift, w_p3)
    cr = w_p3.shape[1]
    mc = x4.new_empty((n, t, s, 1))
    pool = x4.new_empty((n, t, c))
    x3 = x4.new_empty((n, t, s, cr))
    acc = torch.empty((n, t, c), dtype=torch.float32, device=x4.device)
    _launch("ehgr_action_stats", x4, x4.data_ptr(), w_shift.data_ptr(),
            w_p3.data_ptr(), mc.data_ptr(), pool.data_ptr(), x3.data_ptr(),
            acc.data_ptr(), n, t, s, c, cr)
    action_stats.launches += 1
    return mc, pool, x3


action_stats.launches = 0


# ---------------------------------------------------------------------------
# sweep 2: gates + gated sum + wrapped 1x1 conv
# ---------------------------------------------------------------------------

def action_apply_plain(x4: torch.Tensor, w_shift: torch.Tensor,
                       g1: torch.Tensor, gch: torch.Tensor,
                       w_net: torch.Tensor) -> torch.Tensor:
    """Plain version of ``action_apply``, computed in f32 and cast to the
    input dtype like the kernel."""
    xs = learnable_shift(x4.float(), w_shift.float())
    gated = xs * (g1.float() + gch.float()[:, :, None, :])
    return (gated @ w_net.float()).to(x4.dtype)


def action_apply(x4: torch.Tensor, w_shift: torch.Tensor, g1: torch.Tensor,
                 gch: torch.Tensor, w_net: torch.Tensor) -> torch.Tensor:
    """``x4 [N,T,S,C], w_shift [3,C], g1 [N,T,S,1], gch [N,T,C],
    w_net [C,F]`` -> ``(x_shift * (g1 + gch)) @ w_net  [N,T,S,F]``.

    ``gch`` already holds the residual offset: the ACTION gated sum is
    ``x_shift*(g1+g2+g3+3)``, so callers pass ``gch = g2 + g3 + 3``."""
    n, t, s, c = x4.shape
    if w_shift.shape != (3, c) or g1.shape != (n, t, s, 1) or \
            gch.shape != (n, t, c) or w_net.dim() != 2 or \
            w_net.shape[0] != c:
        raise ValueError(
            f"action_apply: shapes {tuple(x4.shape)}, {tuple(w_shift.shape)}"
            f", {tuple(g1.shape)}, {tuple(gch.shape)}, {tuple(w_net.shape)}")
    _check("action_apply", x4, w_shift=w_shift, g1=g1, gch=gch, w_net=w_net)
    if x4.device.type == "cpu":
        return action_apply_plain(x4, w_shift, g1, gch, w_net)
    f = w_net.shape[1]
    out = x4.new_empty((n, t, s, f))
    _launch("ehgr_action_apply", x4, x4.data_ptr(), w_shift.data_ptr(),
            g1.data_ptr(), gch.data_ptr(), w_net.data_ptr(), out.data_ptr(),
            n, t, s, c, f)
    action_apply.launches += 1
    return out


action_apply.launches = 0


# ---------------------------------------------------------------------------
# STE stencil (the small middle): XLA's 27-tap stencil in JAX, F.conv3d here
# ---------------------------------------------------------------------------

def ste_stencil(mc: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``mc [N,T,H,W], kernel [3,3,3]`` -> zero-padded 3x3x3
    cross-correlation (``Conv3d(1, 1, 3, padding=1, bias=False)``)."""
    return F.conv3d(mc[:, None], kernel[None, None].to(mc.dtype),
                    padding=1)[:, 0]
