"""Learnable (ACTION) temporal shift kernels: wrappers of the CUDA kernels in
``csrc/shift.cu`` beside their plain PyTorch versions (counterpart of
``learnable_shift_pallas`` in ``ehgr_tpu/ops/pallas/shift.py``).

  ``learnable_shift_fwd(x4, w)``      y[t] = w0*x[t-1] + w1*x[t] + w2*x[t+1]
  ``learnable_shift_bwd(x4, g4, w)``  (dx, dw): dx is the forward with the
      taps reversed, ``dw[k,c] = sum x[t+k-1] * g[t]`` accumulated in f32

on ``x4, g4 [N,T,S,C]``, ``w [3,C]``, zero at clip edges.  ``LearnableShift``
binds the two as a ``torch.autograd.Function``.  The plain versions are the
port's ``learnable_shift`` and its autograd, computed in f32 and cast back
like the kernels.

A wrapper takes the plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises.  ``<wrapper>.launches`` counts kernel
launches (the plain path does not count).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ehgr_tpu_torch.ops.kernels.build import check_operands, launch, load
from ehgr_tpu_torch.ops.temporal_shift import learnable_shift

_THREADS = 256
# blocks in flight the grid aims at: 132 SMs x 8 blocks of 256 threads
_BLOCKS = 132 * 8


def geometry(n: int, s: int, c: int, vec: int) -> Tuple[int, int, int, int]:
    """Block ``(bx, by)`` and grid ``(gx, gy)`` of the shift kernels: x over
    the ``C/vec`` channel vectors, y over the ``N*S`` (n, s) rows, each
    thread walking T; ``gy`` is capped so a thread takes several rows when
    there are many (it is also the number of dw partials)."""
    nvec = c // vec
    bx = min(32, 1 << max(nvec - 1, 0).bit_length())
    by = _THREADS // bx
    gx = -(-nvec // bx)
    gy = max(1, min(-(-(n * s) // by), _BLOCKS // gx))
    return bx, by, gx, gy


def _vec(c: int, *tensors: torch.Tensor) -> int:
    """Channels a thread loads at once: 16 bytes when C and every pointer
    allow it, else 1."""
    v = 16 // tensors[0].element_size()
    ok = c % v == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    return v if ok else 1


def _check_shapes(name: str, x4: torch.Tensor, w: torch.Tensor,
                  g4: torch.Tensor = None) -> None:
    if x4.dim() != 4 or w.shape != (3, x4.shape[-1]) or \
            (g4 is not None and g4.shape != x4.shape):
        raise ValueError(f"{name}: shapes {tuple(x4.shape)}, {tuple(w.shape)}"
                         + ("" if g4 is None else f", {tuple(g4.shape)}"))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def learnable_shift_fwd_plain(x4: torch.Tensor,
                              w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``learnable_shift_fwd``, computed in f32 and cast
    to the input dtype like the kernel."""
    return learnable_shift(x4.float(), w.float()).to(x4.dtype)


def learnable_shift_fwd(x4: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x4 [N,T,S,C], w [3,C]`` -> the shifted ``[N,T,S,C]``."""
    _check_shapes("learnable_shift_fwd", x4, w)
    check_operands("learnable_shift_fwd", x4, w=w)
    if x4.device.type == "cpu":
        return learnable_shift_fwd_plain(x4, w)
    load("shift")                      # a failed build raises here
    n, t, s, c = x4.shape
    y = torch.empty_like(x4)
    vec = _vec(c, x4, w, y)
    launch("shift", "ehgr_shift_fwd", x4, x4.data_ptr(), w.data_ptr(),
           y.data_ptr(), n, t, s, c, vec, *geometry(n, s, c, vec))
    learnable_shift_fwd.launches += 1
    return y


learnable_shift_fwd.launches = 0


# ---------------------------------------------------------------------------
# backward: dx and dw in one sweep over g and x
# ---------------------------------------------------------------------------

def learnable_shift_bwd_plain(x4: torch.Tensor, g4: torch.Tensor,
                              w: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``learnable_shift_bwd``: autograd of the plain shift
    in f32, cast back like the kernel."""
    with torch.enable_grad():
        xf = x4.detach().float().requires_grad_()
        wf = w.detach().float().requires_grad_()
        dx, dw = torch.autograd.grad(learnable_shift(xf, wf), (xf, wf),
                                     g4.float())
    return dx.to(x4.dtype), dw.to(w.dtype)


def learnable_shift_bwd(x4: torch.Tensor, g4: torch.Tensor, w: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x4, g4 [N,T,S,C], w [3,C]`` -> ``(dx [N,T,S,C], dw [3,C])`` of the
    shift at ``x4`` for the cotangent ``g4``; ``dw`` is summed in f32 and
    returned in ``w``'s dtype."""
    _check_shapes("learnable_shift_bwd", x4, w, g4)
    check_operands("learnable_shift_bwd", x4, g4=g4, w=w)
    if x4.device.type == "cpu":
        return learnable_shift_bwd_plain(x4, g4, w)
    load("shift")                      # a failed build raises here
    n, t, s, c = x4.shape
    dx = torch.empty_like(x4)
    dw = torch.empty_like(w)
    vec = _vec(c, x4, g4, w, dx)
    bx, by, gx, gy = geometry(n, s, c, vec)
    part = torch.empty((gy, 3, c), dtype=torch.float32, device=x4.device)
    launch("shift", "ehgr_shift_bwd", x4, x4.data_ptr(), g4.data_ptr(),
           w.data_ptr(), dx.data_ptr(), part.data_ptr(), dw.data_ptr(),
           n, t, s, c, vec, bx, by, gx, gy)
    learnable_shift_bwd.launches += 1
    return dx, dw


learnable_shift_bwd.launches = 0


class LearnableShift(torch.autograd.Function):
    """The shift as a differentiable op on the two kernels:
    ``LearnableShift.apply(x4, w)`` with ``x4 [N,T,S,C]`` and ``w [3,C]`` of
    one dtype."""

    @staticmethod
    def forward(ctx, x4: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x4, w)
        return learnable_shift_fwd(x4, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x4, w = ctx.saved_tensors
        return learnable_shift_bwd(x4, g.contiguous(), w)
