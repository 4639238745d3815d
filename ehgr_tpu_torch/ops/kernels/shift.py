"""Learnable (ACTION) temporal shift kernels: wrappers of the CUDA kernels in
``csrc/shift.cu`` and ``csrc/shift_bwd.cu`` beside their plain PyTorch
versions (counterpart of ``learnable_shift_pallas`` in
``ehgr_tpu/ops/pallas/shift.py``).

  ``learnable_shift_fwd(x4, w)``      y[t] = w0*x[t-1] + w1*x[t] + w2*x[t+1]
  ``learnable_shift_bwd(x4, g4, w)``  (dx, dw): dx is the forward with the
      taps reversed, ``dw[k,c] = sum x[t+k-1] * g[t]`` accumulated in f32

on ``x4, g4 [N,T,S,C]``, ``w [3,C]``, zero at clip edges.  ``LearnableShift``
binds the two as a ``torch.autograd.Function``.  The plain versions are the
port's ``learnable_shift`` and its autograd, computed in f32 and cast back
like the kernels.  The backward has two routes (``bwd_route``): ``'strip'``
(``csrc/shift_bwd.cu``, every ResNet-50 site) and ``'sweep'``
(``csrc/shift.cu``, the rest).

A wrapper takes the plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises.  ``<wrapper>.launches`` counts kernel
launches (the plain path does not count),
``learnable_shift_bwd.route_launches`` those of each route.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ehgr_tpu_torch.ops.kernels.build import check_operands, launch, load
from ehgr_tpu_torch.ops.temporal_shift import learnable_shift

_THREADS = 256
# blocks in flight the grid aims at: 132 SMs x 8 blocks of 256 threads
_BLOCKS = 132 * 8
# the strip kernel (csrc/shift_bwd.cu): a block's 256 threads walk 32 rows x
# 64 channels at a time; a strip takes up to 4 such sub-strips where the
# grid keeps at least two waves of two blocks an SM
_SUB_ROWS, _CHUNK, _MAX_SUBS, _STRIP_MIN_BLOCKS = 32, 64, 4, 4 * 132


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


def bwd_route(dtype: torch.dtype, c: int, aligned: bool) -> str:
    """The kernel that computes ``learnable_shift_bwd``, a pure function of
    the operands: ``'strip'`` (``csrc/shift_bwd.cu``: bf16 with C % 64 == 0
    and x, g, w 16-byte aligned, which every ResNet-50 site meets; dx is
    allocated aligned) or ``'sweep'`` (``csrc/shift.cu``: fp32, and any
    other bf16)."""
    if dtype == torch.bfloat16 and aligned and c % _CHUNK == 0:
        return "strip"
    return "sweep"


def strip_geometry(n: int, s: int, c: int) -> dict:
    """The launch of the ``'strip'`` route: a block owns ``rows`` (R)
    positions of one clip, all T frames, and one 64-channel chunk;
    ``strips`` = ceil(S / R) a clip, ``blocks`` = N * strips * chunks,
    ``parts`` = N * strips f32 partial rows of dw; ``dw_finish`` sums them
    with ``finish_cols`` columns a block over ``finish_blocks`` blocks.
    R takes the most sub-strips of 32 rows (4 down to 1) that leave at least
    _STRIP_MIN_BLOCKS blocks, then evens out the clip's strips."""
    chunks = c // _CHUNK
    subs = -(-s // _SUB_ROWS)
    for k in range(_MAX_SUBS, 0, -1):
        if k == 1 or n * -(-subs // k) * chunks >= _STRIP_MIN_BLOCKS:
            break
    rows = -(-s // -(-subs // k))
    strips = -(-s // rows)
    cols = 1 << min(5, chunks.bit_length() - 1)
    return dict(rows=rows, subs=-(-rows // _SUB_ROWS), strips=strips,
                chunks=chunks, blocks=n * strips * chunks, parts=n * strips,
                finish_cols=cols, finish_blocks=-(-3 * c // cols))


def learnable_shift_bwd(x4: torch.Tensor, g4: torch.Tensor, w: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x4, g4 [N,T,S,C], w [3,C]`` -> ``(dx [N,T,S,C], dw [3,C])`` of the
    shift at ``x4`` for the cotangent ``g4``; ``dw`` is summed in f32 and
    returned in ``w``'s dtype.  ``learnable_shift_bwd.route_launches``
    counts the launches of each route of ``bwd_route``."""
    _check_shapes("learnable_shift_bwd", x4, w, g4)
    check_operands("learnable_shift_bwd", x4, g4=g4, w=w)
    if x4.device.type == "cpu":
        return learnable_shift_bwd_plain(x4, g4, w)
    route = bwd_route(x4.dtype, x4.shape[-1],
                      all(v.data_ptr() % 16 == 0 for v in (x4, g4, w)))
    out = (bwd_strip if route == "strip" else bwd_sweep)(x4, g4, w)
    learnable_shift_bwd.launches += 1
    learnable_shift_bwd.route_launches[route] += 1
    return out


learnable_shift_bwd.launches = 0
learnable_shift_bwd.route_launches = dict(strip=0, sweep=0)


def bwd_strip(x4: torch.Tensor, g4: torch.Tensor, w: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route ``'strip'`` of ``learnable_shift_bwd`` on checked CUDA
    operands that ``bwd_route`` sends there (counts nothing)."""
    load("shift_bwd")                  # a failed build raises here
    n, t, s, c = x4.shape
    dx = torch.empty_like(x4)
    dw = torch.empty_like(w)
    geo = strip_geometry(n, s, c)
    part = x4.new_empty((geo["parts"], 3, c), dtype=torch.float32)
    launch("shift_bwd", "ehgr_shift_bwd_strip", x4, x4.data_ptr(),
           g4.data_ptr(), w.data_ptr(), dx.data_ptr(), part.data_ptr(),
           dw.data_ptr(), n, t, s, c, geo["rows"], geo["strips"],
           geo["finish_cols"])
    return dx, dw


def bwd_sweep(x4: torch.Tensor, g4: torch.Tensor, w: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route ``'sweep'`` of ``learnable_shift_bwd`` on checked CUDA
    operands: ``shift_sweep<..., true>`` and ``dw_reduce`` of
    ``csrc/shift.cu`` (counts nothing; takes any dtype and C)."""
    load("shift")                      # a failed build raises here
    n, t, s, c = x4.shape
    dx = torch.empty_like(x4)
    dw = torch.empty_like(w)
    vec = _vec(c, x4, g4, w, dx)
    bx, by, gx, gy = geometry(n, s, c, vec)
    part = x4.new_empty((gy, 3, c), dtype=torch.float32)
    launch("shift", "ehgr_shift_bwd", x4, x4.data_ptr(), g4.data_ptr(),
           w.data_ptr(), dx.data_ptr(), part.data_ptr(), dw.data_ptr(),
           n, t, s, c, vec, bx, by, gx, gy)
    return dx, dw


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
