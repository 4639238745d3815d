"""int8 convolution with the activation quantize fused in: the wrapper of
the CUDA kernel in ``csrc/int8_conv.cu`` beside its plain PyTorch version.

No TPU kernel stands behind it: the JAX package computes the int8 conv of
``ehgr_tpu/ops/quantize.py`` with XLA's ``lax.conv_general_dilated(...,
preferred_element_type=int32)`` on codes that XLA quantizes inside the
producer's fusion, and PyTorch has no int8 convolution on CUDA.

  ``int8_conv(x, xs, wq, ws, stride, padding)``: ``x [N, Cin, H, W]`` bf16
      or f32, ``xs`` an f32 scalar tensor (the activation scale, > 0),
      ``wq [Cout, Cin, KH, KW]`` int8, ``ws [Cout]`` f32 -> ``x.dtype(
      (conv(codes, wq) summed in int32).float() * (xs * ws))`` as ``[N,
      Cout, Ho, Wo]`` in channels_last, zero padding, where ``codes =
      quantize_codes(x, xs) = clamp(round(x / xs), -127, 127)``.

The kernel quantizes ``x`` on its way into shared memory (the codes never
reach device memory) and reads ``xs`` through its pointer, so the scale
never comes back to the host.  It reads ``x`` channels_last and the weight
as ``[Cout, KH, KW, Cin]`` (K contiguous); it takes ``Cin % 16 == 0`` and
``Cout % 8 == 0`` (every ResNet-50/101 block conv) and raises otherwise.
The kernel is the custom op ``ehgr::int8_conv`` (CPU: the plain version;
CUDA: the launch and its counter; a fake implementation for
``torch.export``), which the wrapper calls after its checks.  So the plain
version serves CPU tensors only; a CUDA tensor launches the kernel or
raises.  ``int8_conv.launches`` counts kernel launches (the plain path
does not count).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ehgr_tpu_torch.ops.kernels.build import (DTYPE_CODE, check_operands,
                                              launch, load)

DTYPES = (torch.float32, torch.bfloat16)


def _out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


def quantize_codes(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``x`` -> int8 ``clip(round(x / xs), -127, 127)``, rounding half to
    even as ``jnp.round`` does, and dividing as JAX does (no reciprocal)."""
    return torch.clamp(torch.round(x.float() / xs), -127, 127).to(torch.int8)


def int8_conv_codes(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    stride: int = 1, padding: int = 0,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The integer core on codes (plain PyTorch): the convolution of the
    int8 ``xq`` by ``wq`` in float64, where every partial sum (below 127^2
    * K < 2^53) is an exact integer, then JAX's epilogue: int32, to f32,
    times ``scale [Cout]``, to ``dtype``.  The rounding before int32 only
    removes what a transform algorithm of cuDNN (FFT, Winograd) adds in
    float64, far below 0.5."""
    acc = F.conv2d(xq.double(), wq.double(), stride=stride, padding=padding)
    y = acc.round().to(torch.int32).float() * scale[:, None, None]
    return y.to(dtype).contiguous(memory_format=torch.channels_last)


def _check(x: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
           ws: torch.Tensor) -> None:
    if x.dim() != 4 or wq.dim() != 4 or x.shape[1] != wq.shape[1] or \
            xs.dim() != 0 or ws.shape != (wq.shape[0],):
        raise ValueError(f"int8_conv: x {tuple(x.shape)}, xs "
                         f"{tuple(xs.shape)}, w {tuple(wq.shape)}, ws "
                         f"{tuple(ws.shape)}")
    if x.dtype not in DTYPES or xs.dtype != torch.float32 or \
            wq.dtype != torch.int8 or ws.dtype != torch.float32:
        raise TypeError(f"int8_conv: x {x.dtype}, xs {xs.dtype}, w "
                        f"{wq.dtype}, ws {ws.dtype} (f32 or bf16, f32, "
                        "int8, f32)")


def int8_conv_plain(x: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                    ws: torch.Tensor, stride: int = 1,
                    padding: int = 0) -> torch.Tensor:
    """Plain version of ``int8_conv``: ``quantize_codes``, then the exact
    integer conv and JAX's epilogue (``int8_conv_codes``) with the scale
    ``xs * ws``, in ``x``'s dtype."""
    _check(x, xs, wq, ws)
    return int8_conv_codes(quantize_codes(x, xs), wq, xs * ws, stride,
                           padding, x.dtype)


def int8_conv(x: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
              ws: torch.Tensor, stride: int = 1,
              padding: int = 0) -> torch.Tensor:
    """``[N, Cin, H, W]`` float ``x`` quantized by ``xs``, conv ``[Cout,
    Cin, KH, KW]`` int8, int32 sums, times ``xs * ws`` -> ``[N, Cout, Ho,
    Wo]`` in ``x``'s dtype, channels_last (see the module docstring)."""
    _check(x, xs, wq, ws)
    return conv_op(x, xs, wq, ws, stride, padding)


@torch.library.custom_op(
    "ehgr::int8_conv", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor xs, Tensor wq, Tensor ws, int stride, "
           "int padding) -> Tensor")
def conv_op(x, xs, wq, ws, stride, padding):
    return int8_conv_plain(x, xs, wq, ws, stride, padding)


@conv_op.register_kernel("cuda")
def _conv_cuda(x, xs, wq, ws, stride, padding):
    n, cin, h, w = x.shape
    cout, _, kh, kw = wq.shape
    if cin % 16 or cout % 8:
        raise ValueError(f"int8_conv: Cin {cin} % 16 or Cout {cout} % 8 "
                         "is not 0")
    ho, wo = _out_size(h, kh, stride, padding), _out_size(w, kw, stride,
                                                          padding)
    if ho < 1 or wo < 1 or n * ho * wo >= 2 ** 31:
        raise ValueError(f"int8_conv: output {n} x {ho} x {wo}")
    xc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    wt = wq.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    ws = ws.contiguous()
    check_operands("int8_conv", xc)
    check_operands("int8_conv", wt, dtypes=(torch.int8,))
    check_operands("int8_conv", xs, dtypes=(torch.float32,), ws=ws)
    if not xs.device == wt.device == xc.device:
        raise TypeError(f"int8_conv: x on {xc.device}, xs and ws on "
                        f"{xs.device}, w on {wt.device}")
    if xc.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("int8_conv: x or w is not 16-byte aligned")
    load("int8_conv")                  # a failed build raises here
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=xc.device)
    launch("int8_conv", "ehgr_int8_conv_fused", out, xc.data_ptr(),
           xs.data_ptr(), wt.data_ptr(), ws.data_ptr(), out.data_ptr(), n, h,
           w, cin, cout, kh, kw, stride, padding, ho, wo)
    int8_conv.launches += 1
    return out.permute(0, 3, 1, 2)


@conv_op.register_fake
def _conv_fake(x, xs, wq, ws, stride, padding):
    n, _, h, w = x.shape
    cout, _, kh, kw = wq.shape
    out = x.new_empty((n, _out_size(h, kh, stride, padding),
                       _out_size(w, kw, stride, padding), cout))
    return out.permute(0, 3, 1, 2)


int8_conv.launches = 0


def int8_conv_grid(dtype: torch.dtype, m: int, cout: int, k: int) -> dict:
    """The launch of ``int8_conv`` for ``m`` output pixels, ``cout``
    channels and depth ``k`` (KH * KW * Cin) of input ``dtype``, as its
    host code picks it (builds the library; for reports)."""
    grid = (ctypes.c_int * 5)()
    load("int8_conv").ehgr_int8_conv_grid(DTYPE_CODE[dtype], m, cout, k,
                                          grid)
    return dict(zip(("blocks", "BN", "BM", "stages", "smem_bytes"), grid))
