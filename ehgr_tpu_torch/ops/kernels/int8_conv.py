"""int8 convolution: the wrapper of the CUDA kernel in ``csrc/int8_conv.cu``
beside its plain PyTorch version.

No TPU kernel stands behind it: the JAX package computes the int8 conv of
``ehgr_tpu/ops/quantize.py`` with XLA's ``lax.conv_general_dilated(...,
preferred_element_type=int32)``, and PyTorch has no int8 convolution on
CUDA.

  ``int8_conv(xq, wq, scale, stride, padding, dtype)``: ``xq [N, Cin, H, W]``
      int8, ``wq [Cout, Cin, KH, KW]`` int8, ``scale [Cout]`` f32 ->
      ``dtype((conv(xq, wq) summed in int32).float() * scale)`` as
      ``[N, Cout, Ho, Wo]`` in channels_last, zero padding.

The kernel reads both int8 operands channels_last (the weight so as
``[Cout, KH, KW, Cin]``, K contiguous); it takes ``Cin % 16 == 0`` and
``Cout % 8 == 0`` (every ResNet-50/101 block conv) and raises otherwise.
The wrapper takes the plain version for CPU tensors only; for CUDA tensors
it launches its kernel or raises.  ``int8_conv.launches`` counts kernel
launches (the plain path does not count).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ehgr_tpu_torch.ops.kernels.build import check_operands, launch, load

OUT_DTYPES = (torch.float32, torch.bfloat16)


def _out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


def _check(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
           dtype: torch.dtype) -> None:
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[1] != wq.shape[1] or \
            scale.shape != (wq.shape[0],):
        raise ValueError(f"int8_conv: x {tuple(xq.shape)}, w "
                         f"{tuple(wq.shape)}, scale {tuple(scale.shape)}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or \
            scale.dtype != torch.float32 or dtype not in OUT_DTYPES:
        raise TypeError(f"int8_conv: x {xq.dtype}, w {wq.dtype}, scale "
                        f"{scale.dtype}, out {dtype} (int8, int8, f32, f32 "
                        "or bf16)")


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    stride: int = 1, padding: int = 0,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of ``int8_conv``: the convolution of the int8 codes in
    float64, where every partial sum (below 127^2 * K < 2^53) is an exact
    integer, then JAX's epilogue: int32, to f32, times ``scale``, to
    ``dtype``.  The rounding before int32 only removes what a transform
    algorithm of cuDNN (FFT, Winograd) adds in float64, far below 0.5."""
    _check(xq, wq, scale, dtype)
    acc = F.conv2d(xq.double(), wq.double(), stride=stride, padding=padding)
    y = acc.round().to(torch.int32).float() * scale[:, None, None]
    return y.to(dtype).contiguous(memory_format=torch.channels_last)


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
              stride: int = 1, padding: int = 0,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``[N, Cin, H, W]`` int8 conv ``[Cout, Cin, KH, KW]`` int8, int32
    sums, times ``scale [Cout]`` -> ``[N, Cout, Ho, Wo]`` ``dtype``,
    channels_last (see the module docstring)."""
    _check(xq, wq, scale, dtype)
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, wq, scale, stride, padding, dtype)
    n, cin, h, w = xq.shape
    cout, _, kh, kw = wq.shape
    if cin % 16 or cout % 8:
        raise ValueError(f"int8_conv: Cin {cin} % 16 or Cout {cout} % 8 "
                         "is not 0")
    ho, wo = _out_size(h, kh, stride, padding), _out_size(w, kw, stride,
                                                          padding)
    if ho < 1 or wo < 1 or n * ho * wo >= 2 ** 31:
        raise ValueError(f"int8_conv: output {n} x {ho} x {wo}")
    x = xq.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    wt = wq.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    scale = scale.contiguous()
    check_operands("int8_conv", x, wt=wt, dtypes=(torch.int8,))
    check_operands("int8_conv", scale, dtypes=(torch.float32,))
    if scale.device != x.device:
        raise TypeError(f"int8_conv: scale on {scale.device}, x on "
                        f"{x.device}")
    if x.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("int8_conv: x or w is not 16-byte aligned")
    load("int8_conv")                  # a failed build raises here
    out = torch.empty((n, ho, wo, cout), dtype=dtype, device=x.device)
    launch("int8_conv", "ehgr_int8_conv", out, x.data_ptr(), wt.data_ptr(),
           scale.data_ptr(), out.data_ptr(), n, h, w, cin, cout, kh, kw,
           stride, padding, ho, wo)
    int8_conv.launches += 1
    return out.permute(0, 3, 1, 2)


int8_conv.launches = 0
