"""TSM temporal shift kernel: the wrapper of the CUDA kernel in
``csrc/tsm_shift.cu`` beside its plain PyTorch version (counterpart of
``tsm_shift_pallas`` in ``ehgr_tpu/ops/pallas/shift.py``).

  ``tsm_shift(x4, fold_div, reverse)``  on ``x4 [N,T,S,C]``: channels
      ``[0, fold)`` read t+1, ``[fold, 2*fold)`` read t-1, the rest pass;
      zero at clip edges; ``fold = C // fold_div``.  ``reverse`` swaps the
      two directions, the shift's transpose.

``TsmShift`` binds it as a ``torch.autograd.Function`` whose backward is the
same kernel with ``reverse=True``, as the TPU kernel's custom VJP is.  The
plain version is the port's ``temporal_shift``.

The kernel is the custom op ``ehgr::tsm_shift`` (CPU: the plain version,
any dtype there; CUDA: the launch and its counters; a fake implementation
for ``torch.export``), which the wrapper calls after its checks.  So a CUDA
tensor launches the kernel or raises.  ``tsm_shift.launches``
counts kernel launches, ``tsm_shift.reverse_launches`` those with
``reverse=True`` among them (the plain path does not count).
"""

from __future__ import annotations

import torch

from ehgr_tpu_torch.ops.kernels.build import check_operands, launch, load
from ehgr_tpu_torch.ops.kernels.shift import _vec, geometry
from ehgr_tpu_torch.ops.temporal_shift import temporal_shift


def tsm_shift_plain(x4: torch.Tensor, fold_div: int = 8,
                    reverse: bool = False) -> torch.Tensor:
    """Plain version of ``tsm_shift``."""
    return temporal_shift(x4, fold_div, reverse=reverse)


def tsm_shift(x4: torch.Tensor, fold_div: int = 8,
              reverse: bool = False) -> torch.Tensor:
    """``x4 [N,T,S,C]`` -> the shifted ``[N,T,S,C]`` (bitwise a copy)."""
    if x4.dim() != 4 or fold_div < 1:
        raise ValueError(f"tsm_shift: shape {tuple(x4.shape)}, "
                         f"fold_div {fold_div}")
    return shift_op(x4, fold_div, reverse)


@torch.library.custom_op(
    "ehgr::tsm_shift", mutates_args=(), device_types="cpu",
    schema="(Tensor x4, int fold_div, bool reverse) -> Tensor")
def shift_op(x4, fold_div, reverse):
    return tsm_shift_plain(x4, fold_div, reverse)


@shift_op.register_kernel("cuda")
def _shift_cuda(x4, fold_div, reverse):
    check_operands("tsm_shift", x4)
    load("tsm_shift")                  # a failed build raises here
    n, t, s, c = x4.shape
    y = torch.empty_like(x4)
    vec = _vec(c, x4, y)
    launch("tsm_shift", "ehgr_tsm_shift", x4, x4.data_ptr(), y.data_ptr(),
           n, t, s, c, c // fold_div, int(reverse), vec,
           *geometry(n, s, c, vec))
    tsm_shift.launches += 1
    tsm_shift.reverse_launches += int(reverse)
    return y


@shift_op.register_fake
def _shift_fake(x4, fold_div, reverse):
    return torch.empty_like(x4)


tsm_shift.launches = 0
tsm_shift.reverse_launches = 0


class TsmShift(torch.autograd.Function):
    """``TsmShift.apply(x4, fold_div)``: the shift as a differentiable op,
    the reverse shift of the cotangent as its backward."""

    @staticmethod
    def forward(ctx, x4: torch.Tensor, fold_div: int) -> torch.Tensor:
        ctx.fold_div = fold_div
        return tsm_shift(x4, fold_div)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return tsm_shift(g.contiguous(), ctx.fold_div, reverse=True), None
