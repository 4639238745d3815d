"""The mesh's collectives over ``torch.distributed`` process groups, with
no model imports, so that the layers, the kernel region and the optimizer
can reduce over a group that ``parallel/mesh.py`` hands them.

Every collective is an ``all_reduce``: gloo supports no other on CUDA
tensors but ``broadcast``, and two ranks that share one card must use gloo
(NCCL refuses two ranks on one device).  So one code path serves gloo on the
CPU, gloo on a shared card and NCCL on one card a rank.  A gather is an
``all_reduce`` of a zero-filled full tensor in which each rank writes its
own part.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """The number of ranks in ``group``."""
    return dist.get_world_size(group)


def _sum_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place SUM over ``group``; 16-bit floats go through f32."""
    if t.dtype in (torch.float16, torch.bfloat16):
        f = t.float()
        dist.all_reduce(f, group=group)
        return t.copy_(f)
    dist.all_reduce(t, group=group)
    return t


def flat_groups(tensors: Iterable[torch.Tensor]):
    """``tensors`` grouped by dtype and device, for one flat collective a
    group."""
    by = {}
    for t in tensors:
        by.setdefault((t.dtype, t.device), []).append(t)
    return by.values()


@torch.no_grad()
def all_reduce_grads(grads: Iterable[torch.Tensor], group) -> None:
    """SUM each tensor over ``group`` in place, as one flat reduction a
    dtype."""
    for ts in flat_groups(list(grads)):
        flat = _sum_(torch.cat([t.reshape(-1) for t in ts]), group)
        for t, piece in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(piece.view_as(t))


@torch.no_grad()
def sum_over(values: Mapping[str, torch.Tensor],
             group) -> Dict[str, torch.Tensor]:
    """Each value (a metric or a count) SUMmed over ``group``, in f32, as
    one flat reduction on the first value's device."""
    dev = next(iter(values.values())).device
    parts = {k: torch.as_tensor(v).to(dev, torch.float32)
             for k, v in values.items()}
    flat = _sum_(torch.cat([v.reshape(-1) for v in parts.values()]), group)
    pieces = flat.split([v.numel() for v in parts.values()])
    return {k: p.view_as(v) for (k, v), p in zip(parts.items(), pieces)}


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        # every rank's output depends on every rank's input
        return _sum_(g.contiguous().clone(), ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_(g.contiguous().clone(), ctx.group), None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, group, start, full):
        ctx.group, ctx.cols = group, slice(start, start + local.shape[-1])
        out = local.new_zeros(
            local.shape[:-1] + (full,),
            dtype=torch.promote_types(local.dtype, torch.float32))
        out[..., ctx.cols] = local
        dist.all_reduce(out, group=group)
        return out.to(local.dtype)

    @staticmethod
    def backward(ctx, g):
        # every rank computes the same loss from the full logits: its
        # shard's gradient is its own columns, not their sum
        return g[..., ctx.cols].contiguous(), None, None, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable SUM of ``x`` over ``group`` (its backward is the SUM
    of the cotangents); ``x`` itself where there is no group."""
    return x if group is None else _AllReduce.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward SUMs the cotangent over ``group``
    (the input of a head whose out-features are sharded)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def gather_cols(local: torch.Tensor, group, start: int,
                full: int) -> torch.Tensor:
    """``[..., c]`` shards -> ``[..., full]``: a zero-filled f32 (or
    float64) tensor with this rank's columns at ``start``, SUMmed over
    ``group`` (exact: the other ranks add zeros), cast back; the backward
    takes the rank's own columns."""
    return _GatherCols.apply(local, group, start, full)
