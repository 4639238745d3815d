"""FLOPs of a served call or a train step, counted once over the plain
reference on the meta device (``torch.utils.flop_counter``: the matrix
products and convolutions, forward and backward), so that the count is the
same whatever implements the work.  Recomputation is not counted: the
reference keeps what its backward needs.

A convolution's backward costs its forward's FLOPs once for the input's
gradient and once for the weight's.  ``torch.utils.flop_counter`` counts
the weight's gradient of a grouped convolution as if it were dense (``groups``
times too many), so this module gives it that rule instead."""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.model import TSN
from portbench.reference.train import loss_of

aten = torch.ops.aten


def _prod(shape) -> int:
    out = 1
    for v in shape:
        out *= v
    return out


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        _groups, output_mask, out_shape=None, **kw) -> int:
    """Each requested gradient of a convolution costs its forward: 2 FLOPs
    for each output element (each input element, transposed) times the
    weight's elements per output channel."""
    fwd = 2 * _prod(x_shape if transposed else grad_out_shape) \
        * _prod(w_shape[1:])
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


def counter() -> FlopCounterMode:
    return FlopCounterMode(display=False, custom_mapping={
        aten.convolution_backward: conv_backward_flops})


def call_flops(model: Dict, clips: int, crop: int) -> int:
    """One eval forward of ``clips`` clips."""
    ref = TSN(model, with_depth=False, device="meta").eval()
    x = torch.empty(clips, model["num_segments"], crop, crop, 3,
                    device="meta")
    with counter() as fc, torch.no_grad():
        ref(x)
    return fc.get_total_flops()


def step_flops(model: Dict, clips: int, crop: int, with_depth: bool,
               depth_weight: float) -> int:
    """One training forward and backward of ``clips`` clips, dropout and
    the depth loss included."""
    ref = TSN(model, with_depth=with_depth, device="meta").train()
    t = model["num_segments"]
    x = torch.empty(clips, t, crop, crop, 3, device="meta")
    labels = torch.zeros(clips, dtype=torch.long, device="meta")
    mask = torch.ones(clips * t, model["feature_width"], device="meta")
    with counter() as fc:
        out = ref(x, mask)
        depth = torch.empty(out[1].shape, device="meta") \
            if with_depth else None
        loss_of(out, labels, depth, depth_weight).backward()
    return fc.get_total_flops()
