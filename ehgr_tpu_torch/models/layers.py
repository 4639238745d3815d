"""Layers with the JAX package's dtype convention, and weight init from an
explicit ``torch.Generator``.

flax keeps parameters in f32 and casts them to the compute dtype at use;
these layers do the same, computing in the dtype of their input (the model
casts its input once, so the input dtype is the compute dtype).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ehgr_tpu_torch.parallel.collectives import copy_to_group, gather_cols


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(
            x, self.weight.to(x.dtype),
            None if self.bias is None else self.bias.to(x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype),
            None if self.bias is None else self.bias.to(x.dtype),
            self.stride, self.padding, self.output_padding, self.groups,
            self.dilation)


class Conv3d(nn.Conv3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(
            x, self.weight.to(x.dtype),
            None if self.bias is None else self.bias.to(x.dtype))


class ConvTranspose3d(nn.ConvTranspose3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose3d(
            x, self.weight.to(x.dtype),
            None if self.bias is None else self.bias.to(x.dtype),
            self.stride, self.padding, self.output_padding, self.groups,
            self.dilation)


class Conv1d(nn.Conv1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(
            x, self.weight.to(x.dtype),
            None if self.bias is None else self.bias.to(x.dtype))


class Linear(nn.Linear):
    """``tp``: set by ``parallel.mesh.shard_model`` on a head whose
    out-features shard over the mesh's model group, ``(model group, first
    row, full rows)``; the layer then holds its own rows, takes its input as it
    is (the input's gradient SUMmed over the group) and returns the full
    output, gathered over the group."""

    tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            group, start, full = self.tp
            x = copy_to_group(x, group)
        y = F.linear(x, self.weight.to(x.dtype),
                     None if self.bias is None else self.bias.to(x.dtype))
        if self.tp is not None:
            y = gather_cols(y, group, start, full)
        return y


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


def dropout_mask(shape, keep: float, generator,
                 device) -> torch.Tensor:
    """A keep mask of ``shape`` (1 with probability ``keep``) drawn from
    ``generator``."""
    return torch.empty(shape, device=device).bernoulli_(keep,
                                                        generator=generator)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator, rows=None) -> torch.Tensor:
    """Inverted dropout of ``x`` in training, its mask drawn from
    ``generator`` (a ``torch.Generator`` on ``x``'s device); ``x`` as it is
    at eval or at rate 0.  ``rows=(index, count)``: ``x`` is block
    ``index`` of ``count`` equal row blocks of a global batch (a data rank's
    rows); the mask of the global batch is drawn and the block's rows
    taken, so that every rank, drawing from the same generator state, drops
    what one process would on the whole batch."""
    if not training or rate <= 0:
        return x
    if generator is None:
        raise ValueError("training with dropout needs generator=, a "
                         "torch.Generator")
    keep = 1.0 - rate
    if rows is None:
        mask = dropout_mask(x.shape, keep, generator, x.device)
    else:
        index, count = rows
        n = x.shape[0]
        mask = dropout_mask((n * count,) + tuple(x.shape[1:]), keep,
                            generator, x.device)[index * n:(index + 1) * n]
    return x * (mask / keep).to(x.dtype)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """flax-style init of every conv/linear weight: normal with variance
    1/fan_in (lecun; a transposed conv's ``[I, O, kh, kw]`` weight takes
    ``O*kh*kw``, the fan-in flax reads off its ``transpose_kernel``
    layout), biases zero; BN scale 1, bias 0, stats (0, 1).  Draws
    on the CPU from ``generator`` (a CPU generator) in module order, so a
    seed gives the same weights on every device."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d,
                          nn.ConvTranspose2d, nn.ConvTranspose3d,
                          nn.Linear)):
            w = m.weight
            std = w[0].numel() ** -0.5
            w.copy_(torch.empty(w.shape).normal_(0.0, std,
                                                 generator=generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
