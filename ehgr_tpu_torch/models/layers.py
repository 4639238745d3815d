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


class Conv1d(nn.Conv1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(
            x, self.weight.to(x.dtype),
            None if self.bias is None else self.bias.to(x.dtype))


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


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
                          nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            std = w[0].numel() ** -0.5
            w.copy_(torch.empty(w.shape).normal_(0.0, std,
                                                 generator=generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
