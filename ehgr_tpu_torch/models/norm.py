"""BatchNorm with the JAX package's semantics (counterpart of
``ehgr_tpu/models/norm.py``, which is torch's BN rule written in flax).

Training is torch's own ``BatchNorm2d`` at momentum 0.1 and eps 1e-5 (flax
momentum 0.9 with the unbiased running variance).  Eval folds the running
stats into one per-channel multiply-add, ``a = scale/sqrt(var+eps)`` and
``b = bias - mean*a`` in f32, applied in the input's dtype, as the JAX
module does.

``frozen`` (partial BN) keeps the layer on its running statistics while the
model trains: ``train()`` cannot switch it to batch statistics.

torch's ``num_batches_tracked`` counter is only read when momentum is None;
the JAX variable tree has no counterpart and ``export_state_dict`` emits
none, so here it stays out of the state_dict and a converted state_dict
loads with ``strict=True``.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.BatchNorm2d):
    # whether the optimizer's policy walk labels this layer a BN: the JAX
    # walk decides by "bn" in the flax module name, which MobileNetV2's
    # BNs (``c1``, ``conv_{j}``) lack (train/optim.py)
    policy_bn = True

    def __init__(self, num_features: int, frozen: bool = False,
                 device=None):
        super().__init__(num_features, eps=1e-5, momentum=0.1, device=device)
        self.register_buffer("num_batches_tracked", self.num_batches_tracked,
                             persistent=False)
        self.frozen = frozen
        self.train(self.training)

    def train(self, mode: bool = True) -> "BatchNorm":
        return super().train(mode and not self.frozen)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # skip _NormBase's hook that inserts num_batches_tracked into
        # version-less state_dicts (it would come back as unexpected)
        nn.Module._load_from_state_dict(self, state_dict, prefix, *args,
                                        **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * a
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * a.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)


class BatchNorm3d(BatchNorm):
    """``BatchNorm`` over ``[N, C, T, H, W]`` (the 3-D models)."""

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() != 5:
            raise ValueError(f"expected 5D input (got {x.dim()}D input)")
