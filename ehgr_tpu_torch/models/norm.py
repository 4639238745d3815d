"""BatchNorm with the JAX package's semantics (counterpart of
``ehgr_tpu/models/norm.py``, which is torch's BN rule written in flax).

Training is torch's own ``BatchNorm2d`` at momentum 0.1 and eps 1e-5 (flax
momentum 0.9 with the unbiased running variance).  Eval folds the running
stats into one per-channel multiply-add, ``a = scale/sqrt(var+eps)`` and
``b = bias - mean*a`` in f32, applied in the input's dtype, as the JAX
module does.

``frozen`` (partial BN) keeps the layer on its running statistics while the
model trains: ``train()`` cannot switch it to batch statistics.

On a mesh (``parallel.mesh.shard_model`` sets ``data_group``, the mesh's
data group where it has more than one rank), a training layer
takes its statistics over the global batch, as JAX's BN does under GSPMD:
the per-rank sum and then the sum of squared deviations from the global mean
are each SUMmed over the data group (two passes: summing x and x^2 cancels
badly at the stem's activations), through a differentiable ``all_reduce``;
the running variance is updated unbiased with the global count.  Frozen
layers and eval are as without a mesh.

torch's ``num_batches_tracked`` counter is only read when momentum is None;
the JAX variable tree has no counterpart and ``export_state_dict`` emits
none, so here it stays out of the state_dict and a converted state_dict
loads with ``strict=True``.
"""

from __future__ import annotations

import torch
from torch import nn

from ehgr_tpu_torch.parallel.collectives import all_reduce, group_size


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
        self.data_group = None
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
            if self.data_group is not None:
                return self._global_forward(x)
            return super().forward(x)
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * a
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * a.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Training over ``data_group``: statistics of the global batch in
        f32 (float64 for a float64 input), the output in the input's
        dtype."""
        group = self.data_group
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        count = x.numel() // x.shape[1] * group_size(group)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = all_reduce(xf.sum(dims), group) / count
        d = xf - mean.view(shape)
        var = all_reduce((d * d).sum(dims), group) / count
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(
                mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(
                var * (count / max(count - 1, 1)), alpha=self.momentum)
        y = d * (torch.rsqrt(var + self.eps) * self.weight).view(shape) \
            + self.bias.view(shape)
        return y.to(x.dtype)


class BatchNorm3d(BatchNorm):
    """``BatchNorm`` over ``[N, C, T, H, W]`` (the 3-D models)."""

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() != 5:
            raise ValueError(f"expected 5D input (got {x.dim()}D input)")
