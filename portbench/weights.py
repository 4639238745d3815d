"""The cell's weights from ``--seed``, made on the run's device in one
draw, as a state dict in the measured program's key names (the reference's
names are the same), and the BN running statistics that the reference sets
from the first batch.

Draws: every conv and linear weight normal with variance 1 / fan-in (the
head too, so that the logits are of order one and the comparison of
probabilities sees the whole model), biases ``N(0, 0.01^2)``, BN scales
``1 + N(0, 0.1^2)`` and shifts ``N(0, 0.1^2)``, and ACTION's shift taps the
TSM pattern (one tap 1 a channel) plus ``N(0, 0.1^2)``.  The last BN of
each residual branch (``bn3``) has its scale and shift times
``RESIDUAL_SCALE``, as the zero-init of that scale does in training from scratch
(Goyal et al., arXiv:1706.02677): a random BN ResNet at full scale trains
in its chaotic regime, where any rounding decorrelates the early layers'
gradients and every precision reads alike (PERF.md).

With BN's initial statistics (mean 0, variance 1) random weights grow a
ResNet-50's activations to ~1e5, where every comparison measures amplified
rounding.  So each BN's running statistics are set once from its input on
an eval forward of the reference over the first batch (float32), and both
sides get them.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from portbench.reference.model import BatchNorm, TSN

RESIDUAL_SCALE = 0.1


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matrix products and convolutions inside the block."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _kinds(ref: TSN) -> Dict[str, str]:
    """State-dict key -> what is drawn for it."""
    kinds = {}
    for path, mod in ref.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            key = f"{path}.{leaf}"
            if isinstance(mod, BatchNorm):
                kinds[key] = "bn_" + leaf
            elif path.endswith("action_shift"):
                kinds[key] = "shift"
            else:
                kinds[key] = leaf
        for leaf, _ in mod.named_buffers(recurse=False):
            kinds[f"{path}.{leaf}"] = leaf
    return kinds


def make_weights(model: Dict, with_depth: bool, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """float32 state dict of the TSN (with the depth decoder where
    ``with_depth``) drawn from ``seed`` on ``device``."""
    meta = TSN(model, with_depth, device="meta")
    shapes = {k: v.shape for k, v in meta.state_dict().items()}
    kinds = _kinds(meta)
    total = sum(shapes[k].numel() for k in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for key, shape in shapes.items():
        z = draw[at:at + shape.numel()].view(shape)
        at += shape.numel()
        kind = kinds[key]
        if kind == "weight":
            v = z * shape[1:].numel() ** -0.5
        elif kind == "shift":                    # [C, 1, 3] taps
            c = shape[0]
            fold = c // model["shift_div"]
            tap = torch.ones(c, dtype=torch.long, device=device)
            tap[:fold], tap[fold:2 * fold] = 2, 0
            v = 0.1 * z
            v[torch.arange(c, device=device), 0, tap] += 1.0
        elif kind == "bias":
            v = 0.01 * z
        elif kind == "bn_weight":
            v = (RESIDUAL_SCALE if key.endswith("bn3.weight") else 1.0) \
                * (1.0 + 0.1 * z)
        elif kind == "bn_bias":
            v = (RESIDUAL_SCALE if key.endswith("bn3.bias") else 1.0) \
                * 0.1 * z
        elif kind == "running_mean":
            v = torch.zeros(shape, device=device)
        elif kind == "running_var":
            v = torch.ones(shape, device=device)
        else:
            raise KeyError(f"no draw for {key} ({kind})")
        out[key] = v.contiguous()
    return out


@torch.no_grad()
def bn_statistics(model: Dict, weights: Dict[str, torch.Tensor],
                  frames: torch.Tensor, with_depth: bool
                  ) -> Dict[str, torch.Tensor]:
    """Each BN's running mean and (biased) variance of its input on one
    eval forward of the reference over normalised ``frames [N, T, H, W,
    3]``, each set before the layer runs; returns them by key."""
    ref = TSN(model, with_depth, device=frames.device)
    ref.load_state_dict(weights, strict=True)
    ref.eval()

    def set_stats(bn, inputs):
        x = inputs[0]
        bn.running_mean.copy_(x.mean((0, 2, 3)))
        bn.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats)
             for m in ref.modules() if isinstance(m, BatchNorm)]
    with float32_exact():
        ref(frames)
    for h in hooks:
        h.remove()
    return {k: v.clone() for k, v in ref.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}
