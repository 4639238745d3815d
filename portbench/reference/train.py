"""The plain reference of one Stage-1 training step: the loss (cross
entropy, plus ``w * MSE`` of the depth map against the next segment's depth
at the decoder's size), the reference recipe's SGD with its nine-group
learning-rate and weight-decay policy, and the EMA of the parameters and
BN running statistics.  Plain PyTorch, float32; imports nothing of the
measured program.

The policy (TSN's ``get_optim_policies`` with ACTION's ``custom_ops``):
the first conv's weight x1, conv and linear biases x2 without decay, BN
scale and bias without decay, the ACTION gate layers x1, the classifier
x5 (weight) and x10 (bias, no decay); with partial BN every BN but the
first is frozen.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.model import BatchNorm

# group -> (lr multiplier, weight-decay multiplier)
POLICY = {
    "first_conv": (1.0, 1.0), "weight": (1.0, 1.0), "bias": (2.0, 0.0),
    "bn": (1.0, 0.0), "action": (1.0, 1.0), "action_bn": (1.0, 0.0),
    "head_weight": (5.0, 1.0), "head_bias": (10.0, 0.0), "frozen": (0.0, 0.0),
}


def policy_groups(model: nn.Module, partial_bn: bool = False
                  ) -> Dict[str, str]:
    """Parameter name -> policy group."""
    out = {}
    for name, _ in model.named_parameters():
        path, leaf = name.rsplit(".", 1)
        owner = model.get_submodule(path)
        parts = path.split(".")
        if path == "base_model.conv1":
            out[name] = "first_conv"
        elif parts[-1] == "action_p3_bn1":
            out[name] = "frozen" if partial_bn else "action_bn"
        elif parts[-1].startswith("action_"):
            out[name] = "action"
        elif isinstance(owner, BatchNorm):
            out[name] = "frozen" if partial_bn and path != "base_model.bn1" \
                else "bn"
        elif path == "new_fc":
            out[name] = "head_" + leaf
        else:
            out[name] = leaf
    return out


def decay_mults(model: nn.Module, partial_bn: bool = False
                ) -> Dict[str, float]:
    return {k: POLICY[g][1]
            for k, g in policy_groups(model, partial_bn).items()}


class Sgd:
    """SGD with momentum (``buf = mu * buf + g + wd * decay * p``,
    ``p -= lr * mult * buf``) over the policy groups."""

    def __init__(self, model: nn.Module, optim: Dict,
                 partial_bn: bool = False):
        self.params = dict(model.named_parameters())
        self.groups = policy_groups(model, partial_bn)
        self.lr = optim["lr"]
        self.mu = optim["momentum"]
        self.wd = optim["weight_decay"]
        self.buf = {k: torch.zeros_like(p) for k, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        for k, p in self.params.items():
            lr_mult, decay = POLICY[self.groups[k]]
            d = grads[k] + self.wd * decay * p
            self.buf[k] = self.mu * self.buf[k] + d
            p -= self.lr * lr_mult * self.buf[k]


class Ema:
    """``ema = d * ema + (1 - d) * value`` for every parameter and BN
    running statistic."""

    def __init__(self, model: nn.Module, decay: float):
        self.model = model
        self.decay = decay
        self.values = {k: v.detach().clone()
                       for k, v in model.state_dict().items()}

    @torch.no_grad()
    def update(self) -> None:
        for k, v in self.model.state_dict().items():
            self.values[k] = self.decay * self.values[k] \
                + (1.0 - self.decay) * v


def loss_of(out, labels: torch.Tensor, depth=None,
            depth_weight: float = 0.0) -> torch.Tensor:
    """Mean cross entropy, plus ``depth_weight`` times the mean squared
    error of the depth map where the model has one."""
    if isinstance(out, tuple):
        logits, pred = out
        return F.cross_entropy(logits, labels.long()) \
            + depth_weight * ((pred - depth) ** 2).mean()
    return F.cross_entropy(out, labels.long())


def train_steps(model: nn.Module, batches: Iterable[Tuple], sgd: Sgd,
                ema: Ema = None, depth_weight: float = 0.0
                ) -> List[Tuple[float, Dict[str, torch.Tensor]]]:
    """Run one step per ``(x, labels, depth or None, dropout mask or
    None)``; returns each step's loss and gradients."""
    model.train()
    out = []
    params = list(sgd.params.values())
    for x, labels, depth, mask in batches:
        loss = loss_of(model(x, mask), labels, depth, depth_weight)
        grads = dict(zip(sgd.params, torch.autograd.grad(loss, params)))
        sgd.step(grads)
        if ema is not None:
            ema.update()
        out.append((loss.item(), grads))
    return out
