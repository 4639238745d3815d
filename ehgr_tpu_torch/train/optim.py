"""SGD with the reference's 9-group lr/decay policy and step decay
(counterpart of ``ehgr_tpu/train/optim.py``).

* Groups (``label_params``): first conv x1; conv biases x2 without decay; BN
  without decay; the ACTION ("custom") weights x1; the classifier head x5
  weight / x10 bias with ``fc_lr5``; under partial BN every BN but the
  stem's, the ME ``p3_bn1`` included, gets lr 0 ("frozen").  A BN is one
  whose JAX module name holds "bn", as the JAX walk decides: MobileNetV2's
  BNs (``BatchNorm.policy_bn`` False) are not, so their scale and bias go
  with the conv biases (x2, no decay, never frozen), as in JAX.
* Update, torch SGD with momentum: ``buf = mu*buf + g + wd*decay_mult*p``,
  ``p -= lr_group*factor*buf`` with ``lr_group = f32(base_lr*mult)``.
* Step decay: ``factor = gamma ** #(lr_steps passed)``, taken at epoch - 1
  because the reference adjusts the lr at the end of each epoch.
* ``clip_gradient``: optax's ``clip_by_global_norm``.
* Resume: the schedule is the optimizer's own, built from the current
  config; a full-state checkpoint carries the schedule it was trained with
  only so that ``adopt_config_hyper`` can warn where the two differ.

Parameters and momentum buffers are updated in place (no second copy of
either).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

# label -> (lr_mult, decay_mult)
GROUPS: Dict[str, tuple] = {
    "first_conv_weight": (1.0, 1.0),
    "first_conv_bias": (2.0, 0.0),
    "normal_weight": (1.0, 1.0),
    "normal_bias": (2.0, 0.0),
    "bn": (1.0, 0.0),
    "custom_weight": (1.0, 1.0),
    "custom_bn": (1.0, 0.0),
    "lr5_weight": (5.0, 1.0),
    "lr10_bias": (10.0, 0.0),
    "frozen": (0.0, 0.0),
}

# the ACTION gate heads' modules (torch names of the JAX pK_* children)
_ACTION_CHILDREN = ("action_p1_conv1", "action_p2_squeeze", "action_p2_conv1",
                    "action_p2_expand", "action_p3_squeeze", "action_p3_conv1",
                    "action_p3_expand")
_HEAD_NAMES = ("new_fc", "middle_fc1", "middle_fc2", "middle_fc3")


def label_params(model: nn.Module, fc_lr5: bool = True,
                 partial_bn: bool = False) -> Dict[str, str]:
    """Each parameter name of ``model`` -> its policy group, the JAX walk
    over the port's module names."""
    labels = {}
    for name, _ in model.named_parameters():
        mods, leaf = name.split(".")[:-1], name.split(".")[-1]
        owner = model.get_submodule(".".join(mods))
        is_bn = isinstance(owner, nn.modules.batchnorm._BatchNorm)
        if mods and mods[-1] in ("action_shift",) + _ACTION_CHILDREN:
            labels[name] = "custom_weight"
        elif mods and mods[-1] == "action_p3_bn1":
            labels[name] = "frozen" if partial_bn else "custom_bn"
        elif is_bn and getattr(owner, "policy_bn", True):
            is_stem_bn = mods == ["base_model", "bn1"]
            labels[name] = "frozen" if partial_bn and not is_stem_bn \
                else "bn"
        elif mods == ["base_model", "conv1"]:
            labels[name] = ("first_conv_weight" if leaf == "weight"
                            else "first_conv_bias")
        elif mods and mods[-1] in _HEAD_NAMES:
            if fc_lr5:
                labels[name] = "lr5_weight" if leaf == "weight" \
                    else "lr10_bias"
            else:
                labels[name] = "normal_weight" if leaf == "weight" \
                    else "normal_bias"
        elif leaf == "weight" and not is_bn:
            labels[name] = "normal_weight"
        else:                       # a bias, or a BN the walk does not see
            labels[name] = "normal_bias"
    return labels


@dataclass
class SgdState:
    step: int                               # updates taken
    momentum: Dict[str, torch.Tensor]       # buffer per parameter name


def clip_gradient(grads: Mapping[str, torch.Tensor],
                  max_norm: float) -> None:
    """Scale ``grads`` in place to global norm ``max_norm`` when above it
    (optax ``clip_by_global_norm``)."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))


class SgdPolicies:
    """The policy optimizer over ``labels`` (from ``label_params``): the
    epoch of the decay schedule is ``step // steps_per_epoch``."""

    def __init__(self, labels: Mapping[str, str], base_lr: float,
                 momentum: float = 0.9, weight_decay: float = 1e-5,
                 lr_steps: Sequence[int] = (10, 15, 20), gamma: float = 0.1,
                 steps_per_epoch: int = 1,
                 clip_gradient: Optional[float] = None):
        self.labels = dict(labels)
        # f32(base_lr * mult), rounded on the host as the JAX package does
        self.group_lr = {g: np.float32(base_lr * m)
                         for g, (m, _) in GROUPS.items()}
        self.momentum = float(np.float32(momentum))
        self.weight_decay = float(np.float32(weight_decay))
        self.lr_steps = tuple(lr_steps)
        self.gamma = np.float32(gamma)
        self.steps_per_epoch = steps_per_epoch
        self.clip = clip_gradient

    def schedule(self) -> Dict[str, object]:
        """The schedule as plain values (a checkpoint's ``schedule``)."""
        return {"group_lr": {g: float(v) for g, v in self.group_lr.items()},
                "lr_steps": list(self.lr_steps), "gamma": float(self.gamma),
                "momentum": self.momentum,
                "weight_decay": self.weight_decay,
                "steps_per_epoch": self.steps_per_epoch}

    def init(self, params: Mapping[str, torch.Tensor]) -> SgdState:
        return SgdState(step=0, momentum={
            k: torch.zeros_like(p) for k, p in params.items()})

    def factor(self, step: int) -> np.float32:
        """Step-decay factor of the update at ``step``."""
        epoch = step // self.steps_per_epoch
        return self.gamma ** sum((epoch - 1) >= s for s in self.lr_steps)

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor], state: SgdState) -> None:
        """One update of ``params`` and ``state`` in place, as multi-tensor
        (``torch._foreach_*``) ops over each group."""
        if self.clip:
            clip_gradient(grads, self.clip)
        factor = self.factor(state.step)
        keys = list(params)
        bufs = [state.momentum[k] for k in keys]
        torch._foreach_mul_(bufs, self.momentum)
        torch._foreach_add_(bufs, [grads[k] for k in keys])
        by_label: Dict[str, list] = {}
        for k in keys:
            by_label.setdefault(self.labels[k], []).append(k)
        for label, ks in by_label.items():
            decay = GROUPS[label][1]
            if decay:
                torch._foreach_add_([state.momentum[k] for k in ks],
                                    [params[k] for k in ks],
                                    alpha=self.weight_decay * decay)
            upd = torch._foreach_mul([state.momentum[k] for k in ks],
                                     float(self.group_lr[label] * factor))
            torch._foreach_sub_([params[k] for k in ks], upd)
        state.step += 1


def adopt_config_hyper(schedule: Mapping[str, object], opt: SgdPolicies,
                       log=None) -> List[str]:
    """The resume half of the JAX ``adopt_config_hyper``: after a
    full-state resume the CURRENT config's schedule applies (``opt``'s,
    which the port never takes from a checkpoint).  Returns the fields of
    the checkpointed ``schedule`` that differ from ``opt``'s, and warns
    naming them when ``log`` is given."""
    fresh = opt.schedule()
    diffs = [k for k in ("momentum", "weight_decay", "gamma", "lr_steps",
                         "steps_per_epoch") if schedule[k] != fresh[k]]
    diffs += [f"lr[{g}]" for g in fresh["group_lr"]
              if schedule["group_lr"].get(g) != fresh["group_lr"][g]]
    if diffs and log is not None:
        log.warning(
            "resume: checkpointed schedule differs from config on "
            "%s; using the CURRENT config's schedule", diffs)
    return diffs


def build_optimizer(model: nn.Module, cfg_optim, fc_lr5: bool = True,
                    partial_bn: bool = False, steps_per_epoch: int = 1):
    """Config -> ``(optimizer, labels)``; ``policies=False`` puts every
    parameter in one group (plain SGD with momentum and weight decay)."""
    if getattr(cfg_optim, "policies", True):
        labels = label_params(model, fc_lr5=fc_lr5, partial_bn=partial_bn)
    else:
        labels = {k: "normal_weight" for k, _ in model.named_parameters()}
    opt = SgdPolicies(labels, base_lr=cfg_optim.lr,
                      momentum=cfg_optim.momentum,
                      weight_decay=cfg_optim.weight_decay,
                      lr_steps=cfg_optim.lr_steps, gamma=cfg_optim.gamma,
                      steps_per_epoch=steps_per_epoch,
                      clip_gradient=cfg_optim.clip_gradient)
    return opt, labels
