"""Train steps of the other backbone families on the CPU, stage
``baseline`` (arch ``tsn``), against the JAX ``make_train_step`` from the
same numpy weights (``test_torch_backbones.draw`` at the JAX init's BN and
head values, converted with ``models/convert.py``) and the same uint8
batches: two steps of MobileNetV2 + ACTION and of Res2Net-50 + ACTION (one
block a stage), one step of BN-Inception + ACTION.

The JAX reference runs in float64 (``jax_run``: x64, every ``jnp.float32``
of the JAX package read as float64), because f32 runs of these networks
are far from float64 here: at N=2 clips the first step's gradients of a
JAX f32 MobileNetV2 + ACTION lay a median 3% of each leaf's largest value
from its float64 run, and three f32 runs of the port (other thread counts,
'vjp' or plain) parted by up to 1.5% in the second step's loss.  At N=4
clips, used here, the f32 losses agree within 2e-5, but single leaves
still part by a few percent (BN scales and biases after the last stages'
1x1 maps; a first-step weight delta of the stem by 2% between one torch
thread and eight).  So each family is held twice:

* in float64 (plain ACTION formulation, its input normalized in float64
  as JAX's is): every step's loss within 1e-6 and every leaf of the final
  state within F64_TOL of its largest JAX value, the same training leaf
  for leaf;
* in f32 in mode ``'vjp'`` (the kernel region at MobileNetV2's and
  Res2Net's ACTION sites, ``LearnableShift`` at BN-Inception's gates):
  every step's loss within 1e-4, and the final state by chip_smoke.py's
  fp32 gate, with the plain f32 run (mode None) as the floor: over the
  leaves of each tree, the 'vjp' run's errors from JAX's float64 state at
  the median and 95th percentile within GRAD_X times the plain run's plus
  TOL, the worst within WORST_X times the plain run's worst plus KINK_TOL.

Port runs take one torch thread (``one_thread``), JAX's as many as it
likes.  An error is max |diff| over max |JAX value|, the latter not below
F64_FLOOR / F32_FLOOR of its tree's largest JAX value: a tensor that is a
sum whose terms cancel sits at the rounding noise of those terms, not of
its own size (a bias that only BNs in training read has an exact gradient
of zero: BN-Inception's conv biases, MobileNetV2's last BN of a block
before a plain conv; a BN scale's gradient at init, ~1e-5 of its tree's
largest)."""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import unflatten_dict

from ehgr_tpu.configs import LossConfig as JLossConfig
from ehgr_tpu.configs import OptimConfig as JOptimConfig
from ehgr_tpu.train.optim import build_optimizer as j_build_optimizer
from ehgr_tpu.train.steps import create_train_state as j_create_state
from ehgr_tpu.train.steps import make_train_step as j_make_train_step
from ehgr_tpu_torch.configs import LossConfig, OptimConfig
from ehgr_tpu_torch.models.convert import state_dict_from_jax
from ehgr_tpu_torch.train import steps as t_steps
from ehgr_tpu_torch.train.optim import build_optimizer
from ehgr_tpu_torch.train.steps import create_train_state, make_train_step

from test_torch_backbones import draw, jax_model, jax_shapes, port, \
    tiny_res2net
from test_torch_loop import _Float64Names
from test_torch_train import (CLS, DEPTH, EMA, HW, KINK_TOL, LR, LR_STEPS,
                              MEAN, STD, T, TOL, _final, one_thread)

# clips a batch: at 2 the last stages' BNs (1x1 maps at 32^2) see 8 values
# a channel and f32 runs part (module docstring)
N = 4
# the port's TSN hands back f32 logits whatever its compute dtype, so its
# float64 run is float64 up to that one rounding (2e-8 of the first loss)
F64_TOL = 1e-6
F64_FLOOR, F32_FLOOR = 1e-7, 1e-5
# the gate of the f32 'vjp' run against the f32 plain run (module
# docstring), chip_smoke.py's train_parity factors
GRAD_X, WORST_X = 1.5, 3.0
# steps of each family's trajectory
STEPS = {"mobilenet_v2": 2, "res2net50": 2, "bn_inception": 1}


def batches(count):
    rng = np.random.default_rng(3)
    return [{"rgb": rng.integers(0, 256, (N, T, HW, HW, 3), dtype=np.uint8),
             "label": rng.integers(0, CLS, (N,))} for _ in range(count)]


def jax_run(family):
    """(initial variables (f32), metrics of each step, the state's trees
    after each step, all flat) of the JAX trajectory in float64."""
    flat0 = draw(jax_shapes("tsn", family, "action", n=N, dropout=0.0),
                 seed=21, init=True)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for name, mod in list(sys.modules.items()):
            if name.startswith("ehgr_tpu.") and \
                    getattr(mod, "jnp", None) is jnp:
                mp.setattr(mod, "jnp", _Float64Names())
        model = jax_model("tsn", family, "action", dropout=0.0,
                          dtype=jnp.float64)
        v = unflatten_dict({k: jnp.asarray(a, jnp.float64)
                            for k, a in flat0.items()})
        tx, _ = j_build_optimizer(v["params"], JOptimConfig(
            lr=LR, lr_steps=LR_STEPS), steps_per_epoch=1)
        step = j_make_train_step(
            model, tx, stage="baseline",
            loss_cfg=JLossConfig(depth_size=DEPTH), ema_decay=EMA,
            mean=MEAN, std=STD, donate=False)
        state = jax.jit(lambda vv: j_create_state(vv, tx))(v)
        metrics, finals = [], []
        with tiny_res2net():
            for b in batches(STEPS[family]):
                state, m = step(state, {k: jnp.asarray(a)
                                        for k, a in b.items()},
                                jax.random.key(0))
                metrics.append({k: float(a) for k, a in m.items()})
                finals.append(_final(state))
    return flat0, metrics, finals


def _normalize64(x, mean, std, dtype=None):
    """The JAX ``normalize_clip`` with its float32 read as float64."""
    m, s = (torch.tensor(v, dtype=torch.float64) for v in (mean, std))
    return x.double() * ((1.0 / 255.0) / s) + (-m / s)


def port_run(family, flat0, mode, dtype):
    """(state trees after each step, metrics of each step) of the port's
    trajectory in ``mode`` and ``dtype`` from ``flat0``, on one torch
    thread (``one_thread``); in float64 the input is normalized in
    float64."""
    model = port("tsn", family, "action", mode, flat0).to(dtype)
    model.dtype, model.dropout = dtype, 0.0
    opt, _ = build_optimizer(model, OptimConfig(lr=LR, lr_steps=LR_STEPS),
                             steps_per_epoch=1)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, stage="baseline",
                           loss_cfg=LossConfig(depth_size=DEPTH),
                           ema_decay=EMA, mean=MEAN, std=STD)
    states, metrics = [], []
    with pytest.MonkeyPatch.context() as mp, one_thread():
        if dtype == torch.float64:
            mp.setattr(t_steps, "normalize_clip", _normalize64)
        for b in batches(STEPS[family]):
            state, m = step(state, b, torch.Generator().manual_seed(0))
            metrics.append({k: float(a) for k, a in m.items()})
            trees = (("params", state.params),
                     ("ema_params", state.ema_params),
                     ("momentum", state.opt_state.momentum),
                     ("batch_stats", state.batch_stats),
                     ("ema_batch_stats", state.ema_batch_stats))
            states.append({name: {k: v.detach().double().numpy()
                                  for k, v in tree.items()}
                           for name, tree in trees})
    return states, metrics


_TREES = (("params", True), ("ema_params", True), ("momentum", False),
          ("batch_stats", False), ("ema_batch_stats", False))


def leaf_errors(got, final, flat0, floor):
    """tree -> key -> max |got - JAX| over max |JAX value| (not below
    ``floor`` of the tree's largest JAX value; module docstring) for each
    tensor of ``got`` (a state of ``port_run``) and ``final`` (the JAX
    trees after the same step); parameters and their EMA as deltas from
    ``flat0``, taken in float64 before the layout change."""
    p0 = {k: t.double().numpy()
          for k, t in state_dict_from_jax(flat0).items()}
    out = {}
    for tree, delta in _TREES:
        jtree = final[tree]
        if delta:                    # ema_params has the params' paths
            jtree = {p: a - flat0[("params",) + p[1:]].astype(np.float64)
                     for p, a in jtree.items()}
        want = {k: t.double().numpy() for k, t in state_dict_from_jax(
            {("params",) + p[1:]: a for p, a in jtree.items()}).items()}
        have = {k: v - (p0[k] if delta else 0.0)
                for k, v in got[tree].items()}
        assert sorted(have) == sorted(want), tree
        low = floor * max(np.abs(v).max() for v in want.values())
        out[tree] = {k: np.abs(have[k] - w).max() / max(np.abs(w).max(), low)
                     for k, w in want.items()}
    return out


def _losses_match(metrics, want, rtol):
    for i, (got, exp) in enumerate(zip(metrics, want)):
        for k in ("loss", "ce"):
            np.testing.assert_allclose(got[k], exp[k], rtol=rtol,
                                       err_msg=f"step {i} {k}")


@pytest.mark.parametrize("family", list(STEPS))
def test_steps_match_jax(family):
    """In float64 leaf for leaf; in f32 'vjp' the losses and the gate
    against the plain f32 run (see the module docstring)."""
    flat0, metrics, finals = jax_run(family)
    states, got = port_run(family, flat0, None, torch.float64)
    _losses_match(got, metrics, 1e-6)
    for tree, errs in leaf_errors(states[-1], finals[-1], flat0,
                                  F64_FLOOR).items():
        worst = max(errs, key=errs.get)
        assert errs[worst] <= F64_TOL, (tree, worst, errs[worst])
    errs = {}
    for mode in ("vjp", None):
        states, got = port_run(family, flat0, mode, torch.float32)
        _losses_match(got, metrics, 1e-4)
        errs[mode] = leaf_errors(states[-1], finals[-1], flat0, F32_FLOOR)
    for tree in errs["vjp"]:
        mine, plain = (np.array(list(errs[m][tree].values()))
                       for m in ("vjp", None))
        for q, x, tol in ((50, GRAD_X, TOL), (95, GRAD_X, TOL),
                          (100, WORST_X, KINK_TOL)):
            a, b = np.percentile(mine, q), np.percentile(plain, q)
            assert a <= x * b + tol, (tree, q, a, b)
