"""The 3-D models on the CPU: R(2+1)D-18, ``r2plus1d_mtmm`` (its MTMM depth
decoder) and SlowOnly-R50, at full depth and width, against the JAX package
(``ehgr_tpu/models/video3d.py``) from the same weights: drawn with numpy
from a fixed seed over the JAX variable tree (BN statistics off their init,
so every BN acts) and converted with ``models/convert.py``, loaded
strictly.

Held within TOL of the max |JAX value| of each tensor: the fp32 eval
logits (and depth map) of all three; for SlowOnly (stage ``baseline``) and
``r2plus1d_mtmm`` (stage ``mtmm``), one ``make_train_step`` against JAX's
(one parameter group, as ``cli.train_slowonly`` sets it; dropout 0) and a
train-mode forward beside it: the outputs and the BN statistics that
forward writes, every parameter's gradient (the momentum after the step),
the loss and its parts, the updated parameters and BN statistics.  These
run in float64 on both sides (x64, the JAX package's ``jnp.float32`` read
as float64): in fp32 the gradients of these random full-depth models are
ill-conditioned, single leaves of the port's and of JAX's fp32 gradients
sitting up to 16% and 3% from a float64 run (activations at a ReLU's kink
under train-mode BN over 8-64 elements a channel), so fp32 against fp32
would compare rounding.  R(2+1)D-18's train path is ``r2plus1d_mtmm``'s
trunk.  Also the decoder's transposed convs alone at T = 1 -> 2 and at an
odd spatial size, ``build_model`` and ``cli.train_slowonly``.

Geometry N=2, 32^2, 5 classes; T=8 for R(2+1)D (its decoder grows layer4's
T=1 back to 8) and T=4 for SlowOnly.  Each JAX model compiles once a dtype
(``jax_eval``, ``float64_step``: module-scoped)."""

import dataclasses
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn
from flax.traverse_util import flatten_dict, unflatten_dict

from ehgr_tpu.configs import LossConfig as JLossConfig
from ehgr_tpu.configs import OptimConfig as JOptimConfig
from ehgr_tpu.models.video3d import R2Plus1D18 as JR2Plus1D18
from ehgr_tpu.models.video3d import SlowOnlyR50 as JSlowOnlyR50
from ehgr_tpu.train.optim import build_optimizer as j_build_optimizer
from ehgr_tpu.train.steps import create_train_state as j_create_state
from ehgr_tpu.train.steps import make_train_step as j_make_train_step
from ehgr_tpu_torch.cli import train_slowonly
from ehgr_tpu_torch.configs import LossConfig, OptimConfig, get_preset
from ehgr_tpu_torch.models.convert import (convert_tensor,
                                           load_jax_variables,
                                           state_dict_from_jax, torch_key)
from ehgr_tpu_torch.models.factory import build_model
from ehgr_tpu_torch.models.layers import ConvTranspose3d
from ehgr_tpu_torch.models.video3d import R2Plus1D18, SlowOnlyR50
from ehgr_tpu_torch.train import steps as p_steps
from ehgr_tpu_torch.train.optim import build_optimizer
from ehgr_tpu_torch.train.steps import create_train_state, make_train_step

CLS, N, HW = 5, 2, 32
TOL = 1e-4
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LR, DEPTH = 0.00125, HW // 4
# arch -> (T, JAX model, port model class and kwargs)
MODELS = {
    "r2plus1d": (8, lambda d=jnp.float32: JR2Plus1D18(CLS, dropout=0.0,
                                                      dtype=d),
                 lambda: R2Plus1D18(CLS, dropout=0.0, device="cpu")),
    "r2plus1d_mtmm": (8, lambda d=jnp.float32: JR2Plus1D18(
        CLS, dropout=0.0, with_depth=True, dtype=d),
        lambda: R2Plus1D18(CLS, dropout=0.0, with_depth=True,
                           device="cpu")),
    "slowonly": (4, lambda d=jnp.float32: JSlowOnlyR50(CLS, dropout=0.0,
                                                       dtype=d),
                 lambda: SlowOnlyR50(CLS, dropout=0.0, device="cpu")),
}
# arch -> train stage of its make_train_step case
STEPS = {"slowonly": "baseline", "r2plus1d_mtmm": "mtmm"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread for the file: at these sizes more threads only
    add overhead, and over many a CPU op spins against the other test
    processes that hold the cores.  No compared result depends on it
    beyond rounding (far inside TOL)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def draw(shapes, seed):
    """Variables of the tree ``shapes`` drawn with numpy: kernels
    N(0, 1/fan_in), BN scale and running variance U(0.5, 1.5), biases and
    running means N(0, 0.1^2); f32, leaves in sorted path order."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in sorted(flatten_dict(shapes).items()):
        leaf = path[-1]
        if leaf == "kernel":
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif leaf in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, s.shape)
        else:
            a = rng.normal(0.0, 0.1, s.shape)
        out[path] = np.asarray(a, np.float32)
    return out


def _x(t, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (N, t, HW, HW, 3)).astype(np.float32)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


class _Float64Names:
    """``jax.numpy`` with ``float32`` read as ``float64`` (in place of
    ``jnp`` in the JAX package's modules in the float64 step)."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


_EVALS = {}


def jax_eval(arch):
    """(flat variables, eval outputs) of the fp32 JAX model on ``_x``, one
    jitted forward; kept per arch and module."""
    if arch not in _EVALS:
        t, jmodel, _ = MODELS[arch]
        model = jmodel()
        x = jnp.asarray(_x(t))
        shapes = jax.eval_shape(lambda r: model.init(r, x, train=False),
                                {"params": jax.random.key(0)})
        flat = draw(shapes, seed=sorted(MODELS).index(arch))
        ev = jax.jit(lambda v: model.apply(v, x, train=False))(
            unflatten_dict(flat))
        _EVALS[arch] = flat, [np.asarray(o) for o in _as_tuple(ev)]
    return _EVALS[arch]


def port_model(arch, flat, dtype=torch.float32):
    model = MODELS[arch][2]()
    load_jax_variables(model, flat)
    model.to(dtype).dtype = dtype
    return model


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_eval_outputs(arch):
    """fp32 eval outputs within TOL of JAX's (the depth map ``[N, 8, H/4,
    W/4, 1]``)."""
    flat, want = jax_eval(arch)
    model = port_model(arch, flat)
    with torch.no_grad():
        got = [o.numpy() for o in _as_tuple(model(torch.from_numpy(
            _x(MODELS[arch][0]))))]
    assert [o.shape for o in got] == [o.shape for o in want]
    if arch == "r2plus1d_mtmm":
        assert want[1].shape == (N, 8, HW // 4, HW // 4, 1)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


def _train_batch(t, with_depth, seed=3):
    rng = np.random.default_rng(seed)
    b = {"rgb": rng.integers(0, 256, (N, t, HW, HW, 3), dtype=np.uint8),
         "label": rng.integers(0, CLS, (N,))}
    if with_depth:
        b["depth"] = rng.integers(0, 256, (N, t, HW, HW, 1), dtype=np.uint8)
    return b


def _normalize64(x, mean=MEAN, std=STD, dtype=None):
    """The port's ``normalize_clip`` in float64 (the float64 step's)."""
    mean = torch.tensor(mean, dtype=torch.float64)
    std = torch.tensor(std, dtype=torch.float64)
    return (torch.as_tensor(x).to(torch.float64) / 255.0 - mean) / std


def _flat(tree, coll):
    return {(coll,) + p: np.asarray(a) for p, a in flatten_dict(tree).items()}


@pytest.fixture(scope="module", params=sorted(STEPS))
def float64_step(request):
    """One step of each package's ``make_train_step`` (stage ``baseline``
    for SlowOnly, ``mtmm`` for ``r2plus1d_mtmm``; one parameter group,
    dropout 0) from the same weights and batch, and a train-mode forward
    of the batch beside it, float64 on both sides: x64 on and every
    ``jnp.float32`` of the JAX package read as float64;
    the port's input normalization in float64.  JAX's step is its own
    jitted function; the forward is jitted apart (one program with the
    step would compile twice as long).  Returns the two sides'
    metrics, trees after the step (params, BN statistics, momentum: the
    first step's momentum is the gradient plus weight decay) and forward
    outputs and statistics, as torch state dicts."""
    arch = request.param
    stage = STEPS[arch]
    t, jmodel, _ = MODELS[arch]
    flat = jax_eval(arch)[0]
    batch = _train_batch(t, stage == "mtmm")
    x = _normalize64(batch["rgb"]).numpy()
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for name, mod in list(sys.modules.items()):
            if name.startswith("ehgr_tpu.") and \
                    getattr(mod, "jnp", None) is jnp:
                mp.setattr(mod, "jnp", _Float64Names())
        model = jmodel(jnp.float64)
        v = unflatten_dict({p: jnp.asarray(a, jnp.float64)
                            for p, a in flat.items()})
        tx, _ = j_build_optimizer(v["params"],
                                  JOptimConfig(lr=LR, policies=False),
                                  steps_per_epoch=1)
        step = j_make_train_step(model, tx, stage=stage,
                                 loss_cfg=JLossConfig(depth_size=DEPTH),
                                 ema_decay=0.9, mean=MEAN, std=STD,
                                 donate=False)

        state, jm = jax.device_get(step(
            j_create_state(v, tx),
            {k: jnp.asarray(a) for k, a in batch.items()},
            jax.random.key(0)))
        fwd, mut = jax.device_get(jax.jit(lambda v, x: model.apply(
            v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x)))
        stats = mut["batch_stats"]
    jax_side = dict(
        metrics={k: float(a) for k, a in jm.items()},
        params=state_dict_from_jax(_flat(state.params, "params")),
        batch_stats=state_dict_from_jax(_flat(state.batch_stats,
                                              "batch_stats")),
        momentum=state_dict_from_jax(_flat(state.opt_state.momentum,
                                           "params")),
        forward=[np.asarray(o) for o in _as_tuple(fwd)],
        forward_stats=state_dict_from_jax(_flat(stats, "batch_stats")))

    fmodel = port_model(arch, flat, torch.float64).train()
    with torch.no_grad():
        pfwd = [o.numpy() for o in _as_tuple(fmodel(torch.from_numpy(x)))]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(p_steps, "normalize_clip", _normalize64)
        pmodel = port_model(arch, flat, torch.float64)
        opt, labels = build_optimizer(pmodel, OptimConfig(lr=LR,
                                                          policies=False),
                                      steps_per_epoch=1)
        assert set(labels.values()) == {"normal_weight"}
        pstate = create_train_state(pmodel, opt)
        pstep = make_train_step(pmodel, opt, stage=stage,
                                loss_cfg=LossConfig(depth_size=DEPTH),
                                ema_decay=0.9, mean=MEAN, std=STD)
        _, pm = pstep(pstate, batch, torch.Generator().manual_seed(0))
    port_side = dict(
        metrics={k: float(a) for k, a in pm.items()},
        params=pstate.params, batch_stats=pstate.batch_stats,
        momentum=pstate.opt_state.momentum, forward=pfwd,
        forward_stats={k: b for k, b in fmodel.state_dict().items()
                       if "running_" in k})
    return jax_side, port_side


def test_train_forward_and_batch_stats(float64_step):
    """Train-mode outputs (BN on batch statistics, dropout 0) and the BN
    statistics that forward writes, within TOL."""
    want, got = float64_step
    for g, w in zip(got["forward"], want["forward"]):
        assert g.shape == w.shape and _rel(g, w) <= TOL
    assert set(got["forward_stats"]) == set(want["forward_stats"])
    for k, w in want["forward_stats"].items():
        assert _rel(got["forward_stats"][k], w) <= TOL, k


def test_gradients(float64_step):
    """Every parameter's gradient of the step's loss (the momentum after
    one step: gradient plus weight decay), within TOL of the leaf's max
    |JAX value|."""
    want, got = float64_step
    assert set(got["momentum"]) == set(want["momentum"]) == \
        set(got["params"])
    errs = {k: _rel(got["momentum"][k], w)
            for k, w in want["momentum"].items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])


def test_train_step(float64_step):
    """The step's loss and its parts, the updated parameters and BN
    statistics, within TOL."""
    want, got = float64_step
    assert set(got["metrics"]) == set(want["metrics"])
    for k, w in want["metrics"].items():
        assert abs(got["metrics"][k] - w) <= TOL * max(abs(w), 1e-6), k
    for tree in ("params", "batch_stats"):
        assert set(want[tree]) <= set(got[tree])
        for k, w in want[tree].items():
            assert _rel(got[tree][k].detach(), w) <= TOL, (tree, k)


@pytest.mark.parametrize("kernel,stride,pad,shape", [
    ((4, 4, 4), (2, 2, 2), (1, 1, 1), (1, 1, 5, 5, 6)),
    ((4, 4, 4), (2, 2, 2), (1, 1, 1), (2, 3, 7, 4, 6)),
    ((4, 1, 1), (2, 1, 1), (1, 0, 0), (1, 1, 5, 7, 6))])
def test_transposed_conv(kernel, stride, pad, shape):
    """flax ``ConvTranspose(padding='SAME', transpose_kernel=True)`` is the
    port's ``ConvTranspose3d(padding=pad)`` with the kernel converted by the
    rank-5 rule (no flip), from T=1 to 2 and at odd H and W."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    layer = nn.ConvTranspose(3, kernel, strides=stride, padding="SAME",
                             transpose_kernel=True, use_bias=False)
    v = layer.init(jax.random.key(0), jnp.asarray(x))
    k = rng.standard_normal(v["params"]["kernel"].shape).astype(np.float32)
    want = np.asarray(layer.apply({"params": {"kernel": k}},
                                  jnp.asarray(x)))
    conv = ConvTranspose3d(shape[-1], 3, kernel, stride=stride, padding=pad,
                           bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(convert_tensor(
            k, torch_key(("dec_ct0", "kernel")))))
        got = conv(torch.from_numpy(x).permute(0, 4, 1, 2, 3)) \
            .permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape == (shape[0],) + tuple(
        s * st for s, st in zip(shape[1:4], stride)) + (3,)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("arch", ["slowonly", "r2plus1d", "r2plus1d_mtmm"])
def test_build_model(arch):
    m = dataclasses.replace(get_preset("ego_baseline").model, arch=arch,
                            num_classes=CLS, dropout=0.3)
    model = build_model(m, device="cpu")
    want = SlowOnlyR50 if arch == "slowonly" else R2Plus1D18
    assert type(model) is want and model.dropout == 0.3
    assert model.dtype == torch.bfloat16
    assert getattr(model, "with_depth", False) == (arch == "r2plus1d_mtmm")
    with pytest.raises(ValueError, match="int8"):
        build_model(m, device="cpu", quantize="static")


def test_train_slowonly_cli(tmp_path):
    """``cli.train_slowonly --synthetic`` at the tiny flags: arch
    ``slowonly``, one parameter group, 2 steps, its checkpoints written."""
    res = train_slowonly.main([
        "--synthetic", "--device", "cpu", "--clip_len", "4",
        "--crop_size", "32", "--scale_size", "32", "--num_classes", "5",
        "--batch_size", "4", "--synthetic_videos", "8", "--epochs", "1",
        "--run_dir", str(tmp_path)])
    run_dir = res["run_dir"]
    assert "BASELINE" in run_dir and np.isfinite(res["final_train_loss"])
    with open(os.path.join(run_dir, "train.log")) as f:
        log = f.read()
    assert "arch='slowonly'" in log and "policies=False" in log
    assert "Epoch 0 train: 2 steps" in log
    ckpts = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(run_dir, "*_ckpt.pth")))
    assert ckpts == [f"ACTION_resnet50_{t}_ckpt.pth"
                     for t in ("best", "ema_best", "latest")]
    payload = torch.load(os.path.join(run_dir, ckpts[-1]),
                         weights_only=True)
    assert "proj.weight" in payload["state_dict"]
    for name in ckpts:                       # ~380 MB each
        os.remove(os.path.join(run_dir, name))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        assert json.loads(f.readline())["epoch"] == 0
