"""The mesh on the CPU: the port's ``parallel/mesh.py`` over gloo, one
process a rank (``run_ranks``), against the JAX package's sharded step and
scorer on its 8-device CPU mesh (``tests/conftest.py``), from the same
numpy-seeded batches and converted weights.

Geometry: the tiny TSN of ``tests/torch_mesh_ranks.py`` (ResNet-50 widths,
one bottleneck a stage on both sides, T=4, 32^2, 16 classes so the heads
shard over a model axis of 2), every BN training (``partial_bn=False``: the
global statistics are tested at every layer), ``action_fused='vjp'`` on
both sides, fp32.  Two port topologies, each spawned once for the module:
``(data=4, model=1)`` and ``(data=2, model=2)``; each rank runs on one torch
thread, within a group timeout of ``GROUP_S`` and a join limit of
``JOIN_S``.

Held:
* the layout and the head-sharding rule equal JAX's;
* the ``baseline`` step on data=4 against JAX's on ``make_mesh(4)``, the
  joint ``mtmm_sd`` step with dropout 0.5 on (2, 2) against JAX's on
  ``make_mesh(4, model_parallel=2)`` (the same global keep mask on both
  sides: JAX's ``nn.Dropout`` replaced by one that applies it, the port's
  ``layers.dropout_mask`` by one that checks the global shape and returns
  it; the hint weight ``HINT_BETA`` so the feature-hint SUM moves the
  exits' gradients by far more than the limits), and ``sd`` with
  ``accum_steps=2`` on (2, 2) against JAX's sharded accumulation step.
  These hold the mesh's semantics, so they run in float64 on both sides
  (x64 on, the JAX package's ``jnp.float32`` read as float64, the plain
  ACTION formulation): the loss, every parameter and the stem BN's running
  statistics within JAX's own sharded-step limits (``LOSS_RTOL``,
  ``PARAM_TOL``, ``STAT_TOL``), and every leaf's momentum (after one
  step, the gradient plus weight decay) within ``GRAD64``.  In fp32 these
  random networks' gradients sit up to several percent from float64 on
  single leaves (BN's backward subtracts large sums), more than any mesh
  effect.  Each step also runs in fp32 in 'vjp' (the kernel region, whose
  ME BN takes its global statistics itself), held to the port's float64
  step on the same mesh by ``F32_GATE``.  The ranks of one model index
  hold bitwise the same state.
  The joint step's reference is JAX's one-device step: JAX's step on the
  (data=2, model=2) CPU mesh returns twice the gradient of every
  depthwise conv weight (the ACTION ME's ``p3_conv1`` and the SD exits'
  ``dw1`` / ``dw2``, ratio 2.00 leaf by leaf; in float64, also in ``sd``
  without accumulation), while its (2, 1), (4, 1) and (1, 2) meshes equal
  its one-device step to 1e-8, and so does the port on every topology;
* the sharded scorer, pure DP on (4, 1) and with TP heads on (2, 2),
  against JAX's ``make_sharded_score_fn`` with TP heads on
  ``make_mesh(4, model_parallel=2)`` (rtol 2e-5, atol 1e-6, JAX's own test,
  which holds that scorer, and the pure-DP one, to JAX's one-device scorer
  at the same limits: one JAX scorer is compiled here), and its "divide"
  error;
* a state saved on (2, 2) restores bitwise on one process and on (4, 1),
  whose eval logits equal the one-process model's (rtol 1e-5, atol 1e-6,
  JAX's own test), and back into (2, 2) bitwise;
* a rank that raises ends the run with its traceback within the deadline;
  NCCL with more ranks than cards raises; a mesh given no device takes the
  rank's card, and raises without CUDA.
"""

import contextlib
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import flax.linen
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from ehgr_tpu.configs import LossConfig as JLossConfig
from ehgr_tpu.configs import OptimConfig as JOptimConfig
from ehgr_tpu.eval.inference import \
    make_sharded_score_fn as j_make_sharded_score_fn
from ehgr_tpu.models import tsn as j_tsn
from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu.parallel import mesh as jmesh
from ehgr_tpu.train.optim import build_optimizer as j_build_optimizer
from ehgr_tpu.train.steps import create_train_state as j_create_state
from ehgr_tpu.train.steps import make_train_step as j_make_train_step
from ehgr_tpu_torch.configs import OptimConfig
from ehgr_tpu_torch.models.convert import (convert_tensor,
                                           state_dict_from_jax, torch_key)
from ehgr_tpu_torch.models.tsn import variant
from ehgr_tpu_torch.parallel import mesh as pmesh
from ehgr_tpu_torch.train.checkpoints import load_train_state
from ehgr_tpu_torch.train.optim import build_optimizer
from ehgr_tpu_torch.train.steps import create_train_state

import torch_mesh_ranks as R
from test_torch_train import one_thread, tiny_resnet

T, HW, CLS, DEPTH = R.T, R.HW, R.CLS, R.DEPTH
# videos x clips of the scorer's batch (V divides both data axes)
VIDEOS, CLIPS = 4, 2
# the joint step's hint weight: at the recipe's 1e-6 the hint SUM is ~0.03
# of a loss of ~20; at 1e-3 it is ~30, so halving it (the fault of dividing
# a SUM by the data size) moves the exits' gradients by tens of percent
HINT_BETA = 1e-3
KEEP = 0.5
# JAX's own sharded-step limits (tests/test_train_step.py)
LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
STAT_TOL = dict(rtol=1e-4, atol=1e-6)
# the float64 steps' momentum after one step (the gradient plus weight
# decay), leaf by leaf, max |port - JAX| / max |JAX|: JAX's float64 values
# are rounded to f32 by the conversion (~6e-8) and the port's depth target
# is resized in f32 (the depth head's biases: 1.1e-6); a fault of the mesh
# (a gradient mp times too large, a partial one, a hint halved) moves
# whole trees by tens of percent
GRAD64 = 1e-5
# the fp32 'vjp' step against the float64 one (both the port's, on the same
# mesh), same measure: median, 95th percentile and worst over the leaves.
# The float64 steps run the plain ACTION formulation (the kernels take f32
# and bf16), so this holds the kernel region's global ME BN statistics.
# fp32 gradients of this network are ill-conditioned on single leaves (BN's
# backward subtracts large sums)
F32_GATE = {"median": 1e-4, "p95": 1e-4, "worst": 1e-3}
# a conv bias that feeds a training BN has an exact gradient of zero: both
# sides hold rounding noise, held within this share of its weight's
ZERO_GRAD_REL = 1e-3
GROUP_S, JOIN_S = 120.0, 420.0


def _batch(seed, n, depth=False):
    rng = np.random.default_rng(seed)
    b = {"rgb": rng.integers(0, 256, (n, T, HW, HW, 3), dtype=np.uint8),
         "label": rng.integers(0, CLS, (n,))}
    if depth:
        b["depth"] = rng.integers(0, 256, (n, T, HW, HW, 1), dtype=np.uint8)
    return b


DP_BATCH = _batch(0, 8)
JOINT_BATCH = _batch(1, 4, depth=True)
SD_BATCH = _batch(2, 8)
FRAMES = np.random.default_rng(3).integers(
    0, 256, (VIDEOS, CLIPS, T, HW, HW, 3), dtype=np.uint8)
# the joint step's global keep mask over the pooled features [N*T, 2048]
MASK = (np.random.default_rng(4).random((4 * T, 2048)) < KEEP).astype(
    np.float32)


class _FixedDropout:
    """``flax.linen.Dropout`` applying ``MASK`` (JAX's select form)."""

    def __init__(self, rate, deterministic=False):
        self.rate, self.deterministic = rate, deterministic

    def __call__(self, x):
        if self.deterministic or self.rate == 0:
            return x
        assert x.shape == MASK.shape, x.shape
        keep = 1.0 - self.rate
        return jnp.where(jnp.asarray(MASK) > 0, x / keep, jnp.zeros_like(x))


class _Linen:
    """``flax.linen`` with ``Dropout`` replaced by ``_FixedDropout``."""
    Dropout = _FixedDropout

    def __getattr__(self, name):
        return getattr(flax.linen, name)


@contextlib.contextmanager
def fixed_dropout():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_tsn, "nn", _Linen())
        yield


def _flat(tree, collection):
    return {(collection,) + p: np.asarray(a)
            for p, a in flatten_dict(jax.device_get(tree)).items()}


def _torch_tree(tree, collection="params"):
    return {k: v.numpy() for k, v in
            state_dict_from_jax(_flat(tree, collection)).items()}


def _init(arch, seed, dropout=0.0):
    """The f32 model ('vjp', the scorer's) and its initial variables."""
    with tiny_resnet():
        model = j_variant(arch, num_class=CLS, num_segments=T,
                          partial_bn=False, dropout=dropout,
                          action_fused="vjp")
        v = jax.jit(lambda r: model.init(
            {"params": r}, jnp.zeros((2, T, HW, HW, 3)), train=False))(
                jax.random.key(seed))
    return model, v


class _Float64Names:
    """``jax.numpy`` with ``float32`` read as ``float64`` (in place of
    ``jnp`` in the JAX package's modules in the float64 steps)."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _place(state, mesh, tp):
    """The train state on ``mesh`` as ``dryrun_multichip`` lays it out:
    parameters, momentum and EMA in the (TP) parameter layout, the rest
    replicated."""
    psh = jmesh.param_shardings(state.params, mesh, model_parallel=tp)
    repl = jmesh.replicated(mesh)

    def put(tree):
        return jax.tree.map(jax.device_put, tree, psh)

    def rep(tree):
        return jax.tree.map(lambda x: jax.device_put(x, repl), tree)

    return state.replace(
        step=rep(state.step), params=put(state.params),
        batch_stats=rep(state.batch_stats),
        opt_state=state.opt_state._replace(
            step=rep(state.opt_state.step),
            momentum=put(state.opt_state.momentum)),
        ema_params=put(state.ema_params),
        ema_batch_stats=rep(state.ema_batch_stats))


def jax_step(arch, stage, v, batch, n_mesh, mp, accum=1, dropout=0.0,
             beta=1e-6):
    """JAX's train step in float64 (x64 on, every ``jnp.float32`` of the
    JAX package read as float64, the plain ACTION formulation) on a
    ``(n_mesh / mp, mp)`` mesh from the f32 variables ``v`` cast to
    float64: the state's trees after the step (torch keys) and the
    metrics."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp64, \
            tiny_resnet(), fixed_dropout():
        for name, mod in list(sys.modules.items()):
            if name.startswith("ehgr_tpu.") and \
                    getattr(mod, "jnp", None) is jnp:
                mp64.setattr(mod, "jnp", _Float64Names())
        model = j_variant(arch, num_class=CLS, num_segments=T,
                          partial_bn=False, dropout=dropout,
                          action_fused="none", dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        tx, _ = j_build_optimizer(v64["params"], JOptimConfig(lr=R.LR),
                                  steps_per_epoch=1)
        step = j_make_train_step(
            model, tx, stage=stage,
            loss_cfg=JLossConfig(depth_size=DEPTH, beta=beta),
            ema_decay=R.EMA, mean=R.MEAN, std=R.STD, donate=False,
            accum_steps=accum)
        mesh = jmesh.make_mesh(n_mesh, model_parallel=mp)
        state = _place(j_create_state(v64, tx), mesh, mp > 1)
        new, metrics = jax.device_get(step(state, jmesh.shard_batch(
            {k: jnp.asarray(a) for k, a in batch.items()}, mesh),
            jax.random.key(0)))
    trees = {"params": _torch_tree(new.params),
             "batch_stats": _torch_tree(new.batch_stats, "batch_stats"),
             "momentum": _torch_tree(new.opt_state.momentum)}
    return dict(trees=trees,
                metrics={k: float(np.mean(a)) for k, a in metrics.items()})


@pytest.fixture(scope="module")
def inits():
    """The f32 initial variables of the three models (JAX init keys 0-2)."""
    return {arch: _init(arch, seed)[1] for seed, arch in
            enumerate(("tsn", "tsn_mtmm_sd", "tsn_sd"))}


def _flat0(v):
    return _flat(v["params"], "params") | _flat(v["batch_stats"],
                                                "batch_stats")


@pytest.fixture(scope="module", autouse=True)
def port_runs(inits, tmp_path_factory):
    """Both port topologies, run in a background thread from the module's
    start, while the JAX references compile: (data=2, model=2) first (the
    joint step, the SD accumulation step, whose state it saves and
    reloads, and the TP scorer), then (data=4, model=1) (the DP step, the
    eval counts, the DP scorer and the (2, 2) file restored)."""
    path = tmp_path_factory.mktemp("mesh") / "sd_2x2.pth"
    x = np.random.default_rng(5).normal(size=(2, T, HW, HW, 3)).astype(
        np.float32)
    flat = {arch: _flat0(v) for arch, v in inits.items()}
    kw = dict(device="cpu", threads=1, timeout=GROUP_S, deadline=JOIN_S)

    def run():
        r22 = pmesh.run_ranks(
            R.joint_rank, 4, 2, **kw,
            args=(flat["tsn_mtmm_sd"], flat["tsn_sd"], flat["tsn"],
                  JOINT_BATCH, MASK, HINT_BETA, SD_BATCH, FRAMES,
                  str(path)))
        r41 = pmesh.run_ranks(
            R.dp_rank, 4, 1, **kw,
            args=(flat["tsn"], DP_BATCH, FRAMES, str(path), x))
        return dict(r22=r22, r41=r41, x=x, path=str(path))

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run)
    path.unlink(missing_ok=True)


@pytest.fixture(scope="module")
def ranks22(port_runs):
    return port_runs.result()["r22"]


@pytest.fixture(scope="module")
def ranks41(port_runs):
    return port_runs.result()["r41"]


@pytest.fixture(scope="module", autouse=True)
def jax_refs(inits, port_runs):
    """JAX's float64 steps and its scorer, computed at the module's start
    while the port's ranks run (``port_runs``, started first)."""
    with tiny_resnet():
        model = j_variant("tsn", num_class=CLS, num_segments=T,
                          partial_bn=False, action_fused="vjp")
        probs = np.asarray(j_make_sharded_score_fn(
            model, inits["tsn"], jmesh.make_mesh(4, model_parallel=2),
            model_parallel=True, scale_size=HW, crop_size=HW,
            dtype_name="float32")(FRAMES))
    return dict(
        probs=probs,
        dp=jax_step("tsn", "baseline", inits["tsn"], DP_BATCH, 4, 1),
        # JAX's one-device step: its (data=2, model=2) step on the CPU mesh
        # doubles the gradient of every depthwise conv weight (see the
        # module docstring), so the one-device step, which the sharded step
        # is meant to equal, is the reference here
        joint=jax_step("tsn_mtmm_sd", "mtmm_sd", inits["tsn_mtmm_sd"],
                       JOINT_BATCH, 1, 1, dropout=1.0 - KEEP,
                       beta=HINT_BETA),
        sd=jax_step("tsn_sd", "sd", inits["tsn_sd"], SD_BATCH, 4, 2,
                    accum=2))


def _assemble(outs, mp, head_shards=()):
    """Rank (0, 0)'s trees with each head shard replaced by the model
    ranks' rows, concatenated."""
    trees = {n: dict(t) for n, t in outs[0]["trees"].items()}
    for name, t in trees.items():
        for k in t:
            if k in head_shards:
                t[k] = np.concatenate([outs[m]["trees"][name][k]
                                       for m in range(mp)])
    return trees


def _same_per_model_index(outs, mp):
    for r, o in enumerate(outs):
        assert o["digest"] == outs[r % mp]["digest"], r


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _grad_errors(mom, want):
    """Per-leaf error of the momentum ``mom`` against ``want``; the biases
    whose exact gradient is zero (a conv bias into a training BN: tiny
    against their weight's) are held within ZERO_GRAD_REL of their
    weight's largest value instead."""
    zero = [k for k in want if k.endswith(".bias")
            and k[:-4] + "weight" in want and np.abs(want[k]).max() <
            1e-4 * np.abs(want[k[:-4] + "weight"]).max()]
    for k in zero:
        w = np.abs(want[k[:-4] + "weight"]).max()
        assert np.abs(mom[k]).max() <= ZERO_GRAD_REL * w, k
    return {k: _rel(mom[k], a) for k, a in want.items() if k not in zero}


def _hold_step(outs, mp, jax_ref, shards=()):
    """The float64 step against JAX's: the loss, every parameter and the
    stem BN's running statistics (JAX's own sharded-step limits), every
    leaf's momentum within GRAD64; the fp32 'vjp' step against the float64
    one by ``F32_GATE``.  Returns the float64 momentum errors."""
    _same_per_model_index([o["f64"] for o in outs], mp)
    _same_per_model_index([o["f32"] for o in outs], mp)
    got = _assemble([o["f64"] for o in outs], mp, shards)
    want = jax_ref["trees"]
    np.testing.assert_allclose(float(outs[0]["f64"]["metrics"]["loss"]),
                               jax_ref["metrics"]["loss"], rtol=LOSS_RTOL)
    for k, a in want["params"].items():
        np.testing.assert_allclose(got["params"][k], a, err_msg=k,
                                   **PARAM_TOL)
    for k in ("base_model.bn1.running_mean", "base_model.bn1.running_var"):
        np.testing.assert_allclose(got["batch_stats"][k],
                                   want["batch_stats"][k], err_msg=k,
                                   **STAT_TOL)
    errs = _grad_errors(got["momentum"], want["momentum"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD64, (worst, errs[worst])
    f32 = _assemble([o["f32"] for o in outs], mp, shards)
    e = sorted(_grad_errors(f32["momentum"], got["momentum"]).values())
    stats = {"median": e[len(e) // 2], "p95": e[int(0.95 * len(e))],
             "worst": e[-1]}
    for q, lim in F32_GATE.items():
        assert stats[q] <= lim, (q, stats)
    return errs


def test_layout_and_param_shardings():
    """Rank -> (data, model) as JAX's device grid; the sharded key set as
    JAX's for the joint model at 16 classes, and none at 17 (the odd-class
    fallback) or without model_parallel."""
    for world, mp in ((8, 2), (4, 2), (4, 1), (8, 4)):
        jm = jmesh.make_mesh(world, model_parallel=mp)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        np.testing.assert_array_equal(pmesh.layout(world, mp), ids)
    for cls, mp_flag in ((16, True), (17, True), (16, False)):
        model = j_variant("tsn_mtmm_sd", num_class=cls, num_segments=T)
        with tiny_resnet():
            shapes = jax.eval_shape(lambda r: model.init(
                r, jnp.zeros((1, T, HW, HW, 3)), train=False),
                {"params": jax.random.key(0)})["params"]
        shard = jmesh.param_shardings(shapes, jmesh.make_mesh(4, 2),
                                      model_parallel=mp_flag)
        want = {torch_key(p) for p, s in flatten_dict(shard).items()
                if jmesh.MODEL_AXIS in s.spec}
        params = {torch_key(p): convert_tensor(np.zeros(s.shape, np.float32),
                                               torch_key(p))
                  for p, s in flatten_dict(shapes).items()}
        got = pmesh.param_shardings(
            params, pmesh.Mesh(shape={"data": 2, "model": 2}, device="cpu"),
            model_parallel=mp_flag)
        assert set(got) == want, (cls, mp_flag)
        assert bool(want) == (cls == 16 and mp_flag)


def test_dp_step_matches_jax(ranks41, jax_refs):
    _hold_step(ranks41, 1, jax_refs["dp"])
    # the eval step's counts are the global batch's on every rank
    for o in ranks41:
        assert {k: int(v) for k, v in o["eval"].items()} == {
            k: int(sum(s["eval_own_rows"][k] for s in ranks41))
            for k in o["eval"]}
    assert int(ranks41[0]["eval"]["n"]) == len(DP_BATCH["label"])


def test_joint_step_matches_jax(ranks22, jax_refs):
    jax_joint = jax_refs["joint"]
    outs = [o["joint"] for o in ranks22]
    shards = ranks22[0]["head_shards"]
    assert sorted(shards) == sorted(
        f"{h}.{leaf}" for h in pmesh.HEAD_NAMES for leaf in ("weight",
                                                             "bias"))
    _hold_step(outs, 2, jax_joint, shards)
    # the hint is a real part of the loss (see HINT_BETA)
    assert jax_joint["metrics"]["feat"] * HINT_BETA > 1.0


def test_sd_accum_step_matches_jax(ranks22, jax_refs):
    _hold_step([o["sd"] for o in ranks22], 2, jax_refs["sd"],
               ranks22[0]["head_shards"])


@pytest.mark.parametrize("tp", [False, True])
def test_sharded_scorer_matches_jax(ranks41, ranks22, jax_refs, tp):
    outs = ranks22 if tp else ranks41
    for o in outs:
        np.testing.assert_allclose(o["probs"], jax_refs["probs"], rtol=2e-5,
                                   atol=1e-6)
        assert "divide" in o["divide_error"]


def test_checkpoint_restores_across_topologies(ranks22, ranks41,
                                               port_runs):
    """The (2, 2) file (the fp32 SD state): on one process bitwise the
    mesh's state (head shards joined), on (4, 1) bitwise the one-process
    restore with equal eval logits, and back on (2, 2) bitwise."""
    x, path = port_runs.result()["x"], port_runs.result()["path"]
    sd_outs = [o["sd"]["f32"] for o in ranks22]
    want = _assemble(sd_outs, 2, ranks22[0]["head_shards"])
    with one_thread(), tiny_resnet():
        model = variant("tsn_sd", num_class=CLS, num_segments=T,
                        partial_bn=False, dropout=0.0, action_fused="vjp",
                        device="cpu")
        opt, _ = build_optimizer(model, OptimConfig(lr=R.LR),
                                 steps_per_epoch=1)
        state = create_train_state(model, opt)
        load_train_state(path, state)
        one = R.trees(state)
        for name, t in want.items():
            for k, a in t.items():
                np.testing.assert_array_equal(one[name][k].detach().numpy(),
                                              a, err_msg=f"{name} {k}")
        assert state.step == sd_outs[0]["step"] == 1
        digest = R.digest(one)
        model.eval()
        with torch.no_grad():
            logits = model(torch.as_tensor(x))[0].numpy()
    for o in ranks41:
        assert o["restore"]["digest"] == digest
        assert o["restore"]["step"] == 1
        np.testing.assert_allclose(o["restore"]["logits"], logits,
                                   rtol=1e-5, atol=1e-6)
    assert all(o["sd_reload_bitwise"] for o in ranks22)


def test_failed_rank_ends_the_run():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        pmesh.run_ranks(R.failing_rank, 2, device="cpu", threads=1,
                        timeout=30.0, deadline=60.0)
    assert time.monotonic() - t0 < 60.0


def test_nccl_needs_a_card_a_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one card a rank"):
        pmesh.run_ranks(R.failing_rank, 2, backend="nccl", device="cuda")
    with pytest.raises(ValueError, match="CUDA devices only"):
        pmesh.run_ranks(R.failing_rank, 1, backend="nccl", device="cpu")


def test_mesh_defaults_to_the_ranks_card(monkeypatch):
    """Without a device a mesh (and ``make_mesh``) takes the rank's card,
    ``cuda:{rank % device_count}``, and raises where CUDA is missing: the
    CPU only when the caller names it."""
    shape = {"data": 2, "model": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmesh.Mesh(shape=shape, rank=3)
        torch.distributed.init_process_group(
            "gloo", init_method=f"tcp://localhost:{pmesh._free_port()}",
            world_size=1, rank=0)
        try:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                pmesh.make_mesh()
            assert pmesh.make_mesh(device="cpu").device == torch.device("cpu")
        finally:
            torch.distributed.destroy_process_group()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pmesh.Mesh(shape=shape, rank=3).device == torch.device("cuda", 1)
    assert pmesh.Mesh(shape=shape, rank=2, device="cpu").device == \
        torch.device("cpu")
