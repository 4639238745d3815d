"""The training slice on the CPU, stage ``baseline`` (arch ``tsn``): K=3
steps of the port's ``make_train_step`` against the JAX ``make_train_step``
from converted weights and the same uint8 batches, with ``accum_steps`` 1
and 2 and the port in modes ``'vjp'`` (the kernel region) and ``None``
(plain autograd), against JAX's default ``'vjp'``.  Compared: the loss and
its parts at each step, and after K steps the parameter deltas, the BN
statistics, the EMA and the momentum.  Plus the eval step, the step's
guards and partial BN.

Geometry N=2 clips a microbatch (4 a batch with accum_steps 2), T=4, 32^2,
5 classes, dropout 0 (the two frameworks draw other random bits), the
recipe's lr 0.00125 with lr steps (1,) so the third step is decayed.  The
ResNet-50 is cut to one bottleneck a stage on both sides (its widths stay)
so a JAX compile stays short.  fp32; each tensor
within TOL of its max |JAX value| (gradients through training BN are
differences of large sums, and three steps carry them on), plus, for the
parameter and EMA deltas, ULPS f32 roundings of the parameter they move (a
delta of a few roundings is resolved only to one).

Each trajectory runs once per configuration and module (``jax_result``,
``port_result``; the JAX step compiles once), and a one-step check reads
the first step of the K-step run over the same batches."""

import contextlib
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from ehgr_tpu.configs import LossConfig as JLossConfig
from ehgr_tpu.configs import OptimConfig as JOptimConfig
from ehgr_tpu.models import resnet as j_resnet
from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu.ops.preprocess_device import normalize_clip as j_normalize
from ehgr_tpu.train.optim import build_optimizer as j_build_optimizer
from ehgr_tpu.train.steps import create_train_state as j_create_state
from ehgr_tpu.train.steps import make_eval_step as j_make_eval_step
from ehgr_tpu.train.steps import make_train_step as j_make_train_step
from ehgr_tpu_torch.configs import LossConfig, OptimConfig
from ehgr_tpu_torch.models import resnet as t_resnet
from ehgr_tpu_torch.models.convert import (load_jax_variables,
                                           state_dict_from_jax)
from ehgr_tpu_torch.models.tsn import variant
from ehgr_tpu_torch.train.optim import build_optimizer
from ehgr_tpu_torch.train.steps import (create_train_state, make_eval_step,
                                        make_train_step)

CLS, T, HW, N, K, DEPTH = 5, 4, 32, 2, 3, 8
# the stages whose batches carry depth (and whose steps report its loss)
DEPTH_STAGES = ("mtmm", "mtmm_sd")
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LR, LR_STEPS, EMA = 0.00125, (1,), 0.9
TOL, ULPS = 1e-3, 4
# the momentum after K steps is mostly the last step's gradient: after two
# steps of ~1e-5 drift an input of a small ReLU branch (the CE conv over T
# at 2x2) can cross its kink and move that tensor's gradient by up to ~2%
# (measured 0.9-1.9%); the first step's gradients agree within 1e-4
# (test_first_step_gradients)
MOMENTUM_TOL = 3e-2
# accum_steps=2 in 'vjp' on one torch thread: the second step puts one
# element of layer4.0's block output on the other side of its ReLU from a
# float64 run (test_accum_vjp_gap_is_a_relu_kink); that element's gradient
# reaches every backbone leaf, measured up to 10.9x TOL on the parameter
# and EMA deltas (layer4.0.bn3.bias), so those deltas of the backbone are
# held to KINK_TOL in that case, new_fc's and every other tree to TOL
KINK_TOL = 3e-2
BACKBONE = ("base_model.",)
# a conv bias that feeds a BN in training has an exact gradient of zero:
# both runs move it by rounding noise alone (~1e-7 of its weight's delta),
# so it is held to this share of its weight's largest JAX value instead
ZERO_GRAD_REL = 1e-5


@contextlib.contextmanager
def tiny_resnet():
    """ResNet-50 widths with one bottleneck a stage, in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(j_resnet.STAGE_SIZES, "resnet50", (1, 1, 1, 1))
        mp.setitem(t_resnet.STAGE_SIZES, "resnet50", (1, 1, 1, 1))
        yield


def make_batches(seed, with_depth, count=K, n=N):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        b = {"rgb": rng.integers(0, 256, (n, T, HW, HW, 3), dtype=np.uint8),
             "label": rng.integers(0, CLS, (n,))}
        if with_depth:
            b["depth"] = rng.integers(0, 256, (n, T, HW, HW, 1),
                                      dtype=np.uint8)
        out.append(b)
    return out


def _flat(tree, collection):
    return {(collection,) + p: np.asarray(a)
            for p, a in flatten_dict(jax.device_get(tree)).items()}


def jax_setup(arch, stage, accum):
    """The JAX model, its initial variables and train state and the jitted
    train step of one configuration (the step compiles at its first call;
    later calls at the same shapes reuse it)."""
    with tiny_resnet():
        model = j_variant(arch, num_class=CLS, num_segments=T,
                          partial_bn=False, dropout=0.0, action_fused="vjp")
        v = jax.jit(lambda r: model.init(
            {"params": r}, jnp.zeros((N, T, HW, HW, 3)), train=False))(
                jax.random.key(42))
        tx, _ = j_build_optimizer(
            v["params"], JOptimConfig(lr=LR, lr_steps=LR_STEPS),
            steps_per_epoch=1)
        step = j_make_train_step(
            model, tx, stage=stage, loss_cfg=JLossConfig(depth_size=DEPTH),
            ema_decay=EMA, mean=MEAN, std=STD, donate=False,
            accum_steps=accum)
    return dict(model=model, v=v, state=j_create_state(v, tx), step=step)


def _final(state):
    return dict(params=_flat(state.params, "params"),
                batch_stats=_flat(state.batch_stats, "batch_stats"),
                ema_params=_flat(state.ema_params, "params"),
                ema_batch_stats=_flat(state.ema_batch_stats, "batch_stats"),
                momentum=_flat(state.opt_state.momentum, "params"))


def jax_run(arch, stage, accum, batches, setup=None):
    """The JAX trajectory over ``batches`` from the initial variables of
    ``setup`` (``jax_setup``'s, built here if not given): those variables
    (flat), the metrics of each step, the last state's trees (flat), the
    trees after each step, and the last state."""
    s = setup or jax_setup(arch, stage, accum)
    state, metrics, finals = s["state"], [], []
    with tiny_resnet():
        for b in batches:
            state, m = s["step"](state, {k: jnp.asarray(a)
                                         for k, a in b.items()},
                                 jax.random.key(0))
            metrics.append({k: float(a) for k, a in m.items()})
            finals.append(_final(state))
    v = s["v"]
    return _flat(v["params"], "params") | _flat(v["batch_stats"],
                                                "batch_stats"), \
        metrics, finals[-1], finals, state


def jax_evals(arch, stage, accum):
    """The JAX eval counts (live and EMA weights) after the K steps of
    ``jax_result``, on the last batch."""
    jax_result(arch, stage, accum)
    setup, run = _JAX[(arch, stage, accum)]
    batch = make_batches(0, stage in DEPTH_STAGES, n=N * accum)[K - 1]
    with tiny_resnet():
        return {use_ema: {k: int(a) for k, a in j_make_eval_step(
            setup["model"], mean=MEAN, std=STD, use_ema=use_ema)(
                run[4], {k: jnp.asarray(a) for k, a in batch.items()}
            ).items()} for use_ema in (False, True)}


def port_run(arch, stage, accum, mode, flat0, batches,
             dtype=torch.float32, snapshots=None, on_model=None):
    """The port's trajectory over ``batches`` from ``flat0``: (model, last
    state, metrics of each step); ``snapshots``, a list, also gets a copy
    of the state after each step; ``on_model`` is called with the model
    before the first step."""
    with tiny_resnet():
        model = variant(arch, num_class=CLS, num_segments=T,
                        partial_bn=False, dropout=0.0, action_fused=mode,
                        dtype=dtype, device="cpu")
    if on_model is not None:
        on_model(model)
    load_jax_variables(model, flat0)
    model.to(dtype)
    opt, _ = build_optimizer(model, OptimConfig(lr=LR, lr_steps=LR_STEPS),
                             steps_per_epoch=1)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, stage=stage,
                           loss_cfg=LossConfig(depth_size=DEPTH),
                           ema_decay=EMA, mean=MEAN, std=STD,
                           accum_steps=accum)
    metrics = []
    for b in batches:
        state, m = step(state, b, torch.Generator().manual_seed(0))
        metrics.append({k: float(a) for k, a in m.items()})
        if snapshots is not None:
            snapshots.append(copy.deepcopy(state))
    return model, state, metrics


def _excess(got, want, ref, tol):
    """max |got - want| over its limit: ``tol`` of max |want|, plus ULPS f32
    roundings of max |ref| (the parameter a delta moves)."""
    lim = tol * np.abs(want).max()
    if ref is not None:
        lim += ULPS * np.finfo(np.float32).eps * np.abs(ref).max()
    return np.abs(got - want).max() / max(lim, 1e-30)


def check_trajectory(jax_result, port_result, stage, tol=TOL,
                     momentum_tol=None, loose=((), None), loose_in=None,
                     zero_grad=()):
    """Losses within 1e-4 at each step; every leaf of the final state within
    ``tol`` (the momentum within ``momentum_tol`` where given), except the
    leaves whose key starts with one of ``loose[0]``, held to ``loose[1]``
    (in the trees named by ``loose_in`` only, where given), and the conv
    biases of ``zero_grad`` (each feeding a BN in training), held in both
    runs within ZERO_GRAD_REL of their weight's max |JAX value| in each
    tree."""
    flat0, j_metrics, final = jax_result[:3]
    _, state, metrics = port_result
    keys = ("loss", "ce") + (("depth",) if stage in DEPTH_STAGES else ())
    for i, (got, want) in enumerate(zip(metrics, j_metrics)):
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=f"step {i} {k}")

    def torch_layout(flat):
        return {k: t.numpy() for k, t in state_dict_from_jax(flat).items()}

    p0 = torch_layout(flat0)
    want = {
        "param delta": torch_layout(
            {p: a - flat0[p] for p, a in final["params"].items()}),
        "ema delta": torch_layout(
            {p: a - flat0[p] for p, a in final["ema_params"].items()}),
        "momentum": torch_layout(final["momentum"]),
        "batch stats": torch_layout(final["batch_stats"]),
        "ema batch stats": torch_layout(final["ema_batch_stats"])}
    got = {
        "param delta": {k: v.detach().numpy() - p0[k]
                        for k, v in state.params.items()},
        "ema delta": {k: v.numpy() - p0[k]
                      for k, v in state.ema_params.items()},
        "momentum": {k: v.numpy()
                     for k, v in state.opt_state.momentum.items()},
        "batch stats": {k: v.detach().numpy()
                        for k, v in state.batch_stats.items()},
        "ema batch stats": {k: v.numpy()
                            for k, v in state.ema_batch_stats.items()}}
    for what, w in want.items():
        assert sorted(got[what]) == sorted(w), what
        ref = p0 if "delta" in what else {}
        lim = momentum_tol if what == "momentum" and momentum_tol else tol
        in_scope = loose_in is None or what in loose_in
        excess = {k: _excess(got[what][k], w[k], ref.get(k),
                             loose[1] if in_scope and k.startswith(loose[0])
                             else lim)
                  for k in w if k not in zero_grad}
        for k in zero_grad:
            if k in w:
                bound = ZERO_GRAD_REL * np.abs(
                    w[k[:-len("bias")] + "weight"]).max()
                moved = max(np.abs(got[what][k]).max(), np.abs(w[k]).max())
                assert moved <= bound, (what, k, moved, bound)
        worst = max(excess, key=excess.get)
        assert excess[worst] <= 1.0, (what, worst, excess[worst])


_JAX = {}
_PORT = {}


def jax_result(arch, stage, accum, k=K):
    """(initial variables, metrics of the first ``k`` steps, the state's
    trees after step ``k``) of the JAX trajectory, kept per configuration
    and module: a ``k``-step run is the first ``k`` steps of a longer one
    over the same batches, and a longer one reuses the compiled step."""
    key = (arch, stage, accum)
    setup, run = _JAX.get(key, (None, None))
    if run is None or len(run[1]) < k:
        setup = setup or jax_setup(arch, stage, accum)
        run = jax_run(arch, stage, accum, make_batches(
            0, stage in DEPTH_STAGES, n=N * accum)[:k], setup)
        _JAX[key] = setup, run
    flat0, metrics, _, finals, _ = run
    return flat0, metrics[:k], finals[k - 1]


def port_result(arch, stage, accum, mode, k=K):
    """(model, state after step ``k``, metrics of the first ``k`` steps)
    of the port's trajectory from ``jax_result``'s initial variables, kept
    per configuration, mode and module like ``jax_result``'s; where a
    longer run was kept the state is a copy taken after step ``k`` and the
    model holds the last step's weights."""
    key = (arch, stage, accum, mode)
    if key not in _PORT or len(_PORT[key][2]) < k:
        states = []
        _PORT[key] = port_run(arch, stage, accum, mode,
                              jax_result(arch, stage, accum, k)[0],
                              make_batches(0, stage in DEPTH_STAGES,
                                           n=N * accum)[:k],
                              snapshots=states) + (states,)
    model, state, metrics, states = _PORT[key]
    return model, (state if k == len(metrics) else states[k - 1]), \
        metrics[:k]


def jax_setup_of(arch, stage, accum):
    """``jax_setup`` of the configuration ``jax_result`` keeps (its compiled
    step reused)."""
    jax_result(arch, stage, accum, k=1)
    return _JAX[(arch, stage, accum)][0]


@contextlib.contextmanager
def one_thread():
    """torch on one thread.  Over many threads a CPU op spins against the
    other test processes that hold the cores (a float64 run stalls for
    minutes).  Used where no compared result depends on the thread count:
    float64 references (their sums move by ~1e-16 with it, far inside
    every limit they serve) and tests that hold the port against itself.
    Not for the f32 trajectories against JAX: their kinks move with it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def single_thread():
    """``one_thread`` around a test that holds the port against itself."""
    with one_thread():
        yield


class TestBaselineSteps:
    @pytest.mark.parametrize("accum,mode", [(1, "vjp"), (2, "vjp"),
                                            (1, None)])
    def test_k_steps_match_jax(self, accum, mode):
        """With accum 2 in 'vjp' the backbone's parameter and EMA deltas
        are held to KINK_TOL (see its note)."""
        kink = accum == 2 and mode == "vjp"
        check_trajectory(jax_result("tsn", "baseline", accum),
                         port_result("tsn", "baseline", accum, mode),
                         "baseline", momentum_tol=MOMENTUM_TOL,
                         loose=(BACKBONE, KINK_TOL) if kink else ((), None),
                         loose_in=("param delta", "ema delta"))

    def test_accum_vjp_gap_is_a_relu_kink(self):
        """``accum_steps=2``, 'vjp', one torch thread: the second step's
        second microbatch puts element (3, 1708) of layer4.0's block output
        before its ReLU (bn3 + the downsample branch) at +9.8e-6 in a
        float64 run of the port and at -1.9e-6 in the f32 run, inside that
        run's rounding of the tensor (max abs error 5.0e-5); JAX's f32 run
        keeps it positive (+1.0e-5) with a larger max error (1.5e-4).  So
        the two f32 runs take that ReLU on opposite sides, and the port is
        no farther from float64 than JAX.  Each run from its own first
        step."""
        key = ("tsn", "baseline", 2)
        jax_result(*key)
        setup, run = _JAX[key]
        batches = make_batches(0, False, n=N * 2)[:2]

        def pre_relu(dtype, mode):
            """The block output before its ReLU at the second step's second
            microbatch, as the port computes it (bn3 + downsample)."""
            seen = {"bn3": [], "ds": []}

            def hook(model):
                block = model.base_model.layer4[0]
                for name, mod in (("bn3", block.bn3),
                                  ("ds", block.downsample[1])):
                    mod.register_forward_hook(
                        lambda m, i, o, name=name: seen[name].append(
                            o.detach().clone()))
            port_run("tsn", "baseline", 2, mode, run[0], batches,
                     dtype=dtype, on_model=hook)
            return (seen["bn3"][3] + seen["ds"][3]).double().numpy()

        with one_thread():
            f64 = pre_relu(torch.float64, None)
            f32 = pre_relu(torch.float32, "vjp")
        params = unflatten_dict({**run[3][0]["params"],
                                 **run[3][0]["batch_stats"]})
        rgb = batches[1]["rgb"][N:]
        with tiny_resnet():
            _, mut = jax.jit(lambda v, x: setup["model"].apply(
                v, x, train=True, mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda m, _: m.path[-2:] in (
                    ("layer4_0", "bn3"), ("layer4_0", "downsample_bn"))))(
                        params, j_normalize(jnp.asarray(rgb), MEAN, STD,
                                            dtype=jnp.float32))
        b3, ds = (np.asarray(v[0], np.float32) for _, v in sorted(
            flatten_dict(mut["intermediates"]).items()))
        jax32 = (b3 + ds).astype(np.float64).transpose(0, 3, 1, 2)
        port_err, jax_err = np.abs(f32 - f64), np.abs(jax32 - f64)
        flips = np.argwhere((f32 > 0) != (f64 > 0))
        assert [tuple(f) for f in flips] == [(3, 1708, 0, 0)]
        for f in map(tuple, flips):
            assert f64[f] > 0 > f32[f] and jax32[f] > 0
            assert abs(f64[f]) <= min(port_err.max(), jax_err.max())
        assert not ((jax32 > 0) != (f64 > 0)).any()
        assert port_err.max() <= jax_err.max()

    @pytest.mark.parametrize("accum", [1, 2])
    def test_first_step_gradients(self, accum):
        """One step: the momentum is the (accumulated) gradient plus weight
        decay, held to TOL like everything else."""
        check_trajectory(jax_result("tsn", "baseline", accum, k=1),
                         port_result("tsn", "baseline", accum, "vjp", k=1),
                         "baseline")

    @pytest.mark.parametrize("use_ema", [False, True])
    def test_eval_step_matches_jax(self, use_ema):
        model, state, _ = port_result("tsn", "baseline", 1, "vjp")
        ev = make_eval_step(model, mean=MEAN, std=STD, use_ema=use_ema)
        got = {k: int(v) for k, v in ev(
            state, make_batches(0, False)[-1]).items()}
        assert got == jax_evals("tsn", "baseline", 1)[use_ema]


@pytest.mark.usefixtures("single_thread")
class TestStepGuards:
    def _model(self, **kw):
        with tiny_resnet():
            return variant("tsn", num_class=CLS, num_segments=T,
                           partial_bn=False, device="cpu", **kw)

    def test_indivisible_batch_raises(self):
        m = self._model(dropout=0.0)
        opt, _ = build_optimizer(m, OptimConfig())
        step = make_train_step(m, opt, stage="baseline",
                               loss_cfg=LossConfig(), ema_decay=EMA,
                               mean=MEAN, std=STD, accum_steps=3)
        with pytest.raises(ValueError, match="not divisible"):
            step(create_train_state(m, opt), make_batches(0, False)[0])

    @pytest.mark.parametrize("stage,err", [("sd", None), ("mtmm_sd", None),
                                           ("bogus", ValueError)])
    def test_stages_not_ported_raise(self, stage, err):
        """An unknown stage is refused; ``sd`` (tests/test_torch_sd.py) and
        the joint ``mtmm_sd`` (tests/test_torch_joint.py) are ported and
        build their step."""
        m = self._model()
        opt, _ = build_optimizer(m, OptimConfig())
        if err is None:
            assert callable(make_train_step(
                m, opt, stage=stage, loss_cfg=LossConfig(), ema_decay=EMA,
                mean=MEAN, std=STD))
            return
        with pytest.raises(err):
            make_train_step(m, opt, stage=stage, loss_cfg=LossConfig(),
                            ema_decay=EMA, mean=MEAN, std=STD)

    def test_dropout_draws_from_the_generator(self):
        """Dropout needs an explicit generator; the same seed gives the same
        step, another seed another one."""
        batch = make_batches(0, False)[0]
        with pytest.raises(ValueError, match="generator"):
            self._model().train()(torch.zeros(N, T, HW, HW, 3))
        losses = []
        for seed in (1, 1, 2):
            m = self._model(dropout=0.5)
            opt, _ = build_optimizer(m, OptimConfig())
            step = make_train_step(m, opt, stage="baseline",
                                   loss_cfg=LossConfig(), ema_decay=EMA,
                                   mean=MEAN, std=STD)
            state = create_train_state(m, opt)
            for _ in range(2):
                state, mt = step(state, batch,
                                 torch.Generator().manual_seed(seed))
            losses.append(float(mt["loss"]))
        assert losses[0] == losses[1] != losses[2]

    def test_partial_bn_survives_train(self):
        """Under partial BN ``model.train()`` leaves every BN but the stem's
        (the ACTION p3_bn1 included) on running statistics; the decoder's
        BNs train."""
        from ehgr_tpu_torch.models.norm import BatchNorm

        with tiny_resnet():
            m = variant("tsn_mtmm", num_class=CLS, num_segments=T,
                        partial_bn=True, device="cpu").train()
        live = {k for k, mod in m.named_modules()
                if isinstance(mod, BatchNorm) and mod.training}
        assert live == {"base_model.bn1"} | {
            f"global_decoder.{i}" for i in (1, 5, 9, 13)}
        assert not m.base_model.layer1[0].conv1.action_p3_bn1.training
        assert m.training and m.base_model.layer1[0].conv1.training
