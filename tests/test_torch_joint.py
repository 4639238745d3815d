"""The joint MTMM+SD stage and the TSN options on the CPU, against the JAX
package from the same weights and inputs: ``TransposedDecoder`` and
``TextEncoder``; ``tsn_mtmm_sd`` at the golden geometry
(``tests/test_regression.py``: N=2, T=4, 32^2, 5 classes, init key 42; the
ResNet-50 cut to one bottleneck a stage, as everywhere in this file, so a
JAX compile stays short) with ``modal='rgb_depth'`` and with every modal
head, each output (``tests/test_torch_anchors.py`` holds the full-depth
model to ``GOLD_MTMMSD_GDEPTH``); ``temporal_pool`` (forward, and the
gradient through the pool where its windows tie), ``before_softmax=False`` and
``consensus_type='identity'``; ``build_model`` applying ``temporal_pool``
and ``before_softmax`` as the JAX factory does; K=3 ``mtmm_sd`` train steps
and the multi-output eval step; the optimizer's labels of the new leaves;
the warm start from a Stage-1 ``.pth``; and ``cli.train_mtmm_sd`` for one
epoch of two steps.

fp32.  Tolerances: logits rtol = atol = 1e-4 (the convolutions sum in
another order); the exits' logits (~1e-3, from the N(0, 0.001) heads) at
atol 1e-6; features and maps rtol 1e-4 and atol 1e-4 of their max |value|;
probabilities and gradients through the pool the same; the train steps at
the SD limits of ``tests/test_torch_sd_steps.py`` (KINK_TOL, see there);
the pool's own gradient with ties exactly JAX's (an even split of each
window's cotangent over its tied maxima is a division by 1, 2 or 3).

The JAX package's ``temporal_pool`` cannot be traced by ``jax.jit`` (it
slices with the elements of a ``jnp.arange``, tracers under a trace).  So
the JAX models with ``temporal_pool`` run under ``traceable_pool``: its
body with a Python ``range``, shown bitwise equal to it, value and VJP,
where windows tie (``test_temporal_pool_vjp_splits_ties``)."""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from ehgr_tpu.configs import ModelConfig as JModelConfig
from ehgr_tpu.models.decoders import TextEncoder as JTextEncoder
from ehgr_tpu.models.decoders import TransposedDecoder as JTransposedDecoder
from ehgr_tpu.models.factory import build_model as j_build_model
from ehgr_tpu.models.torch_import import export_state_dict
from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu.ops import temporal_shift as j_temporal_shift
from ehgr_tpu.train.checkpoints import load_for_model as j_load_for_model
from ehgr_tpu.train.optim import label_params as j_label_params
from ehgr_tpu.train.steps import TrainState as JTrainState
from ehgr_tpu.train.steps import make_eval_step as j_make_eval_step
from ehgr_tpu_torch.cli import train_mtmm_sd as cli_train_mtmm_sd
from ehgr_tpu_torch.configs import ModelConfig
from ehgr_tpu_torch.models.convert import (load_jax_variables,
                                           state_dict_from_jax, torch_key)
from ehgr_tpu_torch.models.decoders import TextEncoder, TransposedDecoder
from ehgr_tpu_torch.models.factory import build_model
from ehgr_tpu_torch.models.tsn import variant
from ehgr_tpu_torch.ops.action import ActionConv
from ehgr_tpu_torch.ops.temporal_shift import temporal_pool
from ehgr_tpu_torch.train.checkpoints import load_for_model
from ehgr_tpu_torch.train.optim import label_params
from ehgr_tpu_torch.train.steps import make_eval_step

from test_torch_sd_steps import KINK_MOMENTUM_TOL, KINK_TOL, _nested
from test_torch_train import (MEAN, STD, check_trajectory, jax_result,
                              make_batches, one_thread, port_result,
                              port_run, tiny_resnet)
from test_torch_train import single_thread  # noqa: F401  (a fixture)

CLS, T, HW = 5, 4, 32
FULL = "rgb_depth_skeleton_text"
TOL = dict(rtol=1e-4, atol=1e-4)
MID_TOL = dict(rtol=1e-4, atol=1e-6)
OUT_NAMES = ("logits", "mid1", "mid2", "mid3", "final_fea", "f1", "f2", "f3",
             "local_depth", "global_depth", "local_skel", "global_skel",
             "text")
# the modules of the heads that modal 'rgb_depth' does not build
NOT_RGB_DEPTH = ("local_skel_decoder", "global_skel_decoder", "text_encoder")
# the sigmoid maps and their decoders, in output order
MAPS = {"local_depth": "local_decoder", "global_depth": "global_decoder",
        "local_skel": "local_skel_decoder",
        "global_skel": "global_skel_decoder"}
# the transposed convs of modal 'rgb_depth' whose output feeds a BN
BN_FED_BIASES = ("local_decoder.0.bias", "global_decoder.0.bias",
                 "global_decoder.2.bias")


def _x():
    return np.linspace(-1, 1, 2 * T * HW * HW * 3,
                       dtype=np.float32).reshape(2, T, HW, HW, 3)


def _flat(v):
    return {k: np.asarray(a) for k, a in flatten_dict(v).items()}


def _rel_tol(w):
    """rtol 1e-4 and atol 1e-4 of max |w|."""
    return dict(rtol=1e-4, atol=1e-4 * max(float(np.abs(w).max()), 1e-30))


def _module_vars(flat, name, fields):
    """The variables of the one-module tree ``flat`` (as ``init`` of a
    lone module gives them) -> (the port's state_dict of that module, the
    nested JAX variables).  ``fields`` draws each BN leaf off (0, 1)."""
    flat = dict(flat)
    for p in flat:
        if p[-1] in ("mean", "var", "scale", "bias") and p[0] in fields:
            flat[p] = fields[p[0]](flat[p].shape)
    sd = {k[len(name) + 1:]: t for k, t in state_dict_from_jax(
        {(p[0], name) + p[1:]: a for p, a in flat.items()}).items()}
    return sd, unflatten_dict({p: jnp.asarray(a) for p, a in flat.items()})


class TestHeads:
    @pytest.mark.parametrize("train", [False, True])
    @pytest.mark.parametrize("widths,out", [((32,), 1), ((16, 8), 42)])
    def test_transposed_decoder_matches_jax(self, rng, train, widths, out):
        """Output, and in training the BN statistics it leaves, from the
        same weights on ``[4, 3, 3, 24]``: each stage doubles H and W."""
        x = rng.standard_normal((4, 3, 3, 24)).astype(np.float32)
        j = JTransposedDecoder(widths, out)
        v = jax.jit(lambda r: j.init(r, jnp.asarray(x)))(jax.random.key(0))
        uni = lambda s: rng.uniform(0.5, 1.5, s).astype(np.float32)  # noqa
        sd, jv = _module_vars(_flat(v), "global_decoder",
                              {"params": uni, "batch_stats": uni})
        tm = TransposedDecoder(24, widths, out, device="cpu")
        tm.load_state_dict(sd, strict=True)
        with one_thread():
            got = tm.train(train)(torch.from_numpy(x).permute(0, 3, 1, 2))
        if train:
            want, mut = j.apply(jv, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        else:
            want = j.apply(jv, jnp.asarray(x), train=False)
        size = 3 * 2 ** (len(widths) + 1)
        assert got.shape == (4, out, size, size)
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
        if train:
            stats, _ = _module_vars(_flat(mut), "global_decoder", {})
            for k, t in stats.items():
                np.testing.assert_allclose(tm.state_dict()[k].numpy(),
                                           t.numpy(), rtol=1e-5, atol=1e-6,
                                           err_msg=k)

    @pytest.mark.parametrize("train", [False, True])
    def test_text_encoder_matches_jax(self, rng, train):
        """``[N=3, T=4, 48] -> [3, 16]`` from the same weights, and in
        training the BN statistics."""
        x = rng.standard_normal((3, T, 48)).astype(np.float32)
        j = JTextEncoder(features=16)
        v = jax.jit(lambda r: j.init(r, jnp.asarray(x)))(jax.random.key(1))
        uni = lambda s: rng.uniform(0.5, 1.5, s).astype(np.float32)  # noqa
        sd, jv = _module_vars(_flat(v), "text_encoder",
                              {"params": uni, "batch_stats": uni})
        tm = TextEncoder(48, T, 16, device="cpu")
        tm.load_state_dict(sd, strict=True)
        with one_thread():
            got = tm.train(train)(torch.from_numpy(x))
        if train:
            want, mut = j.apply(jv, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
            stats, _ = _module_vars(_flat(mut), "text_encoder", {})
            for k, t in stats.items():
                np.testing.assert_allclose(tm.state_dict()[k].numpy(),
                                           t.numpy(), rtol=1e-5, atol=1e-6,
                                           err_msg=k)
        else:
            want = j.apply(jv, jnp.asarray(x), train=False)
        assert got.shape == (3, 16)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def joint():
    """JAX ``tsn_mtmm_sd`` with every modal head at the golden geometry
    (init key 42): variables, flat variables, its 13 outputs and each
    decoder's last transposed conv output (before the sigmoid)."""
    from flax import linen as fnn

    x = jnp.asarray(_x())
    with tiny_resnet():
        model = j_variant("tsn_mtmm_sd", num_class=CLS, num_segments=T,
                          temporal="action", partial_bn=False, modal=FULL)
        v = jax.jit(lambda r, xx: model.init(r, xx, train=False))(
            {"params": jax.random.key(42)}, x)
        out, inter = jax.jit(lambda vv, xx: model.apply(
            vv, xx, train=False, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(
                mdl, fnn.ConvTranspose)))(v, x)
    inter = inter["intermediates"]
    pre = {dec: np.asarray(inter[dec][max(inter[dec])]["__call__"][0])
           for dec in MAPS.values()}
    return v, _flat(v), [np.asarray(o) for o in out], pre


@pytest.mark.usefixtures("single_thread")
class TestJointForward:
    def test_converter_matches_export_state_dict(self, joint):
        """``torch_key`` on every leaf of the joint surface (the four
        decoders share none of their keys' rules with the prefix alone)
        gives ``export_state_dict``'s keys and tensors, and the port's
        model has exactly those keys."""
        v, flat = joint[:2]
        want = export_state_dict(v)
        got = state_dict_from_jax(flat)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        with tiny_resnet():
            m = variant("tsn_mtmm_sd", num_class=CLS, num_segments=T,
                        modal=FULL, device="cpu")
        assert sorted(m.state_dict()) == sorted(got)
        assert {k.split(".")[0] for k in got} >= {
            "local_decoder", "global_decoder", "local_skel_decoder",
            "global_skel_decoder", "text_encoder"}

    @pytest.mark.parametrize("mode", [None, "mega"])
    @pytest.mark.parametrize("modal", ["rgb_depth", FULL])
    def test_outputs_match_jax(self, joint, modal, mode):
        """Every output of the port's ``tsn_mtmm_sd`` against JAX's, in
        JAX's order: the SD 8-tuple, local and global depth, local and
        global skeleton heatmaps, the text embedding.  ``rgb_depth`` is the
        first ten: its variables are the full surface's less the skeleton
        and text heads (flax draws each module's init from its own path),
        and those heads read the trunk's taps only.  The maps are sigmoids
        of large sums here (layer4 grows at random init), so each
        decoder's last transposed conv is held to rtol 1e-4 and atol 1e-4
        of its max |value|, and its sigmoid to a quarter of that atol (the
        sigmoid's slope is at most 1/4)."""
        _, flat, want, want_pre = joint
        if modal == "rgb_depth":
            flat = {p: a for p, a in flat.items()
                    if p[1] not in NOT_RGB_DEPTH}
            want = want[:10]
        with tiny_resnet():
            m = variant("tsn_mtmm_sd", num_class=CLS, num_segments=T,
                        temporal="action", action_fused=mode,
                        partial_bn=False, modal=modal, device="cpu")
        load_jax_variables(m, flat)
        pre = {}
        for dec in MAPS.values():
            if hasattr(m, dec):
                getattr(m, dec)[-2].register_forward_hook(
                    lambda mod, i, o, dec=dec: pre.__setitem__(
                        dec, o.permute(0, 2, 3, 1).numpy()))
        with torch.no_grad():
            got = [o.numpy() for o in m(torch.from_numpy(_x()))]
        assert [g.shape for g in got] == [w.shape for w in want]
        assert got[9].shape == (2 * T, 8, 8, 1) and got[8].shape == (
            2 * T, HW, HW, 1)
        for name, g, w in zip(OUT_NAMES, got, want):
            if name == "logits":
                tol = TOL
            elif name.startswith("mid"):
                tol = MID_TOL
            elif name in MAPS:
                z = want_pre[MAPS[name]]
                np.testing.assert_allclose(pre[MAPS[name]], z,
                                           err_msg=MAPS[name],
                                           **_rel_tol(z))
                tol = dict(rtol=1e-4, atol=0.25 * _rel_tol(z)["atol"])
            else:
                tol = _rel_tol(w)
            np.testing.assert_allclose(g, w, err_msg=name, **tol)


@pytest.fixture(scope="module")
def tiny_tsn():
    """The variables of JAX ``tsn_mtmm`` on the one-bottleneck ResNet-50
    (key 7), flat; ``tsn``'s are its subset, and the TSN options add
    none."""
    with tiny_resnet():
        model = j_variant("tsn_mtmm", num_class=CLS, num_segments=T,
                          temporal="action", partial_bn=False)
        v = jax.jit(lambda r: model.init(
            r, jnp.zeros((2, T, HW, HW, 3)), train=False))(
                {"params": jax.random.key(7)})
    return _flat(v)


def _tiny_pair(flat, arch, **opts):
    """JAX ``arch`` with the TSN options ``opts`` and the port's twin
    (plain formulation) holding ``flat``'s variables of that surface."""
    with tiny_resnet():
        jm = dataclasses.replace(j_variant(
            arch, num_class=CLS, num_segments=T, temporal="action",
            partial_bn=False), **opts)
        pm = variant(arch, num_class=CLS, num_segments=T, temporal="action",
                     partial_bn=False, device="cpu", **opts)
    flat = {p: a for p, a in flat.items()
            if arch == "tsn_mtmm" or p[1] != "global_decoder"}
    load_jax_variables(pm, flat)
    return jm, unflatten_dict({p: jnp.asarray(a) for p, a in flat.items()}), pm


def _pool_twin(x):
    """``ehgr_tpu.ops.temporal_shift.temporal_pool`` with its window starts
    from a Python ``range`` instead of a ``jnp.arange``, so that it
    traces."""
    t = x.shape[1]
    pad = jnp.full_like(x[:, :1], -jnp.inf)
    xp = jnp.concatenate([pad, x, pad], axis=1)
    windows = jnp.stack([xp[:, s:s + 3] for s in range(0, t, 2)], axis=1)
    return jnp.max(windows, axis=2)


@contextlib.contextmanager
def traceable_pool():
    """The JAX models' ``temporal_pool`` (looked up at the call) is
    ``_pool_twin`` inside the block."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_temporal_shift, "temporal_pool", _pool_twin)
        yield


def _window_ties(x5):
    """Windows of ``temporal_pool`` (kernel 3, stride 2, pad 1 over dim 1
    of ``x5``) whose max is taken by more than one frame."""
    x = torch.as_tensor(x5)
    pad = torch.full_like(x[:, :1], float("-inf"))
    xp = torch.cat([pad, x, pad], 1)
    w = torch.stack([xp[:, s:s + 3] for s in range(0, x.shape[1], 2)], 1)
    return int(((w == w.amax(2, keepdim=True)).sum(2) > 1).sum())


@pytest.mark.usefixtures("single_thread")
class TestTsnOptions:
    def test_temporal_pool_vjp_splits_ties(self, rng):
        """The pool's gradient where windows tie: the cotangent of each
        window is split evenly over its tied maxima (``jnp.max``'s rule,
        and ``torch.amax``'s), and frames 1, 3, ... sit in two windows, so
        theirs add; exactly JAX's.  Values from {0, 1, 2} tie often.  The
        traceable twin of the JAX pool gives JAX's value and VJP bitwise,
        eagerly and jitted."""
        x = rng.integers(0, 3, (2, 6, 3, 3, 5)).astype(np.float32)
        cot = rng.standard_normal((2, 3, 3, 3, 5)).astype(np.float32)
        assert _window_ties(x) > 20
        y, vjp = jax.vjp(j_temporal_shift.temporal_pool, jnp.asarray(x))
        want = np.asarray(vjp(jnp.asarray(cot))[0])
        xt = torch.from_numpy(x).requires_grad_()
        yt = temporal_pool(xt)
        (yt * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
        np.testing.assert_array_equal(xt.grad.numpy(), want)
        for twin in (_pool_twin, jax.jit(_pool_twin)):
            y2, vjp2 = jax.vjp(twin, jnp.asarray(x))
            np.testing.assert_array_equal(np.asarray(y2), np.asarray(y))
            np.testing.assert_array_equal(
                np.asarray(vjp2(jnp.asarray(cot))[0]), want)

    def test_temporal_pool_model_matches_jax(self, tiny_tsn):
        """``tsn_mtmm`` with ``temporal_pool``: the ACTION sites of stages
        3-4 built for T/2 frames; logits, the depth map at T/2 frames a
        clip and the gradient of every parameter (eval, a fixed linear
        functional of both outputs) against JAX's.  The layer2 tap holds
        windows whose max ties (zeros after the ReLU), so the gradient
        passes through the split of ``test_temporal_pool_vjp_splits_ties``."""
        jm, jv, pm = _tiny_pair(tiny_tsn, "tsn_mtmm", temporal_pool=True)
        segs = [b.conv1.n_segment for i in range(1, 5)
                for b in getattr(pm.base_model, f"layer{i}")
                if isinstance(b.conv1, ActionConv)]
        assert segs == [T, T, T // 2, T // 2]
        x = _x()
        rng = np.random.default_rng(5)
        c_logits = rng.standard_normal((2, CLS)).astype(np.float32)
        c_depth = rng.standard_normal((T, 8, 8, 1)).astype(np.float32)

        def j_loss(params):
            lg, depth = jm.apply({**jv, "params": params}, jnp.asarray(x),
                                 train=False)
            return jnp.sum(lg * c_logits) + jnp.sum(depth * c_depth), \
                (lg, depth)

        with tiny_resnet(), traceable_pool():
            (_, (j_lg, j_depth)), j_grads = jax.jit(jax.value_and_grad(
                j_loss, has_aux=True))(jv["params"])
        pm.eval()
        taps = {}
        pm.base_model.layer2.register_forward_hook(
            lambda mod, i, o: taps.__setitem__("layer2", o.detach()))
        lg, depth = pm(torch.from_numpy(x))
        ((lg * torch.from_numpy(c_logits)).sum() +
         (depth * torch.from_numpy(c_depth)).sum()).backward()
        assert depth.shape == (T, 8, 8, 1)
        l2 = taps["layer2"].permute(0, 2, 3, 1).reshape(
            (2, T) + tuple(taps["layer2"].permute(0, 2, 3, 1).shape[1:]))
        assert _window_ties(l2) > 0
        np.testing.assert_allclose(lg.detach().numpy(), np.asarray(j_lg),
                                   **TOL)
        np.testing.assert_allclose(depth.detach().numpy(),
                                   np.asarray(j_depth), **_rel_tol(j_depth))
        want = {k: t.numpy() for k, t in state_dict_from_jax(
            {("params",) + p: np.asarray(a)
             for p, a in flatten_dict(j_grads).items()}).items()}
        for k, p in pm.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[k], err_msg=k,
                                       **_rel_tol(want[k]))

    @pytest.mark.parametrize("consensus_type,before_softmax,tpool", [
        ("avg", False, False), ("identity", True, False),
        ("identity", False, True)])
    def test_options_match_jax(self, tiny_tsn, consensus_type,
                               before_softmax, tpool):
        """``tsn`` with ``consensus_type``, ``before_softmax`` and
        ``temporal_pool``: without ``before_softmax`` the frames'
        probabilities (softmax in the compute dtype, before the
        consensus), with ``identity`` ``[N, T, classes]`` (T/2 under the
        pool)."""
        jm, jv, pm = _tiny_pair(tiny_tsn, "tsn",
                                consensus_type=consensus_type,
                                before_softmax=before_softmax,
                                temporal_pool=tpool)
        with tiny_resnet(), traceable_pool():
            want = np.asarray(jax.jit(lambda vv, xx: jm.apply(
                vv, xx, train=False))(jv, jnp.asarray(_x())))
        with torch.no_grad():
            got = pm(torch.from_numpy(_x())).numpy()
        seg = T // 2 if tpool else T
        assert got.shape == want.shape == (
            (2, seg, CLS) if consensus_type == "identity" else (2, CLS))
        if not before_softmax:
            np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("opts", [dict(temporal_pool=True),
                                      dict(before_softmax=False)])
    def test_build_model_applies_the_options(self, tiny_tsn, opts):
        """``build_model`` of one ``ModelConfig`` in both packages gives
        the same model: ``temporal_pool`` and ``before_softmax`` reach it
        (``consensus_type`` reaches neither: the JAX factory does not pass
        it)."""
        kw = dict(arch="tsn_mtmm", num_segments=T, num_classes=CLS,
                  dtype="float32", **opts)
        with tiny_resnet(), traceable_pool():
            jm = j_build_model(JModelConfig(**kw))
            pm = build_model(ModelConfig(**kw), device="cpu")
            want = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(
                unflatten_dict({p: jnp.asarray(a)
                                for p, a in tiny_tsn.items()}),
                jnp.asarray(_x()))
        load_jax_variables(pm, tiny_tsn)
        with torch.no_grad():
            got = pm(torch.from_numpy(_x()))
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       **_rel_tol(np.asarray(w)))


class TestJointSteps:
    def test_k_steps_match_jax(self):
        """K=3 ``mtmm_sd`` steps of ``tsn_mtmm_sd`` (``modal='rgb_depth'``,
        the port in 'vjp') from the same weights and batches (rgb and the
        current depth): losses at each step within 1e-4, their SD parts
        too; after three steps the deltas within KINK_TOL and the momentum
        within KINK_MOMENTUM_TOL, the SD steps' limits (the exits are as
        ill-conditioned here).  The transposed convs' biases that feed a
        BN in training move by rounding alone (measured ~1e-14 against
        ~1e-7 for their weights, in both runs): ``check_trajectory`` holds
        them near zero instead (``zero_grad``)."""
        res = jax_result("tsn_mtmm_sd", "mtmm_sd", 1)
        port = port_result("tsn_mtmm_sd", "mtmm_sd", 1, "vjp")
        check_trajectory(res, port, "mtmm_sd", tol=KINK_TOL,
                         momentum_tol=KINK_MOMENTUM_TOL,
                         zero_grad=BN_FED_BIASES)
        for i, (got, want) in enumerate(zip(port[2], res[1])):
            for key in ("mid_ce", "kd", "feat", "depth"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                           err_msg=f"step {i} {key}")

    def test_eval_step_multi_output_matches_jax(self):
        """``make_eval_step(multi_output=True)`` on the joint surface: the
        final head's and the three exits' top-1/5 hits, live and EMA
        weights, after one step."""
        res = jax_result("tsn_mtmm_sd", "mtmm_sd", 1, k=1)
        batch = make_batches(0, True)[0]
        model, state, _ = port_run("tsn_mtmm_sd", "mtmm_sd", 1, "vjp",
                                   res[0], [batch])
        jstate = JTrainState(
            step=0, params=_nested(res[2]["params"]),
            batch_stats=_nested(res[2]["batch_stats"]), opt_state=None,
            ema_params=_nested(res[2]["ema_params"]),
            ema_batch_stats=_nested(res[2]["ema_batch_stats"]))
        for use_ema in (False, True):
            got = {k: int(v) for k, v in make_eval_step(
                model, mean=MEAN, std=STD, use_ema=use_ema,
                multi_output=True)(state, batch).items()}
            with tiny_resnet():
                jm = j_variant("tsn_mtmm_sd", num_class=CLS, num_segments=T,
                               partial_bn=False, dropout=0.0)
                want = j_make_eval_step(
                    jm, mean=MEAN, std=STD, use_ema=use_ema,
                    multi_output=True)(
                    jstate, {k: jnp.asarray(a) for k, a in batch.items()})
            assert set(got) == {"n"} | {f"{h}_top{k}" for h in
                                        ("final", "mid1", "mid2", "mid3")
                                        for k in (1, 5)}
            assert got == {k: int(a) for k, a in want.items()}


def _mtmm_pth(path):
    """A Stage-1 file: a seeded port ``tsn_mtmm`` (one-bottleneck
    ResNet-50) as ``{'state_dict': ...}``; returns its state_dict."""
    with tiny_resnet():
        src = variant("tsn_mtmm", num_class=CLS, num_segments=T,
                      partial_bn=False, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    sd = src.state_dict()
    torch.save({"state_dict": sd}, path)
    return sd


@pytest.mark.usefixtures("single_thread")
class TestWarmStart:
    @pytest.mark.parametrize("partial_bn", [False, True])
    def test_labels_match_the_jax_walk(self, partial_bn):
        """``label_params`` on ``tsn_mtmm_sd`` with every head: the
        transposed convs' biases ``normal_bias``, their BNs and the text
        BN ``frozen`` under partial BN and ``bn`` otherwise, the text
        conv's 3-D weight ``normal_weight``, as in the JAX walk."""
        with tiny_resnet():
            jm = j_variant("tsn_mtmm_sd", num_class=CLS, num_segments=T,
                           partial_bn=partial_bn, modal=FULL)
            shapes = jax.eval_shape(lambda: jm.init(
                jax.random.key(0), jnp.zeros((2, T, HW, HW, 3)),
                train=False))
            m = variant("tsn_mtmm_sd", num_class=CLS, num_segments=T,
                        partial_bn=partial_bn, modal=FULL, device="cpu")
        want = {torch_key(p): lab for p, lab in flatten_dict(
            j_label_params(shapes["params"], fc_lr5=True,
                           partial_bn=partial_bn)).items()}
        got = label_params(m, fc_lr5=True, partial_bn=partial_bn)
        assert got == want
        bn = "frozen" if partial_bn else "bn"
        for dec in ("local_decoder", "global_decoder", "local_skel_decoder",
                    "global_skel_decoder"):
            assert got[f"{dec}.0.bias"] == "normal_bias"
            assert got[f"{dec}.1.weight"] == bn
        assert got["text_encoder.0.weight"] == "normal_weight"
        assert got["text_encoder.1.bias"] == bn

    def test_pth_warm_start_matches_jax(self, tmp_path):
        """A Stage-1 ``.pth`` into ``tsn_mtmm_sd`` by torch keys.  The MTMM
        decoder's first BN, ``global_decoder.1.*`` (256 channels), has the
        key and shape of the joint decoder's ``ctbn0`` and is taken; its
        other keys are absent from the joint model or of another shape
        and are skipped; the exits and the local decoder, and the joint
        decoder's transposed convs and ``ctbn1``, keep their init.  The
        JAX loader refuses this file (ValueError on the first shape
        mismatch, ``global_decoder.0.weight``); given the file without the
        two keys whose shape differs, it leaves every tensor bitwise where
        the port's loader leaves it from the whole file."""
        path = str(tmp_path / "mtmm.pth")
        src = _mtmm_pth(path)
        with tiny_resnet():
            jm = j_variant("tsn_mtmm_sd", num_class=CLS, num_segments=T,
                           partial_bn=False)
            v = jax.jit(lambda r: jm.init(
                r, jnp.zeros((2, T, HW, HW, 3)), train=False))(
                    {"params": jax.random.key(3)})
            m = variant("tsn_mtmm_sd", num_class=CLS, num_segments=T,
                        partial_bn=False, device="cpu")
        load_jax_variables(m, _flat(v))
        with pytest.raises(ValueError, match="global_decoder.0.weight"):
            j_load_for_model(path, v)
        skipped = load_for_model(path, m)
        shape_differs = ["global_decoder.0.weight", "global_decoder.4.weight"]
        assert sorted(skipped) == sorted(shape_differs + [
            f"global_decoder.{i}.{leaf}" for i in (5, 9, 13)
            for leaf in ("weight", "bias", "running_mean", "running_var")] +
            ["global_decoder.8.weight", "global_decoder.12.weight",
             "global_decoder.15.weight", "global_decoder.15.bias"])
        taken = set(src) - set(skipped)
        kept = sorted(set(m.state_dict()) - taken)
        assert {k for k in taken if k.startswith("global_decoder.")} == {
            f"global_decoder.1.{leaf}" for leaf in (
                "weight", "bias", "running_mean", "running_var")}
        assert all(k.startswith(("scala", "middle_fc", "local_decoder.",
                                 "global_decoder.0.", "global_decoder.2.",
                                 "global_decoder.3.", "global_decoder.4."))
                   for k in kept)
        filtered = str(tmp_path / "mtmm_same_shapes.pth")
        torch.save({"state_dict": {k: t for k, t in src.items()
                                   if k not in shape_differs}}, filtered)
        want = state_dict_from_jax(_flat(j_load_for_model(filtered, v)))
        got = m.state_dict()
        assert sorted(got) == sorted(want)
        for k, t in want.items():
            assert torch.equal(got[k], t), k

    def test_cli_trains_one_epoch(self, tmp_path):
        """``cli.train_mtmm_sd`` on the CPU (the preset ``ego_mtmm_sd``,
        bf16, 'vjp') for one epoch of two steps of two clips, warm-started
        from a Stage-1 ``.pth``: the three checkpoint files of the joint
        model, one ``metrics.jsonl`` record, the exits' top-1 validated."""
        path = str(tmp_path / "mtmm.pth")
        _mtmm_pth(path)
        argv = ["--synthetic", "--epochs", "1", "--batch_size", "2",
                "--clip_len", str(T), "--crop_size", str(HW),
                "--scale_size", str(HW), "--num_classes", str(CLS),
                "--synthetic_videos", "4", "--run_dir", str(tmp_path),
                "--model_name", "joint", "--checkpoint_path", path,
                "--device", "cpu"]
        with tiny_resnet():
            res = cli_train_mtmm_sd.main(argv)
            want = variant("tsn_mtmm_sd", num_class=CLS, num_segments=T,
                           device="cpu").state_dict()
        assert np.isfinite(res["final_train_loss"])
        assert {f"{h}_top1" for h in ("final", "mid1", "mid2", "mid3")} <= \
            set(res)
        files = sorted(f for f in os.listdir(res["run_dir"])
                       if f.endswith(".pth"))
        assert files == ["joint_best_ckpt.pth", "joint_ema_best_ckpt.pth",
                         "joint_latest_ckpt.pth"]
        saved = torch.load(os.path.join(res["run_dir"], files[2]),
                           map_location="cpu", weights_only=True)
        assert saved["step"] == 2
        assert sorted(saved["state_dict"]) == sorted(want)
        with open(os.path.join(res["run_dir"], "metrics.jsonl")) as f:
            assert len(f.readlines()) == 1
