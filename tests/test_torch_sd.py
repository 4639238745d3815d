"""Stage 2 (self-distillation) and its truncated deploys on the CPU, against
the JAX package from the same weights and inputs: the SD exits (``SepConv``,
``Scala``), ``tsn_sd`` at the golden geometry (``tests/test_regression.py``:
N=2, T=4, 32^2, 5 classes, init key 42) and its full 8-tuple, the
truncated ``tsn_middle1/2/3``, the converter, ``merge_state_dict`` against
``merge_variables``, the optimizer's labels, the SD losses and the 4-head
scorer against ``eval/runner.py``'s vote (the train steps are in
``tests/test_torch_sd_steps.py``).

fp32.  Tolerances: the golden anchors at their own limits; logits rtol =
atol = 1e-4 (the convolutions sum in another order), features rtol 1e-4
and atol 1e-4 of their max |value|, the exits' logits (~1e-3, from the
N(0, 0.001) heads) at atol 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from ehgr_tpu.models.decoders import Scala as JScala
from ehgr_tpu.models.torch_import import export_state_dict
from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu.ops.preprocess_device import normalize_clip as j_normalize
from ehgr_tpu.train import losses as jl
from ehgr_tpu.train.checkpoints import merge_variables
from ehgr_tpu.train.optim import label_params as j_label_params
from ehgr_tpu_torch.eval.inference import make_score_fn
from ehgr_tpu_torch.models.convert import (load_jax_variables,
                                           state_dict_from_jax, torch_key)
from ehgr_tpu_torch.models.decoders import Scala, SepConv
from ehgr_tpu_torch.models.norm import BatchNorm
from ehgr_tpu_torch.models.tsn import variant
from ehgr_tpu_torch.train import losses as tl
from ehgr_tpu_torch.train.checkpoints import merge_state_dict
from ehgr_tpu_torch.train.optim import label_params

from test_regression import GOLD_FINAL, GOLD_MID1
from test_torch_train import one_thread
from test_torch_train import single_thread  # noqa: F401  (a fixture)

CLS, T, HW = 5, 4, 32
TOL = dict(rtol=1e-4, atol=1e-4)
MID_TOL = dict(rtol=1e-4, atol=1e-6)
OUT_NAMES = ("logits", "mid1", "mid2", "mid3", "final_fea", "f1", "f2", "f3")
# every test here runs the port forward or builds it, never a trajectory
pytestmark = pytest.mark.usefixtures("single_thread")


def _x():
    return np.linspace(-1, 1, 2 * T * HW * HW * 3,
                       dtype=np.float32).reshape(2, T, HW, HW, 3)


def _flat(v):
    return {k: np.asarray(a) for k, a in flatten_dict(v).items()}


def _jax_model(arch):
    """A JAX surface at the golden geometry: model, variables, outputs."""
    model = j_variant(arch, num_class=CLS, num_segments=T, temporal="action",
                      partial_bn=False)
    x = jnp.asarray(_x())
    v = jax.jit(lambda r, xx: model.init(r, xx, train=False))(
        {"params": jax.random.key(42)}, x)
    return model, v, jax.jit(lambda vv, xx: model.apply(vv, xx,
                                                        train=False))(v, x)


@pytest.fixture(scope="module")
def sd():
    """JAX ``tsn_sd``: model, variables, flat variables, 8-tuple."""
    model, v, out = _jax_model("tsn_sd")
    return model, v, _flat(v), [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def middles(sd):
    """JAX ``tsn_middleK`` for K = 1, 2, 3: variables, flat variables and
    logits.  Each middle's variable tree is a subtree of ``tsn_sd``'s (the
    same paths and shapes, so the same init), so its variables are taken
    from the ``sd`` fixture's instead of a second init."""
    flat_sd = flatten_dict(sd[1])
    x = jnp.asarray(_x())
    out = {}
    for k in (1, 2, 3):
        model = j_variant(f"tsn_middle{k}", num_class=CLS, num_segments=T,
                          temporal="action", partial_bn=False)
        shapes = flatten_dict(jax.eval_shape(lambda: model.init(
            {"params": jax.random.key(42)}, x, train=False)))
        assert all(flat_sd[p].shape == a.shape for p, a in shapes.items())
        v = unflatten_dict({p: flat_sd[p] for p in shapes})
        logits = jax.jit(lambda vv, xx: model.apply(vv, xx, train=False))(
            v, x)
        out[k] = (v, _flat(v), np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def sd_prologue(sd):
    """The port's ``tsn_sd`` in mode 'prologue' from the JAX variables, one
    for the module: its state_dict and its outputs on the golden input."""
    m = _port("tsn_sd", sd[2], "prologue")
    with torch.no_grad(), one_thread():     # as the tests it serves run
        return m.state_dict(), m(torch.from_numpy(_x()))


def _mtmm_variables(flat_sd):
    """A ``tsn_mtmm`` variable tree (its paths and shapes, without an init):
    ``flat_sd``'s values where ``tsn_sd`` has the path, the global decoder
    from a seeded generator, every leaf plus 0.5 so that none equals the
    SD model's."""
    model = j_variant("tsn_mtmm", num_class=CLS, num_segments=T,
                      temporal="action", partial_bn=False)
    shapes = flatten_dict(jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(42)}, jnp.asarray(_x()), train=False)))
    rng = np.random.default_rng(3)
    return unflatten_dict({
        p: jnp.asarray((np.asarray(flat_sd[p]) if p in flat_sd else
                        rng.standard_normal(a.shape).astype(a.dtype)) + 0.5)
        for p, a in shapes.items()})


def _port(arch, flat=None, mode=None, **kw):
    m = variant(arch, num_class=CLS, num_segments=T, temporal="action",
                action_fused=mode, device="cpu", **kw)
    if flat is not None:
        load_jax_variables(m, flat)
    return m


def _scala_vars(flat, name):
    """Flat JAX variables of one scala stack -> (its torch state_dict, the
    nested JAX variables of the module alone)."""
    sd = {k[len(name) + 1:]: t for k, t in state_dict_from_jax(
        {p: a for p, a in flat.items() if p[1] == name}).items()}
    jv = {"params": {}, "batch_stats": {}}
    for p, a in flat.items():
        if p[1] != name:
            continue
        node = jv[p[0]]
        for part in p[2:-1]:
            node = node.setdefault(part, {})
        node[p[-1]] = jnp.asarray(a)
    return sd, jv


class TestExits:
    @pytest.mark.parametrize("train", [False, True])
    @pytest.mark.parametrize("widths", [(64,), (64, 128)])
    def test_scala_matches_jax(self, rng, train, widths):
        """A scala stack on a 32-channel 9x9 tap (odd size: the stride-2
        pad), from the same weights with BN statistics off (0, 1); training
        also the statistics it leaves."""
        x = rng.standard_normal((4, 9, 9, 32)).astype(np.float32)
        j = JScala(widths)
        v = j.init(jax.random.key(0), jnp.asarray(x), train=False)
        flat = {(p[0], "scala1") + p[1:]: np.asarray(a)
                for p, a in flatten_dict(v).items()}
        for p in flat:
            if p[-1] in ("mean", "var", "bias", "scale"):
                flat[p] = rng.uniform(0.5, 1.5, flat[p].shape).astype(
                    np.float32)
        sd, jv = _scala_vars(flat, "scala1")
        tm = Scala(32, widths, device="cpu")
        tm.load_state_dict(sd, strict=True)
        tm.train(train)
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
        if train:
            want, mut = j.apply(jv, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        else:
            want = j.apply(jv, jnp.asarray(x), train=False)
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), **TOL)
        if train:
            stats = {(p[0], "scala1") + p[1:]: np.asarray(a) for p, a in
                     flatten_dict({"batch_stats": mut["batch_stats"]})
                     .items()}
            want_sd = {k[len("scala1."):]: t
                       for k, t in state_dict_from_jax(stats).items()}
            for k, t in want_sd.items():
                np.testing.assert_allclose(
                    tm.state_dict()[k].numpy(), t.numpy(), err_msg=k, **TOL)

    def test_sepconv_keys_are_the_references(self):
        """``op.{0,1,2,4,5,6}``: dw, pw, BN, (ReLU), dw, pw, BN."""
        keys = set(SepConv(8, 16, device="cpu").state_dict())
        assert {k.split(".")[1] for k in keys} == {"0", "1", "2", "4", "5",
                                                    "6"}
        assert SepConv(8, 16, device="cpu").op[0].stride == (2, 2)

    def test_exit_bns_train_under_partial_bn(self):
        """The scala BNs sit outside base_model: batch statistics in
        training whatever partial_bn says."""
        m = _port("tsn_sd", partial_bn=True).train()
        live = {k for k, mod in m.named_modules()
                if isinstance(mod, BatchNorm) and mod.training}
        assert live == {"base_model.bn1"} | {
            k for k, mod in m.named_modules()
            if isinstance(mod, BatchNorm) and k.startswith("scala")}
        assert len(live) == 1 + 2 * (3 + 2 + 1)


class TestTsnSd:
    def test_converter_matches_export_state_dict(self, sd):
        _, v, flat, _ = sd
        want = export_state_dict(v)
        got = state_dict_from_jax(flat)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        assert sorted(_port("tsn_sd").state_dict()) == sorted(got)

    @pytest.mark.parametrize("mode", [None, "mega", "prologue"])
    def test_reproduces_gold_and_jax(self, sd, mode):
        _, _, flat, want = sd
        with torch.no_grad():
            got = [o.numpy() for o in _port("tsn_sd", flat, mode)(
                torch.from_numpy(_x()))]
        np.testing.assert_allclose(got[0][0], GOLD_FINAL, rtol=2e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(got[1][0], GOLD_MID1, rtol=2e-3,
                                   atol=1e-6)
        assert [g.shape for g in got] == [w.shape for w in want] == \
            [(2, CLS)] * 4 + [(2 * T, 2048)] * 4
        for name, g, w in zip(OUT_NAMES, got, want):
            if name.startswith("f"):       # features: up to ~4e2 here
                tol = dict(rtol=1e-4, atol=1e-4 * np.abs(w).max())
            else:
                tol = MID_TOL if name.startswith("mid") else TOL
            np.testing.assert_allclose(g, w, err_msg=name, **tol)

    def test_joint_stage_raises(self):
        """The joint arch builds (tests/test_torch_joint.py holds it against
        JAX): with ``modal='rgb'`` it is ``tsn_sd``'s surface, key for key;
        an unknown arch raises."""
        joint = _port("tsn_mtmm_sd", modal="rgb")
        assert list(joint.state_dict()) == list(_port("tsn_sd").state_dict())
        with pytest.raises(ValueError, match="unknown arch"):
            _port("tsn_middle4")


class TestMiddle:
    @pytest.mark.parametrize("k", [1, 2, 3])
    def test_matches_jax_truncation(self, middles, k):
        """The port's truncated model holds the same keys as the JAX one
        (stages up to K, exit K) and gives its logits."""
        v, flat, want = middles[k]
        assert sorted(state_dict_from_jax(flat)) == \
            sorted(export_state_dict(v))
        m = _port(f"tsn_middle{k}", flat)
        assert not hasattr(m.base_model, f"layer{k + 1}")
        with torch.no_grad():
            got = m(torch.from_numpy(_x())).numpy()
        np.testing.assert_allclose(got, want, **MID_TOL)

    @pytest.mark.parametrize("k", [1, 2, 3])
    def test_from_tsn_sd_equals_exit(self, sd_prologue, k):
        """Loaded from ``tsn_sd`` with ``merge_state_dict``, ``tsn_middleK``
        gives exactly the SD model's exit K; every one of its tensors came
        from the source."""
        src, full_out = sd_prologue
        mid = _port(f"tsn_middle{k}", mode="prologue",
                    generator=torch.Generator().manual_seed(7))
        skipped = merge_state_dict(mid, src)
        assert set(mid.state_dict()) == set(src) - set(skipped)
        with torch.no_grad():
            torch.testing.assert_close(mid(torch.from_numpy(_x())),
                                       full_out[k], rtol=0, atol=0)


class TestMergeStateDict:
    def _jax_skipped(self, dst, src):
        merged, skipped = merge_variables(dst, src)
        return merged, {torch_key(p[1:]) for p in skipped}

    def test_stage1_into_stage2(self, sd):
        """``tsn_mtmm`` -> ``tsn_sd``: the same skipped keys as
        ``merge_variables`` (the global decoder), the same merged
        weights, and the exits keep their init."""
        _, v_sd, flat_sd, _ = sd
        v_mtmm = _mtmm_variables(flat_sd)
        merged, want = self._jax_skipped(v_sd, v_mtmm)
        assert want and all(k.startswith("global_decoder.") for k in want)
        m = _port("tsn_sd", _flat(v_sd))
        got = merge_state_dict(m, state_dict_from_jax(_flat(v_mtmm)))
        assert set(got) == want and len(got) == len(want)
        want_sd = state_dict_from_jax(_flat(merged))
        for k, t in m.state_dict().items():
            torch.testing.assert_close(t, want_sd[k], rtol=0, atol=0,
                                       msg=k)
        assert torch.equal(m.scala1[0].op[0].weight, state_dict_from_jax(
            flat_sd)["scala1.0.op.0.weight"])

    @pytest.mark.parametrize("k", [1, 2, 3])
    def test_sd_into_middle(self, sd, middles, k):
        _, v_sd, flat_sd, _ = sd
        v_mid, flat_mid, _ = middles[k]
        _, want = self._jax_skipped(v_mid, v_sd)
        got = merge_state_dict(_port(f"tsn_middle{k}", flat_mid),
                               state_dict_from_jax(flat_sd))
        assert set(got) == want
        assert any(s.startswith("new_fc") for s in got)

    def test_shape_mismatch_is_skipped(self):
        m = _port("tsn_middle1")
        w = m.middle_fc1.weight.detach().clone()
        src = {"middle_fc1.weight": torch.zeros(CLS + 1, 2048),
               "middle_fc1.bias": torch.ones(CLS), "nope": torch.zeros(1)}
        assert merge_state_dict(m, src) == ["middle_fc1.weight", "nope"]
        assert torch.equal(m.middle_fc1.weight, w)
        assert torch.equal(m.middle_fc1.bias, torch.ones(CLS))


class TestOptimizerLabels:
    @pytest.mark.parametrize("partial_bn", [False, True])
    def test_labels_match_the_jax_walk(self, partial_bn):
        """``label_params`` on ``tsn_sd``: the exits' heads are lr5/lr10,
        and under partial BN the scala BNs are labelled frozen although
        they train on batch statistics, as in the JAX walk."""
        jm = j_variant("tsn_sd", num_class=CLS, num_segments=T,
                       partial_bn=partial_bn)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.key(0), jnp.zeros((1, T, HW, HW, 3)), train=False))
        want = {torch_key(p): lab for p, lab in flatten_dict(
            j_label_params(shapes["params"], fc_lr5=True,
                           partial_bn=partial_bn)).items()}
        m = _port("tsn_sd", partial_bn=partial_bn)
        got = label_params(m, fc_lr5=True, partial_bn=partial_bn)
        assert got == want
        assert got["middle_fc2.weight"] == "lr5_weight"
        assert got["scala1.0.op.2.weight"] == \
            ("frozen" if partial_bn else "bn")


class TestLosses:
    @pytest.mark.parametrize("temperature,alpha,beta",
                             [(3.0, 0.1, 1e-6), (1.0, 0.5, 1e-3)])
    def test_sd_total_on_model_outputs(self, sd, temperature, alpha, beta):
        """``sd_total`` and its parts on the ``tsn_sd`` 8-tuple."""
        _, _, _, out = sd
        labels = np.array([1, 3])
        j_total, j_aux = jl.sd_total(
            jnp.asarray(out[0]), [jnp.asarray(o) for o in out[1:4]],
            jnp.asarray(labels), jnp.asarray(out[4]),
            [jnp.asarray(o) for o in out[5:]], alpha=alpha, beta=beta,
            temperature=temperature)
        t = [torch.from_numpy(o.copy()) for o in out]
        total, aux = tl.sd_total(t[0], t[1:4], torch.from_numpy(labels),
                                 t[4], t[5:], alpha=alpha, beta=beta,
                                 temperature=temperature)
        np.testing.assert_allclose(total.item(), float(j_total), rtol=1e-5)
        for k in ("ce", "mid_ce", "kd", "feat"):
            np.testing.assert_allclose(aux[k].numpy(), np.asarray(j_aux[k]),
                                       rtol=1e-5, err_msg=k)

    def test_teacher_is_detached(self):
        """No gradient reaches the final head through KD or the hint."""
        out, fea, mid, mid_fea = (torch.randn(*s, requires_grad=True)
                                  for s in ((3, 5), (3, 8), (3, 5), (3, 8)))
        (tl.kd_loss(mid, out) + tl.feature_hint_loss(mid_fea, fea)) \
            .backward()
        assert out.grad is None and fea.grad is None
        assert mid.grad.abs().sum() > 0 and mid_fea.grad.abs().sum() > 0


class TestFourHeadScorer:
    def test_matches_the_runner_vote(self, sd, rng):
        """V=2 videos x K=2 clips through ``make_score_fn(heads=4)`` against
        the JAX model's softmax averaged over clips per head (the vote of
        ``eval/runner.py``), and ``heads=1`` is the final head alone.  The
        heads are scaled on both sides so no head is saturated or
        uniform."""
        model, v, _, _ = sd
        frames = rng.integers(0, 256, (2, 2, T, HW, HW, 3), dtype=np.uint8)
        x = j_normalize(jnp.asarray(frames), dtype=jnp.float32)
        x = x.reshape((4, T) + x.shape[3:])
        apply = jax.jit(lambda vv, xx: model.apply(vv, xx, train=False))
        outs = apply(v, x)
        params = jax.tree_util.tree_map(lambda a: a, v["params"])
        for name, o in zip(("new_fc", "middle_fc1", "middle_fc2",
                            "middle_fc3"), outs):   # max |logit| to 2
            params[name]["kernel"] = params[name]["kernel"] * (
                2.0 / float(jnp.abs(o).max()))
        v = {**v, "params": params}
        outs = apply(v, x)
        want = [np.asarray(jax.nn.softmax(o, -1).reshape(2, 2, -1).mean(1))
                for o in outs[:4]]
        m = _port("tsn_sd", _flat(v), "prologue")
        got = make_score_fn(m, device="cpu", crop_size=HW,
                            dtype_name="float32", heads=4)(frames)
        assert isinstance(got, tuple) and len(got) == 4
        for g, w in zip(got, want):
            assert 0.05 < w.max() < 0.95 and w.std() > 1e-3
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)
        one = make_score_fn(m, device="cpu", crop_size=HW,
                            dtype_name="float32")(frames)
        torch.testing.assert_close(one, got[0], rtol=0, atol=0)
