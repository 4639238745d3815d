"""The whole slice on the CPU: the port's TSN + ACTION ResNet-50 in mode
``'mega'`` from converted JAX weights at the golden geometry
(``tests/test_regression.py``: N=2, T=4, 32^2, 5 classes, init key 42), the
converter against ``export_state_dict``, and the multi-clip scorer against
the JAX scorer.  The JAX reference is built once per module."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from ehgr_tpu.eval.inference import evaluate as j_evaluate
from ehgr_tpu.eval.inference import make_score_fn as j_make_score_fn
from ehgr_tpu.models.torch_import import export_state_dict
from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu_torch.eval.inference import evaluate, make_score_fn
from ehgr_tpu_torch.models.backbones import get_backbone
from ehgr_tpu_torch.models.convert import (load_jax_variables,
                                           state_dict_from_jax)
from ehgr_tpu_torch.models.tsn import variant

from test_regression import GOLD_TSN
from test_torch_train import single_thread  # noqa: F401  (a fixture)

CLS, T, HW = 5, 4, 32
# every test here runs the port forward or builds it, never a trajectory
pytestmark = pytest.mark.usefixtures("single_thread")


def _x():
    return np.linspace(-1, 1, 2 * T * HW * HW * 3,
                       dtype=np.float32).reshape(2, T, HW, HW, 3)


@pytest.fixture(scope="module")
def golden():
    """JAX tsn (action_fused='mega', Pallas in interpret mode) at the golden
    geometry: its variables, flattened variables and logits."""
    model = j_variant("tsn", num_class=CLS, num_segments=T,
                      temporal="action", partial_bn=False,
                      action_fused="mega")
    x = jnp.asarray(_x())
    v = jax.jit(lambda r, xx: model.init(r, xx, train=False))(
        {"params": jax.random.key(42)}, x)
    logits = np.asarray(jax.jit(lambda vv, xx: model.apply(
        vv, xx, train=False))(v, x))
    flat = {k: np.asarray(a) for k, a in flatten_dict(v).items()}
    return v, flat, logits


@pytest.fixture(scope="module")
def ports(golden):
    """The port's tsn from the golden variables, one converted model per
    ACTION mode for the module."""
    return {mode: _port(golden[1], mode) for mode in ("mega", None,
                                                      "prologue")}


def _port(flat, mode):
    m = variant("tsn", num_class=CLS, num_segments=T, temporal="action",
                action_fused=mode, device="cpu")
    load_jax_variables(m, flat)
    return m


class TestConverter:
    def test_matches_export_state_dict(self, golden):
        v, flat, _ = golden
        want = export_state_dict(v)
        got = state_dict_from_jax(flat)
        assert len(want) == 459
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == w.shape, k
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)

    def test_state_dict_keys_are_the_models(self, golden):
        _, flat, _ = golden
        m = variant("tsn", num_class=CLS, num_segments=T, device="cpu")
        assert sorted(m.state_dict()) == sorted(state_dict_from_jax(flat))


class TestGoldenLogits:
    @pytest.mark.parametrize("mode", ["mega", None, "prologue"])
    def test_reproduces_gold_and_jax(self, golden, ports, mode):
        want = golden[2]
        with torch.no_grad():
            got = ports[mode](torch.from_numpy(_x())).numpy()
        np.testing.assert_allclose(got[0, :5], GOLD_TSN, rtol=2e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


class TestScorer:
    def test_scorer_and_evaluate_match_jax(self, golden, rng):
        """V=2 videos x K=2 clips.  The head is scaled by 1e-2 on both sides
        so the random-init probabilities are not saturated at 0/1."""
        v, flat, _ = golden
        params = jax.tree_util.tree_map(lambda a: a, v["params"])
        params["new_fc"]["kernel"] = params["new_fc"]["kernel"] * 1e-2
        v = {**v, "params": params}
        flat = {k: np.asarray(a) for k, a in flatten_dict(v).items()}
        jm = j_variant("tsn", num_class=CLS, num_segments=T,
                       temporal="action", partial_bn=False)
        j_score = j_make_score_fn(jm, v, crop_size=HW, dtype_name="float32")
        score = make_score_fn(_port(flat, "mega"), device="cpu",
                              crop_size=HW, dtype_name="float32")

        batches = [(rng.integers(0, 256, (2, 2, T, HW, HW, 3),
                                 dtype=np.uint8), rng.integers(0, CLS, (2,)))
                   for _ in range(2)]
        for frames, _ in batches:
            want = np.asarray(j_score(jnp.asarray(frames)))
            got = score(frames).numpy()
            assert 0.05 < want.max() < 0.95          # not saturated
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        r, jr = evaluate(score, batches, CLS), j_evaluate(j_score, batches,
                                                          CLS)
        assert (r["top1"], r["top5"], r["n_videos"]) == \
            (jr["top1"], jr["top5"], jr["n_videos"])
        np.testing.assert_array_equal(r["confusion"].m, jr["confusion"].m)


class TestEntryPoints:
    def test_default_device_is_cuda(self, monkeypatch):
        """Without ``device=`` the model and the scorer want CUDA and raise
        where there is none."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            variant("tsn", num_class=CLS, num_segments=T)
        m = variant("tsn", num_class=CLS, num_segments=T, device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_score_fn(m)

    def test_seeded_init_is_deterministic(self):
        def build(seed):
            return variant("tsn", num_class=CLS, num_segments=T,
                           device="cpu",
                           generator=torch.Generator().manual_seed(seed))
        a, b, c = build(1), build(1), build(2)
        for (k, va), vb in zip(a.state_dict().items(),
                               b.state_dict().values()):
            torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
        assert not torch.equal(a.new_fc.weight, c.new_fc.weight)
        assert a.new_fc.weight.std().item() < 0.002   # N(0, 0.001) head

    @pytest.mark.parametrize("arch", ["tsn_mtmm", "tsn_sd", "tsn_mtmm_sd",
                                      "tsn_middle2"])
    def test_unported_surfaces_raise(self, arch):
        """Every TSN surface is ported and returns its outputs: tsn_mtmm
        (training slice), tsn_sd and tsn_middle2 (SD slice;
        tests/test_torch_sd.py holds them against JAX) and the joint
        tsn_mtmm_sd (tests/test_torch_joint.py)."""
        m = variant(arch, num_class=CLS, num_segments=T, device="cpu")
        with torch.no_grad():
            out = m(torch.zeros(1, T, HW, HW, 3))
        if arch == "tsn_mtmm":
            logits, depth = out
            assert logits.shape == (1, CLS) and depth.shape == (T, 8, 8, 1)
        elif arch == "tsn_sd":
            assert [tuple(o.shape) for o in out] == \
                [(1, CLS)] * 4 + [(T, 2048)] * 4
        elif arch == "tsn_mtmm_sd":              # modal 'rgb_depth'
            assert [tuple(o.shape) for o in out] == \
                [(1, CLS)] * 4 + [(T, 2048)] * 4 + [(T, HW, HW, 1),
                                                    (T, 8, 8, 1)]
        else:
            assert out.shape == (1, CLS)
            assert not hasattr(m.base_model, "layer3")

    def test_unported_backbone_raises(self):
        """Every backbone of the JAX factory is ported now (MobileNetV2, the
        unported one this test held before, builds); a name the JAX factory
        does not know raises its ValueError."""
        bb = get_backbone("mobilenet_v2", "action", T, 8, device="cpu")
        assert type(bb).__name__ == "MobileNetV2Backbone"
        with pytest.raises(ValueError, match="unknown base model"):
            get_backbone("vgg16", "action", T, 8, device="cpu")


class TestBackbone:
    def test_taps_and_max_stage(self):
        bb = get_backbone("resnet50", "action", T, 8, device="cpu").eval()
        x = torch.zeros(2 * T, 3, HW, HW).contiguous(
            memory_format=torch.channels_last)
        with torch.no_grad():
            taps = bb(x)
            assert {k: tuple(v.shape) for k, v in taps.items()} == {
                "stem": (8, 64, 8, 8), "layer1": (8, 256, 8, 8),
                "layer2": (8, 512, 4, 4), "layer3": (8, 1024, 2, 2),
                "layer4": (8, 2048, 1, 1), "pool": (8, 2048)}
        bb2 = get_backbone("resnet50", "action", T, 8, stages=2,
                           device="cpu").eval()
        assert not hasattr(bb2, "layer3")
        with torch.no_grad():
            assert sorted(bb2(x)) == ["layer1", "layer2", "stem"]

    @pytest.mark.parametrize("name,stages,want", [
        ("resnet50", (1, 2, 3, 4), [3, 4, 6, 3]),
        ("resnet101", (1, 2, 3, 4), [3, 4, 12, 3]),   # every other of 23
        ("resnet50", (4,), [0, 0, 0, 3]),
    ])
    def test_action_placement(self, name, stages, want):
        from ehgr_tpu_torch.ops.action import ActionConv

        bb = get_backbone(name, "action", T, 8, action_stages=stages,
                          device="cpu")
        got = [sum(isinstance(b.conv1, ActionConv)
                   for b in getattr(bb, f"layer{i}")) for i in range(1, 5)]
        assert got == want
