"""The other backbone families on the CPU: MobileNetV2 and BN-Inception at
full width and Res2Net-50 at one block a stage, under TSN with each
temporal module (``none``, ``action``, ``tsm``) and, for ACTION, each eval
mode (plain, ``'mega'``, ``'prologue'``), against the JAX package from the
same weights: drawn with numpy from a fixed seed over the JAX variable tree
(``draw``; BN statistics away from their init so every BN acts) and
converted with ``models/convert.py``, loaded strictly.  Also Res2Net's SD
heads and ``tsn_middle1``, the plain-surface error of the other two, the
converter's keys against the JAX converter's, the optimizer's labels
against the JAX walk, the gate's kernel routes on a tensor that reports
CUDA, ``modality`` (bitwise) and ``BYOTResNet``.  The train steps are in
``tests/test_torch_backbones_train.py``.

Geometry N=1, T=4, 32^2 (BN-Inception's ceil pools need 32^2), 5 classes,
fp32.  Each JAX model is traced once per module (``jax_forward``) and its
apply jitted; logits are held at rtol = atol = 1e-4, as in
``tests/test_torch_tsn.py``."""

import contextlib
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from ehgr_tpu.models import backbones as j_backbones
from ehgr_tpu.models.byot_resnet import BYOTResNet as JBYOTResNet
from ehgr_tpu.models.modality import adapt_first_conv as j_adapt_first_conv
from ehgr_tpu.models.modality import rgb_diff as j_rgb_diff
from ehgr_tpu.models.modality import stack_flow as j_stack_flow
from ehgr_tpu.models.res2net import Res2NetBackbone as JRes2Net
from ehgr_tpu.models.torch_import import _flax_path_to_torch_key
from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu.train.optim import label_params as j_label_params
from ehgr_tpu_torch.models import backbones as t_backbones
from ehgr_tpu_torch.models import modality
from ehgr_tpu_torch.models.byot_resnet import BYOTResNet
from ehgr_tpu_torch.models.convert import (convert_tensor,
                                           load_jax_variables, torch_key)
from ehgr_tpu_torch.models.res2net import Res2NetBackbone
from ehgr_tpu_torch.models.tsn import variant
from ehgr_tpu_torch.ops import action as t_action
from ehgr_tpu_torch.ops.kernels import (action_fused, action_mega, shift,
                                        tsm_shift)
from ehgr_tpu_torch.train.optim import label_params

from test_torch_guards import _OnCuda
from test_torch_train import single_thread  # noqa: F401  (a fixture)

CLS, T, HW = 5, 4, 32
TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ("mobilenet_v2", "bn_inception", "res2net50")
RES2NET_STAGES = (1, 1, 1, 1)
# (family, temporal, ACTION mode at eval) of the forward checks
FORWARD_CASES = [(f, t, m) for f in FAMILIES
                 for t, modes in (("none", (None,)), ("tsm", (None,)),
                                  ("action", (None, "mega", "prologue")))
                 for m in modes]
# every test here runs the port forward or builds it, never a trajectory
pytestmark = pytest.mark.usefixtures("single_thread")


@contextlib.contextmanager
def tiny_res2net():
    """Res2Net-50 widths with one block a stage, in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_backbones, "Res2NetBackbone", functools.partial(
            JRes2Net, stage_sizes=RES2NET_STAGES))
        mp.setattr(t_backbones, "Res2NetBackbone", functools.partial(
            Res2NetBackbone, stage_sizes=RES2NET_STAGES))
        yield


def draw(shapes, seed, init=False):
    """Variables of the tree ``shapes`` drawn with numpy: kernels
    N(0, 1/fan_in), shift taps N(0, 0.5^2), BN scale and running variance
    U(0.5, 1.5), BN and conv biases and running means N(0, 0.1^2); f32,
    leaves drawn in sorted path order.  ``init``: BN scale 1, bias 0,
    mean 0, variance 1, conv biases 0 and the head N(0, 0.001^2), as the
    JAX init has them (the train steps start there)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in sorted(flatten_dict(shapes).items()):
        leaf = path[-1]
        if leaf == "kernel" and init and "new_fc" in path:
            a = rng.normal(0.0, 0.001, s.shape)
        elif leaf == "kernel":
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif leaf == "shift_w":
            a = rng.normal(0.0, 0.5, s.shape)
        elif init:
            a = np.ones(s.shape) if leaf in ("scale", "var") \
                else np.zeros(s.shape)
        elif leaf in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, s.shape)
        else:
            a = rng.normal(0.0, 0.1, s.shape)
        out[path] = np.asarray(a, np.float32)
    return out


def _x(n=1):
    return np.random.default_rng(7).standard_normal(
        (n, T, HW, HW, 3)).astype(np.float32)


def jax_model(arch, family, temporal, partial_bn=False, **kw):
    return j_variant(arch, num_class=CLS, num_segments=T, base_model=family,
                     temporal=temporal, partial_bn=partial_bn, **kw)


@functools.lru_cache(maxsize=None)
def jax_shapes(arch, family, temporal, n=1, **kw):
    """The JAX model's variable tree as shapes (traced, not compiled; kept
    per configuration and module)."""
    model = jax_model(arch, family, temporal, **kw)
    with tiny_res2net():
        return jax.eval_shape(lambda r: model.init(
            r, jnp.zeros((n, T, HW, HW, 3)), train=False),
            {"params": jax.random.key(0)})


_FWD = {}


def jax_forward(arch, family, temporal):
    """(flat variables, outputs as numpy) of the JAX model at eval on
    ``_x()``, kept per configuration and module."""
    key = (arch, family, temporal)
    if key not in _FWD:
        model = jax_model(arch, family, temporal)
        flat = draw(jax_shapes(arch, family, temporal), seed=len(_FWD))
        with tiny_res2net():
            out = jax.jit(lambda v, x: model.apply(v, x, train=False))(
                unflatten_dict(flat), jnp.asarray(_x()))
        _FWD[key] = flat, jax.tree_util.tree_map(np.asarray, out)
    return _FWD[key]


def port(arch, family, temporal, mode=None, flat=None, partial_bn=False):
    with tiny_res2net():
        m = variant(arch, num_class=CLS, num_segments=T, base_model=family,
                    temporal=temporal, action_fused=mode,
                    partial_bn=partial_bn, device="cpu")
    if flat is not None:
        load_jax_variables(m, flat)
    return m


class TestForward:
    @pytest.mark.parametrize("family,temporal,mode", FORWARD_CASES)
    def test_logits_match_jax(self, family, temporal, mode):
        flat, want = jax_forward("tsn", family, temporal)
        with torch.no_grad():
            got = port("tsn", family, temporal, mode, flat)(
                torch.from_numpy(_x())).numpy()
        assert np.abs(want).max() > 1e-2            # the head is live
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("mode", ["mega", "prologue"])
    def test_res2net_sd_heads_match_jax(self, mode):
        """``tsn_sd`` on Res2Net + ACTION: the logits and the exits' logits
        at TOL, the features at rtol 1e-4 and atol 1e-4 of their max."""
        flat, want = jax_forward("tsn_sd", "res2net50", "action")
        with torch.no_grad():
            got = port("tsn_sd", "res2net50", "action", mode, flat)(
                torch.from_numpy(_x()))
        assert len(got) == len(want) == 8
        for i, (g, w) in enumerate(zip(got, want)):
            tol = TOL if i in (0, 1, 2, 3) else dict(
                rtol=1e-4, atol=1e-4 * np.abs(w).max())
            np.testing.assert_allclose(g.numpy(), w, err_msg=str(i), **tol)

    def test_res2net_middle1_matches_jax(self):
        flat, want = jax_forward("tsn_middle1", "res2net50", "action")
        m = port("tsn_middle1", "res2net50", "action", "prologue", flat)
        assert not hasattr(m.base_model, "layer2")
        with torch.no_grad():
            got = m(torch.from_numpy(_x())).numpy()
        np.testing.assert_allclose(got, want, **TOL)


class TestSurfaces:
    @pytest.mark.parametrize("family", ["mobilenet_v2", "bn_inception"])
    def test_plain_surface_only(self, family):
        """Every arch but ``tsn`` raises JAX's error for these two."""
        for arch in ("tsn_mtmm", "tsn_sd", "tsn_mtmm_sd", "tsn_middle1"):
            with pytest.raises(ValueError, match="plain TSN surface"):
                port(arch, family, "action")

    @pytest.mark.parametrize("name,cls", [
        ("mobilenet_v2", "MobileNetV2Backbone"),
        ("mobilenetv2", "MobileNetV2Backbone"),
        ("bn_inception", "BNInceptionBackbone"),
        ("BNInception", "BNInceptionBackbone"),
        ("res2net50", "Res2NetBackbone"),
        ("res2net50_26w_4s", "Res2NetBackbone")])
    def test_get_backbone_names(self, name, cls):
        """Each name builds its family; int8 and ``temporal_pool`` raise
        JAX's errors there; only the ResNet family has layer taps."""
        kw = dict(temporal="action", n_segment=T, shift_div=8,
                  device="cpu")
        with tiny_res2net():
            bb = t_backbones.get_backbone(name, **kw)
        assert type(bb).__name__ == cls
        assert t_backbones.supports_taps(name) == (cls == "Res2NetBackbone")
        with pytest.raises(ValueError, match="int8 inference"):
            t_backbones.get_backbone(name, quantize="dynamic", **kw)
        with pytest.raises(ValueError, match="temporal_pool is resnet-only"):
            t_backbones.get_backbone(name, temporal_pool=True, **kw)

    def test_action_sites(self):
        """ACTION sits on MobileNetV2's 10 residual expand convs, on every
        Res2Net conv1 and on BN-Inception's 10 block entries, gate-only."""
        sites = {f: [(n, m.features) for n, m in port(
            "tsn", f, "action").named_modules()
            if isinstance(m, t_action.ActionConv)] for f in FAMILIES}
        assert [n for n, _ in sites["mobilenet_v2"]] == [
            f"base_model.features.{i}.conv.0"
            for i in (3, 5, 6, 8, 9, 10, 12, 13, 15, 16)]
        assert [n for n, _ in sites["bn_inception"]] == [
            f"base_model.{g}" for g in (
                "shift_2", "shift_3a", "shift_3b", "shift_3c", "shift_4a",
                "shift_4b", "shift_4c", "shift_4d", "shift_4e", "shift_5a")]
        assert {f for _, f in sites["bn_inception"]} == {0}
        assert [(n, f) for n, f in sites["res2net50"]] == [
            (f"base_model.layer{i}.0.conv1", f)
            for i, f in zip((1, 2, 3, 4), (104, 208, 416, 832))]


class TestConverter:
    @pytest.mark.parametrize("family,temporal", [
        ("mobilenet_v2", "action"), ("bn_inception", "action"),
        ("res2net50", "action"), ("res2net50", "tsm")])
    def test_keys_are_the_jax_converters(self, family, temporal):
        """Every path of the tree gets the JAX converter's key, and the
        converted tree has exactly the model's keys."""
        shapes = jax_shapes("tsn", family, temporal)
        flat = flatten_dict(shapes)
        for path in flat:
            assert torch_key(path[1:]) == _flax_path_to_torch_key(path[1:])
        assert sorted(port("tsn", family, temporal).state_dict()) == \
            sorted(torch_key(p[1:]) for p in flat)

    def test_jax_key_cases(self):
        """The cases of ``tests/test_backbones.py``, and Res2Net's."""
        cases = {
            ("base_model", "features_0", "c0", "kernel"):
                "base_model.features.0.0.weight",
            ("base_model", "features_1", "conv_0", "kernel"):
                "base_model.features.1.conv.0.weight",
            ("base_model", "features_2", "conv_4", "mean"):
                "base_model.features.2.conv.4.running_mean",
            ("base_model", "features_18", "c1", "scale"):
                "base_model.features.18.1.weight",
            ("base_model", "conv1", "conv", "kernel"):
                "base_model.conv1_7x7_s2.weight",
            ("base_model", "conv1", "bn", "scale"):
                "base_model.conv1_7x7_s2_bn.weight",
            ("base_model", "conv2_reduce", "conv", "bias"):
                "base_model.conv2_3x3_reduce.bias",
            ("base_model", "inception_3a", "b1x1", "conv", "kernel"):
                "base_model.inception_3a_1x1.weight",
            ("base_model", "inception_4e", "bd3x3_2", "bn", "var"):
                "base_model.inception_4e_double_3x3_2_bn.running_var",
            ("base_model", "inception_5b", "bpool_proj", "bn", "bias"):
                "base_model.inception_5b_pool_proj_bn.bias",
            ("base_model", "layer2_0", "convs_2", "kernel"):
                "base_model.layer2.0.convs.2.weight",
            ("base_model", "layer4_1", "bns_0", "mean"):
                "base_model.layer4.1.bns.0.running_mean",
            ("base_model", "shift_4e", "shift_w"):
                "base_model.shift_4e.action_shift.weight",
        }
        for path, want in cases.items():
            assert torch_key(path) == want, path


class TestOptimizerLabels:
    @pytest.mark.parametrize("partial_bn", [False, True])
    @pytest.mark.parametrize("family", FAMILIES)
    def test_labels_match_the_jax_walk(self, family, partial_bn):
        """``label_params`` of the port gives every leaf the JAX walk's
        label: MobileNetV2's BNs (flax names ``c1`` / ``conv_{j}``) are
        ``normal_bias`` and never frozen, the ME BNs frozen under partial
        BN."""
        shapes = jax_shapes("tsn", family, "action")   # the same tree
        want = {torch_key(p): lab for p, lab in flatten_dict(
            j_label_params(shapes["params"], fc_lr5=True,
                           partial_bn=partial_bn)).items()}
        got = label_params(port("tsn", family, "action",
                                partial_bn=partial_bn),
                           fc_lr5=True, partial_bn=partial_bn)
        assert got == want
        if family == "mobilenet_v2":
            for k in ("base_model.features.0.1.weight",
                      "base_model.features.3.conv.1.bias"):
                assert got[k] == "normal_bias"
            assert got["base_model.features.3.conv.0.action_p3_bn1.weight"] \
                == ("frozen" if partial_bn else "custom_bn")


class _Launched(Exception):
    """Raised by a stand-in ``launch``: the kernel's entry point was
    reached with the operands checked."""


def _on_cuda(module):
    """``module`` with its parameters and buffers as ``_OnCuda``."""
    for mod in module.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[name] = torch.nn.Parameter(
                    torch.Tensor._make_subclass(_OnCuda, p.detach()))
        for name, b in list(mod._buffers.items()):
            if b is not None:
                mod._buffers[name] = torch.Tensor._make_subclass(_OnCuda, b)
    return module


class TestGateRoutes:
    @pytest.fixture
    def on_card(self, monkeypatch):
        """A card that builds nothing: each kernel's ``launch`` raises
        ``_Launched`` with its entry point; the plain shifts raise."""
        def launched(lib, fn, *a):
            raise _Launched(fn)

        def plain(*a, **k):
            raise AssertionError("the plain shift ran")

        class Lib:
            def ehgr_action_pool_scratch_rows(self, n, t, s):
                return 1
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        for mod in (action_fused, action_mega, shift, tsm_shift):
            monkeypatch.setattr(mod, "load", lambda name: Lib())
            monkeypatch.setattr(mod, "launch", launched)
        monkeypatch.setattr(action_fused, "action_prologue_plain", plain)
        monkeypatch.setattr(shift, "learnable_shift_fwd_plain", plain)
        monkeypatch.setattr(tsm_shift, "tsm_shift_plain", plain)
        monkeypatch.setattr(t_action, "learnable_shift", plain)

    def _x(self, c):
        x = torch.randn(2 * T, c, 4, 4).contiguous(
            memory_format=torch.channels_last)
        return torch.Tensor._make_subclass(_OnCuda, x)

    @pytest.mark.parametrize("mode", ["mega", "prologue"])
    def test_eval_gate_dispatches_the_prologue_op(self, on_card, mode):
        """At eval a gate in 'mega' or 'prologue' goes through
        ``ehgr::action_prologue`` to its CUDA kernel."""
        gate = _on_cuda(t_action.ActionGate(64, T, fused=mode,
                                            device="cpu")).eval()
        with pytest.raises(_Launched, match="^ehgr_action_prologue$"):
            gate(self._x(64))

    def test_training_gate_runs_learnable_shift(self, on_card):
        """In training in 'vjp' the gate's shift is ``LearnableShift``:
        the forward kernel first."""
        gate = _on_cuda(t_action.ActionGate(64, T, fused="vjp",
                                            device="cpu")).train()
        with pytest.raises(_Launched, match="^ehgr_shift_fwd$"):
            gate(self._x(64))

    def test_tsm_gate_dispatches_the_tsm_op(self, on_card):
        """BN-Inception's TSM gate goes through ``ehgr::tsm_shift``."""
        with pytest.raises(_Launched, match="^ehgr_tsm_shift$"):
            t_action.tsm_shift_nchw(self._x(192), T, 8)

    def test_gate_values_on_the_kernel_paths(self):
        """On the CPU the gate gives the plain formulation's values in
        every mode, at eval and (with its gradients) in training."""
        torch.manual_seed(0)
        gates = {m: t_action.ActionGate(64, T, fused=m, device="cpu")
                 for m in (None, "mega", "prologue", "vjp")}
        with torch.no_grad():
            gates[None].action_shift.weight.normal_(0.0, 0.5)
        for g in gates.values():
            g.load_state_dict(gates[None].state_dict())
        x = torch.randn(2 * T, 64, 4, 4)
        want = gates[None].eval()(x)
        for m in ("mega", "prologue"):
            torch.testing.assert_close(gates[m].eval()(x), want,
                                       rtol=1e-5, atol=1e-6)
        res = {}
        for m in (None, "vjp"):
            xi = x.clone().requires_grad_()
            y = gates[m].train()(xi)
            y.square().sum().backward()
            res[m] = [y, xi.grad] + [p.grad for p in gates[m].parameters()]
        for got, exp in zip(res["vjp"], res[None]):
            torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-6)


_STEM = {"mobilenet_v2": ("features_0", "c0"), "res2net50": ("conv1",),
         "bn_inception": ("conv1", "conv")}


class TestModality:
    @pytest.mark.parametrize("keep_rgb,width", [(False, 10), (True, 9)])
    @pytest.mark.parametrize("family", FAMILIES)
    def test_adapt_first_conv_is_jaxs(self, family, keep_rgb, width):
        """The stem weight of each family, bitwise the JAX function's
        kernel (in the torch layout); the other keys untouched."""
        kh = {"mobilenet_v2": 3, "res2net50": 7, "bn_inception": 7}[family]
        k = np.random.default_rng(3).standard_normal(
            (kh, kh, 3, 64)).astype(np.float32)
        path = ("base_model",) + _STEM[family] + ("kernel",)
        want = flatten_dict(j_adapt_first_conv(
            unflatten_dict({path: k}), width, keep_rgb=keep_rgb,
            conv_path=path))[path]
        key = modality.STEM_KEYS[family]
        other = torch.ones(2)
        sd = {key: torch.from_numpy(convert_tensor(k, key)), "x": other}
        got = modality.adapt_first_conv(sd, width, keep_rgb=keep_rgb,
                                        base_model=family)
        assert got["x"] is other and got[key].shape == (64, width, kh, kh)
        np.testing.assert_array_equal(
            got[key].numpy(), convert_tensor(np.asarray(want), key))

    @pytest.mark.parametrize("keep_rgb", [False, True])
    def test_rgb_diff_is_jaxs(self, keep_rgb):
        clip = np.random.default_rng(4).standard_normal(
            (2, 5, 6, 6, 3)).astype(np.float32)
        want = np.asarray(j_rgb_diff(jnp.asarray(clip), keep_rgb=keep_rgb))
        got = modality.rgb_diff(torch.from_numpy(clip).permute(0, 1, 4, 2, 3),
                                keep_rgb=keep_rgb)
        np.testing.assert_array_equal(got.permute(0, 1, 3, 4, 2).numpy(),
                                      want)

    def test_stack_flow_is_jaxs(self):
        u, v = np.random.default_rng(5).standard_normal(
            (2, 2, 3, 6, 6)).astype(np.float32)
        want = np.asarray(j_stack_flow(jnp.asarray(u), jnp.asarray(v)))
        got = modality.stack_flow(torch.from_numpy(u), torch.from_numpy(v))
        np.testing.assert_array_equal(got.permute(0, 1, 3, 4, 2).numpy(),
                                      want)


class TestBYOT:
    def test_forward_matches_jax(self):
        """All four exits' logits and features, one bottleneck a stage,
        2 images at 32^2."""
        model = JBYOTResNet(num_class=CLS, stage_sizes=RES2NET_STAGES)
        x = _x(1)[0, :2]
        flat = draw(jax.eval_shape(lambda r: model.init(
            r, jnp.zeros(x.shape), train=False),
            {"params": jax.random.key(0)}), seed=11)
        want = jax.jit(lambda v, xx: model.apply(v, xx, train=False))(
            unflatten_dict(flat), jnp.asarray(x))
        m = BYOTResNet(CLS, stage_sizes=RES2NET_STAGES, device="cpu")
        load_jax_variables(m, flat)
        with torch.no_grad():
            got = m(torch.from_numpy(x))
        assert len(got) == len(want) == 8
        for i, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=str(i))
