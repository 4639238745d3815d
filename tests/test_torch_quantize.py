"""Int8 inference on the CPU against the JAX package (``ehgr_tpu/ops/
quantize.py`` and the quantize branches of its ResNet and ACTION modules),
one counterpart for each case of ``tests/test_quantize.py``: the weight and
activation codes and scales (bitwise, ties at .5 rounding half to even on
both sides); ``QuantConv`` in ``'dynamic'`` and ``'static'`` (the int32
sums exact, the f32 outputs within 1e-6) at the four site geometries of a
ResNet block (3x3 stride 1 and 2, pad 1; 1x1 stride 1 and 2); ``'calib'``
scales within 1e-6 relative; ``'static'`` after calibration equal to
``'dynamic'``; the 36 int8 sites of a TSN + ACTION ResNet-50 at 16^2 and its
static logits against JAX's from the same carried ``act_scale``s (rtol
2e-3, atol 1e-4, the golden anchors' limits); the train path exactly the
float model's; a non-ResNet backbone raising; and ``ActionConv``'s opt-in
int8 wrapped conv.  The port's ``int8_conv`` (float activation in, the
quantize fused into the kernel) runs its plain version here (CPU tensors),
held bitwise to the composition it replaced (``quantize_codes``, then the
integer conv of the codes with the scale ``xs * ws``) and to JAX's ops at
ties, saturation and the smallest scale; ``chip_smoke.py`` holds the
kernel to it bitwise."""

from collections import OrderedDict

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as nn
from flax.traverse_util import flatten_dict

from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu.ops.action import ActionConv as JActionConv
from ehgr_tpu.ops.quantize import QuantConv as JQuantConv
from ehgr_tpu.ops.quantize import quantize_activation as j_qact
from ehgr_tpu.ops.quantize import quantize_weight as j_qweight
from ehgr_tpu_torch.models.convert import load_jax_variables, torch_key
from ehgr_tpu_torch.models.layers import Conv2d
from ehgr_tpu_torch.models.tsn import variant
from ehgr_tpu_torch.ops.action import ActionConv
from ehgr_tpu_torch.ops.kernels.int8_conv import (int8_conv_codes,
                                                  int8_conv_plain)
from ehgr_tpu_torch.ops.quantize import (MIN_SCALE, MODES, QuantConv,
                                         calibrate, dynamic_scale,
                                         quantize_activation,
                                         quantize_codes, quantize_weight,
                                         record_amax, sites)

from test_torch_train import single_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("single_thread")

# (kernel, stride, JAX padding) of the int8 sites of a bottleneck: conv2
# at stride 1 and 2 (explicit pad 1), conv3 and the downsample (1x1, SAME)
GEOMETRIES = {"3x3_s1": (3, 1, [(1, 1), (1, 1)]),
              "3x3_s2": (3, 2, [(1, 1), (1, 1)]),
              "1x1_s1": (1, 1, "SAME"), "1x1_s2": (1, 2, "SAME")}
CIN, COUT, HW = 32, 24, 9
TSN_KW = dict(num_class=7, num_segments=4, base_model="resnet50",
              temporal="action", partial_bn=False, dropout=0.0)


def _nchw(x):
    """NHWC numpy -> the port's channels_last ``[N, C, H, W]``."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _oihw(k):
    """A flax conv kernel ``[kh, kw, I, O]`` -> the torch weight."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(k).transpose(3, 2, 0, 1)))


def _port_conv(kernel, k, stride, mode):
    m = QuantConv(CIN, COUT, k, stride=stride, padding=k // 2,
                  quantize=mode, device="cpu").eval()
    with torch.no_grad():
        m.weight.copy_(_oihw(kernel))
    return m


class TestHelpers:
    def test_weight_codes_match_jax(self, rng):
        w = rng.standard_normal((3, 3, CIN, COUT)).astype(np.float32)
        wq_j, ws_j = j_qweight(jnp.asarray(w))
        wq, ws = quantize_weight(_oihw(w))
        assert wq.dtype == torch.int8 and wq.is_contiguous(
            memory_format=torch.channels_last)
        np.testing.assert_array_equal(wq.numpy(),
                                      np.asarray(wq_j).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(ws.numpy(), np.asarray(ws_j))

    @pytest.mark.parametrize("kind", ["normal", "ties", "near_ties"])
    def test_activation_codes_match_jax(self, rng, kind):
        """``ties``: max |x| = 127, so xs = 1 and x = k + 0.5 lands on a
        tie for every k: both sides round half to even.  ``near_ties``:
        xs = 0.37, and x is (k + 0.5) * xs rounded to f32 and its two
        neighbours, whose codes part where x / xs is not computed as JAX
        computes it (as x times 1 / xs, for one)."""
        if kind == "ties":
            x = np.arange(-127.0, 127.5, 0.5, dtype=np.float32)
            x = rng.permutation(np.resize(x, 2 * 6 * 6 * 16)).reshape(
                2, 6, 6, 16)
        elif kind == "near_ties":
            amax = np.float32(127 * 0.37)
            k = np.arange(-126, 126, dtype=np.float32)
            tie = ((k + np.float32(0.5)) * (amax / np.float32(127))).astype(
                np.float32)
            x = np.concatenate([[amax], tie, np.nextafter(tie, np.inf),
                                np.nextafter(tie, -np.inf)]).astype(
                                    np.float32)
            x = rng.permutation(np.resize(x, 2 * 6 * 6 * 16)).reshape(
                2, 6, 6, 16)
            x.reshape(-1)[0] = amax
        else:
            x = (rng.standard_normal((2, 6, 6, 16)) * 3).astype(np.float32)
        xq_j, xs_j = j_qact(jnp.asarray(x))
        xq, xs = quantize_activation(_nchw(x))
        got, want = xq.permute(0, 2, 3, 1).numpy(), np.asarray(xq_j)
        bad = np.argwhere(got != want)
        assert len(bad) == 0, [
            (x[tuple(i)], float(x[tuple(i)]) / float(xs_j), got[tuple(i)],
             want[tuple(i)]) for i in bad[:10]]
        assert xs.item() == float(xs_j)
        if kind == "ties":
            assert xs.item() == 1.0
            half = np.abs(x - np.trunc(x)) == 0.5
            np.testing.assert_array_equal(got[half] % 2, 0)


class TestQuantConv:
    @pytest.mark.parametrize("mode", ["dynamic", "static"])
    @pytest.mark.parametrize("geom", sorted(GEOMETRIES))
    def test_int32_sums_and_output_match_jax(self, rng, geom, mode):
        k, stride, pad = GEOMETRIES[geom]
        x = rng.standard_normal((2, HW, HW, CIN)).astype(np.float32)
        jm = JQuantConv(COUT, (k, k), strides=(stride, stride), padding=pad)
        v = jm.init(jax.random.key(0), jnp.asarray(x), mode="calib")
        scale = np.float32(np.abs(x).max() / 127.0 * 0.8)  # saturates some
        v = {"params": v["params"], "quant": {"act_scale": jnp.asarray(scale)}}
        want = np.asarray(jm.apply(v, jnp.asarray(x), mode=mode))
        pm = _port_conv(v["params"]["kernel"], k, stride, mode)
        pm.act_scale.fill_(float(scale))
        with torch.no_grad():
            got = pm(_nchw(x))
        # the int32 sums, each side from its own codes
        if mode == "static":
            xs_j = jnp.maximum(jnp.asarray(scale), 1e-12)
            xq_j = jnp.clip(jnp.round(jnp.asarray(x) / xs_j), -127,
                            127).astype(jnp.int8)
            xq = quantize_codes(_nchw(x), pm.act_scale)
        else:
            xq_j, _ = j_qact(jnp.asarray(x))
            xq, _ = quantize_activation(_nchw(x))
        wq_j, _ = j_qweight(v["params"]["kernel"])
        acc_j = jax.lax.conv_general_dilated(
            xq_j, wq_j, (stride, stride), pad,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        wq, _ = quantize_weight(pm.weight)
        acc = F.conv2d(xq.double(), wq.double(), stride=stride,
                       padding=k // 2).to(torch.int32)
        assert acc_j.dtype == jnp.int32
        np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(acc_j))
        g = got.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(g, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
        assert got.dtype == torch.float32 and got.is_contiguous(
            memory_format=torch.channels_last)

    def test_calib_scale_matches_jax(self, rng):
        """Two calibration calls: the running maximum of max|x| / 127."""
        xs = [(rng.standard_normal((2, HW, HW, CIN)) * s).astype(np.float32)
              for s in (1.0, 2.5)]
        jm = JQuantConv(COUT, (3, 3), padding=[(1, 1), (1, 1)])
        v = jm.init(jax.random.key(1), jnp.asarray(xs[0]), mode="calib")
        pm = _port_conv(v["params"]["kernel"], 3, 1, "calib")
        for x in xs:
            y_j, upd = jm.apply(v, jnp.asarray(x), mode="calib",
                                mutable=["quant"])
            v = {**v, "quant": upd["quant"]}
            with torch.no_grad():
                y = pm(_nchw(x))
            np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(y_j), rtol=1e-5, atol=1e-5)
        want = float(v["quant"]["act_scale"])
        assert want > 0
        np.testing.assert_allclose(pm.act_scale.item(), want, rtol=1e-6)

    def test_static_after_calibration_equals_dynamic(self, rng):
        x = _nchw(rng.standard_normal((2, 8, 8, 64)).astype(np.float32))
        m = QuantConv(64, 64, 3, padding=1, quantize="static",
                      device="cpu").eval()
        calibrate(m, [x])
        assert m.act_scale.item() > 0 and m.quantize == "static"
        with torch.no_grad():
            got = m(x)
            m.quantize = "dynamic"
            want = m(x)
        np.testing.assert_array_equal(got.numpy(), want.numpy())

    def test_float_path_equals_conv2d(self, rng):
        """Mode ``'float'`` at eval is the port's ``Conv2d`` (stride 2,
        pad 1), bitwise; as is every mode but ``'calib'`` in training."""
        x = _nchw(rng.standard_normal((2, 8, 8, 16)).astype(np.float32))
        conv = Conv2d(16, 24, 3, stride=2, padding=1, bias=False)
        for mode in MODES:
            q = QuantConv(16, 24, 3, stride=2, padding=1, quantize=mode,
                          device="cpu")
            q.load_state_dict(conv.state_dict())
            with torch.no_grad():
                if mode == "float":
                    np.testing.assert_array_equal(q.eval()(x).numpy(),
                                                  conv(x).numpy())
                if mode != "calib":
                    np.testing.assert_array_equal(q.train()(x).numpy(),
                                                  conv(x).numpy())

    def test_tree_unchanged(self, rng):
        """Same key and shape as ``Conv2d``; ``act_scale`` is in no
        ``state_dict`` and no parameter list; a strict load from a float
        conv works both ways."""
        a = Conv2d(16, 24, 3, padding=1, bias=False)
        b = QuantConv(16, 24, 3, padding=1, quantize="static", device="cpu")
        assert list(b.state_dict()) == list(a.state_dict()) == ["weight"]
        assert [n for n, _ in b.named_parameters()] == ["weight"]
        assert "act_scale" in dict(b.named_buffers())
        b.load_state_dict(a.state_dict(), strict=True)
        a.load_state_dict(b.state_dict(), strict=True)


def jax_site_inputs(model, v, x):
    """``model.apply`` (jitted) with the input of every ``QuantConv`` call
    recorded: (logits, {torch name of the site: its input, NHWC})."""
    def run(vv, xx):
        rec = {}

        def record(next_fun, args, kwargs, ctx):
            if isinstance(ctx.module, JQuantConv):
                rec[torch_key(ctx.module.path + ("x",))[:-2]] = args[0]
            return next_fun(*args, **kwargs)
        with nn.intercept_methods(record):
            out = model.apply(vv, xx, train=False)
        return out, rec
    out, rec = jax.jit(run)(v, jnp.asarray(x))
    return np.asarray(out), {k: np.asarray(a) for k, a in rec.items()}


@pytest.fixture(scope="module")
def jax_static_tsn():
    """JAX's calibrated static TSN + ACTION ResNet-50 at 16^2: (input,
    the flat variables with the ``quant`` collection, static logits, each
    site's input)."""
    x = np.random.default_rng(0).standard_normal(
        (2, 4, 16, 16, 3)).astype(np.float32)
    calib = j_variant("tsn", quantize="calib", **TSN_KW)
    static = j_variant("tsn", quantize="static", **TSN_KW)
    v = jax.jit(lambda r, xx: calib.init(r, xx, train=False))(
        jax.random.key(0), jnp.asarray(x))
    _, upd = jax.jit(lambda vv, xx: calib.apply(
        vv, xx, train=False, mutable=["quant"]))(v, jnp.asarray(x))
    v = {**v, "quant": upd["quant"]}
    logits, inputs = jax_site_inputs(static, v, x)
    return x, {k: np.asarray(a) for k, a in flatten_dict(v).items()}, \
        logits, inputs


def record_site_inputs(model):
    """Forward pre-hooks on every int8 site of ``model``: returns (the site
    names in the order the model runs them, {name: [its input at each
    forward, NHWC numpy]})."""
    names = [n for n, m in model.named_modules() if m in sites(model)]
    seen = {n: [] for n in names}
    modules = dict(model.named_modules())
    for n in names:
        modules[n].register_forward_pre_hook(
            lambda mod, i, n=n: seen[n].append(
                i[0].detach().float().permute(0, 2, 3, 1).numpy().copy()))
    return names, seen


def code_splits(order, got, want, scales, want_scales, t):
    """For each clip (``t`` frames) of the site inputs ``got`` (the
    port's, quantized with ``scales``) and ``want`` (JAX's, with
    ``want_scales``), NHWC by site name: None where the two sides' int8
    codes agree at every site, else the first site (in ``order``) where
    they part.  Asserts that each such split is a tie of
    rounding: every split element's two ratios ``x / xs`` lie on either
    side of, or on, the same half-integer, and the site's inputs of that
    clip agree within 1e-5 of their largest value (rounding, not a
    different computation)."""
    out = []
    for clip in range(next(iter(want.values())).shape[0] // t):
        frames = slice(clip * t, (clip + 1) * t)
        split = None
        for name in order:
            rg = got[name][frames] / np.float32(max(scales[name], 1e-12))
            rw = want[name][frames] / np.float32(
                max(want_scales[name], 1e-12))
            cut = np.clip(np.round(rg), -127, 127) != \
                np.clip(np.round(rw), -127, 127)
            if cut.any():
                lo = np.minimum(rg[cut], rw[cut])
                hi = np.maximum(rg[cut], rw[cut])
                assert (np.floor(hi - 0.5) + 0.5 >= lo).all(), (name, clip)
                xg, xw = got[name][frames], want[name][frames]
                assert np.abs(xg - xw).max() <= \
                    1e-5 * np.abs(xw).max(), (name, clip)
                split = name
                break
        out.append(split)
    return out


class TestQuantizedTSN:
    def test_sites_and_static_logits_match_jax(self, jax_static_tsn):
        """36 sites (16 conv2, 16 conv3, 4 downsample: the ACTION conv1s
        stay float), each with JAX's carried scale; then the static logits
        of every clip whose codes are JAX's at all 36 sites, within rtol
        2e-3 and atol 1e-4.  The float activations of the two packages
        agree to rounding (~1e-7 relative), so now and then an element
        lies on a tie of ``x / xs`` (k + 0.5) within that rounding and the
        two sides take neighbouring codes; from there on that clip's
        activations part (the random network amplifies one code step to a
        few percent of its logits).  For such a clip the test shows that
        the first split is a tie: every split element's two ratios lie on
        either side of, or on, a half-integer, and the site's inputs agree
        within 1e-5 of their largest value.  At least one clip must be
        free of splits."""
        x, flat, want, want_in = jax_static_tsn
        scales = {torch_key(p[1:])[:-len(".act_scale")]: float(a)
                  for p, a in flat.items() if p[0] == "quant"}
        m = variant("tsn", quantize="static", device="cpu", **TSN_KW)
        found = dict(m.named_modules())
        names = [n for n, s in found.items() if s in sites(m)]
        assert len(names) == 36
        assert sorted(names) == sorted(scales) == sorted(want_in)
        assert sorted({n.split(".")[-1] for n in names}) == \
            ["0", "conv2", "conv3"]
        load_jax_variables(m, flat)
        assert all(found[n].act_scale.item() == scales[n] > 0
                   for n in names)
        order, got_in = record_site_inputs(m)
        assert order == names
        with torch.no_grad():
            got = m(torch.from_numpy(x)).numpy()
        splits = code_splits(order, {n: v[0] for n, v in got_in.items()},
                             want_in, scales, scales, TSN_KW["num_segments"])
        clean = 0
        for clip, split in enumerate(splits):
            if split is None:
                clean += 1
                np.testing.assert_allclose(got[clip], want[clip],
                                           rtol=2e-3, atol=1e-4)
        assert clean >= 1

    def test_port_calibration_matches_jax(self, jax_static_tsn):
        """``calibrate`` on the same input gives JAX's 36 scales (the float
        activations agree to ~1e-6 relative, their maxima too)."""
        x, flat, _, _ = jax_static_tsn
        m = variant("tsn", quantize="static", device="cpu", **TSN_KW)
        load_jax_variables(m, {p: a for p, a in flat.items()
                               if p[0] != "quant"})
        calibrate(m, [torch.from_numpy(x)])
        got = {n + ".act_scale": s.act_scale.item()
               for n, s in m.named_modules() if s in sites(m)}
        want = {torch_key(p[1:]): float(a) for p, a in flat.items()
                if p[0] == "quant"}
        assert sorted(got) == sorted(want)
        np.testing.assert_allclose([got[k] for k in sorted(want)],
                                   [want[k] for k in sorted(want)],
                                   rtol=1e-5)

    @pytest.mark.parametrize("quantize", [True, "static"])
    def test_train_path_is_exact_float(self, rng, quantize):
        """In training every site takes the float conv: the quantized
        model's train forward is bitwise the float model's."""
        kw = dict(TSN_KW, temporal="none")
        x = torch.from_numpy(rng.standard_normal((2, 4, 16, 16, 3))
                             .astype(np.float32))
        base = variant("tsn", device="cpu", **kw).train()
        quant = variant("tsn", quantize=quantize, device="cpu", **kw)
        quant.load_state_dict(base.state_dict())
        quant.train()
        assert len(sites(quant)) == 52     # conv1 too, with no ACTION
        with torch.no_grad():
            np.testing.assert_array_equal(quant(x).numpy(),
                                          base(x).numpy())

    def test_non_resnet_rejected(self):
        with pytest.raises(ValueError, match="resnet-only"):
            variant("tsn", num_class=7, num_segments=4,
                    base_model="mobilenet_v2", quantize=True, device="cpu")


class TestActionOptIn:
    @pytest.mark.parametrize("fused", [None, "prologue"])
    def test_action_wrapped_conv_int8_matches_jax(self, rng, fused):
        """``ActionConv(quantize=...)`` at eval, the plain and prologue
        formulations: JAX's calibrated scale of the gated sum (1e-5
        relative; the two gated sums round apart at ~1e-7), and its static
        output, where an element of the gated sum may round to the
        neighbouring code on the other side: at most a few outputs a tensor
        move, each by at most xs * max|w_net| a flipped code."""
        x = rng.standard_normal((8, 8, 8, 32)).astype(np.float32)
        calib = JActionConv(16, n_segment=4, quantize="calib")
        static = JActionConv(16, n_segment=4, quantize="static")
        v = calib.init(jax.random.key(0), jnp.asarray(x), train=False)
        _, upd = calib.apply(v, jnp.asarray(x), train=False,
                             mutable=["quant"])
        v = {**v, "quant": upd["quant"]}
        want = np.asarray(static.apply(v, jnp.asarray(x), train=False))
        flat = {("params", "conv1") + p[1:] if p[0] == "params" else
                (p[0], "conv1") + p[1:]: np.asarray(a)
                for p, a in flatten_dict(v).items()}
        m = torch.nn.Sequential(OrderedDict(conv1=ActionConv(
            32, 16, 4, fused=fused, quantize="calib", bn_frozen=False,
            device="cpu"))).eval()
        load_jax_variables(m, {p: a for p, a in flat.items()
                               if p[0] != "quant"})
        calibrate(m, [_nchw(x)])
        xs = float(v["quant"]["act_scale"])
        np.testing.assert_allclose(m.conv1.act_scale.item(), xs, rtol=1e-5)
        m.conv1.quantize = "static"
        m.conv1.act_scale.fill_(xs)
        with torch.no_grad():
            got = m.conv1(_nchw(x).contiguous(
                memory_format=torch.channels_last)).permute(0, 2, 3, 1)
        step = xs * np.abs(np.asarray(
            v["params"]["net"]["kernel"])).max()
        diff = np.abs(got.numpy() - want)
        assert diff.max() <= 2 * step, (diff.max(), step)
        assert (diff > 1e-5 * np.abs(want).max()).sum() <= 16
        assert m.conv1.quantize == "static"

    def test_mega_and_training_ignore_it(self, rng):
        x = _nchw(rng.standard_normal((8, 8, 8, 32)).astype(np.float32))
        base = ActionConv(32, 16, 4, fused="mega", device="cpu").eval()
        q = ActionConv(32, 16, 4, fused="mega", quantize="static",
                       device="cpu").eval()
        q.load_state_dict(base.state_dict())
        with torch.no_grad():
            np.testing.assert_array_equal(q(x).numpy(), base(x).numpy())
            q.mode = "none"
            base.mode = "none"
            q.train()
            base.train()
            np.testing.assert_array_equal(q(x).numpy(), base(x).numpy())


def test_plain_int8_conv_is_the_integer_conv(rng):
    """``int8_conv_codes``, the integer core of ``int8_conv_plain``: the
    float64 conv of the codes is the exact integer sum (checked against an
    int64 sum by taps), then JAX's epilogue, in f32 and bf16."""
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 32, 7, 7),
                                       dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (16, 32, 3, 3),
                                       dtype=np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, 16).astype(np.float32))
    xp = F.pad(xq.long(), (1, 1, 1, 1))
    acc = torch.zeros(2, 16, 4, 4, dtype=torch.long)
    for i in range(3):
        for j in range(3):
            patch = xp[:, :, i:i + 7:2, j:j + 7:2]          # stride 2
            acc += torch.einsum("nchw,oc->nohw", patch, wq[:, :, i, j].long())
    for dtype in (torch.float32, torch.bfloat16):
        got = int8_conv_codes(xq, wq, scale, 2, 1, dtype)
        want = (acc.to(torch.int32).float() * scale[:, None, None]).to(dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.float().numpy())


def _fused_case(rng, kind, dname):
    """Activations ``[2, 32, 7, 7]`` (in ``dname``, the values the model
    would hand over) and their scale for one case of the fused plain
    version: ``normal`` (xs = max|x| / 127); ``ties`` (xs = 2^-4, and half
    the elements planted at exactly (k + 0.5) * xs, k in [-127, 126], so
    x / xs is a tie); ``saturating`` (xs = 0.3 max|x| / 127, with +-127.5
    xs, +-128 xs and +-1e30 planted); ``min_scale`` (xs = MIN_SCALE, the
    values a few hundred MIN_SCALE wide, so most codes saturate and a few
    do not)."""
    x = rng.standard_normal((2, 7, 7, 32)).astype(np.float32) * 2
    flat = x.reshape(-1)
    if kind == "ties":
        xs = np.float32(2.0 ** -4)
        k = rng.integers(-127, 127, flat.size // 2).astype(np.float32)
        flat[rng.permutation(flat.size)[:flat.size // 2]] = (k + 0.5) * xs
    elif kind == "saturating":
        xs = np.float32(np.abs(x).max() / 127 * 0.3)
        planted = np.float32([127.5, -127.5, 128, -128]) * xs
        flat[:8] = np.concatenate([planted, [1e30, -1e30, 127 * xs,
                                             -127 * xs]])
    elif kind == "min_scale":
        xs = np.float32(MIN_SCALE)
        x *= np.float32(100 * MIN_SCALE)
    x = _nchw(x).to(getattr(torch, dname))
    if kind == "normal":
        xs = np.float32(x.float().abs().max().item()) / np.float32(127)
    return x, torch.tensor(np.float32(xs))


@pytest.mark.parametrize("kind", ["normal", "ties", "saturating",
                                  "min_scale"])
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_fused_plain_is_the_codes_composition(rng, dname, geom, kind):
    """``int8_conv_plain(x, xs, wq, ws)``, the plain version of the fused
    kernel, is bitwise what the int8 sites computed before the quantize
    moved into the kernel: ``quantize_codes(x, xs)``, then the integer conv
    of the codes with the scale ``xs * ws`` (``int8_conv_codes``), in
    ``x``'s dtype; and bitwise JAX's ops in its order
    (``ehgr_tpu/ops/quantize.py:117-125``, run op by op), codes and output,
    at 1x1 and 3x3, stride 1 and 2, with ties, saturation and MIN_SCALE."""
    k, stride, pad = GEOMETRIES[geom]
    x, xs = _fused_case(rng, kind, dname)
    w = rng.standard_normal((k, k, CIN, COUT)).astype(np.float32)
    wq, ws = quantize_weight(_oihw(w))
    got = int8_conv_plain(x, xs, wq, ws, stride, k // 2)
    xq = quantize_codes(x, xs)
    want = int8_conv_codes(xq, wq, xs * ws, stride, k // 2, x.dtype)
    assert got.dtype == x.dtype and got.is_contiguous(
        memory_format=torch.channels_last)
    assert torch.equal(got, want)
    jx = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy()).astype(
        jnp.bfloat16 if dname == "bfloat16" else jnp.float32)
    jxs = jnp.asarray(xs.numpy())
    jxq = jnp.clip(jnp.round(jx.astype(jnp.float32) / jxs), -127,
                   127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jxq))
    if kind == "ties":
        half = np.abs(np.asarray(jx.astype(jnp.float32) / jxs) % 1) == 0.5
        assert half.sum() > 0
        np.testing.assert_array_equal(np.asarray(jxq)[half] % 2, 0)
    jwq = jnp.asarray(wq.permute(2, 3, 1, 0).numpy())
    acc = jax.lax.conv_general_dilated(
        jxq, jwq, (stride, stride), pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    jy = (acc.astype(jnp.float32) * (jxs * jnp.asarray(ws.numpy()))
          ).astype(jx.dtype)
    np.testing.assert_array_equal(
        got.permute(0, 2, 3, 1).float().numpy(),
        np.asarray(jy.astype(jnp.float32)))


def _bf16_values(kind):
    """bf16 tensors of ``kind``: every finite bit pattern, the subnormals
    and zeros, the negatives, or the two zeros."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    finite = bits[torch.isfinite(bits)]
    if kind == "subnormals_and_zeros":
        return finite[finite.float().abs() < 2.0 ** -126]
    if kind == "negatives":
        return finite[finite.float() < 0]
    if kind == "signed_zeros":
        return finite[finite.float() == 0]
    return finite


@pytest.mark.parametrize("kind", ["all_finite", "subnormals_and_zeros",
                                  "negatives", "signed_zeros"])
def test_bf16_amax_is_the_f32_amax(rng, kind):
    """``dynamic_scale`` and ``record_amax`` take max|x| in x's own dtype
    (no f32 copy); on bf16 that is bitwise the f32 form ``x.float().abs()
    .amax()``, over negatives, subnormals and +-0, since abs, max and the
    widening are exact."""
    v = _bf16_values(kind)
    x = v[torch.from_numpy(rng.permutation(v.numel()))].reshape(1, -1, 1, 1)
    ref = x.float().abs().amax() / 127.0
    assert torch.equal(dynamic_scale(x), torch.clamp_min(ref, MIN_SCALE))
    scale = torch.zeros(())
    record_amax(scale, x)
    assert scale.dtype == torch.float32 and torch.equal(scale, ref)
    if kind == "signed_zeros":
        assert x.numel() == 2 and ref.item() == 0.0


def test_trainers_train_float():
    """``--quantize static`` reaches the config, but ``build_model`` (the
    trainers' model factory, ``train/loop.py``) leaves it out, as the JAX
    factory does: the trained model has no int8 site."""
    from ehgr_tpu_torch.configs import config_from_args
    from ehgr_tpu_torch.models.factory import build_model

    cfg = config_from_args(["--preset", "ego_mtmm", "--quantize", "static",
                            "--crop_size", "32"])
    assert cfg.model.quantize == "static"
    model = build_model(cfg.model, device="cpu")
    assert sites(model) == []
    assert sites(build_model(cfg.model, device="cpu",
                             quantize=cfg.model.quantize)) != []
