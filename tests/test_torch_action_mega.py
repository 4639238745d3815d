"""Port parity on the CPU for the ACTION site: the plain versions of the
``action_stats`` / ``action_apply`` kernels against the JAX Pallas kernels
(interpret mode), the wrappers' guards, and the port's ``ActionConv`` in
modes ``None`` and ``'mega'`` against JAX ``ActionConv`` in both modes with
the same weights.  fp32 throughout; rtol = atol = 1e-4 as in
``tests/test_action_mega.py`` (the sums run in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from ehgr_tpu.ops.action import ActionConv as JActionConv
from ehgr_tpu.ops.action import ActionGate as JActionGate
from ehgr_tpu.ops.action import TSMConv as JTSMConv
from ehgr_tpu.ops.pallas import action_mega as jmega
from ehgr_tpu_torch.models.convert import state_dict_from_jax
from ehgr_tpu_torch.ops.action import ActionConv, ActionGate, TSMConv
from ehgr_tpu_torch.ops.kernels import action_mega as mega
from ehgr_tpu_torch.ops.kernels import build

N, T, H, W, C = 2, 4, 8, 8, 32
CR, F = C // 16, 16
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(t):
    return t.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _stats_inputs(rng, n, t, s, c):
    return (rng.standard_normal((n, t, s, c)).astype(np.float32),
            rng.standard_normal((3, c)).astype(np.float32),
            rng.standard_normal((c, c // 16)).astype(np.float32))


def _apply_inputs(rng, n, t, s, c, f):
    return (rng.standard_normal((n, t, s, c)).astype(np.float32),
            rng.standard_normal((3, c)).astype(np.float32),
            rng.uniform(0, 1, (n, t, s, 1)).astype(np.float32),
            rng.uniform(3, 5, (n, t, c)).astype(np.float32),
            rng.standard_normal((c, f)).astype(np.float32))


class TestPlainVersusPallas:
    @pytest.mark.parametrize("n,t,s,c", [(N, T, H * W, C), (1, 4, 1000, 128)])
    def test_stats(self, rng, n, t, s, c):
        """(1, 4, 1000, 128): an S the Pallas kernel tiles with a masked
        partial block (tests/test_action_mega.py)."""
        args = _stats_inputs(rng, n, t, s, c)
        want = jmega.action_stats(*map(jnp.asarray, args), interpret=True)
        got = mega.action_stats_plain(*map(_t, args))
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)

    @pytest.mark.parametrize("n,t,s,c,f", [(N, T, H * W, C, F),
                                           (1, 4, 1000, 128, 8)])
    def test_apply(self, rng, n, t, s, c, f):
        args = _apply_inputs(rng, n, t, s, c, f)
        want = jmega.action_apply(*map(jnp.asarray, args), interpret=True)
        got = mega.action_apply_plain(*map(_t, args))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                                   atol=1e-3)

    def test_ste_stencil(self, rng):
        mc = rng.standard_normal((N, T, H, W)).astype(np.float32)
        k = rng.standard_normal((3, 3, 3)).astype(np.float32)
        want = jmega.ste_stencil(jnp.asarray(mc), jnp.asarray(k))
        np.testing.assert_allclose(_np(mega.ste_stencil(_t(mc), _t(k))),
                                   np.asarray(want), **TOL)


class TestWrappers:
    def test_cpu_takes_plain_version_without_counting(self, rng):
        args = list(map(_t, _stats_inputs(rng, N, T, H * W, C)))
        before = mega.action_stats.launches
        for g, w in zip(mega.action_stats(*args),
                        mega.action_stats_plain(*args)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        aargs = list(map(_t, _apply_inputs(rng, N, T, H * W, C, F)))
        torch.testing.assert_close(mega.action_apply(*aargs),
                                   mega.action_apply_plain(*aargs),
                                   rtol=0, atol=0)
        assert mega.action_stats.launches == before

    def test_bf16_plain_computes_in_f32(self, rng):
        args = [v.to(torch.bfloat16)
                for v in map(_t, _stats_inputs(rng, N, T, H * W, C))]
        got = mega.action_stats(*args)
        want = mega.action_stats_plain(*[v.float() for v in args])
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            torch.testing.assert_close(g, w.to(torch.bfloat16))

    def test_refuses_non_contiguous(self, rng):
        x4, w, wp3 = map(_t, _stats_inputs(rng, N, T, H * W, C))
        x4 = x4.transpose(1, 2).contiguous().transpose(1, 2)
        with pytest.raises(ValueError, match="not contiguous"):
            mega.action_stats(x4, w, wp3)

    @pytest.mark.parametrize("bad", ["dtype", "mixed", "shape"])
    def test_refuses_bad_operands(self, rng, bad):
        x4, w, g1, gch, wn = map(_t, _apply_inputs(rng, N, T, H * W, C, F))
        if bad == "dtype":
            x4, w, g1, gch, wn = (v.half() for v in (x4, w, g1, gch, wn))
        elif bad == "mixed":
            gch = gch.double()
        else:
            g1 = g1[:, :, :-1]
        with pytest.raises((TypeError, ValueError)):
            mega.action_apply(x4, w, g1, gch, wn)

    def test_library_name_follows_the_source(self):
        """The build is keyed by a hash of source and flags, under the
        ignored build directory; nothing is built at import."""
        path = build.library_path("action_mega")
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith("libaction_mega-")
        assert "ehgr_action_stats" in build.SIGNATURES["action_mega"]


def _randomized(variables, rng):
    """JAX ActionConv variables with every leaf redrawn (shift taps off the
    TSM pattern, BN statistics off (0, 1)) so each weight shows."""
    flat = flatten_dict(jax.device_get(variables))
    out = {}
    for path, leaf in flat.items():
        if path[-1] == "var":
            v = rng.uniform(0.5, 2.0, leaf.shape)
        elif path[-1] in ("mean", "bias"):
            v = rng.standard_normal(leaf.shape) * 0.1
        elif path[-1] == "scale":
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif path[-1] == "shift_w":
            v = rng.standard_normal(leaf.shape) * 0.5
        else:
            v = np.asarray(leaf)
        out[path] = np.asarray(v, np.float32)
    return out


def _pair(jmodule, tmodule, rng):
    x = rng.standard_normal((N * T, H, W, C)).astype(np.float32)
    v = jmodule.init(jax.random.key(0), jnp.asarray(x), train=False)
    flat = _randomized(v, rng)
    tmodule.load_state_dict(state_dict_from_jax(flat), strict=True)
    tmodule.eval()
    xt = _t(x).permute(0, 3, 1, 2)                 # channels_last view
    return x, unflatten_dict(flat), xt


class TestActionConv:
    @pytest.mark.parametrize("jmode", [None, "mega"])
    @pytest.mark.parametrize("tmode", [None, "mega", "vjp"])
    def test_matches_jax(self, rng, jmode, tmode):
        j = JActionConv(features=F, n_segment=T, fused=jmode)
        tm = ActionConv(C, F, T, fused=tmode, device="cpu")
        x, v, xt = _pair(j, tm, rng)
        want = np.asarray(j.apply(v, jnp.asarray(x), train=False))
        with torch.no_grad():
            got = tm(xt).permute(0, 2, 3, 1)
        np.testing.assert_allclose(_np(got), want, **TOL)

    def test_action_gate_matches_jax(self, rng):
        j = JActionGate(n_segment=T)
        tm = ActionGate(C, T, device="cpu")
        x, v, xt = _pair(j, tm, rng)
        want = np.asarray(j.apply(v, jnp.asarray(x), train=False))
        with torch.no_grad():
            got = tm(xt).permute(0, 2, 3, 1)
        np.testing.assert_allclose(_np(got), want, **TOL)

    def test_tsm_conv_matches_jax(self, rng):
        j = JTSMConv(features=F, n_segment=T)
        tm = TSMConv(C, F, T, device="cpu")
        x, v, xt = _pair(j, tm, rng)
        want = np.asarray(j.apply(v, jnp.asarray(x), train=False))
        with torch.no_grad():
            got = tm(xt).permute(0, 2, 3, 1)
        np.testing.assert_allclose(_np(got), want, **TOL)

    def test_mega_takes_kernels_and_plain_does_not(self, monkeypatch, rng):
        calls = []
        for name in ("action_stats", "action_apply"):
            fn = getattr(mega, name)
            monkeypatch.setattr(
                "ehgr_tpu_torch.ops.action." + name,
                lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
        x = torch.randn(N * T, C, H, W).contiguous(
            memory_format=torch.channels_last)
        for mode in (None, "mega"):
            ActionConv(C, F, T, fused=mode, device="cpu").eval()(x)
        assert calls == ["action_stats", "action_apply"]

    def test_unported_modes_raise(self):
        """'prologue' is not ported and an unknown mode is refused; training
        is ported (tests/test_torch_action_vjp.py)."""
        with pytest.raises(NotImplementedError, match="prologue"):
            ActionConv(C, F, T, fused="prologue", device="cpu")
        with pytest.raises(ValueError, match="unknown"):
            ActionConv(C, F, T, fused="fast", device="cpu")
