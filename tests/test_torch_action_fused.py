"""Port parity on the CPU for the ACTION prologue (kernel 3): the plain
version of ``action_prologue`` against the JAX ``action_fused_prologue``
(interpret mode), the wrapper's guards, and the port's
``ActionConv(fused='prologue')`` at eval against the JAX ``ActionConv`` in
the same mode (its kernel entry patched to interpret mode, as
``tests/test_action_fused.py`` runs it), with the same weights; in training
the mode is plain autograd.  fp32; rtol = atol = 1e-4, the limit of
``tests/test_torch_action_mega.py`` (the sums run in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ehgr_tpu.ops.pallas.action_fused as jfused
from ehgr_tpu.ops.action import ActionConv as JActionConv
from ehgr_tpu.ops.action import ActionGate as JActionGate
from ehgr_tpu_torch.ops.action import ActionConv
from ehgr_tpu_torch.ops.kernels import action_fused as fused
from ehgr_tpu_torch.ops.kernels import action_mega as mega

from test_torch_action_mega import _launch_on_cuda, _np, _pair, _t

N, T, H, W, C = 2, 4, 8, 8, 32
F = 16
TOL = dict(rtol=1e-4, atol=1e-4)
OUTPUTS = ("x_shift", "mc", "pool", "x3")


def _inputs(rng, n, t, h, w, c):
    return (rng.standard_normal((n, t, h, w, c)).astype(np.float32),
            rng.standard_normal((3, c)).astype(np.float32),
            rng.standard_normal((c, c // 16)).astype(np.float32))


@pytest.fixture
def interpret(monkeypatch):
    """The JAX ``ActionConv``'s prologue kernel in interpret mode."""
    orig = jfused.action_fused_prologue
    monkeypatch.setattr(jfused, "action_fused_prologue",
                        lambda *a, **k: orig(*a, interpret=True))


class TestPlainVersusPallas:
    @pytest.mark.parametrize("n,t,h,w,c", [
        (N, T, H, W, C),
        (1, 4, 16, 16, 512),    # two row tiles: pool summed across tiles
        (1, 3, 5, 7, 48),       # odd T, H, W
    ])
    def test_outputs(self, rng, n, t, h, w, c):
        x5, ws, wp3 = _inputs(rng, n, t, h, w, c)
        want = jfused.action_fused_prologue(
            jnp.asarray(x5), jnp.asarray(ws), jnp.asarray(wp3),
            interpret=True)
        got = fused.action_prologue_plain(
            _t(x5.reshape(n, t, h * w, c)), _t(ws), _t(wp3))
        shapes = ((n, t, h, w, c), (n, t, h, w, 1), (n, t, c),
                  (n, t, h, w, c // 16))
        for name, g, wv, shape in zip(OUTPUTS, got, want, shapes):
            assert np.asarray(wv).shape == shape
            np.testing.assert_allclose(_np(g).reshape(shape), np.asarray(wv),
                                       err_msg=name, **TOL)

    def test_stats_outputs_are_action_stats(self, rng):
        """The prologue is ``action_stats`` plus ``x_shift``."""
        x5, ws, wp3 = _inputs(rng, N, T, H, W, C)
        args = (_t(x5.reshape(N, T, H * W, C)), _t(ws), _t(wp3))
        got = fused.action_prologue_plain(*args)
        for g, w in zip(got[1:], mega.action_stats_plain(*args)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


class TestWrapper:
    def _args(self, rng):
        x5, ws, wp3 = _inputs(rng, N, T, H, W, C)
        return [_t(x5.reshape(N, T, H * W, C)), _t(ws), _t(wp3)]

    def test_cpu_takes_plain_version_without_counting(self, rng):
        args = self._args(rng)
        before = fused.action_prologue.launches
        for g, w in zip(fused.action_prologue(*args),
                        fused.action_prologue_plain(*args)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert fused.action_prologue.launches == before

    def test_bf16_plain_computes_in_f32(self, rng):
        args = [v.to(torch.bfloat16) for v in self._args(rng)]
        got = fused.action_prologue(*args)
        want = fused.action_prologue_plain(*[v.float() for v in args])
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            torch.testing.assert_close(g, w.to(torch.bfloat16))

    @pytest.mark.parametrize("dtype,offset,cr,want", [
        (torch.bfloat16, 0, 4, "window"), (torch.bfloat16, 1, 4, "fma_sweep"),
        (torch.bfloat16, 0, 6, "fma_sweep"), (torch.float32, 0, 4,
                                              "fma_sweep")])
    def test_launches_the_route_and_counts_it(self, monkeypatch, dtype,
                                              offset, cr, want):
        """On a CUDA tensor ``action_prologue`` launches the entry point of
        ``action_stats``' route (``_stats_route``: a misaligned ``x4`` view
        or Cr % 4 != 0 leaves the window kernel) and counts it."""
        calls, moved = _launch_on_cuda(monkeypatch, fused.action_prologue,
                                       dtype, offset, cr=cr)
        assert calls == [("action_stats", "ehgr_action_prologue_window")
                         if want == "window"
                         else ("action_mega", "ehgr_action_prologue")]
        assert moved == {k: int(k == want) for k in moved}

    @pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
    def test_refuses_bad_operands(self, rng, bad):
        x4, ws, wp3 = self._args(rng)
        if bad == "dtype":
            wp3 = wp3.double()
        elif bad == "shape":
            ws = ws[:, :-1]
        else:
            x4 = x4.transpose(1, 2).contiguous().transpose(1, 2)
        with pytest.raises((TypeError, ValueError)):
            fused.action_prologue(x4, ws, wp3)


class TestActionConv:
    @pytest.mark.parametrize("jmode", [None, "prologue"])
    def test_matches_jax(self, rng, interpret, jmode):
        j = JActionConv(features=F, n_segment=T, fused=jmode)
        tm = ActionConv(C, F, T, fused="prologue", device="cpu")
        x, v, xt = _pair(j, tm, rng)
        want = np.asarray(j.apply(v, jnp.asarray(x), train=False))
        with torch.no_grad():
            got = tm(xt).permute(0, 2, 3, 1)
        np.testing.assert_allclose(_np(got), want, **TOL)

    def test_true_is_prologue(self, rng, interpret):
        """``fused=True`` names the prologue mode, as in the JAX module."""
        j = JActionConv(features=F, n_segment=T, fused=True)
        tm = ActionConv(C, F, T, fused=True, device="cpu")
        assert tm.mode == "prologue"
        x, v, xt = _pair(j, tm, rng)
        want = np.asarray(j.apply(v, jnp.asarray(x), train=False))
        with torch.no_grad():
            got = tm(xt).permute(0, 2, 3, 1)
        np.testing.assert_allclose(_np(got), want, **TOL)

    def test_action_gate_matches_jax(self, rng, interpret):
        j = JActionGate(n_segment=T).clone(fused="prologue")
        tm = ActionConv(C, 0, T, fused="prologue", bn_frozen=False,
                        device="cpu")
        x, v, xt = _pair(j, tm, rng)
        want = np.asarray(j.apply(v, jnp.asarray(x), train=False))
        with torch.no_grad():
            got = tm(xt).permute(0, 2, 3, 1)
        np.testing.assert_allclose(_np(got), want, **TOL)

    def test_eval_takes_the_kernel_once(self, monkeypatch):
        calls = []
        for name in ("action_prologue", "action_stats", "action_apply"):
            fn = getattr(fused if name == "action_prologue" else mega, name)
            monkeypatch.setattr(
                "ehgr_tpu_torch.ops.action." + name,
                lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
        x = torch.randn(N * T, C, H, W).contiguous(
            memory_format=torch.channels_last)
        m = ActionConv(C, F, T, fused="prologue", device="cpu").eval()
        m(x)
        assert calls == ["action_prologue"]
        m.train()(x)                           # training: plain autograd
        assert calls == ["action_prologue"]

    def test_training_is_plain_autograd(self, rng):
        """In training ``'prologue'`` gives the plain mode's output and
        gradients (the ME BN on batch statistics)."""
        mods = {mode: ActionConv(C, F, T, fused=mode, bn_frozen=False,
                                 device="cpu").train()
                for mode in ("prologue", None)}
        mods[None].load_state_dict(mods["prologue"].state_dict())
        x = torch.from_numpy(rng.standard_normal((N * T, C, H, W))
                             .astype(np.float32))
        res = {}
        for mode, m in mods.items():
            xi = x.clone().requires_grad_()
            y = m(xi)
            (y ** 2).sum().backward()
            res[mode] = [y.detach(), xi.grad] + [
                p.grad for p in m.parameters()]
        for a, b in zip(res["prologue"], res[None]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_randomized_weights_reach_every_gate(rng, interpret):
    """The parity above is not vacuous: with the converted weights each of
    the STE, CE and ME gates moves the prologue output."""
    j = JActionConv(features=F, n_segment=T, fused="prologue")
    tm = ActionConv(C, F, T, fused="prologue", device="cpu")
    x, v, xt = _pair(j, tm, rng)
    with torch.no_grad():
        base = tm(xt)
        for mod in (tm.action_p1_conv1, tm.action_p2_expand,
                    tm.action_p3_expand):
            saved = mod.weight.clone()
            mod.weight.mul_(2.0)
            assert (tm(xt) - base).abs().max() > 1e-3
            mod.weight.copy_(saved)
