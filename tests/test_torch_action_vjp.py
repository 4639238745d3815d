"""Port parity on the CPU for the ACTION training path: ``ActionRegion`` (the
kernel region with the hand-structured backward) against the JAX
``make_action_region`` and its ``jax.vjp``, and ``ActionConv`` in training
in every mode against the JAX ``ActionConv(fused='vjp')`` trained with the
same weights: outputs, BN statistics, the input's and every parameter's
gradient.  fp32; rtol = atol = 1e-4 as for the forward (the sums run in
another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from ehgr_tpu.ops.action import ActionConv as JActionConv
from ehgr_tpu.ops.action_vjp import make_action_region
from ehgr_tpu_torch.models.convert import state_dict_from_jax
from ehgr_tpu_torch.ops import action_vjp
from ehgr_tpu_torch.ops.action import ActionConv
from ehgr_tpu_torch.ops.action_vjp import ActionRegion

from test_torch_action_mega import _randomized

TOL = dict(rtol=1e-4, atol=1e-4)

# JAX region parameter -> (torch layout from the JAX one)
_TO_TORCH = {
    "k_p1": lambda a: a.transpose(4, 3, 0, 1, 2),      # DHWIO -> OIDHW
    "w_sq": lambda a: a.T[:, :, None, None],           # Dense -> 1x1 conv
    "k_ce": lambda a: a.transpose(2, 1, 0),            # WIO -> OIW
    "w_exp": lambda a: a.T[:, :, None, None],
    "bn_scale": lambda a: a,
    "bn_bias": lambda a: a,
    "k_dw": lambda a: a.transpose(3, 2, 0, 1),         # HWIO -> OIHW
    "w_me": lambda a: a.T[:, :, None, None],
}


def _np(t):
    return t.detach().float().numpy()


def _region_params(rng, c, f):
    cr = c // 16
    p = {"shift_w": rng.standard_normal((3, c)) * 0.5,
         "w_p3": rng.standard_normal((c, cr)) * c ** -0.5,
         "w_net": rng.standard_normal((c, f)) * c ** -0.5,
         "k_p1": rng.standard_normal((3, 3, 3, 1, 1)) / 5,
         "w_sq": rng.standard_normal((c, cr)) * c ** -0.5,
         "k_ce": rng.standard_normal((3, cr, cr)) * (3 * cr) ** -0.5,
         "w_exp": rng.standard_normal((cr, c)) * cr ** -0.5,
         "bn_scale": rng.uniform(0.5, 1.5, cr),
         "bn_bias": rng.standard_normal(cr) * 0.1,
         "bn_mean": rng.standard_normal(cr) * 0.1,
         "bn_var": rng.uniform(0.5, 2.0, cr),
         "k_dw": rng.standard_normal((3, 3, 1, cr)) / 3,
         "w_me": rng.standard_normal((cr, c)) * cr ** -0.5}
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


class TestRegion:
    @pytest.mark.parametrize("bn_train", [True, False])
    @pytest.mark.parametrize("n,t,h,w,c,f", [(2, 4, 6, 6, 32, 16),
                                             (1, 8, 3, 5, 48, 24)])
    def test_matches_jax_region(self, rng, bn_train, n, t, h, w, c, f):
        p = _region_params(rng, c, f)
        x = rng.standard_normal((n, t, h, w, c)).astype(np.float32)
        cot = rng.standard_normal((n * t, h, w, f)).astype(np.float32)

        region = make_action_region(bn_train=bn_train, dtype=jnp.float32)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        (j_out, j_m, j_v), vjp = jax.vjp(region, jnp.asarray(x), jp)
        j_dx, j_dp = vjp((jnp.asarray(cot), jnp.zeros_like(j_m),
                          jnp.zeros_like(j_v)))

        x4 = torch.from_numpy(x).reshape(n, t, h * w, c).requires_grad_()
        big = {k: torch.from_numpy(p[k]).requires_grad_()
               for k in ("shift_w", "w_p3", "w_net")}
        small = [torch.from_numpy(np.ascontiguousarray(_TO_TORCH[k](p[k])))
                 .requires_grad_() for k in action_vjp.SMALL]
        out, m, v = ActionRegion.apply(
            x4, (h, w), bn_train, None, 1e-5, big["shift_w"], big["w_p3"],
            big["w_net"], torch.from_numpy(p["bn_mean"]),
            torch.from_numpy(p["bn_var"]), *small)
        out.backward(torch.from_numpy(cot).reshape(out.shape))

        np.testing.assert_allclose(_np(out).reshape(cot.shape),
                                   np.asarray(j_out), **TOL)
        np.testing.assert_allclose(_np(m), np.asarray(j_m), **TOL)
        np.testing.assert_allclose(_np(v), np.asarray(j_v), **TOL)
        np.testing.assert_allclose(_np(x4.grad).reshape(x.shape),
                                   np.asarray(j_dx), **TOL)
        for k, g in big.items():
            np.testing.assert_allclose(_np(g.grad), np.asarray(j_dp[k]),
                                       err_msg=k, **TOL)
        for k, g in zip(action_vjp.SMALL, small):
            np.testing.assert_allclose(
                _np(g.grad), _TO_TORCH[k](np.asarray(j_dp[k])), err_msg=k,
                **TOL)


N, T, H, W, C, F = 2, 4, 5, 5, 32, 16


def _jax_train(bn_frozen, flat, x, cot):
    """JAX ActionConv(fused='vjp') trained one forward/backward: output,
    new batch statistics and gradients (input and every parameter)."""
    j = JActionConv(features=F, n_segment=T, bn_frozen=bn_frozen,
                    fused="vjp")
    v = unflatten_dict(flat)

    def loss(params, xx):
        out, mut = j.apply({"params": params, "batch_stats":
                            v["batch_stats"]}, xx, train=True,
                           mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut["batch_stats"])

    (_, (out, stats)), (g_p, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    return out, stats, g_p, g_x


class TestActionConvTraining:
    @pytest.mark.parametrize("bn_frozen", [True, False])
    @pytest.mark.parametrize("mode", ["vjp", None, "mega"])
    def test_matches_jax_vjp_module(self, rng, mode, bn_frozen):
        x = rng.standard_normal((N * T, H, W, C)).astype(np.float32)
        cot = rng.standard_normal((N * T, H, W, F)).astype(np.float32)
        j = JActionConv(features=F, n_segment=T, fused="vjp")
        flat = _randomized(j.init(jax.random.key(0), jnp.asarray(x),
                                  train=False), rng)
        out, stats, g_p, g_x = _jax_train(bn_frozen, flat, x, cot)

        tm = ActionConv(C, F, T, fused=mode, bn_frozen=bn_frozen,
                        device="cpu")
        tm.load_state_dict(state_dict_from_jax(flat), strict=True)
        tm.train()
        assert tm.action_p3_bn1.training == (not bn_frozen)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        got = tm(xt)
        (got * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()

        np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)),
                                   np.asarray(out), **TOL)
        np.testing.assert_allclose(_np(xt.grad.permute(0, 2, 3, 1)),
                                   np.asarray(g_x), **TOL)
        want_stats = state_dict_from_jax(flatten_dict(
            {"batch_stats": jax.device_get(stats)}))
        for k, wv in want_stats.items():
            np.testing.assert_allclose(_np(tm.state_dict()[k]), wv.numpy(),
                                       err_msg=k, **TOL)
        want_grads = state_dict_from_jax(flatten_dict(
            {"params": jax.device_get(g_p)}))
        named = dict(tm.named_parameters())
        assert sorted(want_grads) == sorted(named)
        for k, wg in want_grads.items():
            np.testing.assert_allclose(_np(named[k].grad), wg.numpy(),
                                       err_msg=k, **TOL)

    @pytest.mark.parametrize("mode", ["vjp", None, "mega"])
    def test_kernels_only_in_vjp(self, monkeypatch, mode):
        """In training 'vjp' runs the region: action_stats/action_apply
        forward, learnable_shift_fwd/_bwd backward, once each; the other
        modes run plain autograd and no kernel wrapper."""
        calls = []
        for name in ("action_stats", "action_apply", "learnable_shift_fwd",
                     "learnable_shift_bwd"):
            for mod in ("ehgr_tpu_torch.ops.action_vjp",
                        "ehgr_tpu_torch.ops.action"):
                fn = getattr(__import__(mod, fromlist=["x"]), name, None)
                if fn is not None:
                    monkeypatch.setattr(
                        f"{mod}.{name}",
                        lambda *a, _fn=fn, _n=name: calls.append(_n) or
                        _fn(*a))
        tm = ActionConv(C, F, T, fused=mode, bn_frozen=False,
                        device="cpu").train()
        x = torch.randn(N * T, C, H, W).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        tm(x).sum().backward()
        want = ["action_stats", "action_apply", "learnable_shift_fwd",
                "learnable_shift_bwd"] if mode == "vjp" else []
        assert calls == want

    def test_running_stats_update_like_torch_bn(self):
        """The region's ME BN update is torch's: momentum 0.1, unbiased
        variance."""
        tm = ActionConv(C, F, T, fused="vjp", bn_frozen=False,
                        device="cpu").train()
        ref = ActionConv(C, F, T, fused=None, bn_frozen=False,
                         device="cpu").train()
        ref.load_state_dict(tm.state_dict())
        x = torch.randn(N * T, C, H, W)
        with torch.no_grad():
            tm(x)
            ref(x)
        for k in ("running_mean", "running_var"):
            torch.testing.assert_close(
                getattr(tm.action_p3_bn1, k), getattr(ref.action_p3_bn1, k),
                rtol=1e-5, atol=1e-6)
