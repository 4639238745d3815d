"""Port parity on the CPU for the TSM shift (kernel 5): the plain version of
``tsm_shift`` and the gradient of ``TsmShift`` against the JAX
``tsm_shift_pallas`` (interpret mode, as ``tests/test_pallas_shift.py``
runs it) and its ``jax.grad``; the wrapper's guards; ``TSMConv`` and a tiny
``tsn(temporal='tsm')`` against the JAX ones through converted weights,
forward and in training (K=3 steps of ``make_train_step``).

The shift is a copy: the outputs and the input gradients are compared
bitwise.  The model-level comparisons are fp32 with rtol = atol = 1e-4 (the
convolutions sum in another order), the train steps as
``tests/test_torch_train.py`` holds them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu.ops.action import TSMConv as JTSMConv
from ehgr_tpu.ops.pallas.shift import _run_shift, tsm_shift_pallas
from ehgr_tpu_torch.models.convert import load_jax_variables
from ehgr_tpu_torch.models.tsn import variant
from ehgr_tpu_torch.ops.action import TSMConv
from ehgr_tpu_torch.ops.kernels import tsm_shift as tk

from test_torch_train import (check_trajectory, jax_run, make_batches,
                              port_run)

TOL = dict(rtol=1e-4, atol=1e-4)
# (N, T, H, W, C): C=100 puts fold (12 at fold_div 8, 25 at 4) off every
# 8-channel vector; C=24 gives fold 3 (6), inside the first vector
SHAPES = [(2, 6, 3, 3, 100), (1, 8, 2, 5, 24), (2, 4, 4, 4, 64)]


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _x4(x5):
    n, t, h, w, c = x5.shape
    return torch.from_numpy(x5.reshape(n, t, h * w, c))


class TestPlainVersusPallas:
    @pytest.mark.parametrize("fold_div", [8, 4])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_forward(self, rng, shape, fold_div):
        x = _x(rng, shape)
        want = np.asarray(tsm_shift_pallas(jnp.asarray(x), fold_div, True))
        got = tk.tsm_shift(_x4(x), fold_div).numpy().reshape(shape)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("fold_div", [8, 4])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_reverse_is_the_pallas_vjp(self, rng, shape, fold_div):
        """``TsmShift``'s gradient (the reverse shift) against ``jax.grad``
        through the Pallas kernel's custom VJP, and ``reverse=True`` against
        the kernel's own reverse sweep."""
        x, g = _x(rng, shape), _x(rng, shape)
        want = np.asarray(jax.grad(lambda y: jnp.sum(
            tsm_shift_pallas(y, fold_div, True) * g))(jnp.asarray(x)))
        xt = _x4(x).requires_grad_()
        (tk.TsmShift.apply(xt, fold_div) * _x4(g)).sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy().reshape(shape), want)
        rev = np.asarray(_run_shift(jnp.asarray(g), fold_div, True, True))
        np.testing.assert_array_equal(
            tk.tsm_shift(_x4(g), fold_div, reverse=True).numpy()
            .reshape(shape), rev)

    def test_edges_are_zero(self, rng):
        x = torch.from_numpy(_x(rng, (1, 4, 5, 16))) + 10.0
        y = tk.tsm_shift(x, 8)
        assert (y[:, -1, :, :2] == 0).all() and (y[:, 0, :, 2:4] == 0).all()
        assert (y[:, :-1, :, :2] != 0).all() and (y[:, 1:, :, 2:4] != 0).all()
        r = tk.tsm_shift(x, 8, reverse=True)
        assert (r[:, 0, :, :2] == 0).all() and (r[:, -1, :, 2:4] == 0).all()


class TestWrapper:
    def test_cpu_takes_plain_version_without_counting(self, rng):
        x = torch.from_numpy(_x(rng, (2, 4, 9, 32)))
        before = (tk.tsm_shift.launches, tk.tsm_shift.reverse_launches)
        for reverse in (False, True):
            torch.testing.assert_close(
                tk.tsm_shift(x, 8, reverse),
                tk.tsm_shift_plain(x, 8, reverse), rtol=0, atol=0)
        assert (tk.tsm_shift.launches, tk.tsm_shift.reverse_launches) == \
            before

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
    def test_plain_is_a_copy_in_any_dtype(self, rng, dtype):
        x = torch.from_numpy(_x(rng, (1, 4, 3, 16))).to(dtype)
        y = tk.tsm_shift(x, 4)
        assert y.dtype == dtype
        torch.testing.assert_close(y.float(), tk.tsm_shift(x.float(), 4),
                                   rtol=0, atol=0)

    @pytest.mark.parametrize("bad", [(2, 4, 16), (1, 2, 4, 3, 16)])
    def test_refuses_other_ranks(self, bad):
        with pytest.raises(ValueError, match="tsm_shift"):
            tk.tsm_shift(torch.zeros(bad), 8)

    def test_grid_covers_ragged_vectors(self):
        """The geometry the kernel is launched with: C=100 bf16 moves one
        channel a thread, C=96 eight (fold 12 straddles a vector)."""
        from ehgr_tpu_torch.ops.kernels.shift import _vec, geometry

        for c, want in ((100, 1), (96, 8), (24, 8)):
            x = torch.zeros(1, 2, 3, c, dtype=torch.bfloat16)
            vec = _vec(c, x)
            assert vec == want
            bx, by, gx, gy = geometry(1, 3, c, vec)
            assert bx * by == 256 and bx * gx * vec >= c


def _tsm_pair(rng, c, f, t, h, w):
    """JAX and port ``TSMConv`` with the same weights, and an input."""
    x = _x(rng, (2 * t, h, w, c))
    j = JTSMConv(features=f, n_segment=t)
    v = j.init(jax.random.key(0), jnp.asarray(x))
    tm = TSMConv(c, f, t, device="cpu")
    tm.net.weight.data.copy_(torch.from_numpy(np.asarray(
        v["params"]["net"]["kernel"]).transpose(3, 2, 0, 1).copy()))
    return j, v, tm, x


class TestTSMConv:
    @pytest.mark.parametrize("c,f", [(64, 16), (100, 24)])
    def test_forward_and_grads_match_jax(self, rng, c, f):
        """Output, input gradient and ``net`` gradient for a cotangent."""
        t, h, w = 4, 3, 5
        j, v, tm, x = _tsm_pair(rng, c, f, t, h, w)
        cot = _x(rng, (2 * t, h, w, f))

        def loss(params, xx):
            return jnp.sum(j.apply({"params": params}, xx) * cot)

        want = np.asarray(j.apply(v, jnp.asarray(x)))
        gp, gx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        y = tm(xt)
        (y * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
        np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                                   want, **TOL)
        np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(gx), **TOL)
        np.testing.assert_allclose(
            tm.net.weight.grad.numpy(),
            np.asarray(gp["net"]["kernel"]).transpose(3, 2, 0, 1), **TOL)

    def test_takes_the_shift_op(self, monkeypatch, rng):
        """Forward and backward go through ``TsmShift`` (the kernel's
        binding), once each."""
        calls = []
        orig = tk.tsm_shift

        def counted(x4, fold_div=8, reverse=False):
            calls.append(reverse)
            return orig(x4, fold_div, reverse)

        monkeypatch.setattr(tk, "tsm_shift", counted)
        tm = TSMConv(32, 8, 4, device="cpu")
        x = torch.randn(8, 32, 3, 3).requires_grad_()
        tm(x).sum().backward()
        assert calls == [False, True]


CLS, T, HW = 5, 4, 32


class TestTsmModel:
    def test_logits_match_jax(self):
        """``tsn(temporal='tsm')`` at the golden geometry (N=2, T=4, 32^2,
        5 classes, init key 42) from converted weights."""
        x = np.linspace(-1, 1, 2 * T * HW * HW * 3,
                        dtype=np.float32).reshape(2, T, HW, HW, 3)
        jm = j_variant("tsn", num_class=CLS, num_segments=T, temporal="tsm",
                       partial_bn=False)
        v = jax.jit(lambda r, xx: jm.init(r, xx, train=False))(
            {"params": jax.random.key(42)}, jnp.asarray(x))
        want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
        m = variant("tsn", num_class=CLS, num_segments=T, temporal="tsm",
                    device="cpu")
        load_jax_variables(m, {k: np.asarray(a)
                               for k, a in flatten_dict(v).items()})
        with torch.no_grad():
            got = m(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        assert np.abs(want).max() > 1e-2

    def test_train_step_matches_jax(self, monkeypatch):
        """One ``baseline`` step of a TSM ResNet-50 (one bottleneck a
        stage) against the JAX ``make_train_step``: loss, gradients
        (momentum), parameter and EMA deltas, BN statistics.  (Over three
        steps the losses agree within 1e-4, but layer4's BN at 1x1, 8
        values a channel, lets the parameters drift apart by ~3% of a
        delta.)"""
        import test_torch_train as ttr

        monkeypatch.setattr(ttr, "j_variant", lambda *a, **k: j_variant(
            *a, temporal="tsm", **k))
        monkeypatch.setattr(ttr, "variant", lambda *a, **k: variant(
            *a, temporal="tsm", **k))
        batches = make_batches(0, False)[:1]
        res = jax_run("tsn", "baseline", 1, batches)
        port = port_run("tsn", "baseline", 1, None, res[0], batches)
        check_trajectory(res, port, "baseline")
