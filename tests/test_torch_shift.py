"""Port parity on the CPU for the learnable-shift kernels: the wrappers'
plain path and ``LearnableShift`` (forward, dx, dw) against the JAX Pallas
kernel ``learnable_shift_pallas`` in interpret mode and its ``jax.vjp``, the
wrappers' guards and the launch geometry the CUDA kernels take.  fp32;
rtol = atol = 1e-5 (y and dx are three products apart, dw sums N*T*S
products in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ehgr_tpu.ops.pallas.shift import learnable_shift_pallas
from ehgr_tpu_torch.ops.kernels import shift as shk

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().float().numpy()


def _inputs(rng, n, t, h, w, c):
    return (rng.standard_normal((n, t, h, w, c)).astype(np.float32),
            rng.standard_normal((3, c)).astype(np.float32),
            rng.standard_normal((n, t, h, w, c)).astype(np.float32))


class TestAgainstPallas:
    @pytest.mark.parametrize("t", [1, 2, 4, 8])
    @pytest.mark.parametrize("n,h,w,c", [(2, 4, 4, 16), (1, 7, 7, 24),
                                         (3, 2, 5, 8)])
    def test_forward_dx_dw(self, rng, n, t, h, w, c):
        """y, dx and dw of ``LearnableShift`` against the Pallas kernel and
        its custom VJP, ragged spatial sizes and T = 1 (no neighbours)
        included."""
        x, wt, g = _inputs(rng, n, t, h, w, c)
        want, vjp = jax.vjp(
            lambda a, b: learnable_shift_pallas(a, b, True),
            jnp.asarray(x), jnp.asarray(wt))
        want_dx, want_dw = vjp(jnp.asarray(g))

        x4 = torch.from_numpy(x).reshape(n, t, h * w, c).requires_grad_()
        w4 = torch.from_numpy(wt).requires_grad_()
        y = shk.LearnableShift.apply(x4, w4)
        dx, dw = torch.autograd.grad(
            y, (x4, w4), torch.from_numpy(g).reshape(n, t, h * w, c))
        np.testing.assert_allclose(_np(y).reshape(x.shape), np.asarray(want),
                                   **TOL)
        np.testing.assert_allclose(_np(dx).reshape(x.shape),
                                   np.asarray(want_dx), **TOL)
        np.testing.assert_allclose(_np(dw), np.asarray(want_dw), **TOL)

    def test_no_shift_across_clips(self, rng):
        """A cotangent on one clip moves only that clip's dx."""
        x, wt, _ = _inputs(rng, 2, 4, 2, 2, 8)
        g = np.zeros_like(x)
        g[1] = 1.0
        dx, _ = shk.learnable_shift_bwd(
            *(torch.from_numpy(a).reshape(2, 4, 4, 8) for a in (x, g)),
            torch.from_numpy(wt))
        assert torch.count_nonzero(dx[0]) == 0
        assert torch.count_nonzero(dx[1]) > 0


class TestWrappers:
    def test_cpu_takes_plain_version_without_counting(self, rng):
        x, w, g = (torch.from_numpy(a) for a in _inputs(rng, 2, 4, 3, 3, 16))
        x4, g4 = x.reshape(2, 4, 9, 16), g.reshape(2, 4, 9, 16)
        before = (shk.learnable_shift_fwd.launches,
                  shk.learnable_shift_bwd.launches)
        torch.testing.assert_close(shk.learnable_shift_fwd(x4, w),
                                   shk.learnable_shift_fwd_plain(x4, w),
                                   rtol=0, atol=0)
        for got, want in zip(shk.learnable_shift_bwd(x4, g4, w),
                             shk.learnable_shift_bwd_plain(x4, g4, w)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert (shk.learnable_shift_fwd.launches,
                shk.learnable_shift_bwd.launches) == before

    def test_bf16_plain_computes_in_f32(self, rng):
        x, w, g = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(rng, 2, 4, 3, 3, 16))
        x, g = x.reshape(2, 4, 9, 16), g.reshape(2, 4, 9, 16)
        y = shk.learnable_shift_fwd(x, w)
        assert y.dtype == torch.bfloat16
        torch.testing.assert_close(
            y, shk.learnable_shift_fwd_plain(x.float(), w.float())
            .to(torch.bfloat16))
        dx, dw = shk.learnable_shift_bwd(x, g, w)
        assert dx.dtype == dw.dtype == torch.bfloat16
        want_dx, want_dw = shk.learnable_shift_bwd_plain(
            x.float(), g.float(), w.float())
        torch.testing.assert_close(dx, want_dx.to(torch.bfloat16))
        torch.testing.assert_close(dw, want_dw.to(torch.bfloat16))

    @pytest.mark.parametrize("bad", ["dtype", "mixed", "shape",
                                     "non_contiguous"])
    def test_refuses_bad_operands(self, rng, bad):
        x, w, g = (torch.from_numpy(a) for a in _inputs(rng, 2, 4, 3, 3, 16))
        x4, g4 = x.reshape(2, 4, 9, 16), g.reshape(2, 4, 9, 16)
        if bad == "dtype":
            x4, g4, w = x4.half(), g4.half(), w.half()
        elif bad == "mixed":
            g4 = g4.double()
        elif bad == "shape":
            w = w[:, :-1]
        else:
            g4 = g4.transpose(1, 2).contiguous().transpose(1, 2)
        with pytest.raises((TypeError, ValueError)):
            shk.learnable_shift_bwd(x4, g4, w)


class TestGeometry:
    @pytest.mark.parametrize("n,s,c,vec", [
        (8, 3136, 64, 8), (8, 49, 2048, 8), (8, 50, 100, 1),
        (2, 1000, 128, 4), (1, 1, 16, 8)])
    def test_grid_covers_every_channel_and_row(self, n, s, c, vec):
        bx, by, gx, gy = shk.geometry(n, s, c, vec)
        assert bx * by == 256 and bx & (bx - 1) == 0 and by & (by - 1) == 0
        assert gx * bx * vec >= c > (gx - 1) * bx * vec
        assert 1 <= gy * by and gy <= max(1, 132 * 8 // gx)
        assert (gy - 1) * by < n * s          # no block without a row

    def test_vector_width_needs_c_and_alignment(self):
        x = torch.zeros(2, 4, 9, 16)
        assert shk._vec(16, x, x) == 4
        assert shk._vec(16, x.bfloat16(), x.bfloat16()) == 8
        assert shk._vec(12, x.bfloat16()) == 1              # C % 8 != 0
        off = torch.zeros(2 * 4 * 9 * 16 + 1)[1:].reshape(2, 4, 9, 16)
        assert shk._vec(16, x, off) == 1                     # 4-byte offset
