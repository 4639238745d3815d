"""Port parity on the CPU for the learnable-shift kernels: the wrappers'
plain path and ``LearnableShift`` (forward, dx, dw) against the JAX Pallas
kernel ``learnable_shift_pallas`` in interpret mode and its ``jax.vjp``, the
wrappers' guards, the backward's routes and the launch geometry the CUDA
kernels take (the strip kernel's also walked in numpy, block by block, in
its own order).  fp32; rtol = atol = 1e-5 (y and dx are three products
apart, dw sums N*T*S products in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ehgr_tpu.ops.pallas.shift import learnable_shift_pallas
from ehgr_tpu_torch.ops.kernels import shift as shk

from test_torch_guards import _OnCuda

TOL = dict(rtol=1e-5, atol=1e-5)
# (S, C) of the 16 ResNet-50 ACTION sites at 224^2 (the shift does not see F)
SITES = [(3136, 64), (3136, 256), (784, 512), (196, 1024), (49, 2048)]
# (clips, T, S, C) the strip kernel's geometry must cover: every site at the
# train steps' 8 clips and the served batch's 20, T = 5, and ragged S
STRIP_SHAPES = ([(n, 8, s, c) for n in (8, 20) for s, c in SITES] +
                [(n, 5, s, c) for n in (8, 20)
                 for s, c in ((3136, 64), (784, 512))] +
                [(8, 8, 1000, 128), (3, 4, 50, 64), (1, 1, 1, 64),
                 (2, 3, 97, 192)])


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


class TestStripRoute:
    @pytest.mark.parametrize("s,c", SITES)
    def test_every_site_takes_the_strip_kernel(self, s, c):
        assert shk.bwd_route(torch.bfloat16, c, True) == "strip"

    @pytest.mark.parametrize("dtype,c,aligned", [
        (torch.float32, 256, True),
        (torch.bfloat16, 100, True),         # C % 8 != 0
        (torch.bfloat16, 96, True),          # C % 64 != 0
        (torch.bfloat16, 256, False)])       # misaligned
    def test_other_operands_take_the_sweep(self, dtype, c, aligned):
        assert shk.bwd_route(dtype, c, aligned) == "sweep"

    @pytest.mark.parametrize("dtype,offset,want", [
        (torch.bfloat16, 0, "strip"), (torch.bfloat16, 1, "sweep"),
        (torch.float32, 0, "sweep")])
    def test_wrapper_launches_the_route_and_counts_it(self, monkeypatch,
                                                      dtype, offset, want):
        """On a CUDA tensor the wrapper launches the entry point of its
        route with the geometry's sizes (a misaligned ``x4`` view leaves the
        strip kernel) and counts the launch under that route."""
        calls = []
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(shk, "load", lambda lib: None)
        monkeypatch.setattr(shk, "launch",
                            lambda lib, fn, x4, *a: calls.append((lib, fn,
                                                                  a[-7:])))
        n, t, s, c = 2, 3, 40, 128

        def cuda(*shape, extra=0):
            base = torch.randn(extra + int(np.prod(shape))).to(dtype)
            return torch.Tensor._make_subclass(_OnCuda,
                                               base[extra:].view(shape))
        before = dict(shk.learnable_shift_bwd.route_launches)
        launches = shk.learnable_shift_bwd.launches
        shk.learnable_shift_bwd(cuda(n, t, s, c, extra=offset),
                                cuda(n, t, s, c), cuda(3, c))
        geo = shk.strip_geometry(n, s, c)
        assert calls == ([("shift_bwd", "ehgr_shift_bwd_strip",
                           (n, t, s, c, geo["rows"], geo["strips"],
                            geo["finish_cols"]))] if want == "strip" else
                         [("shift", "ehgr_shift_bwd", calls[0][2])])
        after = shk.learnable_shift_bwd.route_launches
        assert {k: after[k] - before[k] for k in after} == {
            k: int(k == want) for k in after}
        assert shk.learnable_shift_bwd.launches == launches + 1

    def test_cpu_counts_no_route(self, rng):
        x, w, g = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(rng, 2, 4, 2, 4, 64))
        before = dict(shk.learnable_shift_bwd.route_launches)
        shk.learnable_shift_bwd(x.reshape(2, 4, 8, 64), g.reshape(2, 4, 8, 64),
                                w)
        assert shk.learnable_shift_bwd.route_launches == before


def _strip_walk(x, g, w, geo):
    """The strip kernel's arithmetic in numpy, block by block in its order:
    each block walks its strip's sub-strips of 32 rows through all T frames
    with g[t-2], g[t-1], x[t-1] carried, writes dx and one partial row of dw
    [3, 64]; then the partials are summed column by column as dw_finish
    does (strided runs in order, then a tree).  f32 throughout."""
    n, t, s, c = x.shape
    dx = np.full_like(x, np.nan)
    part = np.zeros((geo["parts"], 3, c), np.float32)
    ap, ac, an = w[2], w[1], w[0]
    for b in range(geo["blocks"]):
        chunk, p = b % geo["chunks"], b // geo["chunks"]
        nn, row0 = p // geo["strips"], (p % geo["strips"]) * geo["rows"]
        rows = min(geo["rows"], s - row0)
        assert 1 <= rows and -(-rows // 32) <= 4
        cs = slice(chunk * 64, chunk * 64 + 64)
        dw = np.zeros((3, 32, 64), np.float32)       # per thread row
        for u in range(-(-rows // 32)):
            r = np.arange(u * 32, u * 32 + 32)
            ok = r < rows
            rr = row0 + np.where(ok, r, 0)
            gp2 = gp1 = xp1 = np.zeros((32, 64), np.float32)
            for f in range(t):
                gf = np.where(ok[:, None], g[nn, f, rr, cs], 0)
                xf = np.where(ok[:, None], x[nn, f, rr, cs], 0)
                dw[1] += xf * gf
                dw[2] += xf * gp1
                dw[0] += xp1 * gf
                if f > 0:
                    dx[nn, f - 1, rr[ok], cs] = (ap[cs] * gp2 + ac[cs] * gp1 +
                                                 an[cs] * gf)[ok]
                gp2, gp1, xp1 = gp1, gf, xf
            dx[nn, t - 1, rr[ok], cs] = (ap[cs] * gp2 + ac[cs] * gp1)[ok]
        part[p, :, cs] = dw.sum(1)
    cols, rp = geo["finish_cols"], 256 // geo["finish_cols"]
    assert geo["finish_blocks"] * cols >= 3 * c and rp * cols == 256
    flat = part.reshape(geo["parts"], 3 * c)
    runs = np.stack([flat[r::rp].sum(0) for r in range(rp)])
    while len(runs) > 1:
        runs = runs[:len(runs) // 2] + runs[len(runs) // 2:]
    return dx, runs[0].reshape(3, c)


class TestStripGeometry:
    @pytest.mark.parametrize("n,t,s,c", STRIP_SHAPES)
    def test_blocks_cover_every_row_and_channel_once(self, n, t, s, c):
        geo = shk.strip_geometry(n, s, c)
        seen = np.zeros((n, s, c // 64), np.int64)
        for b in range(geo["blocks"]):
            chunk, p = b % geo["chunks"], b // geo["chunks"]
            nn, strip = divmod(p, geo["strips"])
            row0 = strip * geo["rows"]
            rows = min(geo["rows"], s - row0)
            assert nn < n and p < geo["parts"] and rows >= 1
            assert -(-rows // 32) <= geo["subs"] <= 4
            seen[nn, row0:row0 + rows, chunk] += 1
        assert (seen == 1).all()
        assert geo["parts"] == n * geo["strips"]
        assert geo["finish_blocks"] * geo["finish_cols"] >= 3 * c

    @pytest.mark.parametrize("s,c", SITES)
    def test_sites_fill_the_card(self, s, c):
        """At the train steps' 8 clips every site has at least two blocks
        an SM (132 SMs), and dw_finish at least one."""
        geo = shk.strip_geometry(8, s, c)
        assert geo["blocks"] >= 2 * 132 and geo["finish_blocks"] >= 132

    @pytest.mark.parametrize("n,t,s,c", [(2, 5, 70, 128), (3, 4, 33, 64),
                                         (1, 1, 9, 64), (2, 8, 49, 192)])
    def test_walk_matches_the_plain_backward(self, rng, n, t, s, c):
        """The strip kernel's order of work, walked in numpy, gives the
        plain version's dx and dw."""
        x, w, g = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((n, t, s, c), (3, c), (n, t, s, c)))
        dx, dw = _strip_walk(x, g, w, shk.strip_geometry(n, s, c))
        want_dx, want_dw = shk.learnable_shift_bwd_plain(
            *(torch.from_numpy(a) for a in (x, g, w)))
        np.testing.assert_allclose(dx, want_dx.numpy(), **TOL)
        np.testing.assert_allclose(dw, want_dw.numpy(), **TOL)
