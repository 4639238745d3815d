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
from ehgr_tpu_torch.ops.kernels import action_fused as fused
from ehgr_tpu_torch.ops.kernels import action_mega as mega
from ehgr_tpu_torch.ops.kernels import build

from test_torch_guards import _OnCuda

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
    @pytest.mark.parametrize("n,t,s,c", [(N, T, H * W, C), (1, 4, 1000, 128),
                                         (2, 5, 49, 64)])
    def test_stats(self, rng, n, t, s, c):
        """(1, 4, 1000, 128): an S the Pallas kernel tiles with a masked
        partial block (tests/test_action_mega.py); (2, 5, 49, 64): T = 5,
        off every frame group of the window kernel, at a 7^2 frame."""
        args = _stats_inputs(rng, n, t, s, c)
        want = jmega.action_stats(*map(jnp.asarray, args), interpret=True)
        got = mega.action_stats_plain(*map(_t, args))
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)

    @pytest.mark.parametrize("n,t,s,c,f", [(N, T, H * W, C, F),
                                           (1, 4, 1000, 128, 8)] + [
        # the strip route's edges: C one or two 64-channel chunks, F under
        # one 64-column block, one full 256 block and two; S = 49 (a 7^2
        # site) and S = 130 (frames straddle the 128-row strips)
        (1, 4, s, c, f) for s in (49, 130) for c in (64, 128)
        for f in (32, 256, 512)])
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
        strip = build.library_path("action_apply")
        assert strip.parent == build.BUILD_DIR and strip != path
        assert "ehgr_action_apply_strip" in build.SIGNATURES["action_apply"]
        window = build.library_path("action_stats")
        assert window.name.startswith("libaction_stats-")
        assert window not in (path, strip)
        assert "ehgr_action_stats_window" in build.SIGNATURES["action_stats"]

    def test_library_name_follows_the_shared_header(self, monkeypatch,
                                                   tmp_path):
        """Every library's name hashes the headers of ``csrc/`` too: an
        edit to the shared header builds each source anew, an edit to a
        source only that source's library."""
        for f in build.CSRC.iterdir():
            (tmp_path / f.name).write_bytes(f.read_bytes())
        monkeypatch.setattr(build, "CSRC", tmp_path)
        names = ("action_mega", "action_stats", "action_apply")
        before = {k: build.library_path(k) for k in names}
        header = tmp_path / "action_common.cuh"
        header.write_text(header.read_text() + "\n// edited\n")
        after = {k: build.library_path(k) for k in names}
        assert all(after[k] != before[k] for k in names)
        src = tmp_path / "action_stats.cu"
        src.write_text(src.read_text() + "\n// edited\n")
        again = {k: build.library_path(k) for k in names}
        assert again["action_stats"] != after["action_stats"]
        assert again["action_mega"] == after["action_mega"]


# (S, C, F) of the 16 ACTION sites of ResNet-50 at 224^2
RESNET50_SITES = [(3136, 64, 64), (3136, 256, 64), (3136, 256, 128),
                  (784, 512, 128), (784, 512, 256), (196, 1024, 256),
                  (196, 1024, 512), (49, 2048, 512)]


class TestApplyRoute:
    @pytest.mark.parametrize("s,c,f", RESNET50_SITES)
    def test_every_site_takes_the_strip_kernel(self, s, c, f):
        assert mega._apply_route(torch.bfloat16, c, f, True) == "strip"

    @pytest.mark.parametrize("dtype,c,f,aligned,want", [
        (torch.float32, 256, 64, True, "fma_sweep"),
        (torch.bfloat16, 96, 64, True, "fma_sweep"),    # C % 64 != 0
        (torch.bfloat16, 256, 60, True, "fma_sweep"),   # F % 8 != 0
        (torch.bfloat16, 256, 64, False, "fma_sweep"),  # misaligned
        (torch.bfloat16, 100, 24, True, "fma_sweep")])  # C % 8 != 0
    def test_other_operands_keep_the_sweeps(self, dtype, c, f, aligned,
                                            want):
        assert mega._apply_route(dtype, c, f, aligned) == want

    @pytest.mark.parametrize("dtype,offset,want", [
        (torch.bfloat16, 0, "strip"), (torch.bfloat16, 1, "fma_sweep"),
        (torch.float32, 0, "fma_sweep")])
    def test_wrapper_launches_the_route_and_counts_it(self, monkeypatch,
                                                      dtype, offset, want):
        """On a CUDA tensor the wrapper launches the entry point of its
        route (a misaligned ``x4`` view leaves the strip kernel) and counts
        the launch under that route."""
        calls = []
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(mega, "launch",
                            lambda lib, fn, x4, *a: calls.append((lib, fn)))
        n, t, s, c, f = 1, 2, 3, 64, 16

        def cuda(*shape, extra=0):
            base = torch.randn(extra + int(np.prod(shape))).to(dtype)
            return torch.Tensor._make_subclass(
                _OnCuda, base[extra:].view(shape))
        x4 = cuda(n, t, s, c, extra=offset)
        before = dict(mega.action_apply.route_launches)
        mega.action_apply(x4, cuda(3, c), cuda(n, t, s, 1), cuda(n, t, c),
                          cuda(c, f))
        lib = "action_apply" if want == "strip" else "action_mega"
        assert calls == [(lib, "ehgr_action_apply_strip" if want == "strip"
                          else "ehgr_action_apply")]
        after = mega.action_apply.route_launches
        assert {k: after[k] - before[k] for k in after} == {
            k: int(k == want) for k in after}


class _ScratchRows:
    """Stand-in for a built stats library: reports the rows of its pool
    scratch, one per 64-row strip of each frame, and records the call."""

    calls = []

    def __init__(self, lib):
        self.lib = lib

    def ehgr_action_pool_scratch_rows(self, n, t, s):
        _ScratchRows.calls.append((self.lib, n, t, s))
        return n * t * -(-s // 64)


def _launch_on_cuda(monkeypatch, wrapper, dtype, offset, c=64, cr=4):
    """Call ``wrapper(x4, w_shift, w_p3)`` on CPU tensors that report
    ``cuda:0`` (``x4`` a view ``offset`` elements into its storage) with
    ``launch`` recorded instead of run (and nothing built; ``load`` gives a
    library stand-in that reports the pool scratch's rows); returns the
    (library, entry point) it launched and the change of
    ``wrapper.route_launches``."""
    calls = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for mod in (mega, fused):
        monkeypatch.setattr(mod, "load", _ScratchRows)
        monkeypatch.setattr(mod, "launch",
                            lambda lib, fn, x4, *a: calls.append((lib, fn)))
    n, t, s = 1, 2, 3

    def cuda(*shape, extra=0):
        base = torch.randn(extra + int(np.prod(shape))).to(dtype)
        return torch.Tensor._make_subclass(_OnCuda,
                                           base[extra:].view(shape))
    before = dict(wrapper.route_launches)
    wrapper(cuda(n, t, s, c, extra=offset), cuda(3, c), cuda(c, cr))
    after = wrapper.route_launches
    return calls, {k: after[k] - before[k] for k in after}


class TestStatsRoute:
    @pytest.mark.parametrize("s,c,f", RESNET50_SITES)
    def test_every_site_takes_the_window_kernel(self, s, c, f):
        assert mega._stats_route(torch.bfloat16, c, c // 16, True) == \
            "window"

    @pytest.mark.parametrize("dtype,c,cr,aligned", [
        (torch.float32, 256, 16, True),
        (torch.bfloat16, 96, 6, True),        # C % 64 != 0
        (torch.bfloat16, 256, 6, True),       # Cr % 4 != 0
        (torch.bfloat16, 4096, 512, True),    # Cr > 128
        (torch.bfloat16, 2048, 256, True),    # 128 < Cr <= 256: no site
        (torch.bfloat16, 256, 16, False)])    # misaligned
    def test_other_operands_take_the_fma_sweep(self, dtype, c, cr,
                                               aligned):
        assert mega._stats_route(dtype, c, cr, aligned) == "fma_sweep"

    @pytest.mark.parametrize("dtype,offset,want", [
        (torch.bfloat16, 0, "window"), (torch.bfloat16, 1, "fma_sweep"),
        (torch.float32, 0, "fma_sweep")])
    def test_wrapper_launches_the_route_and_counts_it(self, monkeypatch,
                                                      dtype, offset, want):
        """On a CUDA tensor ``action_stats`` launches the entry point of
        its route (a misaligned ``x4`` view leaves the window kernel) and
        counts the launch under that route."""
        calls, moved = _launch_on_cuda(monkeypatch, mega.action_stats,
                                       dtype, offset)
        assert calls == [("action_stats", "ehgr_action_stats_window")
                         if want == "window"
                         else ("action_mega", "ehgr_action_stats")]
        assert moved == {k: int(k == want) for k in moved}
        assert _ScratchRows.calls[-1] == (calls[0][0], 1, 2, 3)

    @pytest.mark.parametrize("lib", ["action_stats", "action_mega"])
    def test_scratch_has_the_rows_its_library_reports(self, monkeypatch,
                                                      lib):
        """The pool partials are f32, C wide and as many rows as the
        library of the route reports, so no strip height is kept in
        Python beside the kernels'."""
        monkeypatch.setattr(mega, "load", _ScratchRows)
        x4 = torch.zeros(2, 3, 65, 64, dtype=torch.bfloat16)
        part = mega.stats_scratch(x4, lib)
        assert _ScratchRows.calls[-1] == (lib, 2, 3, 65)
        assert part.shape == (2 * 3 * 2, 64)
        assert part.dtype == torch.float32


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
        """Every JAX mode is ported ('prologue' at eval gives the plain
        formulation's output, tests/test_torch_action_fused.py holds it
        against JAX) and an unknown mode is refused; training is ported
        (tests/test_torch_action_vjp.py)."""
        x = torch.randn(N * T, C, H, W).contiguous(
            memory_format=torch.channels_last)
        mods = {mode: ActionConv(C, F, T, fused=mode, device="cpu").eval()
                for mode in ("prologue", None)}
        mods[None].load_state_dict(mods["prologue"].state_dict())
        with torch.no_grad():
            torch.testing.assert_close(mods["prologue"](x), mods[None](x),
                                       **TOL)
        with pytest.raises(ValueError, match="unknown"):
            ActionConv(C, F, T, fused="fast", device="cpu")
