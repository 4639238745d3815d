"""GradCAM and the TSN taps on the CPU, against the JAX package from the
same weights and clip: ``TSN(..., return_taps=True)`` (the port's
channels_last taps transposed to JAX's ``[NT, h, w, C]``), ``gradcam`` on
the final exit of ``tsn`` and on exits 1-3 of ``tsn_sd``, with the class
given and taken from the argmax, in the plain ACTION mode and in 'mega'
(its kernels' plain versions on the CPU), and ``overlay_cam`` bitwise.

Weights are drawn with numpy over the JAX variable tree (``draw`` of
``tests/test_torch_backbones.py``: BN statistics off their init) and
converted by ``models/convert.py``.  ResNet-50 widths at one bottleneck a
stage (``tiny_resnet``), N=1, T=4, 5 classes, fp32, at 64^2: at 32^2
layer4 is 1x1, where every normalized CAM is 0 in both packages, so the
final exit's CAM would test nothing; at 64^2 it is 2x2 and exits 1-3 are
16^2, 8^2 and 4^2.  The JAX forward is jitted (``_Jitted``); its
head's VJP runs as JAX's ``gradcam`` runs it.  CAMs and logits are held at
1e-4 absolute; the taps as the SD tests hold features, at rtol 1e-4 and
atol 1e-4 of their max |value|."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import unflatten_dict

from ehgr_tpu.eval.gradcam import gradcam as j_gradcam
from ehgr_tpu.eval.gradcam import overlay_cam as j_overlay_cam
from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu_torch.eval.gradcam import gradcam, overlay_cam
from ehgr_tpu_torch.models.convert import load_jax_variables
from ehgr_tpu_torch.models.tsn import variant

from test_torch_backbones import draw
from test_torch_train import single_thread  # noqa: F401  (a fixture)
from test_torch_train import tiny_resnet

CLS, T, HW = 5, 4, 64
ATOL = 1e-4
# (arch, exit) of the GradCAM cases, the tap each reads and its size
EXITS = [("tsn", "final", "layer4", 2), ("tsn_sd", "mid1", "layer1", 16),
         ("tsn_sd", "mid2", "layer2", 8), ("tsn_sd", "mid3", "layer3", 4)]
CASES = [(arch, ex, cls, mode) for arch, ex, _, _ in EXITS
         for cls in (2, None) for mode in (None, "mega")]
pytestmark = pytest.mark.usefixtures("single_thread")


def _clip():
    return np.random.default_rng(11).standard_normal(
        (1, T, HW, HW, 3)).astype(np.float32)


class _Jitted:
    """A JAX TSN whose ``apply`` (at eval, with the taps) is jitted, for
    the JAX ``gradcam``, which reads ``num_segments`` and calls
    ``apply``."""

    def __init__(self, model):
        self.num_segments = model.num_segments
        self._apply = jax.jit(lambda v, x: model.apply(
            v, x, train=False, return_taps=True))

    def apply(self, variables, x, train=False, return_taps=False):
        assert return_taps and not train
        return self._apply(variables, x)


@functools.lru_cache(maxsize=None)
def jax_model(arch):
    """(jitted JAX model, flat variables drawn over its tree), kept per
    arch and module."""
    model = j_variant(arch, num_class=CLS, num_segments=T, temporal="action",
                      partial_bn=False)
    with tiny_resnet():
        shapes = jax.eval_shape(lambda r: model.init(
            r, jnp.zeros((1, T, HW, HW, 3)), train=False),
            {"params": jax.random.key(0)})
        flat = draw(shapes, seed=3 if arch == "tsn" else 4)
        return _Jitted(model), flat


@functools.lru_cache(maxsize=None)
def jax_cam(arch, exit, class_idx):
    model, flat = jax_model(arch)
    with tiny_resnet():
        return j_gradcam(model, unflatten_dict(flat), jnp.asarray(_clip()),
                         class_idx=class_idx, exit=exit)


@functools.lru_cache(maxsize=None)
def port(arch, mode):
    """The port's model with the JAX model's weights, kept per arch, mode
    and module (``gradcam`` leaves it as it found it, at eval)."""
    with tiny_resnet():
        m = variant(arch, num_class=CLS, num_segments=T, temporal="action",
                    partial_bn=False, action_fused=mode, device="cpu")
    load_jax_variables(m, jax_model(arch)[1])
    return m


class TestTaps:
    @pytest.mark.parametrize("mode", [None, "mega"])
    def test_taps_match_jax(self, mode):
        """Every tap of ``tsn_sd`` (stem, layer1-4, pool) transposed to
        JAX's layout, and the 8-tuple beside them."""
        model, flat = jax_model("tsn_sd")
        with tiny_resnet():
            want_out, want = model.apply(unflatten_dict(flat),
                                         jnp.asarray(_clip()),
                                         return_taps=True)
        with torch.no_grad():
            got_out, got = port("tsn_sd", mode)(torch.from_numpy(_clip()),
                                                return_taps=True)
        assert sorted(got) == sorted(want) == [
            "layer1", "layer2", "layer3", "layer4", "pool", "stem"]
        for name, g in got.items():
            g = g.numpy()
            if g.ndim == 4:
                g = g.transpose(0, 2, 3, 1)
            w = np.asarray(want[name])
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)
        np.testing.assert_allclose(got_out[0].numpy(), np.asarray(want_out[0]),
                                   rtol=1e-4, atol=ATOL)

    @pytest.mark.parametrize("arch", ["tsn", "tsn_mtmm", "tsn_sd",
                                      "tsn_middle2"])
    def test_every_surface_returns_its_output_and_taps(self, arch):
        """``return_taps`` gives ``(out, taps)`` with the output of a plain
        call; a truncated deploy's taps stop at its stage."""
        with tiny_resnet():
            m = variant(arch, num_class=CLS, num_segments=T,
                        temporal="action", partial_bn=False, device="cpu",
                        generator=torch.Generator().manual_seed(1))
        x = torch.from_numpy(_clip())
        with torch.no_grad():
            plain = m(x)
            out, taps = m(x, return_taps=True)
        for a, b in zip(*(o if isinstance(o, tuple) else (o,)
                          for o in (plain, out))):
            assert torch.equal(a, b)
        want = ["layer1", "layer2", "stem"] if arch == "tsn_middle2" else \
            ["layer1", "layer2", "layer3", "layer4", "pool", "stem"]
        assert sorted(taps) == want
        assert taps["layer1"].shape == (T, 256, HW // 4, HW // 4)


class TestGradCAM:
    @pytest.mark.parametrize("arch,exit,class_idx,mode", CASES)
    def test_cam_matches_jax(self, arch, exit, class_idx, mode):
        want_cam, want_logits = jax_cam(arch, exit, class_idx)
        cam, logits = gradcam(port(arch, mode), torch.from_numpy(_clip()),
                              class_idx=class_idx, exit=exit)
        size = next(s for a, e, _, s in EXITS if (a, e) == (arch, exit))
        assert cam.shape == want_cam.shape == (T, size, size)
        assert logits.shape == (1, CLS)
        assert cam.max() == 1.0 and cam.min() >= 0.0        # normalized
        np.testing.assert_allclose(logits, want_logits, rtol=0, atol=ATOL)
        np.testing.assert_allclose(cam, want_cam, rtol=0, atol=ATOL)
        assert int(np.argmax(logits[0])) == int(np.argmax(want_logits[0]))

    def test_class_none_is_the_argmax_of_video_0(self):
        m = port("tsn", None)
        cam, logits = gradcam(m, torch.from_numpy(_clip()))
        again, _ = gradcam(m, torch.from_numpy(_clip()),
                           class_idx=int(np.argmax(logits[0])))
        np.testing.assert_array_equal(cam, again)
        assert not m.training

    def test_overlay_is_jax_bitwise(self):
        rng = np.random.default_rng(5)
        frame = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        for cam in (rng.random((2, 2)).astype(np.float32),
                    rng.random((16, 16)).astype(np.float32),
                    jax_cam("tsn_sd", "mid1", 2)[0][0]):
            got = overlay_cam(frame, cam)
            assert got.dtype == np.uint8 and got.shape == frame.shape
            np.testing.assert_array_equal(got, j_overlay_cam(frame, cam))
