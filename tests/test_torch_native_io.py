"""The port's native decoder binding (``ehgr_tpu_torch/data/native_io.py``)
against the JAX package's binding and against PIL, on the CPU.

Both bindings load a library built from ``native/ehgr_io.cpp``; the port's
builds its own into ``ehgr_tpu_torch/_build/``.  For every chain the
planner covers, one clip decodes bitwise equal through the port's binding,
the JAX package's binding and PIL, and the transforms' generators end in
the same state.  Also: the datasets and the 3-crop NvGesture test dataset
on ``backend='native'``, a chain the planner does not cover (the dataset
decodes it with PIL), a library that fails to build (the native backend
raises, never falls back), and concurrent builds into one directory.

The module skips where ``g++`` or the libjpeg / libpng headers are
missing."""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from ehgr_tpu.data import native_io as jn
from ehgr_tpu.ops import spatial_transforms as jst
from ehgr_tpu_torch import configs as pc
from ehgr_tpu_torch.data import annotations as pa
from ehgr_tpu_torch.data import datasets as pd_
from ehgr_tpu_torch.data import factory as pf
from ehgr_tpu_torch.data import native_io as pn
from ehgr_tpu_torch.data import synthetic as psyn
from ehgr_tpu_torch.ops import spatial_transforms as pst

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def toolchain():
    """Skip the module where the decoder cannot be compiled here."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    for h in ("jpeglib.h", "png.h"):
        if not os.path.exists(os.path.join("/usr/include", h)):
            pytest.skip(f"{h} is not installed")


@pytest.fixture(scope="module", autouse=True)
def jax_binding(toolchain):
    """The JAX package's binding, loadable.  Its library is built when the
    test workers import ``tests/test_native_io.py``, all into one file at
    once; a worker that loaded it half written keeps that error for the
    process.  The file is whole by the time a test runs, so the error is
    cleared and the binding loads it again."""
    if jn._LIB is None and jn._LIB_ERR is not None:
        jn._LIB_ERR = None
    yield


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """8 RGB JPEG frames and 8 gray PNG frames, 80x60, from a seed."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    rgb, gray = [], []
    for i in range(8):
        p = str(root / f"f{i:03d}.jpg")
        Image.fromarray(rng.integers(0, 256, (60, 80, 3), np.uint8)).save(
            p, quality=90)
        rgb.append(p)
        g = str(root / f"g{i:03d}.png")
        Image.fromarray(rng.integers(0, 256, (60, 80), np.uint8), "L").save(g)
        gray.append(g)
    return rgb, gray


def _pil(paths, mode, transform):
    imgs = [Image.open(p).convert(mode) for p in paths]
    if transform is not None:
        imgs = transform(imgs)
    return np.stack([np.asarray(im).reshape(im.size[1], im.size[0], -1)
                     for im in imgs])


# (id, factory over (module, rng), mode): every chain the planner covers
_CHAINS = [
    ("train_ego", lambda m, r: m.Compose(
        [m.GroupScale([56, 56]), m.GroupMultiScaleCrop([48, 48], rng=r)]),
     "RGB"),
    ("train_nv", lambda m, r: m.Compose(
        [m.GroupScale(56), m.GroupMultiScaleCrop(48, rng=r)]), "RGB"),
    ("multiscale_free", lambda m, r: m.Compose(
        [m.GroupScale(56), m.GroupMultiScaleCrop(40, fix_crop=False,
                                                 rng=r)]), "RGB"),
    ("eval_center", lambda m, r: m.Compose(
        [m.GroupScale(56), m.GroupCenterCrop(48)]), "RGB"),
    ("eval_scale_only", lambda m, r: m.Compose([m.GroupScale([48, 48])]),
     "RGB"),
    ("random_crop_flip", lambda m, r: m.Compose(
        [m.GroupScale([56, 56]), m.GroupRandomCrop(48, rng=r),
         m.GroupRandomHorizontalFlip(rng=r)]), "RGB"),
    ("flip_only", lambda m, r: m.GroupRandomHorizontalFlip(rng=r), "RGB"),
    ("identity", lambda m, r: m.IdentityTransform(), "RGB"),
    ("crop3", lambda m, r: m.GroupFullResSample(32, 56, flip=False), "RGB"),
    ("crop10", lambda m, r: m.GroupOverSample(32, 56, flip=False), "RGB"),
    ("crop3_flip", lambda m, r: m.GroupFullResSample(32, 56, flip=True),
     "RGB"),
    ("crop10_flip", lambda m, r: m.GroupOverSample(32, 56), "RGB"),
    ("crop3_gray", lambda m, r: m.GroupFullResSample(32, 56, flip=False),
     "L"),
    ("depth_train", lambda m, r: m.Compose(
        [m.GroupScale([56, 56]), m.GroupMultiScaleCrop([48, 48], rng=r)]),
     "L"),
]


class TestDecode:
    def test_images_match_pil_and_jax(self, frames):
        rgb, gray = frames
        assert pn.image_size(rgb[0]) == jn.image_size(rgb[0]) == (80, 60)
        for p, g in zip(rgb[:3], gray[:3]):
            want = np.asarray(Image.open(p).convert("RGB"))
            np.testing.assert_array_equal(pn.decode_image(p), want)
            np.testing.assert_array_equal(
                pn.decode_image(g, size=(57, 31)),
                np.asarray(Image.open(g).convert("RGB").resize(
                    (57, 31), Image.BILINEAR)))
            np.testing.assert_array_equal(
                pn.decode_image(p, gray=True)[..., 0],
                np.asarray(Image.open(p).convert("L")))
            np.testing.assert_array_equal(pn.decode_image(g, (30, 20)),
                                          jn.decode_image(g, (30, 20)))

    @pytest.mark.parametrize("mk,mode", [c[1:] for c in _CHAINS],
                             ids=[c[0] for c in _CHAINS])
    def test_chain_bitwise(self, frames, mk, mode):
        """One clip through the port's binding, the JAX binding and PIL,
        three draws in a row from one generator each."""
        rgb, gray = frames
        src = gray if mode == "L" else rgb
        idx = np.array([0, 2, 3, 5, 7])
        rs = [np.random.default_rng(7) for _ in range(3)]
        tp, tj, tpil = mk(pst, rs[0]), mk(jst, rs[1]), mk(pst, rs[2])
        for _ in range(3):
            got = pn.decode_clip(src, idx, mode, tp)
            np.testing.assert_array_equal(
                got, jn.decode_clip(src, idx, mode, tj))
            np.testing.assert_array_equal(
                got, _pil([src[i] for i in idx], mode, tpil))
        assert rs[0].bit_generator.state == rs[1].bit_generator.state == \
            rs[2].bit_generator.state

    def test_fast_mode_matches_jax(self, frames):
        rgb, _ = frames
        t = lambda m: m.Compose([m.GroupScale([24, 24])])
        idx = np.arange(4)
        np.testing.assert_array_equal(
            pn.decode_clip(rgb, idx, "RGB", t(pst), fast=True),
            jn.decode_clip(rgb, idx, "RGB", t(jst), fast=True))

    def test_unsupported_chains_raise(self):
        for t in (pst.GroupRandomHorizontalFlip(is_flow=True),
                  pst.GroupRandomSizedCrop(24),
                  pst.Compose([pst.GroupCenterCrop(32), pst.GroupScale(40)]),
                  pst.Compose([pst.GroupFullResSample(32, 40),
                               pst.IdentityTransform()])):
            with pytest.raises(pn.UnsupportedChain):
                pn.plan_clip(t, 80, 60)
        with pytest.raises(pn.UnsupportedChain):
            pn.plan_clip(pst.GroupOverSample(32, 40), 80, 60, mode="L")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    ego = psyn.make_synthetic_ego_tree(str(root / "ego"), size=(60, 80),
                                       num_classes=5, frames_per_gesture=12)
    nv = psyn.make_synthetic_nv_tree(str(root / "nv"), n_videos=4,
                                     frames_per_video=12, size=(60, 80),
                                     num_classes=4)
    out = {"ego": str(root / "annot_ego"), "nv": str(root / "annot_nv")}
    for mode in ("train", "test"):
        pa.construct_annot_ego(ego["frame_path"], ego["label_path"],
                               out["ego"], mode)
        pa.construct_annot_nv(nv, out["nv"], mode)
    return out


def _train_chain(rng):
    return pst.Compose([pst.GroupScale([56, 56]),
                        pst.GroupMultiScaleCrop([48, 48], rng=rng)])


class TestDatasets:
    @pytest.mark.parametrize("name", sorted(pd_.DATASETS))
    def test_native_matches_pil(self, trees, name):
        kw = dict(temporal_transform="uniform_train", clip_len=4, seed=5)
        if name in ("inference", "case_study"):
            kw["clip_num"] = 2
        a, b = (pd_.DATASETS[name](
            trees["ego"], "train",
            spatial_transform=_train_chain(np.random.default_rng(11)),
            decode_backend=backend, **kw) for backend in ("pil", "native"))
        for i in (0, 1, 2, 0):
            sa, sb = a[i], b[i]
            for k in sa:
                if k != "paths":
                    np.testing.assert_array_equal(sa[k], sb[k])

    def test_nv_three_crops_native(self, trees):
        cfg = pc.get_preset("nv_baseline")
        cfg = cfg.replace(
            data=dataclasses.replace(
                cfg.data, annot_path=trees["nv"], clip_len=4, clip_num=2,
                scale_size=40, crop_size=32, num_classes=4),
            model=dataclasses.replace(cfg.model, num_segments=4,
                                      num_classes=4))
        a, b = (pf.build_test_dataset(cfg.replace(data=dataclasses.replace(
            cfg.data, backend=backend))) for backend in ("pil", "native"))
        for i in range(len(a)):
            sa, sb = a[i], b[i]
            assert sa["rgb"].shape == (2, 12, 32, 32, 3)
            np.testing.assert_array_equal(sa["rgb"], sb["rgb"])

    def test_unsupported_chain_decodes_with_pil(self, trees):
        """A chain the planner refuses: the native backend decodes the clip
        with PIL, its generators restored first, so the samples and the
        draws after them equal the PIL backend's."""
        def mk(backend):
            r = np.random.default_rng(4)
            return pd_.SDDataset(
                trees["ego"], "train", clip_len=4, seed=2,
                spatial_transform=pst.Compose(
                    [pst.GroupScale([56, 56]),
                     pst.GroupMultiScaleCrop([48, 48], rng=r),
                     pst.GroupRandomSizedCrop(32, rng=r)]),
                decode_backend=backend)
        a, b = mk("pil"), mk("native")
        for i in (0, 1, 2):
            np.testing.assert_array_equal(a[i]["rgb"], b[i]["rgb"])
        assert a.spatial.transforms[1].rng.bit_generator.state == \
            b.spatial.transforms[1].rng.bit_generator.state

    def test_failed_build_raises(self, trees, tmp_path, monkeypatch):
        """A library that does not compile: ``backend='native'`` raises
        instead of decoding with PIL, at every call."""
        bad = tmp_path / "broken.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(pn, "SRC", str(bad))
        monkeypatch.setattr(pn, "BUILD_DIR", str(tmp_path / "build"))
        assert not pn.available()
        ds = pd_.SDDataset(trees["ego"], "train", clip_len=4,
                           spatial_transform=_train_chain(
                               np.random.default_rng(0)),
                           decode_backend="native")
        for _ in range(2):
            with pytest.raises(RuntimeError, match="native io unavailable"):
                ds[0]


def test_concurrent_builds_share_one_library(tmp_path):
    """Four processes building the same source into one empty directory at
    once: each gets the one library, loads it, and no temporary file is
    left behind."""
    src = tmp_path / "ehgr_io.cpp"
    shutil.copy(pn.SRC, src)
    build = tmp_path / "build"
    code = ("import ctypes, sys; from ehgr_tpu_torch.data import native_io "
            "as n; p = n.build_library(sys.argv[1], sys.argv[2]); "
            "ctypes.CDLL(p); print(p)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(src),
                               str(build)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(build)) == sorted(
        ["lock", os.path.basename(paths.pop())])
