"""The port's host data layer against the JAX package's, on the CPU: the
temporal samplers, the spatial transforms, the annotation builders, the
synthetic sources and trees, every dataset class, the loader, the factory
and ``config_from_args``.  Each pair gets the same inputs and the same
seeds; indices, crops, arrays, batches and DataFrames must be equal bit
for bit, and the generators they drew from must end in the same state."""

import dataclasses
import filecmp
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from ehgr_tpu import configs as jc
from ehgr_tpu.data import annotations as ja
from ehgr_tpu.data import datasets as jd
from ehgr_tpu.data import factory as jf
from ehgr_tpu.data import pipeline as jp
from ehgr_tpu.data import synthetic as jsyn
from ehgr_tpu.ops import spatial_transforms as jst
from ehgr_tpu.ops import temporal_transforms as jtt
from ehgr_tpu_torch import configs as pc
from ehgr_tpu_torch.data import annotations as pa
from ehgr_tpu_torch.data import datasets as pd_
from ehgr_tpu_torch.data import factory as pf
from ehgr_tpu_torch.data import pipeline as pp
from ehgr_tpu_torch.data import synthetic as psyn
from ehgr_tpu_torch.ops import spatial_transforms as pst
from ehgr_tpu_torch.ops import temporal_transforms as ptt

T = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rng_state(r):
    return r.bit_generator.state


def assert_same(a, b):
    """Equal nested samples: arrays bitwise with the same dtype, the rest
    by ``==``."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# --- temporal samplers --------------------------------------------------

_SEEDED = ("uniform_train", "dense_train", "random_crop",
           "uniform_ego_train")
_PLAIN = ("uniform_val", "uniform_test", "begin_crop", "end_crop",
          "center_crop", "uniform_ego_val")


class TestTemporal:
    @pytest.mark.parametrize("name", _SEEDED + _PLAIN)
    @pytest.mark.parametrize("num_frames,size", [(3, 8), (8, 8), (37, 8),
                                                 (120, 16)])
    def test_sampler(self, name, num_frames, size):
        if name in _SEEDED:
            rj, rp = np.random.default_rng(5), np.random.default_rng(5)
            for _ in range(4):
                assert_same(getattr(ptt, name)(num_frames, size, rp),
                            getattr(jtt, name)(num_frames, size, rj))
            assert _rng_state(rp) == _rng_state(rj)
        else:
            assert_same(getattr(ptt, name)(num_frames, size),
                        getattr(jtt, name)(num_frames, size))

    @pytest.mark.parametrize("num_frames,size,clips", [(40, 8, 10),
                                                       (5, 8, 3)])
    def test_dense_multi_clip_next_segment(self, num_frames, size, clips):
        assert_same(ptt.dense_test(num_frames, size, clips),
                    jtt.dense_test(num_frames, size, clips))
        rj, rp = np.random.default_rng(1), np.random.default_rng(1)
        sel = ptt.multi_clip_indices(num_frames, size, clips, rp)
        assert_same(sel, jtt.multi_clip_indices(num_frames, size, clips, rj))
        for row in sel:
            assert_same(ptt.next_segment_indices(row, num_frames),
                        jtt.next_segment_indices(row, num_frames))
        assert_same(ptt.loop_padding(np.arange(3), 7),
                    jtt.loop_padding(np.arange(3), 7))


# --- spatial transforms -------------------------------------------------

def _group(mode, n=6, size=(60, 80), seed=0):
    rng = np.random.default_rng(seed)
    h, w = size
    shape = (h, w, 3) if mode == "RGB" else (h, w)
    return [Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8),
                            mode) for _ in range(n)]


# (id, factory over (module, rng), mode)
_CHAINS = [
    ("scale_short", lambda m, r: m.GroupScale(40), "RGB"),
    ("scale_square", lambda m, r: m.GroupScale([36, 36]), "RGB"),
    ("center_crop", lambda m, r: m.Compose([m.GroupScale(40),
                                            m.GroupCenterCrop(32)]), "RGB"),
    ("random_crop", lambda m, r: m.GroupRandomCrop(32, rng=r), "RGB"),
    ("flip", lambda m, r: m.GroupRandomHorizontalFlip(rng=r), "RGB"),
    ("flip_flow", lambda m, r: m.GroupRandomHorizontalFlip(is_flow=True,
                                                           rng=r), "L"),
    ("multiscale", lambda m, r: m.GroupMultiScaleCrop(32, rng=r), "RGB"),
    ("multiscale_free", lambda m, r: m.GroupMultiScaleCrop(
        [32, 28], fix_crop=False, rng=r), "RGB"),
    ("multiscale_5", lambda m, r: m.GroupMultiScaleCrop(
        32, more_fix_crop=False, max_distort=2, rng=r), "L"),
    ("oversample", lambda m, r: m.GroupOverSample(32, 40), "RGB"),
    ("oversample_noflip", lambda m, r: m.GroupOverSample(32, 40, flip=False),
     "RGB"),
    ("fullres", lambda m, r: m.GroupFullResSample(32, 40), "L"),
    ("fullres_noflip", lambda m, r: m.GroupFullResSample(32, 40, flip=False),
     "RGB"),
    ("sized_crop", lambda m, r: m.GroupRandomSizedCrop(24, rng=r), "RGB"),
    ("rotate", lambda m, r: m.GroupMultiScaleRotate(rng=r), "RGB"),
    ("identity", lambda m, r: m.IdentityTransform(), "RGB"),
]


class TestSpatial:
    @pytest.mark.parametrize("mk,mode", [c[1:] for c in _CHAINS],
                             ids=[c[0] for c in _CHAINS])
    def test_transform(self, mk, mode):
        """The same PIL group through both: equal arrays over several
        draws, and the generators in the same state afterwards."""
        rj, rp = np.random.default_rng(3), np.random.default_rng(3)
        tj, tp = mk(jst, rj), mk(pst, rp)
        for i in range(4):
            group = _group(mode, seed=i)
            want = [np.asarray(im) for im in tj(group)]
            got = [np.asarray(im) for im in tp(group)]
            assert_same(got, want)
        assert _rng_state(rp) == _rng_state(rj)

    def test_crop_offsets(self):
        for more in (False, True):
            for geo in ((80, 60, 32, 32), (256, 341, 224, 168)):
                assert pst.fill_fix_offset(more, *geo) == \
                    jst.fill_fix_offset(more, *geo)
        rj, rp = np.random.default_rng(9), np.random.default_rng(9)
        tj = jst.GroupMultiScaleCrop(224, rng=rj)
        tp = pst.GroupMultiScaleCrop(224, rng=rp)
        for size in ((320, 240), (256, 256), (341, 256)):
            for _ in range(20):
                assert tp._sample_crop_size(size) == \
                    tj._sample_crop_size(size)
        assert len(pst.fill_fix_offset(True, 80, 60, 32, 32)) == 13

    def test_to_array_and_normalize(self):
        group = _group("RGB")
        for div, roll in ((True, False), (False, True)):
            a = pst.ToClipArray(div=div, roll=roll)(group)
            assert_same(a, jst.ToClipArray(div=div, roll=roll)(group))
            assert_same(pst.ClipNormalize((.4, .5, .6), (.2, .3, .4))(a),
                        jst.ClipNormalize((.4, .5, .6), (.2, .3, .4))(a))
        gray = pst.ToClipArray()(_group("L"))
        assert gray.shape == (6, 60, 80, 1)


# --- synthetic sources, trees and annotations -----------------------------

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The Ego and Nv trees each package writes from the same seed (the
    port's used below), and the annotation pickles each package's builders
    write from the port's trees."""
    out = {}
    for name, mod in (("jax", jsyn), ("port", psyn)):
        root = tmp_path_factory.mktemp(f"trees_{name}")
        out[name] = dict(
            root=str(root),
            ego=mod.make_synthetic_ego_tree(
                str(root / "ego"), subjects=(3, 1, 2),
                gestures_per_group=3, frames_per_gesture=12,
                size=(60, 80), num_classes=5, seed=2),
            nv=mod.make_synthetic_nv_tree(
                str(root / "nv"), n_videos=6, frames_per_video=12,
                size=(60, 80), num_classes=5, seed=3))
    port = out["port"]
    for name, mod in (("jax", ja), ("port", pa)):
        ego = os.path.join(port["root"], f"annot_ego_{name}")
        nv = os.path.join(port["root"], f"annot_nv_{name}")
        for mode in ("train", "val", "test", "train_plus_val"):
            mod.construct_annot_ego(port["ego"]["frame_path"],
                                    port["ego"]["label_path"], ego, mode)
        for mode in ("train", "test"):
            mod.construct_annot_nv(port["nv"], nv, mode)
        mod.make_10cls_splits(ego, classes=(0, 2, 4))
        mod.subset_annot(ego, "test", (1, 3), "test_remap",
                         remap_labels=True)
        out[f"annot_ego_{name}"], out[f"annot_nv_{name}"] = ego, nv
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


class TestSyntheticAndAnnotations:
    def test_trees_byte_equal(self, trees):
        a, b = trees["jax"]["root"], trees["port"]["root"]
        for sub in ("ego", "nv"):
            names = _files(os.path.join(a, sub))
            assert names and names == _files(os.path.join(b, sub))
            _, mismatch, errors = filecmp.cmpfiles(
                os.path.join(a, sub), os.path.join(b, sub), names,
                shallow=False)
            assert not mismatch and not errors

    @pytest.mark.parametrize("kind,mode", [
        ("ego", "train"), ("ego", "val"), ("ego", "test"),
        ("ego", "train_plus_val"), ("ego", "train_plus_val_10cls"),
        ("ego", "test_10cls"), ("ego", "test_remap"), ("nv", "train"),
        ("nv", "test")])
    def test_annotations_equal(self, trees, kind, mode):
        want = ja.load_annotations(trees[f"annot_{kind}_jax"], mode)
        got = pa.load_annotations(trees[f"annot_{kind}_port"], mode)
        assert len(got) > 0
        pd.testing.assert_frame_equal(got, want)

    def test_splits(self):
        assert pa.EGO_SPLITS == ja.EGO_SPLITS

    @pytest.mark.parametrize("cls,kw", [
        ("SyntheticClipSource", dict(num_classes=7)),
        ("SyntheticClipSource", dict(num_classes=7, clip_num=3)),
        ("LearnableClipSource", dict(num_classes=16)),
        ("LearnableClipSource", dict(num_classes=8, clip_num=2)),
        ("LearnableClipSource", dict(num_classes=16, hard=True,
                                     distractors=2, occlude=1)),
        ("LearnableClipSource", dict(num_classes=16, hard=True,
                                     dis_mixture=False))])
    def test_clip_sources(self, cls, kw):
        fields = ("rgb", "depth", "depth_est", "n_depth", "n_depth_est",
                  "label")
        mk = lambda mod: getattr(mod, cls)(n_videos=6, clip_len=T,
                                           size=(40, 48), fields=fields,
                                           seed=4, **kw)
        j, p = mk(jsyn), mk(psyn)
        assert len(p) == len(j) == 6
        assert_same(np.asarray(p.labels), np.asarray(j.labels))
        for i in range(len(p)):
            assert_same(p[i], j[i])


# --- datasets -------------------------------------------------------------

def _spatial(mod, seed):
    r = np.random.default_rng(seed)
    return mod.Compose([mod.GroupScale([44, 44]),
                        mod.GroupMultiScaleCrop([32, 32], rng=r)])


class TestDatasets:
    def test_registry(self):
        assert sorted(pd_.DATASETS) == sorted(jd.DATASETS)

    @pytest.mark.parametrize("name", sorted(jd.DATASETS))
    @pytest.mark.parametrize("temporal", ["uniform_train", "uniform_val",
                                          "dense_train"])
    def test_dataset(self, trees, name, temporal):
        """Each class with the PIL backend: every sample equal, and the
        dataset's and the transform's generators in the same state after
        the walk."""
        kw = dict(temporal_transform=temporal, clip_len=T, seed=6,
                  decode_backend="pil")
        if name in ("inference", "case_study"):
            kw["clip_num"] = 2
        j = jd.DATASETS[name](trees["annot_ego_jax"], "train",
                              spatial_transform=_spatial(jst, 8), **kw)
        p = pd_.DATASETS[name](trees["annot_ego_port"], "train",
                               spatial_transform=_spatial(pst, 8), **kw)
        assert len(p) == len(j) == 3
        for i in (0, 2, 1, 0):
            assert_same(p[i], j[i])
        assert _rng_state(p.rng) == _rng_state(j.rng)
        assert _rng_state(p.spatial.transforms[1].rng) == \
            _rng_state(j.spatial.transforms[1].rng)

    def test_unknown_sampler_raises(self, trees):
        ds = pd_.SDDataset(trees["annot_ego_port"], "train",
                           temporal_transform="bogus")
        with pytest.raises(ValueError):
            ds[0]


# --- the loader -----------------------------------------------------------

class _Indexed:
    """A dataset whose sample records its index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"rgb": np.full((2, 3, 3, 1), i, np.uint8),
                "label": np.int32(i), "paths": [f"f{i}"]}


class TestLoader:
    @pytest.mark.parametrize("shuffle", [False, True])
    @pytest.mark.parametrize("drop_last", [False, True])
    def test_same_batches(self, shuffle, drop_last):
        """The same batches in the same order, over two epochs."""
        ds = _Indexed(11)
        mk = lambda mod: mod.Loader(ds, batch_size=3, shuffle=shuffle,
                                    seed=5, num_workers=2,
                                    drop_last=drop_last)
        j, p = mk(jp), mk(pp)
        assert len(p) == len(j)
        for _ in range(2):
            got, want = list(p), list(j)
            assert len(got) == len(want) == len(p)
            assert_same(got, want)

    def test_worker_exception_reraised(self):
        class Exploding(_Indexed):
            def __getitem__(self, i):
                if i >= 4:
                    raise ValueError(f"boom at index {i}")
                return super().__getitem__(i)

        with pytest.raises(ValueError, match="boom"):
            list(pp.Loader(Exploding(8), batch_size=2, num_workers=2))

    def test_collate(self):
        samples = [_Indexed(3)[i] for i in range(3)]
        assert_same(pp.collate(samples), jp.collate(samples))


# --- the factory and the configs ------------------------------------------

def _small(mod, preset, annot, **data_kw):
    """A preset of ``mod``'s configs cut to small geometry."""
    cfg = mod.get_preset(preset)
    data = dict(annot_path=annot, clip_len=T, clip_num=2, scale_size=40,
                crop_size=32, train_crop_size=28, num_workers=1)
    data.update(data_kw)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, **data),
        model=dataclasses.replace(cfg.model, num_segments=T,
                                  num_classes=data.get(
                                      "num_classes", cfg.model.num_classes)))


_FACTORY = [("ego_mtmm", "ego", {}), ("nv_mtmm", "nv", {"test_crops": 1}),
            ("nv_mtmm", "nv", {"test_crops": 3}),
            ("nv_mtmm", "nv", {"test_crops": 5}),
            ("ego_sd", "synthetic", {"synthetic_task": "random"}),
            ("ego_sd", "synthetic", {"synthetic_task": "motion"}),
            ("nv_sd", "synthetic", {"synthetic_task": "motion_hard",
                                    "num_classes": 16})]


class TestFactory:
    @pytest.mark.parametrize("preset,kind,kw", _FACTORY,
                             ids=[f"{p}-{k}-{'-'.join(map(str, kw.values()))}"
                                  for p, k, kw in _FACTORY])
    def test_test_dataset(self, trees, preset, kind, kw):
        if kind == "synthetic":
            kw = dict(kw, backend="synthetic", synthetic_videos=8)
        j = jf.build_test_dataset(_small(jc, preset,
                                         trees.get(f"annot_{kind}_jax"),
                                         **kw))
        p = pf.build_test_dataset(_small(pc, preset,
                                         trees.get(f"annot_{kind}_port"),
                                         **kw))
        assert len(p) == len(j)
        for i in range(min(len(p), 3)):
            assert_same(p[i], j[i])

    @pytest.mark.parametrize("stage", ["baseline", "mtmm", "sd", "mtmm_sd"])
    @pytest.mark.parametrize("preset,kind,kw", [
        ("ego_mtmm", "ego", {}), ("nv_mtmm", "nv", {}),
        ("ego_mtmm", "synthetic", {"synthetic_task": "motion_hard",
                                   "num_classes": 16})])
    def test_train_datasets(self, trees, stage, preset, kind, kw):
        if kind == "synthetic":
            kw = dict(kw, backend="synthetic", synthetic_videos=8)
        for tpv in (True, False):
            j = jf.build_train_datasets(
                _small(jc, preset, trees.get(f"annot_{kind}_jax"), **kw),
                stage, train_plus_val=tpv)
            p = pf.build_train_datasets(
                _small(pc, preset, trees.get(f"annot_{kind}_port"), **kw),
                stage, train_plus_val=tpv)
            for dp, dj in zip(p, j):
                assert len(dp) == len(dj) > 0
                for i in range(min(len(dp), 2)):
                    assert_same(dp[i], dj[i])


_ARGV = [
    [], ["--synthetic"], ["--preset", "nv_sd", "--clip_num", "3",
                          "--test_crops", "5"],
    ["--preset", "ego_mtmm", "--lr", "0.01", "--wd", "1e-4", "--epochs", "3",
     "--lr_steps", "1", "2", "--dropout", "0.2", "--batch_size", "4"],
    ["--clip_len", "4", "--crop_size", "112", "--scale_size", "128",
     "--train_crop_size", "96", "--num_classes", "10", "--backend", "native",
     "--synthetic_videos", "16"],
    ["--action_fused", "mega", "--action_stages", "3", "4", "--shift_div",
     "4", "--base_model", "resnet101", "--modal", "rgb_depth"],
    ["--checkpoint_path", "w.pth", "--model_name", "m", "--run_dir", "r",
     "--ema_decay", "0.99", "--accum_steps", "2", "--dataset", "NvGesture",
     "--annot_path", "a", "--is_shift"],
]


class TestConfigs:
    @pytest.mark.parametrize("preset", sorted(jc.PRESETS))
    @pytest.mark.parametrize("argv", _ARGV, ids=range(len(_ARGV)))
    def test_config_from_args(self, preset, argv):
        """Every field of the port's Config equal to the JAX parser's."""
        argv = ["--preset", preset] + argv if "--preset" not in argv \
            else argv
        got = pc.config_from_args(argv)
        want = jc.config_from_args(argv)
        for part in ("data", "model", "optim", "loss", "parallel", "run"):
            g = dataclasses.asdict(getattr(got, part))
            w = dataclasses.asdict(getattr(want, part))
            assert g == {k: w[k] for k in g}, part
        for part in ("parallel", "run"):
            assert set(dataclasses.asdict(getattr(got, part))) == \
                set(dataclasses.asdict(getattr(want, part))), part

    @pytest.mark.parametrize("argv", [["--quantize", "static"],
                                      ["--quantize", "dynamic"],
                                      ["--vit", "8", "1", "2"]])
    def test_flags_not_ported_raise(self, argv):
        """The flags that once raised in the port, ``--quantize`` and
        ``--vit`` (VideoMAE's encoder size), are ported: each config is
        the JAX parser's, every field."""
        got, want = pc.config_from_args(argv), jc.config_from_args(argv)
        if argv[0] == "--vit":
            assert got.model.vit == want.model.vit == (8, 1, 2)
        else:
            assert got.model.quantize == want.model.quantize == argv[1]
        for part in ("data", "model", "optim", "loss", "parallel", "run"):
            g = dataclasses.asdict(getattr(got, part))
            w = dataclasses.asdict(getattr(want, part))
            assert g == {k: w[k] for k in g}, part


def test_runner_imports_no_jax_pil_or_pandas():
    """The runner, its CLIs and the data layer it needs import without
    JAX, the JAX package, Pillow or pandas (the card's machine has neither
    of the last two)."""
    code = ("import sys; import ehgr_tpu_torch.eval.runner, "
            "ehgr_tpu_torch.cli.test, ehgr_tpu_torch.cli.test_sd, "
            "ehgr_tpu_torch.data.datasets, ehgr_tpu_torch.data.native_io; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ehgr_tpu', 'PIL', 'pandas', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "[]"
