"""The recipe's tools and CLIs on the CPU, against the JAX package: the
case-study export (manifest and GIF frames), the pseudo-depth tree and the
MiDaS gate, ``prepare_data``'s annotation files, ``train_sd_actionnet`` /
``test_sd_actionnet``, ``reproduce`` (its rows, chains, listing and the
synthetic smoke chain), ``dress_rehearsal`` (a tiny plain run's report and
the learnable bar's verdicts) and ``utils/profiling``.

The models run ResNet-50 widths at one bottleneck a stage
(``tiny_resnet``) on one torch thread; the case study uses the GradCAM
file's drawn ``tsn`` weights (``test_torch_gradcam.jax_model``).  The JAX
rehearsal's report keys come from its ``main`` with training and the test
stubbed (``_stub_jax_rehearsal``): its keys are those of the code path,
not of the numbers."""

import argparse
import dataclasses
import filecmp
import json
import math
import os
import shutil
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import unflatten_dict

import cli.dress_rehearsal as j_rehearsal
import cli.prepare_data as j_prepare
import cli.reproduce as j_reproduce
from ehgr_tpu.data import datasets as j_datasets
from ehgr_tpu.data import pseudo_depth as j_pseudo
from ehgr_tpu.eval import case_study as j_case
from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu.ops import spatial_transforms as j_st
from ehgr_tpu.ops.preprocess_device import normalize_clip as j_normalize
from ehgr_tpu_torch.cli import dress_rehearsal, prepare_data, reproduce
from ehgr_tpu_torch.cli import test_sd, test_sd_actionnet, train_sd
from ehgr_tpu_torch.cli import train_sd_actionnet
from ehgr_tpu_torch.data import datasets, pseudo_depth
from ehgr_tpu_torch.data.synthetic import (make_synthetic_ego_tree,
                                           make_synthetic_nv_tree)
from ehgr_tpu_torch.eval import case_study
from ehgr_tpu_torch.models.tsn import variant
from ehgr_tpu_torch.ops import spatial_transforms as st
from ehgr_tpu_torch.utils import profiling

from test_torch_gradcam import jax_model, port
from test_torch_train import single_thread  # noqa: F401  (a fixture)
from test_torch_train import tiny_resnet

CLS, T, HW = 5, 4, 32
pytestmark = pytest.mark.usefixtures("single_thread")
# the tiny rehearsal of the port (the flags of the CPU dress run)
TINY_REHEARSAL = ["--crop", "32", "--clip_len", "4", "--batch", "4",
                  "--steps", "1", "--classes", "5", "--videos", "16"]
# top-1 of (final, mid1, mid2, mid3) and the task, for the learnable bar
BAR_TABLES = {
    "strict_ladder": ("motion_hard", (80.0, 50.0, 60.0, 70.0)),
    "step_inside_margin": ("motion_hard", (80.0, 50.0, 50.4, 70.0)),
    "saturated_head": ("motion_hard", (99.9, 80.0, 90.0, 99.6)),
    "final_below_70": ("motion_hard", (65.0, 30.0, 40.0, 50.0)),
    "legacy_motion": ("motion", (95.0, 90.0, 92.5, 93.0)),
}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_tree(a, b):
    names = _files(a)
    assert names and names == _files(b)
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors


def _gif_frames(path):
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in
                ImageSequence.Iterator(im)]


# --- the case study --------------------------------------------------------

@pytest.fixture(scope="module")
def ego_tree(tmp_path_factory):
    """A synthetic EgoGesture tree (frames 60x80) and its test split."""
    root = tmp_path_factory.mktemp("ego")
    paths = make_synthetic_ego_tree(str(root / "ego"), subjects=(3, 1, 2),
                                    gestures_per_group=4,
                                    frames_per_gesture=12, size=(60, 80),
                                    num_classes=CLS, seed=4)
    annot = str(root / "annot")
    prepare_data.main(["ego", "--frame_path", paths["frame_path"],
                       "--label_path", paths["label_path"],
                       "--save_path", annot])
    return annot


class TestCaseStudy:
    def test_export_matches_jax(self, ego_tree, tmp_path):
        """The same CaseStudyDataset (from each package, same seed) and
        weights: the same manifest and bitwise the same GIF frames."""
        def dataset(mod, tr):
            return mod.CaseStudyDataset(
                ego_tree, "test",
                spatial_transform=tr.Compose([tr.GroupScale([HW, HW])]),
                clip_len=T, clip_num=2, seed=1)

        flat = jax_model("tsn")[1]
        jm = j_variant("tsn", num_class=CLS, num_segments=T,
                       temporal="action", partial_bn=False)
        with tiny_resnet():
            want = j_case.export_case_study(
                jm, unflatten_dict(flat), dataset(j_datasets, j_st),
                str(tmp_path / "jax"), max_videos=3)
        got = case_study.export_case_study(
            port("tsn", "mega"), dataset(datasets, st),
            str(tmp_path / "port"), max_videos=3)
        assert len(got) == 3
        strip = lambda m: [dict(r, gif=os.path.basename(r["gif"]))
                           for r in m]
        assert strip(got) == strip(want)
        for g, w in zip(got, want):
            a, b = _gif_frames(g["gif"]), _gif_frames(w["gif"])
            assert len(a) == len(b) == T
            for fa, fb in zip(a, b):
                np.testing.assert_array_equal(fa, fb)

    def test_scores_match_jax(self):
        """``case_study_scores``: the clip-mean probabilities of JAX's
        scorer (normalize, model, softmax, mean over clips)."""
        flat = jax_model("tsn")[1]
        jm = j_variant("tsn", num_class=CLS, num_segments=T,
                       temporal="action", partial_bn=False)
        frames = np.random.default_rng(2).integers(
            0, 256, (3, T, HW, HW, 3), dtype=np.uint8)
        with tiny_resnet():
            x = j_normalize(jnp.asarray(frames), (0.485, 0.456, 0.406),
                            (0.229, 0.224, 0.225))
            logits = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
                unflatten_dict(flat), x)
        want = np.asarray(jnp.mean(jax.nn.softmax(logits, -1), 0))
        got = case_study.case_study_scores(port("tsn", None), frames)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("correct", [True, False])
    def test_annotate_frame_is_jax_bitwise(self, correct):
        frame = np.random.default_rng(3).integers(0, 256, (60, 80, 3),
                                                  dtype=np.uint8)
        got = case_study.annotate_frame(frame, "7", "3", correct)
        want = j_case.annotate_frame(frame, "7", "3", correct)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# --- pseudo-depth ----------------------------------------------------------

def _rgb_tree(root, n, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    d = root / "Subject01" / "Scene1" / "Color" / "rgb1"
    d.mkdir(parents=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (16, 16, 3),
                                     dtype=np.uint8)).save(d / f"{i:06}.jpg")


class TestPseudoDepth:
    @pytest.mark.parametrize("case", ["in_place", "root_with_rgb_substring",
                                      "separate_out_root"])
    def test_tree_is_jax_bitwise(self, tmp_path, case):
        """The three path cases of ``tests/test_tools.py``: each package
        writes its tree from the same source tree, byte for byte alike."""
        sub = {"in_place": "", "separate_out_root": "src",
               "root_with_rgb_substring": "my_rgb_Color_experiment/frames"}
        trees = {}
        for name, mod in (("jax", j_pseudo), ("port", pseudo_depth)):
            src = tmp_path / name / sub[case]
            _rgb_tree(src, 3, seed=9)
            out = tmp_path / name / "dst" if case == "separate_out_root" \
                else src
            assert mod.generate_pseudo_depth_tree(str(src), str(out)) == 3
            trees[name] = out / "Subject01" / "Scene1" / "Depth_Est"
        assert _files(trees["port"]) == [f"depth_est1/{i:06}.jpg"
                                         for i in range(3)]
        _same_tree(trees["jax"], trees["port"])

    def test_gray_predictor_is_jax_bitwise(self):
        frame = np.random.default_rng(1).integers(0, 256, (9, 7, 3),
                                                  dtype=np.uint8)
        np.testing.assert_array_equal(pseudo_depth._gray_predictor(frame),
                                      j_pseudo._gray_predictor(frame))

    def test_midas_gated(self, tmp_path):
        with pytest.raises(RuntimeError, match="MiDaS"):
            j_pseudo.midas_predictor()
        with pytest.raises(RuntimeError, match="MiDaS"):
            pseudo_depth.midas_predictor()
        with pytest.raises(RuntimeError, match="MiDaS"):
            pseudo_depth.midas_predictor(str(tmp_path / "missing.pt"))
        weights = tmp_path / "dpt_large-midas-2f21e586.pt"
        weights.write_bytes(b"")
        with pytest.raises(NotImplementedError, match="DPT"):
            pseudo_depth.midas_predictor(str(weights))


# --- prepare_data ----------------------------------------------------------

class TestPrepareData:
    def test_ego_matches_jax(self, tmp_path):
        """``ego --pseudo_depth --make_10cls``: the JAX CLI, then the port's,
        on one tree (the pickles name its frames): the same six annotation
        files byte for byte, and the port rewrites the same Depth_Est
        frames."""
        paths = make_synthetic_ego_tree(str(tmp_path / "ego"),
                                        subjects=(3, 1, 2),
                                        gestures_per_group=3,
                                        frames_per_gesture=10, size=(24, 32),
                                        num_classes=12, seed=6)
        frames = paths["frame_path"]
        argv = ["ego", "--frame_path", frames, "--label_path",
                paths["label_path"], "--pseudo_depth", "--make_10cls"]
        want = j_prepare.main(argv + ["--save_path", str(tmp_path / "j")])
        shutil.copytree(frames, tmp_path / "after_jax")
        got = prepare_data.main(argv + ["--save_path", str(tmp_path / "p")])
        assert [os.path.basename(p) for p in got] == \
            [os.path.basename(p) for p in want] == [
                "train.pkl", "val.pkl", "test.pkl", "train_plus_val.pkl",
                "train_plus_val_10cls.pkl", "test_10cls.pkl"]
        for g, w in zip(got, want):
            assert filecmp.cmp(g, w, shallow=False), g
        _same_tree(str(tmp_path / "after_jax"), frames)

    def test_nv_matches_jax(self, tmp_path):
        root = make_synthetic_nv_tree(str(tmp_path / "nv"), n_videos=6,
                                      frames_per_video=12, size=(24, 32),
                                      num_classes=5, seed=8)
        want = j_prepare.main(["nv", "--dataset_path", root, "--save_path",
                               str(tmp_path / "j")])
        got = prepare_data.main(["nv", "--dataset_path", root, "--save_path",
                                 str(tmp_path / "p")])
        assert [os.path.basename(p) for p in got] == ["train.pkl",
                                                      "test.pkl"]
        for g, w in zip(got, want):
            assert filecmp.cmp(g, w, shallow=False), g

    def test_midas_weights_raise(self, tmp_path):
        with pytest.raises(RuntimeError, match="MiDaS"):
            prepare_data.main(["ego", "--frame_path", str(tmp_path),
                               "--label_path", str(tmp_path),
                               "--save_path", str(tmp_path / "a"),
                               "--pseudo_depth", "--midas_weights",
                               str(tmp_path / "none.pt")])


# --- the SD-from-ACTION-Net CLIs --------------------------------------------

class TestSDActionNet:
    def test_trainer_is_train_sd(self):
        assert train_sd_actionnet.main is train_sd.main

    def test_test_cli_is_test_sd_without_confusion(self, tmp_path):
        """The port's ``test_sd`` already drops the confusion matrices, so
        ``test_sd_actionnet`` is that verb; one tiny run gives the four
        heads' keys and no ``confusion``."""
        assert test_sd_actionnet.main is test_sd.main
        with tiny_resnet():
            sd = variant("tsn_sd", num_class=CLS, num_segments=T,
                         temporal="action", partial_bn=False, device="cpu")
        path = str(tmp_path / "sd.pth")
        torch.save({"state_dict": sd.state_dict()}, path)
        argv = ["--preset", "ego_sd", "--synthetic", "--synthetic_videos",
                "8", "--clip_len", str(T), "--crop_size", str(HW),
                "--scale_size", str(HW), "--num_classes", str(CLS),
                "--clip_num", "2", "--checkpoint_path", path, "--device",
                "cpu"]
        with tiny_resnet():
            res = test_sd_actionnet.main(argv)
        assert "confusion" not in res and res["n_videos"] == 32
        assert {f"{h}_top{k}" for h in ("final", "mid1", "mid2", "mid3")
                for k in (1, 5)} <= set(res)


# --- reproduce -------------------------------------------------------------

def _repro_args(smoke):
    return argparse.Namespace(
        smoke=smoke, frame_path="/data/frames", label_path="/data/labels",
        dataset_path="/data/nv", annot_path="/data/annot",
        work_dir="/data/work")


class TestReproduce:
    def test_rows_match_jax(self):
        assert list(reproduce.ROWS) == list(j_reproduce.ROWS)
        for name, row in reproduce.ROWS.items():
            assert dataclasses.asdict(row) == \
                dataclasses.asdict(j_reproduce.ROWS[name])
        for k in ("EGO_TRAIN_CLIPS", "EGO_TEST_VIDEOS", "NV_TRAIN_CLIPS",
                  "NV_TEST_VIDEOS"):
            assert getattr(reproduce, k) == getattr(j_reproduce, k)

    @pytest.mark.parametrize("smoke", [False, True])
    def test_chains_match_jax(self, smoke):
        for name, row in reproduce.ROWS.items():
            assert reproduce._chain_argv(row, _repro_args(smoke)) == \
                j_reproduce._chain_argv(j_reproduce.ROWS[name],
                                        _repro_args(smoke)), name

    def test_list_prints_every_row(self, capsys):
        assert reproduce.main(["--list"]) == 0
        out = capsys.readouterr().out
        for name, row in reproduce.ROWS.items():
            line = next(l for l in out.splitlines() if l.startswith(name))
            assert f"{row.expected_top1:.2f}" in line
            assert " -> ".join(s.verb for s in row.stages) in line
            assert row.baseline_row in out

    def test_smoke_chain_on_cpu(self, tmp_path, monkeypatch):
        """``--smoke --row ego_mtmm_sd --device cpu``: MTMM, SD from its
        best file, the 4-head test on the SD best; finite losses."""
        results = []
        run_row = reproduce.run_row
        monkeypatch.setattr(reproduce, "run_row", lambda row, args: (
            results.append(run_row(row, args)) or results[-1]))
        with tiny_resnet():
            assert reproduce.main(["--row", "ego_mtmm_sd", "--smoke",
                                   "--device", "cpu", "--work_dir",
                                   str(tmp_path / "work")]) == 0
        res = results[0]
        assert math.isfinite(res["stage0_train_loss"])
        assert math.isfinite(res["stage1_train_loss"])
        assert res["n_videos"] == 32 and 0 <= res["final_top1"] <= 100
        shutil.rmtree(tmp_path / "work")


# --- dress_rehearsal -------------------------------------------------------

def _stub_jax_rehearsal(monkeypatch):
    """JAX's rehearsal with training and the test stubbed: each run makes
    its best-checkpoint directory under the run directory and returns
    fixed numbers."""
    import ehgr_tpu.data.factory as jf
    import ehgr_tpu.eval.runner as jr
    import ehgr_tpu.train.loop as jl

    def run_training(cfg, stage, *ds, **kw):
        run_dir = os.path.join(cfg.run.run_dir,
                               f"{stage}_{cfg.run.model_name}")
        os.makedirs(os.path.join(run_dir,
                                 f"{cfg.run.model_name}_best_ckpt"))
        return {"final_train_loss": 1.0, "best_top1": 50.0,
                "run_dir": run_dir}

    monkeypatch.setattr(jl, "run_training", run_training)
    monkeypatch.setattr(jf, "build_train_datasets", lambda c, s: (None, None))
    monkeypatch.setattr(jr, "run_test", lambda c, arch, heads: {
        "final_top1": 80.0, "mid1_top1": 50.0, "mid2_top1": 60.0,
        "mid3_top1": 70.0, "n_videos": 32})


class TestDressRehearsal:
    def test_tiny_plain_run(self, tmp_path, monkeypatch):
        """The port's rehearsal on the CPU at tiny geometry: its report
        file holds JAX's keys in JAX's order, then ``card``."""
        _stub_jax_rehearsal(monkeypatch)
        want = j_rehearsal.main(TINY_REHEARSAL + ["--out",
                                                  str(tmp_path / "j")])
        out = tmp_path / "p"
        with tiny_resnet():
            got = dress_rehearsal.main(TINY_REHEARSAL + [
                "--device", "cpu", "--out", str(out)])
        with open(out / "rehearsal_report.json") as f:
            assert json.load(f) == got
        assert list(got) == list(want)[:11] + ["card"] + list(want)[11:]
        assert got["card"] == "cpu" and got["ok"] is True
        assert math.isfinite(got["mtmm_loss"]) and \
            math.isfinite(got["sd_loss"])
        for k in ("batch", "clip_len", "crop", "classes", "learnable",
                  "task", "lr", "epochs", "videos", "n_videos"):
            assert got[k] == want[k], k
        ckpts = [os.path.join(d, f) for d, _, fs in os.walk(out)
                 for f in fs if f == "rehearsal_best_ckpt.pth"]
        assert len(ckpts) == 2
        shutil.rmtree(out)

    @pytest.mark.parametrize("table", sorted(BAR_TABLES))
    def test_bar_matches_jax(self, table, tmp_path, monkeypatch):
        import ehgr_tpu.eval.runner as jr
        import ehgr_tpu_torch.eval.runner as pr

        task, tops = BAR_TABLES[table]
        res = dict(zip(("final_top1", "mid1_top1", "mid2_top1",
                        "mid3_top1"), tops), n_videos=32)
        monkeypatch.setattr(jr, "run_test", lambda c, arch, heads: res)
        monkeypatch.setattr(pr, "run_test",
                            lambda c, arch, heads, device: res)
        args = types.SimpleNamespace(task=task, out="", device="cpu")
        reports = []
        for mod in (j_rehearsal, dress_rehearsal):
            out_dir = tmp_path / mod.__name__
            out_dir.mkdir()
            reports.append(mod._run_test_protocol(
                args, lambda *a, **k: None, {}, "best", str(out_dir),
                True))
        want, got = reports
        keys = ("exits_ordered", "no_head_saturated", "learnable_pass",
                "final_top1", "mid1_top1", "mid2_top1", "mid3_top1")
        assert {k: got.get(k) for k in keys} == \
            {k: want.get(k) for k in keys}
        verdict = {"strict_ladder": True, "step_inside_margin": False,
                   "saturated_head": False, "final_below_70": False,
                   "legacy_motion": True}[table]
        assert got["learnable_pass"] is verdict


# --- profiling -------------------------------------------------------------

class TestProfiling:
    def test_time_fn_keys(self):
        x = torch.ones(64, 64)
        out = profiling.time_fn(torch.matmul, x, x, warmup=1, iters=5,
                                percentiles=(50, 90, 99))
        assert sorted(out) == ["mean_ms", "min_ms", "p50_ms", "p90_ms",
                               "p99_ms"]
        assert 0 <= out["min_ms"] <= out["p50_ms"] <= out["p99_ms"]

    def test_trace_writes_a_file(self, tmp_path):
        x = torch.ones(32, 32)
        with profiling.trace(str(tmp_path / "trace")) as prof:
            with profiling.annotate("ehgr_span"):
                torch.matmul(x, x)
        path = tmp_path / "trace" / "trace.json"
        assert path.stat().st_size > 0
        names = {e.name for e in prof.events()}
        assert "ehgr_span" in names and "aten::matmul" in names
        assert "ehgr_span" in path.read_text()
