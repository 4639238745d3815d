"""The port's early-exit cascade (``ehgr_tpu_torch/eval/cascade.py``) on
the CPU, against ``ehgr_tpu.eval.cascade`` and mirroring
``tests/test_cascade.py``: bucket sizes, one ``tsn_sd`` checkpoint feeding
both stages, the threshold endpoints, the two-pass run against the sweep,
the curve's shape; then ``run_cascade_test`` of both packages on one
``.pth`` over the synthetic test set, row for row.

Models: the tiny ResNet (ResNet-50 widths, one bottleneck a stage), T=4,
32^2, 5 classes, f32; a seeded ``tsn_sd`` of the port (heads redrawn
from N(0, 0.3) so exit confidences spread) saved once as a ``.pth`` that
both packages' ``_build_model`` read.  The port's stages run
their ACTION kernels' plain versions ('mega'), JAX its XLA eval path.
Both stages' probabilities are held to JAX's within 1e-5; every exit
confidence must lie more than 1e-4 from each threshold of the curve, so a
tie would show as a failure instead of deciding a row."""

import dataclasses

import numpy as np
import pytest
import torch

from ehgr_tpu import configs as jc
from ehgr_tpu.eval import cascade as jcascade
from ehgr_tpu_torch import configs as pc
from ehgr_tpu_torch.cli import test_cascade as cli_cascade
from ehgr_tpu_torch.eval import cascade
from ehgr_tpu_torch.eval import runner
from ehgr_tpu_torch.models.tsn import variant

from test_torch_train import single_thread  # noqa: F401  (a fixture)
from test_torch_train import tiny_resnet

T, HW, CLS, CLIPS = 4, 32, 5, 2
TOL = 1e-5
TIE = 1e-4


def _flags(pth):
    return ["--preset", "ego_sd", "--synthetic", "--checkpoint_path", pth,
            "--clip_len", str(T), "--crop_size", str(HW), "--scale_size",
            str(HW), "--num_classes", str(CLS), "--clip_num", str(CLIPS),
            "--dropout", "0.0"]


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """A ``.pth`` of a seeded ``tsn_sd`` of the port, heads redrawn: the
    JAX package reads it with its reference-checkpoint loader."""
    rng = np.random.default_rng(0)
    with tiny_resnet():
        model = variant("tsn_sd", num_class=CLS, num_segments=T,
                        dtype=torch.float32, device="cpu",
                        generator=torch.Generator().manual_seed(7))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for k in sd:
        if "fc" in k:
            sd[k] = torch.from_numpy(rng.normal(0.0, 0.3, tuple(sd[k].shape))
                                     .astype(np.float32))
    path = str(tmp_path_factory.mktemp("sd") / "tsn_sd.pth")
    torch.save({"state_dict": sd}, path)
    return path


def _fp32(cfg, **data):
    """``cfg`` computing in f32 (the presets' bf16 rounds ~1e-3 apart in
    the two packages), with ``data`` set."""
    return cfg.replace(data=dataclasses.replace(cfg.data, **data),
                       model=dataclasses.replace(cfg.model, dtype="float32"))


def _config(pth, mode="mega"):
    return _fp32(pc.config_from_args(_flags(pth) + ["--action_fused", mode]),
                 num_workers=0)


@pytest.fixture(scope="module")
def stages(both_runs):
    """The port's two stages as its ``run_cascade_test`` built them from
    the one file (model, skipped keys), and their scorers."""
    return both_runs["port_stages"]


def _frames(v=8, seed=3):
    return np.random.default_rng(seed).integers(
        0, 256, (v, CLIPS, T, HW, HW, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def both_runs(pth):
    """``run_cascade_test`` of both packages on the one file, with the
    scores each hands to ``sweep_thresholds`` recorded; and the port's
    stages as it built them (``port_stages``)."""
    out = {}
    for name, mod, cfg, kw in (
            ("jax", jcascade, _fp32(jc.config_from_args(_flags(pth))), {}),
            ("port", cascade, _config(pth), dict(device="cpu"))):
        seen, built, fns = [], {}, []
        sweep, build = mod.sweep_thresholds, mod.build_cascade_score_fns

        def recording(scores, *a, _seen=seen, _sweep=sweep, **k):
            _seen.append(scores)
            return _sweep(scores, *a, **k)

        def building(*a, _fns=fns, _build=build, **k):
            _fns[:] = _build(*a, **k)
            return tuple(_fns)

        def build_model(cfg, arch, *a, _built=built,
                        _inner=runner._build_model):
            _built[arch] = _inner(cfg, arch, *a)
            return _built[arch]

        with pytest.MonkeyPatch.context() as mp, tiny_resnet():
            mp.setattr(mod, "sweep_thresholds", recording)
            mp.setattr(mod, "build_cascade_score_fns", building)
            if name == "port":
                mp.setattr(runner, "_build_model", build_model)
            res = mod.run_cascade_test(cfg, exit_k=1, **kw)
        out[name] = (res, seen[0])
    out["port_stages"] = (built, tuple(fns))
    return out


def test_bucket_size():
    assert cascade.bucket_size(0, 8) == 0
    assert cascade.bucket_size(1, 8) == 1
    assert cascade.bucket_size(3, 8) == 4
    assert cascade.bucket_size(5, 8) == 8
    assert cascade.bucket_size(7, 4) == 4   # capped at the pass-1 batch


def test_one_file_feeds_both_stages(pth, stages):
    """The exit stage takes the stem and its exit head, the full stage the
    final head, each from the one ``tsn_sd`` file, which keeps keys for
    neither model alone."""
    sd = torch.load(pth, weights_only=True)["state_dict"]
    (exit_model, exit_skipped), (full, full_skipped) = (
        stages[0]["tsn_middle1"], stages[0]["tsn"])
    mid, fin = exit_model.state_dict(), full.state_dict()
    for key in ("base_model.conv1.weight", "middle_fc1.weight"):
        assert torch.equal(mid[key], sd[key])
    assert torch.equal(fin["new_fc.weight"], sd["new_fc.weight"])
    assert "new_fc.weight" in exit_skipped and \
        "middle_fc1.weight" in full_skipped


@pytest.mark.usefixtures("single_thread")
def test_endpoints(stages):
    score_exit, score_full = stages[1]
    frames = _frames()
    p_exit = score_exit(frames).numpy()
    p_full = score_full(frames).numpy()
    none = cascade.execute_cascade(score_exit, score_full, frames, 0.0)
    assert not none["escalated"].any()
    np.testing.assert_array_equal(none["pred"], p_exit.argmax(-1))
    every = cascade.execute_cascade(score_exit, score_full, frames, 1.1)
    assert every["escalated"].all()
    np.testing.assert_array_equal(every["pred"], p_full.argmax(-1))


@pytest.mark.usefixtures("single_thread")
def test_execute_matches_sweep(stages):
    """The two-pass run (escalated videos gathered, padded with video 0
    to a power-of-two bucket) decides as the analytic combination at the
    median threshold, whose bucket (3 or 4 of 7 videos) needs padding."""
    score_exit, score_full = stages[1]
    frames = _frames(v=7)
    scores = cascade.collect_scores(score_exit, score_full,
                                    [(frames, np.arange(7) % CLS)])
    tau = float(np.median(scores["p_exit"].max(-1)))
    run = cascade.execute_cascade(score_exit, score_full, frames, tau)
    esc = scores["p_exit"].max(-1) < tau
    want = np.where(esc, scores["p_full"].argmax(-1),
                    scores["p_exit"].argmax(-1))
    np.testing.assert_array_equal(run["escalated"], esc)
    np.testing.assert_array_equal(run["pred"], want)
    assert 0 < esc.sum() < 7 and cascade.bucket_size(esc.sum(), 7) > \
        esc.sum()
    # the full stage scored them in the bucket of 4, not the batch of 7:
    # f32 sums in another order
    np.testing.assert_allclose(run["probs"][esc], scores["p_full"][esc],
                               rtol=0, atol=1e-6)


def test_sweep_curve_shape():
    rng = np.random.default_rng(1)
    p = rng.dirichlet(np.ones(CLS), (2, 8)).astype(np.float32)
    scores = {"p_exit": p[0], "p_full": p[1], "label": np.zeros(8, int)}
    rows = cascade.sweep_thresholds(scores, [0.0, 0.5, 1.1],
                                    rate_exit=1000.0, rate_full=400.0)
    assert rows == jcascade.sweep_thresholds(scores, [0.0, 0.5, 1.1],
                                             1000.0, 400.0)
    assert rows[0]["escalated_pct"] == 0.0
    assert rows[-1]["escalated_pct"] == 100.0
    fracs = [r["escalated_pct"] for r in rows]
    assert fracs == sorted(fracs)
    assert rows[0]["effective_clips_per_sec"] > \
        rows[-1]["effective_clips_per_sec"]
    assert rows[-1]["effective_clips_per_sec"] < 400.0


def test_stages_match_jax(both_runs):
    """Every video's exit and full probabilities, as the two
    ``run_cascade_test``s hand them to the sweep, within 1e-5; labels
    equal; and no exit confidence within 1e-4 of a threshold."""
    (_, js), (_, ps) = both_runs["jax"], both_runs["port"]
    np.testing.assert_array_equal(ps["label"], js["label"])
    for key in ("p_exit", "p_full"):
        assert ps[key].shape == js[key].shape == (32, CLS)
        np.testing.assert_allclose(ps[key], js[key], rtol=0, atol=TOL)
    conf = js["p_exit"].max(-1)
    gaps = np.abs(conf[:, None] - np.asarray(
        jcascade.DEFAULT_THRESHOLDS)[None]).min()
    assert gaps > TIE, gaps
    assert len(np.unique(conf < np.median(conf))) == 2


def test_run_cascade_test_matches_jax(both_runs):
    """The curve row for row, the one-head accuracies and the two-pass
    check (threshold within 1e-5, the same escalations)."""
    (jres, _), (pres, _) = both_runs["jax"], both_runs["port"]
    assert pres["curve"] == jres["curve"]
    for key in ("exit", "n_videos", "top1_exit_only", "top1_full_only"):
        assert pres[key] == jres[key], key
    jt, pt = jres["two_pass_check"], pres["two_pass_check"]
    assert abs(pt["threshold"] - jt["threshold"]) < TOL
    assert (pt["escalated"], pt["of"]) == (jt["escalated"], jt["of"])


def test_cli_on_the_cpu(pth, monkeypatch):
    """``cli.test_cascade`` hands ``run_cascade_test`` the config of its
    flags, its ``--cascade_exit`` and its ``--device``."""
    calls = []
    monkeypatch.setattr(cascade, "run_cascade_test",
                        lambda cfg, **k: calls.append((cfg, k)) or k)
    res = cli_cascade.main(_flags(pth) + ["--action_fused", "prologue",
                                          "--cascade_exit", "2",
                                          "--device", "cpu"])
    assert res == dict(exit_k=2, device="cpu")
    assert calls[0][0] == pc.config_from_args(
        _flags(pth) + ["--action_fused", "prologue"])
