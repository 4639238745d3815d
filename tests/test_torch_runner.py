"""The test protocol as a whole on the CPU: the port's ``run_test`` against
``ehgr_tpu.eval.runner.run_test`` from one weights file.

Both runners build their model under ``tiny_resnet`` (ResNet-50 widths,
one bottleneck a stage) at T=4 and 32^2 with 5 classes in fp32, and both
load one ``.pth``: the JAX model's initial variables exported by
``ehgr_tpu.models.torch_import.export_state_dict``, with the heads redrawn
larger so each video's vote has a clear winner.  Cases: the synthetic
backend (``LearnableClipSource``, 32 videos x 2 clips) with ``heads=1``
and ``heads=4``, where the port runs its ACTION kernels' plain versions
(``'mega'``, and ``'prologue'`` for the SD model) against JAX's XLA eval
path ('vjp'); and the synthetic NvGesture tree at 3 crops through the PIL
backend, which folds the crops into the clip vote.

The fourth case, ``synthetic_int8``, is the first with int8 'static'
block convs (``--quantize static``): both runners calibrate on the first two
batches of their own test loader, whose clips and resulting ``act_scale``s
are compared too (equal; within 1e-5 relative).  The two packages' float
activations agree to rounding, so now and then an element lies on a
rounding tie of its code (k + 0.5) and the two sides take neighbouring
codes, after which that clip's activations part (``code_splits`` in
``tests/test_torch_quantize.py`` shows each such split to be a tie).  JAX
parts from itself the same way: its runner's scorer is one XLA program with
the normalization fused in, and its probabilities differ from a plain
jitted apply of the same model to the same normalized clips by up to 7e-2
(measured).  So in this case the reference is that plain apply, on the
port's normalized clips of each batch (normalization is bitwise JAX's),
and the probabilities and decisions are held to it for every video none of
whose clips split from it (17 of 32 when measured); at least MIN_CLEAN of
the videos must be such.  The port's top-1/5 counts and confusion matrix,
with the split videos' own part taken out, are the reference's over the
videos that did not split.

Compared: each head's video probabilities of every batch, as the runners
hand them to ``topk_correct`` (recorded there), within rtol = atol = 1e-4
(probabilities lie in [0, 1]; two f32 paths that sum in other orders
differ by ~1e-6), after asserting that every video's top-1 margin in the
JAX probabilities is above 1e-3, so no near tie decides the counts; then
``n_videos``, top-1/5 and the confusion matrices, equal.  Each JAX runner
runs once a configuration and module (``_RUNS``).  Also the two CLIs with
``--device cpu``, and the one deliberate difference of the two runners'
models (``temporal_pool`` and ``before_softmax`` from the config)."""

import dataclasses

import numpy as np
import pytest
import torch

from ehgr_tpu import configs as jc
from ehgr_tpu.eval import runner as jrunner
from ehgr_tpu.models.torch_import import export_state_dict
from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu_torch import configs as pc
from ehgr_tpu_torch.cli import test as cli_test
from ehgr_tpu_torch.cli import test_sd as cli_test_sd
from ehgr_tpu_torch.data.annotations import construct_annot_nv
from ehgr_tpu_torch.data.synthetic import make_synthetic_nv_tree
from ehgr_tpu_torch.eval import runner as prunner
from ehgr_tpu_torch.eval.metrics import ConfusionMatrix
from ehgr_tpu_torch.models.convert import torch_key
from ehgr_tpu_torch.ops.action import ActionConv
from ehgr_tpu_torch.ops.quantize import sites

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from test_torch_quantize import (code_splits, jax_site_inputs,
                                  record_site_inputs)
from test_torch_train import single_thread  # noqa: F401  (a fixture)
from test_torch_train import tiny_resnet

CLS, T, HW, CLIPS = 5, 4, 32, 2
TOL = 1e-4
MARGIN = 1e-3
# the least share of the int8 case's videos whose clips take JAX's codes
# at every site (none on a rounding tie)
MIN_CLEAN = 0.5
# per case: JAX arch, heads, the port's ACTION mode, the data and the int8
# mode
CASES = {"synthetic_h1": ("tsn", 1, "mega", "synthetic", False),
         "synthetic_h4": ("tsn_sd", 4, "prologue", "synthetic", False),
         "nv_3crop": ("tsn", 1, "vjp", "nv", False),
         "synthetic_int8": ("tsn", 1, "mega", "synthetic", "static")}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """arch -> a ``.pth`` of the JAX model's initial variables (heads
    redrawn from N(0, 0.1))."""
    out = {}
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("weights")
    with tiny_resnet():
        for arch in ("tsn", "tsn_sd"):
            model = j_variant(arch, num_class=CLS, num_segments=T)
            v = jax.jit(lambda r, m=model: m.init(
                {"params": r}, jnp.zeros((1, T, HW, HW, 3)), train=False))(
                    jax.random.key(3))
            sd = export_state_dict(v)
            for k in sd:
                if k.endswith("fc.weight") or k.endswith("fc.bias") or \
                        "middle_fc" in k:
                    sd[k] = rng.normal(0.0, 0.1, sd[k].shape).astype(
                        np.float32)
            path = str(root / f"{arch}.pth")
            torch.save({"state_dict": {k: torch.from_numpy(np.array(a))
                                       for k, a in sd.items()}}, path)
            out[arch] = path
    return out


@pytest.fixture(scope="module")
def nv_annot(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nv"))
    make_synthetic_nv_tree(root, n_videos=6, frames_per_video=24,
                           size=(60, 80), num_classes=CLS, seed=1)
    annot = str(tmp_path_factory.mktemp("nv_annot"))
    construct_annot_nv(root, annot, "test")
    return annot


def configs(case, ckpt, annot=None):
    """(JAX config, port config) of ``case``, from the same presets and
    the same small settings; the port's ACTION mode is the case's."""
    arch, _, mode, kind, quantize = CASES[case]
    preset = {"tsn": "ego_baseline", "tsn_sd": "ego_sd"}[arch]
    data = dict(clip_len=T, crop_size=HW, clip_num=CLIPS, num_classes=CLS)
    if kind == "synthetic":
        data.update(backend="synthetic", synthetic_task="motion",
                    synthetic_videos=64)
    else:
        preset = "nv_baseline"
        # one decode thread: the dataset's generator is shared by the
        # loader's workers, so more would draw the clips in thread order
        data.update(backend="pil", annot_path=annot, scale_size=40,
                    train_crop_size=HW, test_crops=3, num_workers=1)
    out = []
    for mod, fused in ((jc, "vjp"), (pc, mode)):
        cfg = mod.get_preset(preset)
        out.append(cfg.replace(
            data=dataclasses.replace(cfg.data, **data),
            model=dataclasses.replace(cfg.model, num_classes=CLS,
                                      num_segments=T, dtype="float32",
                                      action_fused=fused, quantize=quantize),
            run=dataclasses.replace(cfg.run, checkpoint_path=ckpt)))
    return out


def _recording(monkeypatch, module, labels=None):
    """Record every probability array ``module.run_test`` hands to
    ``topk_correct``, in call order (batch by batch, head by head), and
    into ``labels`` (if given) the labels beside it."""
    seen = []
    inner = module.topk_correct

    def topk_correct(p, lab, ks):
        seen.append(np.asarray(p, np.float32))
        if labels is not None:
            labels.append(np.asarray(lab))
        return inner(p, lab, ks)

    monkeypatch.setattr(module, "topk_correct", topk_correct)
    return seen


def _assert_margins(probs):
    """Every video's top-1 probability beats its second by over MARGIN."""
    for p in probs:
        top2 = np.sort(p, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MARGIN


def _built(monkeypatch, module):
    """Record each ``module._build_model`` call's calibration clips and
    what it returns; for the port's, also the model's input and each int8
    site's input at every forward after it is built (the scored batches).
    """
    seen = []
    inner = module._build_model

    def _build_model(*args, **kw):
        out = inner(*args, **kw)
        calib = kw["calib_batches"] if "calib_batches" in kw else \
            args[3] if len(args) > 3 else None
        seen.append((calib, out))
        if module is prunner:
            inputs = []
            out[0].register_forward_pre_hook(
                lambda mod, i: inputs.append(i[0].float().numpy().copy()))
            seen[-1] += (inputs,) + record_site_inputs(out[0])
        return out

    monkeypatch.setattr(module, "_build_model", _build_model)
    return seen


_RUNS = {}
_BUILT = {}
_LABELS = {}


@pytest.fixture
def runs(weights, nv_annot, monkeypatch):
    """case -> ((JAX result, its probabilities), (port result, its
    probabilities), port config), each runner run once a case; each
    runner's ``_build_model`` calls are kept in ``_BUILT[case]``, and the
    labels the port's runner scores against in ``_LABELS[case]``."""
    def get(case):
        if case not in _RUNS:
            arch, heads = CASES[case][:2]
            jcfg, pcfg = configs(case, weights[arch], nv_annot)
            with tiny_resnet(), monkeypatch.context() as mp:
                seen_j = _recording(mp, jrunner)
                built_j = _built(mp, jrunner)
                res_j = jrunner.run_test(jcfg, arch=arch, heads=heads)
                _LABELS[case] = []
                seen_p = _recording(mp, prunner, _LABELS[case])
                built_p = _built(mp, prunner)
                res_p = prunner.run_test(pcfg, arch=arch, heads=heads,
                                         device="cpu")
            _RUNS[case] = (res_j, seen_j), (res_p, seen_p), pcfg
            _BUILT[case] = built_j, built_p
        return _RUNS[case]
    return get


_INT8_REF = {}


def _int8_reference(runs, case):
    """Per scored batch of the int8 case: JAX's probabilities from a plain
    jitted apply of its calibrated model to the port's normalized clips of
    the batch, and which videos' clips took the same int8 codes on both
    sides at every site (None outside the int8 case)."""
    runs(case)
    if not CASES[case][4]:
        return None
    if case not in _INT8_REF:
        (_, (jmodel, jvars)), = _BUILT[case][0]
        (_, (model, _), inputs, names, seen), = _BUILT[case][1]
        scales = {n: m.act_scale.item() for n, m in model.named_modules()
                  if m in sites(model)}
        want_scales = {torch_key(p)[:-len(".act_scale")]: float(a)
                       for p, a in flatten_dict(jvars["quant"]).items()}
        with tiny_resnet():         # every batch in one apply
            logits, want_in = jax_site_inputs(jmodel, jvars,
                                              np.concatenate(inputs))
        split = code_splits(names, {n: np.concatenate(seen[n])
                                    for n in names},
                            want_in, scales, want_scales, T)
        probs = np.asarray(jax.nn.softmax(logits, axis=-1)).reshape(
            -1, CLIPS, CLS).mean(axis=1)
        clean = np.array([s is None for s in split]).reshape(
            -1, CLIPS).all(axis=1)
        cut = np.cumsum([len(x) // CLIPS for x in inputs])[:-1]
        out = list(zip(np.split(probs, cut), np.split(clean, cut)))
        assert clean.mean() >= MIN_CLEAN, clean
        _INT8_REF[case] = out
    return _INT8_REF[case]


@pytest.mark.parametrize("case", sorted(CASES))
class TestRunTest:
    def test_checkpoint_loads_whole(self, weights, case):
        arch = CASES[case][0]
        _, pcfg = configs(case, weights[arch])
        with tiny_resnet():
            model, skipped = prunner._build_model(pcfg, arch, "cpu")
        assert skipped == []
        assert not model.training

    def test_probabilities_match_jax(self, runs, case):
        (_, want), (_, got), _ = runs(case)
        assert len(got) == len(want) > 0
        _assert_margins(want)
        ref = _int8_reference(runs, case) or \
            [(w, slice(None)) for w in want]
        assert len(ref) == len(got)
        for g, (w, ok) in zip(got, ref):
            np.testing.assert_allclose(g[ok], w[ok], rtol=TOL, atol=TOL)

    def test_results_match_jax(self, runs, case):
        (want, seen), (got, seen_p), _ = runs(case)
        _assert_margins(seen)
        if CASES[case][4]:
            # int8: each decision of a video whose codes are JAX's, and the
            # counts over those videos
            assert got["n_videos"] == want["n_videos"] == 32
            ref = _int8_reference(runs, case)
            for g, (w, ok) in zip(seen_p, ref):
                np.testing.assert_array_equal(g[ok].argmax(-1),
                                              w[ok].argmax(-1))
            labels = np.concatenate(_LABELS[case])
            clean = np.concatenate([ok for _, ok in ref])
            port = np.concatenate(seen_p)[~clean]
            jref = np.concatenate([w for w, _ in ref])[clean]
            for k in (1, 5):
                def hits(p, lab):
                    return int((np.argsort(-p, axis=-1)[:, :k] ==
                                lab[:, None]).any(axis=1).sum())
                assert round(got[f"final_top{k}"] * 32 / 100) == \
                    hits(port, labels[~clean]) + hits(jref, labels[clean])
            split_cm, want_cm = ConfusionMatrix(CLS), ConfusionMatrix(CLS)
            split_cm.update(port.argmax(-1), labels[~clean])
            want_cm.update(jref.argmax(-1), labels[clean])
            np.testing.assert_array_equal(
                got["confusion"]["final"].m - split_cm.m, want_cm.m)
            return
        heads = CASES[case][1]
        names = ["final"] + [f"mid{i}" for i in range(1, heads)]
        assert sorted(got) == sorted(want)
        assert got["n_videos"] == want["n_videos"] == \
            (6 if case == "nv_3crop" else 32)
        for n in names:
            for k in (1, 5):
                assert got[f"{n}_top{k}"] == want[f"{n}_top{k}"]
            np.testing.assert_array_equal(got["confusion"][n].m,
                                          want["confusion"][n].m)
            assert got["confusion"][n].m.sum() == got["n_videos"]


def test_int8_calibration_matches_jax(runs):
    """``--quantize static``: both runners calibrate on the same clips (the
    first two batches of the test loader, 4 videos x 2 clips as
    ``[8, T, 32, 32, 3]`` uint8), and every site's ``act_scale`` (12: conv2,
    conv3 and the downsample of the four one-bottleneck stages) is JAX's
    within 1e-5 relative."""
    runs("synthetic_int8")
    (j_clips, (_, j_vars)), = _BUILT["synthetic_int8"][0]
    (p_clips, (model, _), *_), = _BUILT["synthetic_int8"][1]
    assert len(j_clips) == len(p_clips) == 2
    for a, b in zip(j_clips, p_clips):
        assert a.shape == (8, T, HW, HW, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    want = {torch_key(p)[:-len(".act_scale")]: float(a)
            for p, a in flatten_dict(j_vars["quant"]).items()}
    got = {n: m.act_scale.item() for n, m in model.named_modules()
           if m in sites(model)}
    assert len(got) == 12 and sorted(got) == sorted(want)
    assert all(v > 0 for v in got.values())
    np.testing.assert_allclose([got[k] for k in sorted(want)],
                               [want[k] for k in sorted(want)], rtol=1e-5)


def test_runner_builds_the_model_as_trained(weights):
    """The one deliberate difference of the two runners' models (README,
    "Known deltas"): the port builds through ``build_model``, which applies
    the config's ``temporal_pool`` and ``before_softmax`` (and ``modal``)
    as the trainers do, so a checkpoint is tested as it was trained; the
    JAX runner builds ``variant`` without them.  With the default options
    the two agree (``TestRunTest``).  With ``temporal_pool``, the port's
    full-depth ResNet-50 at T = 8 has 7 ACTION sites at T = 8 (stages 1-2)
    and 9 at T = 4 (stages 3-4); JAX's model is not pooled."""
    jcfg, pcfg = configs("synthetic_h1", "")
    opts = dict(temporal_pool=True, before_softmax=False)
    pcfg = pcfg.replace(
        data=dataclasses.replace(pcfg.data, clip_len=8),
        model=dataclasses.replace(pcfg.model, num_segments=8, **opts))
    model, _ = prunner._build_model(pcfg, "tsn", "cpu")
    segs = [m.n_segment for m in model.modules()
            if isinstance(m, ActionConv)]
    assert (segs.count(8), segs.count(4), len(segs)) == (7, 9, 16)
    assert model.temporal_pool and not model.before_softmax
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **opts))
    with tiny_resnet():
        jmodel, _ = jrunner._build_model(jcfg, "tsn")
    assert not jmodel.temporal_pool and jmodel.before_softmax


@pytest.mark.usefixtures("single_thread")
class TestCli:
    @pytest.mark.parametrize("cli,preset,arch,heads", [
        (cli_test, "ego_baseline", "tsn", 1),
        (cli_test_sd, "ego_sd", "tsn_sd", 4)])
    def test_cli_on_cpu(self, weights, cli, preset, arch, heads):
        """The CLI with ``--device cpu`` gives ``run_test``'s result for
        the config its flags make (bf16 compute, the preset's default)."""
        flags = ["--preset", preset, "--synthetic", "--clip_len", str(T),
                 "--crop_size", str(HW), "--clip_num", str(CLIPS),
                 "--num_classes", str(CLS), "--synthetic_videos", "8",
                 "--checkpoint_path", weights[arch]]
        with tiny_resnet():
            got = cli.main(flags + ["--device", "cpu"])
            want = prunner.run_test(pc.config_from_args(flags), arch=arch,
                                    heads=heads, device="cpu")
        want.pop("confusion")
        assert got == want
        assert got["n_videos"] == 32
        assert sorted(got) == sorted(
            ["n_videos"] + [f"{n}_top{k}" for n in
                            ["final"] + [f"mid{i}" for i in range(1, heads)]
                            for k in (1, 5)])

    @pytest.mark.parametrize("cli,preset,arch,heads", [
        (cli_test, "ego_baseline", "tsn", 1),
        (cli_test_sd, "ego_sd", "tsn_sd", 4)])
    def test_cli_quantize_on_cpu(self, weights, monkeypatch, cli, preset,
                                 arch, heads):
        """``--quantize static`` reaches both test CLIs through the config:
        the model they score has the int8 sites of its backbone (12 in the
        one-bottleneck ResNet-50), each calibrated, and the SD model's
        scala exits stay float; the result is ``run_test``'s for that
        config."""
        flags = ["--preset", preset, "--synthetic", "--clip_len", str(T),
                 "--crop_size", str(HW), "--clip_num", str(CLIPS),
                 "--num_classes", str(CLS), "--synthetic_videos", "8",
                 "--checkpoint_path", weights[arch], "--quantize", "static"]
        built = _built(monkeypatch, prunner)
        with tiny_resnet():
            got = cli.main(flags + ["--device", "cpu"])
            want = prunner.run_test(pc.config_from_args(flags), arch=arch,
                                    heads=heads, device="cpu")
        want.pop("confusion")
        assert got == want
        for _, (model, _), *_ in built:
            found = [n for n, m in model.named_modules()
                     if m in sites(model)]
            assert len(found) == 12 and all(
                n.startswith("base_model.") for n in found)
            assert all(m.act_scale.item() > 0 for m in sites(model))

    def test_quantize_and_orbax_raise(self, weights, tmp_path):
        """An orbax directory raises (reading orbax stays out of the port).
        ``--quantize`` is ported: its parity with the JAX runner is the
        ``synthetic_int8`` case and ``test_int8_calibration_matches_jax``."""
        _, pcfg = configs("synthetic_h1", weights["tsn"])
        orbax = pcfg.replace(run=dataclasses.replace(
            pcfg.run, checkpoint_path=str(tmp_path)))
        with tiny_resnet(), pytest.raises(NotImplementedError,
                                          match="ROADMAP"):
            prunner._build_model(orbax, "tsn", "cpu")
