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

Compared: each head's video probabilities of every batch, as the runners
hand them to ``topk_correct`` (recorded there), within rtol = atol = 1e-4
(probabilities lie in [0, 1]; two f32 paths that sum in other orders
differ by ~1e-6), after asserting that every video's top-1 margin in the
JAX probabilities is above 1e-3, so no near tie decides the counts; then
``n_videos``, top-1/5 and the confusion matrices, equal.  Each JAX runner
runs once a configuration and module (``_RUNS``).  Also the two CLIs with
``--device cpu``."""

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

import jax
import jax.numpy as jnp

from test_torch_train import single_thread  # noqa: F401  (a fixture)
from test_torch_train import tiny_resnet

CLS, T, HW, CLIPS = 5, 4, 32, 2
TOL = 1e-4
MARGIN = 1e-3
# per case: JAX arch, heads, the port's ACTION mode, and the data
CASES = {"synthetic_h1": ("tsn", 1, "mega", "synthetic"),
         "synthetic_h4": ("tsn_sd", 4, "prologue", "synthetic"),
         "nv_3crop": ("tsn", 1, "vjp", "nv")}


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
    arch, _, mode, kind = CASES[case]
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
                                      action_fused=fused),
            run=dataclasses.replace(cfg.run, checkpoint_path=ckpt)))
    return out


def _recording(monkeypatch, module):
    """Record every probability array ``module.run_test`` hands to
    ``topk_correct``, in call order (batch by batch, head by head)."""
    seen = []
    inner = module.topk_correct

    def topk_correct(p, labels, ks):
        seen.append(np.asarray(p, np.float32))
        return inner(p, labels, ks)

    monkeypatch.setattr(module, "topk_correct", topk_correct)
    return seen


def _assert_margins(probs):
    """Every video's top-1 probability beats its second by over MARGIN."""
    for p in probs:
        top2 = np.sort(p, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MARGIN


_RUNS = {}


@pytest.fixture
def runs(weights, nv_annot, monkeypatch):
    """case -> ((JAX result, its probabilities), (port result, its
    probabilities), port config), each runner run once a case."""
    def get(case):
        if case not in _RUNS:
            arch, heads, _, _ = CASES[case]
            jcfg, pcfg = configs(case, weights[arch], nv_annot)
            with tiny_resnet(), monkeypatch.context() as mp:
                seen_j = _recording(mp, jrunner)
                res_j = jrunner.run_test(jcfg, arch=arch, heads=heads)
                seen_p = _recording(mp, prunner)
                res_p = prunner.run_test(pcfg, arch=arch, heads=heads,
                                         device="cpu")
            _RUNS[case] = (res_j, seen_j), (res_p, seen_p), pcfg
        return _RUNS[case]
    return get


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
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)

    def test_results_match_jax(self, runs, case):
        (want, seen), (got, _), _ = runs(case)
        _assert_margins(seen)
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

    def test_quantize_and_orbax_raise(self, weights, tmp_path):
        _, pcfg = configs("synthetic_h1", weights["tsn"])
        q = pcfg.replace(model=dataclasses.replace(pcfg.model,
                                                   quantize="static"))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            prunner.run_test(q, device="cpu")
        orbax = pcfg.replace(run=dataclasses.replace(
            pcfg.run, checkpoint_path=str(tmp_path)))
        with tiny_resnet(), pytest.raises(NotImplementedError,
                                          match="ROADMAP"):
            prunner._build_model(orbax, "tsn", "cpu")
