"""The port's serving export (``ehgr_tpu_torch.serve``) on the CPU: the
scorers against the JAX package's ``make_video_scorer`` /
``make_clip_scorer`` on converted weights, and the artifact that
``torch.export`` makes of them.

Models: the tiny ResNet (ResNet-50 widths, one bottleneck a stage), T=4,
32^2, 5 classes, f32; the JAX variables of ``tsn_sd`` from one jitted init
and of ``tsn`` merged from them, converted with ``export_state_dict``.  On the CPU the
port's kernels run their plain versions inside their custom ops
(``ehgr::*``), which is what the exported graph must keep as nodes: the
counts of those nodes are pinned here, one per kernel site.  Each export
is made once per module (``artifacts``)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ehgr_tpu.models.torch_import import export_state_dict
from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu.serve import export as jexport
from ehgr_tpu.train.checkpoints import merge_variables
from ehgr_tpu_torch import configs as pc
from ehgr_tpu_torch.cli import export_serving
from ehgr_tpu_torch.eval import runner
from ehgr_tpu_torch.models.tsn import variant
from ehgr_tpu_torch.ops.action import ActionConv, TSMConv
from ehgr_tpu_torch.ops.preprocess_device import IMAGENET_MEAN, IMAGENET_STD
from ehgr_tpu_torch.ops.quantize import sites
from ehgr_tpu_torch.serve import export as serve

import jax
import jax.numpy as jnp

from test_torch_train import single_thread  # noqa: F401  (a fixture)
from test_torch_train import one_thread, tiny_resnet

ROOT = Path(__file__).resolve().parents[1]
CLS, T, HW, CLIPS = 5, 4, 32, 2
# probabilities of two f32 implementations that sum in other orders
TOL = 1e-5
# frames of the exported video scorers: not at crop size, so the program
# holds the on-device resize
FRAMES = (40, 48)


def _frames(seed, v, hw=(HW, HW)):
    return np.random.default_rng(seed).integers(
        0, 256, (v, CLIPS, T) + hw + (3,), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_models():
    """arch -> (JAX model, variables, the port's state dict of them): one
    jitted init of ``tsn_sd``, and ``tsn`` merged from it (every leaf of
    ``tsn`` is one of ``tsn_sd``'s, so its shapes alone are traced)."""
    out = {}
    x0 = jnp.zeros((1, T, HW, HW, 3))
    with tiny_resnet():
        sd_model = j_variant("tsn_sd", num_class=CLS, num_segments=T)
        v = jax.jit(lambda r: sd_model.init({"params": r}, x0,
                                            train=False))(jax.random.key(1))
        model = j_variant("tsn", num_class=CLS, num_segments=T)
        shapes = jax.eval_shape(lambda: model.init(
            {"params": jax.random.key(0)}, x0, train=False))
        merged, _ = merge_variables(dict(shapes), dict(v))
    for arch, m, variables in (("tsn_sd", sd_model, v),
                               ("tsn", model, merged)):
        sd = {k: torch.from_numpy(np.array(a))
              for k, a in export_state_dict(variables).items()}
        out[arch] = (m, variables, sd)
    return out


def _port(arch, sd=None, **kw):
    with tiny_resnet():
        m = variant(arch, num_class=CLS, num_segments=T, dtype=torch.float32,
                    device="cpu", generator=torch.Generator().manual_seed(2),
                    **kw)
    if sd is not None:
        m.load_state_dict(sd, strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def artifacts(jax_models, tmp_path_factory):
    """name -> (live scorer, artifact path, ``load_artifact``'s (fn,
    manifest), the live model): "cli", ``cli.export_serving --videos sym
    --quantize static --action_fused mega`` on the converted ``tsn``
    weights (the live scorer and model rebuilt as the CLI builds them);
    "tsm", a TSM video scorer on frames off the crop size, through
    ``export_artifact`` with a symbolic batch."""
    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    with one_thread():
        pth = str(root / "tsn.pth")
        torch.save({"state_dict": jax_models["tsn"][2]}, pth)
        path = str(root / "cli.ehgrtx")
        flags = ["--checkpoint_path", pth, "--quantize", "static",
                 "--action_fused", "mega", "--clip_len", str(T),
                 "--crop_size", str(HW), "--scale_size", str(HW),
                 "--num_classes", str(CLS), "--clip_num", str(CLIPS)]
        with tiny_resnet():
            res = export_serving.main(["--out", path, "--videos", "sym",
                                       "--device", "cpu", *flags])
            # the CLI's model made again: the same weights and the same
            # calibration (noise from the config's seed)
            model, _ = runner._build_model(
                pc.config_from_args(flags), "tsn", "cpu")
        live = serve.make_video_scorer(model, scale_size=HW, crop_size=HW)
        out["cli"] = (live, path, serve.load_artifact(path), model)
        assert res["bytes"] == os.path.getsize(path)
        made = {"tsm": (serve.make_video_scorer(
            _port("tsn", temporal="tsm"), scale_size=HW, crop_size=HW,
            dtype_name="float32"), (CLIPS, T) + FRAMES)}
        for name, (scorer, shape) in made.items():
            path = str(root / f"{name}.ehgrtx")
            program = serve.export_artifact(
                scorer, serve.symbolic_batch((8,) + shape + (3,)))
            serve.save_artifact(path, program, {"arch": name})
            out[name] = (scorer, path, serve.load_artifact(path),
                         scorer.model)
    return out


@pytest.mark.parametrize("arch,kind", [("tsn", "video"),
                                       ("tsn_sd", "clip")])
def test_scorer_matches_jax(jax_models, arch, kind):
    """On converted weights the port's scorer gives JAX's probabilities
    (the primary head of the multi-output ``tsn_sd``); the port runs its
    ACTION kernels' plain versions ('mega' for ``tsn``, 'prologue' for
    ``tsn_sd``).  The clip scorer's logits (``return_probs=False``) are the
    log of its probabilities up to a constant a clip."""
    jm, v, sd = jax_models[arch]
    m = _port(arch, sd, action_fused="mega" if arch == "tsn"
              else "prologue")
    frames = _frames(3, 3)
    if kind == "video":
        jfn = jexport.make_video_scorer(jm, v, scale_size=HW, crop_size=HW,
                                        dtype_name="float32")
        fn = serve.make_video_scorer(m, scale_size=HW, crop_size=HW,
                                     dtype_name="float32")
    else:
        frames = frames.reshape((-1, T, HW, HW, 3))
        kw = dict(mean=IMAGENET_MEAN, std=IMAGENET_STD, dtype_name="float32")
        jfn = jexport.make_clip_scorer(jm, v, **kw)
        fn = serve.make_clip_scorer(m, **kw)
        with torch.no_grad():
            logits = serve.make_clip_scorer(m, return_probs=False, **kw)(
                torch.from_numpy(frames))
        torch.testing.assert_close(torch.softmax(logits, -1),
                                   fn(torch.from_numpy(frames)))
    with tiny_resnet():
        want = np.asarray(jfn(jnp.asarray(frames)))
    with torch.no_grad():
        got = fn(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (len(frames), CLS)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.usefixtures("single_thread")
@pytest.mark.parametrize("name,batches", [("cli", (2,)),
                                          ("tsm", (1, 3, 5))])
def test_round_trip_is_bitwise_at_any_batch(artifacts, name, batches):
    """The loaded artifact gives the live scorer's output bit for bit, at
    each batch of its symbolic leading dimension (the TSM scorer's frames
    resized on the device)."""
    scorer, _, (fn, manifest), _ = artifacts[name]
    assert manifest["device"] == "cpu" and manifest["in_shape"][0] != "8"
    for v in batches:
        x = _frames(v, v, FRAMES if name == "tsm" else (HW, HW))
        with torch.no_grad():
            want = scorer(torch.from_numpy(x))
        got = fn(x)
        assert got.shape == (len(x), CLS)
        assert torch.equal(got, want), (name, v)


@pytest.mark.parametrize("name", ["cli", "tsm"])
def test_graph_holds_one_op_per_kernel_site(artifacts, name):
    """The guard against exporting the plain versions: one ``ehgr::`` node
    per kernel site of the model in the graph, as the manifest records
    them: for the CLI's int8 'mega' model the two ACTION kernels at each
    ACTION site and ``int8_conv`` at each of its 12 int8 sites (36 at full
    depth)."""
    _, _, (fn, manifest), model = artifacts[name]
    n = sum(isinstance(m, ActionConv) for m in model.modules())
    want = {"cli": {"ehgr::action_stats": n, "ehgr::action_apply": n,
                    "ehgr::int8_conv": len(sites(model))},
            "tsm": {"ehgr::tsm_shift": sum(
                isinstance(m, TSMConv) for m in model.modules())}}[name]
    assert all(v > 0 for v in want.values())
    assert name != "cli" or len(sites(model)) == 12
    assert manifest["ops"] == want
    assert serve.graph_ops(fn.program) == want


def test_cli_manifest(artifacts):
    """The CLI's manifest: the geometry, int8 'static', the device and
    torch version it was exported on and a symbolic video batch."""
    _, _, (_, manifest), _ = artifacts["cli"]
    assert {k: manifest[k] for k in (
        "arch", "clip_scorer", "num_segments", "crop_size", "scale_size",
        "num_classes", "quantize", "device", "torch_version")} == dict(
            arch="tsn", clip_scorer=False, num_segments=T, crop_size=HW,
            scale_size=HW, num_classes=CLS, quantize="static", device="cpu",
            torch_version=torch.__version__)
    assert manifest["in_shape"][1:] == [str(CLIPS), str(T), str(HW),
                                        str(HW), "3"]


def test_cli_refuses_platforms():
    with pytest.raises(SystemExit, match="--device"):
        export_serving.main(["--platforms", "tpu"])


def test_bad_magic_raises(tmp_path):
    bad = tmp_path / "bad.ehgrtx"
    bad.write_bytes(b"EHGRX1\n" + b"\0" * 64)
    with pytest.raises(ValueError, match="not an EHGRTX1 artifact"):
        serve.load_artifact(str(bad))


def test_unregistered_op_raises(artifacts, tmp_path):
    """A manifest naming a custom op this port does not register is
    refused before the program is read."""
    _, path, _, _ = artifacts["tsm"]
    blob = Path(path).read_bytes()
    hlen = int.from_bytes(blob[8:12], "little")
    manifest = json.loads(blob[12:12 + hlen])
    manifest["ops"]["ehgr::not_ported"] = 1
    header = json.dumps(manifest).encode()
    other = tmp_path / "other.ehgrtx"
    other.write_bytes(blob[:8] + len(header).to_bytes(4, "little") + header
                      + blob[12 + hlen:])
    with pytest.raises(RuntimeError, match="not_ported"):
        serve.load_artifact(str(other))


def test_subprocess_loads_without_model_code(artifacts, tmp_path):
    """A fresh process loads and runs the artifact through
    ``ehgr_tpu_torch.serve`` alone: no module of the port's models (nor of
    the JAX package) is imported, and its probabilities are the live
    scorer's (both on one thread)."""
    scorer, path, _, _ = artifacts["tsm"]
    x = _frames(11, 2, FRAMES)
    np.save(tmp_path / "x.npy", x)
    code = (
        "import json, sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from ehgr_tpu_torch.serve import load_artifact\n"
        f"fn, manifest = load_artifact({path!r})\n"
        f"y = fn(np.load({str(tmp_path / 'x.npy')!r}))\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, y.numpy())\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.startswith("
        "('ehgr_tpu_torch.models', 'ehgr_tpu.', 'jax')) or m == "
        "'ehgr_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    with one_thread(), torch.no_grad():
        want = scorer(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want)
