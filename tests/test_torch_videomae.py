"""VideoMAE on the CPU against the JAX package (``ehgr_tpu/models/
videomae.py``): a tiny encoder (dim 32, depth 2, 2 heads, tubelet 2, patch
8; T=4, 32^2: 32 tokens, 5 classes), fp32, weights drawn with numpy from a
fixed seed over the JAX variable tree and converted with
``models/convert.py`` (loaded strictly).  Held within TOL of the max |JAX
value|: the logits and every parameter's gradient of a fixed linear probe
of them (``jax.grad``).  Also ``sincos_pos_embed`` bitwise, the HF
converter against a real ``transformers`` ``VideoMAEForVideoClassification``
(weights redrawn so the logits are O(1); the q/v biases are HF's separate
``q_bias`` / ``v_bias``), ``--vit`` through ``config_from_args`` and
``build_model``, and ``cli.train_videomae``.

``transformers`` is imported through ``_transformers``: a torchvision shim
installed in ``sys.modules`` by another test file of the same worker (it
has no ``__spec__``) would break its import, so the shim is hidden while
it imports.  This file installs no shim."""

import dataclasses
import glob
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from ehgr_tpu import configs as jc
from ehgr_tpu.models.videomae import VideoMAE as JVideoMAE
from ehgr_tpu.models.videomae import sincos_pos_embed as j_sincos
from ehgr_tpu_torch import configs as pc
from ehgr_tpu_torch.cli import train_videomae
from ehgr_tpu_torch.models.convert import (load_jax_variables,
                                           state_dict_from_jax)
from ehgr_tpu_torch.models.factory import build_model
from ehgr_tpu_torch.models.videomae import (VideoMAE, convert_hf_videomae,
                                            hf_videomae_key_map,
                                            sincos_pos_embed)

CLS, N, T, HW = 5, 2, 4, 32
TINY = dict(dim=32, depth=2, heads=2, tubelet=2, patch=8)
TOL = 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _transformers():
    """``transformers``, imported with any ``__spec__``-less torchvision
    shim hidden from ``sys.modules`` (restored after)."""
    shim = {k: v for k, v in sys.modules.items()
            if k.split(".")[0] == "torchvision"
            and getattr(v, "__spec__", None) is None}
    for k in shim:
        del sys.modules[k]
    try:
        return pytest.importorskip("transformers")
    finally:
        sys.modules.update(shim)


def draw(shapes, seed=0):
    """Kernels N(0, 1/fan_in), LayerNorm scales U(0.5, 1.5), biases
    N(0, 0.1^2); f32, leaves in sorted path order."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in sorted(flatten_dict(shapes).items()):
        if path[-1] == "kernel":
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif path[-1] == "scale":
            a = rng.uniform(0.5, 1.5, s.shape)
        else:
            a = rng.normal(0.0, 0.1, s.shape)
        out[path] = np.asarray(a, np.float32)
    return out


def _x(seed=7):
    return np.random.default_rng(seed).standard_normal(
        (N, T, HW, HW, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_run():
    """(flat variables, probe weights, logits, flat gradients of the
    probe) of the JAX model, one jitted call."""
    model = JVideoMAE(num_class=CLS, **TINY)
    x = jnp.asarray(_x())
    shapes = jax.eval_shape(lambda r: model.init(r, x, train=False),
                            {"params": jax.random.key(0)})
    flat = draw(shapes)
    w = np.random.default_rng(11).standard_normal((N, CLS)) \
        .astype(np.float32)

    @jax.jit
    def run(params):
        def probe(p):
            logits = model.apply({"params": p}, x, train=False)
            return jnp.sum(logits * w), logits
        return jax.grad(probe, has_aux=True)(params)

    grads, logits = jax.device_get(run(unflatten_dict(flat)["params"]))
    return flat, w, np.asarray(logits), {
        ("params",) + p: np.asarray(a) for p, a in flatten_dict(grads).items()}


@pytest.fixture(scope="module")
def port_run(jax_run):
    flat, w, _, _ = jax_run
    model = VideoMAE(CLS, **TINY, device="cpu")
    load_jax_variables(model, flat)
    logits = model(torch.from_numpy(_x()))
    (logits * torch.from_numpy(w)).sum().backward()
    return model, logits.detach().numpy()


def test_logits(jax_run, port_run):
    assert port_run[1].shape == (N, CLS)
    assert _rel(port_run[1], jax_run[2]) <= TOL


def test_gradients(jax_run, port_run):
    want = state_dict_from_jax(jax_run[3])
    got = {k: p.grad for k, p in port_run[0].named_parameters()}
    assert set(got) == set(want)
    errs = {k: _rel(got[k], w) for k, w in want.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])


@pytest.mark.parametrize("n_pos,dim", [(8, 32), (1568, 768), (7, 10)])
def test_sincos_pos_embed_bitwise(n_pos, dim):
    got, want = sincos_pos_embed(n_pos, dim), j_sincos(n_pos, dim)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_attention_softmax_in_fp32():
    """bf16 compute: the scores' softmax runs in fp32 and is cast back, so
    the attention probabilities of a row sum to 1 within bf16 rounding."""
    model = VideoMAE(CLS, **TINY, dtype=torch.bfloat16, device="cpu")
    seen = {}
    attn = model.block0.attn
    orig = torch.softmax

    def spy(t, dim):
        seen["dtype"] = t.dtype
        return orig(t, dim=dim)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "softmax", spy)
        out = attn(torch.randn(1, 8, TINY["dim"]).to(torch.bfloat16))
    assert seen["dtype"] == torch.float32 and out.dtype == torch.bfloat16
    assert model(torch.from_numpy(_x())).dtype == torch.float32


def _redraw_hf(hf, seed=3):
    """Weights of an HF module redrawn so its logits are O(1): matrices
    N(0, 1/fan_in), LayerNorm weights U(0.5, 1.5), every bias (the q/v
    ones too) N(0, 0.1^2)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if p.dim() >= 2:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g) * fan_in ** -0.5)
            elif name.endswith("weight"):
                p.copy_(0.5 + torch.rand(p.shape, generator=g))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))


def test_hf_converter_against_transformers():
    transformers = _transformers()
    cfg = transformers.VideoMAEConfig(
        image_size=HW, patch_size=TINY["patch"], num_channels=3,
        num_frames=T, tubelet_size=TINY["tubelet"],
        hidden_size=TINY["dim"], num_hidden_layers=TINY["depth"],
        num_attention_heads=TINY["heads"], intermediate_size=4 * TINY["dim"],
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        use_mean_pooling=True, num_labels=CLS)
    hf = transformers.VideoMAEForVideoClassification(cfg).eval()
    _redraw_hf(hf)
    sd = hf.state_dict()
    model = VideoMAE(CLS, **TINY, device="cpu")
    assert convert_hf_videomae(sd, model) == []
    # every HF tensor is taken, the q/v biases from q_bias / v_bias
    assert set(hf_videomae_key_map(model).values()) == set(sd)
    assert torch.equal(model.block1.attn.v.bias,
                       sd["videomae.encoder.layer.1.attention.attention."
                          "v_bias"])
    x = _x()
    with torch.no_grad():
        ref = hf(torch.from_numpy(x).permute(0, 1, 4, 2, 3)).logits
        got = model(torch.from_numpy(x))
    assert ref.abs().max() > 0.1
    assert _rel(got, ref) <= TOL


def test_vit_flag_builds_the_encoder():
    """``--vit DIM DEPTH HEADS``: the config is the JAX parser's, every
    field, and ``build_model`` sizes VideoMAE from it."""
    argv = ["--vit", "32", "2", "2", "--clip_len", "4", "--num_classes",
            "5"]
    got, want = pc.config_from_args(argv), jc.config_from_args(argv)
    for part in ("data", "model", "optim", "loss", "run"):
        g = dataclasses.asdict(getattr(got, part))
        w = dataclasses.asdict(getattr(want, part))
        assert g == {k: w[k] for k in g}, part
    model = build_model(dataclasses.replace(got.model, arch="videomae"),
                        device="cpu")
    assert isinstance(model, VideoMAE) and model.depth == 2
    assert model.patch_embed.out_channels == 32
    assert model.block1.attn.heads == 2 and model.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="arch"):
        dataclasses.replace(got, model=dataclasses.replace(
            got.model, arch="vit")).validate()


@pytest.mark.parametrize("clip_len,want_t", [(4, 4), (5, 16)])
def test_train_videomae_cli(tmp_path, clip_len, want_t):
    """``cli.train_videomae --synthetic`` at tiny flags: arch
    ``videomae``, ``num_segments`` = clip_len (an odd one becomes 16), no
    shift, one parameter group; 2 steps; its checkpoints written."""
    res = train_videomae.main([
        "--synthetic", "--device", "cpu", "--clip_len", str(clip_len),
        "--crop_size", "32", "--scale_size", "32", "--num_classes", "5",
        "--batch_size", "4", "--synthetic_videos", "8", "--epochs", "1",
        "--vit", "32", "2", "2", "--run_dir", str(tmp_path)])
    assert np.isfinite(res["final_train_loss"])
    with open(os.path.join(res["run_dir"], "train.log")) as f:
        log = f.read()
    for want in ("arch='videomae'", f"clip_len={want_t}",
                 f"num_segments={want_t}", "is_shift=False",
                 "policies=False", "vit=(32, 2, 2)",
                 "Epoch 0 train: 2 steps"):
        assert want in log, want
    ckpts = glob.glob(os.path.join(res["run_dir"], "*_ckpt.pth"))
    assert len(ckpts) == 3
    sd = torch.load(sorted(ckpts)[-1], weights_only=True)["state_dict"]
    assert "block1.attn.q.bias" in sd and "block1.attn.k.bias" not in sd
