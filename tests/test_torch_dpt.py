"""DPT (the MiDaS depth model) on the CPU: the port against the JAX package
(``ehgr_tpu/models/dpt.py``) and against the real ``transformers``
``DPTForDepthEstimation``, at ``tests/test_dpt.py``'s ``TINY`` config
(dim 32, depth 4, 2 heads, hooks 0-3, 16 features, reassemble 16/24/32/40,
4x4 position grid), fp32.

* JAX variables drawn with numpy (kernels N(0, 1/fan_in), LayerNorm scales
  U(0.5, 1.5), biases N(0, 0.1^2), the head's last bias 1 so the depth
  after its ReLU is mostly nonzero) through ``models/convert.py``, which
  flips ``up1`` / ``up2`` in space: depth within TOL of max |JAX depth| at
  64^2 and at 32x96 (the 4x4 position grid shrinks on one axis and grows
  on the other).
* The MiDaS and HF loaders copy torch tensors as they are: the port is
  MiDaS's function.  Against the real HF module (weights redrawn the same
  way) the depth and refinenet1's output (a forward hook) are held
  relative to their own scale, which is checked to be non-degenerate
  first; the same model with ``up1`` / ``up2`` flipped misses.
* The JAX package's loaders put the torch kernels into its ``up1`` /
  ``up2`` unflipped, so its DPT is MiDaS with those two flipped: its
  ``convert_hf_dpt`` variables give the HF depth once they are flipped
  back, and miss it as they are; likewise its MiDaS loader against the
  port's.
* ``upsample2_align_corners`` (a size-1 axis too), the MiDaS key map's
  coverage and unused keys against JAX's, and ``midas_predictor`` on a
  saved tiny weights file (``dpt_large`` patched to ``TINY``).

``transformers`` is imported with any torchvision shim hidden
(``test_torch_videomae._transformers``); this file installs none."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from ehgr_tpu.models import dpt as j_dpt
from ehgr_tpu_torch.data import pseudo_depth
from ehgr_tpu_torch.models import dpt
from ehgr_tpu_torch.models.convert import load_jax_variables

from test_torch_videomae import _transformers

TINY = dict(embed_dim=32, depth=4, heads=2, hooks=(0, 1, 2, 3),
            features=16, reassemble=(16, 24, 32, 40), pos_grid=4)
TOL = 1e-4
# a flip of up1 / up2 must move the depth by more than this share of it
FLIP_MISS = 1e-2


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _non_degenerate(depth):
    depth = np.asarray(depth)
    assert np.abs(depth).max() > 0 and (depth == 0).mean() < 0.5, \
        (np.abs(depth).max(), (depth == 0).mean())


def draw(shapes, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in sorted(flatten_dict(shapes).items()):
        if path[-1] == "kernel":
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif path[-1] == "scale":
            a = rng.uniform(0.5, 1.5, s.shape)
        elif path[-1] in ("cls_token", "pos_embed"):
            a = rng.normal(0.0, 0.5, s.shape)
        else:
            a = rng.normal(0.0, 0.1, s.shape)
        out[path] = np.asarray(a, np.float32)
    out[("params", "head_conv3", "bias")][:] = 1.0
    return out


def _x(h, w, n=2, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (n, h, w, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_vars():
    model = j_dpt.DPT(**TINY)
    shapes = jax.eval_shape(lambda r: model.init(r, jnp.zeros(
        (1, 64, 64, 3))), {"params": jax.random.key(0)})
    return model, draw(shapes)


@pytest.mark.parametrize("h,w", [(64, 64), (32, 96)])
def test_depth_on_jax_variables(jax_vars, h, w):
    model, flat = jax_vars
    x = _x(h, w, n=2 if h == w else 1)
    want = np.asarray(jax.jit(model.apply)(unflatten_dict(flat),
                                           jnp.asarray(x)))
    _non_degenerate(want)
    port = dpt.DPT(**TINY, device="cpu")
    load_jax_variables(port, flat)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape[:3]
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 4, 2), (1, 3, 1, 2),
                                   (1, 1, 1, 4)])
def test_upsample2_align_corners(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(j_dpt.upsample2_align_corners(jnp.asarray(x)))
    got = dpt.upsample2_align_corners(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _midas_state_dict(model, seed=1):
    """A MiDaS-keyed state dict for ``model``: the port's own tensors
    renamed, plus refinenet4's never-called ``resConfUnit1``."""
    sd = model.state_dict()
    out = {k: sd[p].clone() for k, p in dpt.midas_key_map(model).items()}
    g = torch.Generator().manual_seed(seed)
    for c in ("conv1", "conv2"):
        key = f"scratch.refinenet4.resConfUnit1.{c}"
        out[key + ".weight"] = torch.randn(
            sd["refinenet4.res2.conv1.weight"].shape, generator=g)
        out[key + ".bias"] = torch.randn(
            sd["refinenet4.res2.conv1.bias"].shape, generator=g)
    return out


def _flip(t):
    return t.flip((-2, -1))


def test_midas_loader(jax_vars):
    """The port's MiDaS key map has JAX's keys; both loaders report the
    same unused keys; the port loads the tensors as they are and JAX's
    DPT on the same file is the port with ``up1`` / ``up2`` flipped."""
    jmodel, flat = jax_vars
    src = dpt.DPT(**TINY, device="cpu")
    load_jax_variables(src, flat)
    sd = _midas_state_dict(src)
    port = dpt.DPT(**TINY, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    assert set(dpt.midas_key_map(port)) == set(j_dpt.midas_key_map(jmodel))
    unused = dpt.convert_midas_state_dict(
        {"module." + k: v for k, v in sd.items()}, port)
    want_unused = [f"scratch.refinenet4.resConfUnit1.{c}.{leaf}"
                   for c in ("conv1", "conv2") for leaf in ("weight", "bias")]
    assert sorted(unused) == sorted(want_unused)
    for k, v in port.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k
    jvars, junused = j_dpt.convert_midas_state_dict(
        {k: v.numpy() for k, v in sd.items()}, unflatten_dict(flat), jmodel)
    assert sorted(junused) == sorted(unused)
    with pytest.raises(KeyError, match="without a tensor"):
        dpt.convert_midas_state_dict(
            {k: v for k, v in sd.items() if "head_conv" not in k
             and "output_conv.4" not in k}, port)

    x = _x(64, 64)
    jdepth = np.asarray(jax.jit(jmodel.apply)(jvars, jnp.asarray(x)))
    with torch.no_grad():
        depth = port(torch.from_numpy(x)).numpy()
        port.up1.weight.copy_(_flip(port.up1.weight))
        port.up2.weight.copy_(_flip(port.up2.weight))
        flipped = port(torch.from_numpy(x)).numpy()
    _non_degenerate(jdepth)
    assert _rel(flipped, jdepth) <= TOL
    assert _rel(depth, jdepth) > FLIP_MISS


def _hf_model():
    """A random ``DPTForDepthEstimation`` at the TINY config, its weights
    redrawn as ``draw`` draws JAX's (the head's last bias 1)."""
    transformers = _transformers()
    cfg = transformers.DPTConfig(
        hidden_size=TINY["embed_dim"], num_hidden_layers=TINY["depth"],
        num_attention_heads=TINY["heads"],
        intermediate_size=4 * TINY["embed_dim"], image_size=64,
        patch_size=16, backbone_out_indices=list(TINY["hooks"]),
        neck_hidden_sizes=list(TINY["reassemble"]),
        fusion_hidden_size=TINY["features"], readout_type="project",
        layer_norm_eps=1e-6, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    hf = transformers.DPTForDepthEstimation(cfg).eval()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=g) *
                        p[0].numel() ** -0.5)
            elif name.endswith("weight"):
                p.copy_(0.5 + torch.rand(p.shape, generator=g))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
        hf.head.head[4].bias.fill_(1.0)
    return hf


@pytest.fixture(scope="module")
def hf_run():
    """The HF model, its depth and refinenet1's output (the last fusion
    layer, through a forward hook) on one input."""
    hf = _hf_model()
    x = _x(64, 64)
    taps = {}
    hook = hf.neck.fusion_stage.layers[3].register_forward_hook(
        lambda m, i, o: taps.update(fused=o.detach().numpy()))
    with torch.no_grad():
        depth = hf(torch.from_numpy(x).permute(0, 3, 1, 2)) \
            .predicted_depth.numpy()
    hook.remove()
    return hf, x, depth, taps["fused"]


def test_hf_loader_against_transformers(hf_run):
    hf, x, ref, ref_fused = hf_run
    _non_degenerate(ref)
    assert np.abs(ref_fused).max() > 0.1
    port = dpt.DPT(**TINY, device="cpu")
    unused = dpt.convert_hf_dpt(hf.state_dict(), port)
    assert sorted(unused) == sorted(
        ["dpt.layernorm.weight", "dpt.layernorm.bias"]
        + [f"neck.fusion_stage.layers.0.residual_layer1.{c}.{leaf}"
           for c in ("convolution1", "convolution2")
           for leaf in ("weight", "bias")])
    taps = {}
    port.refinenet1.register_forward_hook(
        lambda m, i, o: taps.update(fused=o.numpy()))
    with torch.no_grad():
        depth = port(torch.from_numpy(x))
        assert _rel(depth, ref) <= TOL
        assert _rel(taps["fused"], ref_fused) <= TOL
        port.up1.weight.copy_(_flip(port.up1.weight))
        port.up2.weight.copy_(_flip(port.up2.weight))
        assert _rel(port(torch.from_numpy(x)), ref) > FLIP_MISS


def test_jax_hf_variables_are_midas_with_up_flipped(hf_run):
    """JAX's ``convert_hf_dpt`` puts HF's ``up1`` / ``up2`` kernels in
    unflipped: its depth misses the HF module's, and matches it once those
    two kernels alone are flipped in space (relative to the depth's
    scale)."""
    hf, x, ref, _ = hf_run
    model = j_dpt.DPT(**TINY)
    v = jax.jit(lambda r: model.init(r, jnp.zeros((1, 64, 64, 3))))(
        jax.random.key(0))
    v, _ = j_dpt.convert_hf_dpt(hf.state_dict(), v, model)
    flipped = dict(v["params"])
    for name in ("up1", "up2"):
        flipped[name] = {**v["params"][name],
                         "kernel": v["params"][name]["kernel"][::-1, ::-1]}
    apply = jax.jit(model.apply)
    got = np.asarray(apply(v, jnp.asarray(x)))
    got_flipped = np.asarray(apply({**v, "params": flipped}, jnp.asarray(x)))
    assert _rel(got_flipped, ref) <= TOL
    assert _rel(got, ref) > FLIP_MISS


def test_midas_predictor_end_to_end(tmp_path, monkeypatch):
    """``midas_predictor`` on a saved MiDaS-keyed file (``dpt_large``
    patched to the tiny config in both packages) against the JAX package's
    ``midas_predictor`` on the same file with ``up1`` / ``up2`` flipped
    (JAX's loader puts them in unflipped, ``test_midas_loader``): a 40x50
    frame goes to 384x480 and shrinks back, its map within TOL of JAX's
    (a [0, 1] map after the per-frame min-max)."""
    import ehgr_tpu.data.pseudo_depth as j_pseudo_depth

    src = dpt.DPT(**TINY, device="cpu",
                  generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        src.head_conv3.bias.fill_(1.0)
    sd = _midas_state_dict(src)
    path, jpath = tmp_path / "dpt_tiny.pt", tmp_path / "dpt_tiny_jax.pt"
    torch.save({"state_dict": sd}, path)
    up = [f"pretrained.act_postprocess{k}.4.weight" for k in (1, 2)]
    torch.save({k: _flip(v) if k in up else v for k, v in sd.items()},
               jpath)
    monkeypatch.setattr(dpt, "dpt_large",
                        lambda *a, **k: dpt.DPT(**TINY, **k))
    monkeypatch.setattr(j_dpt, "dpt_large",
                        lambda *a, **k: j_dpt.DPT(**TINY))
    pred = pseudo_depth.midas_predictor(str(path), device="cpu")
    frame = np.random.default_rng(3).integers(0, 256, (40, 50, 3),
                                              dtype=np.uint8)
    depth = pred(frame)
    assert depth.shape == (40, 50) and depth.dtype == np.float32
    assert depth.min() == 0.0 and depth.max() == 1.0
    want = j_pseudo_depth.midas_predictor(str(jpath))(frame)
    assert want.shape == (40, 50) and want.max() == 1.0
    assert _rel(depth, want) <= TOL
