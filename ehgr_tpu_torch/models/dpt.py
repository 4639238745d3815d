"""DPT (dense prediction transformer) monocular depth, the MiDaS model
(counterpart of ``ehgr_tpu/models/dpt.py``): DPT-Large, a ViT-L/16
backbone, reassemble taps and a RefineNet-style fusion decoder, batched
over frames.

Architecture (MiDaS v3 ``dpt/models.py`` + ``dpt/vit.py``):
* ViT-L/16: patch 16, embed 1024, depth 24, heads 16, learned position
  table (resized for non-384 inputs, as ``jax.image.resize`` bilinear does:
  antialiased where it shrinks, ``ops/preprocess_device.resize_clip``),
  class token.  LayerNorm eps 1e-6; the softmax runs in the compute dtype.
* hooks at blocks {5, 11, 17, 23}; readout "project" (concat the class
  token, Linear 2D->D, GELU).
* reassemble: 1x1 conv to {256, 512, 1024, 1024}, then a x4 / x2
  transposed conv / identity / stride-2 conv -> strides {4, 8, 16, 32}.
* scratch: 3x3 no-bias convs to 256; four fusion blocks (two residual conv
  units each, align-corners x2 upsample, 1x1 out conv; refinenet4 has no
  first unit: MiDaS creates it but never calls it); head 3x3->128, x2 up,
  3x3->32, ReLU, 1x1->1, ReLU (inverse depth).

Weights: ``convert_midas_state_dict`` (the official MiDaS checkpoint,
``dpt_large-midas-2f21e586.pt``) and ``convert_hf_dpt``
(``transformers.DPTForDepthEstimation``, e.g. ``Intel/dpt-large``) copy a
torch state dict into the module as it is stored: the module computes
MiDaS's function.  The JAX package's ``up1`` / ``up2`` are flax transposed
convs without ``transpose_kernel``, into which its converters load the
torch kernels unflipped; ``models/convert.py`` flips them on the way from
JAX variables, so the port computes JAX's function on JAX's variables.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ehgr_tpu_torch.device import DeviceLike, resolve_device
from ehgr_tpu_torch.models.layers import (Conv2d, ConvTranspose2d, LayerNorm,
                                          Linear, init_params)
from ehgr_tpu_torch.ops.preprocess_device import resize_clip


def upsample2_align_corners(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample of ``[N, C, H, W]`` with ``align_corners=True``;
    a size-1 axis repeats."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.qkv = Linear(dim, 3 * dim)
        self.attn_proj = Linear(dim, dim)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.fc1 = Linear(dim, mlp_ratio * dim)
        self.fc2 = Linear(mlp_ratio * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, dim = x.shape
        hd = dim // self.heads
        q, k, v = (a.reshape(n, t, self.heads, hd).transpose(1, 2)
                   for a in self.qkv(self.norm1(x)).chunk(3, dim=-1))
        attn = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd),
                             dim=-1)
        o = (attn @ v).transpose(1, 2).reshape(n, t, dim)
        x = x + self.attn_proj(o)
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1)
        self.conv2 = Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusion(nn.Module):
    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.res1 = ResidualConvUnit(features)
        self.res2 = ResidualConvUnit(features)
        self.out_conv = Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.res1(skip)
        x = upsample2_align_corners(self.res2(x))
        return self.out_conv(x)


class DPT(nn.Module):
    """DPT depth net.  Input ``[N, H, W, 3]`` normalized
    (``(x/255 - 0.5)/0.5``), H and W multiples of 32; output f32 inverse
    relative depth ``[N, H, W]``.  Parameters are f32 on ``device``
    (default CUDA), drawn from ``generator`` (lecun normal for convs and
    Linears, N(0, 0.02) for the position table, a zero class token);
    ``dtype`` is the compute dtype."""

    def __init__(self, embed_dim: int = 1024, depth: int = 24,
                 heads: int = 16, patch: int = 16,
                 hooks: Sequence[int] = (5, 11, 17, 23),
                 features: int = 256,
                 reassemble: Sequence[int] = (256, 512, 1024, 1024),
                 pos_grid: int = 24, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.embed_dim, self.depth, self.patch = embed_dim, depth, patch
        self.hooks = tuple(hooks)
        self.pos_grid = pos_grid
        self.dtype = dtype
        self.patch_embed = Conv2d(3, embed_dim, patch, stride=patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + pos_grid ** 2, embed_dim))
        for i in range(depth):
            setattr(self, f"block{i}", ViTBlock(embed_dim, heads))
        r = reassemble
        for k in range(1, 5):
            setattr(self, f"readout{k}", Linear(2 * embed_dim, embed_dim))
            setattr(self, f"reassemble{k}", Conv2d(embed_dim, r[k - 1], 1))
            setattr(self, f"layer{k}_rn", Conv2d(r[k - 1], features, 3,
                                                 padding=1, bias=False))
        self.up1 = ConvTranspose2d(r[0], r[0], 4, stride=4)
        self.up2 = ConvTranspose2d(r[1], r[1], 2, stride=2)
        self.down4 = Conv2d(r[3], r[3], 3, stride=2, padding=1)
        for k in range(1, 5):
            setattr(self, f"refinenet{k}",
                    FeatureFusion(features, with_skip=k != 4))
        self.head_conv1 = Conv2d(features, features // 2, 3, padding=1)
        self.head_conv2 = Conv2d(features // 2, 32, 3, padding=1)
        self.head_conv3 = Conv2d(32, 1, 1)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        init_params(self, gen)
        with torch.no_grad():
            self.pos_embed.copy_(torch.empty(self.pos_embed.shape).normal_(
                0.0, 0.02, generator=gen))
        self.to(dev).eval()

    def _pos(self, gh: int, gw: int) -> torch.Tensor:
        """The position table for a ``gh x gw`` token grid (f32)."""
        pos = self.pos_embed
        if (gh, gw) == (self.pos_grid, self.pos_grid):
            return pos
        grid = pos[:, 1:].reshape(1, self.pos_grid, self.pos_grid,
                                  self.embed_dim)
        grid = resize_clip(grid, (gh, gw)).reshape(1, gh * gw,
                                                   self.embed_dim)
        return torch.cat([pos[:, :1], grid], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w = x.shape[:3]
        if h % 32 or w % 32:
            raise ValueError(f"DPT needs H and W multiples of 32, got "
                             f"{h}x{w}")
        gh, gw = h // self.patch, w // self.patch
        p = self.patch_embed(x.to(self.dtype).permute(0, 3, 1, 2))
        tokens = p.flatten(2).transpose(1, 2)             # [N, gh*gw, D]
        cls = self.cls_token.to(self.dtype).expand(n, 1, self.embed_dim)
        tokens = torch.cat([cls, tokens], dim=1) + \
            self._pos(gh, gw).to(self.dtype)

        taps = {}
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens)
            if i in self.hooks:
                taps[i] = tokens

        pyramid = []
        for k, hook in enumerate(self.hooks, start=1):
            t = taps[hook]
            feat = torch.cat([t[:, 1:], t[:, :1].expand_as(t[:, 1:])],
                             dim=-1)
            feat = F.gelu(getattr(self, f"readout{k}")(feat))
            feat = feat.transpose(1, 2).reshape(n, self.embed_dim, gh, gw)
            feat = getattr(self, f"reassemble{k}")(feat)
            if k == 1:
                feat = self.up1(feat)
            elif k == 2:
                feat = self.up2(feat)
            elif k == 4:
                feat = self.down4(feat)
            pyramid.append(getattr(self, f"layer{k}_rn")(feat))

        r1, r2, r3, r4 = pyramid
        path = self.refinenet4(r4)
        path = self.refinenet3(path, r3)
        path = self.refinenet2(path, r2)
        path = self.refinenet1(path, r1)
        out = upsample2_align_corners(self.head_conv1(path))
        out = F.relu(self.head_conv2(out))
        out = F.relu(self.head_conv3(out))
        return out[:, 0].float()


def dpt_large(dtype: torch.dtype = torch.float32, device: DeviceLike = None,
              generator: Optional[torch.Generator] = None) -> DPT:
    """The MiDaS DPT_Large configuration."""
    return DPT(dtype=dtype, device=device, generator=generator)


# --- torch checkpoint ingestion ---------------------------------------------

def _unit_keys(prefix: str, port: str, convs: Sequence[str]) -> Dict:
    return {f"{prefix}.{c}.{leaf}": f"{port}.{pc}.{leaf}"
            for c, pc in zip(convs, ("conv1", "conv2"))
            for leaf in ("weight", "bias")}


def midas_key_map(model: DPT) -> Dict[str, str]:
    """{MiDaS state-dict key -> port key} for the official MiDaS DPT layout
    (``pretrained.model.*`` timm ViT names, ``pretrained.act_postprocess``
    reassemble, ``scratch.*`` decoder).  refinenet4's ``resConfUnit1`` has
    no port key: MiDaS creates it and never calls it."""
    m = {}
    P = "pretrained.model."
    m[P + "cls_token"] = "cls_token"
    m[P + "pos_embed"] = "pos_embed"
    for leaf in ("weight", "bias"):
        m[P + f"patch_embed.proj.{leaf}"] = f"patch_embed.{leaf}"
    for i in range(model.depth):
        B, b = P + f"blocks.{i}.", f"block{i}."
        for tn, pn in (("norm1", "norm1"), ("norm2", "norm2"),
                       ("attn.qkv", "qkv"), ("attn.proj", "attn_proj"),
                       ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            for leaf in ("weight", "bias"):
                m[f"{B}{tn}.{leaf}"] = f"{b}{pn}.{leaf}"
    resize = {1: "up1", 2: "up2", 4: "down4"}
    for k in range(1, 5):
        A = f"pretrained.act_postprocess{k}."
        for leaf in ("weight", "bias"):
            m[A + f"0.project.0.{leaf}"] = f"readout{k}.{leaf}"
            m[A + f"3.{leaf}"] = f"reassemble{k}.{leaf}"
            if k in resize:
                m[A + f"4.{leaf}"] = f"{resize[k]}.{leaf}"
            m[f"scratch.refinenet{k}.out_conv.{leaf}"] = \
                f"refinenet{k}.out_conv.{leaf}"
        m[f"scratch.layer{k}_rn.weight"] = f"layer{k}_rn.weight"
        R, r = f"scratch.refinenet{k}.", f"refinenet{k}."
        units = (("resConfUnit2", "res2"),) if k == 4 else \
            (("resConfUnit1", "res1"), ("resConfUnit2", "res2"))
        for tn, pn in units:
            m.update(_unit_keys(R + tn, r + pn, ("conv1", "conv2")))
    for tn, pn in (("0", "head_conv1"), ("2", "head_conv2"),
                   ("4", "head_conv3")):
        for leaf in ("weight", "bias"):
            m[f"scratch.output_conv.{tn}.{leaf}"] = f"{pn}.{leaf}"
    return m


def hf_dpt_key_map(model: DPT) -> Dict[str, str]:
    """{HF ``DPTForDepthEstimation`` key -> port key}, for every key but
    the q/k/v Linears (``convert_hf_dpt`` fuses those into ``qkv``).
    ``dpt.layernorm`` (applied only to the final sequence output, never to
    the tapped states) and fusion layer 0's ``residual_layer1`` (the MiDaS
    create-but-skip unit) have no port key."""
    m = {}
    E = "dpt.embeddings."
    m[E + "cls_token"] = "cls_token"
    m[E + "position_embeddings"] = "pos_embed"
    for leaf in ("weight", "bias"):
        m[E + f"patch_embeddings.projection.{leaf}"] = f"patch_embed.{leaf}"
    for i in range(model.depth):
        L, b = f"dpt.encoder.layer.{i}.", f"block{i}."
        for hn, pn in (("layernorm_before", "norm1"),
                       ("layernorm_after", "norm2"),
                       ("attention.output.dense", "attn_proj"),
                       ("intermediate.dense", "fc1"),
                       ("output.dense", "fc2")):
            for leaf in ("weight", "bias"):
                m[f"{L}{hn}.{leaf}"] = f"{b}{pn}.{leaf}"
    resize = {1: "up1", 2: "up2", 4: "down4"}
    for k in range(1, 5):
        R = f"neck.reassemble_stage.readout_projects.{k - 1}.0."
        A = f"neck.reassemble_stage.layers.{k - 1}."
        F_ = f"neck.fusion_stage.layers.{4 - k}."   # layer 0: the deepest
        for leaf in ("weight", "bias"):
            m[R + leaf] = f"readout{k}.{leaf}"
            m[A + f"projection.{leaf}"] = f"reassemble{k}.{leaf}"
            if k in resize:
                m[A + f"resize.{leaf}"] = f"{resize[k]}.{leaf}"
            m[F_ + f"projection.{leaf}"] = f"refinenet{k}.out_conv.{leaf}"
        m[f"neck.convs.{k - 1}.weight"] = f"layer{k}_rn.weight"
        units = (("residual_layer2", "res2"),) if k == 4 else \
            (("residual_layer1", "res1"), ("residual_layer2", "res2"))
        for hn, pn in units:
            m.update(_unit_keys(F_ + hn, f"refinenet{k}.{pn}",
                                ("convolution1", "convolution2")))
    for hn, pn in (("0", "head_conv1"), ("2", "head_conv2"),
                   ("4", "head_conv3")):
        for leaf in ("weight", "bias"):
            m[f"head.head.{hn}.{leaf}"] = f"{pn}.{leaf}"
    return m


def _load_mapped(state_dict: Mapping[str, torch.Tensor], model: DPT,
                 kmap: Mapping[str, str]) -> List[str]:
    """Copy each key of ``state_dict`` that ``kmap`` names into ``model``
    as it is; raise ``KeyError`` if a key of the model gets no tensor.
    Returns the unused keys of ``state_dict``."""
    own = model.state_dict()
    unused, copied = [], set()
    with torch.no_grad():
        for key, v in state_dict.items():
            if key not in kmap:
                unused.append(key)
                continue
            dst = own[kmap[key]]
            src = torch.as_tensor(v)
            if src.shape != dst.shape:
                raise ValueError(f"{key}: shape {tuple(src.shape)}, "
                                 f"{kmap[key]} has {tuple(dst.shape)}")
            dst.copy_(src)
            copied.add(kmap[key])
    missing = [k for k in own if k not in copied]
    if missing:
        raise KeyError(f"model keys without a tensor: {missing[:10]} "
                       f"(+{max(0, len(missing) - 10)} more)")
    return unused


def convert_midas_state_dict(state_dict: Mapping[str, torch.Tensor],
                             model: DPT) -> List[str]:
    """Load an official MiDaS DPT state dict (keys may carry ``module.``)
    into ``model``; returns the unused keys (refinenet4's
    ``resConfUnit1``)."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in state_dict.items()}
    return _load_mapped(sd, model, midas_key_map(model))


def convert_hf_dpt(state_dict: Mapping[str, torch.Tensor],
                   model: DPT) -> List[str]:
    """Load an HF ``DPTForDepthEstimation`` state dict into ``model``, its
    separate q/k/v Linears fused into ``qkv`` (rows q, k, v); returns the
    unused keys (``dpt.layernorm.*`` and fusion layer 0's
    ``residual_layer1``)."""
    sd = dict(state_dict)
    kmap = hf_dpt_key_map(model)
    for i in range(model.depth):
        A = f"dpt.encoder.layer.{i}.attention.attention."
        for leaf in ("weight", "bias"):
            try:
                parts = [sd.pop(f"{A}{n}.{leaf}")
                         for n in ("query", "key", "value")]
            except KeyError as e:
                raise KeyError(f"HF DPT checkpoint missing q/k/v at layer "
                               f"{i}: {e}") from e
            fused = f"__fused_qkv{i}.{leaf}"
            sd[fused] = torch.cat([torch.as_tensor(p) for p in parts])
            kmap[fused] = f"block{i}.qkv.{leaf}"
    return _load_mapped(sd, model, kmap)
