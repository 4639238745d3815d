"""VideoMAE-Base video classifier (counterpart of
``ehgr_tpu/models/videomae.py``): tubelet (2x16x16) embedding -> joint
space-time ViT-B/16 encoder (12 layers, 768 dim, 12 heads, fixed sin-cos
position table) -> token mean + LayerNorm head.

The numerics are JAX's: k has no bias while q and v do; the scores are
scaled by ``1/sqrt(d_head)`` and their softmax runs in fp32, cast back to
the compute dtype; LayerNorm eps 1e-12; exact GELU.  Attention is written
as JAX writes it, two matmuls around the softmax (JAX computes it outside
any Pallas kernel).

``convert_hf_videomae`` loads an HF ``VideoMAEForVideoClassification``
state dict into the module.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ehgr_tpu_torch.device import DeviceLike, resolve_device
from ehgr_tpu_torch.models.layers import (Conv3d, LayerNorm, Linear,
                                          dropout, init_params)


def sincos_pos_embed(n_pos: int, dim: int) -> np.ndarray:
    """Fixed sinusoidal table (VideoMAE uses non-learned position embeds)."""
    pos = np.arange(n_pos)[:, None]
    omega = 1.0 / (10000 ** (2 * (np.arange(dim)[None, :] // 2) / dim))
    table = pos * omega
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return table.astype(np.float32)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = Linear(dim, dim)
        self.k = Linear(dim, dim, bias=False)
        self.v = Linear(dim, dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, s, dim = x.shape
        d_head = dim // self.heads
        q, k, v = (f(x).reshape(n, s, self.heads, d_head).transpose(1, 2)
                   for f in (self.q, self.k, self.v))     # [n, h, s, d]
        att = (q @ k.transpose(-1, -2)) / math.sqrt(d_head)
        att = torch.softmax(att.float(), dim=-1).to(x.dtype)
        out = (att @ v).transpose(1, 2).reshape(n, s, dim)
        return self.proj(out)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-12)
        self.attn = Attention(dim, heads)
        self.norm2 = LayerNorm(dim, eps=1e-12)
        self.fc1 = Linear(dim, int(dim * mlp_ratio))
        self.fc2 = Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class VideoMAE(nn.Module):
    """VideoMAE classification model.  Input ``[N, T, H, W, 3]`` normalized
    frames, T even (tubelet 2); f32 logits ``[N, classes]``.  Parameters
    are f32 on ``device`` (default CUDA), drawn from ``generator`` (lecun
    normal, as the port's other models); ``dtype`` is the compute dtype;
    ``dropout`` acts on the pooled feature in training, drawn from the
    ``generator`` passed to ``forward``."""

    def __init__(self, num_class: int, dim: int = 768, depth: int = 12,
                 heads: int = 12, tubelet: int = 2, patch: int = 16,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.depth = depth
        self.dropout = dropout
        self.dtype = dtype
        self.patch_embed = Conv3d(3, dim, (tubelet, patch, patch),
                                  stride=(tubelet, patch, patch))
        for i in range(depth):
            setattr(self, f"block{i}", Block(dim, heads))
        self.fc_norm = LayerNorm(dim, eps=1e-12)
        self.classifier = Linear(dim, num_class)
        init_params(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))
        self.to(dev).eval()
        self._pos: Dict[tuple, torch.Tensor] = {}

    def _pos_table(self, n_pos: int, dim: int,
                   device: torch.device) -> torch.Tensor:
        key = (n_pos, dim, device)
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(
                sincos_pos_embed(n_pos, dim)).to(device)
        return self._pos[key]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.patch_embed(x.to(self.dtype).permute(0, 4, 1, 2, 3))
        seq = x.flatten(2).transpose(1, 2)               # [N, T'H'W', dim]
        seq = seq + self._pos_table(seq.shape[1], seq.shape[2],
                                    seq.device).to(seq.dtype)
        for i in range(self.depth):
            seq = getattr(self, f"block{i}")(seq)
        pooled = self.fc_norm(seq.mean(1))
        pooled = dropout(pooled, self.dropout, self.training, generator)
        return self.classifier(pooled).float()


def hf_videomae_key_map(model: VideoMAE) -> Dict[str, str]:
    """{port key -> HF ``VideoMAEForVideoClassification`` key}.  HF's q/k/v
    Linears carry no bias; the q and v biases are the separate ``q_bias``
    / ``v_bias`` parameters (k's bias is zero and the port has none)."""
    m = {"patch_embed.weight":
         "videomae.embeddings.patch_embeddings.projection.weight",
         "patch_embed.bias":
         "videomae.embeddings.patch_embeddings.projection.bias"}
    for i in range(model.depth):
        L, b = f"videomae.encoder.layer.{i}.", f"block{i}."
        A = L + "attention.attention."
        sub = {"norm1": L + "layernorm_before", "norm2": L + "layernorm_after",
               "fc1": L + "intermediate.dense", "fc2": L + "output.dense",
               "attn.proj": L + "attention.output.dense"}
        for name, hf in sub.items():
            for leaf in ("weight", "bias"):
                m[f"{b}{name}.{leaf}"] = f"{hf}.{leaf}"
        for name, hf in (("q", "query"), ("k", "key"), ("v", "value")):
            m[f"{b}attn.{name}.weight"] = f"{A}{hf}.weight"
        m[f"{b}attn.q.bias"] = A + "q_bias"
        m[f"{b}attn.v.bias"] = A + "v_bias"
    for name in ("fc_norm", "classifier"):
        for leaf in ("weight", "bias"):
            m[f"{name}.{leaf}"] = f"{name}.{leaf}"
    return m


def convert_hf_videomae(state_dict: Mapping[str, torch.Tensor],
                        model: VideoMAE) -> List[str]:
    """Copy an HF ``VideoMAEForVideoClassification`` state dict into
    ``model`` in place (torch layouts on both sides: nothing transposes).
    Returns the port's keys the state dict had no tensor for (they keep
    their values), as the JAX converter returns its missing leaves."""
    own = model.state_dict()
    missing = []
    with torch.no_grad():
        for key, hf in hf_videomae_key_map(model).items():
            if hf not in state_dict:
                missing.append(key)
                continue
            src = torch.as_tensor(state_dict[hf])
            if src.shape != own[key].shape:
                raise ValueError(f"{hf}: shape {tuple(src.shape)}, "
                                 f"{key} has {tuple(own[key].shape)}")
            own[key].copy_(src)
    return missing
