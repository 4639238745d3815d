"""TSN task models (counterpart of ``ehgr_tpu/models/tsn.py``): arch ``tsn``
(average consensus over the segments' logits), ``tsn_mtmm`` (plus the
global depth decoder on layer4, stage 1 of the recipe), ``tsn_sd`` (plus
the three scala exits of stage 2, self-distillation) and the truncated
deploys ``tsn_middle1/2/3`` (stages up to K and exit K only).

Input is ``[N, T, H, W, C]``; frames fold into the batch as ``N*T`` for the
2D backbone (channels_last, so the fold is a free view) and the logits
unfold back to ``[N, T, classes]`` for the segment consensus.  The joint
stage ``tsn_mtmm_sd`` and the TSN options ``temporal_pool``,
``before_softmax`` and ``consensus_type`` are ROADMAP items.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ehgr_tpu_torch.device import DeviceLike, resolve_device
from ehgr_tpu_torch.models.backbones import get_backbone
from ehgr_tpu_torch.models.decoders import GlobalDepthDecoder, Scala
from ehgr_tpu_torch.models.layers import Linear, init_params
from ehgr_tpu_torch.ops.consensus import consensus

_FEATURES = {"resnet50": 2048, "resnet101": 2048}
# input width and SepConv widths of each SD exit (taps layer1..3 of ResNet)
_SCALA = {1: (256, (512, 1024, 2048)), 2: (512, (1024, 2048)),
          3: (1024, (2048,))}


class TSN(nn.Module):
    """Temporal Segment Network: logits ``[N, classes]``; with
    ``with_depth`` also the depth map ``[N*T, 56, 56, 1]`` (at 224^2); with
    ``with_sd`` the 8-tuple ``(logits, mid1, mid2, mid3, final_fea, f1, f2,
    f3)`` of the SD exits (``mid{k}`` the exit's logits, ``f{k}`` its
    per-frame feature ``[N*T, 2048]``, ``final_fea`` the pooled feature
    before dropout); with ``truncate_at=K`` only exit K's logits, the
    backbone built and run up to stage K.

    Parameters are f32 on ``device`` (default CUDA, see
    ``ehgr_tpu_torch.device``); ``dtype`` is the compute dtype.  Weights are
    drawn from ``generator`` (default: a CPU generator seeded 0): lecun
    normal for convs, ``N(0, 0.001)`` for the heads as in the reference.
    ``partial_bn`` keeps every backbone BN but the stem's on its running
    statistics in training; ``dropout`` acts on the pooled feature in
    training, drawn from the ``generator`` passed to ``forward``.
    ``remat`` recomputes each bottleneck in the backward pass (see
    ``ResNetBackbone``)."""

    def __init__(self, num_class: int, num_segments: int,
                 base_model: str = "resnet50", temporal: str = "action",
                 shift_div: int = 8, dropout: float = 0.5,
                 partial_bn: bool = True, with_depth: bool = False,
                 with_sd: bool = False, truncate_at: int = 0,
                 action_fused: Any = None, action_stages=(1, 2, 3, 4),
                 remat: bool = False, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_segments = num_segments
        self.dropout = dropout
        self.with_depth = with_depth
        self.with_sd = with_sd
        self.truncate_at = truncate_at
        self.dtype = dtype
        self.base_model = get_backbone(
            base_model, temporal=temporal, n_segment=num_segments,
            shift_div=shift_div, action_fused=action_fused,
            action_stages=action_stages, partial_bn=partial_bn,
            stages=truncate_at or 4, remat=remat, device=dev)
        width = _FEATURES[base_model]
        self.exits = (truncate_at,) if truncate_at else \
            (1, 2, 3) if with_sd else ()
        for k in self.exits:
            setattr(self, f"scala{k}", Scala(*_SCALA[k], device=dev))
            setattr(self, f"middle_fc{k}",
                    Linear(width, num_class, device=dev))
        if not truncate_at:
            self.new_fc = Linear(width, num_class, device=dev)
        if with_depth:
            self.global_decoder = GlobalDepthDecoder(width, device=dev)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        init_params(self, gen)
        with torch.no_grad():
            for name in ["new_fc"] * (not truncate_at) + \
                    [f"middle_fc{k}" for k in self.exits]:
                w = getattr(self, name).weight
                w.copy_(torch.empty(w.shape).normal_(0.0, 0.001,
                                                     generator=gen))
        self.eval()

    def _head(self, fc: nn.Module, feat: torch.Tensor,
              n: int) -> torch.Tensor:
        """Per-frame logits of ``fc`` -> consensus over T, f32."""
        return consensus(fc(feat).reshape(n, self.num_segments, -1)).float()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """``[N, T, H, W, 3]`` -> f32 logits ``[N, classes]`` (plus the
        depth map, or the SD tuple, or exit K's logits alone; see the class
        docstring).  Training with dropout needs ``generator``, a
        ``torch.Generator`` on the input's device."""
        n, t = x.shape[0], x.shape[1]
        if t != self.num_segments:
            raise ValueError(f"got {t} segments, model has "
                             f"{self.num_segments}")
        x = x.reshape((n * t,) + x.shape[2:]).to(self.dtype) \
            .permute(0, 3, 1, 2)                      # channels_last view
        taps = self.base_model(x)
        mids, mid_feas = [], []
        for k in self.exits:
            h = getattr(self, f"scala{k}")(taps[f"layer{k}"]).mean((2, 3))
            mid_feas.append(h.float())                  # [NT, 2048]
            mids.append(self._head(getattr(self, f"middle_fc{k}"), h, n))
        if self.truncate_at:
            return mids[0]
        feat = taps["pool"]                             # [NT, 2048]
        final_fea = feat
        if self.training and self.dropout > 0:
            if generator is None:
                raise ValueError("training with dropout needs generator=, "
                                 "a torch.Generator")
            keep = 1.0 - self.dropout
            mask = torch.empty(feat.shape, device=feat.device).bernoulli_(
                keep, generator=generator)
            feat = feat * (mask / keep).to(feat.dtype)
        logits = self._head(self.new_fc, feat, n)
        if self.with_sd:
            return (logits, *mids, final_fea.float(), *mid_feas)
        if not self.with_depth:
            return logits
        depth = self.global_decoder(taps["layer4"])     # [NT, 1, h, w]
        return logits, depth.permute(0, 2, 3, 1).float()


_MIDDLE = {"tsn_middle1": 1, "tsn_middle2": 2, "tsn_middle3": 3}


def variant(arch: str, num_class: int, num_segments: int,
            base_model: str = "resnet50", temporal: str = "action",
            shift_div: int = 8, dropout: float = 0.5,
            partial_bn: bool = True, action_fused: Any = None,
            action_stages: Any = (1, 2, 3, 4), remat: bool = False,
            dtype: torch.dtype = torch.float32, device: DeviceLike = None,
            generator: Optional[torch.Generator] = None) -> TSN:
    """Build the model surface ``arch`` (``tsn``, ``tsn_mtmm``, ``tsn_sd``
    and ``tsn_middle1/2/3`` are ported)."""
    if arch == "tsn_mtmm_sd":
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP: the joint stage)")
    if arch not in ("tsn", "tsn_mtmm", "tsn_sd") and arch not in _MIDDLE:
        raise ValueError(f"unknown arch: {arch}")
    return TSN(num_class=num_class, num_segments=num_segments,
               base_model=base_model, temporal=temporal,
               shift_div=shift_div, dropout=dropout, partial_bn=partial_bn,
               with_depth=arch == "tsn_mtmm", with_sd=arch == "tsn_sd",
               truncate_at=_MIDDLE.get(arch, 0), action_fused=action_fused,
               action_stages=tuple(action_stages), remat=remat,
               dtype=dtype, device=device, generator=generator)
