"""TSN task models (counterpart of ``ehgr_tpu/models/tsn.py``): arch ``tsn``
(segment consensus over the frames' logits), ``tsn_mtmm`` (plus the global
depth decoder on layer4, stage 1 of the recipe), ``tsn_sd`` (plus the three
scala exits of stage 2, self-distillation), ``tsn_mtmm_sd`` (the joint
stage: the SD exits plus the modal heads that ``modal`` names) and the
truncated deploys ``tsn_middle1/2/3`` (stages up to K and exit K only).

Input is ``[N, T, H, W, C]``; frames fold into the batch as ``N*T`` for the
2D backbone (channels_last, so the fold is a free view) and the logits
unfold back to ``[N, T, classes]`` for the segment consensus.  The TSN
options: ``consensus_type`` (``avg`` or ``identity``), ``before_softmax``
(False: a softmax per frame, in the compute dtype, before the consensus)
and ``temporal_pool`` (T halved after stage 2; every head's consensus then
runs over T/2 frames, as in the JAX package).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ehgr_tpu_torch.device import DeviceLike, resolve_device
from ehgr_tpu_torch.models.backbones import get_backbone, supports_taps
from ehgr_tpu_torch.models.decoders import (GlobalDepthDecoder, Scala,
                                           TextEncoder, TransposedDecoder)
from ehgr_tpu_torch.models.layers import Linear, dropout, init_params
from ehgr_tpu_torch.ops.consensus import consensus

# width of the pooled feature of each backbone (its names and aliases)
_FEATURES = {"resnet50": 2048, "resnet101": 2048, "res2net50": 2048,
             "res2net50_26w_4s": 2048, "mobilenet_v2": 1280,
             "mobilenetv2": 1280, "bn_inception": 1024, "BNInception": 1024}
# input width and SepConv widths of each SD exit (taps layer1..3 of ResNet)
_SCALA = {1: (256, (512, 1024, 2048)), 2: (512, (1024, 2048)),
          3: (1024, (2048,))}
# the joint stage's modal heads: (name, modal word, tap, widths, channels),
# in the reference's output order (models_MTMM_SD.py:517-532)
_MODAL_DECODERS = (
    ("local_decoder", "depth", "stem", (32,), 1),
    ("global_decoder", "depth", "layer4", (256, 32), 1),
    ("local_skel_decoder", "skeleton", "stem", (64,), 42),
    ("global_skel_decoder", "skeleton", "layer4", (256, 64), 42))
_TAP_WIDTH = {"stem": 64, "layer4": 2048}


class TSN(nn.Module):
    """Temporal Segment Network: logits ``[N, classes]``; with
    ``with_depth`` also the depth map ``[N*T, 56, 56, 1]`` (at 224^2); with
    ``with_sd`` the 8-tuple ``(logits, mid1, mid2, mid3, final_fea, f1, f2,
    f3)`` of the SD exits (``mid{k}`` the exit's logits, ``f{k}`` its
    per-frame feature ``[N*T, 2048]``, ``final_fea`` the pooled feature
    before dropout), followed, when ``modal`` names them, by the local
    (stem, ``[N*T, 224, 224, 1]`` at 224^2) and global (layer4, 56^2) depth
    maps, the local and global skeleton heatmaps (42 channels) and the text
    embedding ``[N, 512]`` (the pooled feature reshaped by
    ``num_segments``, as JAX reshapes it also under ``temporal_pool``,
    where that gives N/2 rows);
    with ``truncate_at=K`` only exit K's logits, the backbone built and run
    up to stage K.

    Parameters are f32 on ``device`` (default CUDA, see
    ``ehgr_tpu_torch.device``); ``dtype`` is the compute dtype.  Weights are
    drawn from ``generator`` (default: a CPU generator seeded 0): lecun
    normal for convs, ``N(0, 0.001)`` for the heads as in the reference.
    ``base_model``: the ResNet family (``resnet50``, ``resnet101``,
    ``res2net50``) serves every surface; ``mobilenet_v2`` and
    ``bn_inception`` only ``tsn`` (the others raise, as in JAX).
    ``partial_bn`` keeps every ResNet BN but the stem's on its running
    statistics in training (the other families keep every BN on batch
    statistics, as JAX builds them); ``dropout`` acts on the pooled feature in
    training, drawn from the ``generator`` passed to ``forward`` (on a mesh,
    ``parallel.mesh.shard_model``, the global batch's mask, this rank's
    rows; the heads then gather their logits over the model group where
    their out-features shard).
    ``remat`` recomputes each bottleneck in the backward pass and
    ``quantize`` makes its block convs int8 sites at eval (see
    ``ResNetBackbone``)."""

    def __init__(self, num_class: int, num_segments: int,
                 base_model: str = "resnet50", temporal: str = "action",
                 shift_div: int = 8, dropout: float = 0.5,
                 partial_bn: bool = True, with_depth: bool = False,
                 with_sd: bool = False, modal: str = "rgb",
                 truncate_at: int = 0, action_fused: Any = None,
                 action_stages=(1, 2, 3, 4), remat: bool = False,
                 consensus_type: str = "avg", before_softmax: bool = True,
                 temporal_pool: bool = False, quantize: Any = False,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_segments = num_segments
        self.dropout = dropout
        self.with_depth = with_depth
        self.with_sd = with_sd
        self.truncate_at = truncate_at
        self.consensus_type = consensus_type
        self.before_softmax = before_softmax
        self.temporal_pool = temporal_pool
        self.dtype = dtype
        if (with_sd or with_depth or truncate_at) and \
                not supports_taps(base_model):
            raise ValueError(
                f"{base_model} supports only the plain TSN surface "
                "(MTMM/SD need resnet-family layer taps, as in the "
                "reference)")
        self.base_model = get_backbone(
            base_model, temporal=temporal, n_segment=num_segments,
            shift_div=shift_div, action_fused=action_fused,
            action_stages=action_stages, partial_bn=partial_bn,
            stages=truncate_at or 4, remat=remat,
            temporal_pool=temporal_pool, quantize=quantize, device=dev)
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
        self.modal_heads = [d for d in _MODAL_DECODERS
                            if with_sd and d[1] in modal]
        for name, _, tap, widths, out in self.modal_heads:
            setattr(self, name, TransposedDecoder(_TAP_WIDTH[tap], widths,
                                                  out, device=dev))
        self.with_text = with_sd and "text" in modal
        if self.with_text:
            self.text_encoder = TextEncoder(width, num_segments, device=dev)
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

    def _head(self, fc: nn.Module, feat: torch.Tensor) -> torch.Tensor:
        """Per-frame logits of ``fc`` (their softmax, in the compute dtype,
        without ``before_softmax``) -> consensus over the segments (T/2
        under ``temporal_pool``, for every head as in JAX), f32."""
        seg = self.num_segments // 2 if self.temporal_pool \
            else self.num_segments
        logits = fc(feat)
        if not self.before_softmax:
            logits = torch.softmax(logits, -1)
        return consensus(logits.reshape(-1, seg, logits.shape[-1]),
                         self.consensus_type).float()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                return_taps: bool = False):
        """``[N, T, H, W, 3]`` -> f32 logits ``[N, classes]`` (plus the
        depth map, or the SD tuple, or exit K's logits alone; see the class
        docstring).  Training with dropout needs ``generator``, a
        ``torch.Generator`` on the input's device.  ``return_taps`` returns
        ``(out, taps)`` on every surface: the backbone's dict (``stem``,
        ``layer1..4`` as far as the model runs, channels_last ``[N*T, C,
        h, w]`` in the compute dtype, and ``pool`` ``[N*T, C]``)."""
        out, taps = self._forward(x, generator)
        return (out, taps) if return_taps else out

    def _forward(self, x: torch.Tensor,
                 generator: Optional[torch.Generator]):
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
            mids.append(self._head(getattr(self, f"middle_fc{k}"), h))
        if self.truncate_at:
            return mids[0], taps
        feat = taps["pool"]                             # [NT, 2048]
        final_fea = feat
        mesh = getattr(self, "mesh", None)
        feat = dropout(feat, self.dropout, self.training, generator,
                       rows=None if mesh is None else
                       (mesh.data_index, mesh.data_size))
        logits = self._head(self.new_fc, feat)
        if self.with_sd:
            extras = tuple(
                getattr(self, name)(taps[tap]).permute(0, 2, 3, 1).float()
                for name, _, tap, _, _ in self.modal_heads)
            if self.with_text:
                extras += (self.text_encoder(final_fea.reshape(
                    -1, self.num_segments, final_fea.shape[-1])).float(),)
            return (logits, *mids, final_fea.float(), *mid_feas,
                    *extras), taps
        if not self.with_depth:
            return logits, taps
        depth = self.global_decoder(taps["layer4"])     # [NT, 1, h, w]
        return (logits, depth.permute(0, 2, 3, 1).float()), taps


_MIDDLE = {"tsn_middle1": 1, "tsn_middle2": 2, "tsn_middle3": 3}


def variant(arch: str, num_class: int, num_segments: int,
            base_model: str = "resnet50", temporal: str = "action",
            shift_div: int = 8, dropout: float = 0.5,
            partial_bn: bool = True, modal: str = "rgb_depth",
            action_fused: Any = None, action_stages: Any = (1, 2, 3, 4),
            remat: bool = False, consensus_type: str = "avg",
            before_softmax: bool = True, temporal_pool: bool = False,
            quantize: Any = False, dtype: torch.dtype = torch.float32,
            device: DeviceLike = None,
            generator: Optional[torch.Generator] = None) -> TSN:
    """Build the model surface ``arch`` (``tsn``, ``tsn_mtmm``, ``tsn_sd``,
    ``tsn_mtmm_sd`` with the heads of ``modal``, which no other arch reads,
    and ``tsn_middle1/2/3``), with the TSN options ``consensus_type``,
    ``before_softmax`` and ``temporal_pool`` and the int8 mode
    ``quantize``."""
    if arch not in ("tsn", "tsn_mtmm", "tsn_sd", "tsn_mtmm_sd") and \
            arch not in _MIDDLE:
        raise ValueError(f"unknown arch: {arch}")
    return TSN(num_class=num_class, num_segments=num_segments,
               base_model=base_model, temporal=temporal,
               shift_div=shift_div, dropout=dropout, partial_bn=partial_bn,
               with_depth=arch == "tsn_mtmm",
               with_sd=arch in ("tsn_sd", "tsn_mtmm_sd"),
               modal=modal if arch == "tsn_mtmm_sd" else "rgb",
               truncate_at=_MIDDLE.get(arch, 0), action_fused=action_fused,
               action_stages=tuple(action_stages), remat=remat,
               consensus_type=consensus_type, before_softmax=before_softmax,
               temporal_pool=temporal_pool, quantize=quantize, dtype=dtype,
               device=device, generator=generator)
