"""TSN task model (counterpart of ``ehgr_tpu/models/tsn.py``), arch ``tsn``
at eval: average consensus over the segments' logits.

Input is ``[N, T, H, W, C]``; frames fold into the batch as ``N*T`` for the
2D backbone (channels_last, so the fold is a free view) and the logits
unfold back to ``[N, T, classes]`` for the segment consensus.  The MTMM, SD
and truncated ``tsn_middleK`` surfaces, and the TSN options the serving
path does not use (``temporal_pool``, ``before_softmax``, dropout and
partial BN for training), are ROADMAP items.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ehgr_tpu_torch.device import DeviceLike, resolve_device
from ehgr_tpu_torch.models.backbones import get_backbone
from ehgr_tpu_torch.models.layers import Linear, init_params
from ehgr_tpu_torch.ops.consensus import consensus

_FEATURES = {"resnet50": 2048, "resnet101": 2048}


class TSN(nn.Module):
    """Temporal Segment Network, plain surface (logits ``[N, classes]``).

    Parameters are f32 on ``device`` (default CUDA, see
    ``ehgr_tpu_torch.device``); ``dtype`` is the compute dtype.  Weights are
    drawn from ``generator`` (default: a CPU generator seeded 0): lecun
    normal for convs, ``N(0, 0.001)`` for the head as in the reference."""

    def __init__(self, num_class: int, num_segments: int,
                 base_model: str = "resnet50", temporal: str = "action",
                 shift_div: int = 8, action_fused: Any = None,
                 action_stages=(1, 2, 3, 4),
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_segments = num_segments
        self.dtype = dtype
        self.base_model = get_backbone(
            base_model, temporal=temporal, n_segment=num_segments,
            shift_div=shift_div, action_fused=action_fused,
            action_stages=action_stages, device=dev)
        self.new_fc = Linear(_FEATURES[base_model], num_class, device=dev)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        init_params(self, gen)
        with torch.no_grad():
            self.new_fc.weight.copy_(torch.empty(self.new_fc.weight.shape)
                                     .normal_(0.0, 0.001, generator=gen))
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[N, T, H, W, 3]`` -> f32 logits ``[N, classes]``."""
        n, t = x.shape[0], x.shape[1]
        if t != self.num_segments:
            raise ValueError(f"got {t} segments, model has "
                             f"{self.num_segments}")
        x = x.reshape((n * t,) + x.shape[2:]).to(self.dtype) \
            .permute(0, 3, 1, 2)                      # channels_last view
        feat = self.base_model(x)["pool"]               # [NT, 2048]
        logits = self.new_fc(feat)          # eval: dropout is the identity
        return consensus(logits.reshape(n, t, -1)).float()


def variant(arch: str, num_class: int, num_segments: int,
            base_model: str = "resnet50", temporal: str = "action",
            shift_div: int = 8, action_fused: Any = None,
            action_stages: Any = (1, 2, 3, 4),
            dtype: torch.dtype = torch.float32, device: DeviceLike = None,
            generator: Optional[torch.Generator] = None) -> TSN:
    """Build the model surface ``arch`` (only ``tsn`` is ported)."""
    if arch == "tsn":
        return TSN(num_class=num_class, num_segments=num_segments,
                   base_model=base_model, temporal=temporal,
                   shift_div=shift_div, action_fused=action_fused,
                   action_stages=tuple(action_stages), dtype=dtype,
                   device=device, generator=generator)
    if arch in ("tsn_mtmm", "tsn_sd", "tsn_mtmm_sd") or \
            arch.startswith("tsn_middle"):
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP: MTMM/SD/middle "
            "surfaces)")
    raise ValueError(f"unknown arch: {arch}")
