"""Cross-stage weight transfer (counterpart of ``merge_variables`` in
``ehgr_tpu/train/checkpoints.py``): the reference's
``load_state_dict(strict=False)``, through which Stage 2 (``tsn_sd``)
absorbs the Stage-1 ``tsn_mtmm`` weights while its new exits keep their
init, and a truncated ``tsn_middleK`` takes its stages and exit K from a
``tsn_sd``.  Saving and restoring checkpoints are a ROADMAP item.
"""

from __future__ import annotations

from typing import List, Mapping

import torch
from torch import nn


@torch.no_grad()
def merge_state_dict(model: nn.Module,
                     src: Mapping[str, torch.Tensor]) -> List[str]:
    """Copy into ``model``, in place, every tensor of ``src`` whose key and
    shape ``model``'s ``state_dict`` has; returns the keys of ``src`` that
    were not copied, in ``src``'s order."""
    dst = model.state_dict()
    skipped = []
    for key, value in src.items():
        if key in dst and dst[key].shape == value.shape:
            dst[key].copy_(value)
        else:
            skipped.append(key)
    return skipped
