"""Cross-stage weight transfer and loading weights from a file
(counterpart of ``merge_variables`` and ``load_for_model`` in
``ehgr_tpu/train/checkpoints.py``).

``merge_state_dict`` is the reference's ``load_state_dict(strict=False)``,
through which Stage 2 (``tsn_sd``) absorbs the Stage-1 ``tsn_mtmm`` weights
while its new exits keep their init, and a truncated ``tsn_middleK`` takes
its stages and exit K from a ``tsn_sd``.  ``load_for_model`` reads a
reference ``.pth`` / ``.pth.tar`` file into a model through it.  The orbax
checkpoints the JAX package writes, and the port's own checkpoint manager,
are ROADMAP items (queue 1, item 2).
"""

from __future__ import annotations

import os
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


def load_for_model(path: str, model: nn.Module,
                   strict: bool = False) -> List[str]:
    """Load the weights of a torch checkpoint file into ``model`` in place
    and return the keys of the file that were not copied.

    The file holds a reference payload ``{'state_dict': ...}`` (other
    entries, such as the optimizer's, are ignored) or a bare state dict,
    read with ``torch.load(weights_only=True)``.  Keys lose a leading
    ``module.`` (a ``DataParallel`` save); when no key names
    ``base_model.``, a bare backbone's keys gain that prefix where the
    model has such a key (an ImageNet ResNet), as
    ``ehgr_tpu.models.torch_import.load_torch_checkpoint`` maps them.  The
    tensors are merged through ``merge_state_dict``; ``strict=True``
    raises ``KeyError`` if a key of the model got no tensor (as the JAX
    package's loader raises for a leaf without a source)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package); reading orbax is not ported (ROADMAP: queue 1, item "
            "2, the loop and checkpoints)")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = payload.get("state_dict", payload) if isinstance(payload, dict) \
        else payload
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items()}
    if not any(k.startswith("base_model.") for k in sd):
        dst = model.state_dict()
        sd = {("base_model." + k if "base_model." + k in dst else k): v
              for k, v in sd.items()}
    skipped = merge_state_dict(model, sd)
    if strict:
        copied = set(sd) - set(skipped)
        missing = [k for k in model.state_dict() if k not in copied]
        if missing:
            raise KeyError(f"model keys without a tensor in {path}: "
                           f"{missing[:10]} (+{max(0, len(missing) - 10)} "
                           "more)")
    return skipped
