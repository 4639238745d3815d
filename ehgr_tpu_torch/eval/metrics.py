"""Accuracy / confusion-matrix metrics (counterpart of
``ehgr_tpu/eval/metrics.py``): top-k counts on the device, the confusion
matrix on the host in numpy."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def topk_correct(logits: torch.Tensor, labels: torch.Tensor,
                 ks: Sequence[int] = (1, 5)) -> Tuple[torch.Tensor, ...]:
    """Number of top-k-correct rows for each k."""
    topi = torch.argsort(-logits, dim=-1, stable=True)[:, :max(ks)]
    hit = topi == labels[:, None]
    return tuple(hit[:, :k].any(dim=1).sum() for k in ks)


class ConfusionMatrix:
    """Streaming confusion matrix + per-class accuracy (host side)."""

    def __init__(self, num_classes: int):
        self.m = np.zeros((num_classes, num_classes), dtype=np.int64)

    def update(self, preds: np.ndarray, labels: np.ndarray):
        preds = np.asarray(preds).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        np.add.at(self.m, (labels, preds), 1)

    @property
    def per_class_accuracy(self) -> np.ndarray:
        denom = self.m.sum(axis=1)
        return np.divide(np.diag(self.m), denom,
                         out=np.zeros_like(denom, dtype=np.float64),
                         where=denom > 0)

    @property
    def normalized(self) -> np.ndarray:
        denom = self.m.sum(axis=1, keepdims=True)
        return np.divide(self.m, denom, out=np.zeros_like(self.m, np.float64),
                         where=denom > 0)
