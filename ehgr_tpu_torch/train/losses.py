"""Loss functions of the three training stages (counterpart of
``ehgr_tpu/train/losses.py``, the reference's numerics):

* cross entropy   -- mean CE over the batch.
* KD              -- ``-mean(sum(log_softmax(mid/T) * softmax(final/T)))``
                     scaled by T^2, teacher detached.
* feature hint    -- masked-L2 **sum** against the detached teacher feature.
* depth           -- mean MSE of the sigmoid depth against the [0, 1] target.
* SD total        -- ``(1-a)*sum(CE) + a*sum(KD) + b*sum(feat)``.

``data_size``: on a mesh of that many data ranks, each rank's totals are
its share of the global loss, so that the ranks' losses (and their
gradients) SUM to the global batch's: the mean terms (CE, KD, depth) are
divided by it, the feature hint, a sum over the batch, is not.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels.long())


def kd_loss(mid_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float = 3.0) -> torch.Tensor:
    """Soft-label distillation against the detached final head, already
    scaled by T^2."""
    teacher = torch.softmax(teacher_logits.detach() / temperature, dim=-1)
    logp = torch.log_softmax(mid_logits / temperature, dim=-1)
    return -(logp * teacher).sum(1).mean() * temperature ** 2


def feature_hint_loss(fea: torch.Tensor,
                      target_fea: torch.Tensor) -> torch.Tensor:
    """Masked-L2 SUM against the detached teacher feature."""
    t = target_fea.detach()
    mask = ((fea > 0) | (t > 0)).to(fea.dtype)
    return ((fea - t) ** 2 * mask).abs().sum()


def depth_loss(depth_pred: torch.Tensor,
               depth_gt: torch.Tensor) -> torch.Tensor:
    """Mean MSE of ``[NT, 56, 56, 1]`` sigmoid outputs against [0, 1]
    targets."""
    return ((depth_pred - depth_gt) ** 2).mean()


def share(mean: torch.Tensor, data_size: int = 1) -> torch.Tensor:
    """A data rank's share of a batch mean (the mean itself on one
    rank)."""
    return mean if data_size == 1 else mean / data_size


def mtmm_total(logits, labels, depth_pred, depth_gt,
               depth_weight: float = 0.01, data_size: int = 1
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    ce = share(cross_entropy(logits, labels), data_size)
    dl = share(depth_loss(depth_pred, depth_gt), data_size)
    return ce + depth_weight * dl, {"ce": ce, "depth": dl}


def sd_total(output, mids: Sequence[torch.Tensor], labels, final_fea,
             mid_feas: Sequence[torch.Tensor], alpha: float = 0.1,
             beta: float = 1e-6, temperature: float = 3.0,
             data_size: int = 1
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    ce = share(cross_entropy(output, labels), data_size)
    mid_ces = [share(cross_entropy(m, labels), data_size) for m in mids]
    kds = [share(kd_loss(m, output, temperature), data_size) for m in mids]
    feats = [feature_hint_loss(f, final_fea) for f in mid_feas]
    total = ((1.0 - alpha) * (ce + sum(mid_ces))
             + alpha * sum(kds) + beta * sum(feats))
    aux = {"ce": ce, "mid_ce": torch.stack(mid_ces), "kd": torch.stack(kds),
           "feat": torch.stack(feats)}
    return total, aux


def mtmm_sd_total(output, mids, labels, final_fea, mid_feas, depth_pred,
                  depth_gt, alpha: float = 0.1, beta: float = 1e-6,
                  temperature: float = 3.0, depth_weight: float = 0.01,
                  data_size: int = 1
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Joint stage: the SD losses plus the current clip's depth MSE."""
    total, aux = sd_total(output, mids, labels, final_fea, mid_feas,
                          alpha=alpha, beta=beta, temperature=temperature,
                          data_size=data_size)
    dl = share(depth_loss(depth_pred, depth_gt), data_size)
    aux["depth"] = dl
    return total + depth_weight * dl, aux
