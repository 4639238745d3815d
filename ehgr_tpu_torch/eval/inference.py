"""Multi-clip inference protocol, the serving path (counterpart of
``ehgr_tpu/eval/inference.py``).

Videos arrive as uint8 ``[V, K, T, H, W, 3]``; they are moved to the device
as uint8, normalized there, and the ``V*K`` clips fold into one model batch.
Each clip's softmax is averaged into one distribution per video; top-1/5 and
a confusion matrix follow.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ehgr_tpu_torch.device import DeviceLike, resolve_device
from ehgr_tpu_torch.eval.metrics import ConfusionMatrix, topk_correct
from ehgr_tpu_torch.ops.preprocess_device import preprocess_eval_batch


def make_score_fn(model: torch.nn.Module, *, device: DeviceLike = None,
                  scale_size: int = 224, crop_size: int = 224,
                  square_resize: bool = True, dtype_name: str = "bfloat16",
                  heads: int = 1) -> Callable:
    """``frames_u8 [V,K,T,H,W,3]`` (numpy or tensor) -> ``video_probs
    [V, classes]`` on ``device`` (default CUDA; the model must live there).

    ``heads > 1`` votes on each of the model's first ``heads`` outputs (the
    SD model's final head and its exits, ``eval/runner.py``'s 4-head test)
    and returns their ``video_probs`` as a tuple."""
    dev = resolve_device(device)
    dtype = getattr(torch, dtype_name)
    model.eval()

    @torch.inference_mode()
    def score(frames_u8) -> torch.Tensor:
        x = torch.as_tensor(frames_u8).to(dev)
        v, k, t = x.shape[:3]
        x = preprocess_eval_batch(x, scale_size=scale_size,
                                  crop_size=crop_size,
                                  square_resize=square_resize, dtype=dtype)
        out = model(x.reshape((v * k, t) + x.shape[3:]))      # [V*K, C]
        outs = out if isinstance(out, tuple) else (out,)
        probs = tuple(torch.softmax(lg, dim=-1).reshape(v, k, -1)
                      .mean(dim=1) for lg in outs[:heads])     # clip voting
        return probs if heads > 1 else probs[0]

    return score


def evaluate(score_fn: Callable, batches, num_classes: int,
             ks=(1, 5)) -> dict:
    """Run the protocol over an iterable of ``(frames_u8, labels)`` host
    batches; returns top-k accuracies + confusion matrix."""
    cm = ConfusionMatrix(num_classes)
    correct = {k: 0 for k in ks}
    total = 0
    for frames, labels in batches:
        probs = score_fn(frames)
        labels_t = torch.as_tensor(np.asarray(labels), device=probs.device)
        for k, c in zip(ks, topk_correct(probs, labels_t, ks)):
            correct[k] += int(c)
        total += int(labels_t.shape[0])
        cm.update(probs.argmax(dim=-1).cpu().numpy(), np.asarray(labels))
    out = {f"top{k}": 100.0 * correct[k] / max(total, 1) for k in ks}
    out["confusion"] = cm
    out["n_videos"] = total
    return out
