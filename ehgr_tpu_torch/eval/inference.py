"""Multi-clip inference protocol, the serving path (counterpart of
``ehgr_tpu/eval/inference.py``).

Videos arrive as uint8 ``[V, K, T, H, W, 3]``; they are moved to the device
as uint8, normalized there, and the ``V*K`` clips fold into one model batch.
Each clip's softmax is averaged into one distribution per video; top-1/5 and
a confusion matrix follow.  A scorer call opens the program's spans
``ehgr.score`` / ``.upload`` / ``.preprocess`` / ``.model``
(``utils/profiling.py``).  ``make_sharded_score_fn`` scores over a mesh
(``parallel/mesh.py``): videos split over ``data``, heads optionally
sharded over ``model``.
"""

from __future__ import annotations

import itertools
from typing import Callable

import numpy as np
import torch

from ehgr_tpu_torch.device import DeviceLike, resolve_device
from ehgr_tpu_torch.eval.metrics import ConfusionMatrix, topk_correct
from ehgr_tpu_torch.ops.preprocess_device import preprocess_eval_batch
from ehgr_tpu_torch.parallel.collectives import sum_over
from ehgr_tpu_torch.parallel.mesh import shard_model
from ehgr_tpu_torch.utils.profiling import span


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
    calls = itertools.count()

    @torch.inference_mode()
    def score(frames_u8) -> torch.Tensor:
        with span("ehgr.score", next(calls)):
            with span("ehgr.score.upload"):
                x = torch.as_tensor(frames_u8).to(dev)
            v, k, t = x.shape[:3]
            with span("ehgr.score.preprocess"):
                x = preprocess_eval_batch(x, scale_size=scale_size,
                                          crop_size=crop_size,
                                          square_resize=square_resize,
                                          dtype=dtype)
            with span("ehgr.score.model"):
                out = model(x.reshape((v * k, t) + x.shape[3:]))  # [V*K, C]
            outs = out if isinstance(out, tuple) else (out,)
            probs = tuple(torch.softmax(lg, dim=-1).reshape(v, k, -1)
                          .mean(dim=1) for lg in outs[:heads])  # clip voting
            return probs if heads > 1 else probs[0]

    return score


def make_sharded_score_fn(model: torch.nn.Module, mesh, *,
                          model_parallel: bool = False,
                          **score_kw) -> Callable:
    """Data-parallel multi-clip scorer of one rank of ``mesh``: the same
    signature and result as ``make_score_fn``'s, on the full host batch
    ``[V, K, T, H, W, 3]`` on every rank.  The rank scores its ``V / data``
    videos (eval needs no traffic but the result's); with
    ``model_parallel`` the heads shard their out-features over ``model``
    (``parallel.mesh.shard_model``, in place) and gather their logits.
    Every rank returns the whole ``[V, classes]`` (the tuple for ``heads >
    1``), each rank's rows written into zeros and SUMmed over ``data``.  A
    video count that the data axis does not divide raises
    ``AssertionError``."""
    shard_model(model, mesh, model_parallel)
    score = make_score_fn(model, **{**score_kw, "device": mesh.device})
    ndata = mesh.data_size

    def fn(frames_u8):
        v = frames_u8.shape[0]
        if v % ndata:
            raise AssertionError(
                f"video batch {v} must divide data axis {ndata}")
        per = v // ndata
        start = mesh.data_index * per
        probs = score(frames_u8[start:start + per])
        outs = probs if isinstance(probs, tuple) else (probs,)
        full = {}
        for i, p in enumerate(outs):
            full[i] = p.new_zeros((v,) + p.shape[1:])
            full[i][start:start + per] = p
        if ndata > 1:
            full = sum_over(full, mesh.data_group)
        outs = tuple(full[i] for i in range(len(outs)))
        return outs if isinstance(probs, tuple) else outs[0]

    return fn


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
