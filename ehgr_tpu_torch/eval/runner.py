"""The test protocol (counterpart of ``ehgr_tpu/eval/runner.py``): the
``test.py`` / ``test_sd.py`` verbs of the reference.

Each video of the test dataset brings ``clip_num`` clips (and, for the
NvGesture multi-crop tests, several crops of each clip); every clip and
crop is scored, the softmax probabilities are averaged into one vote per
video, and top-1/5 and a confusion matrix are counted per head (the final
head, and with ``heads=4`` the SD model's three exits).

Batches come from the host loader as uint8; on the device they are
normalized at ``cfg.model.dtype``, run through the model, and voted.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ehgr_tpu_torch.configs import Config
from ehgr_tpu_torch.data.factory import build_test_dataset
from ehgr_tpu_torch.data.pipeline import Loader
from ehgr_tpu_torch.device import DeviceLike, resolve_device
from ehgr_tpu_torch.eval.metrics import ConfusionMatrix, topk_correct
from ehgr_tpu_torch.models.factory import build_model
from ehgr_tpu_torch.models.tsn import TSN
from ehgr_tpu_torch.ops.preprocess_device import normalize_clip
from ehgr_tpu_torch.train.checkpoints import load_for_model


def _build_model(cfg: Config, arch: str,
                 device: DeviceLike = None) -> Tuple[TSN, List[str]]:
    """``arch`` built from ``cfg`` on ``device`` (default CUDA) in eval
    mode, with the weights of ``cfg.run.checkpoint_path`` when it is set;
    returns the model and the checkpoint's keys it did not take."""
    model = build_model(cfg.model, arch, resolve_device(device))
    skipped = []
    if cfg.run.checkpoint_path:
        skipped = load_for_model(cfg.run.checkpoint_path, model)
        if skipped:
            logging.getLogger(__name__).warning(
                "checkpoint keys not loaded: %s", skipped)
    return model.eval(), skipped


def make_test_scorer(cfg: Config, model: torch.nn.Module, heads: int = 1,
                     device: DeviceLike = None) -> Callable:
    """One batch of the test loader -> each head's video probabilities.

    ``frames_u8 [V, K, crops*T, H, W, 3]`` (numpy) is uploaded as uint8,
    normalized at ``cfg.model.dtype`` and folded crop-major into
    ``V*K*crops`` clips of T frames (the multi-crop transforms emit whole
    frame groups per crop offset); the softmax of each of the model's first
    ``heads`` outputs is averaged over the ``K*crops`` clips of a video.
    Returns a tuple of ``heads`` f32 tensors ``[V, classes]`` on the
    device."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.model.dtype)
    t = cfg.model.num_segments
    mean, std = cfg.data.mean, cfg.data.std

    @torch.inference_mode()
    def score(frames_u8) -> Tuple[torch.Tensor, ...]:
        x = torch.as_tensor(frames_u8).to(dev)
        v, k, ct = x.shape[:3]
        crops = ct // t
        if crops * t != ct:
            raise ValueError(f"{ct} frames a clip is not a multiple of T={t}")
        x = normalize_clip(x, mean, std, dtype=dtype)
        out = model(x.reshape((v * k * crops, t) + x.shape[3:]))
        outs = out if isinstance(out, tuple) else (out,)
        return tuple(torch.softmax(lg.float(), dim=-1)
                     .reshape(v, k * crops, -1).mean(dim=1)
                     for lg in outs[:heads])

    return score


def run_test(cfg: Config, arch: str = "tsn", heads: int = 1,
             device: DeviceLike = None) -> Dict[str, float]:
    """Evaluate ``arch`` with the multi-clip protocol on ``device``
    (default CUDA).  ``heads=4`` scores the SD model's final head and its
    three exits (``test_sd.py``).  Returns ``n_videos``, ``final_top1/5``,
    ``mid{i}_top1/5`` and ``confusion`` (a ``ConfusionMatrix`` a head),
    the keys of ``ehgr_tpu.eval.runner.run_test``."""
    log = logging.getLogger(__name__)
    dev = resolve_device(device)
    dataset = build_test_dataset(cfg)
    model, _ = _build_model(cfg, arch, dev)
    loader = Loader(dataset, batch_size=max(1, 8 // cfg.data.clip_num or 1),
                    shuffle=False, num_workers=cfg.data.num_workers,
                    drop_last=False)
    score = make_test_scorer(cfg, model, heads, dev)

    names = ["final"] + [f"mid{i}" for i in range(1, heads)]
    cms = {n: ConfusionMatrix(cfg.model.num_classes) for n in names}
    correct = {n: {1: 0, 5: 0} for n in names}
    total = 0
    for batch in loader:
        probs = score(batch["rgb"])
        labels = torch.as_tensor(np.asarray(batch["label"])).to(dev)
        total += int(labels.shape[0])
        for n, p in zip(names, probs):
            c1, c5 = topk_correct(p, labels, (1, 5))
            correct[n][1] += int(c1)
            correct[n][5] += int(c5)
            cms[n].update(p.argmax(dim=-1).cpu().numpy(),
                          np.asarray(batch["label"]))

    results: Dict[str, float] = {"n_videos": total}
    for n in names:
        results[f"{n}_top1"] = 100.0 * correct[n][1] / max(total, 1)
        results[f"{n}_top5"] = 100.0 * correct[n][5] / max(total, 1)
    log.info("test results: %s", results)
    results["confusion"] = cms  # type: ignore[assignment]
    return results
