"""The test protocol (counterpart of ``ehgr_tpu/eval/runner.py``): the
``test.py`` / ``test_sd.py`` verbs of the reference.

Each video of the test dataset brings ``clip_num`` clips (and, for the
NvGesture multi-crop tests, several crops of each clip); every clip and
crop is scored, the softmax probabilities are averaged into one vote per
video, and top-1/5 and a confusion matrix are counted per head (the final
head, and with ``heads=4`` the SD model's three exits).

Batches come from the host loader as uint8; on the device they are
normalized at ``cfg.model.dtype``, run through the model, and voted.

``cfg.model.quantize`` ('dynamic' or 'static') runs the backbone's block
convs in int8 (``ops/quantize.py``); 'static' first calibrates on the first
two batches of the test loader itself, as the JAX runner does.

The model is built by ``build_model``, which applies the config's
``temporal_pool``, ``before_softmax`` and ``modal``, so a checkpoint is
tested as it was trained.  The JAX runner builds ``variant`` without them
(a deliberate difference, README "Known deltas").
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
from ehgr_tpu_torch.ops.quantize import calibrate
from ehgr_tpu_torch.train.checkpoints import load_for_model


def calibration_clips(cfg: Config, dataset) -> List[np.ndarray]:
    """The clips int8 'static' calibrates on: the first two batches of an
    unshuffled one-thread loader over ``dataset`` (the one the test then
    scores, so its draws come first), each reshaped to uint8
    ``[clips, T, H, W, 3]``."""
    loader = Loader(dataset, batch_size=max(1, 8 // cfg.data.clip_num or 1),
                    shuffle=False, num_workers=0, drop_last=False)
    out = []
    t = cfg.model.num_segments
    for b in loader:
        rgb = np.asarray(b["rgb"])              # [V, K, crops*T, H, W, 3]
        out.append(rgb.reshape((-1, t) + rgb.shape[3:]))
        if len(out) == 2:
            break
    return out


def _build_model(cfg: Config, arch: str, device: DeviceLike = None,
                 calib_batches=None) -> Tuple[TSN, List[str]]:
    """``arch`` built from ``cfg`` on ``device`` (default CUDA) in eval
    mode, with the weights of ``cfg.run.checkpoint_path`` when it is set
    and ``cfg.model.quantize``; returns the model and the checkpoint's keys
    it did not take.  int8 'static' is calibrated on ``calib_batches``
    (uint8 clips ``[N, T, H, W, 3]``, normalized at float32; the model
    computes in its own dtype), or without them on standard-normal noise
    ``(8, T, crop, crop, 3)`` from ``cfg.run.seed``, with JAX's
    warning."""
    dev = resolve_device(device)
    log = logging.getLogger(__name__)
    model = build_model(cfg.model, arch, dev, quantize=cfg.model.quantize)
    skipped = []
    if cfg.run.checkpoint_path:
        skipped = load_for_model(cfg.run.checkpoint_path, model)
        if skipped:
            log.warning("checkpoint keys not loaded: %s", skipped)
    model.eval()
    if cfg.model.quantize == "static":
        if calib_batches:
            xs = [normalize_clip(torch.as_tensor(b).to(dev), cfg.data.mean,
                                 cfg.data.std, dtype=torch.float32)
                  for b in calib_batches]
        else:
            log.warning("int8 static: no calibration clips provided — "
                        "scales are noise-calibrated; accuracy may degrade")
            rng = np.random.default_rng(cfg.run.seed)
            xs = [torch.as_tensor(rng.standard_normal(
                (8, cfg.model.num_segments, cfg.data.crop_size,
                 cfg.data.crop_size, 3)), dtype=torch.float32, device=dev)]
        calibrate(model, xs)
    return model, skipped


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
    the keys of ``ehgr_tpu.eval.runner.run_test``.  int8 'static'
    calibrates on ``calibration_clips`` first."""
    log = logging.getLogger(__name__)
    dev = resolve_device(device)
    dataset = build_test_dataset(cfg)
    calib = calibration_clips(cfg, dataset) \
        if cfg.model.quantize == "static" else None
    model, _ = _build_model(cfg, arch, dev, calib)
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
