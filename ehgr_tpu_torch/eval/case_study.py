"""Qualitative prediction-video exporter (counterpart of
``ehgr_tpu/eval/case_study.py``; ref ``case_study.py``, broken as
committed: it imports the missing ``models.models_mtask``).

For each video: score its clips with the multi-clip protocol
(``case_study_scores``: normalize, the model, softmax, the mean over the
clips, on the model's device), annotate the first clip's frames with
"P:<pred> / L:<label>" banners and write them as an animated GIF (the
reference writes mp4 via cv2, ``case_study.py:108-120``).  Pillow is
imported inside the functions that draw and write.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ehgr_tpu_torch.ops.preprocess_device import normalize_clip


def annotate_frame(frame_u8: np.ndarray, pred_name: str, label_name: str,
                   correct: bool):
    """The frame as a PIL image with a black banner: the prediction (green
    when right, red when wrong) over the label (white)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(frame_u8).convert("RGB")
    draw = ImageDraw.Draw(img)
    color = (0, 200, 0) if correct else (220, 0, 0)
    draw.rectangle([0, 0, img.width, 26], fill=(0, 0, 0))
    draw.text((4, 2), f"P:{pred_name}", fill=color)
    draw.text((4, 14), f"L:{label_name}", fill=(255, 255, 255))
    return img


@torch.inference_mode()
def case_study_scores(model, frames_u8,
                      mean=(0.485, 0.456, 0.406),
                      std=(0.229, 0.224, 0.225)) -> torch.Tensor:
    """One video's clips ``[K, T, H, W, 3]`` uint8 -> its f32 class
    probabilities ``[classes]``: normalized at f32 on the model's device,
    the model at eval (the first output where it gives several), softmax,
    mean over the K clips."""
    dev = next(model.parameters()).device
    x = normalize_clip(torch.as_tensor(np.asarray(frames_u8)).to(dev),
                       mean, std)
    logits = model.eval()(x)
    if isinstance(logits, tuple):
        logits = logits[0]
    return torch.softmax(logits.float(), dim=-1).mean(dim=0)


def export_case_study(model, dataset, save_dir: str,
                      class_names: Optional[Sequence[str]] = None,
                      max_videos: int = 10,
                      mean=(0.485, 0.456, 0.406),
                      std=(0.229, 0.224, 0.225)) -> List[Dict]:
    """Score videos from a CaseStudyDataset (any source of ``rgb [K, T, H,
    W, 3]`` and ``label``) and export annotated GIFs.  Returns a manifest
    of ``{video, pred, label, correct, gif}`` records."""
    os.makedirs(save_dir, exist_ok=True)
    log = logging.getLogger(__name__)

    def name(c):
        return class_names[c] if class_names else str(c)

    manifest = []
    for idx in range(min(max_videos, len(dataset))):
        sample = dataset[idx]
        probs = case_study_scores(model, sample["rgb"], mean, std)
        pred = int(torch.argmax(probs))
        label = int(sample["label"])

        frames = sample["rgb"][0]  # first clip [T, H, W, 3]
        imgs = [annotate_frame(f, name(pred), name(label), pred == label)
                for f in frames]
        gif = os.path.join(save_dir, f"video{idx:04d}.gif")
        imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                     duration=120, loop=0)
        rec = {"video": idx, "pred": pred, "label": label,
               "correct": pred == label, "gif": gif}
        log.info("case_study %s", rec)
        manifest.append(rec)
    return manifest
