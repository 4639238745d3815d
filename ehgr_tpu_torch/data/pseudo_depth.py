"""Pseudo-depth generation, offline prep (the port's own copy of
``ehgr_tpu/data/pseudo_depth.py``).

The reference's ``preprocess/generate_pseudo_depth_{ego,nv}.py`` runs MiDaS
DPT_Large over every RGB frame and writes a parallel ``Depth_Est`` JPEG
tree.

``generate_pseudo_depth_tree`` takes any callable ``uint8 [H,W,3] -> float
[H,W]`` as ``predictor``; the built-in default writes luminance-based
placeholders, so the whole ``depth_est`` pipeline (annotations -> MTMM
``rgb_depthest`` training) runs without external weights.  The real
predictor, ``midas_predictor``, needs the DPT model, which the port does
not have yet.  Pillow is imported inside the functions that read and write
images.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np


def _gray_predictor(frame: np.ndarray) -> np.ndarray:
    """Luminance placeholder (NOT a depth estimate — pipeline plumbing only)."""
    f = frame.astype(np.float32)
    return (0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]) / 255.0


def generate_pseudo_depth_tree(
        rgb_root: str, out_root: str,
        predictor: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        rgb_dirname: str = "Color", out_dirname: str = "Depth_Est",
        rgb_prefix: str = "rgb", out_prefix: str = "depth_est") -> int:
    """Mirror an EgoGesture-style ``.../Color/rgb{g}/*.jpg`` tree into
    ``.../Depth_Est/depth_est{g}/*.jpg`` (ref
    ``preprocess/generate_pseudo_depth_ego.py:15-59``).  Returns the number
    of frames written."""
    from PIL import Image

    if predictor is None:
        predictor = _gray_predictor
    n = 0
    for dirpath, _, files in os.walk(rgb_root):
        jpgs = sorted(f for f in files if f.endswith(".jpg"))
        rel = os.path.relpath(dirpath, rgb_root)
        parts = [] if rel == "." else rel.split(os.sep)
        if not jpgs or rgb_dirname not in parts:
            continue
        # substitute per path COMPONENT below rgb_root, never on the root
        # prefix: a root that itself contains 'rgb' or 'Color' stays intact
        out_parts = [out_dirname if p == rgb_dirname
                     else out_prefix + p[len(rgb_prefix):]
                     if p.startswith(rgb_prefix) else p
                     for p in parts]
        out_dir = os.path.join(out_root, *out_parts)
        os.makedirs(out_dir, exist_ok=True)
        for f in jpgs:
            frame = np.asarray(Image.open(os.path.join(dirpath, f))
                               .convert("RGB"))
            depth = np.clip(predictor(frame), 0.0, 1.0)
            Image.fromarray((depth * 255).astype(np.uint8), "L").save(
                os.path.join(out_dir, f))
            n += 1
    return n


def midas_predictor(weights_path: Optional[str] = None):
    """Real MiDaS DPT_Large as a predictor (``uint8 [H,W,3] -> float
    [H,W]`` in [0,1]), for ``generate_pseudo_depth_tree``.

    ``weights_path`` must point at the official checkpoint
    (``dpt_large-midas-2f21e586.pt``), which the repository does not hold.
    Without it this raises the JAX package's error.  With it, it raises
    too: the DPT model (``ehgr_tpu/models/dpt.py``) is not ported yet."""
    if weights_path is None or not os.path.isfile(weights_path):
        raise RuntimeError(
            "MiDaS DPT_Large weights are not bundled (no network egress). "
            "Download dpt_large-midas-2f21e586.pt elsewhere and pass "
            "weights_path=, or provide generate_pseudo_depth_tree(..., "
            "predictor=<your uint8[H,W,3] -> float[H,W] model>).")
    raise NotImplementedError(
        "MiDaS DPT_Large needs the DPT model, which ehgr_tpu_torch does not "
        "have yet; pass generate_pseudo_depth_tree(..., predictor=<your "
        "uint8[H,W,3] -> float[H,W] model>) instead")
