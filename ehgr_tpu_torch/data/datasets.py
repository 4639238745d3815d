"""Clip datasets (the port's own copy of ``ehgr_tpu/data/datasets.py``):
one row of an annotation pickle -> a dict of uint8 ``[T, H, W, C]`` frames
and an int32 label, with the same frames, crops and draws as the JAX
package's classes from the same seed.

``OriginalDataset`` (rgb, depth), ``SDDataset`` / ``DistillDataset`` (rgb),
``MTMMDataset`` (rgb, depth, depth_est and the next segment's depth),
``InferenceDataset`` (``clip_num`` clips a video, the test protocol) and
``CaseStudyDataset`` (plus depth and frame paths).  Frames stay uint8:
normalisation runs on the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

from ehgr_tpu_torch.data.annotations import load_annotations
from ehgr_tpu_torch.ops import temporal_transforms as tt


def _transform_rngs(transform) -> list:
    """Collect the distinct np.random.Generator streams a group-transform
    chain draws from (Compose children, nested scale workers)."""
    rngs, seen = [], set()

    def walk(t):
        if t is None or id(t) in seen:
            return
        seen.add(id(t))
        r = getattr(t, "rng", None)
        if r is not None and all(r is not x for x in rngs):
            rngs.append(r)
        for sub in getattr(t, "transforms", None) or []:
            walk(sub)
        walk(getattr(t, "scale_worker", None))

    walk(transform)
    return rngs


def _decode(paths: Sequence[str], indices: np.ndarray, mode: str,
            spatial: Optional[Callable],
            backend: str = "pil") -> np.ndarray:
    """Decode selected frames, apply a group spatial transform, return
    ``[T', H, W, C]`` uint8 (T' may be crops*T for multi-crop evals).

    ``backend='native'`` takes the C++ decode->resize->crop path
    (``ehgr_tpu_torch/data/native_io.py``, bit-exact against PIL);
    ``'native_fast'`` also allows DCT-scaled JPEG decode (same geometry,
    not bit-identical to PIL).  A chain the native planner does not cover
    (``UnsupportedChain``) or a file the native decoder cannot read
    (``IOError``) is decoded by PIL for that clip, after the transform's rng
    streams are put back to where they were before the planner drew from
    them, so later samples draw as on the PIL backend.  A library that does
    not build or load raises (``RuntimeError``): the native backend never
    falls back to PIL for that."""
    if backend in ("native", "native_fast"):
        from ehgr_tpu_torch.data import native_io

        rngs = _transform_rngs(spatial)
        states = [r.bit_generator.state for r in rngs]
        try:
            return native_io.decode_clip(list(paths), np.asarray(indices),
                                         mode, spatial,
                                         fast=(backend == "native_fast"))
        except (native_io.UnsupportedChain, IOError):
            for r, s in zip(rngs, states):
                r.bit_generator.state = s
    from PIL import Image

    imgs = [Image.open(paths[i]).convert(mode) for i in indices]
    if spatial is not None:
        imgs = spatial(imgs)
    arrs = []
    for im in imgs:
        a = np.asarray(im)
        if a.ndim == 2:
            a = a[:, :, None]
        arrs.append(a)
    return np.stack(arrs, axis=0)


class ClipDataset:
    """Base: one row of the annotation pickle -> one training example."""

    #: columns this variant decodes
    modalities = ("rgb",)

    def __init__(self, annot_path: str, mode: str,
                 spatial_transform: Optional[Callable] = None,
                 temporal_transform: str = "uniform_train",
                 clip_len: int = 8, seed: int = 0,
                 decode_backend: str = "pil"):
        df = load_annotations(annot_path, mode)
        self.samples = {c: list(df[c]) for c in df.columns if c != "label"}
        self.labels = [int(l) for l in df["label"]]
        self.spatial = spatial_transform
        self.temporal = temporal_transform
        self.clip_len = clip_len
        self.decode_backend = decode_backend
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.labels)

    def _sample_indices(self, num_frames: int) -> np.ndarray:
        if self.temporal == "uniform_train":
            return tt.uniform_train(num_frames, self.clip_len, self.rng)
        if self.temporal == "uniform_val":
            return tt.uniform_val(num_frames, self.clip_len)
        if self.temporal == "uniform_test":
            return tt.uniform_test(num_frames, self.clip_len)
        if self.temporal == "dense_train":
            return tt.dense_train(num_frames, self.clip_len, self.rng)
        raise ValueError(self.temporal)

    def _dec(self, paths, sel, mode):
        return _decode(paths, sel, mode, self.spatial,
                       backend=self.decode_backend)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError


class OriginalDataset(ClipDataset):
    """(rgb, depth, label) — baseline/slowonly trainers
    (``dataset_video_original``, ref :141-169)."""

    def __getitem__(self, idx):
        rgb_p = self.samples["rgb"][idx]
        sel = self._sample_indices(len(rgb_p))
        return {
            "rgb": self._dec(rgb_p, sel, "RGB"),
            "depth": self._dec(self.samples["depth"][idx], sel, "L"),
            "label": np.int32(self.labels[idx]),
        }


class SDDataset(ClipDataset):
    """(rgb, label) — SD stage (``dataset_video_SD``, ref :237-260)."""

    def __getitem__(self, idx):
        rgb_p = self.samples["rgb"][idx]
        sel = self._sample_indices(len(rgb_p))
        return {"rgb": self._dec(rgb_p, sel, "RGB"),
                "label": np.int32(self.labels[idx])}


class DistillDataset(SDDataset):
    """The dataset the reference forgot to define (train_sd.py:572):
    same (rgb, label) contract as SDDataset."""


class MTMMDataset(ClipDataset):
    """6-field MTMM contract with NEXT-segment depth targets
    (``dataset_video_MTMM``, ref :172-234; next indices at :190-192)."""

    def __getitem__(self, idx):
        rgb_p = self.samples["rgb"][idx]
        depth_p = self.samples["depth"][idx]
        dest_p = self.samples["depth_est"][idx]
        n = len(rgb_p)
        sel = self._sample_indices(n)
        nxt = tt.next_segment_indices(sel, n)
        return {
            "rgb": self._dec(rgb_p, sel, "RGB"),
            "depth": self._dec(depth_p, sel, "L"),
            "depth_est": self._dec(dest_p, sel, "L"),
            "n_depth": self._dec(depth_p, nxt, "L"),
            "n_depth_est": self._dec(dest_p, nxt, "L"),
            "label": np.int32(self.labels[idx]),
        }


class InferenceDataset(ClipDataset):
    """``clip_num`` random clips per video -> ``[K, T', H, W, 3]``
    (``dataset_video_inference``, ref :263-296; the test.py protocol)."""

    def __init__(self, *args, clip_num: int = 10, **kw):
        super().__init__(*args, **kw)
        self.clip_num = clip_num

    def __getitem__(self, idx):
        rgb_p = self.samples["rgb"][idx]
        n = len(rgb_p)
        clips = []
        for _ in range(self.clip_num):
            sel = self._sample_indices(n)
            clips.append(self._dec(rgb_p, sel, "RGB"))
        return {"rgb": np.stack(clips, axis=0),
                "label": np.int32(self.labels[idx])}


class CaseStudyDataset(InferenceDataset):
    """Inference clips + depth + frame paths for qualitative export
    (``dataset_video_case_study``, ref :299-352)."""

    def __getitem__(self, idx):
        out = super().__getitem__(idx)
        rgb_p = self.samples["rgb"][idx]
        n = len(rgb_p)
        sel = self._sample_indices(n)
        out["depth"] = self._dec(self.samples["depth"][idx], sel, "L")
        if "depth_est" in self.samples:
            out["depth_est"] = self._dec(self.samples["depth_est"][idx],
                                         sel, "L")
        out["paths"] = [rgb_p[i] for i in sel]
        return out


DATASETS = {
    "original": OriginalDataset,
    "mtmm": MTMMDataset,
    "sd": SDDataset,
    "distill": DistillDataset,
    "inference": InferenceDataset,
    "case_study": CaseStudyDataset,
}
