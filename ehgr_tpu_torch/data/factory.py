"""Dataset and transform assembly per stage and dataset (the port's own
copy of ``ehgr_tpu/data/factory.py``): ``build_train_datasets`` for the
training stages, ``build_test_dataset`` for the multi-clip test protocol,
and the train / eval / test spatial-transform tables.
"""

from __future__ import annotations

from typing import Tuple

from ehgr_tpu_torch.configs import Config
from ehgr_tpu_torch.data.datasets import (DistillDataset, InferenceDataset,
                                          MTMMDataset, OriginalDataset)
from ehgr_tpu_torch.data.synthetic import (LearnableClipSource,
                                           SyntheticClipSource)
from ehgr_tpu_torch.ops import spatial_transforms as st

_STAGE_DATASET = {
    "baseline": OriginalDataset,
    "mtmm": MTMMDataset,
    "sd": DistillDataset,
    "mtmm_sd": MTMMDataset,
}
_STAGE_FIELDS = {
    "baseline": ("rgb", "depth"),
    "mtmm": ("rgb", "depth", "depth_est", "n_depth", "n_depth_est"),
    "sd": ("rgb",),
    "mtmm_sd": ("rgb", "depth", "depth_est", "n_depth", "n_depth_est"),
}


def train_spatial_transform(cfg: Config, rng=None):
    """EgoGesture: square 224 resize + multi-scale crop; NvGesture:
    short-side 256 + multi-scale crop to 224 (``train_mtmm.py:440-488``) —
    geometry comes from ``scale_size``/``train_crop`` so the presets carry
    the train-vs-test crop split."""
    import numpy as np

    rng = rng or np.random.default_rng(cfg.run.seed)
    crop = cfg.data.train_crop
    if cfg.data.dataset == "NvGesture":
        return st.Compose([st.GroupScale(cfg.data.scale_size),
                           st.GroupMultiScaleCrop(crop, rng=rng)])
    return st.Compose([st.GroupScale([crop, crop]),
                       st.GroupMultiScaleCrop([crop, crop], rng=rng)])


def eval_spatial_transform(cfg: Config):
    """Training-time val transform (``train_mtmm.py:479-486``): NvGesture
    center-crops at the TRAIN crop size (224), not the test crop."""
    if cfg.data.dataset == "NvGesture":
        return st.Compose([st.GroupScale(cfg.data.scale_size),
                           st.GroupCenterCrop(cfg.data.train_crop)])
    c = cfg.data.train_crop
    return st.Compose([st.GroupScale([c, c])])


def test_spatial_transform(cfg: Config):
    """The test.py cropping table (``test.py:204-221``): EgoGesture plain
    square resize; NvGesture center/3-crop/10-crop by ``test_crops``."""
    if cfg.data.dataset != "NvGesture":
        c = cfg.data.crop_size
        return st.Compose([st.GroupScale([c, c])])
    if cfg.data.test_crops == 1:
        return st.Compose([st.GroupScale(cfg.data.scale_size),
                           st.GroupCenterCrop(cfg.data.crop_size)])
    if cfg.data.test_crops == 3:
        return st.GroupFullResSample(cfg.data.crop_size, cfg.data.scale_size,
                                     flip=False)
    if cfg.data.test_crops == 5:
        return st.GroupOverSample(cfg.data.crop_size, cfg.data.scale_size,
                                  flip=False)
    raise ValueError(f"unsupported test_crops: {cfg.data.test_crops}")


def _synthetic_source(cfg: Config):
    """Map ``synthetic_task`` onto a clip-source constructor."""
    import functools

    task = cfg.data.synthetic_task
    if task == "motion":
        return LearnableClipSource
    if task == "motion_hard":
        return functools.partial(
            LearnableClipSource, hard=True,
            distractors=cfg.data.synthetic_distractors,
            occlude=cfg.data.synthetic_occlude)
    return SyntheticClipSource


def build_train_datasets(cfg: Config, stage: str,
                         train_plus_val: bool = True) -> Tuple:
    """(train_ds, val_ds) for a stage; 'synthetic' backend needs no disk."""
    if cfg.data.backend == "synthetic":
        src = _synthetic_source(cfg)
        nv = cfg.data.synthetic_videos
        # motion_hard grades val HARD-ONLY (dis_mixture off): easy mixture
        # clips are a training aid, not an evaluation target (synthetic.py)
        hard_eval = ({"dis_mixture": False}
                     if cfg.data.synthetic_task == "motion_hard" else {})
        mk = lambda n, seed, **kw: src(
            n_videos=n, clip_len=cfg.data.clip_len,
            size=(cfg.data.train_crop, cfg.data.train_crop),
            num_classes=cfg.data.num_classes,
            fields=_STAGE_FIELDS[stage] + ("label",), seed=seed, **kw)
        return (mk(nv, cfg.run.seed),
                mk(max(nv // 4, 16), cfg.run.seed + 1, **hard_eval))

    cls = _STAGE_DATASET[stage]
    train_mode = "train_plus_val" if (
        train_plus_val and cfg.data.dataset == "EgoGesture") else "train"
    val_mode = "test" if (train_plus_val or cfg.data.dataset == "NvGesture") \
        else "val"
    train_ds = cls(cfg.data.annot_path, train_mode,
                   spatial_transform=train_spatial_transform(cfg),
                   temporal_transform="uniform_train",
                   clip_len=cfg.data.clip_len, seed=cfg.run.seed,
                   decode_backend=cfg.data.backend)
    val_ds = cls(cfg.data.annot_path, val_mode,
                 spatial_transform=eval_spatial_transform(cfg),
                 temporal_transform="uniform_val",
                 clip_len=cfg.data.clip_len, seed=cfg.run.seed,
                 decode_backend=cfg.data.backend)
    return train_ds, val_ds


def build_test_dataset(cfg: Config, multiple_clip_test: bool = True):
    """The multi-clip test protocol dataset (``test.py:237-284``)."""
    if cfg.data.backend == "synthetic":
        src = _synthetic_source(cfg)
        hard_eval = ({"dis_mixture": False}
                     if cfg.data.synthetic_task == "motion_hard" else {})
        return src(
            n_videos=max(cfg.data.synthetic_videos // 2, 32),
            clip_len=cfg.data.clip_len,
            size=(cfg.data.crop_size, cfg.data.crop_size),
            num_classes=cfg.data.num_classes, fields=("rgb", "label"),
            seed=cfg.run.seed + 7, clip_num=cfg.data.clip_num, **hard_eval)
    return InferenceDataset(
        cfg.data.annot_path, "test",
        spatial_transform=test_spatial_transform(cfg),
        temporal_transform=("uniform_train" if multiple_clip_test
                            else "uniform_val"),
        clip_len=cfg.data.clip_len, clip_num=cfg.data.clip_num,
        seed=cfg.run.seed, decode_backend=cfg.data.backend)
