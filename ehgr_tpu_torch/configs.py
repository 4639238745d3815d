"""Typed configuration of the port: its own copy of the JAX package's
``DataConfig``, ``ModelConfig``, ``Config`` and ``PRESETS``
(``ehgr_tpu/configs.py``), so the port imports nothing of that package.

Only the data and model settings are carried over; the optimizer, loss,
mesh and run settings arrive with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    """Dataset + input pipeline settings."""

    dataset: str = "EgoGesture"          # 'EgoGesture' | 'NvGesture' | 'synthetic'
    annot_path: str = ""
    clip_len: int = 8                    # T, frames per clip
    batch_size: int = 8                  # clips per global batch
    num_classes: int = 83                # 83 EgoGesture / 25 NvGesture
    scale_size: int = 224                # resize short side / square
    crop_size: int = 224                 # test-protocol crop
    # train crop when it differs from the test crop (NvGesture trains on
    # 224 crops but tests on 256); None = same as crop_size
    train_crop_size: Optional[int] = None

    @property
    def train_crop(self) -> int:
        return self.train_crop_size or self.crop_size
    # ImageNet statistics
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    clip_num: int = 10                   # clips per video at test time
    test_crops: int = 1                  # 1 (Ego) | 3 | 10 (Nv variants)
    num_workers: int = 4
    seed: int = 0
    backend: str = "pil"                 # 'pil' | 'native' | 'synthetic'
    synthetic_task: str = "random"       # 'random' | 'motion' | 'motion_hard'
    synthetic_videos: int = 64
    synthetic_distractors: int = 2
    synthetic_occlude: int = 0


@dataclass(frozen=True)
class ModelConfig:
    """Model family + backbone settings."""

    arch: str = "tsn"                    # tsn | tsn_mtmm | tsn_sd | tsn_mtmm_sd |
                                         # tsn_middle{1,2,3} | r2plus1d | slowonly
    base_model: str = "resnet50"
    num_segments: int = 8                # T at model level (== clip_len)
    num_classes: int = 83
    modality: str = "RGB"
    modal: str = "rgb"
    consensus_type: str = "avg"
    dropout: float = 0.5
    partial_bn: bool = False
    is_shift: bool = True
    temporal_module: str = "action"      # 'action' | 'tsm' | 'none'
    shift_div: int = 8
    shift_place: str = "blockres"
    temporal_pool: bool = False
    before_softmax: bool = True
    fc_lr5: bool = True
    pretrain: str = "imagenet"
    remat: bool = False
    # ACTION kernel mode: 'vjp' and None/'none' take the plain formulation
    # at eval; 'mega' the action_stats/action_apply kernels
    action_fused: Optional[str] = "vjp"
    quantize: object = False
    action_stages: Tuple[int, ...] = (1, 2, 3, 4)
    dtype: str = "bfloat16"              # compute dtype (params stay f32)
    vit: Optional[Tuple[int, int, int]] = None


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)

    def replace(self, **kw) -> "Config":
        return replace(self, **kw)

    def validate(self) -> "Config":
        if self.data.clip_len != self.model.num_segments:
            raise ValueError("clip_len must equal num_segments")
        if self.data.num_classes != self.model.num_classes:
            raise ValueError("data and model num_classes differ")
        if self.model.temporal_module not in ("action", "tsm", "none"):
            raise ValueError(
                f"unknown temporal module {self.model.temporal_module!r}")
        return self


def _ego_base(**model_kw) -> Config:
    """EgoGesture recipe: resnet50+ACTION, 8 frames, 224 square test."""
    return Config(
        data=DataConfig(dataset="EgoGesture", num_classes=83,
                        scale_size=224, crop_size=224, test_crops=1),
        model=ModelConfig(num_classes=83, **model_kw),
    )


def _nv_base(**model_kw) -> Config:
    """NvGesture recipe: 3-crop 256 test, 224 train crops."""
    return Config(
        data=DataConfig(dataset="NvGesture", num_classes=25,
                        scale_size=256, crop_size=256, train_crop_size=224,
                        test_crops=3),
        model=ModelConfig(num_classes=25, **model_kw),
    )


PRESETS = {
    "ego_baseline": _ego_base(arch="tsn"),
    "ego_mtmm": _ego_base(arch="tsn_mtmm", modal="rgb_depth"),
    "ego_sd": _ego_base(arch="tsn_sd"),
    "ego_mtmm_sd": _ego_base(arch="tsn_mtmm_sd", modal="rgb_depth"),
    "nv_baseline": _nv_base(arch="tsn"),
    "nv_mtmm": _nv_base(arch="tsn_mtmm", modal="rgb_depth"),
    "nv_sd": _nv_base(arch="tsn_sd"),
    "nv_mtmm_sd": _nv_base(arch="tsn_mtmm_sd", modal="rgb_depth"),
}


def get_preset(name: str) -> Config:
    return PRESETS[name].validate()
