"""Typed configuration of the port: its own copy of the JAX package's
``DataConfig``, ``ModelConfig``, ``OptimConfig``, ``LossConfig``,
``RunConfig``, ``Config``, ``PRESETS`` and ``config_from_args``
(``ehgr_tpu/configs.py``), so the port imports nothing of that package.

The mesh settings (``ParallelConfig``) are not ported: the port runs on one
card until DDP is ported (ROADMAP §1, the DDP item).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple


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
                                         # tsn_middle{1,2,3} | r2plus1d |
                                         # r2plus1d_mtmm | slowonly | videomae
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
    # ACTION kernel mode: at eval 'vjp' and None/'none' take the plain
    # formulation, 'mega' the action_stats/action_apply kernels; in training
    # 'vjp' runs the kernel region (ops/action_vjp.py), the others autograd
    action_fused: Optional[str] = "vjp"
    quantize: object = False
    action_stages: Tuple[int, ...] = (1, 2, 3, 4)
    dtype: str = "bfloat16"              # compute dtype (params stay f32)
    vit: Optional[Tuple[int, int, int]] = None


@dataclass(frozen=True)
class OptimConfig:
    """SGD + 9-group lr/decay policy + step decay."""

    lr: float = 0.00125
    momentum: float = 0.9
    weight_decay: float = 1e-5
    lr_steps: Tuple[int, ...] = (10, 15, 20)   # epochs at which lr *= 0.1
    gamma: float = 0.1
    epochs: int = 25
    # declared but never applied in the reference trainers; None matches
    # the actual runs
    clip_gradient: Optional[float] = None
    ema_decay: float = 0.9999                  # 0.999 for NvGesture
    # False = single param group; True = the 9-group lr/decay policy walk
    policies: bool = True
    # >1 = gradient accumulation: each batch in this many microbatches, one
    # optimizer/EMA update per batch (train/steps.py)
    accum_steps: int = 1


@dataclass(frozen=True)
class LossConfig:
    """MTMM + SD loss weights."""

    depth_weight: float = 0.01        # CE + w * MSE(depth)
    depth_size: int = 56              # GT depth resized to 56x56
    temperature: float = 3.0          # KD softmax temperature
    alpha: float = 0.1                # KD mixing: (1-a)*CE + a*KD
    beta: float = 1e-6                # feature-hint weight


@dataclass(frozen=True)
class RunConfig:
    """Logging and checkpoint housekeeping."""

    run_dir: str = "runs"
    model_name: str = "ACTION_resnet50"
    display: int = 100                # log every N steps
    save_depth_images: bool = False
    seed: int = 0
    checkpoint_path: str = ""         # weights to start from (--checkpoint_path)
    # restore the full train state (optimizer, EMA, step) from
    # checkpoint_path, not the weights alone
    resume_full: bool = False
    # write checkpoints once at the end of training instead of every epoch
    ckpt_light: bool = False


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    run: RunConfig = field(default_factory=RunConfig)

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
        if self.model.arch not in ARCHS:
            raise ValueError(f"unknown arch {self.model.arch!r}")
        return self


ARCHS = ("tsn", "tsn_mtmm", "tsn_sd", "tsn_mtmm_sd", "tsn_middle1",
         "tsn_middle2", "tsn_middle3", "r2plus1d", "r2plus1d_mtmm",
         "slowonly", "videomae")


def _ego_base(**model_kw) -> Config:
    """EgoGesture recipe: resnet50+ACTION, 8 frames, 224 square test."""
    return Config(
        data=DataConfig(dataset="EgoGesture", num_classes=83,
                        scale_size=224, crop_size=224, test_crops=1),
        model=ModelConfig(num_classes=83, **model_kw),
        optim=OptimConfig(epochs=25, lr_steps=(10, 15, 20)),
    )


def _nv_base(**model_kw) -> Config:
    """NvGesture recipe: 3-crop 256 test, 224 train crops."""
    return Config(
        data=DataConfig(dataset="NvGesture", num_classes=25,
                        scale_size=256, crop_size=256, train_crop_size=224,
                        test_crops=3),
        model=ModelConfig(num_classes=25, **model_kw),
        optim=OptimConfig(epochs=80, lr_steps=(50, 60, 70), ema_decay=0.999),
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


def config_from_args(argv: Sequence[str],
                     default_preset: str = "ego_baseline") -> Config:
    """The CLI flags of ``ehgr_tpu.configs.config_from_args`` (the
    reference's flag names) over a preset, giving the same value for every
    field of this ``Config`` (the JAX ``ParallelConfig`` has no
    counterpart, nor flags)."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--preset", default=default_preset, choices=sorted(PRESETS))
    p.add_argument("--dataset", default=None)
    p.add_argument("--annot_path", default=None)
    p.add_argument("--clip_len", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--wd", type=float, default=None)
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr_steps", type=int, nargs="+", default=None)
    p.add_argument("--base_model", default=None)
    p.add_argument("--is_shift", action="store_true", default=None)
    p.add_argument("--shift_div", type=int, default=None)
    p.add_argument("--modal", default=None)
    p.add_argument("--model_name", default=None)
    p.add_argument("--ema_decay", type=float, default=None)
    p.add_argument("--synthetic", action="store_true", default=False)
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--clip_num", type=int, default=None)
    p.add_argument("--test_crops", type=int, default=None)
    p.add_argument("--scale_size", type=int, default=None)
    p.add_argument("--crop_size", type=int, default=None)
    p.add_argument("--train_crop_size", type=int, default=None)
    p.add_argument("--backend", default=None,
                   choices=["pil", "native", "native_fast"],
                   help="host decode path (native = C++ fused decoder)")
    p.add_argument("--action_fused", default=None,
                   choices=["prologue", "mega", "vjp", "none"],
                   help="ACTION kernel mode (default 'vjp': the kernel "
                        "region in training, the plain formulation at eval)")
    p.add_argument("--action_stages", type=int, nargs="+", default=None,
                   help="stages carrying ACTION (placement ablation)")
    p.add_argument("--quantize", default=None,
                   choices=["dynamic", "static"],
                   help="int8 inference for the backbone's block convs "
                        "(the test runner; trainers train float)")
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--run_dir", default=None)
    p.add_argument("--synthetic_videos", type=int, default=None)
    p.add_argument("--vit", type=int, nargs=3, default=None,
                   metavar=("DIM", "DEPTH", "HEADS"),
                   help="videomae encoder size")
    p.add_argument("--accum_steps", type=int, default=None,
                   help="gradient accumulation: microbatches per step")
    args = p.parse_args(argv)

    cfg = get_preset(args.preset)
    d, m, o, r = cfg.data, cfg.model, cfg.optim, cfg.run

    def upd(obj, **kw):
        kw = {k: v for k, v in kw.items() if v is not None}
        return replace(obj, **kw) if kw else obj

    d = upd(d, dataset=args.dataset, annot_path=args.annot_path,
            clip_len=args.clip_len, batch_size=args.batch_size,
            clip_num=args.clip_num, test_crops=args.test_crops,
            scale_size=args.scale_size, crop_size=args.crop_size,
            train_crop_size=args.train_crop_size, backend=args.backend,
            num_classes=args.num_classes,
            synthetic_videos=args.synthetic_videos)
    if args.synthetic:
        d = replace(d, backend="synthetic")
    m = upd(m, base_model=args.base_model, shift_div=args.shift_div,
            modal=args.modal, dropout=args.dropout,
            num_segments=args.clip_len, action_fused=args.action_fused,
            quantize=args.quantize, num_classes=args.num_classes,
            action_stages=(tuple(args.action_stages)
                           if args.action_stages else None),
            vit=tuple(args.vit) if args.vit else None)
    o = upd(o, lr=args.lr, weight_decay=args.wd, epochs=args.epochs,
            lr_steps=tuple(args.lr_steps) if args.lr_steps else None,
            ema_decay=args.ema_decay, accum_steps=args.accum_steps)
    r = upd(r, model_name=args.model_name,
            checkpoint_path=args.checkpoint_path, run_dir=args.run_dir)
    return Config(data=d, model=m, optim=o, loss=cfg.loss, run=r).validate()
