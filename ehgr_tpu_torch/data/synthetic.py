"""Synthetic data sources (the port's own copy of
``ehgr_tpu/data/synthetic.py``), so the data layer and the test runner run
without the EgoGesture / NvGesture trees:

* ``make_synthetic_ego_tree`` / ``make_synthetic_nv_tree`` write miniature
  JPEG trees in each dataset's layout, with the label files the annotation
  builders parse;
* ``LearnableClipSource`` renders moving-patch clips whose label is a
  function of the motion (and colour), ``SyntheticClipSource`` class-biased
  noise clips; both in memory, with the dataset classes' mapping interface.

Every array is drawn from the same ``numpy.random.Generator`` streams as in
the JAX package, so a seed gives the same clips bit for bit.  PIL is
imported inside the two tree builders only.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


def make_synthetic_ego_tree(root: str, subjects=(3, 1, 2), scenes: int = 1,
                            groups: int = 1, gestures_per_group: int = 3,
                            frames_per_gesture: int = 24,
                            size: Tuple[int, int] = (48, 64),
                            num_classes: int = 5, seed: int = 0) -> Dict[str, str]:
    """Build a miniature EgoGesture-layout tree (one train/val/test subject
    by default — IDs 3/1/2 fall in the reference's respective splits).
    Returns {'frame_path', 'label_path'}."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    frame_path = os.path.join(root, "frames")
    label_path = os.path.join(root, "labels")
    h, w = size
    for sub in subjects:
        for scene in range(1, scenes + 1):
            lab_dir = os.path.join(label_path, f"subject{sub:02}",
                                   f"Scene{scene}")
            os.makedirs(lab_dir, exist_ok=True)
            for g in range(1, groups + 1):
                rgb_dir = os.path.join(frame_path, f"Subject{sub:02}",
                                       f"Scene{scene}", "Color", f"rgb{g}")
                dep_dir = os.path.join(frame_path, f"Subject{sub:02}",
                                       f"Scene{scene}", "Depth", f"depth{g}")
                dest_dir = os.path.join(frame_path, f"Subject{sub:02}",
                                        f"Scene{scene}", "Depth_Est",
                                        f"depth_est{g}")
                for d in (rgb_dir, dep_dir, dest_dir):
                    os.makedirs(d, exist_ok=True)
                rows = []
                frame_i = 1
                for _ in range(gestures_per_group):
                    cls = int(rng.integers(1, num_classes + 1))  # 1-based
                    start = frame_i
                    end = frame_i + frames_per_gesture
                    for i in range(start, end):
                        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        # class-dependent bias so models can fit
                        arr[..., 0] = np.clip(
                            arr[..., 0] * 0.5 + cls * 40, 0, 255)
                        Image.fromarray(arr).save(
                            os.path.join(rgb_dir, f"{i:06}.jpg"))
                        dep = rng.integers(0, 256, (h, w), dtype=np.uint8)
                        Image.fromarray(dep, "L").save(
                            os.path.join(dep_dir, f"{i:06}.jpg"))
                        Image.fromarray(dep, "L").save(
                            os.path.join(dest_dir, f"{i:06}.jpg"))
                    rows.append((cls, start, end + 1))  # builder uses end-1
                    frame_i = end
                with open(os.path.join(lab_dir, f"Group{g}.csv"), "w") as f:
                    for cls, s, e in rows:
                        f.write(f"{cls},{s},{e}\n")
    return {"frame_path": frame_path, "label_path": label_path}


def make_synthetic_nv_tree(root: str, n_videos: int = 6,
                           frames_per_video: int = 24,
                           size: Tuple[int, int] = (60, 80),
                           num_classes: int = 5, seed: int = 0) -> str:
    """Build a miniature NvGesture-layout tree: per-video
    ``Video_data/class_XX/subjectN_r0/{sk_color_all,sk_depth_all,
    sk_depth_est_all}/*.jpg`` plus the two ``.lst`` files the annotation
    builder parses (the ``.lst`` field layout: ``path:.`` 0, start/end in field 2, ``label:`` field 4).
    Returns the dataset root (== the ``.lst`` directory)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = size
    lines = []
    for v in range(n_videos):
        cls = v % num_classes + 1  # 1-based in the .lst
        rel = f"Video_data/class_{cls:02}/subject{v + 1}_r0"
        base = os.path.join(root, rel)
        for sub in ("sk_color_all", "sk_depth_all", "sk_depth_est_all"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        for i in range(1, frames_per_video + 1):
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            arr[..., 0] = np.clip(arr[..., 0] * 0.5 + cls * 40, 0, 255)
            Image.fromarray(arr).save(
                os.path.join(base, "sk_color_all", f"{i:05}.jpg"))
            dep = rng.integers(0, 256, (h, w), dtype=np.uint8)
            Image.fromarray(dep, "L").save(
                os.path.join(base, "sk_depth_all", f"{i:05}.jpg"))
            Image.fromarray(dep, "L").save(
                os.path.join(base, "sk_depth_est_all", f"{i:05}.jpg"))
        lines.append(f"path:./{rel} depth:x color:x:1:{frames_per_video - 1} "
                     f"duration:x label:{cls}\n")
    for mode in ("train", "test"):
        with open(os.path.join(
                root, f"nvgesture_{mode}_correct_cvpr2016_v2.lst"), "w") as f:
            f.writelines(lines)
    return root


_DIRS = np.array([(0, 1), (0, -1), (1, 0), (-1, 0),
                  (1, 1), (1, -1), (-1, 1), (-1, -1)], np.int32)  # (dy, dx)

# hard-mode speed classes (px/frame): decoding 1 vs 3 px/frame needs
# precise temporal integration, not just any-motion detection
_HARD_SPEEDS = (1, 3)


def _color_palette(n: int) -> np.ndarray:
    """n maximally-separated saturated RGB colors (hue wheel)."""
    import colorsys
    cols = [colorsys.hsv_to_rgb(i / max(n, 1), 1.0, 1.0) for i in range(n)]
    return (np.array(cols) * 255).astype(np.uint8)


class LearnableClipSource:
    """Moving-patch clips whose label is a DETERMINISTIC function of the
    clip's content — the end-to-end learnability proxy .

    Each video shows one bright square patch translating at constant
    velocity over a noise background.  ``label = color_idx * n_dirs +
    dir_idx``: the motion direction indexes ``_DIRS`` (8 compass
    directions) and, when ``num_classes > 8``, the patch color carries the
    remaining bits.  Decoding the direction requires TEMPORAL reasoning
    (the ACTION/TSM path); color is a spatial cue.  A recipe that cannot
    learn this task has a label/loader/collate/sharding misalignment that
    trajectory-parity tests cannot see.

    Depth fields localize the patch (bright square on dark ground) and
    move WITH it, so the MTMM next-segment depth loss
    is genuinely predictive:
    ``n_depth`` renders the patch one velocity step ahead of ``rgb``,
    mirroring the reference's ``selected_indice[1:] + [last+1]`` contract
    (``data/dataset_EgoGesture.py:190-192``).
    """

    def __init__(self, n_videos: int = 256, clip_len: int = 8,
                 size: Tuple[int, int] = (64, 64), num_classes: int = 16,
                 fields: Tuple[str, ...] = ("rgb", "label"), seed: int = 0,
                 clip_num: int = 0, noise: int = 96, hard: bool = False,
                 distractors: int = 2, occlude: int = 0,
                 dis_mixture: bool = True):
        assert num_classes <= 8 * 32, num_classes
        self.n = n_videos
        self.t = clip_len
        self.h, self.w = size
        self.num_classes = num_classes
        self.fields = fields
        self.clip_num = clip_num
        self.noise = noise
        self.hard = hard
        self.occlude = occlude
        # train keeps the 0..K mixture (easy clips give optimization a
        # toothold); val/test grade HARD-ONLY (always K distractors — an
        # in-support subset of the train distribution) so easy clips
        # cannot inflate the exit ladder into saturation
        self.dis_mixture = dis_mixture
        self.n_dirs = min(num_classes, len(_DIRS))
        if hard:
            # hard variant: label = dir * speed of the single ACHROMATIC
            # (white, brightness-jittered) patch; colored distractor
            # patches move with independent dir/speed, so the
            # pooled representation must bind "direction of the white one",
            # not "any motion".  Smaller patch, target-only depth, so the
            # SD exits order strictly instead of saturating.
            n_speeds = -(-num_classes // self.n_dirs)
            assert n_speeds <= len(_HARD_SPEEDS), num_classes
            self.speeds = _HARD_SPEEDS[:max(n_speeds, 1)]
            self.distractors = distractors
            self.palette = _color_palette(max(distractors, 1) * 2)
            self.patch = max(5, self.h // 8)
        else:
            self.speeds = None
            self.distractors = 0
            n_colors = -(-num_classes // self.n_dirs)  # ceil
            self.palette = (_color_palette(n_colors) if n_colors > 1
                            else np.array([[255, 255, 255]], np.uint8))
            self.patch = max(6, self.h // 5)
        # keep the whole T+1-step trajectory in frame: travel <= min(h,w)
        # minus patch minus a start margin
        self.vel = max(2, (min(self.h, self.w) - self.patch - 4)
                       // (clip_len + 1))
        # balanced labels: idx round-robins the classes
        self.labels = (np.arange(n_videos) % num_classes).astype(np.int32)
        self._seed = seed

    def __len__(self):
        return self.n

    def _positions(self, rng, d: np.ndarray, vel: int) -> np.ndarray:
        """Start position uniform in the box that keeps t=0..T in bounds."""
        travel = vel * self.t  # n_depth needs position at t=T
        pos = np.empty(2, np.int32)
        for ax, lim in ((0, self.h), (1, self.w)):
            lo = travel if d[ax] < 0 else 0
            hi = lim - self.patch - (travel if d[ax] > 0 else 0)
            pos[ax] = rng.integers(lo, max(lo + 1, hi + 1))
        steps = np.arange(self.t + 1, dtype=np.int32)
        return pos[None, :] + steps[:, None] * vel * d[None, :]

    def _render(self, rng, label: int):
        """One clip: rgb [T,h,w,3], depth [T,h,w,1], n_depth [T,h,w,1]."""
        d = _DIRS[label % self.n_dirs]
        rgb = rng.integers(0, self.noise, (self.t, self.h, self.w, 3),
                           dtype=np.uint8)
        dep = rng.integers(20, 60, (self.t + 1, self.h, self.w, 1),
                           dtype=np.uint8)
        p = self.patch
        if self.hard:
            vel = self.speeds[label // self.n_dirs]
            # distractor-count MIXTURE 0..K per clip: clips without
            # distractors give optimization a toothold (the pure binding
            # task has no partial credit and barely trains from scratch),
            # clips with them grade difficulty so exits
            # ladder — deep features win the hard subset
            n_dis = (int(rng.integers(0, self.distractors + 1))
                     if self.dis_mixture else self.distractors)
            # distractors first (target drawn last, always on top)
            for k in range(n_dis):
                dd = _DIRS[rng.integers(0, len(_DIRS))]
                dv = self.speeds[rng.integers(0, len(self.speeds))]
                dpos = self._positions(rng, dd, dv)
                col = self.palette[rng.integers(0, len(self.palette))]
                for t in range(self.t):
                    y, x = dpos[t]
                    rgb[t, y:y + p, x:x + p] = col
            pos = self._positions(rng, d, vel)
            hide = (set(rng.choice(self.t, self.occlude, replace=False))
                    if self.occlude else set())
            for t in range(self.t + 1):
                y, x = pos[t]
                if t < self.t and t not in hide:
                    # per-frame brightness jitter kills any fixed-intensity
                    # shortcut; achromatic (R=G=B) is the selection cue
                    rgb[t, y:y + p, x:x + p] = rng.integers(180, 256)
                dep[t, y:y + p, x:x + p] = 220  # depth shows the TARGET only
            return rgb, dep[:-1], dep[1:]
        color = self.palette[label // self.n_dirs]
        pos = self._positions(rng, d, self.vel)           # [T+1, 2]
        for t in range(self.t + 1):
            y, x = pos[t]
            if t < self.t:
                rgb[t, y:y + p, x:x + p] = color
            dep[t, y:y + p, x:x + p] = 220
        return rgb, dep[:-1], dep[1:]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self._seed * 100003 + idx)
        label = int(self.labels[idx])
        out: Dict[str, np.ndarray] = {"label": np.int32(label)}
        k = self.clip_num or 1
        clips = [self._render(rng, label) for _ in range(k)]
        rgb = np.stack([c[0] for c in clips])
        out["rgb"] = rgb if self.clip_num else rgb[0]
        # depth fields are only consumed clip_num-less (train stages)
        if "depth" in self.fields or "depth_est" in self.fields:
            for name in ("depth", "depth_est"):
                if name in self.fields:
                    out[name] = clips[0][1]
        for name in ("n_depth", "n_depth_est"):
            if name in self.fields:
                out[name] = clips[0][2]
        return out


class SyntheticClipSource:
    """In-memory dataset with the same mapping interface as
    ``ehgr_tpu_torch.data.datasets`` classes; fields selectable per stage."""

    def __init__(self, n_videos: int = 64, clip_len: int = 8,
                 size: Tuple[int, int] = (224, 224), num_classes: int = 83,
                 fields: Tuple[str, ...] = ("rgb", "label"), seed: int = 0,
                 clip_num: int = 0):
        self.n = n_videos
        self.t = clip_len
        self.h, self.w = size
        self.num_classes = num_classes
        self.fields = fields
        self.clip_num = clip_num
        rng = np.random.default_rng(seed)
        self.labels = rng.integers(0, num_classes, n_videos).astype(np.int32)
        self._seed = seed

    def __len__(self):
        return self.n

    def _frames(self, rng, label, shape):
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        x[..., 0] = np.clip(
            x[..., 0] * 0.5 + (label % 6) * 40, 0, 255).astype(np.uint8)
        return x

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self._seed * 100003 + idx)
        label = int(self.labels[idx])
        out: Dict[str, np.ndarray] = {"label": np.int32(label)}
        if self.clip_num:
            shape = (self.clip_num, self.t, self.h, self.w, 3)
        else:
            shape = (self.t, self.h, self.w, 3)
        if "rgb" in self.fields:
            out["rgb"] = self._frames(rng, label, shape)
        for name in ("depth", "n_depth", "depth_est", "n_depth_est"):
            if name in self.fields:
                out[name] = rng.integers(
                    0, 256, (self.t, self.h, self.w, 1), dtype=np.uint8)
        return out
