"""Temporal frame-index samplers as pure numpy functions (the port's own
copy of ``ehgr_tpu/ops/temporal_transforms.py``, same names and the same
draws from the same ``numpy.random.Generator``).

Each sampler is ``(num_frames, size[, rng]) -> int64 ndarray``:

* ``uniform_train`` -- TSN segment sampling: ``range(num_frames)`` split
  into ``size`` segments of ``num_frames // size`` frames and one uniform
  offset drawn per segment; all zeros for a video shorter than ``size``.
* ``uniform_val`` -- segment centres ``int(tick/2 + tick*i)`` with
  ``tick = num_frames / size``; all zeros when ``num_frames <= size``.
* ``uniform_test`` -- the same centres without the short-video guard.
* ``dense_train`` / ``dense_test`` -- I3D dense sampling at stride
  ``64 // size`` with wraparound.
* ``begin/end/center/random_crop`` -- contiguous crops, loop-padded.
* ``loop_padding`` -- cycle indices up to ``size`` entries.
* ``next_segment_indices`` -- the MTMM depth target's next segment.
* ``multi_clip_indices`` -- ``clip_num`` independent ``uniform_train``
  draws, the multi-clip test protocol.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "uniform_train", "uniform_val", "uniform_test",
    "dense_train", "dense_test",
    "begin_crop", "end_crop", "center_crop", "random_crop",
    "loop_padding", "next_segment_indices", "multi_clip_indices",
]


def _as_int(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int64)


def uniform_train(num_frames: int, size: int, rng: np.random.Generator) -> np.ndarray:
    """TSN per-segment random sampling (TemporalUniformCrop_train)."""
    average_duration = num_frames // size
    if average_duration > 0:
        base = np.arange(size, dtype=np.int64) * average_duration
        offsets = rng.integers(0, average_duration, size=size)
        return base + offsets
    return np.zeros((size,), dtype=np.int64)


def uniform_val(num_frames: int, size: int) -> np.ndarray:
    """Per-segment center sampling (TemporalUniformCrop_val)."""
    if num_frames > size:
        tick = num_frames / float(size)
        return _as_int([int(tick / 2.0 + tick * x) for x in range(size)])
    return np.zeros((size,), dtype=np.int64)


def uniform_test(num_frames: int, size: int) -> np.ndarray:
    """Per-segment center sampling without the short-video guard
    (TemporalUniformCrop_test)."""
    tick = num_frames / float(size)
    return _as_int([int(tick / 2.0 + tick * x) for x in range(size)])


def dense_train(num_frames: int, size: int, rng: np.random.Generator) -> np.ndarray:
    """I3D dense sampling, random window start (TemporalDense_train)."""
    t_stride = 64 // size
    sample_pos = max(1, 1 + num_frames - t_stride * size)
    start_idx = 0 if sample_pos == 1 else int(rng.integers(0, sample_pos - 1))
    return _as_int([(i * t_stride + start_idx) % num_frames for i in range(size)])


def dense_test(num_frames: int, size: int, clip_num: int) -> np.ndarray:
    """I3D dense sampling at linspaced window starts; returns
    ``[clip_num, size]`` (TemporalDense_test)."""
    t_stride = 64 // size
    sample_pos = max(1, 1 + num_frames - t_stride * size)
    start_list = np.linspace(0, sample_pos - 1, num=clip_num, dtype=int)
    out = [[(i * t_stride + s) % num_frames for i in range(size)]
           for s in start_list.tolist()]
    return _as_int(out).reshape(clip_num, size)


def loop_padding(indices: np.ndarray, size: int) -> np.ndarray:
    """Cycle ``indices`` until it has at least ``size`` entries (LoopPadding)."""
    out = list(np.asarray(indices, dtype=np.int64))
    for idx in out:
        if len(out) >= size:
            break
        out.append(idx)
    return _as_int(out[:max(size, len(out))]) if len(out) >= size else _as_int(out)


def begin_crop(num_frames: int, size: int) -> np.ndarray:
    return loop_padding(np.arange(min(num_frames, size)), size)


def end_crop(num_frames: int, size: int) -> np.ndarray:
    start = max(0, num_frames - size)
    return loop_padding(np.arange(start, num_frames), size)


def center_crop(num_frames: int, size: int) -> np.ndarray:
    center = num_frames // 2
    begin = max(0, center - size // 2)
    end = min(begin + size, num_frames)
    return loop_padding(np.arange(begin, end), size)


def random_crop(num_frames: int, size: int, rng: np.random.Generator) -> np.ndarray:
    rand_end = max(0, num_frames - size - 1)
    begin = int(rng.integers(0, rand_end + 1))
    end = min(begin + size, num_frames)
    return loop_padding(np.arange(begin, end), size)


def uniform_ego_train(num_frames: int, size: int,
                      rng: np.random.Generator) -> np.ndarray:
    """Ego variant (TemporalUniformCrop_ego_train, ref :202-214): short
    videos repeat ONE random frame instead of frame 0."""
    average_duration = num_frames // size
    if average_duration > 0:
        base = np.arange(size, dtype=np.int64) * average_duration
        return base + rng.integers(0, average_duration, size=size)
    return np.full((size,), rng.integers(0, num_frames), dtype=np.int64)


def uniform_ego_val(num_frames: int, size: int) -> np.ndarray:
    """Ego variant (ref :217-231): short videos repeat the middle frame."""
    if num_frames > size:
        tick = num_frames / float(size)
        return _as_int([int(tick / 2.0 + tick * x) for x in range(size)])
    return np.full((size,), num_frames // 2, dtype=np.int64)


def next_segment_indices(selected: np.ndarray, num_frames: int) -> np.ndarray:
    """Next-segment indices for MTMM depth supervision: drop the first index,
    append ``last+1`` clamped to the video length
    (``data/dataset_EgoGesture.py:190-192``)."""
    selected = np.asarray(selected, dtype=np.int64)
    last = int(selected[-1])
    nxt = last + 1 if last + 1 < num_frames else last
    return np.append(selected[1:], nxt)


def multi_clip_indices(num_frames: int, size: int, clip_num: int,
                       rng: np.random.Generator) -> np.ndarray:
    """The multi-clip test protocol: ``clip_num`` independent uniform_train
    samples per video (``test.py:235-244`` + ``dataset_video_inference``).
    Returns ``[clip_num, size]``."""
    return np.stack([uniform_train(num_frames, size, rng)
                     for _ in range(clip_num)], axis=0)
