"""Online (streaming) gesture recognition over a frame stream (counterpart
of ``ehgr_tpu/eval/streaming.py``).

* Frames accumulate on the host in a uint8 ring of the last ``window``
  frames (nothing goes to the device until a window fires).
* Every ``stride`` frames, the last ``window`` frames are TSN
  segment-sampled (``ops/temporal_transforms.uniform_val``, the sampling
  eval uses) into one ``[1, T, H, W, C]`` clip, scored by one scorer call.
* Per-window probabilities are EMA-smoothed, and a confidence threshold
  with a minimum of consecutive windows turns them into ``start`` /
  ``end`` events (the hysteresis that keeps gesture boundaries from
  flickering).

Any ``[1, T, H, W, C] -> [1, classes]`` scorer serves, a cascade's too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from ehgr_tpu_torch.device import DeviceLike
from ehgr_tpu_torch.ops import temporal_transforms as tt


@dataclass
class StreamEvent:
    kind: str                  # 'start' | 'end'
    label: int
    frame_index: int           # stream position at emission
    confidence: float


class StreamingRecognizer:
    """Sliding-window online recognizer over a frame stream.

    ``score_fn``: ``uint8 [1, T, H, W, C] -> [1, num_classes]``
    probabilities (numpy)."""

    def __init__(self, score_fn: Callable, num_segments: int = 8,
                 window: int = 32, stride: int = 8, smooth: float = 0.6,
                 threshold: float = 0.6, min_windows: int = 2,
                 background_class: Optional[int] = None):
        if window < num_segments or stride < 1:
            raise ValueError(f"window {window} < T {num_segments} or "
                             f"stride {stride} < 1")
        self.score_fn = score_fn
        self.t = num_segments
        self.window = window
        self.stride = stride
        self.smooth = smooth
        self.threshold = threshold
        self.min_windows = min_windows
        self.background_class = background_class
        self._buf: List[np.ndarray] = []
        self._frames_seen = 0
        self._since_fire = 0
        self._probs: Optional[np.ndarray] = None
        self._streak_label = -1
        self._streak = 0
        self._active: Optional[int] = None

    def _window_clip(self) -> np.ndarray:
        frames = self._buf[-self.window:]
        idx = tt.uniform_val(len(frames), self.t)
        return np.stack([frames[i] for i in idx])[None]      # [1,T,H,W,C]

    def _debounce(self, probs: np.ndarray) -> List[StreamEvent]:
        label = int(probs.argmax())
        conf = float(probs[label])
        fired = conf >= self.threshold and label != self.background_class
        events: List[StreamEvent] = []
        if fired and label == self._streak_label:
            self._streak += 1
        elif fired:
            self._streak_label, self._streak = label, 1
        else:
            self._streak_label, self._streak = -1, 0
        if self._active is not None and (not fired or
                                         label != self._active):
            events.append(StreamEvent("end", self._active,
                                      self._frames_seen, conf))
            self._active = None
        if self._active is None and self._streak >= self.min_windows:
            self._active = label
            events.append(StreamEvent("start", label,
                                      self._frames_seen, conf))
        return events

    def push(self, frame: np.ndarray) -> List[StreamEvent]:
        """Feed one ``uint8 [H, W, C]`` frame; returns any events fired."""
        self._buf.append(np.asarray(frame, np.uint8))
        if len(self._buf) > self.window:
            del self._buf[: len(self._buf) - self.window]
        self._frames_seen += 1
        self._since_fire += 1
        if self._frames_seen < self.t or self._since_fire < self.stride:
            return []
        self._since_fire = 0
        probs = np.asarray(self.score_fn(self._window_clip()))[0]
        self._probs = probs if self._probs is None else \
            self.smooth * self._probs + (1.0 - self.smooth) * probs
        return self._debounce(self._probs)

    def flush(self) -> List[StreamEvent]:
        """End of stream: close any active gesture."""
        if self._active is None:
            return []
        ev = StreamEvent("end", self._active, self._frames_seen,
                         float(self._probs[self._active]))
        self._active = None
        return [ev]

    @property
    def state(self) -> Dict:
        return {"frames_seen": self._frames_seen, "active": self._active,
                "streak": self._streak}


def make_stream_score_fn(model, *, device: DeviceLike = None,
                         crop_size: int = 224,
                         dtype_name: str = "bfloat16") -> Callable:
    """``uint8 [1, T, H, W, C] -> [1, C]`` f32 numpy probabilities of one
    clip on ``device`` (default CUDA; the model must live there), frames
    resized on the device if they are not at ``crop_size``."""
    from ehgr_tpu_torch.eval.inference import make_score_fn

    score = make_score_fn(model, device=device, scale_size=crop_size,
                          crop_size=crop_size, square_resize=True,
                          dtype_name=dtype_name)

    def fn(clip_u8: np.ndarray) -> np.ndarray:
        return score(clip_u8[:, None]).float().cpu().numpy()

    return fn
