"""Host-side meters (the port's own copy of ``AverageMeter`` and
``StepTimer`` from ``ehgr_tpu/utils/meters.py``; the reference's
``utils.py:54-71``)."""

from __future__ import annotations

import time


class AverageMeter:
    """Running value/avg meter with the reference's ``.val``/``.avg``
    semantics (``utils.py:54-71``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class StepTimer:
    """data_time / batch_time measurement matching the reference hot-loop
    instrumentation (``train_mtmm.py:194-261``)."""

    def __init__(self):
        self.data_time = AverageMeter()
        self.batch_time = AverageMeter()
        self._end = time.time()

    def data_ready(self):
        self.data_time.update(time.time() - self._end)

    def step_done(self):
        self.batch_time.update(time.time() - self._end)
        self._end = time.time()
