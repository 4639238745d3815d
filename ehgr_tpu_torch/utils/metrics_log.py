"""Run metrics logging: JSONL per run + optional wandb (the port's own copy
of ``ehgr_tpu/utils/metrics_log.py``).

The reference instruments wandb everywhere but force-disables it via env
(``train_mtmm.py:30``); here wandb is attempted only when WANDB_MODE is not
'disabled' and the package imports — the JSONL file is always written and is
the source of truth (the analogue of the reference's ``runs/*/train.log``
metric lines).  A wandb that was asked for and does not start is logged as
a warning, not passed over in silence."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, run_dir: str, enable_wandb: Optional[bool] = None,
                 project: str = "ehgr_tpu", name: str = ""):
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self._wandb = None
        if enable_wandb is None:
            enable_wandb = os.environ.get("WANDB_MODE", "disabled") != "disabled"
        if enable_wandb:
            try:
                import wandb  # type: ignore

                self._wandb = wandb.init(project=project, name=name or None)
            except Exception as e:  # noqa: BLE001 — any wandb failure
                logging.getLogger(__name__).warning(
                    "WANDB_MODE=%s but wandb did not start (%r); metrics go "
                    "to %s only", os.environ.get("WANDB_MODE"), e, self.path)

    def log(self, metrics: Dict[str, float], step: Optional[int] = None):
        rec = {"ts": time.time(), **({"step": step} if step is not None
                                     else {}), **metrics}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
