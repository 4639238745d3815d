"""What ``correct``'s limits are set against, apart from the timed path:
each mode runs a cell as ``kinds/<kind>.py`` does, with one thing put in
the program's place or changed under it.  Needs the card at the cells'
sizes; used by ``calibrate.py`` and the control's test.

* ``program``: the cell as it runs;
* ``int8`` (serve): the program's own int8 path (``quantize="dynamic"``),
  the control of the serve cells;
* ``fp8`` (train): the float32 reference computed in float8
  (``reference.model.set_fp8``) in the program's place, the control of
  the train cells (the program has no lower-precision training path);
* ``half_batch`` (train): the reference in the program's place on the
  first half of each batch, a planted fault (a state left unchanged reads
  1 by the training numbers' measure and needs no run);
* ``fp32`` (train): the program in float32 with TF32 off, a witness of
  what it computes apart from rounding (its kernels take their float32
  routes);
* ``plain`` (train): the program in its own precision with the plain
  PyTorch versions of its ACTION and shift kernels in their place.
"""

from __future__ import annotations

import contextlib

from portbench import session
from portbench.harness import Cell
from portbench.weights import float32_exact

CONTROL = {"serve": "int8", "train": "fp8"}
MODES = {"serve": ("program", "int8"),
         "train": ("program", "fp8", "half_batch", "fp32", "plain")}


@contextlib.contextmanager
def _program_with(**kw):
    """``session.program_model`` builds the program's model with ``kw``."""
    make = session.program_model

    def changed(cell, arch, mode, **given):
        return make(cell, arch, mode, **{**given, **kw})

    session.program_model = changed
    try:
        yield
    finally:
        session.program_model = make


@contextlib.contextmanager
def _plain_kernels():
    """The ACTION region's and the TSM shift's kernels replaced by their
    plain PyTorch versions."""
    from ehgr_tpu_torch.ops import action_vjp
    from ehgr_tpu_torch.ops.kernels import action_mega, shift, tsm_shift

    swaps = [(action_vjp, "action_stats", action_mega.action_stats_plain),
             (action_vjp, "action_apply", action_mega.action_apply_plain),
             (action_vjp, "learnable_shift_fwd",
              shift.learnable_shift_fwd_plain),
             (action_vjp, "learnable_shift_bwd",
              shift.learnable_shift_bwd_plain),
             (tsm_shift, "tsm_shift", tsm_shift.tsm_shift_plain)]
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in kept:
            setattr(mod, name, fn)


def _stand_in(cell: Cell, half: bool) -> dict:
    """The reference in the program's place for the checked steps, in
    float8 or on the first half of each batch; no window."""
    kind = cell.kind()
    pool, weights, with_depth = kind.setup(cell)
    stats = session.statistics_of(weights)
    del weights
    rows = cell.traffic["clips"] // 2 if half else None
    prog = kind.reference_run(cell, pool, stats, with_depth, fp8=not half,
                              rows=rows)
    values, ref = kind.compare(cell, pool, stats, with_depth, prog)
    return {"values": values, "attempted": 0, "failed": 0,
            "readings": {"program": prog, "reference": ref}}


def run(cell: Cell, mode: str) -> dict:
    """The kind's result for ``cell`` in ``mode`` (``values``,
    ``attempted``, ``failed``, ``readings``)."""
    kind = cell.traffic["kind"]
    if mode not in MODES[kind]:
        raise ValueError(f"no mode {mode!r} for {kind} cells")
    if mode in ("fp8", "half_batch"):
        return _stand_in(cell, half=mode == "half_batch")
    with contextlib.ExitStack() as stack:
        if mode == "int8":
            stack.enter_context(_program_with(quantize="dynamic"))
        elif mode == "fp32":
            stack.enter_context(float32_exact())
            stack.enter_context(_program_with(dtype="float32"))
        elif mode == "plain":
            stack.enter_context(_plain_kernels())
        return cell.kind().run(cell)
