"""Train traffic: the recipe's ``make_train_step`` at a fixed batch of
clips, back to back.

Set-up builds one step (the program's model, optimizer state, EMA and
dropout generator) from the seed and drives it through its first
``checked_steps`` steps on distinct pool batches; they compile and warm up,
and they are what ``correct`` compares (``correct.py``): the first step's
loss, the first gradient as the optimizer holds it, and each parameter's
change over the three.  The window then runs the same step on, cycling the pool, until
``--seconds`` have passed, and ends with the last step's loss on the host;
a traced run profiles ``trace_steps`` more.  Afterwards the float32
reference follows the first three steps from the same weights, batches and
dropout masks.
"""

from __future__ import annotations

import torch

from portbench import correct, session, trace
from portbench.harness import Cell, sub_seed
from portbench.reference.model import TSN, depth_target, set_fp8
from portbench.reference.train import Sgd, decay_mults, train_steps
from portbench.traffic import make_pool
from portbench.weights import float32_exact


def _step(cell: Cell, weights):
    """The program's ``(step, state)``."""
    from ehgr_tpu_torch.configs import LossConfig, OptimConfig
    from ehgr_tpu_torch.train.optim import build_optimizer
    from ehgr_tpu_torch.train.steps import create_train_state, make_train_step

    m, tr, o = cell.model, cell.traffic, cell.config["optim"]
    model = session.program_model(cell, tr["arch"], "train")
    model.load_state_dict(weights, strict=True)
    opt, _ = build_optimizer(
        model, OptimConfig(lr=o["lr"], momentum=o["momentum"],
                           weight_decay=o["weight_decay"],
                           lr_steps=tuple(o["lr_steps"]), gamma=o["gamma"],
                           ema_decay=o["ema_decay"]),
        fc_lr5=o["fc_lr5"], partial_bn=m["partial_bn"],
        steps_per_epoch=tr["steps_per_epoch"])
    state = create_train_state(model, opt)
    loss = cell.config["loss"]
    step = make_train_step(
        model, opt, stage=tr["stage"],
        loss_cfg=LossConfig(depth_weight=loss["depth_weight"],
                            depth_size=loss["depth_size"]),
        ema_decay=o["ema_decay"], mean=m["mean"], std=m["std"])
    return step, state


def setup(cell: Cell):
    """The pool, the seeded weights with their BN statistics, and whether
    the cell trains the depth decoder."""
    dev, m, tr = cell.device, cell.model, cell.traffic
    with_depth = tr["arch"] == "tsn_mtmm"
    pool = make_pool(tr, m, sub_seed(cell.seed, session.TRAFFIC), dev)
    weights = session.weights_and_stats(cell, with_depth, pool[0]["rgb"])
    return pool, weights, with_depth


def run(cell: Cell) -> dict:
    dev, m, tr = cell.device, cell.model, cell.traffic
    pool, weights, with_depth = setup(cell)
    stats = session.statistics_of(weights)
    n_check = tr["checked_steps"]
    step, state = _step(cell, weights)
    del weights
    session.free(dev)
    session.reset_peak(dev)
    gen = torch.Generator(device=dev).manual_seed(
        sub_seed(cell.seed, session.DROPOUT))

    # set-up: the first steps, read as correct() compares them
    wd = cell.config["optim"]["weight_decay"]
    dm = decay_mults(TSN(m, with_depth, device="meta"), m["partial_bn"])
    p0 = {k: p.detach().clone() for k, p in state.params.items()}
    losses = []
    for k in range(n_check):
        _, metrics = step(state, pool[k], gen)
        losses.append(float(metrics["loss"]))
        if k == 0:
            grad1 = correct.leaf_norms(
                {key: state.opt_state.momentum[key] - wd * dm[key] * p0[key]
                 for key in p0})
    update = correct.leaf_norms({k: p.detach() - p0[k]
                                 for k, p in state.params.items()})
    del p0
    session.sync(dev)
    setup_s = session.wall() - cell.started

    window = []
    t0 = session.now()
    end = t0
    while end - t0 < cell.seconds:
        _, metrics = step(state, pool[(n_check + len(window)) % len(pool)],
                          gen)
        window.append(metrics["loss"])
        end = session.now()
    float(window[-1])                       # the last loss on the host
    window_s = session.now() - t0
    steps = len(window)

    stretch = None
    if cell.trace:
        def traced(k):
            batch = pool[(n_check + steps + k) % len(pool)]
            with torch.profiler.record_function("portbench.step"):
                _, metrics = step(state, batch, gen)
            with torch.profiler.record_function("portbench.readback"):
                window.append(float(metrics["loss"]))
        stretch = trace.profile_stretch(traced, tr["trace_steps"],
                                        lambda: session.sync(dev))
    peak = session.peak_bytes(dev)
    read = torch.tensor(losses + [float(v) for v in window])
    failed = int((~torch.isfinite(read)).sum())
    del step, state
    session.free(dev)

    prog = {"losses": losses, "grad1": grad1, "update": update}
    values, ref = compare(cell, pool, stats, with_depth, prog)
    return {
        "record": {"kind": "train", "setup_s": setup_s, "window_s": window_s,
                   "calls": steps, "clips": steps * tr["clips"],
                   "clips_per_call": tr["clips"], "trace": stretch},
        "values": values, "attempted": len(read),
        "failed": failed, "memory_peak_bytes": peak,
        "readings": {"program": prog, "reference": ref},
    }


def _batches(cell: Cell, pool, gen, with_depth, rows=None):
    """The reference's view of the first steps' batches: normalised clips,
    labels, depth targets and the dropout masks the program drew."""
    m, dev = cell.model, cell.device
    keep = 1.0 - m["dropout"]
    out = []
    for k in range(cell.traffic["checked_steps"]):
        b = pool[k]
        n = b["label"].shape[0]
        mask = torch.empty((n * m["num_segments"], m["feature_width"]),
                           device=dev).bernoulli_(keep, generator=gen)
        r = slice(None, rows)
        x = session.frames_in(cell, b["rgb"][r], dev)
        labels = torch.as_tensor(b["label"][r]).to(dev)
        depth = depth_target(torch.as_tensor(b["depth"][r]).to(dev),
                             cell.config["loss"]["depth_size"]) \
            if with_depth else None
        if rows is not None:
            mask = mask[:rows * m["num_segments"]]
        out.append((x, labels, depth, mask))
    return out


def reference_run(cell: Cell, pool, stats, with_depth, fp8=False,
                  rows=None) -> dict:
    """The reference's first steps: losses, first-gradient and update
    norms by leaf."""
    dev, m = cell.device, cell.model
    weights = session.reference_state(cell, with_depth, stats)
    ref = TSN(m, with_depth, device=dev)
    ref.load_state_dict(weights, strict=True)
    set_fp8(ref, fp8)
    p0 = {k: weights[k] for k, _ in ref.named_parameters()}
    sgd = Sgd(ref, cell.config["optim"], m["partial_bn"])
    gen = torch.Generator(device=dev).manual_seed(
        sub_seed(cell.seed, session.DROPOUT))
    with float32_exact():
        steps = train_steps(ref, _batches(cell, pool, gen, with_depth, rows),
                            sgd, depth_weight=cell.config["loss"]
                            ["depth_weight"] if with_depth else 0.0)
    out = {"losses": [s[0] for s in steps],
           "grad1": correct.leaf_norms(steps[0][1]),
           "update": correct.leaf_norms({k: p.detach() - p0[k] for k, p in
                                         ref.named_parameters()})}
    del ref, sgd, steps, weights, p0
    session.free(dev)
    return out


def compare(cell: Cell, pool, stats, with_depth, prog: dict):
    """The numbers read (``correct.train_numbers``), and the reference's
    readings."""
    ref = reference_run(cell, pool, stats, with_depth)
    return correct.train_numbers(prog, ref), ref
