#!/usr/bin/env python3
"""Drive the PyTorch port (``ehgr_tpu_torch``) on one CUDA GPU and check it.

Phases; any miss raises and the run exits nonzero:

1. build the CUDA kernels from the sources in this checkout, one ``nvcc``
   per source, all started together;
2. hold ``action_stats`` / ``action_apply`` against their plain versions at
   the eight ResNet-50 ACTION site shapes of the main path plus two ragged
   shapes, in fp32 (TF32 off) and in bf16 (plain version in f32 from the
   same bf16 inputs); and measure how far the TPU kernel's bf16 running sum
   of ``pool`` would land from the f32 sum kept here;
3. hold ``learnable_shift_fwd`` / ``learnable_shift_bwd`` (y, dx, dw)
   against autograd of the plain shift at the site shapes at 8 clips and
   the two ragged shapes, fp32 and bf16;
4. serve: ``evaluate`` over ``make_score_fn`` on the full-width TSN + ACTION
   ResNet-50 (T=8, 224^2, 83 classes, bf16, ``action_fused='mega'``,
   weights drawn from a seeded ``torch.Generator``) for a few request
   batches of uint8 videos, with the kernels' launch counters zeroed just
   before and read just after; then the logits against the plain path
   (``action_fused=None``) in fp32 and in bf16;
5. trace one scorer call with ``torch.profiler`` (device time by kernel,
   idle share);
6. train: ``make_train_step(stage='mtmm')`` on the full-width ``tsn_mtmm``
   (``action_fused='vjp'``: the four kernels forward and backward; bf16
   compute, f32 params, 8 clips of uint8 rgb and depth, dropout 0.5 from a
   seeded generator) for a few steps, with the launch counters zeroed just
   before and read after each step; one train step traced with
   ``torch.profiler``; each ACTION site in training, kernel region against
   plain autograd, fp32; and one fp32 step's loss and gradients of the
   ``'vjp'`` model and the plain model against a float64 run;
7. time each kernel, its plain version and a yardstick (the bare GEMM of
   the same ``[rows, C] x [C, F]`` product for the ACTION kernels, the
   grouped ``conv3d`` and its backward for the shift) at each site shape
   with CUDA events.

Prints the kernel table as one JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  It needs one card;
without CUDA it exits nonzero before doing anything.

    python3 chip_smoke.py [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

T, CROP, CLASSES = 8, 224, 83
BATCHES, VIDEOS, CLIPS = 3, 2, 10       # requests of V videos x K clips
# (S, C, F, sites per forward) of the 16 ACTION sites of ResNet-50 at 224^2:
# each layer{i}_0 site runs at the previous stage's resolution
SITES = [(3136, 64, 64, 1), (3136, 256, 64, 2), (3136, 256, 128, 1),
         (784, 512, 128, 3), (784, 512, 256, 1), (196, 1024, 256, 5),
         (196, 1024, 512, 1), (49, 2048, 512, 2)]
# S off every tile size with Cr=8 and F under one tile; and C off the
# 8-channel rows the tensor-core sweep needs (bf16 then takes the FMA sweep)
RAGGED = [(1000, 128, 32), (50, 100, 24)]
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 / fp32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# kernel vs plain, max |err| over max |plain|: fp32 differs only in
# summation order; bf16 also in two roundings to bf16 (2^-9 relative
# each): of the gated tile fed to the tensor cores, and of the output
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# shift kernels vs autograd of the plain shift, same measure.  fp32: y and
# dx differ only in the order of three products; dw in summation order over
# up to N*T*S = 200,704 rows (f32 per thread, a fixed-order sum of the block
# partials).  bf16: each output is rounded once to bf16 (2^-8 relative),
# dw too, since it leaves in w's dtype; its f32 sums add no more than the
# fp32 limit
SHIFT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# training batch: the recipe's 8 clips (sh/train_ego.sh), T=8, 224^2, depth
# targets at 56^2; steps timed and counted
TRAIN_CLIPS, TRAIN_STEPS, DEPTH_SIZE = 8, 5, 56
# one ACTION site in training, 'vjp' (the kernel region) vs plain
# autograd, fp32: output and every gradient, max |diff| / max |plain|; the
# same math in another order (kernel sums, the region's matmul transposes)
SITE_TOL = 1e-4
# the full fp32 train step against a float64 run of the plain model: each
# parameter's gradient error (same measure); the kernel model within GRAD_X
# times the plain fp32 model's own error plus GRAD_TOL (see train_parity);
# the two fp32 losses within LOSS_TOL
GRAD_X, GRAD_TOL, LOSS_TOL = 1.5, 1e-3, 1e-5
# logits of the 'mega' model vs the plain model, same measure (fp32), and
# how much further from fp32 the bf16 'mega' logits may be than the bf16
# plain ones (see compare_logits)
LOGIT_TOL = 1e-3
BF16_SLACK = 1.5


def _inputs(torch, n, s, c, f, dtype, gen):
    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") *
                scale).to(dtype)

    def rand(*shape, lo=0.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen,
                                            device="cuda")).to(dtype)
    return dict(x4=randn(n, T, s, c), w=randn(3, c),
                wp3=randn(c, c // 16, scale=c ** -0.5),
                g1=rand(n, T, s, 1), gch=rand(n, T, c, lo=3.0, hi=5.0),
                wn=randn(c, f, scale=c ** -0.5))


def _rel_err(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def _tpu_s_tile(s, c, out_cols, itemsize=2, budget=12 << 20):
    """The S tile the TPU kernel uses (ehgr_tpu/ops/pallas/action_mega.py
    ``_s_tile``), copied so the port imports nothing of that package."""
    lane = 128
    pad_out = (max(out_cols, 1) + lane - 1) // lane * lane
    per_row = T * (itemsize * (2 * c + 4 * lane + 2 * pad_out)
                   + 4 * (pad_out + lane))
    if s * per_row <= budget or s < 8:
        return s
    cap = max(8, budget // per_row // 8 * 8)
    for d in range(cap, 7, -8):
        if s % d == 0:
            return d
    return min(cap, max(8, s // 8 * 8))


def pool_accumulation_delta(torch, d):
    """How far a bf16 running sum of ``pool`` (the TPU kernel's: each S
    tile's sum rounded to bf16 and added into a bf16 accumulator) lands from
    the f32 sum this port's kernel keeps, on the same bf16 x_shift; as max
    |delta| / max |pool|."""
    from ehgr_tpu_torch.ops.temporal_shift import learnable_shift

    bf16 = torch.bfloat16
    xs = learnable_shift(d["x4"].float(), d["w"].float()).to(bf16)
    s, c = xs.shape[2], xs.shape[3]
    st = _tpu_s_tile(s, c, c // 16 + 1)
    acc = torch.zeros_like(xs[:, :, 0])
    for s0 in range(0, s, st):
        part = xs[:, :, s0:s0 + st].float().sum(2).to(bf16)
        acc = (acc.float() + part.float()).to(bf16)
    want = xs.float().mean(2)
    return dict(S=s, C=c, tpu_s_tile=st,
                bf16_acc_rel=_rel_err((acc / s).float(), want)[1],
                f32_acc_rel=_rel_err(want.to(bf16), want)[1])


def check_kernels(torch, mega, n, gen):
    """Each kernel against its plain version at every site shape, fp32 and
    bf16; returns per-(shape, dtype) errors and raises on a miss."""
    results, pool_acc = [], []
    shapes = [s[:3] for s in SITES] + RAGGED
    for s, c, f in shapes:
        for dname in ("float32", "bfloat16"):
            d = _inputs(torch, n, s, c, f, getattr(torch, dname), gen)
            ref = {k: v.float() for k, v in d.items()}   # same values, f32
            got = dict(zip(("mc", "pool", "x3"),
                           mega.action_stats(d["x4"], d["w"], d["wp3"])))
            want = dict(zip(("mc", "pool", "x3"), mega.action_stats_plain(
                ref["x4"], ref["w"], ref["wp3"])))
            got["out"] = mega.action_apply(d["x4"], d["w"], d["g1"],
                                           d["gch"], d["wn"])
            want["out"] = mega.action_apply_plain(
                ref["x4"], ref["w"], ref["g1"], ref["gch"], ref["wn"])
            torch.cuda.synchronize()
            for name in got:
                err, rel = _rel_err(got[name], want[name])
                kernel = "action_apply" if name == "out" else "action_stats"
                ok = rel <= TOL[dname] and math.isfinite(err)
                results.append(dict(kernel=kernel, output=name, S=s, C=c,
                                    F=f, dtype=dname, max_abs_err=err,
                                    max_rel_err=rel, tol=TOL[dname], ok=ok))
                print(f"check {kernel:12s} {name:4s} S={s:4d} C={c:4d} "
                      f"F={f:3d} {dname:8s} max_abs_err={err:.3e} "
                      f"rel={rel:.3e} tol={TOL[dname]:.0e} "
                      f"{'ok' if ok else 'MISS'}", flush=True)
                if not ok:
                    raise AssertionError(
                        f"{kernel}.{name} disagrees with its plain version "
                        f"at S={s} C={c} F={f} {dname}: rel {rel:.3e} > "
                        f"{TOL[dname]}")
            if dname == "bfloat16" and (s, c, f) not in RAGGED:
                pool_acc.append(pool_accumulation_delta(torch, d))
            del d, ref, got, want
    print("pool_accumulation " + json.dumps(pool_acc), flush=True)
    return results, pool_acc


def _shift_shapes():
    """Distinct (S, C) of the 16 ACTION sites (the shift does not see F),
    with their site counts."""
    shapes = {}
    for s, c, _, count in SITES:
        shapes[(s, c)] = shapes.get((s, c), 0) + count
    return [(s, c, k) for (s, c), k in shapes.items()]


def _shift_inputs(torch, n, s, c, dtype, gen):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return randn(n, T, s, c), randn(3, c), randn(n, T, s, c)


def check_shift(torch, shk, gen):
    """``learnable_shift_fwd`` / ``_bwd`` against autograd of the plain
    shift (in f32 from the same values) at the site shapes at TRAIN_CLIPS
    clips and the ragged shapes, fp32 and bf16; raises on a miss."""
    results = []
    shapes = [(s, c) for s, c, _ in _shift_shapes()] + \
        [(s, c) for s, c, _ in RAGGED]
    for s, c in shapes:
        for dname in ("float32", "bfloat16"):
            x, w, g = _shift_inputs(torch, TRAIN_CLIPS, s, c,
                                    getattr(torch, dname), gen)
            got = dict(y=shk.learnable_shift_fwd(x, w))
            got["dx"], got["dw"] = shk.learnable_shift_bwd(x, g, w)
            want = dict(y=shk.learnable_shift_fwd_plain(x.float(), w.float()))
            want["dx"], want["dw"] = shk.learnable_shift_bwd_plain(
                x.float(), g.float(), w.float())
            torch.cuda.synchronize()
            for name in got:
                err, rel = _rel_err(got[name], want[name])
                kernel = "learnable_shift_fwd" if name == "y" \
                    else "learnable_shift_bwd"
                ok = rel <= SHIFT_TOL[dname] and math.isfinite(err)
                results.append(dict(kernel=kernel, output=name, S=s, C=c,
                                    dtype=dname, max_abs_err=err,
                                    max_rel_err=rel, tol=SHIFT_TOL[dname],
                                    ok=ok))
                print(f"check {kernel:19s} {name:2s} S={s:4d} C={c:4d} "
                      f"{dname:8s} max_abs_err={err:.3e} rel={rel:.3e} "
                      f"tol={SHIFT_TOL[dname]:.0e} {'ok' if ok else 'MISS'}",
                      flush=True)
                if not ok:
                    raise AssertionError(
                        f"{kernel}.{name} disagrees with its plain version "
                        f"at S={s} C={c} {dname}: rel {rel:.3e} > "
                        f"{SHIFT_TOL[dname]}")
            del x, w, g, got, want
    return results


def make_batches(seed):
    """Request batches of uint8 videos and labels from ``--seed``."""
    rng = np.random.default_rng(seed)
    shape = (VIDEOS, CLIPS, T, CROP, CROP, 3)
    return [(rng.integers(0, 256, shape, dtype=np.uint8),
             rng.integers(0, CLASSES, (VIDEOS,)))
            for _ in range(BATCHES)]


def _clips(torch, frames):
    from ehgr_tpu_torch.ops.preprocess_device import normalize_clip

    x = normalize_clip(torch.as_tensor(frames).cuda())
    return x.reshape((-1, T) + x.shape[3:])


def set_bn_stats(torch, model, clips):
    """Set each BN's running statistics from its input on one eval
    forward of ``model`` over ``clips`` ``[N, T, H, W, 3]``."""
    from ehgr_tpu_torch.models.norm import BatchNorm

    def set_stats(bn, inputs):
        x = inputs[0].float()
        bn.running_mean.copy_(x.mean((0, 2, 3)))
        bn.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats)
             for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model.eval()(clips)
    for h in hooks:
        h.remove()


def build_models(torch, seed, frames):
    """The served model ('mega') and its plain twin from the same seed.

    With BN's init statistics (mean 0, var 1) a random ResNet-50 + ACTION
    at 224^2 grows its activations to ~1e5 (logits ~7e3), where the
    comparison with the plain path measures amplified rounding, not the
    kernels.  So, as one would for any random-weight smoke model, each BN's
    running statistics are set once from its input on the first batch
    (plain path, fp32); both models then hold the same weights."""
    from ehgr_tpu_torch.models.tsn import variant

    models = [variant("tsn", num_class=CLASSES, num_segments=T,
                      temporal="action", action_fused=mode,
                      dtype=torch.float32, device="cuda",
                      generator=torch.Generator().manual_seed(seed))
              for mode in ("mega", None)]
    mega_model, plain = models
    set_bn_stats(torch, plain, _clips(torch, frames))
    mega_model.load_state_dict(plain.state_dict())
    for m in models:
        m.dtype = torch.bfloat16
    return mega_model, plain


def _counters():
    """The launch counter of each kernel wrapper, by kernel name."""
    from ehgr_tpu_torch.ops.kernels import action_mega as mega
    from ehgr_tpu_torch.ops.kernels import shift as shk

    return {"learnable_shift_fwd": shk.learnable_shift_fwd,
            "learnable_shift_bwd": shk.learnable_shift_bwd,
            "action_stats": mega.action_stats,
            "action_apply": mega.action_apply}


def serve(torch, model, batches):
    """The main path: the multi-clip scorer over request batches, with the
    kernels' launch counters zeroed just before and read just after."""
    from ehgr_tpu_torch.eval.inference import evaluate, make_score_fn

    score = make_score_fn(model, device="cuda", crop_size=CROP,
                          dtype_name="bfloat16")
    score(batches[0][0])                       # warm-up: cuDNN plans
    torch.cuda.synchronize()

    probs = []

    def recorded(frames):
        p = score(frames)
        probs.append(p)
        return p

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = evaluate(recorded, batches, CLASSES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}

    want = {k: 16 * BATCHES if k.startswith("action") else 0
            for k in counters}
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want} (16 sites "
                             f"x {BATCHES} forwards, no shift kernel)")
    for p in probs:
        if p.shape != (VIDEOS, CLASSES) or \
                not torch.isfinite(p).all() or \
                (p.sum(-1) - 1).abs().max().item() > 1e-3:
            raise AssertionError(f"bad video probabilities {p}")
    if res["n_videos"] != VIDEOS * BATCHES:
        raise AssertionError(f"evaluate saw {res['n_videos']} videos")
    clips = BATCHES * VIDEOS * CLIPS
    out = dict(batches=BATCHES, videos=VIDEOS, clips=CLIPS,
               launches=launches, top1=res["top1"], top5=res["top5"],
               seconds=wall, clips_per_s=clips / wall)
    print("serve " + json.dumps(out), flush=True)
    return out


def compare_logits(torch, mega_model, plain, frames):
    """'mega' logits against the plain path from the same weights.

    fp32 (TF32 off): the two must agree within LOGIT_TOL; the floor beside
    it is the plain path against itself with the batch split in two (other
    GEMM/conv algorithms, same math).  bf16: both paths round at other
    places, so each is measured against the fp32 plain logits and the
    'mega' path must come within BF16_SLACK times the plain path's own bf16
    error (plus LOGIT_TOL)."""
    x = _clips(torch, frames)
    half = x.shape[0] // 2
    logits = {}
    with torch.inference_mode():
        for dname in ("float32", "bfloat16"):
            for m in (mega_model, plain):
                m.dtype = getattr(torch, dname)
            logits[dname] = (mega_model(x), plain(x))
        for m in (mega_model, plain):
            m.dtype = torch.float32
        split = torch.cat([plain(x[:half]), plain(x[half:])])
        for m in (mega_model, plain):
            m.dtype = torch.bfloat16
    ref = logits["float32"][1]
    err, rel = _rel_err(logits["float32"][0], ref)
    out = dict(max_abs_logit=ref.abs().max().item(),
               fp32=dict(max_abs_err=err, max_rel_err=rel,
                         floor_rel=_rel_err(split, ref)[1], tol=LOGIT_TOL))
    mega_rel = _rel_err(logits["bfloat16"][0], ref)[1]
    plain_rel = _rel_err(logits["bfloat16"][1], ref)[1]
    err_b, rel_b = _rel_err(*logits["bfloat16"])
    out["bf16"] = dict(max_abs_err=err_b, max_rel_err=rel_b,
                       mega_vs_fp32_rel=mega_rel, plain_vs_fp32_rel=plain_rel,
                       tol=BF16_SLACK * plain_rel + LOGIT_TOL)
    print("logits " + json.dumps(out), flush=True)
    if not rel <= LOGIT_TOL:
        raise AssertionError(f"fp32 logits: mega vs plain rel {rel:.3e} > "
                             f"{LOGIT_TOL}")
    if not mega_rel <= out["bf16"]["tol"]:
        raise AssertionError(f"bf16 logits: mega {mega_rel:.3e} from fp32, "
                             f"plain {plain_rel:.3e}")
    return out


def profile_forward(torch, model, frames):
    """Device time by kernel name over one scorer call (torch.profiler),
    beside the call's wall time."""
    from ehgr_tpu_torch.eval.inference import make_score_fn

    score = make_score_fn(model, device="cuda", crop_size=CROP,
                          dtype_name="bfloat16")
    out = _device_profile(torch, lambda: score(frames))
    print("profile " + json.dumps(out), flush=True)
    return out


def make_train_batches(seed, count):
    """Training batches of uint8 rgb, the next segment's uint8 depth and
    labels from ``seed``."""
    rng = np.random.default_rng(seed + 1)
    shape = (TRAIN_CLIPS, T, CROP, CROP)
    return [{"rgb": rng.integers(0, 256, shape + (3,), dtype=np.uint8),
             "depth": rng.integers(0, 256, shape + (1,), dtype=np.uint8),
             "label": rng.integers(0, CLASSES, (TRAIN_CLIPS,))}
            for _ in range(count)]


def _train_model(torch, seed, mode, dtype, dropout):
    from ehgr_tpu_torch.models.tsn import variant

    return variant("tsn_mtmm", num_class=CLASSES, num_segments=T,
                   temporal="action", action_fused=mode, partial_bn=False,
                   dropout=dropout, dtype=dtype, device="cuda",
                   generator=torch.Generator().manual_seed(seed))


def train(torch, seed):
    """The training path: ``make_train_step(stage='mtmm')`` on the
    full-width ``tsn_mtmm`` in bf16 with the recipe's optimizer settings.
    One warm-up step, then TRAIN_STEPS steps with the launch counters zeroed
    just before and read after each step (16 sites: 16 launches of each
    kernel a step).  Returns the result and the warm (model, step, state,
    batch, generator) for the profile."""
    from ehgr_tpu_torch.configs import LossConfig, OptimConfig
    from ehgr_tpu_torch.ops.preprocess_device import (IMAGENET_MEAN,
                                                      IMAGENET_STD)
    from ehgr_tpu_torch.train.optim import build_optimizer
    from ehgr_tpu_torch.train.steps import (create_train_state,
                                            make_train_step)

    model = _train_model(torch, seed, "vjp", torch.bfloat16, 0.5)
    opt, _ = build_optimizer(model, OptimConfig(lr=0.00125,
                                                weight_decay=1e-5),
                             partial_bn=False)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, stage="mtmm",
                           loss_cfg=LossConfig(depth_size=DEPTH_SIZE),
                           ema_decay=0.9999, mean=IMAGENET_MEAN,
                           std=IMAGENET_STD)
    batches = make_train_batches(seed, TRAIN_STEPS + 1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    e0 = {k: v.clone() for k, v in state.ema_params.items()}
    step(state, batches[0], gen)                 # warm-up: cuDNN plans
    torch.cuda.synchronize()

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    per_step, ms, metrics = [], [], []
    for b in batches[1:]:
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        _, m = step(state, b, gen)
        m = {k: float(v) for k, v in m.items()}     # synchronises
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: fn.launches - before[k]
                         for k, fn in counters.items()})
        metrics.append(m)
    launches = {k: fn.launches for k, fn in counters.items()}

    for i, (c, m) in enumerate(zip(per_step, metrics)):
        if c != {k: 16 for k in counters}:
            raise AssertionError(f"train step {i}: launches {c}, want 16 of "
                                 "each (16 ACTION sites)")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"train step {i}: metrics {m}")
    moved = sum(not torch.equal(p0[k], v) for k, v in state.params.items())
    ema_moved = sum(not torch.equal(e0[k], v)
                    for k, v in state.ema_params.items())
    if moved < len(p0) // 2 or ema_moved < len(p0) // 2:
        raise AssertionError(f"params moved {moved}, EMA {ema_moved} of "
                             f"{len(p0)}")
    mean_ms = sum(ms) / len(ms)
    out = dict(steps=TRAIN_STEPS, clips=TRAIN_CLIPS, launches=launches,
               launches_per_step=per_step[0], ms_per_step=ms,
               mean_ms_per_step=mean_ms, clips_per_s=TRAIN_CLIPS / mean_ms *
               1e3, losses=[m["loss"] for m in metrics], metrics=metrics,
               params_moved=moved, ema_moved=ema_moved, n_params=len(p0))
    print("train " + json.dumps(out), flush=True)
    return out, (step, state, batches[1], gen)


def _frozen_bn_state(torch, seed, batch):
    """Weights of the parity models with every BN's running statistics set
    from its input on ``batch`` (plain path, as for the scorer)."""
    from ehgr_tpu_torch.ops.preprocess_device import (IMAGENET_MEAN,
                                                      IMAGENET_STD,
                                                      normalize_clip)

    model = _train_model(torch, seed, None, torch.float32, 0.0)
    set_bn_stats(torch, model,
                 normalize_clip(batch["rgb"], IMAGENET_MEAN, IMAGENET_STD))
    return model.state_dict()


def check_sites(torch, gen):
    """One ACTION site in training at each site shape, TRAIN_CLIPS clips,
    fp32: ``ActionConv('vjp')`` (the kernel region) against the plain
    autograd formulation from the same weights, input and cotangent; the
    output, the input's gradient and every parameter's gradient, ME BN on
    batch statistics.  Raises on a miss."""
    from ehgr_tpu_torch.ops.action import ActionConv

    out = []
    for s, c, f, _ in SITES:
        h = int(round(math.sqrt(s)))
        mods = {mode: ActionConv(c, f, T, fused=mode, bn_frozen=False,
                                 device="cuda").train()
                for mode in ("vjp", None)}
        with torch.no_grad():              # taps off the TSM pattern
            mods["vjp"].action_shift.weight.normal_(0.0, 0.5, generator=gen)
        mods[None].load_state_dict(mods["vjp"].state_dict())
        x = torch.randn(TRAIN_CLIPS * T, c, h, s // h, device="cuda",
                        generator=gen).contiguous(
                            memory_format=torch.channels_last)
        cot = torch.randn(TRAIN_CLIPS * T, f, h, s // h, device="cuda",
                          generator=gen)
        res = {}
        for mode, m in mods.items():
            xi = x.clone().requires_grad_()
            y = m(xi)
            (y * cot).sum().backward()
            res[mode] = dict(out=y.detach(), dx=xi.grad, **{
                k: p.grad for k, p in m.named_parameters()})
        rels = {k: _rel_err(v, res[None][k])[1] for k, v in res["vjp"].items()}
        worst = max(rels, key=rels.get)
        r = dict(S=s, C=c, F=f, n=len(rels), worst=worst,
                 worst_rel=rels[worst], out_rel=rels["out"],
                 dx_rel=rels["dx"], tol=SITE_TOL)
        out.append(r)
        print("check_site " + json.dumps(r), flush=True)
        if not rels[worst] <= SITE_TOL:
            raise AssertionError(f"ACTION site S={s} C={c} F={f}: {worst} "
                                 f"rel {rels[worst]:.3e} > {SITE_TOL}")
        del mods, res, x, cot
    return out


def _parity_grads(torch, seed, mode, dtype, batch, state):
    """Loss and gradients of one fp32 (or float64) forward/backward of the
    mtmm loss; ``state``: BN statistics to load, every BN then frozen."""
    from ehgr_tpu_torch.configs import LossConfig
    from ehgr_tpu_torch.models.norm import BatchNorm
    from ehgr_tpu_torch.ops.preprocess_device import (IMAGENET_MEAN,
                                                      IMAGENET_STD)
    from ehgr_tpu_torch.train.steps import make_loss_fn

    model = _train_model(torch, seed, mode, torch.float32, 0.0)
    if state is not None:
        model.load_state_dict(state)
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.frozen = True
    model = model.to(dtype).train()
    model.dtype = dtype
    loss_fn = make_loss_fn(model, stage="mtmm",
                           loss_cfg=LossConfig(depth_size=DEPTH_SIZE),
                           mean=IMAGENET_MEAN, std=IMAGENET_STD)
    total, _, _ = loss_fn(batch, None)
    total.backward()
    return total.item(), {k: p.grad.double()
                          for k, p in model.named_parameters()}


def train_parity(torch, seed):
    """One step's loss and gradients of the full-width model: the fp32
    'vjp' kernel model and the fp32 plain model, each against a float64 run
    of the plain model from the same weights and batch (dropout 0).  The
    plain model's own fp32 error is the floor: at random init the fp32
    gradient of this network is only good to a few percent (a forward
    perturbation of one rounding moves it as much), so the kernel model is
    held to GRAD_X times that floor, tensor by tensor in median and worst,
    plus GRAD_TOL.  Two settings: ``bn_batch``, every BN on batch
    statistics as the train phase runs; ``bn_running``, every BN on running
    statistics set from the batch."""
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in make_train_batches(seed, 1)[0].items()}
    out = {}
    for setting in ("bn_batch", "bn_running"):
        state = _frozen_bn_state(torch, seed, batch) \
            if setting == "bn_running" else None
        loss64, ref = _parity_grads(torch, seed, None, torch.float64, batch,
                                    state)
        runs = {name: _parity_grads(torch, seed, mode, torch.float32, batch,
                                    state)
                for name, mode in (("vjp", "vjp"), ("plain", None))}
        errs = {name: sorted(_rel_err(g[k], ref[k])[1] for k in ref)
                for name, (_, g) in runs.items()}
        direct = {k: _rel_err(g, runs["plain"][1][k])[1]
                  for k, g in runs["vjp"][1].items()}
        stat = {name: dict(median=e[len(e) // 2], worst=e[-1])
                for name, e in errs.items()}
        tol = {q: GRAD_X * stat["plain"][q] + GRAD_TOL
               for q in ("median", "worst")}
        loss_rel = abs(runs["vjp"][0] - runs["plain"][0]) / \
            abs(runs["plain"][0])
        r = out[setting] = dict(
            loss_vjp=runs["vjp"][0], loss_plain=runs["plain"][0],
            loss_float64=loss64, loss_rel=loss_rel, loss_tol=LOSS_TOL,
            n_grads=len(ref), vjp_vs_float64=stat["vjp"],
            plain_vs_float64=stat["plain"], tol=tol,
            vjp_vs_plain=dict(median=sorted(direct.values())[
                len(direct) // 2], worst=max(direct.values()),
                worst_key=max(direct, key=direct.get)))
        print(f"train_parity {setting} " + json.dumps(r), flush=True)
        if not loss_rel <= LOSS_TOL:
            raise AssertionError(f"{setting}: fp32 train loss vjp "
                                 f"{runs['vjp'][0]} vs plain "
                                 f"{runs['plain'][0]}")
        for q in ("median", "worst"):
            if not stat["vjp"][q] <= tol[q]:
                raise AssertionError(
                    f"{setting}: {q} gradient error against float64: vjp "
                    f"{stat['vjp'][q]:.3e}, plain {stat['plain'][q]:.3e}")
        del runs, ref
    return out


def _device_profile(torch, fn):
    """Wall time and device time by kernel name of one call of ``fn``
    (torch.profiler), ``fn`` run once before to warm up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = {}
    for e in prof.key_averages():      # kernels only: ops would count twice
        if str(e.device_type).endswith("CUDA"):
            dev[e.key] = getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0)) / 1e3
    busy = sum(dev.values())
    top = dict(sorted(dev.items(), key=lambda kv: -kv[1])[:20])
    return dict(wall_ms=wall, device_busy_ms=busy,
                idle_share=1 - busy / wall, top_device_ms=top)


def profile_train(torch, warm):
    """Device time by kernel over one train step."""
    step, state, batch, gen = warm
    out = _device_profile(torch, lambda: step(state, batch, gen))
    print("train_profile " + json.dumps(out), flush=True)
    return out


def _time_ms(torch, fn, reps=20):
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _bound_ms(nbytes, flops, dname):
    """(ms to move the bytes, ms to do the FLOPs) at the card's peaks."""
    return nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dname] * 1e3


def time_kernels(torch, mega, n, gen):
    """Per site shape, bf16 (the main path's dtype): kernel, plain version,
    bare GEMM; bound from the bytes each function must move and the FLOPs
    it does."""
    rows_out = []
    for s, c, f, count in SITES:
        d = _inputs(torch, n, s, c, f, torch.bfloat16, gen)
        rows, cr, nt = n * T * s, c // 16, n * T
        xb = d["x4"].reshape(rows, c)
        for kernel in ("action_stats", "action_apply"):
            if kernel == "action_stats":
                args = (d["x4"], d["w"], d["wp3"])
                fk, fp = mega.action_stats, mega.action_stats_plain
                gemm_w = d["wp3"]
                nbytes = 2 * (rows * c + 3 * c + c * cr +
                              rows + nt * c + rows * cr)
                flops = 2 * rows * c * cr
            else:
                args = (d["x4"], d["w"], d["g1"], d["gch"], d["wn"])
                fk, fp = mega.action_apply, mega.action_apply_plain
                gemm_w = d["wn"]
                nbytes = 2 * (rows * c + 3 * c + rows + nt * c + c * f +
                              rows * f)
                flops = 2 * rows * c * f
            t_bytes, t_ops = _bound_ms(nbytes, flops, "bfloat16")
            bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            r = dict(kernel=kernel, S=s, C=c, F=f, sites=count, rows=rows,
                     bytes=nbytes, flops=flops, bytes_ms=t_bytes,
                     ops_ms=t_ops, bound_ms=bound, bound_by=by,
                     ms=_time_ms(torch, lambda: fk(*args)),
                     plain_ms=_time_ms(torch, lambda: fp(*args)),
                     matmul_ms=_time_ms(torch, lambda: xb @ gemm_w))
            r["roofline_share"] = bound / r["ms"]
            rows_out.append(r)
            print(f"time {kernel:12s} S={s:4d} C={c:4d} F={f:3d} "
                  f"ms={r['ms']:.4f} bound={bound:.4f} ({by}) "
                  f"plain={r['plain_ms']:.4f} matmul={r['matmul_ms']:.4f}",
                  flush=True)
        del d, xb
    return rows_out


def _conv3d_shift(torch, x4, w):
    """The yardstick of the shift: one grouped ``conv3d`` with kernel
    (3, 1, 1) and ``groups=C`` on the channels_last_3d view of ``x4``
    (``[N,C,T,S,1]``), the same function; the port never calls it."""
    import torch.nn.functional as F

    n, t, s, c = x4.shape
    x5 = x4.reshape(n, t, s, 1, c).permute(0, 4, 1, 2, 3)
    wc = w.t().reshape(c, 1, 3, 1, 1).contiguous()
    return x5, wc, lambda: F.conv3d(x5, wc, padding=(1, 0, 0), groups=c)


def time_shift(torch, shk, gen):
    """Per distinct (S, C) of the sites at TRAIN_CLIPS clips, bf16: each
    shift kernel, its plain version and the library yardstick (grouped
    conv3d; its ``convolution_backward`` for dx and dw).  Bound: the bytes
    each function must move once (fwd reads x and writes y, bwd reads x and
    g and writes dx, plus w and dw) at 3.35 TB/s, beside its f32 FMAs on
    the CUDA cores (5 flops/element fwd, 11 bwd) at 67 TFLOP/s."""
    rows_out = []
    for s, c, count in _shift_shapes():
        x, w, g = _shift_inputs(torch, TRAIN_CLIPS, s, c, torch.bfloat16, gen)
        x5, wc, conv = _conv3d_shift(torch, x, w)
        g5 = g.reshape(TRAIN_CLIPS, T, s, 1, c).permute(0, 4, 1, 2, 3)
        if _rel_err(conv().permute(0, 2, 3, 4, 1).reshape(x.shape),
                    shk.learnable_shift_fwd(x, w))[1] > SHIFT_TOL["bfloat16"]:
            raise AssertionError("the conv3d yardstick computes another "
                                 "function")

        def conv_bwd():
            return torch.ops.aten.convolution_backward(
                g5, x5, wc, None, [1, 1, 1], [1, 0, 0], [1, 1, 1], False,
                [0, 0, 0], c, [True, True, False])

        elems = TRAIN_CLIPS * T * s * c
        for kernel in ("learnable_shift_fwd", "learnable_shift_bwd"):
            if kernel == "learnable_shift_fwd":
                fk = lambda: shk.learnable_shift_fwd(x, w)
                fp = lambda: shk.learnable_shift_fwd_plain(x, w)
                fl, nbytes, flops = conv, 2 * (2 * elems + 3 * c), 5 * elems
            else:
                fk = lambda: shk.learnable_shift_bwd(x, g, w)
                fp = lambda: shk.learnable_shift_bwd_plain(x, g, w)
                fl = conv_bwd
                nbytes, flops = 2 * (3 * elems + 6 * c), 11 * elems
            t_bytes, t_ops = _bound_ms(nbytes, flops, "float32")
            bound = max(t_bytes, t_ops)
            r = dict(kernel=kernel, S=s, C=c, sites=count,
                     rows=TRAIN_CLIPS * T * s, bytes=nbytes, flops=flops,
                     bytes_ms=t_bytes, ops_ms=t_ops, bound_ms=bound,
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     ms=_time_ms(torch, fk), plain_ms=_time_ms(torch, fp),
                     library_ms=_time_ms(torch, fl))
            r["roofline_share"] = bound / r["ms"]
            rows_out.append(r)
            print(f"time {kernel:19s} S={s:4d} C={c:4d} ms={r['ms']:.4f} "
                  f"bound={bound:.4f} ({r['bound_by']}) "
                  f"plain={r['plain_ms']:.4f} "
                  f"library={r['library_ms']:.4f}", flush=True)
        del x, w, g, x5, g5, wc
    return rows_out


def kernel_table(checks, timings, launches):
    """One entry per kernel.  The ACTION kernels' times are per forward of
    the served batch, the shift kernels' per train step (each site shape
    weighted by its number of sites); ``launches`` sums the counts of the
    two paths' runs (``launches_by_path``)."""
    table = []
    for name in ("learnable_shift_fwd", "learnable_shift_bwd"):
        t = [r for r in timings if r["kernel"] == name]
        c = [r for r in checks if r["kernel"] == name]
        tot = {k: sum(r[k] * r["sites"] for r in t)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "bytes_ms", "ops_ms")}
        by_path = {p: v[name] for p, v in launches.items() if name in v}
        table.append(dict(
            name=name, route="cuda",
            source="ehgr_tpu_torch/ops/kernels/csrc/shift.cu",
            replaces="ehgr_tpu/ops/pallas/shift.py:158",
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in c
                            if r["dtype"] == "bfloat16"),
            max_abs_err_fp32=max(r["max_abs_err"] for r in c
                                 if r["dtype"] == "float32"),
            max_rel_err=max(r["max_rel_err"] for r in c),
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by="bytes" if tot["bytes_ms"] >= tot["ops_ms"]
            else "operations",
            library_ms=tot["library_ms"], per="train step, 8 clips",
            sites=[{k: r[k] for k in ("S", "C", "sites", "ms", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by",
                                      "roofline_share")}
                   for r in t]))
    for name in ("action_stats", "action_apply"):
        t = [r for r in timings if r["kernel"] == name]
        c = [r for r in checks if r["kernel"] == name]
        tot = {k: sum(r[k] * r["sites"] for r in t)
               for k in ("ms", "plain_ms", "matmul_ms", "bound_ms",
                         "bytes_ms", "ops_ms")}
        by_path = {p: v[name] for p, v in launches.items() if name in v}
        table.append(dict(
            name=name, route="cuda",
            source="ehgr_tpu_torch/ops/kernels/csrc/action_mega.cu",
            replaces=("ehgr_tpu/ops/pallas/action_mega.py:126"
                      if name == "action_stats"
                      else "ehgr_tpu/ops/pallas/action_mega.py:192"),
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in c
                            if r["dtype"] == "bfloat16"),
            max_abs_err_fp32=max(r["max_abs_err"] for r in c
                                 if r["dtype"] == "float32"),
            max_rel_err=max(r["max_rel_err"] for r in c),
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by="bytes" if tot["bytes_ms"] >= tot["ops_ms"]
            else "operations",
            library_ms=None, matmul_ms=tot["matmul_ms"],
            per="forward of the served batch, 20 clips",
            sites=[{k: r[k] for k in ("S", "C", "F", "sites", "ms",
                                      "plain_ms", "matmul_ms", "bound_ms",
                                      "bound_by", "roofline_share")}
                   for r in t]))
    return table


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights, the videos and the inputs")
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ehgr_tpu_torch.ops.kernels import action_mega as mega
    from ehgr_tpu_torch.ops.kernels import shift as shk
    from ehgr_tpu_torch.ops.kernels.build import build, load

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    libs = ("action_mega", "shift")
    with ThreadPoolExecutor(len(libs)) as pool:   # one nvcc per source
        list(pool.map(lambda name: build(name, verbose=True), libs))
    for name in libs:                              # -Xptxas -v printed
        load(name)
    print(f"build {', '.join(libs)}: {time.perf_counter() - t0:.1f} s",
          flush=True)

    n = VIDEOS * CLIPS                         # clips per forward
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    checks, pool_acc = check_kernels(torch, mega, n, gen)
    checks += check_shift(torch, shk, gen)
    batches = make_batches(args.seed)
    model, plain = build_models(torch, args.seed, batches[0][0])
    served = serve(torch, model, batches)
    logits = compare_logits(torch, model, plain, batches[0][0])
    del plain
    prof = profile_forward(torch, model, batches[0][0])
    del model
    trained, warm = train(torch, args.seed)
    train_prof = profile_train(torch, warm)
    del warm
    sites = check_sites(torch, gen)
    parity = train_parity(torch, args.seed)
    timings = time_kernels(torch, mega, n, gen) + time_shift(torch, shk, gen)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    table = kernel_table(checks, timings, {"serve": served["launches"],
                                           "train": trained["launches"]})
    print(json.dumps({"kernels": table, "serve": served, "logits": logits,
                      "pool_accumulation": pool_acc, "profile": prof,
                      "train": trained, "train_profile": train_prof,
                      "train_sites": sites, "train_parity": parity,
                      "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
