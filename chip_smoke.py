#!/usr/bin/env python3
"""Drive the PyTorch port (``ehgr_tpu_torch``) on one CUDA GPU and check it.

Phases; any miss raises and the run exits nonzero:

1. build the CUDA kernels from the sources in this checkout;
2. hold ``action_stats`` / ``action_apply`` against their plain versions at
   the eight ResNet-50 ACTION site shapes of the main path plus two ragged
   shapes, in fp32 (TF32 off) and in bf16 (plain version in f32 from the
   same bf16 inputs); and measure how far the TPU kernel's bf16 running sum
   of ``pool`` would land from the f32 sum kept here;
3. serve: ``evaluate`` over ``make_score_fn`` on the full-width TSN + ACTION
   ResNet-50 (T=8, 224^2, 83 classes, bf16, ``action_fused='mega'``,
   weights drawn from a seeded ``torch.Generator``) for a few request
   batches of uint8 videos, with the kernels' launch counters zeroed just
   before and read just after; then the logits against the plain path
   (``action_fused=None``) in fp32 and in bf16;
4. trace one scorer call with ``torch.profiler`` (device time by kernel,
   idle share);
5. time each kernel, its plain version and the bare GEMM of the same
   ``[rows, C] x [C, F]`` product at each site shape with CUDA events.

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


def build_models(torch, seed, frames):
    """The served model ('mega') and its plain twin from the same seed.

    With BN's init statistics (mean 0, var 1) a random ResNet-50 + ACTION
    at 224^2 grows its activations to ~1e5 (logits ~7e3), where the
    comparison with the plain path measures amplified rounding, not the
    kernels.  So, as one would for any random-weight smoke model, each BN's
    running statistics are set once from its input on the first batch
    (plain path, fp32); both models then hold the same weights."""
    from ehgr_tpu_torch.models.norm import BatchNorm
    from ehgr_tpu_torch.models.tsn import variant

    models = [variant("tsn", num_class=CLASSES, num_segments=T,
                      temporal="action", action_fused=mode,
                      dtype=torch.float32, device="cuda",
                      generator=torch.Generator().manual_seed(seed))
              for mode in ("mega", None)]
    mega_model, plain = models

    def set_stats(bn, inputs):
        x = inputs[0].float()
        bn.running_mean.copy_(x.mean((0, 2, 3)))
        bn.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats)
             for m in plain.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        plain(_clips(torch, frames))
    for h in hooks:
        h.remove()
    mega_model.load_state_dict(plain.state_dict())
    for m in models:
        m.dtype = torch.bfloat16
    return mega_model, plain


def serve(torch, model, batches):
    """The main path: the multi-clip scorer over request batches, with the
    kernels' launch counters zeroed just before and read just after."""
    from ehgr_tpu_torch.eval.inference import evaluate, make_score_fn
    from ehgr_tpu_torch.ops.kernels import action_mega as mega

    score = make_score_fn(model, device="cuda", crop_size=CROP,
                          dtype_name="bfloat16")
    score(batches[0][0])                       # warm-up: cuDNN plans
    torch.cuda.synchronize()

    probs = []

    def recorded(frames):
        p = score(frames)
        probs.append(p)
        return p

    mega.action_stats.launches = 0
    mega.action_apply.launches = 0
    t0 = time.perf_counter()
    res = evaluate(recorded, batches, CLASSES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"action_stats": mega.action_stats.launches,
                "action_apply": mega.action_apply.launches}

    want = 16 * BATCHES
    if launches != {"action_stats": want, "action_apply": want}:
        raise AssertionError(f"launches {launches}, want {want} of each "
                             f"(16 sites x {BATCHES} forwards)")
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
    from torch.profiler import ProfilerActivity, profile

    from ehgr_tpu_torch.eval.inference import make_score_fn

    score = make_score_fn(model, device="cuda", crop_size=CROP,
                          dtype_name="bfloat16")
    score(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        score(frames)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = {}
    for e in prof.key_averages():      # kernels only: ops would count twice
        if str(e.device_type).endswith("CUDA"):
            dev[e.key] = getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0)) / 1e3
    busy = sum(dev.values())
    top = dict(sorted(dev.items(), key=lambda kv: -kv[1])[:20])
    out = dict(wall_ms=wall, device_busy_ms=busy,
               idle_share=1 - busy / wall, top_device_ms=top)
    print("profile " + json.dumps(out), flush=True)
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


def kernel_table(checks, timings, launches):
    """One entry per kernel; times are per forward of the served batch
    (each site shape weighted by its number of sites)."""
    table = []
    for name in ("action_stats", "action_apply"):
        t = [r for r in timings if r["kernel"] == name]
        c = [r for r in checks if r["kernel"] == name]
        tot = {k: sum(r[k] * r["sites"] for r in t)
               for k in ("ms", "plain_ms", "matmul_ms", "bound_ms",
                         "bytes_ms", "ops_ms")}
        table.append(dict(
            name=name, route="cuda",
            source="ehgr_tpu_torch/ops/kernels/csrc/action_mega.cu",
            replaces=("ehgr_tpu/ops/pallas/action_mega.py:126"
                      if name == "action_stats"
                      else "ehgr_tpu/ops/pallas/action_mega.py:192"),
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in c
                            if r["dtype"] == "bfloat16"),
            max_abs_err_fp32=max(r["max_abs_err"] for r in c
                                 if r["dtype"] == "float32"),
            max_rel_err=max(r["max_rel_err"] for r in c),
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by="bytes" if tot["bytes_ms"] >= tot["ops_ms"]
            else "operations",
            library_ms=None, matmul_ms=tot["matmul_ms"],
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
    from ehgr_tpu_torch.ops.kernels.build import build, load

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build("action_mega", verbose=True)         # prints -Xptxas -v
    load("action_mega")
    print(f"build action_mega: {time.perf_counter() - t0:.1f} s", flush=True)

    n = VIDEOS * CLIPS                         # clips per forward
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    checks, pool_acc = check_kernels(torch, mega, n, gen)
    batches = make_batches(args.seed)
    model, plain = build_models(torch, args.seed, batches[0][0])
    served = serve(torch, model, batches)
    logits = compare_logits(torch, model, plain, batches[0][0])
    del plain
    prof = profile_forward(torch, model, batches[0][0])
    timings = time_kernels(torch, mega, n, gen)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    table = kernel_table(checks, timings, served["launches"])
    print(json.dumps({"kernels": table, "serve": served, "logits": logits,
                      "pool_accumulation": pool_acc, "profile": prof,
                      "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
