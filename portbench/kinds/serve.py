"""Serve traffic: the test protocol's scorer, closed loop, one client.

A call hands one host batch of uint8 videos ``[V, K, T, H, W, 3]`` to
``make_score_fn`` and ends with the videos' probabilities on the host.
Set-up: the pool, the seeded weights and BN statistics, the program's
model and scorer, two warm-up calls on the pool's first batch.  The window
calls back to back, cycling the pool, until ``--seconds`` have passed; a
traced run then profiles ``trace_calls`` more calls.  Afterwards every
call's answer is compared with the float32 reference's on its batch.
"""

from __future__ import annotations

import math

import torch

from portbench import session, trace
from portbench.correct import logprob_gap, video_kl
from portbench.harness import Cell, sub_seed
from portbench.reference.model import TSN
from portbench.traffic import make_pool
from portbench.weights import float32_exact


def run(cell: Cell) -> dict:
    from ehgr_tpu_torch.eval import inference

    dev, m, tr = cell.device, cell.model, cell.traffic
    pool = make_pool(tr, m, sub_seed(cell.seed, session.TRAFFIC), dev)
    weights = session.weights_and_stats(cell, False, pool[0]["frames"])
    stats = session.statistics_of(weights)
    model = session.program_model(cell, tr["arch"], "serve")
    model.load_state_dict(weights, strict=True)
    del weights
    session.free(dev)
    session.reset_peak(dev)
    score = inference.make_score_fn(model, device=dev, scale_size=m["crop"],
                                    crop_size=m["crop"], square_resize=True,
                                    dtype_name=m["dtype"])
    for _ in range(2):                              # every shape, every plan
        score(pool[0]["frames"]).cpu()
    session.sync(dev)
    setup_s = session.wall() - cell.started

    answers, latencies = [], []
    t0 = session.now()
    end = t0
    while end - t0 < cell.seconds:
        i = len(answers) % len(pool)
        a = session.now()
        probs = score(pool[i]["frames"]).cpu()
        end = session.now()
        latencies.append(end - a)
        answers.append((i, probs))
    window_s = end - t0
    calls = len(answers)

    stretch = None
    if cell.trace:
        def traced(k):
            i = (calls + k) % len(pool)
            with torch.profiler.record_function("portbench.score"):
                out = score(pool[i]["frames"])
            with torch.profiler.record_function("portbench.readback"):
                answers.append((i, out.cpu()))
        stretch = trace.profile_stretch(traced, tr["trace_calls"],
                                        lambda: session.sync(dev))
    peak = session.peak_bytes(dev)
    del score, model
    session.free(dev)

    clips = tr["videos"] * tr["clips"]
    failed = sum(1 for _, p in answers
                 if p.shape != (tr["videos"], m["num_classes"]) or
                 not torch.isfinite(p).all())
    refs = reference_probs(cell, pool, sorted({i for i, _ in answers}), stats)
    sound = [(p, refs[i]) for i, p in answers if p.shape == refs[i].shape]
    gap = max((logprob_gap(p, r) for p, r in sound), default=math.inf)
    kl = sum(video_kl(p, r) for p, r in sound) / len(sound) if sound \
        else math.inf
    return {
        "record": {"kind": "serve", "setup_s": setup_s,
                   "window_s": window_s, "calls": calls,
                   "clips": calls * clips, "latencies_s": latencies,
                   "clips_per_call": clips, "trace": stretch},
        "values": {"video_logprob_gap": gap, "video_kl": kl},
        "attempted": len(answers), "failed": failed,
        "memory_peak_bytes": peak,
        "readings": {"program": {i: p.tolist() for i, p in
                                 dict(reversed(answers)).items()},
                     "reference": {i: p.tolist() for i, p in refs.items()}},
    }


@torch.no_grad()
def reference_probs(cell: Cell, pool, used, stats) -> dict:
    """Pool index -> the float32 reference's video probabilities
    ``[V, classes]``, a few videos at a time."""
    dev, m, tr = cell.device, cell.model, cell.traffic
    weights = session.reference_state(cell, False, stats)
    ref = TSN(m, with_depth=False, device=dev)
    ref.load_state_dict(weights, strict=True)
    ref.eval()
    del weights
    step = tr["reference_videos"]
    out = {}
    with float32_exact():
        for i in used:
            frames = pool[i]["frames"]
            parts = []
            for v in range(0, frames.shape[0], step):
                x = session.frames_in(cell, frames[v:v + step], dev)
                p = torch.softmax(ref(x), dim=-1)
                parts.append(p.reshape(-1, tr["clips"], p.shape[-1])
                             .mean(1))
            out[i] = torch.cat(parts).cpu()
    del ref
    session.free(dev)
    return out
