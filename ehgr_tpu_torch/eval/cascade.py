"""Confidence-gated early-exit cascade (counterpart of
``ehgr_tpu/eval/cascade.py``).

Every video is scored by the cheap exit-K deploy model (``tsn_middle{K}``);
only videos whose vote confidence (the max of the clip-averaged
probability) falls below a threshold escalate to the full network's final
head (``tsn``).  Both stages are ``eval.inference.make_score_fn`` scorers
``[V, K, T, H, W, 3] -> [V, C]`` on the device, and both load from one
``tsn_sd`` checkpoint (the exit stage takes the backbone prefix, scala-K
and ``middle_fcK``, the full stage the backbone and ``new_fc``).

Escalation is batched on the host as in the JAX package: the escalated
videos are gathered there, padded with video 0 to a power-of-two bucket
and uploaded again, so the full model sees at most ``log2(batch)`` batch
sizes.  ``collect_scores`` scores each video through both stages once, so
the whole threshold curve is a host computation (``sweep_thresholds``);
``execute_cascade`` runs the real two-pass path for one threshold.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

from ehgr_tpu_torch.device import DeviceLike
from ehgr_tpu_torch.eval.inference import make_score_fn

DEFAULT_THRESHOLDS = (0.0, 0.3, 0.5, 0.7, 0.8, 0.9, 0.95, 0.99, 1.1)


def bucket_size(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped at ``cap`` (the pass-1 batch)."""
    if n <= 0:
        return 0
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


def build_cascade_score_fns(model_exit, model_full, **score_kw) -> Tuple:
    """(score_exit, score_full): ``[V,K,T,H,W,3] -> [V,C]`` probability
    scorers (``make_score_fn`` with ``score_kw``)."""
    return (make_score_fn(model_exit, **score_kw),
            make_score_fn(model_full, **score_kw))


def _np(probs) -> np.ndarray:
    return probs.float().cpu().numpy()


def execute_cascade(score_exit, score_full, frames_u8: np.ndarray,
                    threshold: float) -> Dict[str, np.ndarray]:
    """Run the two-pass cascade on one video batch.

    Pass 1 scores every video with the exit model; videos with
    ``max(prob) < threshold`` are gathered on the host, padded to a
    power-of-two bucket with video 0, and scored again by the full model.
    Returns per-video probs, predictions, the escalation mask and the exit
    confidence."""
    v = frames_u8.shape[0]
    p_exit = _np(score_exit(frames_u8))
    conf = p_exit.max(axis=-1)
    esc = conf < threshold
    probs = p_exit.copy()
    if esc.any():
        idx = np.nonzero(esc)[0]
        b = bucket_size(len(idx), v)
        pad = np.concatenate([idx, np.zeros(b - len(idx), np.int64)]) \
            if b > len(idx) else idx[:b]
        p_full = _np(score_full(frames_u8[pad]))
        probs[idx] = p_full[: len(idx)]
    return {"probs": probs, "pred": probs.argmax(-1), "escalated": esc,
            "exit_conf": conf}


def collect_scores(score_exit, score_full,
                   batches: Iterable) -> Dict[str, np.ndarray]:
    """Score every ``(frames_u8, labels)`` batch through both stages once;
    the arrays make any threshold's cascade a host computation
    (``sweep_thresholds``)."""
    pe, pf, ys = [], [], []
    for frames, labels in batches:
        pe.append(_np(score_exit(frames)))
        pf.append(_np(score_full(frames)))
        ys.append(np.asarray(labels))
    return {"p_exit": np.concatenate(pe), "p_full": np.concatenate(pf),
            "label": np.concatenate(ys)}


def sweep_thresholds(scores: Dict[str, np.ndarray],
                     thresholds: Sequence[float],
                     rate_exit: float = 0.0,
                     rate_full: float = 0.0) -> list:
    """The cascade's operating curve from one ``collect_scores`` pass.

    Per threshold: top-1, escalated fraction and, when both stages'
    measured rates are given, the effective serving rate
    ``1 / (1/rate_exit + frac/rate_full)`` (every clip pays the exit,
    escalated clips the full model too)."""
    p_exit, p_full, y = scores["p_exit"], scores["p_full"], scores["label"]
    conf = p_exit.max(-1)
    pred_exit, pred_full = p_exit.argmax(-1), p_full.argmax(-1)
    rows = []
    for tau in thresholds:
        esc = conf < tau
        pred = np.where(esc, pred_full, pred_exit)
        row = {"threshold": float(tau),
               "top1": 100.0 * float((pred == y).mean()),
               "escalated_pct": 100.0 * float(esc.mean())}
        if rate_exit > 0 and rate_full > 0:
            row["effective_clips_per_sec"] = round(
                1.0 / (1.0 / rate_exit + float(esc.mean()) / rate_full), 1)
        rows.append(row)
    return rows


def run_cascade_test(cfg, exit_k: int = 1,
                     thresholds: Sequence[float] = DEFAULT_THRESHOLDS,
                     rate_exit: float = 0.0, rate_full: float = 0.0,
                     device: DeviceLike = None) -> Dict:
    """The cascade over the test protocol (the ``cli.test_cascade`` verb)
    on ``device`` (default CUDA).

    Loads one ``tsn_sd`` checkpoint (``cfg.run.checkpoint_path``) into both
    stages, scores the multi-clip test set through each once, and returns
    the threshold curve plus a real two-pass run of the first batch at the
    median exit confidence."""
    from ehgr_tpu_torch.data.factory import build_test_dataset
    from ehgr_tpu_torch.data.pipeline import Loader
    from ehgr_tpu_torch.eval.runner import _build_model

    m_exit, _ = _build_model(cfg, f"tsn_middle{exit_k}", device)
    m_full, _ = _build_model(cfg, "tsn", device)
    score_exit, score_full = build_cascade_score_fns(
        m_exit, m_full, device=device, scale_size=cfg.data.scale_size,
        crop_size=cfg.data.crop_size, square_resize=True,
        dtype_name=cfg.model.dtype)

    dataset = build_test_dataset(cfg)
    loader = Loader(dataset, batch_size=max(1, 8 // cfg.data.clip_num or 1),
                    shuffle=False, num_workers=cfg.data.num_workers,
                    drop_last=False)
    t = cfg.model.num_segments

    def batches():
        for b in loader:
            rgb = np.asarray(b["rgb"])          # [V, K, crops*T, H, W, C]
            v, k, ct = rgb.shape[:3]
            # crops fold into the clip-vote axis (eval/runner.py protocol)
            rgb = rgb.reshape((v, k * (ct // t), t) + rgb.shape[3:])
            yield rgb, np.asarray(b["label"])

    first = next(iter(batches()))
    scores = collect_scores(score_exit, score_full, batches())
    curve = sweep_thresholds(scores, thresholds, rate_exit, rate_full)

    tau = float(np.median(scores["p_exit"].max(-1)))
    run = execute_cascade(score_exit, score_full, first[0], tau)
    y = scores["label"]
    return {"exit": exit_k, "n_videos": int(len(y)),
            "top1_exit_only": 100.0 * float(
                (scores["p_exit"].argmax(-1) == y).mean()),
            "top1_full_only": 100.0 * float(
                (scores["p_full"].argmax(-1) == y).mean()),
            "curve": curve,
            "two_pass_check": {
                "threshold": tau,
                "escalated": int(run["escalated"].sum()),
                "of": int(first[0].shape[0])}}
