"""The port's streaming recognizer (``ehgr_tpu_torch/eval/streaming.py``)
on the CPU against ``ehgr_tpu.eval.streaming``: both recognizers fed the
same scripted probability stream emit the same events (kind, label, frame
index and confidence, compared exactly: the host arithmetic is the same
numpy), for the cases of ``tests/test_streaming.py`` (window cadence, no
fire before T frames, min-window hysteresis, start/end, label switch,
background class, flush, EMA) and one long random stream; then windows
through the port's cascade, and the tiny TSN stream scorer against JAX's
``make_stream_score_fn`` (tiny ResNet, T=4, 32^2, 5 classes, f32,
converted weights) within 1e-5."""

import numpy as np
import pytest
import torch

from ehgr_tpu.eval import streaming as jstreaming
from ehgr_tpu.models.torch_import import export_state_dict
from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu_torch.eval import cascade, streaming
from ehgr_tpu_torch.models.tsn import variant

import jax
import jax.numpy as jnp

from test_torch_train import single_thread  # noqa: F401  (a fixture)
from test_torch_train import tiny_resnet

HW, T, CLS = 16, 4, 5
TOL = 1e-5


def _probs(label, conf):
    p = np.full(CLS, (1.0 - conf) / (CLS - 1), np.float32)
    p[label] = conf
    return p


class _Script:
    """Scripted per-window probabilities; records the window shapes."""

    def __init__(self, probs):
        self.probs = list(probs)
        self.calls = []

    def __call__(self, clip):
        self.calls.append(clip.shape)
        return np.asarray([self.probs.pop(0)], np.float32)


def _random_script(n=40):
    """Gesture-like: segments of 5 windows of one label at a random high
    or low confidence, the label drawn per segment."""
    rng = np.random.default_rng(4)
    out = []
    for _ in range(n // 5):
        label, high = int(rng.integers(0, CLS)), rng.uniform() < 0.7
        out += [_probs(label, float(rng.uniform(0.6, 1.0) if high
                                    else rng.uniform(0.1, 0.5)))
                for _ in range(5)]
    return out


# name -> (window probabilities, frames pushed, recognizer settings)
CASES = {
    "cadence": ([_probs(0, 0.2)] * 10, 20,
                dict(window=8, stride=3, smooth=0.0, threshold=0.9)),
    "before_t_frames": ([_probs(0, 0.99)] * 4, T - 1,
                        dict(window=8, stride=1, min_windows=1)),
    "hysteresis": ([_probs(2, 0.95), _probs(2, 0.1), _probs(2, 0.1)], 12,
                   dict(window=4, stride=4, smooth=0.0, min_windows=2)),
    "start_end": ([_probs(3, 0.9)] * 3 + [_probs(3, 0.05)], 16,
                  dict(window=4, stride=4, smooth=0.0, min_windows=2)),
    "label_switch": ([_probs(1, 0.9)] * 2 + [_probs(4, 0.9)] * 2, 16,
                     dict(window=4, stride=4, smooth=0.0, min_windows=1)),
    "background": ([_probs(0, 0.99)] * 3, 12,
                   dict(window=4, stride=4, smooth=0.0, min_windows=1,
                        background_class=0)),
    "flush": ([_probs(2, 0.9)] * 2, 8,
              dict(window=4, stride=4, smooth=0.0, min_windows=1)),
    "ema": ([_probs(1, 1.0), _probs(2, 1.0)], 8,
            dict(window=4, stride=4, smooth=0.5, threshold=2.0)),
    "random_long": (_random_script(), 160,
                    dict(window=12, stride=4, smooth=0.6, threshold=0.5,
                         min_windows=2, background_class=3)),
}


def _events(evs):
    return [(e.kind, e.label, e.frame_index, e.confidence) for e in evs]


@pytest.mark.parametrize("name", sorted(CASES))
def test_events_match_jax(name):
    probs, frames, kw = CASES[name]
    recs = {}
    for key, mod in (("jax", jstreaming), ("port", streaming)):
        script = _Script(probs)
        rec = mod.StreamingRecognizer(script, num_segments=T, **kw)
        events = []
        for i in range(frames):
            events += rec.push(np.full((HW, HW, 3), i % 256, np.uint8))
        events += rec.flush()
        recs[key] = (_events(events), script.calls, rec.state, rec._probs)
    (je, jc, js, jp), (pe, pcalls, ps, pp) = recs["jax"], recs["port"]
    assert pe == je and pcalls == jc and ps == js
    assert (pp is None and jp is None) or np.array_equal(pp, jp)
    assert all(s == (1, T, HW, HW, 3) for s in pcalls)
    if name == "random_long":
        assert len(pe) >= 4 and {e[0] for e in pe} == {"start", "end"}


def test_window_is_refused_below_t():
    with pytest.raises(ValueError):
        streaming.StreamingRecognizer(lambda c: c, num_segments=8, window=4)


def _port_tsn(arch, sd=None, **kw):
    with tiny_resnet():
        m = variant(arch, num_class=CLS, num_segments=T, dtype=torch.float32,
                    device="cpu", generator=torch.Generator().manual_seed(1),
                    action_fused="mega", **kw)
    if sd is not None:
        m.load_state_dict(sd, strict=True)
    return m.eval()


@pytest.mark.usefixtures("single_thread")
def test_stream_windows_through_cascade():
    """The cascade's two-pass run as the stream's scorer: each window
    scored by the exit stage and escalated to the full one below the
    threshold; the recognizer smooths the probabilities it returns."""
    stages = [_port_tsn(a) for a in ("tsn_middle1", "tsn")]
    score_exit, score_full = cascade.build_cascade_score_fns(
        *stages, device="cpu", scale_size=32, crop_size=32,
        dtype_name="float32")
    runs = []

    def fn(clip_u8):
        run = cascade.execute_cascade(score_exit, score_full,
                                      clip_u8[:, None], threshold=0.5)
        runs.append(run)
        return run["probs"]

    rec = streaming.StreamingRecognizer(fn, num_segments=T, window=8,
                                        stride=4, threshold=1.1)
    rng = np.random.default_rng(5)
    for _ in range(12):
        rec.push(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    assert len(runs) == 3                   # windows at frames 4, 8, 12
    for run in runs:
        assert run["escalated"][0] == (run["exit_conf"][0] < 0.5)
    assert rec._probs.shape == (CLS,)
    assert np.isclose(rec._probs.sum(), 1.0, atol=1e-5)


def test_stream_scorer_matches_jax():
    """The tiny TSN (converted weights, the port in 'mega') scores each
    window of one frame stream as JAX's stream scorer does."""
    with tiny_resnet():
        jm = j_variant("tsn", num_class=CLS, num_segments=T)
        v = jax.jit(lambda r: jm.init(
            {"params": r}, jnp.zeros((1, T, 32, 32, 3)), train=False))(
                jax.random.key(2))
    sd = {k: torch.from_numpy(np.array(a))
          for k, a in export_state_dict(v).items()}
    jfn = jstreaming.make_stream_score_fn(jm, v, crop_size=32,
                                          dtype_name="float32")
    pfn = streaming.make_stream_score_fn(_port_tsn("tsn", sd), device="cpu",
                                         crop_size=32, dtype_name="float32")
    seen = {"jax": [], "port": []}
    recs = []
    for key, mod, fn in (("jax", jstreaming, jfn), ("port", streaming, pfn)):
        def scored(clip, _fn=fn, _seen=seen[key]):
            _seen.append(_fn(clip))
            return _seen[-1]
        recs.append(mod.StreamingRecognizer(scored, num_segments=T,
                                            window=8, stride=4,
                                            threshold=1.1))
    rng = np.random.default_rng(0)
    with tiny_resnet():
        for _ in range(16):
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            for rec in recs:
                rec.push(frame)
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for got, want in zip(seen["port"], seen["jax"]):
        assert got.shape == want.shape == (1, CLS) and \
            got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
