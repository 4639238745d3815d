"""The program's spans (``utils/profiling.span``) at the boundaries of its
two hot paths, under a CPU ``torch.profiler``: a scorer call opens
``ehgr.score`` around ``upload``, ``preprocess`` and ``model``; a train
step opens ``ehgr.step`` around ``copy``, each microbatch's ``forward`` and
``backward``, and ``update``.  With no profiler a span is one shared no-op
and ``record_function`` is never entered.  The model: ResNet-50 widths at
one bottleneck a stage (``test_torch_train.tiny_resnet``), 2 frames, 32^2.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ehgr_tpu_torch.configs import LossConfig, OptimConfig
from ehgr_tpu_torch.eval.inference import make_score_fn
from ehgr_tpu_torch.models import resnet
from ehgr_tpu_torch.models.tsn import variant
from ehgr_tpu_torch.train.optim import build_optimizer
from ehgr_tpu_torch.train.steps import create_train_state, make_train_step
from ehgr_tpu_torch.utils import profiling

CLS, T, HW, N = 5, 2, 32, 2
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(resnet.STAGE_SIZES, "resnet50", (1, 1, 1, 1))
        return variant("tsn", num_class=CLS, num_segments=T,
                       partial_bn=False, dropout=0.0, dtype=torch.float32,
                       device="cpu")


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def frames(*lead):
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, lead + (T, HW, HW, 3), dtype=np.uint8)


def batch():
    return {"rgb": frames(N), "label": np.arange(N) % CLS}


def score_fn(model):
    return make_score_fn(model, device="cpu", scale_size=HW, crop_size=HW,
                         dtype_name="float32")


def step_fn(model, accum_steps=1):
    opt, _ = build_optimizer(model, OptimConfig(lr=1e-3, lr_steps=(1,)),
                             steps_per_epoch=1)
    step = make_train_step(model, opt, stage="baseline",
                           loss_cfg=LossConfig(), ema_decay=0.9, mean=MEAN,
                           std=STD, accum_steps=accum_steps)
    return step, create_train_state(model, opt)


def program_spans(fn):
    """The program's spans that ``fn()`` opens: each outer span with the
    names of the program spans directly under it, in order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in prof.events():
        if e.name.startswith("ehgr.") and not any(
                p.name.startswith("ehgr.") for p in _parents(e)):
            kids = sorted((c for c in e.cpu_children
                           if c.name.startswith("ehgr.")),
                          key=lambda c: c.time_range.start)
            out.append((e.name, [c.name for c in kids]))
    return out


def _parents(e):
    while e.cpu_parent is not None:
        e = e.cpu_parent
        yield e


def test_score_call_spans(model, one_thread):
    score = score_fn(model)
    got = program_spans(lambda: score(frames(2, 2)))
    assert got == [("ehgr.score", ["ehgr.score.upload",
                                   "ehgr.score.preprocess",
                                   "ehgr.score.model"])]


@pytest.mark.parametrize("accum_steps, middle", [
    (1, ["forward", "backward"]),
    (2, ["forward", "backward", "forward", "backward"])])
def test_train_step_spans(model, one_thread, accum_steps, middle):
    step, state = step_fn(model, accum_steps)
    got = program_spans(lambda: step(state, batch()))
    names = ["copy"] + middle + ["update"]
    assert got == [("ehgr.step", [f"ehgr.step.{n}" for n in names])]


def test_span_off_is_one_shared_no_op(model, one_thread, monkeypatch):
    def entered(*a, **kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    class Unprintable:
        def __str__(self):
            raise AssertionError("args made a string with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", entered)
    assert profiling.span("ehgr.a") is profiling.span("ehgr.b", Unprintable())
    with profiling.span("ehgr.a"):
        pass
    score_fn(model)(frames(1, 2))
    step, state = step_fn(model)
    step(state, batch())
    assert state.step == 1


def test_launch_counts_reads_every_kernel_counter(monkeypatch):
    """Every hand-written kernel's wrapper, the custom ops' and the
    learnable shift's two, with its routes; a snapshot's difference counts
    the launches between."""
    from ehgr_tpu_torch.ops.kernels import registry, shift

    assert set(registry.OPS.values()) | {shift.learnable_shift_fwd,
                                         shift.learnable_shift_bwd} == \
        set(registry.KERNELS.values())
    before = profiling.launch_counts()
    assert {"action_stats/window", "action_apply/strip", "tsm_shift/reverse",
            "learnable_shift_bwd/strip", "int8_conv"} <= set(before)
    bwd = shift.learnable_shift_bwd
    monkeypatch.setattr(bwd, "launches", bwd.launches + 1)
    monkeypatch.setitem(bwd.route_launches, "strip",
                        bwd.route_launches["strip"] + 1)
    after = profiling.launch_counts()
    assert {k for k in after if after[k] != before[k]} == {
        "learnable_shift_bwd", "learnable_shift_bwd/strip"}
