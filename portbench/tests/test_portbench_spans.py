"""The program's spans in a profiled stretch (``spans.py``), and what they
leave of ``trace.reduce`` as it was: over kineto-like events made here, a
launch is charged by correlation id to the program span innermost at its
time (also from autograd's thread), idle time is split between the spans
and ``none``, and ``reduce``'s keys come out the same with and without the
program's spans.  On the CPU, the tiny cells' traced stretch holds the
program's spans once a call or step.  On the card, the hand-written
kernels' launch counters agree with the launches ``reduce`` counts in a
trace that kept every kernel's record (CUPTI now and then drops a run of
records; such a stretch is traced again):

    python -m pytest -q -m card portbench/tests/test_portbench_spans.py
"""

import json
import time

import pytest
import torch

from ehgr_tpu_torch.ops.kernels import registry
from portbench import run, spans, trace
from portbench.tests import tiny

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
KERNEL = "void stats_window_kernel<8>(float*)"


class Event:
    """The part of a kineto event that ``reduce`` and ``spans_of`` read."""

    def __init__(self, name, start, end, device=CPU, corr=0,
                 annotation=False, thread=1):
        self._name, self._start, self._end = name, start, end
        self._device, self._corr = device, corr
        self._annotation, self.thread = annotation, thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return self._device

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._annotation


def program_spans():
    """One step: ``ehgr.step`` 10-900 around ``forward`` 20-300 and
    ``backward`` 300-700, with their copies on the card's timeline, as a
    profiler on a card records them."""
    out = []
    for name, a, b in (("ehgr.step", 10, 900),
                       ("ehgr.step.forward", 20, 300),
                       ("ehgr.step.backward", 300, 700)):
        out.append(Event(name, a, b, annotation=True))
        out.append(Event(name, a + 5, b + 50, CUDA, annotation=True))
    return out


def device_work():
    """A launch in the forward on the calling thread (kernel 100-200), one
    in the backward from autograd's thread (kernel 650-800, past the
    backward's end), and a copy whose runtime call is outside any program
    span (950-980)."""
    return [Event(trace.STRETCH, 0, 1000),
            Event("cudaLaunchKernel", 50, 60, corr=1),
            Event(KERNEL, 100, 200, CUDA, corr=1),
            Event("cudaLaunchKernel", 400, 420, corr=2, thread=2),
            Event("aten::mm", 390, 430, thread=2),
            Event("elementwise_kernel<128, 4>", 650, 800, CUDA, corr=2),
            Event("cudaMemcpyAsync", 920, 930, corr=3),
            Event("Memcpy HtoD (Pageable -> Device)", 950, 980, CUDA,
                  corr=3)]


def test_launch_charged_by_correlation_to_innermost_span():
    got = spans.spans_of(device_work() + program_spans())
    assert got["ehgr.step.forward"]["launches"] == 1
    assert got["ehgr.step.forward"]["device_s"] == pytest.approx(100e-9)
    # launched from autograd's thread while the caller waits in backward
    assert got["ehgr.step.backward"]["launches"] == 1
    assert got["ehgr.step.backward"]["device_s"] == pytest.approx(150e-9)
    assert got["ehgr.step"]["launches"] == 0
    assert got["none"]["launches"] == 1
    assert got["none"]["device_s"] == pytest.approx(30e-9)
    assert {n: v["count"] for n, v in got.items()} == {
        "ehgr.step": 1, "ehgr.step.forward": 1, "ehgr.step.backward": 1,
        "none": 0}
    assert got["ehgr.step"]["host_s"] == pytest.approx(890e-9)
    assert got["none"]["host_s"] == pytest.approx(110e-9)


def test_idle_split_between_spans_and_none():
    got = spans.spans_of(device_work() + program_spans())
    # busy 100-200, 650-800, 950-980 of the window 0-1000
    want = {"none": 10 + 50 + 20, "ehgr.step": 10 + 100,
            "ehgr.step.forward": 80 + 100, "ehgr.step.backward": 350}
    for name, ns in want.items():
        assert got[name]["idle_s"] == pytest.approx(ns * 1e-9), name
    assert sum(v["idle_s"] for v in got.values()) == \
        pytest.approx((1000 - 280) * 1e-9)


def test_reduce_keys_unchanged_by_program_spans():
    plain = trace.reduce(device_work())
    spanned = trace.reduce(device_work() + program_spans())
    for key in ("busy_s", "window_s", "kernels", "device_ops"):
        assert spanned[key] == plain[key], key
    assert plain["kernels"] == {
        "action_stats": {"seconds": pytest.approx(100e-9), "launches": 1}}


def test_lost_launches_counts_launches_without_a_device_record():
    events = device_work() + [Event("cudaLaunchKernel", 500, 510, corr=9)]
    assert lost_launches(device_work()) == 0
    assert lost_launches(events) == 1


def test_program_annotation_on_the_card_is_never_busy():
    events = [Event(trace.STRETCH, 0, 1000),
              Event("ehgr.score", 0, 1000, CUDA, annotation=True),
              Event(KERNEL, 100, 200, CUDA, corr=1)]
    got = trace.reduce(events)
    assert got["busy_s"] == pytest.approx(100e-9)
    assert all(not name.startswith("ehgr.")
               for name, _ in got["device_ops"])


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_per_call_needs_its_kind_and_a_trace(kind):
    other = "train" if kind == "serve" else "serve"
    outer = spans.OUTER[kind]
    table = {outer: {"count": 2, "launches": 4},
             outer + ".copy": {"count": 2, "launches": 6},
             outer + "x": {"count": 2, "launches": 100},
             "none": {"count": 0, "launches": 1}}
    rec = {"kind": kind, "calls": 3, "trace": {"spans": table}}
    assert spans.per_call(rec, kind, outer, "launches") == 5.0
    assert spans.per_call(rec, kind, outer + ".copy", "launches") == 3.0
    assert spans.per_call(rec, other, outer, "launches") is None
    assert spans.per_call({**rec, "trace": None}, kind, outer,
                          "launches") is None
    assert spans.per_call({**rec, "trace": {"busy_s": 1.0}}, kind, outer,
                          "launches") is None
    assert spans.per_call({**rec, "trace": {"spans": {"none": {}}}}, kind,
                          outer, "launches") is None


# --- the program's spans in a traced stretch of a tiny cell ----------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("tiny"))


def lost_launches(events):
    """Kernel launch calls inside the stretch whose kernel has no device
    record: the trace lost records (CUPTI drops a run of them now and
    then)."""
    window, calls, recorded = None, [], set()
    for e in events:
        if trace._is_device(e):
            recorded.add(e.correlation_id())
        elif e.device_type() == CPU:
            if e.name() == trace.STRETCH:
                window = (e.start_ns(), e.start_ns() + e.duration_ns())
            elif "LaunchKernel" in e.name():
                calls.append((e.start_ns(), e.correlation_id()))
    lo, hi = window
    return sum(1 for at, corr in calls
               if lo <= at <= hi and corr not in recorded)


def traced_run(root, monkeypatch, name, device="cpu", dtype=None):
    """A traced run of a tiny cell (its kind's ``run``, without the
    metrics); returns each traced stretch's ``reduce`` record, with
    ``spans`` and ``lost`` (``lost_launches``), and the kernels' launch
    counters before and after it."""
    from ehgr_tpu_torch.utils import profiling

    if dtype is not None:
        path = root / "portbench" / "configs" / f"{name.split('.')[0]}.json"
        cfg = json.loads(path.read_text())
        cfg["model"]["dtype"] = dtype
        path.write_text(json.dumps(cfg))
    stretches = []
    profile_stretch, reduce = trace.profile_stretch, trace.reduce

    def counted(*a, **kw):
        before = profiling.launch_counts()
        out = profile_stretch(*a, **kw)
        stretches.append((out, before, profiling.launch_counts()))
        return out

    def with_spans(events):
        return {**reduce(events), "spans": spans.spans_of(events),
                "lost": lost_launches(events)}

    monkeypatch.setattr(trace, "profile_stretch", counted)
    monkeypatch.setattr(trace, "reduce", with_spans)
    cell = tiny.cell(root, name, trace=True)
    cell.device, cell.started = device, time.time()
    cell.kind().run(cell)
    return stretches


@pytest.mark.parametrize("name, calls, children", [
    (tiny.SERVE, 2, ("upload", "preprocess", "model")),
    (tiny.TRAIN, 1, ("copy", "forward", "backward", "update"))])
def test_tiny_stretch_holds_the_program_spans(root, monkeypatch, name,
                                              calls, children):
    (stretch, _, _), = traced_run(root, monkeypatch, name)
    got = stretch["spans"]
    outer = spans.OUTER["serve" if name == tiny.SERVE else "train"]
    assert {n: v["count"] for n, v in got.items() if n != "none"} == {
        outer: calls, **{f"{outer}.{c}": calls for c in children}}
    assert got[outer]["host_s"] >= sum(got[f"{outer}.{c}"]["host_s"]
                                       for c in children)
    kind = "serve" if name == tiny.SERVE else "train"
    read = spans.readings(got, kind)
    assert set(read) == {n for n, r in spans.READINGS.items()
                         if r[0] == kind}
    assert all(v >= 0 for v in read.values())


# --- on the card: the launch counters against the trace --------------------

# a counter of ``profiling.launch_counts`` -> the launch of
# ``work/kernels.py`` whose first kernel counts it in the trace.  The cells
# run bf16 (routes ``window``, ``strip``); on float32 the shift backward's
# ``sweep`` route also launches ``shift_sweep`` for dx, which the trace
# counts as a forward launch.
COUNTER_LAUNCH = {
    "action_stats/window": "action_stats",
    "action_apply/strip": "action_apply",
    "learnable_shift_fwd": "learnable_shift_fwd",
    "learnable_shift_bwd/strip": "learnable_shift_bwd",
    "tsm_shift": "tsm_shift",
}


@pytest.mark.card
@pytest.mark.parametrize("name", tiny.CELLS)
def test_launch_counters_match_the_trace(cuda_card, tmp_path, name):
    """On a trace that kept every kernel's record; one that lost records
    (``lost_launches``) is traced again, at most twice."""
    root = tiny.copy(tmp_path)
    run.prepare_process(root)
    for _ in range(3):
        with pytest.MonkeyPatch.context() as mp:
            (stretch, before, after), = traced_run(root, mp, name,
                                                   cuda_card, "bfloat16")
        if not stretch["lost"]:
            break
    else:
        pytest.fail(f"the trace lost kernel records in 3 stretches of 3 "
                    f"(last: {stretch['lost']})")
    delta = {k: after[k] - before[k] for k in after}
    want = {}
    for counter, launch in COUNTER_LAUNCH.items():
        if delta[counter]:
            want[launch] = want.get(launch, 0) + delta[counter]
    assert want, delta
    assert {k: v["launches"] for k, v in stretch["kernels"].items()} == \
        want, delta
    assert sum(delta[k] for k in COUNTER_LAUNCH) == sum(
        delta[k] for k in registry.KERNELS), delta
    launches = sum(v["launches"] for v in stretch["spans"].values())
    assert launches >= sum(want.values())
