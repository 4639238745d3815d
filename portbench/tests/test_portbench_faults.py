"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the tiny cells on the CPU, each
fault a cell can have planted in the program.  Serve: an answer altered
where it is produced; half of each video's clips left out, the vote taken
over the rest.  Train: a step that returns its state unchanged; half of
the batch left out, the mean taken over the rest.  The sound program
passes on the same cells and seeds."""

import time

import pytest
import torch

from portbench import harness, run
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("tiny"))


def verdict(root, name, seed=11):
    cell = tiny.cell(root, name, seed=seed)
    cell.started = time.time()
    return run.run_cell(cell, harness.load_benchmark(root))


@pytest.mark.parametrize("name", tiny.CELLS)
def test_sound_program_is_correct(root, name):
    result = verdict(root, name)
    assert result["correct"], result["compared"]


def _wrap_scorer(monkeypatch, change):
    from ehgr_tpu_torch.eval import inference

    make = inference.make_score_fn

    def broken(*a, **kw):
        score = make(*a, **kw)
        return lambda frames: change(score, frames)

    monkeypatch.setattr(inference, "make_score_fn", broken)


def _altered(score, frames):
    p = score(frames).clone()
    p[0] = p[0].roll(1)
    return p


def _half_clips(score, frames):
    return score(frames[:, :frames.shape[1] // 2])


@pytest.mark.parametrize("name", [tiny.SERVE, tiny.TSM_SERVE])
@pytest.mark.parametrize("fault", [_altered, _half_clips])
def test_serve_fault_is_caught(root, monkeypatch, name, fault):
    _wrap_scorer(monkeypatch, fault)
    result = verdict(root, name)
    assert not result["correct"], result["compared"]


def _state_unchanged(monkeypatch):
    from ehgr_tpu_torch.train import optim, steps

    monkeypatch.setattr(optim.SgdPolicies, "step",
                        lambda self, *a, **kw: None)
    monkeypatch.setattr(steps, "ema_update", lambda *a, **kw: None)


def _half_batch(monkeypatch):
    from ehgr_tpu_torch.train import steps

    make = steps.make_train_step

    def broken(*a, **kw):
        step = make(*a, **kw)

        def half(state, batch, generator=None):
            n = len(batch["label"]) // 2
            return step(state, {k: v[:n] for k, v in batch.items()},
                        generator)
        return half

    monkeypatch.setattr(steps, "make_train_step", broken)


@pytest.mark.parametrize("name", [tiny.TRAIN, tiny.TSM_TRAIN])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_train_fault_is_caught(root, monkeypatch, name, fault):
    fault(monkeypatch)
    result = verdict(root, name)
    assert not result["correct"], result["compared"]


def _in_mode(root, name, mode):
    from portbench import controls, correct

    cell = tiny.cell(root, name, seed=13)
    cell.started = time.time()
    out = controls.run(cell, mode)
    return correct.verdict(out["values"], cell.limits)


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_is_not_correct(root, name):
    from portbench import controls

    kind = "serve" if name in (tiny.SERVE, tiny.TSM_SERVE) else "train"
    v = _in_mode(root, name, controls.CONTROL[kind])
    assert not v["ok"], v["checks"]


@pytest.mark.parametrize("name", [tiny.TRAIN, tiny.TSM_TRAIN])
@pytest.mark.parametrize("mode", ["plain", "fp32"])
def test_witnesses_of_the_program_are_correct(root, name, mode):
    v = _in_mode(root, name, mode)
    assert v["ok"], v["checks"]
