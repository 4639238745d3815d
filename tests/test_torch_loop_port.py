"""The port's training loop against itself on the CPU, and its small
pieces against the JAX package's: ``select_batch``, the meters and the
metrics logger; a resumed run bitwise an uninterrupted one with dropout
0.5; deferred checkpoint writes (``ckpt_light``); the checkpoint manager;
``remat`` against the plain step; the three trainer CLIs; and the guards.

The loops run ``tsn_mtmm`` cut to one bottleneck a stage (``tiny_resnet``)
at T=4, 32^2, 5 classes, batch 4, fp32, on the synthetic backend with one
loader thread, 2 steps an epoch, on one torch thread (``single_thread``:
the port is held against itself).  Each run happens once a module
(``_RUNS``)."""

import contextlib
import dataclasses
import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ehgr_tpu.train import loop as jloop
from ehgr_tpu.train.optim import adopt_config_hyper as j_adopt
from ehgr_tpu.train.optim import sgd_policies as j_sgd_policies
from ehgr_tpu.utils import meters as jmeters
from ehgr_tpu.utils import metrics_log as jmetrics_log
from ehgr_tpu_torch import configs as pc
from ehgr_tpu_torch.cli import test as cli_test
from ehgr_tpu_torch.cli import train as cli_train
from ehgr_tpu_torch.cli import train_mtmm as cli_train_mtmm
from ehgr_tpu_torch.cli import train_mtmm_sd as cli_train_mtmm_sd
from ehgr_tpu_torch.cli import train_sd as cli_train_sd
from ehgr_tpu_torch.data import factory as pfactory
from ehgr_tpu_torch.models import resnet as t_resnet
from ehgr_tpu_torch.models.factory import build_model
from ehgr_tpu_torch.models.tsn import variant
from ehgr_tpu_torch.train import loop as ploop
from ehgr_tpu_torch.train.checkpoints import (CheckpointManager,
                                              load_for_model,
                                              state_payload)
from ehgr_tpu_torch.train.optim import (SgdPolicies, adopt_config_hyper,
                                        build_optimizer)
from ehgr_tpu_torch.train.steps import create_train_state, make_train_step
from ehgr_tpu_torch.utils import meters as pmeters
from ehgr_tpu_torch.utils import metrics_log as pmetrics_log

from test_torch_train import (CLS, DEPTH, EMA, HW, MEAN, STD, T,
                              make_batches, tiny_resnet)
from test_torch_train import single_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("single_thread")
TREES = ("state_dict", "ema_state_dict", "momentum")
ARGV = ["--synthetic", "--clip_len", str(T), "--crop_size", str(HW),
        "--scale_size", str(HW), "--num_classes", str(CLS), "--batch_size",
        "4", "--synthetic_videos", "8", "--epochs", "2", "--lr_steps", "0",
        "--ema_decay", "0.9", "--device", "cpu"]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "ts"}
                for line in f]


def assert_payloads_equal(a, b):
    assert a["step"] == b["step"]
    assert a["schedule"] == b["schedule"]
    for tree in TREES:
        assert sorted(a[tree]) == sorted(b[tree]), tree
        for k, v in a[tree].items():
            assert torch.equal(v, b[tree][k]), (tree, k)


def mtmm_config(run_dir, name, **run):
    """``ego_mtmm`` at the tiny geometry, dropout 0.5 (the preset's), one
    loader thread, fp32; ``run`` sets fields of ``RunConfig``."""
    cfg = pc.config_from_args(
        [a for a in ARGV if a not in ("--device", "cpu")]
        + ["--run_dir", run_dir, "--model_name", name],
        default_preset="ego_mtmm")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, num_workers=1),
        model=dataclasses.replace(cfg.model, dtype="float32"),
        run=dataclasses.replace(cfg.run, **run))


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.loop = []

    def emit(self, record):
        if hasattr(record, "loop"):
            self.loop.append(record.loop)


def train(cfg, epochs=None):
    """The loop's result, with the ``loop`` fields of its log records
    under ``"events"``."""
    log = logging.getLogger(ploop.__name__)
    seen = _Records()
    log.addHandler(seen)
    try:
        with tiny_resnet():
            res = ploop.run_training(
                cfg, "mtmm", *pfactory.build_train_datasets(cfg, "mtmm"),
                max_steps_per_epoch=2, epochs=epochs, device="cpu")
    finally:
        log.removeHandler(seen)
    return {**res, "events": seen.loop}


_RUNS = {}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("loop_port")
    yield path
    shutil.rmtree(path, ignore_errors=True)      # checkpoints of ~160 MB
    _RUNS.clear()


@pytest.fixture
def runs(root):
    """name -> result of one of the module's port runs: ``full`` (2
    epochs), ``first`` (1 epoch, depth images at every step), ``resumed``
    (``first``'s ``latest`` to 2 epochs, ``resume_full``) and ``light``
    (2 epochs, ``ckpt_light``)."""
    def get(name):
        if name not in _RUNS:
            d = str(root / name)
            if name == "full":
                res = train(mtmm_config(d, "m"))
            elif name == "first":
                res = train(mtmm_config(d, "m", display=1,
                                        save_depth_images=True), epochs=1)
            elif name == "resumed":
                ckpt = os.path.join(get("first")["run_dir"],
                                    "m_latest_ckpt.pth")
                res = train(mtmm_config(d, "m", checkpoint_path=ckpt,
                                        resume_full=True))
            else:
                res = train(mtmm_config(d, "m", ckpt_light=True))
            _RUNS[name] = res
        return _RUNS[name]
    return get


class TestResume:
    def test_resumed_run_is_bitwise_the_full_run(self, runs):
        """1 epoch, then ``resume_full`` to 2, with dropout 0.5: every
        tensor of the last state, the step counter, the schedule and the
        second epoch's metrics record equal to the uninterrupted run's."""
        full, resumed = runs("full"), runs("resumed")
        for tag in ("latest",):
            assert_payloads_equal(
                _load(os.path.join(resumed["run_dir"], f"m_{tag}_ckpt.pth")),
                _load(os.path.join(full["run_dir"], f"m_{tag}_ckpt.pth")))
        assert _records(resumed["run_dir"]) == _records(full["run_dir"])[1:]
        assert resumed["final_train_loss"] == full["final_train_loss"]

    def test_loop_events(self, runs):
        """The resumed run restores step 2 (epoch 1) and trains epoch 1
        alone; the full run logs each epoch's train part and validation
        and each checkpoint write, with its bytes."""
        ev = runs("resumed")["events"]
        assert [(e["step"], e["epoch"]) for e in ev
                if e["event"] == "restore"] == [(2, 1)]
        assert [(e["epoch"], e["steps"], e["clips"]) for e in ev
                if e["event"] == "train"] == [(1, 2, 8)]
        ev = runs("full")["events"]
        assert [e["event"] for e in ev if e["epoch"] == 0] == [
            "train", "save", "validate", "save", "save"]
        saves = [e for e in ev if e["event"] == "save"]
        assert [e["tag"] for e in saves][:3] == ["latest", "best",
                                                 "ema_best"]
        assert all(e["bytes"] > 0 and e["seconds"] >= 0 for e in saves)

    def test_dropout_masks_depend_on_the_step(self):
        """The seed of each step's masks is a function of (seed, step):
        equal for equal arguments, different across steps and seeds."""
        seeds = {(s, k): ploop.step_seed(s, k) for s in (1, 2)
                 for k in range(4)}
        assert ploop.step_seed(1, 3) == seeds[1, 3]
        assert len(set(seeds.values())) == len(seeds)

    def test_ckpt_light_writes_the_same_files(self, runs):
        """Deferred writes: the same ``latest``, ``best`` and ``ema_best``
        as the run that writes every epoch."""
        full, light = runs("full"), runs("light")
        for tag in ("latest", "best", "ema_best"):
            assert_payloads_equal(
                _load(os.path.join(light["run_dir"], f"m_{tag}_ckpt.pth")),
                _load(os.path.join(full["run_dir"], f"m_{tag}_ckpt.pth")))

    def test_depth_images_written(self, runs):
        files = sorted(f for f in os.listdir(runs("first")["run_dir"])
                       if f.endswith(".jpg"))
        assert files == ["g_depth_gt_1.jpg", "g_depth_gt_2.jpg",
                         "g_depth_out_1.jpg", "g_depth_out_2.jpg"]

    def test_best_file_loads_the_live_weights(self, runs):
        """``load_for_model`` of a full-state file takes its live weights,
        not the EMA (as the JAX loader does), and skips no key."""
        path = os.path.join(runs("full")["run_dir"], "m_best_ckpt.pth")
        payload = _load(path)
        with tiny_resnet():
            m = variant("tsn_mtmm", num_class=CLS, num_segments=T,
                        device="cpu")
        assert load_for_model(path, m, strict=True) == []
        sd = m.state_dict()
        assert all(torch.equal(sd[k], v)
                   for k, v in payload["state_dict"].items())
        assert any(not torch.equal(payload["ema_state_dict"][k], v)
                   for k, v in payload["state_dict"].items())


class TestCheckpointManager:
    def _state(self, seed):
        with tiny_resnet():
            m = variant("tsn", num_class=CLS, num_segments=T, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
        opt, _ = build_optimizer(m, pc.OptimConfig(), steps_per_epoch=3)
        state = create_train_state(m, opt)
        for v in state.opt_state.momentum.values():
            v.normal_(generator=torch.Generator().manual_seed(seed))
        state.step = state.opt_state.step = 7 + seed
        return state, opt

    def test_save_restore_round_trip(self, tmp_path):
        src, opt = self._state(1)
        mgr = CheckpointManager(tmp_path, "x")
        assert not mgr.exists("latest")
        path = mgr.save("latest", state_payload(src, opt))
        assert path == mgr.path("latest") == str(tmp_path /
                                                 "x_latest_ckpt.pth")
        assert mgr.exists("latest") and os.listdir(tmp_path) == [
            "x_latest_ckpt.pth"]
        dst, _ = self._state(2)
        assert mgr.restore("latest", dst) == opt.schedule()
        assert dst.step == dst.opt_state.step == 8
        assert_payloads_equal(state_payload(dst, opt),
                              state_payload(src, opt))

    def test_crash_mid_write_keeps_the_old_file(self, tmp_path, monkeypatch):
        state, opt = self._state(1)
        mgr = CheckpointManager(tmp_path, "x")
        mgr.save("latest", state_payload(state, opt))
        before = open(mgr.path("latest"), "rb").read()

        def torn(obj, f):
            f.write(b"partial")
            raise OSError("disk full")

        monkeypatch.setattr(torch, "save", torn)
        with pytest.raises(OSError, match="disk full"):
            mgr.save("latest", state_payload(state, opt))
        assert os.listdir(tmp_path) == ["x_latest_ckpt.pth"]
        assert open(mgr.path("latest"), "rb").read() == before

    def test_restore_into_another_model_raises(self, tmp_path):
        state, opt = self._state(1)
        mgr = CheckpointManager(tmp_path, "x")
        mgr.save("latest", state_payload(state, opt))
        with tiny_resnet():
            m = variant("tsn_mtmm", num_class=CLS, num_segments=T,
                        device="cpu")
        other = create_train_state(m, build_optimizer(
            m, pc.OptimConfig())[0])
        with pytest.raises(KeyError, match="global_decoder"):
            mgr.restore("latest", other)

    def test_schedule_warning_names_the_jax_fields(self, caplog):
        """A resume under another schedule warns naming the same fields,
        in the same words, as the JAX package's ``adopt_config_hyper``."""
        labels = {"a": "normal_weight", "b": "lr5_weight"}
        kw = [dict(base_lr=0.1, momentum=0.9, lr_steps=(2, 4), gamma=0.1,
                   steps_per_epoch=3),
              dict(base_lr=0.2, momentum=0.8, lr_steps=(2, 5), gamma=0.1,
                   steps_per_epoch=3)]
        params = {"a": jnp.zeros(2), "b": jnp.zeros(2)}
        j_states = [j_sgd_policies(labels, **k).init(params) for k in kw]
        p_opts = [SgdPolicies(labels, **k) for k in kw]
        log = logging.getLogger("schedule_test")
        with caplog.at_level(logging.WARNING, logger="schedule_test"):
            j_adopt(j_states[0], j_states[1], log)
            diffs = adopt_config_hyper(p_opts[0].schedule(), p_opts[1], log)
        j_msg, p_msg = (r.getMessage() for r in caplog.records)
        assert p_msg == j_msg
        assert diffs[:2] == ["momentum", "lr_steps"] and all(
            d.startswith("lr[") for d in diffs[2:])
        assert adopt_config_hyper(p_opts[1].schedule(), p_opts[1]) == []


class TestRemat:
    def _step(self, remat, flat_batch, keep=True, monkeypatch=None):
        with tiny_resnet():
            m = variant("tsn_mtmm", num_class=CLS, num_segments=T,
                        partial_bn=False, dropout=0.0, action_fused="vjp",
                        remat=remat, device="cpu",
                        generator=torch.Generator().manual_seed(5))
        if not keep:
            monkeypatch.setattr(t_resnet, "_buffers_kept",
                                lambda block: contextlib.nullcontext())
        opt, _ = build_optimizer(m, pc.OptimConfig())
        state = create_train_state(m, opt)
        step = make_train_step(m, opt, stage="mtmm",
                               loss_cfg=pc.LossConfig(depth_size=DEPTH),
                               ema_decay=EMA, mean=MEAN, std=STD)
        _, metrics = step(state, flat_batch)
        grads = {k: p.grad.clone() for k, p in m.named_parameters()}
        return float(metrics["loss"]), grads, dict(state.batch_stats)

    def test_remat_step_equals_the_plain_step(self, monkeypatch):
        """Partial BN off, so every BN trains: the loss and gradients of a
        rematerialised step within 1e-6 of the plain step's, the BN
        running statistics bitwise equal.  Without the buffers kept around
        the recompute, the statistics take the batch twice."""
        batch = make_batches(0, True, n=4)[0]
        loss, grads, stats = self._step(False, batch)
        r_loss, r_grads, r_stats = self._step(True, batch)
        assert r_loss == loss
        for k, g in grads.items():
            scale = max(g.abs().max().item(), 1e-30)
            assert (r_grads[k] - g).abs().max().item() <= 1e-6 * scale, k
        assert all(torch.equal(r_stats[k], v) for k, v in stats.items())
        _, _, twice = self._step(True, batch, keep=False,
                                 monkeypatch=monkeypatch)
        moved = [k for k, v in stats.items() if not torch.equal(twice[k], v)]
        assert any(k.endswith("running_mean") for k in moved)
        assert any("action_p3_bn1" in k for k in moved)

    def test_remat_from_the_config(self):
        cfg = pc.get_preset("ego_mtmm")
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, remat=True, num_classes=CLS, num_segments=T))
        with tiny_resnet():
            m = build_model(cfg.model, device="cpu")
        assert m.base_model.remat


class TestHostPieces:
    @pytest.mark.parametrize("stage", ["baseline", "mtmm", "sd", "mtmm_sd"])
    @pytest.mark.parametrize("modal", ["rgb_depth", "rgb_depthest"])
    def test_select_batch_matches_jax(self, stage, modal):
        rng = np.random.default_rng(3)
        batch = {k: rng.integers(0, 256, (2, T, 8, 8, c), dtype=np.uint8)
                 for k, c in (("rgb", 3), ("depth", 1), ("depth_est", 1),
                              ("n_depth", 1), ("n_depth_est", 1))}
        batch["label"] = rng.integers(0, CLS, (2,))
        got = ploop.select_batch(batch, stage, modal)
        want = jloop.select_batch(batch, stage, modal)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))

    def test_meters_match_jax(self):
        vals = [(0.5, 4), (1.25, 2), (3.0, 1), (-2.0, 3)]
        meters = [pmeters.AverageMeter(), jmeters.AverageMeter()]
        for v, n in vals:
            for m in meters:
                m.update(v, n)
            assert vars(meters[0]) == vars(meters[1])
        timer = pmeters.StepTimer()
        timer.data_ready()
        timer.step_done()
        assert timer.data_time.count == timer.batch_time.count == 1
        assert timer.batch_time.val >= timer.data_time.val >= 0.0

    def test_metrics_logger_matches_jax(self, tmp_path, monkeypatch):
        monkeypatch.delenv("WANDB_MODE", raising=False)
        recs = [({"epoch": 0, "val_final_top1": 12.5}, 0),
                ({"train_loss": 1.5}, None)]
        for mod in (pmetrics_log, jmetrics_log):
            d = tmp_path / mod.__name__
            d.mkdir()
            log = mod.MetricsLogger(str(d), name="x")
            for rec, step in recs:
                log.log(rec, step=step)
            log.close()
        got, want = (_records(tmp_path / mod.__name__)
                     for mod in (pmetrics_log, jmetrics_log))
        assert got == want == [{"step": 0, "epoch": 0,
                                "val_final_top1": 12.5},
                               {"train_loss": 1.5}]


class TestCli:
    E2E = ["--synthetic", "--epochs", "1", "--batch_size", "2",
           "--clip_len", "4", "--crop_size", "32", "--scale_size", "32",
           "--num_classes", "5", "--synthetic_videos", "4", "--clip_num",
           "2", "--lr", "0.01", "--is_shift"]

    def test_train_then_test(self, tmp_path):
        """``cli.train`` with ``tests/test_e2e.py``'s flags on the CPU, then
        ``cli.test`` on its ``best``."""
        argv = self.E2E + ["--run_dir", str(tmp_path), "--model_name", "bk",
                           "--device", "cpu"]
        with tiny_resnet():
            res = cli_train.main(argv)
            assert np.isfinite(res["final_train_loss"])
            best = os.path.join(res["run_dir"], "bk_best_ckpt.pth")
            assert sorted(f for f in os.listdir(res["run_dir"])
                          if f.endswith(".pth")) == [
                "bk_best_ckpt.pth", "bk_ema_best_ckpt.pth",
                "bk_latest_ckpt.pth"]
            out = cli_test.main(argv + ["--checkpoint_path", best])
        assert out["n_videos"] == 32
        assert 0.0 <= out["final_top1"] <= 100.0

    @pytest.mark.parametrize("cli", [cli_train, cli_train_mtmm,
                                     cli_train_sd, cli_train_mtmm_sd])
    def test_trainers_default_to_cuda(self, cli, tmp_path):
        """Without ``--device`` a trainer asks for CUDA and raises on a
        machine without it, before it writes anything."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(self.E2E + ["--run_dir", str(tmp_path)])
        assert os.listdir(tmp_path) == []


class TestGuards:
    def test_joint_stage_raises(self, tmp_path):
        """The stage guard: an unknown stage raises before the loop writes
        anything; the joint stage is one the loop trains
        (tests/test_torch_joint.py runs it through its CLI)."""
        cfg = mtmm_config(str(tmp_path), "j")
        assert "mtmm_sd" in ploop.STAGES
        with pytest.raises(ValueError, match="unknown stage"):
            ploop.run_training(cfg, "bogus", None, None, device="cpu")
        assert os.listdir(tmp_path) == []

    def test_run_training_defaults_to_cuda(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ploop.run_training(mtmm_config(str(tmp_path), "c"), "mtmm",
                               None, None)
        assert os.listdir(tmp_path) == []

    def test_orbax_directory_raises_naming_the_export(self, tmp_path):
        with tiny_resnet():
            m = variant("tsn", num_class=CLS, num_segments=T, device="cpu")
        with pytest.raises(NotImplementedError,
                           match="export_state_dict.*"):
            load_for_model(str(tmp_path), m)
