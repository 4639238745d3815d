"""The training loop on the CPU: the port's ``run_training`` against
``ehgr_tpu.train.loop.run_training``, stage 1 (``mtmm``) then stage 2
(``sd``), and what crosses between the packages (a JAX train state resumed
by the port, the port's checkpoint read by the JAX loader), plus one
``remat`` step against JAX's.

Both loops run the model of ``tests/test_torch_train.py`` cut to one
bottleneck a stage (``tiny_resnet``) at T=4, 32^2, 5 classes, batch 4,
fp32, on the synthetic backend (8 train videos, 16 validation videos) with
one loader thread, dropout 0 (the two packages draw other random bits),
2 steps an epoch for 2 epochs, EMA 0.9 and ``lr_steps`` (0,) so the second
epoch is decayed.  Both start from one ``.pth`` of a JAX init; stage 2
starts from each side's own ``best`` with the exits of one JAX ``tsn_sd``
init (the two packages draw other initial weights).

Compared after each stage: every tensor of the final state (parameters and
their EMA as deltas from the stage's start, BN statistics, momentum) within
``MTMM_TOL`` / ``SD_TOL`` (the tiny model's ReLU kinks, see there); in a
tree where the two f32 runs differ beyond that, a float64 run of the JAX
loop decides by the card's fp32 gate (see ``X``): JAX's f32 gradient of the
loop's first batch lies 28% of its largest value from float64 at
layer3.0.downsample.0, the port's 6e-5, and that gap carries to the end of
both stages; each epoch's live and EMA validation metrics equal,
``best_top1`` and ``ema_best_top1`` equal, the same checkpoint tags
written, and the ``metrics.jsonl`` train loss within 1e-4.  Each loop runs
once a stage and module (``_RUNS``); the JAX states are recorded at each
checkpoint write."""

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from ehgr_tpu import configs as jc
from ehgr_tpu.configs import LossConfig as JLossConfig
from ehgr_tpu.configs import OptimConfig as JOptimConfig
from ehgr_tpu.data import factory as jfactory
from ehgr_tpu.models.torch_import import export_state_dict
from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu.train import loop as jloop
from ehgr_tpu.train.checkpoints import load_for_model as j_load_for_model
from ehgr_tpu.train.optim import build_optimizer as j_build_optimizer
from ehgr_tpu.train.steps import create_train_state as j_create_state
from ehgr_tpu.train.steps import make_train_step as j_make_train_step
from ehgr_tpu_torch import configs as pc
from ehgr_tpu_torch.data import factory as pfactory
from ehgr_tpu_torch.models.convert import (convert_train_state,
                                           state_dict_from_jax)
from ehgr_tpu_torch.train import loop as ploop
from ehgr_tpu_torch.train.checkpoints import CheckpointManager

from test_torch_train import (CLS, DEPTH, EMA, HW, LR, LR_STEPS, MEAN, N,
                              STD, T, _excess, _final, check_trajectory,
                              make_batches, one_thread, port_run,
                              tiny_resnet)

# (parameters, their EMA and the BN statistics; momentum): each stage's
# limits of test_k_steps_match_jax (test_torch_train_mtmm.py,
# test_torch_sd_steps.py: the tiny model's ReLU kinks)
MTMM_TOL = (3e-2, 3e-2)
SD_TOL = (3e-2, 1e-1)
# where the two f32 runs part beyond those limits, a float64 run of the JAX
# loop (``jax_float64_training``) decides by the rule of chip_smoke.py's
# fp32 train-step gate (PERF.md §2): over a tree's tensors, the port's
# errors from float64 (max |diff| over max |float64|) at the median and the
# 95th percentile within X times JAX's, its worst within WORST_X times
# JAX's worst, each plus GATE_TOL.  At this geometry the two f32 runs take
# ReLU kinks on other sides, at leaves that move with the torch thread
# count: after stage 1 JAX's f32 EMA lies up to 30% of a tensor's largest
# value from float64, the port's up to 43% (one thread)
X, WORST_X, GATE_TOL = 1.5, 3.0, 1e-3
STAGE = {"mtmm": ("ego_mtmm", "tsn_mtmm", MTMM_TOL),
         "sd": ("ego_sd", "tsn_sd", SD_TOL)}
TREES = ("state_dict", "ema_state_dict", "momentum")
_STATS = ("running_mean", "running_var")


def argv(run_dir, name, checkpoint):
    return ["--synthetic", "--clip_len", str(T), "--crop_size", str(HW),
            "--scale_size", str(HW), "--num_classes", str(CLS),
            "--batch_size", "4", "--synthetic_videos", "8", "--dropout", "0",
            "--epochs", "2", "--lr_steps", "0", "--ema_decay", "0.9",
            "--run_dir", run_dir, "--model_name", name,
            "--checkpoint_path", checkpoint]


def configs(stage, run_dir, checkpoint):
    """(JAX config, port config) of ``stage`` from one command line, one
    loader thread, fp32, a log line every step."""
    out = []
    for mod, name in ((jc, "jax"), (pc, "port")):
        cfg = mod.config_from_args(argv(run_dir, name, checkpoint),
                                   default_preset=STAGE[stage][0])
        out.append(cfg.replace(
            data=dataclasses.replace(cfg.data, num_workers=1),
            model=dataclasses.replace(cfg.model, dtype="float32"),
            run=dataclasses.replace(cfg.run, display=1)))
    return out


def flat_state(state):
    """A JAX ``TrainState`` (host) -> ``convert_train_state``'s input."""
    trees = {"params": state.params, "batch_stats": state.batch_stats,
             "ema_params": state.ema_params,
             "ema_batch_stats": state.ema_batch_stats,
             "momentum": state.opt_state.momentum,
             "hyper": state.opt_state.hyper}
    out = {(name,) + p: np.asarray(a) for name, tree in trees.items()
           for p, a in flatten_dict(tree).items()}
    out[("step",)] = np.asarray(state.step)
    return out


def jax_init_pth(arch, key, path):
    """The JAX ``arch``'s initial variables (tiny, ``key``) as a ``.pth``;
    returns the variables."""
    with tiny_resnet():
        model = j_variant(arch, num_class=CLS, num_segments=T,
                          partial_bn=False)
        v = jax.jit(lambda r: model.init(
            {"params": r}, jnp.zeros((1, T, HW, HW, 3)), train=False))(
                jax.random.key(key))
    torch.save({"state_dict": {k: torch.from_numpy(np.array(a))
                               for k, a in export_state_dict(v).items()}},
               path)
    return v


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "ts"}
                for line in f]


def _tags(run_dir, suffix):
    return sorted(f[f.index("_") + 1:-len(suffix)]
                  for f in os.listdir(run_dir) if f.endswith(suffix))


def jax_training(cfg, stage, replay=None):
    """The JAX loop's result (with the tags of its checkpoint writes under
    ``"tags"``) and what it saved: the payloads of the states it wrote as
    ``latest`` (stage 1: the first and the last) and, in stage 1, last as
    ``best``, and each validation's result (``"vals"``).  The writes are
    recorded, not made: orbax would write a few hundred MB that nothing
    here reads.  With ``replay`` (an earlier run's ``"vals"``) each
    validation returns the next of those instead of running."""
    saved = {"latest": [], "best": None, "tags": set(), "vals": []}
    pending = None if replay is None else iter(replay)
    real_validate = jloop.validate

    class Recording(jloop.CheckpointManager):
        def save(self, tag, state):
            payload = convert_train_state(flat_state(state))
            saved["tags"].add(tag)
            if tag == "latest":        # stage 2 needs its last alone
                saved["latest"] = saved["latest"][:stage == "mtmm"] + [
                    payload]
            elif tag == "best" and stage == "mtmm":
                saved["best"] = payload
            return self._path(tag)

    def validate(*args):
        out = real_validate(*args) if pending is None else next(pending)
        saved["vals"].append(out)
        return out

    with pytest.MonkeyPatch.context() as mp, tiny_resnet():
        mp.setattr(jloop, "CheckpointManager", Recording)
        mp.setattr(jloop, "validate", validate)
        res = jloop.run_training(
            cfg, stage, *jfactory.build_train_datasets(cfg, stage),
            max_steps_per_epoch=2)
    res["tags"] = sorted(saved.pop("tags"))
    return res, saved


def port_training(cfg, stage):
    """The port's loop on one torch thread (many spin against the other
    test processes)."""
    with tiny_resnet(), one_thread():
        return ploop.run_training(
            cfg, stage, *pfactory.build_train_datasets(cfg, stage),
            max_steps_per_epoch=2, device="cpu")


class _Float64Names:
    """``jax.numpy`` with ``float32`` read as ``float64``.  In place of
    ``jnp`` in the JAX package's modules it turns every cast and
    accumulator that names float32 (the BN statistics, the ACTION products,
    the heads' outputs, the input normalization, the schedule's scalars)
    into float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def jax_float64_training(cfg, stage, replay):
    """``jax_training`` in float64, the reference the two f32 runs are held
    to: x64 on, the model at float64 in the plain ACTION formulation, every
    ``jnp.float32`` of the JAX package read as float64 and the variables
    cast to float64 before the train state is made.  It replays the f32
    JAX run's validations (``replay``), so its ``best`` is the epoch that
    run and the port chose (their validations are held equal below).
    Called after the stage's f32 run, which has imported every module the
    loop reaches."""
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, dtype="float64", action_fused="none"))

    def cast(a):
        return (a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
                else a)

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for name, mod in list(sys.modules.items()):
            if name.startswith("ehgr_tpu.") and getattr(mod, "jnp",
                                                        None) is jnp:
                mp.setattr(mod, "jnp", _Float64Names())
        mp.setattr(jloop, "create_train_state",
                   lambda v, tx: j_create_state(jax.tree.map(cast, v), tx))
        return jax_training(cfg, stage, replay)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def sd_start(state_dict, exits, path):
    """A stage-2 start: ``state_dict`` (a stage-1 ``best``) with the exits
    of ``exits`` (a ``tsn_sd`` init) written as a ``.pth``."""
    sd = dict(state_dict)
    sd.update({k: v for k, v in exits.items()
               if k.startswith(("scala", "middle_fc"))})
    torch.save({"state_dict": sd}, path)
    return str(path)


_RUNS = {}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("loop")
    yield path
    shutil.rmtree(path, ignore_errors=True)      # checkpoints of ~200 MB
    _RUNS.clear()


@pytest.fixture
def runs(root):
    """stage -> dict of both loops' results, each run once a module."""
    def get(stage):
        if stage in _RUNS:
            return _RUNS[stage]
        if stage == "mtmm":
            jv = jax_init_pth("tsn_mtmm", 42, root / "init.pth")
            starts = {"jax": str(root / "init.pth"),
                      "port": str(root / "init.pth")}
        else:
            mtmm = get("mtmm")
            jax_init_pth("tsn_sd", 43, root / "sd_init.pth")
            exits = _load(root / "sd_init.pth")["state_dict"]
            j_best = mtmm["jax_saves"]["best"]
            starts = {
                "jax": sd_start(j_best["state_dict"], exits,
                                root / "jax_sd_start.pth"),
                "port": sd_start(_load(os.path.join(
                    mtmm["port"]["run_dir"], "port_best_ckpt.pth"))
                    ["state_dict"], exits, root / "port_sd_start.pth")}
            jv = None
        jcfg, _ = configs(stage, str(root / "jax"), starts["jax"])
        _, pcfg = configs(stage, str(root / "port"), starts["port"])
        jres, jsaves = jax_training(jcfg, stage)
        pres = port_training(pcfg, stage)
        _RUNS[stage] = dict(jax=jres, jax_saves=jsaves, port=pres,
                            starts={k: _load(v)["state_dict"]
                                    for k, v in starts.items()},
                            pcfg=pcfg, jax_variables=jv, root=root)
        return _RUNS[stage]
    return get


def float64_result(r, stage):
    """(final payload, start) of the JAX loop in float64 over the stage,
    from the init (MTMM) or from its own MTMM ``best`` with the common exits
    (SD); run once a stage and module.  The payloads are f32
    (``convert_train_state``): a rounding of 6e-8 of each value."""
    if "f64" not in r:
        root = r["root"]
        start = str(root / "init.pth")
        if stage == "sd":
            mtmm = _RUNS["mtmm"]
            float64_result(mtmm, "mtmm")
            start = sd_start(mtmm["f64_best"],
                             _load(root / "sd_init.pth")["state_dict"],
                             root / "f64_sd_start.pth")
        cfg, _ = configs(stage, str(root / "f64"), start)
        _, saves = jax_float64_training(cfg, stage,
                                        r["jax_saves"]["vals"])
        if stage == "mtmm":
            r["f64_best"] = saves["best"]["state_dict"]
        r["f64"] = (saves["latest"][-1], _load(start)["state_dict"])
        shutil.rmtree(root / "f64")
    return r["f64"]


def _leaf_excess(tree, key, a, b, tol):
    """``_excess`` of one tensor of two (payload, start) pairs: parameters
    and their EMA as deltas from each side's start (plus ULPS roundings of
    the start), BN statistics as values, the momentum with its own limit."""
    (pa, sa), (pb, sb) = a, b
    g, w = (p[tree][key].double().numpy() for p in (pa, pb))
    if tree == "momentum":
        return _excess(g, w, None, tol[1])
    if key.endswith(_STATS):
        return _excess(g, w, None, tol[0])
    start = sb[key].double().numpy()
    return _excess(g - sa[key].double().numpy(), w - start, start, tol[0])


def check_state(port, jax_, tol, float64=None):
    """Every tensor of the port's final state within the stage's limits of
    JAX's; each argument a (payload, start state_dict) pair.  In a tree
    where a tensor is not, ``float64()`` (the JAX loop in float64, the same
    pair) decides by the gate above; its readings are printed (``-s``).
    The step counters equal."""
    assert port[0]["step"] == jax_[0]["step"]
    ref = None
    for tree in TREES:
        assert sorted(port[0][tree]) == sorted(jax_[0][tree]), tree
        keys = list(jax_[0][tree])
        apart = {k: e for k in keys
                 if (e := _leaf_excess(tree, k, port, jax_, tol)) > 1.0}
        if not apart:
            continue
        assert float64 is not None, (tree, apart)
        ref = ref or float64()
        errs = {who: np.array([_leaf_excess(tree, k, side, ref, (1.0, 1.0))
                               for k in keys])
                for who, side in (("port", port), ("jax", jax_))}
        for q, x in ((50, X), (95, X), (100, WORST_X)):
            mine, theirs = (np.percentile(errs[w], q) for w in ("port",
                                                                "jax"))
            print(f"{tree} q{q}: port {mine:.4g}, jax {theirs:.4g}, "
                  f"limit {x * theirs + GATE_TOL:.4g}")
            assert mine <= x * theirs + GATE_TOL, (tree, q, mine, theirs,
                                                   apart)


class TestLoopMatchesJax:
    @pytest.mark.parametrize("stage", ["mtmm", "sd"])
    def test_final_state(self, runs, stage):
        r = runs(stage)
        got = _load(os.path.join(r["port"]["run_dir"],
                                 "port_latest_ckpt.pth"))
        want = r["jax_saves"]["latest"][-1]
        assert got["step"] == 4
        check_state((got, r["starts"]["port"]), (want, r["starts"]["jax"]),
                    STAGE[stage][2], lambda: float64_result(r, stage))

    @pytest.mark.parametrize("stage", ["mtmm", "sd"])
    def test_validation_and_records(self, runs, stage):
        """Each epoch's record: the same keys, the live and EMA validation
        metrics and the train top-1 equal, the train loss within 1e-4."""
        r = runs(stage)
        got, want = (_records(r[k]["run_dir"]) for k in ("port", "jax"))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            np.testing.assert_allclose(g.pop("train_loss"),
                                       w.pop("train_loss"), rtol=1e-4)
            assert g == w
        for k in ("best_top1", "ema_best_top1", "final_top1",
                  "final_train_loss"):
            np.testing.assert_allclose(r["port"][k], r["jax"][k], rtol=1e-4)
        if stage == "sd":
            assert {f"mid{i}_top1" for i in (1, 2, 3)} <= set(r["port"])

    @pytest.mark.parametrize("stage", ["mtmm", "sd"])
    def test_checkpoint_tags(self, runs, stage):
        r = runs(stage)
        got = _tags(r["port"]["run_dir"], "_ckpt.pth")
        assert got == r["jax"]["tags"]
        assert {"latest", "best", "ema_best"} <= set(got)

    def test_resume_from_a_jax_state(self, runs, root):
        """JAX's state after epoch 1, converted and written by the port's
        ``CheckpointManager``, resumed by the port to epoch 2: JAX's
        uninterrupted epoch 2, within the MTMM limits."""
        r = runs("mtmm")
        after_one = r["jax_saves"]["latest"][0]
        assert after_one["step"] == 2
        path = CheckpointManager(root / "from_jax", "jax").save(
            "latest", after_one)
        cfg = r["pcfg"]
        cfg = cfg.replace(run=dataclasses.replace(
            cfg.run, checkpoint_path=path, resume_full=True,
            run_dir=str(root / "resumed")))
        res = port_training(cfg, "mtmm")
        got = _load(os.path.join(res["run_dir"], "port_latest_ckpt.pth"))
        want = r["jax_saves"]["latest"][-1]
        check_state((got, r["starts"]["jax"]), (want, r["starts"]["jax"]),
                    MTMM_TOL)
        assert len(_records(res["run_dir"])) == 1      # epoch 2 alone
        shutil.rmtree(root / "from_jax")
        shutil.rmtree(root / "resumed")

    def test_jax_loader_reads_the_port_best(self, runs):
        """The port's ``best`` through the JAX package's ``load_for_model``
        (the ``.pth`` path): the port's live weights, bitwise."""
        r = runs("mtmm")
        path = os.path.join(r["port"]["run_dir"], "port_best_ckpt.pth")
        v = j_load_for_model(path, r["jax_variables"], strict=True)
        got = state_dict_from_jax({k: np.asarray(a)
                                   for k, a in flatten_dict(v).items()})
        want = _load(path)["state_dict"]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert torch.equal(got[k], w), k


def test_remat_step_matches_jax():
    """One ``tsn_mtmm`` step with ``remat`` (partial BN off, 'vjp') in
    both packages from the same weights and batch, as
    ``test_torch_train_mtmm``'s first-step check holds it."""
    batch = make_batches(0, True)[:1]
    with tiny_resnet():
        model = j_variant("tsn_mtmm", num_class=CLS, num_segments=T,
                          partial_bn=False, dropout=0.0, action_fused="vjp",
                          remat=True)
        v = jax.jit(lambda r: model.init(
            {"params": r}, jnp.zeros((N, T, HW, HW, 3)), train=False))(
                jax.random.key(42))
        tx, _ = j_build_optimizer(
            v["params"], JOptimConfig(lr=LR, lr_steps=LR_STEPS),
            steps_per_epoch=1)
        step = j_make_train_step(
            model, tx, stage="mtmm", loss_cfg=JLossConfig(depth_size=DEPTH),
            ema_decay=EMA, mean=MEAN, std=STD, donate=False)
        state, m = step(j_create_state(v, tx),
                        {k: jnp.asarray(a) for k, a in batch[0].items()},
                        jax.random.key(0))
    flat0 = {(c,) + p: np.asarray(a) for c in ("params", "batch_stats")
             for p, a in flatten_dict(v[c]).items()}
    port = port_run("tsn_mtmm", "mtmm", 1, "vjp", flat0, batch,
                    on_model=lambda mdl: setattr(mdl.base_model, "remat",
                                                 True))
    assert port[0].base_model.remat
    check_trajectory((flat0, [{k: float(a) for k, a in m.items()}],
                      _final(state)), port, "mtmm")
