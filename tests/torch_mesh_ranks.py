"""Rank functions of ``tests/test_torch_parallel.py``.

``run_ranks`` spawns one process a rank and imports the rank function there
by name, so this module imports torch, numpy and the port only: no JAX, and
no test module that imports it.  Each function builds the tiny TSN of the
test (ResNet-50 widths, one bottleneck a stage, T=4, 32^2, 16 classes, every
BN training, ``action_fused='vjp'``) from the converted JAX variables it is
given, puts it on the rank's mesh, runs each step twice (float64 in the
plain ACTION formulation, fp32 in 'vjp') and returns numpy results: rank
(0, 0) the whole state, the other model ranks of data index 0 their head
shards, every rank a digest of its state (ranks that share a model index
must agree).
"""

import hashlib

import numpy as np
import torch
import torch.distributed as dist

from ehgr_tpu_torch.configs import LossConfig, OptimConfig
from ehgr_tpu_torch.eval.inference import make_sharded_score_fn
from ehgr_tpu_torch.models import layers, resnet
from ehgr_tpu_torch.models.convert import load_jax_variables
from ehgr_tpu_torch.models.tsn import variant
from ehgr_tpu_torch.parallel.mesh import (replicated, shard_batch,
                                          shard_model)
from ehgr_tpu_torch.train.checkpoints import load_train_state, state_payload
from ehgr_tpu_torch.train import steps
from ehgr_tpu_torch.train.optim import build_optimizer
from ehgr_tpu_torch.train.steps import (create_train_state, make_eval_step,
                                        make_train_step)

T, HW, CLS, DEPTH = 4, 32, 16, 8
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LR, EMA = 0.00125, 0.9
TREES = ("params", "batch_stats", "ema_params", "ema_batch_stats",
         "momentum")


def build(arch, flat0, mesh, model_parallel, dropout=0.0,
          dtype=torch.float32):
    """The tiny model with ``flat0``'s weights, replicated from rank 0 and
    put on ``mesh``; in float64 in the plain ACTION formulation (the
    kernels take f32 and bf16 only), else 'vjp'."""
    resnet.STAGE_SIZES["resnet50"] = (1, 1, 1, 1)
    model = variant(arch, num_class=CLS, num_segments=T, partial_bn=False,
                    dropout=dropout, device="cpu",
                    action_fused=None if dtype == torch.float64 else "vjp")
    if flat0 is not None:
        load_jax_variables(model, flat0)
    model.to(dtype)
    model.dtype = dtype
    replicated(mesh, model.state_dict().values())
    shard_model(model, mesh, model_parallel)
    return model


def trees(state):
    return {"params": state.params, "batch_stats": state.batch_stats,
            "ema_params": state.ema_params,
            "ema_batch_stats": state.ema_batch_stats,
            "momentum": state.opt_state.momentum}


def digest(tree_map) -> str:
    """SHA-1 over every tensor's bytes, tree by tree, key by key."""
    h = hashlib.sha1()
    for name in TREES:
        for k in sorted(tree_map[name]):
            h.update(k.encode())
            h.update(np.ascontiguousarray(
                torch.as_tensor(tree_map[name][k]).detach().cpu().numpy()
            ).tobytes())
    return h.hexdigest()


def _result(mesh, state, metrics=None, keep=TREES):
    """The state's digest, step and metrics; on data index 0 the trees
    named in ``keep`` (rank (0, 0) whole, the other model ranks their head
    shards): the test reads no others, and each costs the trip back."""
    out = {"digest": digest(trees(state)), "step": state.step,
           "metrics": metrics and {k: v.detach().clone()
                                   for k, v in metrics.items()}}
    if mesh.data_index == 0:
        ts = {name: t for name, t in trees(state).items() if name in keep}
        out["trees"] = ts if mesh.model_index == 0 else {
            name: {k: v for k, v in t.items() if k in state.head_shards}
            for name, t in ts.items()}
    return out


def _normalize64(x, mean, std, dtype=None):
    """The port's ``normalize_clip`` in float64 (the float64 step's)."""
    mean = torch.tensor(mean, dtype=torch.float64, device=x.device)
    std = torch.tensor(std, dtype=torch.float64, device=x.device)
    return (torch.as_tensor(x).to(torch.float64) / 255.0 - mean) / std


def train_once(mesh, arch, stage, flat0, batch, model_parallel,
               accum=1, dropout=0.0, mask=None, beta=1e-6,
               dtype=torch.float32):
    """One ``make_train_step`` on the mesh (in float64 with the input
    normalized in float64); ``mask``: the global dropout keep mask the step
    must draw (``layers.dropout_mask`` is replaced by one that checks the
    shape it is asked for and returns it)."""
    model = build(arch, flat0, mesh, model_parallel, dropout, dtype)
    opt, _ = build_optimizer(model, OptimConfig(lr=LR), steps_per_epoch=1)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, stage=stage,
                           loss_cfg=LossConfig(depth_size=DEPTH, beta=beta),
                           ema_decay=EMA, mean=MEAN, std=STD,
                           accum_steps=accum, mesh=mesh)
    draw, normalize = layers.dropout_mask, steps.normalize_clip
    if mask is not None:
        def fixed(shape, keep, generator, device):
            assert tuple(shape) == mask.shape, (shape, mask.shape)
            return torch.as_tensor(mask, device=device)
        layers.dropout_mask = fixed
    if dtype == torch.float64:
        steps.normalize_clip = _normalize64
    try:
        state, metrics = step(state, batch, torch.Generator().manual_seed(0))
    finally:
        layers.dropout_mask, steps.normalize_clip = draw, normalize
    return model, opt, state, metrics


def both_steps(mesh, arch, stage, flat0, batch, model_parallel,
               keep32=("momentum",), **kw):
    """The step in float64 (plain ACTION) and in fp32 ('vjp'); the trees
    returned: the float64 step's parameters, statistics and momentum, the
    fp32 step's ``keep32``."""
    out = {}
    for name, dtype, keep in (
            ("f64", torch.float64, ("params", "batch_stats", "momentum")),
            ("f32", torch.float32, keep32)):
        model, opt, state, metrics = train_once(
            mesh, arch, stage, flat0, batch, model_parallel, dtype=dtype,
            **kw)
        out[name] = _result(mesh, state, metrics, keep)
    return out, model, opt, state


def dp_rank(mesh, flat_tsn, batch, frames, path, x):
    """data=4: the ``baseline`` step, the eval step's global counts, the
    sharded scorer (pure DP) with its 'divide' error, and the (2, 2) file
    at ``path`` restored (``restore``)."""
    out, model, _, state = both_steps(mesh, "tsn", "baseline", flat_tsn,
                                      batch, False)
    out["eval"] = make_eval_step(model, mean=MEAN, std=STD, mesh=mesh)(
        state, batch)
    out["eval_own_rows"] = make_eval_step(model, mean=MEAN, std=STD)(
        state, shard_batch(batch, mesh))
    out.update(score_rank(mesh, flat_tsn, frames, False))
    out["restore"] = restore(mesh, path, x)
    return out


def score_rank(mesh, flat_tsn, frames, model_parallel):
    model = build("tsn", flat_tsn, mesh, model_parallel)
    score = make_sharded_score_fn(model, mesh, model_parallel=model_parallel,
                                  scale_size=HW, crop_size=HW,
                                  dtype_name="float32")
    out = {"probs": score(frames)}
    try:
        score(frames[:3])
    except AssertionError as e:
        out["divide_error"] = str(e)
    return out


def joint_rank(mesh, flat_joint, flat_sd, flat_tsn, joint_batch, mask,
               beta, sd_batch, frames, path):
    """(data=2, model=2) at 16 classes, heads sharded: the ``mtmm_sd`` step
    with dropout from ``mask``, the ``sd`` step with ``accum_steps=2``
    (whose state is then saved to ``path`` from rank 0, gathered, and
    restored into a fresh mesh state, bitwise), and the sharded scorer with
    TP heads."""
    out = {"joint": both_steps(
        mesh, "tsn_mtmm_sd", "mtmm_sd", flat_joint, joint_batch, True,
        dropout=0.5, mask=mask, beta=beta)[0]}
    out["sd"], _, opt, state = both_steps(mesh, "tsn_sd", "sd", flat_sd,
                                          sd_batch, True, keep32=TREES,
                                          accum=2)
    payload = state_payload(state, opt)
    if mesh.rank == 0:
        torch.save(payload, path)
    dist.barrier()
    model = build("tsn_sd", None, mesh, True)
    fresh = create_train_state(model, opt)
    load_train_state(path, fresh)
    out["sd_reload_bitwise"] = fresh.step == state.step and all(
        torch.equal(a, trees(fresh)[name][k])
        for name, t in trees(state).items() for k, a in t.items())
    out["head_shards"] = dict(state.head_shards)
    out.update(score_rank(mesh, flat_tsn, frames, True))
    return out


def restore(mesh, path, x):
    """The (2, 2) file restored into a fresh mesh state: its digest and the
    restored model's eval logits on ``x``."""
    model = build("tsn_sd", None, mesh, False)
    opt, _ = build_optimizer(model, OptimConfig(lr=LR), steps_per_epoch=1)
    state = create_train_state(model, opt)
    load_train_state(path, state)
    model.eval()
    with torch.no_grad():
        logits = model(torch.as_tensor(x))[0]
    return {"digest": digest(trees(state)), "step": state.step,
            "logits": logits}


def failing_rank(mesh):
    """Rank 1 raises while rank 0 waits in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    t = torch.ones(1)
    dist.all_reduce(t)
    return float(t)
