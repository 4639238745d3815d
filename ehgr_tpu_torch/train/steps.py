"""Train and eval steps (counterpart of ``ehgr_tpu/train/steps.py``) for the
four stages: ``baseline`` (arch ``tsn``, CE), ``mtmm`` (arch ``tsn_mtmm``,
CE + w * MSE of the depth map against the next segment's depth resized to
56^2), ``sd`` (arch ``tsn_sd``, CE of the final head and the three exits, KD
of each exit against the final head, feature hints) and the joint
``mtmm_sd`` (arch ``tsn_mtmm_sd``: the SD losses plus w * MSE of the
global transposed decoder's map, ``out[9]``, against the CURRENT clip's
depth; the local decoder's map is not supervised).

One step: uint8 batch to the model's device, ``normalize_clip`` in f32,
forward in the model's compute dtype, loss, backward, the policy SGD update
and the EMA blend of the parameters and BN running statistics; the program's
spans ``ehgr.step`` / ``.copy`` / ``.forward`` / ``.backward`` / ``.update``
mark those phases (``utils/profiling.py``).  Batches are
``{"rgb": uint8 [N,T,H,W,3], "depth": uint8 [N,T,H,W,1] (mtmm),
"label": [N]}``, numpy or tensors (depth for ``mtmm`` and ``mtmm_sd``).

The model holds the parameters and statistics; the step updates them, the
optimizer's momentum and the EMA in place.

On a mesh (``mesh=``, the model first put on it with
``parallel.mesh.shard_model``) every rank gets the whole host batch and
takes its rows (``shard_batch``, microbatch by microbatch with
``accum_steps``); its loss is its share of the global loss (the mean terms
divided by the data size, the feature hint not), the gradients are SUMmed
over the data group, the clip norm is global, and the metrics are the
global batch's.  Together with the global BN statistics and the global
dropout mask this makes the mesh step the one-process step on the whole
batch, as GSPMD makes JAX's sharded step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ehgr_tpu_torch.eval.metrics import topk_correct
from ehgr_tpu_torch.ops.preprocess_device import (depth_to_target,
                                                  normalize_clip)
from ehgr_tpu_torch.parallel.collectives import all_reduce_grads, sum_over
from ehgr_tpu_torch.parallel.mesh import shard_batch
from ehgr_tpu_torch.train import losses
from ehgr_tpu_torch.train.ema import ema_update
from ehgr_tpu_torch.train.optim import SgdPolicies, SgdState
from ehgr_tpu_torch.utils.profiling import span

STAGES = ("baseline", "mtmm", "sd", "mtmm_sd")


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]         # the model's parameters
    batch_stats: Dict[str, torch.Tensor]    # the model's BN running stats
    opt_state: SgdState
    ema_params: Dict[str, torch.Tensor]
    ema_batch_stats: Dict[str, torch.Tensor]
    # on a mesh: the model's mesh and each head-shard key's full rows (its
    # parameter, momentum and EMA hold this rank's rows)
    mesh: Any = None
    head_shards: Dict[str, int] = field(default_factory=dict)


def create_train_state(model: nn.Module, opt: SgdPolicies) -> TrainState:
    """State over ``model``'s own tensors (``params`` and ``batch_stats``
    are the live parameters and running statistics), with zero momentum and
    the EMA starting at the current values; on a mesh, with the model's
    head shards."""
    params = dict(model.named_parameters())
    stats = {k: v for k, v in model.state_dict(keep_vars=True).items()
             if k not in params}
    return TrainState(
        step=0, params=params, batch_stats=stats,
        opt_state=opt.init(params),
        ema_params={k: v.detach().clone() for k, v in params.items()},
        ema_batch_stats={k: v.detach().clone() for k, v in stats.items()},
        mesh=getattr(model, "mesh", None),
        head_shards=dict(getattr(model, "head_shards", {})))


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_loss_fn(model: nn.Module, *, stage: str, loss_cfg,
                 mean: Sequence[float], std: Sequence[float],
                 data_size: int = 1) -> Callable:
    """``(batch on the device, generator) -> (total, aux, logits)`` of one
    forward of ``model`` in its current mode; ``data_size``: the loss is a
    data rank's share (``train/losses.py``)."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage: {stage}")

    def loss_fn(batch, generator):
        rgb = normalize_clip(batch["rgb"], mean, std, dtype=torch.float32)
        out = model(rgb, generator=generator)
        labels = batch["label"]
        if stage == "baseline":
            total = losses.share(losses.cross_entropy(out, labels),
                                 data_size)
            return total, {"ce": total}, out
        if stage == "sd":
            logits, m1, m2, m3, ffea, f1, f2, f3 = out
            total, aux = losses.sd_total(
                logits, (m1, m2, m3), labels, ffea, (f1, f2, f3),
                alpha=loss_cfg.alpha, beta=loss_cfg.beta,
                temperature=loss_cfg.temperature, data_size=data_size)
            return total, aux, logits
        depth_gt = depth_to_target(batch["depth"], loss_cfg.depth_size)
        depth_gt = depth_gt.reshape((-1,) + depth_gt.shape[2:])
        if stage == "mtmm_sd":
            logits, m1, m2, m3, ffea, f1, f2, f3 = out[:8]
            total, aux = losses.mtmm_sd_total(
                logits, (m1, m2, m3), labels, ffea, (f1, f2, f3), out[9],
                depth_gt, alpha=loss_cfg.alpha, beta=loss_cfg.beta,
                temperature=loss_cfg.temperature,
                depth_weight=loss_cfg.depth_weight, data_size=data_size)
            return total, aux, logits
        logits, depth_pred = out
        depth_pred = depth_pred.reshape((-1,) + depth_pred.shape[-3:])
        total, aux = losses.mtmm_total(logits, labels, depth_pred, depth_gt,
                                       depth_weight=loss_cfg.depth_weight,
                                       data_size=data_size)
        return total, aux, logits

    return loss_fn


def _on_mesh(model: nn.Module, mesh):
    if mesh is not None and getattr(model, "mesh", None) is not mesh:
        raise ValueError("put the model on the mesh first "
                         "(parallel.mesh.shard_model)")
    return mesh is not None and mesh.data_size > 1


def make_train_step(model: nn.Module, opt: SgdPolicies, *, stage: str,
                    loss_cfg, ema_decay: float, mean: Sequence[float],
                    std: Sequence[float], accum_steps: int = 1,
                    mesh=None) -> Callable:
    """``(state, batch, generator) -> (state, metrics)`` for ``stage`` in
    ``STAGES``; ``generator`` (a ``torch.Generator`` on the model's device)
    draws the dropout masks.

    ``accum_steps=A > 1``: the batch (N divisible by A) runs as A
    microbatches in sequence (BN statistics see each in turn), the gradient
    is their mean, and the optimizer and the EMA update once.

    ``mesh``: the step of one rank of a mesh run (see the module
    docstring); every rank passes the whole batch and a generator in the
    same state."""
    split = _on_mesh(model, mesh)
    loss_fn = make_loss_fn(model, stage=stage, loss_cfg=loss_cfg, mean=mean,
                           std=std, data_size=mesh.data_size if split else 1)
    device = next(model.parameters()).device

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        n = len(batch["label"])
        if n % accum_steps:
            raise ValueError(
                f"batch size {n} not divisible by accum_steps={accum_steps}")
        with span("ehgr.step", state.step):
            with span("ehgr.step.copy"):
                if split:
                    batch = shard_batch(batch, mesh, accum_steps)
                batch = _to_device(batch, device)
            model.train()
            for p in state.params.values():
                p.grad = None
            totals, auxes, c1, c5 = [], [], 0, 0
            for mb in ({k: v.chunk(accum_steps)[i] for k, v in batch.items()}
                       for i in range(accum_steps)):
                with span("ehgr.step.forward"):
                    total, aux, logits = loss_fn(mb, generator)
                with span("ehgr.step.backward"):
                    (total / accum_steps if accum_steps > 1
                     else total).backward()
                k1, k5 = topk_correct(logits.detach(), mb["label"], (1, 5))
                totals.append(total.detach())
                auxes.append({k: v.detach() for k, v in aux.items()})
                c1, c5 = c1 + k1, c5 + k5
            with span("ehgr.step.update"):
                grads = {k: p.grad if p.grad is not None
                         else torch.zeros_like(p)
                         for k, p in state.params.items()}
                if split:
                    all_reduce_grads(grads.values(), mesh.data_group)
                opt.step(state.params, grads, state.opt_state,
                         sharded=state.head_shards,
                         group=None if mesh is None else mesh.model_group)
                ema_update(state.ema_params, state.params, ema_decay)
                ema_update(state.ema_batch_stats, state.batch_stats, ema_decay)
            state.step += 1
            metrics = {"loss": torch.stack(totals).mean(), "c1": c1, "c5": c5}
            metrics.update({k: torch.stack([a[k] for a in auxes]).mean()
                            for k in auxes[0]})
            if split:
                metrics = sum_over(metrics, mesh.data_group)
            c1, c5 = metrics.pop("c1"), metrics.pop("c5")
            metrics = {"loss": metrics.pop("loss"), "top1": 100.0 * c1 / n,
                       "top5": 100.0 * c5 / n, **metrics}
            return state, metrics

    return train_step


def make_eval_step(model: nn.Module, *, mean: Sequence[float],
                   std: Sequence[float], use_ema: bool = False,
                   multi_output: bool = False, mesh=None) -> Callable:
    """``(state, batch) -> counts``: top-1/top-5 hits of the final head
    (and the three exits with ``multi_output``, for the SD and the joint
    surfaces) and ``n``, with the live or the EMA weights.  ``mesh``: each
    rank takes its rows of the whole batch and the counts are the global
    batch's."""
    split = _on_mesh(model, mesh)
    device = next(model.parameters()).device

    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        if split:
            batch = shard_batch(batch, mesh)
        batch = _to_device(batch, device)
        model.eval()
        rgb = normalize_clip(batch["rgb"], mean, std, dtype=torch.float32)
        with torch.no_grad():
            if use_ema:
                out = torch.func.functional_call(
                    model, {**state.ema_params, **state.ema_batch_stats},
                    (rgb,))
            else:
                out = model(rgb)
        outs = out if isinstance(out, tuple) else (out,)
        res = {}
        for i, lg in enumerate(outs[:4] if multi_output else outs[:1]):
            c1, c5 = topk_correct(lg, batch["label"], (1, 5))
            key = "final" if i == 0 else f"mid{i}"
            res[f"{key}_top1"], res[f"{key}_top5"] = c1, c5
        res["n"] = torch.tensor(batch["label"].shape[0])
        if split:
            res = {k: v.round().long() for k, v in
                   sum_over(res, mesh.data_group).items()}
        return res

    return eval_step
