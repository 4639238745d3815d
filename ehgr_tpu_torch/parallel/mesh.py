"""The ``(data, model)`` mesh over ``torch.distributed`` (counterpart of
``ehgr_tpu/parallel/mesh.py``).

JAX runs one controller over a device grid and lets GSPMD insert the
collectives; the port runs ``world = data x model`` processes, one a rank,
in JAX's row-major layout: rank ``r`` sits at data index ``r // model`` and
model index ``r % model``.  A **data group** is the ranks that share a
model index (they hold the same parameters and split the clips); a **model
group** is the ranks that share a data index (they see the same clips and
split the sharded heads).

* ``data`` -- the clip batch splits over it (``shard_batch``); BN batch
  statistics are global means over it (``models/norm.py``), as they are
  under GSPMD; gradients are summed over it (``train/steps.py``).
* ``model`` -- with ``model_parallel``, the classifier and exit heads
  (``new_fc``, ``middle_fc1..3``) shard their out-features over it when
  the class count divides it (``param_shardings``); their logit shards are
  gathered before the softmax and the consensus
  (``collectives.gather_cols``).

Every collective is an ``all_reduce`` (``parallel/collectives.py``, which
says why) or, in ``replicated``, a ``broadcast``.

``run_ranks`` launches a run: one spawned process a rank, the process group
made with an explicit timeout, a rank that raises ends the others and the
launcher raises with its traceback.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue as queue_mod
import socket
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from ehgr_tpu_torch.device import DeviceLike, resolve_device
from ehgr_tpu_torch.models.layers import Linear
from ehgr_tpu_torch.models.norm import BatchNorm
from ehgr_tpu_torch.parallel.collectives import flat_groups

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the modules whose out-features shard over 'model' (the JAX rule)
HEAD_NAMES = ("new_fc", "middle_fc1", "middle_fc2", "middle_fc3")
# integer views for bitwise gathers, by element size
_BITS = {4: torch.int32, 8: torch.int64}


def layout(world: int, model_parallel: int = 1) -> np.ndarray:
    """The rank grid ``[data, model]``, row-major as JAX's ``make_mesh``
    reshapes its devices."""
    if world % model_parallel:
        raise ValueError(f"{world} ranks do not split into model groups of "
                         f"{model_parallel}")
    return np.arange(world).reshape(world // model_parallel, model_parallel)


def rank_device(rank: int) -> torch.device:
    """Rank ``rank``'s card, ``cuda:{rank % device_count}``; raises when
    CUDA is missing (the CPU is only ever the caller's explicit choice)."""
    resolve_device("cuda")
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclass(eq=False)
class Mesh:
    """One rank's view of the grid: its place, its device (by default
    ``rank_device(rank)``: its card, raising without CUDA) and its two
    groups (``None`` where the process group is not set up, as in a
    layout check)."""

    shape: Dict[str, int]
    rank: int = 0
    device: DeviceLike = None
    data_group: Any = None
    model_group: Any = None

    def __post_init__(self):
        self.device = rank_device(self.rank) if self.device is None \
            else resolve_device(self.device)

    @property
    def data_size(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def model_size(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def data_index(self) -> int:
        return self.rank // self.model_size

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size

    def __deepcopy__(self, memo) -> "Mesh":
        # modules and states that hold the mesh deep-copy around it: a
        # process group cannot be copied
        return self


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device: DeviceLike = None) -> Mesh:
    """This rank's ``Mesh`` over the initialised process group (``run_ranks``
    makes one), on ``device``: by default the rank's card
    (``rank_device``), which raises without CUDA; ``device="cpu"`` for a
    CPU run.  Every rank must call it, at the same point: it creates every
    data group, then every model group, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(run_ranks makes one)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"mesh of {n_devices} ranks in a world of {world}")
    grid = layout(world, model_parallel)
    rank = dist.get_rank()
    groups = {}
    for axis, lines in ((DATA_AXIS, grid.T), (MODEL_AXIS, grid)):
        for line in lines:
            g = dist.new_group(line.tolist())
            if rank in line:
                groups[axis] = g
    return Mesh(shape={DATA_AXIS: grid.shape[0], MODEL_AXIS: grid.shape[1]},
                rank=rank, device=device,
                data_group=groups[DATA_AXIS], model_group=groups[MODEL_AXIS])


def batch_sharding(mesh: Mesh, n: int, accum_steps: int = 1) -> np.ndarray:
    """The rows of an ``n``-row host batch that this rank takes.  The batch
    runs as ``accum_steps`` microbatches, microbatch i the global rows
    ``[i*n/A, (i+1)*n/A)`` as JAX's ``reshape((A, -1))`` makes them, each
    split over ``data``; the rank's rows come microbatch by microbatch."""
    d = mesh.data_size
    if n % (accum_steps * d):
        raise ValueError(f"batch of {n} rows does not split into "
                         f"{accum_steps} microbatches over data axis {d}")
    micro, per = n // accum_steps, n // accum_steps // d
    start = mesh.data_index * per
    return np.concatenate([np.arange(i * micro + start, i * micro + start
                                     + per) for i in range(accum_steps)])


def shard_batch(batch: Mapping[str, Any], mesh: Mesh,
                accum_steps: int = 1) -> Dict[str, torch.Tensor]:
    """This rank's rows (``batch_sharding``) of every array of a host batch
    (numpy or tensors, the whole global batch on every rank), on the mesh's
    device."""
    n = len(next(iter(batch.values())))
    rows = batch_sharding(mesh, n, accum_steps)
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        v = v[int(rows[0]):int(rows[-1]) + 1] if accum_steps == 1 \
            else v[torch.as_tensor(rows, device=v.device)]
        out[k] = v.to(mesh.device)
    return out


def head_sharding(mesh: Mesh, rows: int) -> slice:
    """This rank's out-features of a head of ``rows`` out-features, sharded
    over ``model``."""
    per = rows // mesh.model_size
    return slice(mesh.model_index * per, (mesh.model_index + 1) * per)


def param_shardings(params: Mapping[str, Any], mesh: Mesh,
                    model_parallel: bool = False) -> tuple:
    """The parameter keys (torch names) that shard over ``model``: with
    ``model_parallel``, the weights and biases of ``new_fc`` and
    ``middle_fc1..3`` whose out-features (rows) divide the model axis; the
    rest, and every key without ``model_parallel``, replicate."""
    if not model_parallel:
        return ()
    return tuple(k for k, v in params.items()
                 if any(p in HEAD_NAMES for p in k.split(".")[:-1])
                 and tuple(v.shape)[0] % mesh.model_size == 0)


@torch.no_grad()
def replicated(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> None:
    """Make ``tensors`` equal on every rank: broadcast rank 0's values over
    the world, in place (one broadcast of a flat copy a dtype)."""
    if mesh.data_size * mesh.model_size == 1:
        return
    for ts in flat_groups(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=0)
        for t, piece in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(piece.view_as(t))


@torch.no_grad()
def gather_rows(t: torch.Tensor, mesh: Mesh, full: int) -> torch.Tensor:
    """The full ``[full, ...]`` tensor of a head shard, bitwise: the rows
    written into zeros and SUMmed over ``model`` as integers."""
    out = t.new_zeros((full,) + tuple(t.shape[1:]))
    out[head_sharding(mesh, full)] = t
    dist.all_reduce(out.view(_BITS[out.element_size()]),
                    group=mesh.model_group)
    return out


def shard_model(model: torch.nn.Module, mesh: Mesh,
                model_parallel: bool = False) -> Dict[str, int]:
    """Put ``model`` (replicated: the same weights on every rank) on the
    mesh, in place: every BN takes global statistics over ``data`` in
    training, dropout draws the global mask and takes this rank's rows,
    and with ``model_parallel`` each head of ``param_shardings`` keeps its
    own out-features and gathers its logits over ``model``.  Returns (and
    keeps as ``model.head_shards``) each sharded key's full rows.  A model
    already on ``mesh`` is returned as it is."""
    if getattr(model, "mesh", None) is not None:
        if model.mesh is not mesh or \
                bool(model.head_shards) != bool(model_parallel and
                                                mesh.model_size > 1):
            raise ValueError("model is already on another mesh or layout")
        return model.head_shards
    shards = {}
    keys = param_shardings(dict(model.named_parameters()), mesh,
                           model_parallel and mesh.model_size > 1)
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm) and mesh.data_size > 1:
            mod.data_group = mesh.data_group
        if isinstance(mod, Linear) and f"{name}.weight" in keys:
            full = mod.weight.shape[0]
            rows = head_sharding(mesh, full)
            for leaf in ("weight", "bias"):
                p = getattr(mod, leaf)
                if p is not None:
                    setattr(mod, leaf, torch.nn.Parameter(
                        p.detach()[rows].clone()))
                    shards[f"{name}.{leaf}"] = full
            mod.out_features = rows.stop - rows.start
            mod.tp = (mesh.model_group, rows.start, full)
    model.mesh, model.head_shards = mesh, shards
    return shards


def _host(obj):
    """Tensors -> numpy (bf16 through f32), recursively, for the trip back
    to the launcher."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _rank_main(rank, world, model_parallel, backend, device, port, timeout,
               threads, inbox, results):
    try:
        fn, args = pickle.loads(inbox.get(timeout=timeout))
        # every rank is on this host: the loopback interface serves both
        # backends' sockets
        if "lo" in (name for _, name in socket.if_nameindex()):
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(rank) if device == "cuda" else torch.device("cpu")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}",
            world_size=world, rank=rank, timeout=timedelta(seconds=timeout))
        mesh = make_mesh(world, model_parallel, device=dev)
        out = _host(fn(mesh, *args))
        results.put(("ok", rank, out))
        results.close()
        results.join_thread()
        dist.destroy_process_group()
    except Exception:
        # the launcher ends the other ranks; an interrupt or exit is not
        # caught and shows there as a rank that ended without a result
        results.put(("error", rank, traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(fn: Callable, world: int, model_parallel: int = 1,
              backend: str = "gloo", device: str = "cuda", *,
              args: tuple = (), timeout: float = 120.0,
              deadline: Optional[float] = None,
              threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world`` ranks, one spawned process
    each, on a ``(world // model_parallel, model_parallel)`` mesh; returns
    the ranks' results in rank order, every tensor in them as a numpy
    array.  ``fn`` must be importable by name (a module-level function).

    Ranks run on ``cuda:{rank % device_count}``, or on the CPU with
    ``device="cpu"``.  ``backend="nccl"`` needs one card a rank and raises
    with more ranks than cards; ranks share a card only over gloo, which
    the caller asks for.  ``timeout`` (s) bounds each collective and the
    group's set-up; ``deadline`` (s, default twice ``timeout``) the whole
    run.  A rank that raises ends the others, and this raises
    ``RuntimeError`` with its traceback; past the deadline every rank is
    ended and this raises ``TimeoutError``.  ``threads`` sets each rank's
    torch threads."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', not {device!r}")
    layout(world, model_parallel)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the ranks on the CPU")
        cards = torch.cuda.device_count()
        if backend == "nccl" and world > cards:
            raise ValueError(
                f"backend='nccl' needs one card a rank: {world} ranks, "
                f"{cards} card(s); ranks share a card only over gloo")
    elif backend == "nccl":
        raise ValueError("backend='nccl' runs on CUDA devices only")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    # fn and its arguments go through a queue, not the process arguments:
    # a start returns only once the child has read those, so large ones
    # would start the ranks one after another
    inbox = ctx.Queue()
    inbox.cancel_join_thread()
    payload = pickle.dumps((fn, args), protocol=pickle.HIGHEST_PROTOCOL)
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, model_parallel, backend, device,
                               port, timeout, threads, inbox, results))
             for r in range(world)]
    for p in procs:
        p.start()
    for _ in procs:
        inbox.put(payload)
    limit = 2 * timeout if deadline is None else deadline
    end = time.monotonic() + limit
    out: Dict[int, Any] = {}
    ok = False
    try:
        while len(out) < world:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"run_ranks: ranks {sorted(set(range(world)) - set(out))}"
                    f" of {world} still running after {limit:.0f} s")
            try:
                kind, rank, payload = results.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    try:
                        kind, rank, payload = results.get(timeout=1.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} of {world} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                else:
                    continue
            if kind == "error":
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{payload}")
            out[rank] = payload
        ok = True
    finally:
        for p in procs:
            if ok:
                p.join(timeout=30)
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
        inbox.close()
    return [out[r] for r in range(world)]
