"""Checkpoints on disk, cross-stage weight transfer and loading weights
from a file (counterpart of ``ehgr_tpu/train/checkpoints.py``).

``merge_state_dict`` is the reference's ``load_state_dict(strict=False)``,
through which Stage 2 (``tsn_sd``) absorbs the Stage-1 ``tsn_mtmm`` weights
while its new exits keep their init, and a truncated ``tsn_middleK`` takes
its stages and exit K from a ``tsn_sd``.  ``load_for_model`` reads a
reference ``.pth`` / ``.pth.tar`` file, or a full-state file of
``CheckpointManager``, into a model through it.

``CheckpointManager`` writes the trainer's ``latest`` / ``best`` /
``ema_best`` as one file a tag, ``<model_name>_<tag>_ckpt.pth``, with
``torch.save``: the JAX package's orbax directories need JAX's stack, which
the port does not import.  The payload (``state_payload``) holds only what
``torch.load(weights_only=True)`` accepts, every tensor on the CPU:

  ``state_dict``      the live parameters and BN statistics (torch keys, so
                      ``load_for_model`` and the JAX package's
                      ``load_torch_checkpoint`` both read it)
  ``ema_state_dict``  the EMA of both
  ``momentum``        the optimizer's buffers, keyed like the parameters
  ``step``            updates taken
  ``schedule``        the optimizer's lr per group, ``lr_steps``, gamma,
                      momentum, weight decay and ``steps_per_epoch`` (read
                      only to warn when a resume's config differs)

Across topologies: on a mesh with sharded heads, ``state_payload`` gathers
each head shard (parameter, EMA, momentum) to its full tensor over the model
group (a collective: every rank calls it), so a file from any mesh has one
process's keys and shapes; ``load_train_state`` and ``load_for_model`` take
a sharded model's rows of a full tensor.  A file restores bitwise on one
process and on any mesh.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Mapping

import torch
from torch import nn

from ehgr_tpu_torch.parallel.mesh import gather_rows, head_sharding


def _rows(value: torch.Tensor, key: str, mesh, shards: Mapping[str, int]
          ) -> torch.Tensor:
    """This rank's rows of a full tensor of a head-shard key (others as
    they are)."""
    if key in shards and value.shape[0] == shards[key]:
        return value[head_sharding(mesh, shards[key])]
    return value


@torch.no_grad()
def merge_state_dict(model: nn.Module,
                     src: Mapping[str, torch.Tensor]) -> List[str]:
    """Copy into ``model``, in place, every tensor of ``src`` whose key and
    shape ``model``'s ``state_dict`` has (a sharded head's rows of a full
    tensor, on a mesh); returns the keys of ``src`` that were not copied,
    in ``src``'s order."""
    dst = model.state_dict()
    mesh, shards = getattr(model, "mesh", None), \
        getattr(model, "head_shards", {})
    skipped = []
    for key, value in src.items():
        value = _rows(value, key, mesh, shards)
        if key in dst and dst[key].shape == value.shape:
            dst[key].copy_(value)
        else:
            skipped.append(key)
    return skipped


def load_for_model(path: str, model: nn.Module,
                   strict: bool = False) -> List[str]:
    """Load the weights of a torch checkpoint file into ``model`` in place
    and return the keys of the file that were not copied.

    The file holds a reference payload ``{'state_dict': ...}`` (other
    entries, such as the optimizer's, are ignored: a full-state file of
    ``CheckpointManager`` gives its live weights, not the EMA, as the JAX
    loader does) or a bare state dict,
    read with ``torch.load(weights_only=True)``.  Keys lose a leading
    ``module.`` (a ``DataParallel`` save); when no key names
    ``base_model.``, a bare backbone's keys gain that prefix where the
    model has such a key (an ImageNet ResNet), as
    ``ehgr_tpu.models.torch_import.load_torch_checkpoint`` maps them.  The
    tensors are merged through ``merge_state_dict``; ``strict=True``
    raises ``KeyError`` if a key of the model got no tensor (as the JAX
    package's loader raises for a leaf without a source)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package), and the port does not read orbax (ROADMAP: §1, what "
            "stays out of the port): on the JAX side, write the weights as "
            "a .pth with ehgr_tpu.models.torch_import.export_state_dict and "
            "pass that file")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = payload.get("state_dict", payload) if isinstance(payload, dict) \
        else payload
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items()}
    if not any(k.startswith("base_model.") for k in sd):
        dst = model.state_dict()
        sd = {("base_model." + k if "base_model." + k in dst else k): v
              for k, v in sd.items()}
    skipped = merge_state_dict(model, sd)
    if strict:
        copied = set(sd) - set(skipped)
        missing = [k for k in model.state_dict() if k not in copied]
        if missing:
            raise KeyError(f"model keys without a tensor in {path}: "
                           f"{missing[:10]} (+{max(0, len(missing) - 10)} "
                           "more)")
    return skipped


def state_payload(state, opt) -> Dict:
    """The checkpoint payload of a ``TrainState`` and its ``SgdPolicies``
    (see the module docstring): host copies, also of a state on the CPU, so
    the state may train on while the payload waits to be written; head
    shards gathered to their full tensors (every rank of a mesh calls
    this)."""
    shards = getattr(state, "head_shards", {})

    def host(tensors):
        return {k: (gather_rows(v.detach(), state.mesh, shards[k])
                    if k in shards else v.detach()).to("cpu", copy=True)
                for k, v in tensors.items()}

    return {"state_dict": host({**state.params, **state.batch_stats}),
            "ema_state_dict": host({**state.ema_params,
                                    **state.ema_batch_stats}),
            "momentum": host(state.opt_state.momentum),
            "step": int(state.step),
            "schedule": opt.schedule()}


@torch.no_grad()
def load_train_state(path: str, state) -> Dict:
    """Restore a full-state file into ``state`` in place (parameters, BN
    statistics, their EMA, the momentum and both step counters; a sharded
    head's rows on a mesh) and return the file's ``schedule``.  Every key
    and shape must match: a resume that would leave a tensor at its init
    raises ``KeyError``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    pairs = (("state_dict", {**state.params, **state.batch_stats}),
             ("ema_state_dict", {**state.ema_params,
                                 **state.ema_batch_stats}),
             ("momentum", state.opt_state.momentum))
    for name, dst in pairs:
        src = {k: _rows(v, k, getattr(state, "mesh", None),
                        getattr(state, "head_shards", {}))
               for k, v in payload[name].items()}
        if sorted(src) != sorted(dst) or any(
                src[k].shape != v.shape for k, v in dst.items()):
            missing = sorted(set(dst) - set(src))
            extra = sorted(set(src) - set(dst))
            raise KeyError(f"{path}: {name} does not match the model "
                           f"(missing {missing[:10]}, unexpected "
                           f"{extra[:10]}, or other shapes)")
        for k, v in dst.items():
            v.copy_(src[k])
    state.step = state.opt_state.step = int(payload["step"])
    return payload["schedule"]


class CheckpointManager:
    """One full-state file a tag in ``run_dir``, with the reference's
    ``latest`` / ``best`` / ``ema_best`` naming."""

    def __init__(self, run_dir: str, model_name: str):
        self.run_dir = os.path.abspath(run_dir)
        self.model_name = model_name
        os.makedirs(self.run_dir, exist_ok=True)

    def path(self, tag: str) -> str:
        return os.path.join(self.run_dir, f"{self.model_name}_{tag}_ckpt.pth")

    def save(self, tag: str, payload: Dict) -> str:
        """Write ``payload`` (``state_payload``'s) as ``tag``: into a
        temporary file of the same directory, flushed to disk, then renamed
        over the old one, so a crash mid-write leaves the earlier file."""
        path = self.path(tag)
        fd, tmp = tempfile.mkstemp(dir=self.run_dir, suffix=".tmp",
                                   prefix=os.path.basename(path) + ".")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise
        return path

    def restore(self, tag: str, state) -> Dict:
        """``load_train_state`` of ``tag`` into ``state``."""
        return load_train_state(self.path(tag), state)

    def exists(self, tag: str) -> bool:
        return os.path.isfile(self.path(tag))
