"""AOT serving export (counterpart of ``ehgr_tpu/serve/export.py``): the
whole scoring program (uint8 in, on-device preprocess, backbone, softmax
clip vote) captured with ``torch.export``, weights included, in one file a
serving process reloads **without any model code**:

    fn, manifest = load_artifact("tsn_middle2.ehgrtx")
    probs = fn(frames_u8)          # [V, K, T, H, W, 3] u8 -> [V, C]

The port's kernels are ``torch.library`` custom ops (``ehgr::*``), so the
exported graph keeps each as one node and a loaded program launches the
hand-written kernel on the card (its plain version on the CPU) through the
same registration as the eager model; ``load_artifact`` imports that
registration (``ops/kernels/registry.py``) and nothing of the models.

An optional symbolic batch dimension (``symbolic_batch``) lets one artifact
serve any request batch.  The program is exported on the device it will
serve on (its constants, such as the normalization's, live there), which
the manifest names; there is no counterpart of the JAX export's
``platforms``.

File format (``.ehgrtx``): ``EHGRTX1\\n`` magic, u32-LE header length, JSON
manifest (arch, geometry, ``torch_version``, ``device``, ``ops``: the count
of each custom op the graph calls), then the bytes of ``torch.export.save``.
"""

from __future__ import annotations

import io
import json
import struct
from collections import Counter
from typing import Callable, Dict, Sequence, Tuple

import torch
from torch import nn

from ehgr_tpu_torch.ops.kernels.registry import OPS
from ehgr_tpu_torch.ops.preprocess_device import (normalize_clip,
                                                  preprocess_eval_batch)

_MAGIC = b"EHGRTX1\n"
# the batch an export traces at where the leading dimension is symbolic
# (torch.export specializes an example dimension of size 1)
_EXAMPLE_BATCH = 2


def _primary(out):
    """A multi-output model (SD, MTMM) serves its primary logits."""
    return out[0] if isinstance(out, tuple) else out


class ClipScorer(nn.Module):
    """``clips_u8 [N, T, H, W, 3] -> [N, C]`` probabilities (or logits) of
    pre-cropped clips (the ``tsn_middleK`` deploy contract)."""

    def __init__(self, model: nn.Module, mean: Sequence[float],
                 std: Sequence[float], dtype: torch.dtype,
                 return_probs: bool):
        super().__init__()
        self.model = model
        self.mean, self.std = tuple(mean), tuple(std)
        self.dtype, self.return_probs = dtype, return_probs

    def forward(self, clips_u8: torch.Tensor) -> torch.Tensor:
        x = normalize_clip(clips_u8, self.mean, self.std, dtype=self.dtype)
        logits = _primary(self.model(x))
        return torch.softmax(logits, -1) if self.return_probs else logits


class VideoScorer(nn.Module):
    """``frames_u8 [V, K, T, H, W, 3] -> [V, C]`` video probabilities: the
    resize, crop and normalization on the device, the ``V*K`` clips in one
    batch, each clip's softmax averaged over its video's K (the
    ``eval.inference.make_score_fn`` program as a module)."""

    def __init__(self, model: nn.Module, scale_size: int, crop_size: int,
                 square_resize: bool, dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.scale_size, self.crop_size = scale_size, crop_size
        self.square_resize, self.dtype = square_resize, dtype

    def forward(self, frames_u8: torch.Tensor) -> torch.Tensor:
        v, k, t = frames_u8.shape[:3]
        x = preprocess_eval_batch(
            frames_u8, scale_size=self.scale_size, crop_size=self.crop_size,
            square_resize=self.square_resize, dtype=self.dtype)
        logits = _primary(self.model(x.reshape((v * k, t) + x.shape[3:])))
        return torch.softmax(logits, -1).reshape(v, k, -1).mean(1)


def make_clip_scorer(model: nn.Module, *, mean, std,
                     dtype_name: str = "bfloat16",
                     return_probs: bool = True) -> ClipScorer:
    """The clip scorer of ``model`` (put in eval mode)."""
    return ClipScorer(model.eval(), mean, std, getattr(torch, dtype_name),
                      return_probs).eval()


def make_video_scorer(model: nn.Module, *, scale_size: int = 224,
                      crop_size: int = 224, square_resize: bool = True,
                      dtype_name: str = "bfloat16") -> VideoScorer:
    """The full-protocol video scorer of ``model`` (put in eval mode)."""
    return VideoScorer(model.eval(), scale_size, crop_size, square_resize,
                       getattr(torch, dtype_name)).eval()


def symbolic_batch(shape: Sequence[int], name: str = "v") -> tuple:
    """``shape`` with a ``torch.export.Dim`` in place of the leading
    dimension, so the artifact accepts any batch at that position."""
    return (torch.export.Dim(name, min=1),) + tuple(shape[1:])


def export_artifact(scorer: nn.Module, arg_shape, *,
                    dtype: torch.dtype = torch.uint8
                    ) -> torch.export.ExportedProgram:
    """Export ``scorer`` taking one tensor of ``arg_shape`` (ints, or a
    ``symbolic_batch`` result) on the device of its parameters.  The
    scorer first runs once eagerly on zeros of that shape, which checks
    that it runs and makes the int8 sites' weight codes (constants of the
    program)."""
    device = next(scorer.parameters()).device
    sym = {i: d for i, d in enumerate(arg_shape)
           if isinstance(d, torch.export.Dim)}
    shape = tuple(_EXAMPLE_BATCH if i in sym else int(d)
                  for i, d in enumerate(arg_shape))
    example = torch.zeros(shape, dtype=dtype, device=device)
    with torch.no_grad():
        scorer(example)
        program = torch.export.export(scorer, (example,),
                                      dynamic_shapes=(sym or None,),
                                      strict=False)
    program.example_inputs = None       # else saved with the program
    return program


def graph_ops(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """The count of each custom op of the port (``ehgr::*``) that the
    program's graph calls."""
    found = Counter(node.target.name() for node in program.graph.nodes
                    if node.op == "call_function" and
                    isinstance(node.target, torch._ops.OpOverload) and
                    node.target.namespace == "ehgr")
    return {name.split(".")[0]: n for name, n in sorted(found.items())}


def save_artifact(path: str, program: torch.export.ExportedProgram,
                  manifest: Dict) -> int:
    """Write magic + JSON manifest + serialized program; returns bytes."""
    manifest = dict(manifest)
    state = [*program.state_dict.values(), *program.constants.values()]
    inputs = [n for n in program.graph.nodes if n.op == "placeholder" and
              n.name in program.graph_signature.user_inputs]
    manifest.setdefault("torch_version", torch.__version__)
    manifest.setdefault("device", str(state[0].device))
    manifest.setdefault("in_shape", [str(d) for d in
                                     inputs[0].meta["val"].shape])
    manifest.setdefault("ops", graph_ops(program))
    header = json.dumps(manifest).encode()
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(blob)
    return len(_MAGIC) + 4 + len(header) + len(blob)


def load_artifact(path: str) -> Tuple[Callable, Dict]:
    """Reload ``(fn, manifest)`` from a ``save_artifact`` file, no model
    code or weights needed: ``fn(frames_u8)`` (numpy or tensor) scores on
    the manifest's device; ``fn.program`` is the ``ExportedProgram``.
    Raises if the file is not such an artifact or a custom op of its graph
    is not registered."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an EHGRTX1 artifact")
        (hlen,) = struct.unpack("<I", f.read(4))
        manifest = json.loads(f.read(hlen).decode())
        blob = f.read()
    missing = sorted(set(manifest["ops"]) - set(OPS))
    if missing:
        raise RuntimeError(f"{path}: custom ops {missing} are not "
                           f"registered (this port registers {sorted(OPS)})")
    program = torch.export.load(io.BytesIO(blob))
    module = program.module()
    device = torch.device(manifest["device"])

    @torch.inference_mode()
    def fn(frames_u8) -> torch.Tensor:
        return module(torch.as_tensor(frames_u8).to(device))

    fn.program = program
    return fn, manifest
