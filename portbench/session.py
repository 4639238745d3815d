"""What both kinds of run share: the device's clock and memory, the seeded
set-up of weights and BN statistics, and freeing the program before the
reference runs."""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from portbench.harness import Cell, sub_seed
from portbench.reference.model import normalize, resize_square
from portbench.weights import bn_statistics, make_weights

WEIGHTS, TRAFFIC, DROPOUT = 1, 2, 3       # streams of draws of a seed


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def now() -> float:
    return time.perf_counter()


def frames_in(cell: Cell, frames_u8, device) -> torch.Tensor:
    """Host uint8 ``[..., T, H, W, 3]`` -> the reference's normalised
    float32 clips ``[clips, T, crop, crop, 3]`` on ``device``."""
    m = cell.model
    x = normalize(torch.as_tensor(frames_u8).to(device), m["mean"], m["std"])
    x = resize_square(x, m["crop"])
    return x.reshape((-1,) + tuple(x.shape[-4:]))


def weights_and_stats(cell: Cell, with_depth: bool, first_frames
                      ) -> Dict[str, torch.Tensor]:
    """The seeded state dict with the BN statistics the reference sets on
    ``first_frames`` (host uint8)."""
    dev = cell.device
    weights = make_weights(cell.model, with_depth,
                           sub_seed(cell.seed, WEIGHTS), dev)
    stats = bn_statistics(cell.model, weights,
                          frames_in(cell, first_frames, dev), with_depth)
    weights.update(stats)
    return weights


def reference_state(cell: Cell, with_depth: bool,
                    stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The same state dict again, for the reference after the window:
    the weights drawn anew from the seed, the statistics kept from set-up."""
    weights = make_weights(cell.model, with_depth,
                           sub_seed(cell.seed, WEIGHTS), cell.device)
    weights.update({k: v.to(cell.device) for k, v in stats.items()})
    return weights


def statistics_of(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.cpu() for k, v in weights.items()
            if k.endswith(("running_mean", "running_var"))}


def wall() -> float:
    return time.time()


def program_model(cell: Cell, arch: str, mode: str, dtype: str = None,
                  **kw):
    """The program's TSN of this configuration on the run's device (in
    ``dtype`` where given, else the configuration's)."""
    from ehgr_tpu_torch.models.tsn import variant

    m = cell.model
    return variant(arch, num_class=m["num_classes"],
                   num_segments=m["num_segments"],
                   base_model=m["base_model"], temporal=m["temporal"],
                   shift_div=m["shift_div"], dropout=m["dropout"],
                   partial_bn=m["partial_bn"],
                   action_fused=m["action_fused"][mode],
                   dtype=getattr(torch, dtype or m["dtype"]),
                   device=cell.device,
                   **kw)
