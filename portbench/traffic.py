"""The one traffic generator: a pool of host batches made from ``--seed``
by the parameters of a traffic file (``traffic/<name>.json``), cycled by
the run.

Serve traffic (``"kind": "serve"``): each batch is ``videos`` videos of
``clips`` clips of the configuration's ``num_segments`` frames of
``frame`` pixels, uint8 ``[V, K, T, H, W, 3]``, with a label a video.
Train traffic (``"kind": "train"``): each batch is ``clips`` clips of
uint8 RGB ``[N, T, H, W, 3]``, with ``"depth": true`` the next segment's
uint8 depth ``[N, T, H, W, 1]``, and a label a clip.

The pixels are drawn uniformly on the device from a generator seeded by
``seed`` and copied to the host as numpy arrays, as a loader hands them
over; every seed gives the same sizes, so only the contents change.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _u8(shape, gen, device) -> np.ndarray:
    return torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen,
                         device=device).cpu().numpy()


def _labels(n, classes, gen, device) -> np.ndarray:
    return torch.randint(0, classes, (n,), generator=gen,
                         device=device).cpu().numpy()


def make_pool(traffic: Dict, model: Dict, seed: int,
              device) -> List[Dict[str, np.ndarray]]:
    """``traffic["pool"]`` host batches (dicts of numpy arrays)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t, classes = model["num_segments"], model["num_classes"]
    h, w = traffic["frame"]
    pool = []
    for _ in range(traffic["pool"]):
        if traffic["kind"] == "serve":
            v, k = traffic["videos"], traffic["clips"]
            pool.append({"frames": _u8((v, k, t, h, w, 3), gen, device),
                         "label": _labels(v, classes, gen, device)})
        else:
            n = traffic["clips"]
            batch = {"rgb": _u8((n, t, h, w, 3), gen, device)}
            if traffic.get("depth"):
                batch["depth"] = _u8((n, t, h, w, 1), gen, device)
            batch["label"] = _labels(n, classes, gen, device)
            pool.append(batch)
    return pool
