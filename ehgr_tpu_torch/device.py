"""Device policy of the port: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; anything else is taken as given, so CPU runs
    pass ``device="cpu"`` explicitly.  A CUDA device raises when CUDA is
    missing: nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
