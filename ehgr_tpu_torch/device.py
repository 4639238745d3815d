"""Device policy of the port: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is missing); anything else is
    taken as given, so CPU runs pass ``device="cpu"`` explicitly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
