"""Int8 inference for the backbone's block convs (counterpart of
``ehgr_tpu/ops/quantize.py``).

* Weights: per-output-channel symmetric int8, ``ws = max|w| / 127``.
* Activations: per-tensor symmetric int8, ``xs`` the tensor's ``max|x| /
  127`` (``'dynamic'``) or the calibrated ``act_scale`` (``'static'``).
* The conv quantizes ``x`` by ``xs`` and sums the int8 codes in int32,
  then ``(acc.float() * (xs * ws)).to(dtype)``, the JAX package's order:
  one launch of the ``int8_conv`` kernel on the card, which quantizes the
  activation on its way into shared memory, so no pass over ``x`` runs
  before it (in ``'dynamic'`` but its amax).

``QuantConv`` replaces a bias-free ``Conv2d`` with the same ``weight`` key
and shape, so ``.pth`` files and ``load_state_dict(strict=True)`` are
unchanged.  Its ``act_scale`` is a non-persistent buffer: like JAX's
``quant`` collection it is in no checkpoint, no ``state_dict`` and no
optimizer group.  Training (``module.training``) always takes the exact
float path, unless the mode is ``'calib'``, which records at every call.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
from torch import nn

from ehgr_tpu_torch.models.layers import Conv2d
from ehgr_tpu_torch.ops.kernels.int8_conv import int8_conv, quantize_codes

MODES = ("float", "dynamic", "static", "calib")
# below this a scale would divide by zero (a tensor of zeros, or a site
# never calibrated, whose codes then saturate to +-127 as in JAX)
MIN_SCALE = 1e-12


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[O, I, kh, kw]`` -> (int8 codes, channels_last; f32 scale
    ``[O]``)."""
    w = w.float()
    ws = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)) / 127.0, MIN_SCALE)
    wq = torch.clamp(torch.round(w / ws[:, None, None, None]), -127, 127)
    return wq.to(torch.int8).contiguous(memory_format=torch.channels_last), ws


def amax(x: torch.Tensor) -> torch.Tensor:
    """``max|x|`` as an f32 scalar, taken in ``x``'s dtype: abs, max and the
    widening to f32 are exact, so it is bitwise ``x.float().abs().amax()``
    without the f32 copy."""
    return x.abs().amax().float()


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """The f32 per-tensor scale ``max|x| / 127`` (at least MIN_SCALE)."""
    return torch.clamp_min(amax(x) / 127.0, MIN_SCALE)


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Dynamic per-tensor symmetric int8: ``x`` -> (int8 ``x``, f32
    scale)."""
    xs = dynamic_scale(x)
    return quantize_codes(x, xs), xs


def record_amax(act_scale: torch.Tensor, x: torch.Tensor) -> None:
    """``act_scale = max(act_scale, max|x| / 127)``, in place (the
    ``'calib'`` mode's running maximum)."""
    with torch.no_grad():
        act_scale.copy_(torch.maximum(act_scale, amax(x.detach()) / 127.0))


class WeightCodes:
    """The int8 codes and scales of one weight, made once while the weight
    stays as it is (a new tensor or an in-place change, such as a load or
    an optimizer step, makes them anew): at eval the weights are constants,
    as JAX folds them at compile."""

    def __init__(self):
        self._key, self._codes = None, None

    def __call__(self, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (w.data_ptr(), w.device, w._version)
        if key != self._key:
            with torch.no_grad():
                self._codes = quantize_weight(w)
            self._key = key
        return self._codes


def int8_forward(x: torch.Tensor, codes: Tuple[torch.Tensor, torch.Tensor],
                 xs: torch.Tensor, stride: int, padding: int
                 ) -> torch.Tensor:
    """The int8 conv of ``x`` (quantized with scale ``xs`` inside the
    kernel) by the weight codes ``(wq, ws)``, in ``x``'s dtype."""
    wq, ws = codes
    return int8_conv(x, xs, wq, ws, stride, padding)


class QuantConv(Conv2d):
    """A bias-free ``Conv2d`` with an int8 inference path.

    ``quantize`` (the mode) picks the path at eval: ``'float'`` (the plain
    conv), ``'dynamic'`` (per-tensor amax of each call's input),
    ``'static'`` (the calibrated ``act_scale``, at least ``MIN_SCALE``) or
    ``'calib'`` (the
    float conv, recording the running maximum of ``max|x| / 127`` in
    ``act_scale``, over ``x.float()`` of the activation the model really
    computes).  In training every mode but ``'calib'`` is ``'float'``."""

    def __init__(self, *args, quantize: str = "dynamic", **kw):
        super().__init__(*args, bias=False, **kw)
        if quantize not in MODES:
            raise ValueError(f"unknown QuantConv mode {quantize!r}")
        self.quantize = quantize
        self.register_buffer("act_scale",
                             torch.zeros((), device=self.weight.device),
                             persistent=False)
        self.codes = WeightCodes()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mode = self.quantize if self.quantize == "calib" or \
            not self.training else "float"
        if mode == "calib":
            record_amax(self.act_scale, x)
        if mode in ("float", "calib"):
            return super().forward(x)
        if mode == "static":
            xs = torch.clamp_min(self.act_scale, MIN_SCALE)
        else:
            xs = dynamic_scale(x)
        return int8_forward(x, self.codes(self.weight), xs, self.stride[0],
                            self.padding[0])


def sites(model: nn.Module):
    """The int8 sites of ``model``: every module with an ``act_scale``
    (``QuantConv``, and ``ActionConv`` with its opt-in), in module
    order."""
    return [m for m in model.modules() if hasattr(m, "act_scale")]


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable[torch.Tensor]) -> None:
    """Run ``batches`` through ``model`` at eval with every int8 site in
    mode ``'calib'``: each site's ``act_scale`` becomes the running maximum
    of ``max|x| / 127`` over these forwards (and what it held before).  The
    sites' modes and the model's training flag are put back."""
    found = sites(model)
    modes = [m.quantize for m in found]
    training = model.training
    model.eval()
    try:
        for m in found:
            m.quantize = "calib"
        for b in batches:
            model(b)
    finally:
        for m, mode in zip(found, modes):
            m.quantize = mode
        model.train(training)
