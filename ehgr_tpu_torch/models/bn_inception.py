"""BN-Inception backbone with ACTION or TSM gates at its block entries
(counterpart of ``ehgr_tpu/models/bn_inception.py``).

The Caffe-converted GoogLeNet-BN: a 7x7 / 1x1 / 3x3 stem with two
ceil-mode max pools, then ten inception blocks (``_BLOCKS``), each the
concatenation of a 1x1 branch, a 3x3 branch, a double-3x3 branch and a
pool-projection branch; the downsample blocks (3c, 4e) drop the 1x1 and
pool-projection branches and concatenate the stride-2 ceil-mode max pool
of their input instead.  Every conv has a bias and is followed by a BN
and a ReLU.

The gates ``shift_2`` ... ``shift_5a`` act on the input of each block (the
previous block's output, C = 192 ... 1056): with ``temporal='action'`` a
gate-only ``ActionGate`` (its ME BN on batch statistics in training), with
``'tsm'`` the TSM shift on the ``tsm_shift`` kernel (``TsmShift``, as
``TSMConv`` runs it), with ``'none'`` nothing.

Module names are the reference's Caffe-flat torch keys: the stem's
``conv1_7x7_s2``, ``conv2_3x3_reduce`` and ``conv2_3x3``, a block's
``inception_3a_1x1``, ``inception_3a_3x3_reduce``, ..., each with its
``*_bn``, all children of the backbone itself.  Every BN trains on batch
statistics whatever ``partial_bn`` says, as the JAX backbone builds them.
The JAX package's BGR mean (``BGR_MEAN``) is unused there and the port
has no Caffe input pipeline.  Activations are ``[N*T, C, H, W]``
channels_last.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ehgr_tpu_torch.models.layers import Conv2d
from ehgr_tpu_torch.models.norm import BatchNorm
from ehgr_tpu_torch.ops.action import ActionGate, tsm_shift_nchw

# (1x1, 3x3_reduce, 3x3, d3x3_reduce, d3x3_1, d3x3_2, pool_proj, pool,
# stride); None: the branch is absent
_BLOCKS = (
    ("3a", (64, 64, 64, 64, 96, 96, 32, "avg", 1)),
    ("3b", (64, 64, 96, 64, 96, 96, 64, "avg", 1)),
    ("3c", (None, 128, 160, 64, 96, 96, None, "max", 2)),
    ("4a", (224, 64, 96, 96, 128, 128, 128, "avg", 1)),
    ("4b", (192, 96, 128, 96, 128, 128, 128, "avg", 1)),
    ("4c", (160, 128, 160, 128, 160, 160, 128, "avg", 1)),
    ("4d", (96, 128, 192, 160, 192, 192, 128, "avg", 1)),
    ("4e", (None, 128, 192, 192, 256, 256, None, "max", 2)),
    ("5a", (352, 192, 320, 160, 224, 224, 128, "avg", 1)),
    ("5b", (352, 192, 320, 192, 224, 224, 128, "max", 1)),
)
# the gate before each block of _BLOCKS, named after the block it follows
GATES = ("shift_2", "shift_3a", "shift_3b", "shift_3c", "shift_4a",
         "shift_4b", "shift_4c", "shift_4d", "shift_4e", "shift_5a")


def _max_pool_ceil(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """MaxPool2d(k, s, padding=0, ceil_mode=True) as an explicit right and
    bottom pad with -inf, then the floor-mode pool."""
    h, w = x.shape[-2], x.shape[-1]
    oh = -(-(h - k) // s) + 1
    ow = -(-(w - k) // s) + 1
    ph = max(0, (oh - 1) * s + k - h)
    pw = max(0, (ow - 1) * s + k - w)
    x = F.pad(x, (0, pw, 0, ph), value=float("-inf"))
    return F.max_pool2d(x, k, stride=s)


def _avg_pool_3x3_s1(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, 1, padding=1), padding counted in the mean (Caffe)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool_3x3_s1(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=1, padding=1)


class _ConvBnRelu:
    """Conv (with bias) + BN + ReLU whose two modules are registered on
    ``owner`` as ``name`` and ``name + '_bn'`` (the Caffe-flat keys)."""

    def __init__(self, owner: nn.Module, name: str, c_in: int, c_out: int,
                 kernel: int = 1, stride: int = 1, device=None):
        setattr(owner, name, Conv2d(c_in, c_out, kernel, stride=stride,
                                    padding=(kernel - 1) // 2, bias=True,
                                    device=device))
        setattr(owner, name + "_bn", BatchNorm(c_out, device=device))
        self.owner, self.name = owner, name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        conv = getattr(self.owner, self.name)
        bn = getattr(self.owner, self.name + "_bn")
        return torch.relu(bn(conv(x)))


class InceptionBlock:
    """One block of ``_BLOCKS`` over the convs it registers on ``owner``
    (``inception_{name}_{branch}``); ``out_channels`` is its width."""

    def __init__(self, owner: nn.Module, name: str, spec: tuple, c_in: int,
                 device=None):
        b1, r3, o3, rd, d1, d2, pp, pool, stride = spec
        pre = f"inception_{name}_"

        def cbr(branch, c, f, k=1, s=1):
            return _ConvBnRelu(owner, pre + branch, c, f, k, s, device)
        self.b1 = cbr("1x1", c_in, b1) if b1 is not None else None
        self.b3 = (cbr("3x3_reduce", c_in, r3), cbr("3x3", r3, o3, 3, stride))
        self.bd = (cbr("double_3x3_reduce", c_in, rd),
                   cbr("double_3x3_1", rd, d1, 3),
                   cbr("double_3x3_2", d1, d2, 3, stride))
        self.pool, self.stride = pool, stride
        self.proj = cbr("pool_proj", c_in, pp) if stride == 1 else None
        self.out_channels = (b1 or 0) + o3 + d2 + (pp if stride == 1
                                                   else c_in)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        branches = [] if self.b1 is None else [self.b1(x)]
        branches.append(self.b3[1](self.b3[0](x)))
        branches.append(self.bd[2](self.bd[1](self.bd[0](x))))
        if self.stride == 2:
            branches.append(_max_pool_ceil(x))
        else:
            p = _avg_pool_3x3_s1(x) if self.pool == "avg" \
                else _max_pool_3x3_s1(x)
            branches.append(self.proj(p))
        return torch.cat(branches, dim=1)


class BNInceptionBackbone(nn.Module):
    """``forward`` returns ``stem``, ``final`` and ``pool`` (``[NT,
    1024]``): the plain TSN surface only.  ``action_fused`` is the gates'
    ``ActionConv`` mode; ``partial_bn`` is taken for the factory's sake and
    changes no BN's mode."""

    def __init__(self, temporal: str = "none", n_segment: int = 8,
                 shift_div: int = 8, action_fused=None,
                 partial_bn: bool = True, device=None):
        super().__init__()
        if temporal not in ("action", "tsm", "none"):
            raise ValueError(f"unknown temporal module {temporal!r}")
        self.temporal = temporal
        self.n_segment, self.shift_div = n_segment, shift_div
        self.stem = (_ConvBnRelu(self, "conv1_7x7_s2", 3, 64, 7, 2, device),
                     _ConvBnRelu(self, "conv2_3x3_reduce", 64, 64, 1, 1,
                                 device),
                     _ConvBnRelu(self, "conv2_3x3", 64, 192, 3, 1, device))
        self.blocks, c = [], 192
        for gate, (name, spec) in zip(GATES, _BLOCKS):
            if temporal == "action":
                setattr(self, gate, ActionGate(c, n_segment,
                                               shift_div=shift_div,
                                               fused=action_fused,
                                               device=device))
            block = InceptionBlock(self, name, spec, c, device)
            self.blocks.append(block)
            c = block.out_channels

    def _gate(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.temporal == "action":
            return getattr(self, name)(x)
        if self.temporal == "tsm":
            return tsm_shift_nchw(x, self.n_segment, self.shift_div)
        return x

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = _max_pool_ceil(self.stem[0](x))
        x = _max_pool_ceil(self.stem[2](self.stem[1](x)))
        taps: Dict[str, torch.Tensor] = {"stem": x}
        for gate, block in zip(GATES, self.blocks):
            x = block(self._gate(gate, x))
        taps["final"] = x
        taps["pool"] = x.mean((2, 3))
        return taps
