"""JAX variable tree -> the port's ``state_dict`` (counterpart of the export
direction of ``ehgr_tpu/models/torch_import.py``, for the ResNet / TSN /
ACTION / decoder / SD-exit / text-head subset the port has, and for the
3-D models, VideoMAE and DPT).

Input is the flax variable tree flattened to ``{path-tuple: array}``, as
``flax.traverse_util.flatten_dict`` gives it (first element the collection:
``params`` or ``batch_stats``, and ``quant``, the int8 sites' calibrated
``act_scale``, which goes to the non-persistent buffers of the same name
and never into a ``state_dict``; others are skipped).  Each path is
rewritten to its torch key by name rules and each tensor transposed by
rank:

  conv2d kernel [kh,kw,I,O]       -> [O,I,kh,kw]   (also depthwise)
  conv3d kernel [kt,kh,kw,I,O]    -> [O,I,kt,kh,kw]
  conv1d kernel [k,I,O]           -> [O,I,k]
  conv-transpose kernel [kh,kw,O,I] (``transpose_kernel``) -> [I,O,kh,kw]
                                  (also rank 5: R(2+1)D's ``dec_ct{k}``)
  DPT's ``up1`` / ``up2`` [kh,kw,I,O] (no ``transpose_kernel``)
                                  -> [I,O,kh,kw] flipped in kh and kw
  ``cls_token``, ``pos_embed``    -> as they are
  dense  kernel [I,O]             -> [O,I]; [O,I,1,1] at the ACTION 1x1 sites
  shift_w [3,C]                   -> action_shift.weight [C,1,3]

Name rules: ``layer{i}_{j}`` -> ``layer{i}.{j}``; ``downsample_conv/bn`` ->
``downsample.0/1``; DPT's ``layer{k}_rn`` keeps its name; ACTION children ``pK_*`` -> ``action_pK_*``; decoder
``global_decoder/{conv0..4,bn0..3}`` -> ``global_decoder.{nn.Sequential
index}``; ``scala{k}/sep{i}/{dw1,pw1,bn1,dw2,pw2,bn2}`` ->
``scala{k}.{i}.op.{0,1,2,4,5,6}``; ``middle_fc{k}`` keeps its name; BN
leaves ``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``.
The four decoders (``global_decoder``, ``local_decoder``,
``local_skel_decoder``, ``global_skel_decoder``) go by the leaf module's
own name, since the MTMM and the joint-stage decoder share the prefix
``global_decoder``: ``conv0..4/bn0..3`` (the MTMM decoder) by the table
above, ``ct{i}`` -> ``2i`` and ``ctbn{i}`` -> ``2i+1`` (the transposed
decoders); ``text_encoder/{conv,bn}`` -> ``text_encoder.{0,1}``.

The other backbones: MobileNetV2 ``features_{i}`` -> ``features.{i}``,
inside it ``conv_{j}`` -> ``conv.{j}`` and ``c0/c1`` -> ``0/1``;
BN-Inception's Caffe-flat keys, ``conv1/{conv,bn}`` ->
``conv1_7x7_s2[_bn]`` (also ``conv2_reduce``, ``conv2``) and
``inception_3a/b1x1/{conv,bn}`` -> ``inception_3a_1x1[_bn]`` (the branches
of ``_BNI_BRANCH``); Res2Net ``convs_{k}`` / ``bns_{k}`` ->
``convs.{k}`` / ``bns.{k}``.  A ``SepConv`` outside the SD exits (the
BYOT model's ``attention{i}/sep`` and ``scala{i}_sep{k}``) becomes
``<name>.op.{index}`` by the same table as in a scala exit.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_ACTION_CHILD = {
    "p1_conv": "action_p1_conv1",
    "p2_squeeze": "action_p2_squeeze",
    "p2_conv1": "action_p2_conv1",
    "p2_expand": "action_p2_expand",
    "p3_squeeze": "action_p3_squeeze",
    "p3_bn1": "action_p3_bn1",
    "p3_conv1": "action_p3_conv1",
    "p3_expand": "action_p3_expand",
}
_BN_LEAF = {"scale": "weight", "mean": "running_mean",
            "var": "running_var"}
# flax Dense leaves whose torch counterpart is a 1x1 Conv2d
_1X1_DENSE = ("action_p2_squeeze.weight", "action_p2_expand.weight",
              "action_p3_expand.weight")
# the MTMM global decoder's layers -> their nn.Sequential indices
# ([conv, bn, relu, up] x 3 + [conv, bn, relu] + conv1x1 + sigmoid)
_DECODER_SEQ = {"conv0": "0", "bn0": "1", "conv1": "4", "bn1": "5",
                "conv2": "8", "bn2": "9", "conv3": "12", "bn3": "13",
                "conv4": "15"}
# SepConv layers -> their indices in the reference's nn.Sequential ``op``
_SEPCONV_SEQ = {"dw1": "0", "pw1": "1", "bn1": "2", "dw2": "4", "pw2": "5",
                "bn2": "6"}
# the JAX optimizer pads ``hyper['lr_steps']`` to a fixed width with this
# epoch, which no run reaches
_LR_STEP_PAD = 2 ** 30
_DECODERS = ("global_decoder", "local_decoder", "local_skel_decoder",
             "global_skel_decoder")
_TEXT_SEQ = {"conv": "0", "bn": "1"}
# BN-Inception: a block's branches and the stem's layers -> their Caffe names
_BNI_BRANCH = {"b1x1": "1x1", "b3x3_reduce": "3x3_reduce", "b3x3": "3x3",
               "bd3x3_reduce": "double_3x3_reduce",
               "bd3x3_1": "double_3x3_1", "bd3x3_2": "double_3x3_2",
               "bpool_proj": "pool_proj"}
_BNI_STEM = {"conv1": "conv1_7x7_s2", "conv2_reduce": "conv2_3x3_reduce",
             "conv2": "conv2_3x3"}
_BYOT_SEP = re.compile(r"scala\d+_sep\d+")
# DPT's top-level leaves kept in their flax layout: its class token and
# position table
_RAW = ("cls_token", "pos_embed")
# DPT's top-level ``ConvTranspose(transpose_kernel=False)`` kernels
# [kh,kw,I,O]: torch's ``ConvTranspose2d`` computes the same function from
# [I,O,kh,kw] flipped in space
_FLAX_TCONV = ("up1.weight", "up2.weight")


def _decoder_index(p: str) -> str:
    """A decoder's child module -> its ``nn.Sequential`` index."""
    if p.startswith("ctbn"):
        return str(2 * int(p[4:]) + 1)
    if p.startswith("ct"):
        return str(2 * int(p[2:]))
    return _DECODER_SEQ[p]


def _caffe_flat(parts):
    """BN-Inception's layers as one part each, its Caffe-flat names:
    ``inception_3a/b1x1/conv`` -> ``inception_3a_1x1``, ``conv1/bn`` ->
    ``conv1_7x7_s2_bn`` (not inside a block ``layer{i}_{j}``, where
    R(2+1)D's ``conv1/bn`` is its own); other parts pass."""
    out = []
    for p in parts:
        suffix = "_bn" if p == "bn" else ""
        if p in ("conv", "bn") and out and out[-1] in _BNI_STEM and \
                not (len(out) > 1 and out[-2].startswith("layer")):
            out[-1] = _BNI_STEM[out[-1]] + suffix
        elif p in ("conv", "bn") and len(out) > 1 and \
                out[-1] in _BNI_BRANCH and out[-2].startswith("inception_"):
            branch = out.pop()
            out[-1] = f"{out[-1]}_{_BNI_BRANCH[branch]}{suffix}"
        else:
            out.append(p)
    return out


def torch_key(path: Tuple[str, ...]) -> str:
    """A flax variable path (collection stripped) -> its torch key."""
    *parts, leaf = path
    out = []
    for p in _caffe_flat(parts):
        if p.startswith("features_"):
            out += ["features", p[len("features_"):]]
        elif p.startswith("conv_") and "features" in out:
            out += ["conv", p[len("conv_"):]]
        elif p in ("c0", "c1") and "features" in out:
            out.append(p[1:])
        elif p.split("_")[0] in ("convs", "bns") and "_" in p:
            out += p.split("_")
        elif p == "sep" or _BYOT_SEP.fullmatch(p):
            out += [p, "op"]
        elif p.startswith("layer") and p.endswith("_rn"):
            out.append(p)                         # DPT's layer{k}_rn
        elif p.startswith("layer") and "_" in p:
            stage, block = p[5:].split("_")
            out += [f"layer{stage}", block]
        elif p == "downsample_conv":
            out += ["downsample", "0"]
        elif p == "downsample_bn":
            out += ["downsample", "1"]
        elif out and out[-1].startswith("scala") and p.startswith("sep"):
            out += [p[3:], "op"]
        elif out and out[-1] == "op":
            out.append(_SEPCONV_SEQ[p])
        elif len(out) == 1 and out[0] in _DECODERS:
            out.append(_decoder_index(p))
        elif out == ["text_encoder"]:
            out.append(_TEXT_SEQ[p])
        else:
            out.append(_ACTION_CHILD.get(p, p))
    if leaf == "shift_w":
        out.append("action_shift")
        leaf = "weight"
    elif leaf == "kernel":
        leaf = "weight"
    else:
        leaf = _BN_LEAF.get(leaf, leaf)
    return ".".join(out + [leaf])


def convert_tensor(t: np.ndarray, key: str) -> np.ndarray:
    """Transpose a flax leaf to torch layout (see the module docstring)."""
    t = np.array(t, np.float32)        # a writable copy for torch
    if key in _RAW:
        return np.ascontiguousarray(t)
    if t.ndim == 4 and key in _FLAX_TCONV:
        return np.ascontiguousarray(t.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    if key.endswith("action_shift.weight"):
        return np.ascontiguousarray(t.T[:, None, :])
    if t.ndim == 2 and key.endswith(_1X1_DENSE):
        return np.ascontiguousarray(t.T[:, :, None, None])
    if t.ndim >= 2:
        order = tuple(range(t.ndim - 1, t.ndim - 3, -1)) + \
            tuple(range(t.ndim - 2))                  # (O, I, *spatial)
        return np.ascontiguousarray(t.transpose(order))
    return np.ascontiguousarray(t)


def state_dict_from_jax(flat: Mapping[Tuple[str, ...], np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """Flattened JAX variables -> the port's ``state_dict`` (f32 CPU
    tensors, no BN ``num_batches_tracked``)."""
    sd = {}
    for path, leaf in flat.items():
        if path[0] not in ("params", "batch_stats"):
            continue
        key = torch_key(tuple(path[1:]))
        sd[key] = torch.from_numpy(convert_tensor(np.asarray(leaf), key))
    return sd


def load_jax_variables(model: nn.Module,
                       flat: Mapping[Tuple[str, ...], np.ndarray]) -> None:
    """Load converted JAX weights into ``model`` with ``strict=True``, and
    each calibrated ``act_scale`` of ``flat`` (the ``quant`` collection)
    into the int8 site of the same name, which must exist."""
    model.load_state_dict(state_dict_from_jax(flat), strict=True)
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for path, leaf in flat.items():
            if path[0] != "quant":
                continue
            key = torch_key(tuple(path[1:]))
            if key not in buffers:
                raise KeyError(f"{key}: no int8 site of that name")
            buffers[key].fill_(float(np.float32(leaf)))


def convert_train_state(flat: Mapping[Tuple[str, ...], np.ndarray]
                        ) -> Dict[str, object]:
    """A JAX ``TrainState`` as numpy arrays -> the port's checkpoint payload
    (``ehgr_tpu_torch.train.checkpoints``), so a port run can resume from a
    JAX run.

    ``flat`` is the state flattened to ``{(tree, *path): array}`` with tree
    one of ``params``, ``batch_stats``, ``ema_params``, ``ema_batch_stats``,
    ``momentum`` (the optimizer's buffers, ``opt_state.momentum``),
    ``hyper`` (``opt_state.hyper``: ``group_lr/<group>``, ``lr_steps``,
    ``gamma``, ``momentum``, ``weight_decay``, ``steps_per_epoch``) and the
    path ``("step",)``.  Every tree is converted by the key and transpose
    rules above; the momentum takes its parameter's."""
    def trees(*names):
        return {(coll,) + p[1:]: a for p, a in flat.items()
                for name, coll in names if p[0] == name}

    hyper = {p[1:]: np.asarray(a) for p, a in flat.items()
             if p[0] == "hyper"}
    f32 = lambda k: float(np.float32(hyper[(k,)]))  # noqa: E731
    return {
        "state_dict": state_dict_from_jax(trees(("params", "params"),
                                                ("batch_stats",
                                                 "batch_stats"))),
        "ema_state_dict": state_dict_from_jax(trees(
            ("ema_params", "params"), ("ema_batch_stats", "batch_stats"))),
        "momentum": state_dict_from_jax(trees(("momentum", "params"))),
        "step": int(flat[("step",)]),
        "schedule": {
            "group_lr": {p[1]: float(a) for p, a in hyper.items()
                         if p[0] == "group_lr"},
            "lr_steps": [int(s) for s in hyper[("lr_steps",)].reshape(-1)
                         if s < _LR_STEP_PAD],
            "gamma": f32("gamma"), "momentum": f32("momentum"),
            "weight_decay": f32("weight_decay"),
            "steps_per_epoch": int(hyper[("steps_per_epoch",)])}}
