"""Each hand-written kernel's least time: the bytes it must move once and
the operations it must do at one launch, over the NVIDIA H100 SXM's
published peaks (data sheet, dense rates, 700 W).

Bytes count every input element read once and every output written once;
bf16 data is 2 bytes an element.  The ACTION kernels' products run on the
tensor cores (bf16 peak); the learnable shift's multiply-adds run on the
CUDA cores (float32 peak, 5 FLOPs an element forward, 11 backward); the TSM
shift is a copy and reads none of the channels it zeroes at a clip's
edges.  ``bound_s = max(bytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])``.

Sites: the ResNet bottlenecks whose first 1x1 conv carries the temporal
module.  Each runs at its stage's input resolution (the first block of a
stage strides in its 3x3 conv, after the site).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# every kernel of the program's ``csrc/`` (a test holds this to its
# ``__global__`` functions) -> the launch it belongs to.  A launch's first
# kernel (``FIRST_KERNEL``) counts its launches; the others finish its
# work: the pooled mean of ACTION's statistics (``pool_reduce``), the
# taps' gradient of the shift backward (``dw_finish``).  The routes for
# float32 and odd shapes (``sweep_kernel``, ``dw_reduce``) and
# ``int8_conv`` have no least time here: ``reading.kernel_roofline``
# refuses a trace that holds them.
KERNELS = {
    "stats_window_kernel": "action_stats",
    "pool_reduce": "action_stats",
    "apply_strip_kernel": "action_apply",
    "sweep_kernel": "action_sweep",
    "shift_sweep": "learnable_shift_fwd",
    "shift_bwd_strip": "learnable_shift_bwd",
    "dw_finish": "learnable_shift_bwd",
    "dw_reduce": "learnable_shift_bwd_sweep",
    "tsm_sweep": "tsm_shift",
    "int8_conv_kernel": "int8_conv",
}
FIRST_KERNEL = {"action_stats": "stats_window_kernel",
                "action_apply": "apply_strip_kernel",
                "action_sweep": "sweep_kernel",
                "learnable_shift_fwd": "shift_sweep",
                "learnable_shift_bwd": "shift_bwd_strip",
                "learnable_shift_bwd_sweep": "dw_reduce",
                "tsm_shift": "tsm_sweep",
                "int8_conv": "int8_conv_kernel"}


def resnet_sites(crop: int, stage_sizes=(3, 4, 6, 3)
                 ) -> List[Tuple[int, int, int]]:
    """``(S, C, F)`` of every bottleneck's first conv in order: ``S`` the
    pixels of a frame at its input, ``C`` its input and ``F`` its output
    channels."""
    side = crop // 4                                   # after stem and pool
    sites, cin = [], 64
    for i, (blocks, planes) in enumerate(zip(stage_sizes,
                                             (64, 128, 256, 512)), 1):
        for j in range(blocks):
            sites.append((side * side, cin, planes))
            if i > 1 and j == 0:
                side = (side + 1) // 2
            cin = planes * 4
    return sites


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])


def action_stats(n, t, s, c, f) -> float:
    rows, cr = n * t * s, c // 16
    nbytes = 2 * (rows * c + 3 * c + c * cr + rows + n * t * c + rows * cr)
    return bound_s(nbytes, 2 * rows * c * cr, "bfloat16")


def action_apply(n, t, s, c, f) -> float:
    rows = n * t * s
    nbytes = 2 * (rows * c + 3 * c + rows + n * t * c + c * f + rows * f)
    return bound_s(nbytes, 2 * rows * c * f, "bfloat16")


def learnable_shift_fwd(n, t, s, c, f) -> float:
    elems = n * t * s * c
    return bound_s(2 * (2 * elems + 3 * c), 5 * elems, "float32")


def learnable_shift_bwd(n, t, s, c, f) -> float:
    elems = n * t * s * c
    return bound_s(2 * (3 * elems + 6 * c), 11 * elems, "float32")


def tsm_shift(n, t, s, c, f, fold_div=8) -> float:
    fold = c // fold_div
    return bound_s(2 * (2 * n * t * s * c - 2 * fold * n * s), 0, "bfloat16")


LAUNCH = {"action_stats": action_stats, "action_apply": action_apply,
          "learnable_shift_fwd": learnable_shift_fwd,
          "learnable_shift_bwd": learnable_shift_bwd, "tsm_shift": tsm_shift}


def launches_per_call(temporal: str, train: bool) -> Dict[str, int]:
    """The kernels a served call or a train step launches at every site,
    and how often: ACTION's two sweeps (and in training the shift's
    recompute and backward), TSM's shift (and its reverse in training)."""
    if temporal == "action":
        out = {"action_stats": 1, "action_apply": 1}
        if train:
            out.update(learnable_shift_fwd=1, learnable_shift_bwd=1)
        return out
    if temporal == "tsm":
        return {"tsm_shift": 2 if train else 1}
    return {}


def bounds_per_call(model: Dict, clips: int, train: bool
                    ) -> Dict[str, Tuple[int, float]]:
    """Launch name -> (launches, summed least seconds) of one call or step
    of ``clips`` clips."""
    t = model["num_segments"]
    sites = resnet_sites(model["crop"], model["stage_sizes"])
    out = {}
    for name, per_site in launches_per_call(model["temporal"], train).items():
        fn = LAUNCH[name]
        kw = {"fold_div": model["shift_div"]} if name == "tsm_shift" else {}
        total = sum(fn(clips, t, s, c, f, **kw) for s, c, f in sites)
        out[name] = (per_site * len(sites), per_site * total)
    return out


def kernel_ident(trace_name: str) -> str:
    """The function's own name in a trace's kernel name:
    ``void (anonymous namespace)::tsm_sweep<unsigned short, 8>(...)`` ->
    ``tsm_sweep``."""
    name = trace_name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].strip()
    return name.split()[-1].split("::")[-1] if name else name


def launch_of(trace_name: str):
    """``(launch, kernel)`` of a trace's kernel name when the kernel is one
    of the program's, else None."""
    ident = kernel_ident(trace_name)
    return (KERNELS[ident], ident) if ident in KERNELS else None
