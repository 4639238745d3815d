"""Build, load and call the port's CUDA kernels: ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``.

The library is built at first use into ``ehgr_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of its source, the shared headers and the
flags, so an edited source or header builds anew and an unchanged one loads
at once.  A failed build raises; nothing falls back.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points of each library: name -> argtypes (restype is int: the
# cudaError_t of the launches, or the count a ``..._rows`` entry returns)
SIGNATURES: Dict[str, Dict[str, list]] = {
    "action_mega": {
        # dtype, x, w, wp3, mc, pool, x3, part, n, t, s, c, cr, stream
        "ehgr_action_stats": [_I, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P],
        # dtype, x, w, g1, gch, wn, out, n, t, s, c, f, stream
        "ehgr_action_apply": [_I, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P],
        # dtype, x, w, wp3, xs, mc, pool, x3, part, n, t, s, c, cr, stream
        "ehgr_action_prologue": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _P],
        # n, t, s -> rows of part (returned)
        "ehgr_action_pool_scratch_rows": [_I, _I, _I],
    },
    "action_stats": {
        # dtype (bf16 only), x, w, wp3, mc, pool, x3, part, n, t, s, c, cr,
        # stream
        "ehgr_action_stats_window": [_I, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _P],
        # dtype, x, w, wp3, xs, mc, pool, x3, part, n, t, s, c, cr, stream
        "ehgr_action_prologue_window": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I, _P],
        # n, t, s, c, cr, int[8] out: blocks, TG, N, strips, frame groups,
        # threads, stages, shared memory bytes
        "ehgr_action_stats_window_grid": [_I, _I, _I, _I, _I, _P],
        # n, t, s -> rows of part (returned)
        "ehgr_action_pool_scratch_rows": [_I, _I, _I],
    },
    "action_apply": {
        # dtype (bf16 only), x, w, g1, gch, wn, out, n, t, s, c, f, stream
        "ehgr_action_apply_strip": [_I, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _P],
        # rows, f, int[4] out: strips, column blocks, BN, BM
        "ehgr_action_apply_strip_grid": [_I, _I, _P],
    },
    "tsm_shift": {
        # dtype, x, y, n, t, s, c, fold, reverse, vec, bx, by, gx, gy, stream
        "ehgr_tsm_shift": [_I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _P],
    },
    "shift": {
        # dtype, x, w, y, n, t, s, c, vec, bx, by, gx, gy, stream
        "ehgr_shift_fwd": [_I, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _P],
        # dtype, x, g, w, dx, part, dw, n, t, s, c, vec, bx, by, gx, gy,
        # stream
        "ehgr_shift_bwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _P],
    },
    "shift_bwd": {
        # dtype (bf16 only), x, g, w, dx, part, dw, n, t, s, c, rows,
        # strips, finish columns, stream
        "ehgr_shift_bwd_strip": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _P],
    },
    "int8_conv": {
        # dtype (of x and out), x, xs, w, ws, out, n, h, w, cin, cout, kh,
        # kw, stride, pad, ho, wo, stream
        "ehgr_int8_conv_fused": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _P],
        # dtype, m, cout, k, int[5] out: blocks, BN, BM, x ring stages,
        # shared memory bytes
        "ehgr_int8_conv_grid": [_I, _I, _I, _I, _P],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}

# dtype argument of every entry point
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by a hash of the source,
    every shared header of ``csrc/`` (``*.cuh``, which a source may
    include) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless the hashed library exists; returns
    its path.  ``verbose`` adds ``-Xptxas -v`` and prints the compiler's
    report (registers, shared memory, spills)."""
    out = library_path(name)
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        if verbose:
            print(proc.stderr, end="")
        os.replace(tmp, out)        # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library with ``argtypes``/``restype`` set (built first if
    needed)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check_operands(name: str, x4: torch.Tensor,
                   dtypes: Tuple[torch.dtype, ...] = tuple(DTYPE_CODE),
                   **operands: torch.Tensor) -> None:
    """Same device and dtype (one of ``dtypes``: fp32 or bf16 unless the
    caller names others) for every operand, each contiguous, with the
    shapes the caller already asserted."""
    if x4.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x4.dtype} (one of {dtypes})")
    for k, v in dict(x4=x4, **operands).items():
        if v.dtype != x4.dtype or v.device != x4.device:
            raise TypeError(f"{name}: {k} is {v.dtype} on {v.device}, x4 is "
                            f"{x4.dtype} on {x4.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")
    if x4.device.type == "cuda" and \
            x4.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {x4.device}, current device "
                         f"is cuda:{torch.cuda.current_device()}")
    if x4.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x4.device}")


def launch(name: str, fn: str, x4: torch.Tensor, *args) -> None:
    """Call entry point ``fn`` of library ``name`` (built first if needed)
    with ``x4``'s dtype code, ``args`` and the current stream of ``x4``'s
    device; raise if the launch reports a CUDA error."""
    entry = getattr(load(name), fn)
    stream = torch.cuda.current_stream(x4.device).cuda_stream
    err = entry(DTYPE_CODE[x4.dtype], *args, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed (cudaError {err})")
