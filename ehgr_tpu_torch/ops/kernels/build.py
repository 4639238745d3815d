"""Build, load and call the port's CUDA kernels: ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``.

The library is built at first use into ``ehgr_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of its sources and flags, so an edited
source builds anew and an unchanged one loads at once.  A failed build
raises; nothing falls back.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points of each library: name -> argtypes (restype is int, the
# cudaError_t of the launches)
SIGNATURES: Dict[str, Dict[str, list]] = {
    "action_mega": {
        # dtype, x, w, wp3, mc, pool, x3, pool_acc, n, t, s, c, cr, stream
        "ehgr_action_stats": [_I, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P],
        # dtype, x, w, g1, gch, wn, out, n, t, s, c, f, stream
        "ehgr_action_apply": [_I, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P],
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
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
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
                   **operands: torch.Tensor) -> None:
    """Same device and dtype (fp32 or bf16) for every operand, each
    contiguous, with the shapes the caller already asserted."""
    if x4.dtype not in DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x4.dtype} (fp32 or bf16 only)")
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
