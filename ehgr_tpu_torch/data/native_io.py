"""ctypes binding and geometry planner for the native clip decoder (the
port's own binding over ``native/ehgr_io.cpp``, counterpart of
``ehgr_tpu/data/native_io.py``; the C++ source is shared and read only).

``native/ehgr_io.cpp`` fuses decode -> PIL-parity bilinear resize ->
crop(s) -> resize -> flip per frame, multithreaded, into a preallocated
uint8 array.  This module:

* builds the shared library at first use with ``g++ ... -ljpeg -lpng``
  into ``ehgr_tpu_torch/_build/``, named by a hash of the source.  The
  compiler writes a temporary file that is renamed into place under a
  file lock, so concurrent processes (test workers) never load a
  half-written library and never compile into one file at once;
* plans a clip's geometry by walking the same transform objects the PIL
  path uses (``ehgr_tpu_torch/ops/spatial_transforms.py``) and drawing from
  the same rng streams, so a dataset seeded alike gives the same crops
  through either backend;
* ``decode_clip`` is the native path of ``datasets._decode``.

A chain the planner does not cover raises ``UnsupportedChain`` and a file
the decoder cannot read ``IOError``; the dataset then decodes that clip
with PIL.  A library that does not build or load raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import numbers
import os
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ehgr_tpu_torch.ops import spatial_transforms as st

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(_PKG), "native", "ehgr_io.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

_LOCK = threading.Lock()
# source path -> the loaded library, or the error its build or load gave
_LIBS: Dict[str, object] = {}


class UnsupportedChain(Exception):
    """A transform chain the native planner does not cover (the dataset
    decodes that clip with PIL)."""


def build_library(src: str, build_dir: str) -> str:
    """Compile ``src`` (or reuse a build of the same bytes); returns the
    library's path.  The name carries a hash of the source; ``g++`` writes
    a temporary file in ``build_dir`` that ``os.replace`` moves into place
    while this process holds ``build_dir/lock``."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(build_dir, exist_ok=True)
    so = os.path.join(build_dir, f"libehgr_io-{digest}.so")
    if os.path.exists(so):
        return so
    with open(os.path.join(build_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):             # built while this one waited
            return so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-fPIC", "-shared",
                            "-std=c++17", "-pthread", src, "-o", tmp,
                            "-ljpeg", "-lpng"],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    int_p = ctypes.POINTER(ctypes.c_int)
    lib.ehgr_image_size.argtypes = [ctypes.c_char_p, int_p, int_p]
    lib.ehgr_image_size.restype = ctypes.c_int
    lib.ehgr_decode_clip.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, int_p, int_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int]
    lib.ehgr_decode_clip.restype = ctypes.c_int
    lib.ehgr_decode_image.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte)]
    lib.ehgr_decode_image.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The library built from ``SRC`` into ``BUILD_DIR``, built and loaded
    at the first call; a build or load that failed raises ``RuntimeError``
    again at every later call, without retrying."""
    src = SRC
    with _LOCK:
        lib = _LIBS.get(src)
        if lib is None:
            try:
                lib = _bind(ctypes.CDLL(build_library(src, BUILD_DIR)))
            except (OSError, subprocess.CalledProcessError) as e:
                detail = getattr(e, "stderr", "") or ""
                lib = RuntimeError(f"native io unavailable: {e} {detail}")
            _LIBS[src] = lib
    if isinstance(lib, RuntimeError):
        raise lib
    return lib


def available() -> bool:
    """True when the library builds and loads here."""
    try:
        library()
        return True
    except RuntimeError:
        return False


def image_size(path: str) -> Tuple[int, int]:
    """(w, h) from the header only."""
    w, h = ctypes.c_int(), ctypes.c_int()
    if library().ehgr_image_size(path.encode(), ctypes.byref(w),
                                 ctypes.byref(h)) != 0:
        raise IOError(f"cannot read image header: {path}")
    return w.value, h.value


def decode_image(path: str, size: Optional[Tuple[int, int]] = None,
                 gray: bool = False) -> np.ndarray:
    """Decode one image (resized to ``(w, h)`` when given) -> uint8 HWC."""
    lib = library()
    w, h = image_size(path) if size is None else size
    out = np.empty((h, w, 1 if gray else 3), np.uint8)
    rc = lib.ehgr_decode_image(
        path.encode(), 0 if size is None else w, 0 if size is None else h,
        out.shape[2], out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    return out


def _scale_target(size, im_w: int, im_h: int) -> Tuple[int, int]:
    """``GroupScale`` semantics: int = short side, ``[w, h]`` = exact."""
    if isinstance(size, numbers.Number):
        short = int(size)
        if min(im_w, im_h) == short:
            return im_w, im_h
        if im_w < im_h:
            return short, int(round(short * im_h / im_w))
        return int(round(short * im_w / im_h)), short
    return int(size[0]), int(size[1])


def plan_clip(transform, im_w: int, im_h: int, mode: str = "RGB"):
    """Resolve a transform chain into the decoder's geometry
    ``(sw, sh, rects [K, 4], flips [K], out_w, out_h)``, drawing from the
    chain's rng streams exactly as its PIL ``__call__`` would."""
    chain = (list(transform.transforms) if isinstance(transform, st.Compose)
             else [transform])
    sw, sh = 0, 0
    cur_w, cur_h = im_w, im_h
    rects: List[Tuple[int, int, int, int]] = []
    flips: List[int] = []
    out_w = out_h = None
    for i, t in enumerate(chain):
        if isinstance(t, st.IdentityTransform):
            pass
        elif isinstance(t, st.GroupScale):
            if rects:
                raise UnsupportedChain("scale after crop")
            sw, sh = _scale_target(t.size, im_w, im_h)
            cur_w, cur_h = sw, sh
        elif isinstance(t, st.GroupCenterCrop):
            th, tw = t.size
            x1 = int(round((cur_w - tw) / 2.0))
            y1 = int(round((cur_h - th) / 2.0))
            rects, flips = [(x1, y1, tw, th)], [0]
            out_w, out_h = tw, th
        elif isinstance(t, st.GroupRandomCrop):
            th, tw = t.size
            x1 = int(t.rng.integers(0, cur_w - tw + 1))
            y1 = int(t.rng.integers(0, cur_h - th + 1))
            rects, flips = [(x1, y1, tw, th)], [0]
            out_w, out_h = tw, th
        elif isinstance(t, st.GroupMultiScaleCrop):
            cw, ch, ox, oy = t._sample_crop_size((cur_w, cur_h))
            rects, flips = [(ox, oy, cw, ch)], [0]
            out_w, out_h = t.input_size
        elif isinstance(t, st.GroupRandomHorizontalFlip):
            if t.is_flow:
                raise UnsupportedChain("flow flip inversion")
            if not rects:
                rects, flips = [(0, 0, cur_w, cur_h)], [0]
                out_w, out_h = cur_w, cur_h
            if t.rng.random() < 0.5:
                flips = [1] * len(flips)
        elif isinstance(t, (st.GroupFullResSample, st.GroupOverSample)):
            if rects or i != len(chain) - 1:
                raise UnsupportedChain("multi-crop must terminate the chain")
            if t.scale_worker is not None:
                sw, sh = _scale_target(t.scale_worker.size, im_w, im_h)
                cur_w, cur_h = sw, sh
            ch, cw = t.crop_size
            if isinstance(t, st.GroupFullResSample):
                ws = (cur_w - cw) // 4
                hs = (cur_h - ch) // 4
                offsets = [(0, 2 * hs), (4 * ws, 2 * hs), (2 * ws, 2 * hs)]
            else:
                offsets = st.fill_fix_offset(False, cur_w, cur_h, cw, ch)
            if t.flip and mode == "L":
                # PIL inverts flipped grayscale crops at even frame indices
                # (the Flow convention); the decoder flips only
                raise UnsupportedChain("flip+L multi-crop (Flow inversion)")
            for ox, oy in offsets:
                rects.append((ox, oy, cw, ch))
                flips.append(0)
                if t.flip:
                    rects.append((ox, oy, cw, ch))
                    flips.append(1)
            out_w, out_h = cw, ch
        else:
            raise UnsupportedChain(type(t).__name__)
    if not rects:                    # scale-only chain (EgoGesture eval)
        rects, flips = [(0, 0, cur_w, cur_h)], [0]
        out_w, out_h = cur_w, cur_h
    return sw, sh, rects, flips, out_w, out_h


def decode_clip(paths: Sequence[str], indices: np.ndarray, mode: str,
                transform, n_threads: int = 0,
                fast: bool = False) -> np.ndarray:
    """The selected frames through the planned chain -> uint8
    ``[K*T', H, W, C]`` in the PIL multi-crop order (all frames of a crop,
    crops concatenated).  ``fast=True`` allows DCT-scaled JPEG decode
    before a downscale: the same geometry, pixels no longer PIL's."""
    lib = library()
    sel = [paths[int(i)] for i in np.asarray(indices).reshape(-1)]
    im_w, im_h = image_size(sel[0])
    sw, sh, rects, flips, ow, oh = plan_clip(
        transform if transform is not None else st.IdentityTransform(),
        im_w, im_h, mode=mode)
    k, t = len(rects), len(sel)
    c = 1 if mode == "L" else 3
    out = np.empty((k, t, oh, ow, c), np.uint8)
    c_paths = (ctypes.c_char_p * t)(*[p.encode() for p in sel])
    c_rects = (ctypes.c_int * (k * 4))(*[v for r in rects for v in r])
    c_flips = (ctypes.c_int * k)(*flips)
    rc = lib.ehgr_decode_clip(
        c_paths, t, im_w, im_h, sw, sh, c_rects, c_flips, k, ow, oh, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), n_threads,
        int(fast))
    if rc != 0:
        raise IOError(f"native clip decode failed (rc={rc}, first={sel[0]})")
    return out.reshape(k * t, oh, ow, c)
