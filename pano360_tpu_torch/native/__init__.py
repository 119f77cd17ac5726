"""Native (C++) host-side components, built on demand with g++
(counterpart of ``pano360_tpu.native``).

These are the host's sequential hot loops where the reference leaned on
native code too (Numba-JIT crop, stitcher.py:330-369; heapq seam flood,
blend.py:56-100; MSOP's SSC selection). ``crop.cpp`` is all of
``pano360_tpu/native/crop.cpp``; only the crop is bound here, the seam
flood and SSC selection come with their callers. It is compiled at
first use into ``build/native/`` at the repository root (gitignored),
named by a hash of the source and the flags, so an edited source builds
anew and nothing is written beside the source. A pure-Python fallback
keeps the package importable when no compiler is available, mirroring
the reference's optional-Numba behavior (``try_jit``).
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

LOG = logging.getLogger(__name__)
SRC = Path(__file__).resolve().parent / "crop.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """The cached library of ``crop.cpp`` (named by content hash)."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libp360_native_{digest.hexdigest()[:16]}.so"


def _build() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    try:
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                           check=True, capture_output=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        lib.largest_rectangle.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        _lib = lib
    except (subprocess.CalledProcessError, OSError) as exc:
        LOG.warning("native build failed (%s); using Python fallback", exc)
    return _lib


def largest_rectangle(valid: np.ndarray):
    """Maximal all-valid rectangle bounds (top, left, bottom, right)."""
    valid = np.ascontiguousarray(valid.astype(np.uint8))
    h, w = valid.shape
    lib = _build()
    if lib is not None:
        out = (ctypes.c_int * 4)()
        lib.largest_rectangle(
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            h, w, out)
        return out[0], out[1], out[2], out[3]
    return _largest_rectangle_py(valid)


def _largest_rectangle_py(valid: np.ndarray):
    """Pure-Python fallback (same histogram/stack algorithm)."""
    h, w = valid.shape
    heights = np.zeros(w, np.int64)
    best = (0, 0, 0, -1, -1)
    for i in range(h):
        heights = np.where(valid[i], heights + 1, 0)
        stack = []
        for j in range(w + 1):
            hh = heights[j] if j < w else 0
            while stack and heights[stack[-1]] >= hh:
                k = stack.pop()
                hk = int(heights[k])
                lk = stack[-1] + 1 if stack else 0
                area = hk * (j - lk)
                if area > best[0]:
                    best = (area, i - hk + 1, lk, i, j - 1)
            stack.append(j)
    return best[1], best[2], best[3], best[4]


def crop_mosaic(mosaic: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Crop to the largest fully valid rectangle (stitcher.py:341-369)."""
    top, left, bottom, right = largest_rectangle(valid)
    if bottom < top or right < left:
        return mosaic
    return mosaic[top:bottom + 1, left:right + 1]


__all__ = ["largest_rectangle", "crop_mosaic", "library_path", "BUILD_DIR"]
