"""Native (C++) host-side components, built on demand with g++
(counterpart of ``pano360_tpu.native``).

These are the host's sequential hot loops where the reference leaned on
native code too (Numba-JIT crop, stitcher.py:330-369; heapq seam flood,
blend.py:56-100; MSOP's SSC selection). ``crop.cpp`` holds all three:
the crop rectangle, the seam flood and the SSC selection. It is compiled
at first use into ``build/native/`` at the repository root (gitignored),
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
        lib.seam_flood.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int8)]
        lib.ssc_select.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int)]
        lib.ssc_select.restype = ctypes.c_int
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


def loaded() -> bool:
    """Whether the native library is (or can be) built and loaded."""
    return _build() is not None


def seam_flood(diff: np.ndarray, border: int) -> np.ndarray:
    """Two-source priority flood for graph-cut style seams: an int8 mask
    of -1 (left source) / +1 (right source)."""
    diff = np.ascontiguousarray(diff.astype(np.float32))
    rows, cols = diff.shape
    lib = _build()
    if lib is None:
        return _seam_flood_py(diff, border)
    mask = np.zeros((rows, cols), np.int8)
    lib.seam_flood(diff.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                   rows, cols, border,
                   mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return mask


def _seam_flood_py(diff: np.ndarray, border: int) -> np.ndarray:
    import heapq
    rows, cols = diff.shape
    mask = np.zeros((rows, cols), np.int32)
    mask[:, :border] = -1
    mask[:, cols - border + 1:] = 1
    qq = []
    for y in range(rows):
        qq.append((-1e3, -1, border, y))
        qq.append((-1e3, 1, cols - border, y))
    heapq.heapify(qq)
    while qq:
        _, clr, x, y = heapq.heappop(qq)
        if mask[y, x] != 0:
            continue
        mask[y, x] = clr
        for dx, dy in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            nx, ny = x + dx, y + dy
            if 0 <= nx < cols and 0 <= ny < rows and mask[ny, nx] == 0:
                heapq.heappush(qq, (-diff[ny, nx], clr, nx, ny))
    return mask.astype(np.int8)


def ssc_select(kpts_xy: np.ndarray, im_size, n_points: int,
               tol: float = 0.1) -> Optional[np.ndarray]:
    """SSC adaptive non-maximal suppression over score-ordered (x, y)
    keypoints: the selected indices, or None when the native library is
    unavailable (``features.msop.ssc`` then runs its Python version)."""
    lib = _build()
    if lib is None:
        return None
    kp = np.ascontiguousarray(kpts_xy, np.float32)
    out = np.empty(len(kp), np.int32)
    cols, rows = im_size
    n = lib.ssc_select(
        kp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(kp),
        int(cols), int(rows), int(n_points), float(tol),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out[:n].copy()


__all__ = ["largest_rectangle", "crop_mosaic", "seam_flood", "ssc_select",
           "loaded", "library_path", "BUILD_DIR"]
