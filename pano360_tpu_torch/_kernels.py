"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` into one shared
library with a plain C interface, loaded through ``ctypes`` (no PyTorch
headers, so the build takes seconds). The library is cached under
``build/kernels/`` at the repository root and rebuilt when the sources
change (a content hash names the file).

Each C entry point takes raw device pointers, sizes and the CUDA stream
and returns ``cudaGetLastError()`` after its launch; ``check`` turns a
non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
LIB_NAME = "libpano360_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # no a*b+c contraction: the blur chain and the warp keep the JAX
    # package's separate multiply-then-add rounding
    "-fmad=false",
]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # base, gauss, dog, score, n, h, w, taps(host), ksizes(host), n_lay,
    # thresh, edge_r, border, stream
    "p360_octave_stack": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _I,
                          _F, _F, _I, _P],
    # imgs, projs, bottoms, wins, patches, invalid, n, h, w, ph, pw,
    # res_x, res_y, rmin_x, rmin_y, period, stream
    "p360_backward_warp": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _F, _F, _F, _F, _I, _P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{LIB_NAME}_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into the cached shared library (if stale)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
        return _LIB


def check(code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


__all__ = ["build", "lib", "check", "stream_ptr", "library_path",
           "BUILD_DIR"]
