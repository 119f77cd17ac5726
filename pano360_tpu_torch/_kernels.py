"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` into its own shared
library with a plain C interface, loaded through ``ctypes`` (no PyTorch
headers, so a build takes seconds); the ``nvcc`` processes of all sources
run at once. The libraries are cached under ``build/kernels/`` at the
repository root and rebuilt when their source, the shared headers
(``csrc/*.cuh``) or the flags change (a content hash names each file).

Each C entry point takes raw device pointers, sizes and the CUDA stream
and returns ``cudaGetLastError()`` after its launch. Every launch goes
through ``launch``, which turns a non-zero code into an exception and
counts the launch in ``LAUNCHES``, the one registry of kernel launches
(``graphs.Launches`` adds a captured step's at each replay;
``profiling.snapshot`` reports it). ``build_log`` returns what ``nvcc``
(with ptxas's ``-v`` report of registers, shared memory and spills)
printed when it built a library, kept in a ``.log`` file beside it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import types
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # no a*b+c contraction: the blur chain and the warp keep the JAX
    # package's separate multiply-then-add rounding
    "-fmad=false",
    "-Xptxas=-v",
]

_LOCK = threading.Lock()
_LIB: Optional[types.SimpleNamespace] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
MAX_LEVELS = 16        # the mip warp's level capacity (backward_warp_mip.cu)


class WarpView(ctypes.Structure):
    """A warp launch's scalars (``p360::View``, csrc/warp_common.cuh)."""
    _fields_ = [("n", _I), ("ph", _I), ("pw", _I), ("period", _I),
                ("cylindrical", _I), ("res_x", _F), ("res_y", _F),
                ("rmin_x", _F), ("rmin_y", _F)]


class MipLaunch(ctypes.Structure):
    """The mip warp's launch scalars (``MipLaunch``,
    csrc/backward_warp_mip.cu)."""
    _fields_ = [("vw", WarpView), ("h", _I), ("w", _I), ("win_y", _I),
                ("win_x", _I), ("n_levels", _I), ("hp", _I * MAX_LEVELS),
                ("wp", _I * MAX_LEVELS)]


# entry points by source file (csrc/<stem>.cu)
_SIGNATURES = {
    "gauss_octave": {
        # base, gauss, dog, score, n, h, w, taps(host), ksizes(host),
        # n_lay, thresh, edge_r, border, stream
        "p360_octave_stack": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _I,
                              _F, _F, _I, _P],
    },
    "backward_warp": {
        # launch scalars (host), imgs, h, w, params, patches, invalid,
        # stream
        "p360_backward_warp": [ctypes.POINTER(WarpView), _P, _I, _I, _P, _P,
                               _P, _P],
    },
    "sift_refine": {
        # dog, l0, y0, x0, l, y, x, offs, contrast, ok, n, c, n_layers,
        # h, w, border, iters, contrast_thresh, edge_r, (edge_r + 1)^2,
        # stream
        "p360_sift_refine": [_P] * 10 + [_I] * 7 + [_F] * 3 + [_P],
    },
    "sift_orient": {
        # gx, gy, y, x, pcy, pcx, oh, ow, sig, angles, valid, m, psg,
        # bins / 2 pi, 2 pi / bins, stream
        "p360_sift_orient": [_P] * 11 + [_I, _I, _F, _F, _P],
        "p360_sift_orient_block": [_P] * 11 + [_I, _I, _F, _F, _P],
    },
    "sift_descr": {
        # gx, gy, yf, xf, sig, pcy, pcx, oh, ow, angle, desc, m, n_ori,
        # psg, 2 pi, ori_bins / 2 pi, mag_thresh, stream
        "p360_sift_descr": [_P] * 11 + [_I, _I, _I, _F, _F, _F, _P],
    },
    "sift_base": {
        # gray, out, n, h, w, upscale, taps(host), k, stream
        "p360_sift_base": [_P, _P, _I, _I, _I, _I, _P, _I, _P],
    },
    "sift_small_octave": {
        # base, gauss, dog, score, scratch (or null), n, h, w, taps(host),
        # ksizes(host), n_lay, thresh, edge_r, border, stream
        "p360_sift_small_octave": [_P] * 5 + [_I] * 3 + [_P, _P, _I, _F,
                                                         _F, _I, _P],
    },
    "ransac_score": {
        # homs, p1, p2, valid, part, best, mask, counts (or null), b, k,
        # m, thresh^2, stream
        "p360_ransac_score": [_P] * 8 + [_I, _I, _I, _F, _P],
    },
    "knn2": {
        # desc1, desc2, valid1, valid2, norms, part, best, good, b, m1, m2,
        # d, slices, ratio, stream
        "p360_knn2": [_P] * 8 + [_I] * 5 + [_F, _P],
    },
    "band_blur": {
        # in, mid, out, n, h, w, taps(host), k, stream
        "p360_band_blur": [_P, _P, _P, _I, _I, _I, _P, _I, _P],
    },
    "backward_warp_mip": {
        # launch scalars (host), level_ptrs (host), origins, params,
        # patches, invalid, stream
        "p360_backward_warp_mip": [ctypes.POINTER(MipLaunch), _P, _P, _P,
                                   _P, _P, _P],
    },
}


_PREFIX = "p360_"
# launches of every entry point since the process began, by its name
# without the prefix: the wrappers count here, and nowhere else
LAUNCHES: Dict[str, int] = {name[len(_PREFIX):]: 0
                            for entries in _SIGNATURES.values()
                            for name in entries}


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


def library_path(stem: str) -> Path:
    """The cached library of ``csrc/<stem>.cu`` (named by content hash)."""
    digest = hashlib.sha256()
    for src in [CSRC / f"{stem}.cu"] + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libp360_{stem}_{digest.hexdigest()[:16]}.so"


def build() -> Dict[str, Path]:
    """Compile every stale ``csrc/*.cu`` into its cached library, all
    ``nvcc`` processes at once; -> {stem: library path}."""
    out = {stem: library_path(stem) for stem in _SIGNATURES}
    stale = {stem: p for stem, p in out.items() if not p.exists()}
    if not stale:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs: List = []
    try:
        for stem, path in stale.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            procs.append((stem, cmd, tmp, path, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        errors = []
        for stem, cmd, tmp, path, proc in procs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{stdout}\n{stderr}")
            else:
                path.with_suffix(".log").write_text(stdout + stderr)
                os.replace(tmp, path)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build_log(stem: str) -> str:
    """What nvcc and ptxas printed when ``csrc/<stem>.cu`` was built."""
    log = library_path(stem).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def lib() -> types.SimpleNamespace:
    """Every kernel entry point by name (libraries built on first call)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            fns = {}
            for stem, path in build().items():
                handle = ctypes.CDLL(str(path))
                for name, argtypes in _SIGNATURES[stem].items():
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[name] = fn
            _LIB = types.SimpleNamespace(**fns)
        return _LIB


def launch(entry: str, *args) -> None:
    """Call the kernel entry point ``entry`` (``p360_<name>``) of ``lib()``
    with ``args``: raise if it returned a CUDA error code, else count one
    launch in ``LAUNCHES[name]``."""
    code = getattr(lib(), entry)(*args)
    if code != 0:
        raise RuntimeError(f"{entry}: CUDA error {code} at launch")
    LAUNCHES[entry[len(_PREFIX):]] += 1


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on a CUDA ``device``
    (the call that PyTorch's own generated kernels launch with)."""
    import torch
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


__all__ = ["build", "lib", "launch", "LAUNCHES", "stream_ptr",
           "library_path", "build_log", "BUILD_DIR", "NVCC_FLAGS", "WarpView",
           "MipLaunch", "MAX_LEVELS"]
