"""One SIFT octave in one pass: Gaussian chain, DoG and extrema score.

Counterpart of ``pano360_tpu.ops.pallas_gauss.octave_stack``. The CUDA
kernel (``csrc/gauss_octave.cu``) runs on CUDA tensors; the plain
PyTorch version ``octave_stack_ref`` computes the same function and is
what a CPU tensor gets. Semantics (both): the (N, H, W) base is
reflect101-extended ONCE by the chain's cumulative halo, each layer is a
separable blur of the previous one with the ``chain_taps`` taps, and
the score is |DoG| at thresholded 26-neighbour extrema that pass the
integer-position edge test and lie ``border`` px inside the image.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pano360_tpu_torch import _kernels

MAX_TAPS = 64          # per-layer tap capacity of the CUDA kernel
launches = 0           # CUDA kernel launches (main-path evidence)


def chain_taps(sigma: float, n_layers: int) -> Tuple[Tuple[float, ...], ...]:
    """The incremental chain's per-layer 1-D taps (f64 -> normalize -> f32)."""
    s = n_layers
    k = 2.0 ** (1.0 / s)
    sigs = [sigma * (k ** i) for i in range(s + 3)]
    out = []
    for i in range(1, s + 3):
        d = math.sqrt(sigs[i] ** 2 - sigs[i - 1] ** 2)
        ks = int(round(d * 4 * 2 + 1)) | 1
        x = np.arange(ks, dtype=np.float64) - (ks - 1) / 2.0
        g = np.exp(-(x * x) / (2.0 * d * d))
        out.append(tuple((g / g.sum()).astype(np.float32).tolist()))
    return tuple(out)


def chain_halo(taps: Sequence[Sequence[float]]) -> int:
    """Cumulative half-extent of the chained convolutions."""
    return sum(len(t) // 2 for t in taps)


def reflect_legal(h: int, w: int, taps) -> bool:
    """The single reflect101 extension is defined (halo < min(h, w))."""
    return chain_halo(taps) < min(h, w)


def _extrema_score(dog: torch.Tensor, thresh: float, edge_r: float,
                   border: int) -> torch.Tensor:
    """Dense extrema score of (N, L, H, W) DoG -> (N, L-2, H, W); the
    stencils and their evaluation order are ``sift._octave_candidates``'s."""
    n, nl, h, w = dog.shape
    padded = torch.nn.functional.pad(dog, (1, 1, 1, 1, 1, 1),
                                     value=-math.inf)
    mx = torch.nn.functional.max_pool3d(padded[:, None], 3, 1)[:, 0]
    padded = torch.nn.functional.pad(dog, (1, 1, 1, 1, 1, 1),
                                     value=math.inf)
    mn = -torch.nn.functional.max_pool3d(-padded[:, None], 3, 1)[:, 0]
    center = dog[:, 1:-1]
    thr = torch.tensor(thresh, dtype=dog.dtype, device=dog.device)
    is_ext = (((center >= mx[:, 1:-1]) & (center > thr))
              | ((center <= mn[:, 1:-1]) & (center < -thr)))
    ys = torch.arange(h, device=dog.device)[None, None, :, None]
    xs = torch.arange(w, device=dog.device)[None, None, None, :]
    b = border
    is_ext &= (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)

    dxx = (center[..., :, 2:] - 2 * center[..., :, 1:-1]
           + center[..., :, :-2])
    dyy = (center[..., 2:, :] - 2 * center[..., 1:-1, :]
           + center[..., :-2, :])
    dxy = (center[..., 2:, 2:] - center[..., 2:, :-2]
           - center[..., :-2, 2:] + center[..., :-2, :-2]) * 0.25
    pad = torch.nn.functional.pad
    dxx = pad(dxx, (1, 1))
    dyy = pad(dyy, (0, 0, 1, 1))
    dxy = pad(dxy, (1, 1, 1, 1))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = torch.tensor(edge_r, dtype=dog.dtype, device=dog.device)
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
    return torch.where(is_ext & edge_ok, torch.abs(center),
                       torch.zeros_like(center))


def octave_stack_ref(base: torch.Tensor, taps, score_cfg=None):
    """Plain PyTorch version: (N, H, W) f32 -> (gauss (N, L+1, H, W),
    dog (N, L, H, W)[, score (N, L-2, H, W)])."""
    n, h, w = base.shape
    halo = chain_halo(taps)
    if not reflect_legal(h, w, taps):
        raise ValueError(f"octave {h}x{w} too small for halo {halo}")
    cur = torch.nn.functional.pad(base[:, None], (halo,) * 4,
                                  mode="reflect")[:, 0]
    m = halo
    gauss = [base]
    dogs = []
    for t in taps:
        hh = len(t) // 2
        k = torch.tensor(t, dtype=base.dtype, device=base.device)
        rows = cur.shape[1] - 2 * hh
        acc = None
        for i in range(len(t)):
            term = cur[:, i:i + rows, :] * k[i]
            acc = term if acc is None else acc + term
        cols = acc.shape[2] - 2 * hh
        nxt = None
        for i in range(len(t)):
            term = acc[:, :, i:i + cols] * k[i]
            nxt = term if nxt is None else nxt + term
        m -= hh
        dog = nxt - cur[:, hh:hh + nxt.shape[1], hh:hh + nxt.shape[2]]
        gauss.append(nxt[:, m:m + h, m:m + w])
        dogs.append(dog[:, m:m + h, m:m + w])
        cur = nxt
    gauss = torch.stack(gauss, dim=1)
    dog = torch.stack(dogs, dim=1)
    if score_cfg is None:
        return gauss, dog
    return gauss, dog, _extrema_score(dog, *score_cfg)


@functools.lru_cache(maxsize=None)
def _c_taps(taps):
    """The kernel's (taps, ksizes) host arrays: (n_lay, MAX_TAPS) f32
    zero-padded, and the per-layer kernel sizes."""
    nl = len(taps)
    flat = (ctypes.c_float * (nl * MAX_TAPS))()
    for i, t in enumerate(taps):
        flat[i * MAX_TAPS:i * MAX_TAPS + len(t)] = t
    return flat, (ctypes.c_int * nl)(*[len(t) for t in taps])


def _check_base(base: torch.Tensor, taps) -> None:
    if base.dtype != torch.float32 or base.ndim != 3:
        raise ValueError("octave_stack takes an (N, H, W) float32 base, got "
                         f"{tuple(base.shape)} {base.dtype}")
    if not base.is_contiguous():
        raise ValueError("octave_stack takes a contiguous base")
    if not 3 <= len(taps) <= 8 or max(len(t) for t in taps) > MAX_TAPS:
        raise ValueError("octave_stack supports 3..8 layers of <= "
                         f"{MAX_TAPS} taps")
    if not reflect_legal(base.shape[1], base.shape[2], taps):
        raise ValueError("octave_stack needs halo < min(H, W)")


def octave_stack(base: torch.Tensor, taps, score_cfg=None):
    """One octave: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor. ``score_cfg``: optional (thresh, edge_r, border)."""
    global launches
    if base.device.type == "cpu":
        return octave_stack_ref(base, taps, score_cfg)
    if base.device.type != "cuda":
        raise ValueError(f"octave_stack: unsupported device {base.device}")
    _check_base(base, taps)
    n, h, w = base.shape
    nl = len(taps)
    c_taps, c_ksizes = _c_taps(tuple(tuple(t) for t in taps))
    gauss = torch.empty((n, nl + 1, h, w), dtype=base.dtype,
                        device=base.device)
    dog = torch.empty((n, nl, h, w), dtype=base.dtype, device=base.device)
    score: Optional[torch.Tensor] = None
    thresh, edge_r, border = 0.0, 0.0, 0
    if score_cfg is not None:
        thresh, edge_r, border = score_cfg
        score = torch.empty((n, nl - 2, h, w), dtype=base.dtype,
                            device=base.device)
    code = _kernels.lib().p360_octave_stack(
        base.data_ptr(), gauss.data_ptr(), dog.data_ptr(),
        score.data_ptr() if score is not None else None, n, h, w,
        ctypes.cast(c_taps, ctypes.c_void_p),
        ctypes.cast(c_ksizes, ctypes.c_void_p), nl,
        float(thresh), float(edge_r), int(border),
        _kernels.stream_ptr(base.device))
    _kernels.check(code, "p360_octave_stack")
    launches += 1
    if score is None:
        return gauss, dog
    return gauss, dog, score


__all__ = ["chain_taps", "chain_halo", "reflect_legal", "octave_stack",
           "octave_stack_ref"]
