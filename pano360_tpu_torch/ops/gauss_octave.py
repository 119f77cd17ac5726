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

from pano360_tpu_torch import _kernels, graphs

MAX_TAPS = 64          # per-layer tap capacity of the CUDA kernel

# the card's peaks for the bound (NVIDIA H100 SXM data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# operations of one score pixel, as the kernel does them: 27-value max
# and min (54), the extremum test (4), dxx/dyy (3 each), dxy (4), trace
# (1), determinant (3), edge test (5), |DoG| (1)
SCORE_OPS = 78

# the kernel's tile choice (csrc/gauss_octave.cu, pick_tile), mirrored
_TILE_X_MAX, _TILE_Y_MAX, _BAND, _R_MAX, _SMEM_MAX = 192, 96, 16, 8, 232448
_SMS = 132             # SMs of an H100 SXM


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


def _smem_bytes(ty: int, tx: int, m0: int) -> int:
    need = tx + 2 * m0
    pb = need + (33 - need % 32) % 32
    return 4 * ((ty + 2 * m0) * (tx + 2 * m0) + 3 * (ty + 2) * (tx + 2)
                + _BAND * pb + _R_MAX)


def _block_cost(ty: int, tx: int, ksizes) -> int:
    """The kernel's issue-time model of one block (``block_cost``)."""
    cost = 0
    m = sum(k // 2 for k in ksizes) + 1
    for k in ksizes:
        r = 8 if k <= 31 else 4
        mn = m - k // 2
        vtasks = -(-(tx + 2 * m) // 32) * (_BAND // r)
        nch = -(-(tx + 2 * mn) // r)
        pair = 16 // r
        htasks = -(-nch // (2 * pair)) * pair
        bands = -(-(ty + 2 * mn) // _BAND)
        cost += bands * (-(-vtasks // 4) + -(-htasks // 4)) * (
            2 * r * k + r + k)
        m = mn
    return cost


def kernel_tile(taps, n: int, h: int, w: int
                ) -> Optional[Tuple[int, int, int]]:
    """The CUDA kernel's (tile height, tile width, shared bytes) for a
    chain on an (n, h, w) base: of the tiles whose buffers fit a block
    (width a multiple of 32 up to 192, height a multiple of 8 up to 96),
    the one whose waves of blocks cost the least by the kernel's issue
    model; None if none fits."""
    return _kernel_tile(tuple(len(t) for t in taps), n, h, w)


@functools.lru_cache(maxsize=None)
def _kernel_tile(ksizes, n, h, w):
    m0 = sum(k // 2 for k in ksizes) + 1
    best = None
    for tx in range(_TILE_X_MAX, 31, -32):
        for ty in range(_TILE_Y_MAX, 7, -8):
            nbytes = _smem_bytes(ty, tx, m0)
            if nbytes > _SMEM_MAX:
                continue
            blocks = n * -(-h // ty) * -(-w // tx)
            cost = -(-blocks // _SMS) * _block_cost(ty, tx, ksizes)
            if best is None or cost < best[0]:
                best = (cost, ty, tx, nbytes)
    return None if best is None else best[1:]


def kernel_taps_per_px(n: int, h: int, w: int, taps) -> float:
    """Taps per output pixel the CUDA kernel computes on an (n, h, w)
    base, counted from its loop bounds: every block blurs its tile and
    the shrinking ring, the vertical pass over the wider columns."""
    ty, tx, _ = kernel_tile(taps, n, h, w)
    m = chain_halo(taps) + 1
    per_block = 0
    for t in taps:
        mn = m - len(t) // 2
        per_block += len(t) * (ty + 2 * mn) * ((tx + 2 * m) + (tx + 2 * mn))
        m = mn
    return per_block * -(-h // ty) * -(-w // tx) / (h * w)


def octave_stack_cost(n: int, h: int, w: int, taps, score: bool = True):
    """The least work of one ``octave_stack`` call on an (n, h, w) base:
    bytes (the base read once, every output plane written once), float
    operations (a multiply and an add per tap of both passes, the DoG
    subtraction, ``SCORE_OPS`` per score pixel) and the bound in ms, the
    larger of bytes over the H100's memory rate and operations over its
    f32 peak. -> dict(bytes, flops, bytes_ms, flops_ms, bound_ms,
    bound_by)."""
    nl = len(taps)
    px = n * h * w
    planes = 1 + (nl + 1) + nl + (nl - 2 if score else 0)
    ops = sum(4 * len(t) for t in taps) + nl
    if score:
        ops += SCORE_OPS * (nl - 2)
    return bound(4 * px * planes, px * ops)


def bound(nbytes: int, flops: int) -> dict:
    """The least time of work that moves ``nbytes`` and does ``flops``
    f32 operations on an H100: the larger of bytes over its memory rate
    and operations over its f32 peak. -> dict(bytes, flops, bytes_ms,
    flops_ms, bound_ms, bound_by)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / F32_FLOPS_PER_S * 1e3
    return dict(bytes=nbytes, flops=flops, bytes_ms=bytes_ms,
                flops_ms=flops_ms, bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations")


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
    thr = graphs.constant(thresh, dog.dtype, dog.device)
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
    r = graphs.constant(edge_r, dog.dtype, dog.device)
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
        k = graphs.constant(tuple(t), base.dtype, base.device)
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
def _c_taps(taps, n: int, h: int, w: int):
    """Checks a chain on an (n, h, w) base once -> the kernel's (taps,
    ksizes) host arrays: (n_lay, MAX_TAPS) f32 zero-padded, and the
    per-layer kernel sizes."""
    if not 3 <= len(taps) <= 8 or max(len(t) for t in taps) > MAX_TAPS:
        raise ValueError("octave_stack supports 3..8 layers of <= "
                         f"{MAX_TAPS} taps")
    if not reflect_legal(h, w, taps):
        raise ValueError("octave_stack needs halo < min(H, W)")
    if kernel_tile(taps, n, h, w) is None:
        raise ValueError(f"octave_stack: halo {chain_halo(taps)} leaves no "
                         "tile whose buffers fit a block's shared memory")
    return pack_taps(taps, MAX_TAPS)


def pack_taps(taps, width: int):
    """A chain's taps as a kernel takes them: -> ((n_lay, width) f32 host
    array, zero past each layer's taps; the per-layer kernel sizes)."""
    nl = len(taps)
    flat = (ctypes.c_float * (nl * width))()
    for i, t in enumerate(taps):
        flat[i * width:i * width + len(t)] = t
    return flat, (ctypes.c_int * nl)(*[len(t) for t in taps])


def _check_base(base: torch.Tensor, taps):
    """-> the kernel's host arrays for this chain and base shape."""
    if base.dtype != torch.float32 or base.ndim != 3:
        raise ValueError("octave_stack takes an (N, H, W) float32 base, got "
                         f"{tuple(base.shape)} {base.dtype}")
    if not base.is_contiguous():
        raise ValueError("octave_stack takes a contiguous base")
    return _c_taps(tuple(map(tuple, taps)), *base.shape)


def octave_stack(base: torch.Tensor, taps, score_cfg=None):
    """One octave: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor. ``score_cfg``: optional (thresh, edge_r, border)."""
    if base.device.type == "cpu":
        return octave_stack_ref(base, taps, score_cfg)
    if base.device.type != "cuda":
        raise ValueError(f"octave_stack: unsupported device {base.device}")
    c_taps, c_ksizes = _check_base(base, taps)
    n, h, w = base.shape
    nl = len(taps)
    gauss = torch.empty((n, nl + 1, h, w), dtype=base.dtype,
                        device=base.device)
    dog = torch.empty((n, nl, h, w), dtype=base.dtype, device=base.device)
    score: Optional[torch.Tensor] = None
    thresh, edge_r, border = 0.0, 0.0, 0
    if score_cfg is not None:
        thresh, edge_r, border = score_cfg
        score = torch.empty((n, nl - 2, h, w), dtype=base.dtype,
                            device=base.device)
    _kernels.launch(
        "p360_octave_stack", base.data_ptr(), gauss.data_ptr(),
        dog.data_ptr(), score.data_ptr() if score is not None else None, n,
        h, w, c_taps, c_ksizes, nl, float(thresh), float(edge_r),
        int(border), _kernels.stream_ptr(base.device))
    if score is None:
        return gauss, dog
    return gauss, dog, score


__all__ = ["chain_taps", "chain_halo", "reflect_legal", "octave_stack",
           "octave_stack_ref", "octave_stack_cost", "bound", "kernel_tile",
           "kernel_taps_per_px", "pack_taps"]
