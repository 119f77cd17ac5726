"""The least work of kernels, from shapes alone, and the card's peaks.

Frozen copies of the port's ``ops.gauss_octave.octave_stack_cost`` and
``chain_taps`` (a CPU test holds them equal at the cells' shapes), so
that a change to the program cannot move the yardstick. The peaks are
NVIDIA's published figures for the H100 SXM at 700 W; a run prints the
card's power limit beside every share of them.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# operations of one extrema-score pixel: 27-value max and min (54), the
# extremum test (4), dxx/dyy (3 each), dxy (4), trace (1), determinant
# (3), edge test (5), |DoG| (1)
SCORE_OPS = 78
# SIFT's defaults (the port's SiftConfig: sigma 1.6, 3 layers an octave,
# the 2x upscaled base)
SIFT_SIGMA, SIFT_LAYERS, SIFT_UPSCALE = 1.6, 3, True


def chain_taps(sigma: float, n_layers: int) -> Tuple[Tuple[float, ...], ...]:
    """The incremental Gaussian chain's per-layer 1-D taps."""
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


def bound(nbytes: int, flops: int) -> dict:
    """The least time of work moving ``nbytes`` and doing ``flops`` f32
    operations: the larger of bytes over the memory rate and operations
    over the f32 peak."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / F32_FLOPS_PER_S * 1e3
    return dict(bytes=nbytes, flops=flops, bytes_ms=bytes_ms,
                flops_ms=flops_ms, bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations")


def octave_stack_cost(n: int, h: int, w: int, taps, score: bool = True):
    """The least work of one octave's scale space on an (n, h, w) base:
    the base read once, every Gaussian, DoG and score plane written once,
    a multiply and an add per tap of both passes, the DoG subtraction and
    ``SCORE_OPS`` per score pixel."""
    nl = len(taps)
    px = n * h * w
    planes = 1 + (nl + 1) + nl + (nl - 2 if score else 0)
    ops = sum(4 * len(t) for t in taps) + nl
    if score:
        ops += SCORE_OPS * (nl - 2)
    return bound(4 * px * planes, px * ops)


def n_octaves(shape: Sequence[int], upscale: bool = SIFT_UPSCALE) -> int:
    """SIFT's octave count: round(log2(min side of the base)) - 2."""
    side = min(shape) * (2 if upscale else 1)
    return max(int(round(math.log2(side))) - 2, 1)


def octave_shapes(shape: Sequence[int], upscale: bool = SIFT_UPSCALE):
    """Each octave's base (h, w): the 2x upscaled image, then every
    second pixel of the octave before."""
    h, w = (2 * shape[0], 2 * shape[1]) if upscale else tuple(shape)
    out = []
    for _ in range(n_octaves(shape, upscale)):
        out.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


def scale_space_bound_ms(n_views: int, shape: Sequence[int]) -> float:
    """The least time of one panorama's scale space: every octave of
    every view, each octave's bound taken apart (a launch each)."""
    taps = chain_taps(SIFT_SIGMA, SIFT_LAYERS)
    return sum(octave_stack_cost(n_views, h, w, taps)["bound_ms"]
               for h, w in octave_shapes(shape))


__all__ = ["HBM_BYTES_PER_S", "F32_FLOPS_PER_S", "chain_taps", "bound",
           "octave_stack_cost", "n_octaves", "octave_shapes",
           "scale_space_bound_ms"]
