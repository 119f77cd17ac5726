"""The multiband blend's Gaussian blur: one CUDA kernel beside its plain
version.

``render.blend_multiband`` blurs its (N, ph, pw, 4) patch stack once a
level (sigma 4, 6.93, 8.94, 10.58: 33, 57, 73, 87 taps). The plain
version, ``ops.filters.gaussian_blur``, sums shifted slices of a
reflect101-padded copy, a multiply and an add a tap and axis, each
writing a tensor of the stack's size. Here it is ``csrc/band_blur.cu``,
two launches a call (the rows, then the columns, through one float32
intermediate of the stack's size), reading and writing the stack as it
lies, the four channels of a pixel in one 16-byte load.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(on the current stream, writing only into tensors allocated here, with
no host sync); another device raises. On the card the kernel equals the
plain version bit for bit: built with ``-fmad=false``, each sum begun
with its first term and added in ascending tap order, the rows first,
reflect101 folded as ``reflect101_index`` folds, pads wider than the
axis included. ``_kernels.LAUNCHES["band_blur"]`` counts the calls (one
a level); ``band_blur_cost`` gives a call's least bytes and operations
and its bound on an H100. The blend is its only caller: MSOP's and
SIFT's blurs keep ``ops.filters``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from pano360_tpu_torch import _kernels
from pano360_tpu_torch.ops.filters import (auto_ksize, gaussian_blur,
                                           gaussian_kernel1d)
from pano360_tpu_torch.ops.gauss_octave import bound
from pano360_tpu_torch.ops.sift_tail import _check, _on_card

MAX_TAPS = 127          # the kernel's tap capacity (csrc/band_blur.cu)
CHANNELS = 4            # a pixel's values, one 16-byte load


@functools.lru_cache(maxsize=None)
def _c_taps(sigma: float):
    k = gaussian_kernel1d(sigma, auto_ksize(sigma))
    return (ctypes.c_float * len(k))(*k.tolist())


def band_blur(patches: torch.Tensor, sigma: float) -> torch.Tensor:
    """``gaussian_blur(patches, sigma)`` of a contiguous (N, H, W, 4)
    float32 stack: -> a new (N, H, W, 4) tensor."""
    name = "band_blur"
    ksize = auto_ksize(sigma)
    card = _on_card(patches, name)
    _check(name, patches.device,
           patches=(patches, torch.float32, (None, None, None, CHANNELS)))
    n, h, w, _ = patches.shape
    if not 1 <= ksize <= MAX_TAPS:
        raise ValueError(f"{name}: takes 1..{MAX_TAPS} taps, got {ksize} "
                         f"(sigma {sigma})")
    if min(n, h, w) < 1 or n > 65535 or h > 8 * 65535:
        raise ValueError(f"{name}: takes 1..65535 patches of 1..{8 * 65535}"
                         f" rows and at least one column, got N={n}, H={h},"
                         f" W={w}")
    if not card:
        return gaussian_blur(patches, sigma)
    if patches.data_ptr() % 16:
        raise ValueError(f"{name}: takes a 16-byte aligned stack, got "
                         f"address {patches.data_ptr():#x}")
    mid = torch.empty_like(patches)
    out = torch.empty_like(patches)
    _kernels.launch("p360_band_blur", patches.data_ptr(), mid.data_ptr(),
                    out.data_ptr(), n, h, w, _c_taps(float(sigma)),
                    ksize, _kernels.stream_ptr(patches.device))
    return out


def band_blur_cost(n: int, h: int, w: int, ksize: int) -> dict:
    """A call's least work on an (n, h, w, 4) stack: every pixel read once
    and written once (2 x 16 bytes), a multiply and an add a tap but the
    first of each axis (2 (2 ksize - 1) operations a value); its bound on
    an H100 (``gauss_octave.bound``)."""
    px = n * h * w
    return bound(2 * 4 * CHANNELS * px, 2 * (2 * ksize - 1) * CHANNELS * px)


__all__ = ["band_blur", "band_blur_cost", "MAX_TAPS"]
