"""SIFT's front end: the base image and the small octaves' scale space.

The JAX package runs ``sift_extract`` as one jitted program, and XLA
fuses its front end into a few loops (no Pallas kernel lies behind
them): the 2x upsample and the base blur (``_base_image``), and, on the
octaves too small for the octave kernel's single reflect101 extension,
the per-layer Gaussian chain, its DoG and the dense extrema score. Here
each is a kernel written for the card, beside its plain PyTorch
version:

- ``base_image`` (``csrc/sift_base.cu``): the exact 2x bilinear upsample
  (with ``upscale``) and the Gaussian blur of the base, each pass folding
  reflect101 on its own grid (plain: ``base_image_ref``, i.e.
  ``upsample2x_bilinear`` then ``blur_bhw``);
- ``small_octave`` (``csrc/sift_small_octave.cu``): one octave's Gaussian
  stack, DoG stack and extrema score where ``gauss_octave.reflect_legal``
  rejects the base, a block per image, each layer blurred with
  reflect101 folded on that layer (pads wider than the image included;
  plain: ``features.sift._gaussian_stack``, the DoG subtraction and
  ``gauss_octave._extrema_score``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(on the current stream, writing only into tensors allocated here, with
no host sync, so that a CUDA graph captures it); another device raises.
On the card each kernel equals its plain version bit for bit: built with
``-fmad=false``, each sum begun with its first term and added in
ascending tap order, as ``ops.filters.conv_axis`` does. Each launch
counts in ``_kernels.LAUNCHES``; ``base_cost`` and ``small_octave_cost``
give a call's least bytes and operations and its bound on an H100.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from pano360_tpu_torch import _kernels
from pano360_tpu_torch.ops import gauss_octave
from pano360_tpu_torch.ops.filters import (blur_bhw, cv2_sift_ksize,
                                           gaussian_kernel1d)
from pano360_tpu_torch.ops.gauss_octave import bound, chain_taps
from pano360_tpu_torch.ops.resize import upsample2x_bilinear

BASE_MAX_TAPS = 31      # the base kernel's tap capacity (csrc/sift_base.cu)
SMALL_MAX_TAPS = 63     # the small-octave kernel's, per layer
SMALL_MAX_LAYERS = 8
# the small-octave kernel keeps 6 planes of an image in shared memory
# (the current and next layer, the vertical pass, 3 DoG slots) when they
# fit a block's opt-in 227 KB beside its copy of the taps; else its
# passes go through device memory
SMALL_SMEM_PLANES = 6
SMEM_MAX = 232448 - 4 * SMALL_MAX_LAYERS * SMALL_MAX_TAPS


def _on_card(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _check_stack(name: str, x: torch.Tensor):
    """An (N, H, W) contiguous float32 stack, or raise."""
    if x.dtype != torch.float32 or x.ndim != 3 or min(x.shape) < 1:
        raise ValueError(f"{name} takes an (N, H, W) float32 stack, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous stack")


def base_delta(cfg) -> float:
    """The base blur's sigma: from the camera's blur (doubled by the 2x
    upsample) to ``cfg.sigma``."""
    cur = cfg.init_sigma * (2.0 if cfg.upscale else 1.0)
    return math.sqrt(max(cfg.sigma ** 2 - cur ** 2, 0.01))


@functools.lru_cache(maxsize=None)
def _c_base_taps(delta: float):
    k = gaussian_kernel1d(delta, cv2_sift_ksize(delta))
    if len(k) > BASE_MAX_TAPS:
        raise ValueError(f"base_image: the kernel takes <= {BASE_MAX_TAPS} "
                         f"taps, sigma {delta} needs {len(k)}")
    return (ctypes.c_float * len(k))(*k.tolist()), len(k)


def base_image_ref(gray: torch.Tensor, cfg) -> torch.Tensor:
    """Plain version: the 2x upsample (with ``cfg.upscale``), then the
    blur of ``base_delta(cfg)``."""
    img = upsample2x_bilinear(gray) if cfg.upscale else gray
    delta = base_delta(cfg)
    return blur_bhw(img, delta, cv2_sift_ksize(delta))


def base_image(gray: torch.Tensor, cfg) -> torch.Tensor:
    """SIFT's base of an (N, H, W) float32 gray stack: -> (N, 2H, 2W)
    with ``cfg.upscale``, else (N, H, W)."""
    _check_stack("base_image", gray)
    if not _on_card(gray, "base_image"):
        return base_image_ref(gray, cfg)
    taps, k = _c_base_taps(base_delta(cfg))
    n, h, w = gray.shape
    up = 2 if cfg.upscale else 1
    out = torch.empty((n, up * h, up * w), dtype=torch.float32,
                      device=gray.device)
    _kernels.launch(
        "p360_sift_base", gray.data_ptr(), out.data_ptr(), n, h, w,
        int(cfg.upscale), taps, k, _kernels.stream_ptr(gray.device))
    return out


def score_cfg(cfg):
    """The extrema score's (threshold, edge ratio, border) for ``cfg``:
    half the contrast threshold over the layers, as cv2 prefilters."""
    return (0.5 * cfg.contrast_thresh / cfg.n_layers, cfg.edge_thresh,
            cfg.img_border)


def small_octave_ref(base: torch.Tensor, cfg):
    """Plain version: ``_gaussian_stack``, its DoG and the dense extrema
    score (imported at the call: the SIFT module imports this one)."""
    from pano360_tpu_torch.features import sift
    gauss = sift._gaussian_stack(base, cfg)
    dog = gauss[:, 1:] - gauss[:, :-1]
    return gauss, dog, gauss_octave._extrema_score(dog, *score_cfg(cfg))


def small_octave_in_shared(h: int, w: int) -> bool:
    """The kernel keeps the octave's planes in shared memory."""
    return SMALL_SMEM_PLANES * 4 * h * w <= SMEM_MAX


@functools.lru_cache(maxsize=None)
def _c_chain(sigma: float, n_layers: int):
    taps = chain_taps(sigma, n_layers)
    if (not 3 <= len(taps) <= SMALL_MAX_LAYERS
            or max(len(t) for t in taps) > SMALL_MAX_TAPS):
        raise ValueError(f"small_octave: the kernel takes 3.."
                         f"{SMALL_MAX_LAYERS} layers of <= {SMALL_MAX_TAPS}"
                         " taps")
    return gauss_octave.pack_taps(taps, SMALL_MAX_TAPS)


def small_octave(base: torch.Tensor, cfg):
    """One octave of an (N, h, w) float32 base: -> (gauss (N, S+3, h, w),
    dog (N, S+2, h, w), score (N, S, h, w)), as ``_gaussian_stack``, the
    DoG and ``_extrema_score`` give them."""
    _check_stack("small_octave", base)
    if not _on_card(base, "small_octave"):
        return small_octave_ref(base, cfg)
    taps, ksizes = _c_chain(cfg.sigma, cfg.n_layers)
    n, h, w = base.shape
    nl = cfg.n_layers + 2
    dev = base.device
    gauss = torch.empty((n, nl + 1, h, w), dtype=torch.float32, device=dev)
    dog = torch.empty((n, nl, h, w), dtype=torch.float32, device=dev)
    score = torch.empty((n, nl - 2, h, w), dtype=torch.float32, device=dev)
    scratch = None if small_octave_in_shared(h, w) else torch.empty(
        (n, h, w), dtype=torch.float32, device=dev)
    thresh, edge_r, border = score_cfg(cfg)
    _kernels.launch(
        "p360_sift_small_octave", base.data_ptr(), gauss.data_ptr(),
        dog.data_ptr(), score.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n, h, w, taps,
        ksizes, nl, thresh, edge_r, border, _kernels.stream_ptr(dev))
    return gauss, dog, score


# ---------------------------------------------------------------------------
# Least work of each call (each input read once, each output written
# once; a multiply and an add per tap and output), and its bound on an H100
# ---------------------------------------------------------------------------

def base_cost(n: int, h: int, w: int, cfg) -> dict:
    """An (n, h, w) gray stack read once, the base written once; the
    upsample's two products and one add per output of each axis pass,
    the blur's multiply and add per tap of both passes."""
    k = cv2_sift_ksize(base_delta(cfg))
    if cfg.upscale:
        oh, ow = 2 * h, 2 * w
        ops = 3 * n * oh * w + 3 * n * oh * ow
    else:
        oh, ow, ops = h, w, 0
    ops += n * oh * ow * 2 * (2 * k - 1)
    return bound(4 * n * (h * w + oh * ow), ops)


def small_octave_cost(n: int, h: int, w: int, cfg) -> dict:
    """The same work as the octave kernel's on this base
    (``gauss_octave.octave_stack_cost``: the base read once, every
    Gaussian, DoG and score plane written once)."""
    return gauss_octave.octave_stack_cost(
        n, h, w, chain_taps(cfg.sigma, cfg.n_layers))


__all__ = ["base_image", "base_image_ref", "small_octave", "small_octave_ref",
           "small_octave_in_shared", "base_delta", "score_cfg", "base_cost",
           "small_octave_cost"]
