"""Separable filters, corner response and pyramids (counterpart of
``pano360_tpu.ops.filters``).

The 1-D correlation is a sum of shifted slices accumulated in ascending
tap order, exactly as ``pano360_tpu.ops.filters._conv_axis`` does, so
the two packages round alike. The reflect101 border (cv2's default) is
built by index folding, which also covers pads wider than the image
(tiny SIFT octaves), as ``jnp.pad(mode="reflect")`` does.

Layouts: ``(H, W)``, ``(H, W, C)`` or ``(N, H, W, C)``; the two spatial
axes are filtered.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pano360_tpu_torch import graphs


def gaussian_kernel1d(sigma: float, ksize: int) -> np.ndarray:
    """cv2.getGaussianKernel taps: built in f64, normalized, cast f32."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / np.sum(k)).astype(np.float32)


def auto_ksize(sigma: float, depth8u: bool = False) -> int:
    """cv2.GaussianBlur's automatic kernel size for ``ksize=(0, 0)``."""
    return int(round(sigma * (3 if depth8u else 4) * 2 + 1)) | 1


def feature_ksize(sigma: float) -> int:
    """The feature path's kernel-size rule: odd, from sigma."""
    ksz = max(int((sigma - 0.35) / 0.15), 1)
    return ksz + (not ksz % 2)


def reflect101_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Fold integer indices into [0, n) with cv2.BORDER_REFLECT_101."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * n - 2
    m = torch.remainder(idx, period)
    return torch.where(m < n, m, period - m)


def pad_reflect101(x: torch.Tensor, dim: int, lo: int, hi: int):
    """Reflect101-pad ``x`` along ``dim`` by (lo, hi), any widths."""
    n = x.shape[dim]
    idx = torch.arange(-lo, n + hi, device=x.device)
    return torch.index_select(x, dim, reflect101_index(idx, n))


def conv_axis(img_bhw: torch.Tensor, kernel: torch.Tensor, axis: int,
              lo: Optional[int] = None):
    """Correlate (B, H, W) along ``axis`` (1 or 2) with a 1-D f32 kernel,
    reflect101 border, ascending-tap slice sums. ``lo``: the taps before
    the anchor (default: centred, ``(k - 1) // 2``)."""
    k = kernel.shape[0]
    if k == 1:
        return img_bhw * kernel[0]
    if lo is None:
        lo = (k - 1) // 2
    hi = k - 1 - lo
    padded = pad_reflect101(img_bhw, axis, lo, hi)
    n = img_bhw.shape[axis]
    out = None
    for i in range(k):
        term = padded.narrow(axis, i, n) * kernel[i]
        out = term if out is None else out + term
    return out


def _normalize(img: torch.Tensor):
    """Any supported layout -> (B, H, W) plus the inverse reshape."""
    if img.ndim == 2:
        return img[None], lambda y: y[0]
    if img.ndim == 3:                  # (H, W, C): channels as batch
        return img.movedim(-1, 0), lambda y: y.movedim(0, -1)
    if img.ndim == 4:                  # (N, H, W, C)
        n, h, w, c = img.shape
        flat = img.movedim(-1, 1).reshape(n * c, h, w)

        def restore(y):
            return y.reshape(n, c, y.shape[1], y.shape[2]).movedim(1, -1)
        return flat, restore
    raise ValueError(f"unsupported image rank {img.ndim}")


def sep_filter2d(img: torch.Tensor, kx, ky) -> torch.Tensor:
    """Separable 2-D correlation (``ky`` over rows, ``kx`` over cols),
    reflect101 border."""
    flat, restore = _normalize(img)
    kx = torch.as_tensor(kx, dtype=flat.dtype, device=flat.device)
    ky = torch.as_tensor(ky, dtype=flat.dtype, device=flat.device)
    return restore(conv_axis(conv_axis(flat, ky, 1), kx, 2))


def blur_bhw(img: torch.Tensor, sigma: float, ksize: int) -> torch.Tensor:
    """Gaussian blur of a (B, H, W) stack over its two trailing axes."""
    k = graphs.constant(tuple(gaussian_kernel1d(sigma, ksize).tolist()),
                        torch.float32, img.device)
    return conv_axis(conv_axis(img, k, 1), k, 2)


def gaussian_blur(img: torch.Tensor, sigma: float,
                  ksize: Optional[int] = None) -> torch.Tensor:
    """cv2.GaussianBlur-compatible separable smoothing, reflect101."""
    if ksize is None:
        ksize = auto_ksize(sigma)
    flat, restore = _normalize(img)
    return restore(blur_bhw(flat, sigma, ksize))


def cv2_sift_ksize(sigma: float) -> int:
    """cv2 SIFT's GaussianBlur kernel size on float images."""
    return int(round(sigma * 4 * 2 + 1)) | 1


def box_filter(img: torch.Tensor, size: int,
               normalize: bool = False) -> torch.Tensor:
    """Box sum over a ``size x size`` window (cv2.cornerHarris's). For an
    even size the anchor is cv2's: ``size // 2`` taps before the pixel, so
    size 2 sums the window that ends at the pixel."""
    flat, restore = _normalize(img)
    k = torch.ones(size, dtype=flat.dtype, device=flat.device)
    if normalize:
        k = k / size
    lo = size // 2
    return restore(conv_axis(conv_axis(flat, k, 1, lo), k, 2, lo))


_SOBEL_D = (-1.0, 0.0, 1.0)
_SOBEL_S = (1.0, 2.0, 1.0)


def sobel(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """3x3 Sobel first derivative (``cv2.Sobel(..., ksize=3)``)."""
    if (dx, dy) not in ((1, 0), (0, 1)):
        raise ValueError("only first derivatives are supported")
    kx, ky = (_SOBEL_D, _SOBEL_S) if dx else (_SOBEL_S, _SOBEL_D)
    return sep_filter2d(img, kx, ky)


def harris_response(gray: torch.Tensor, block_size: int = 2,
                    k: float = 0.04) -> torch.Tensor:
    """Harris corner response (``cv2.cornerHarris(block, 3, k)``): the
    structure tensor of Sobel gradients scaled by 1 / (4 block), summed
    over the block window, then det - k trace^2."""
    scale = 1.0 / ((1 << (3 - 1)) * block_size)
    gx = sobel(gray, 1, 0) * scale
    gy = sobel(gray, 0, 1) * scale
    gxx = box_filter(gx * gx, block_size)
    gyy = box_filter(gy * gy, block_size)
    gxy = box_filter(gx * gy, block_size)
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    return det - k * tr * tr


def max_pool3x3(img: torch.Tensor) -> torch.Tensor:
    """3x3 max filter, reflect101 border."""
    flat, restore = _normalize(img)
    pad = pad_reflect101(pad_reflect101(flat, 1, 1, 1), 2, 1, 1)
    return restore(torch.nn.functional.max_pool2d(pad[:, None], 3,
                                                  stride=1)[:, 0])


_PYR_K = (0.0625, 0.25, 0.375, 0.25, 0.0625)    # [1 4 6 4 1] / 16


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """5-tap Gaussian blur, then every second row and column
    (``cv2.pyrDown``; an odd size n gives (n + 1) // 2)."""
    flat, restore = _normalize(img)
    k = torch.tensor(_PYR_K, dtype=flat.dtype, device=flat.device)
    return restore(conv_axis(conv_axis(flat, k, 1), k, 2)[:, ::2, ::2])


def pyr_up(img: torch.Tensor,
           out_shape: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Zero-stuffed 5-tap upsample (``cv2.pyrUp``) to ``out_shape``
    (default: twice the input)."""
    flat, restore = _normalize(img)
    b, h, w = flat.shape
    oh, ow = out_shape if out_shape is not None else (2 * h, 2 * w)
    up = torch.zeros((b, oh, ow), dtype=flat.dtype, device=flat.device)
    up[:, ::2, ::2] = flat[:, :(oh + 1) // 2, :(ow + 1) // 2]
    k = torch.tensor(_PYR_K, dtype=flat.dtype, device=flat.device) * 2.0
    return restore(conv_axis(conv_axis(up, k, 1), k, 2))


__all__ = ["gaussian_kernel1d", "auto_ksize", "reflect101_index",
           "pad_reflect101", "conv_axis", "sep_filter2d", "blur_bhw",
           "gaussian_blur", "cv2_sift_ksize", "feature_ksize", "box_filter",
           "sobel", "harris_response", "max_pool3x3", "pyr_down", "pyr_up"]
