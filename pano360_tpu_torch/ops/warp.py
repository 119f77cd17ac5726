"""Gather-based bilinear resampling (counterpart of ``pano360_tpu.ops.warp``).

Border handling is index arithmetic (reflection or clamping), so any
out-of-range coordinate costs nothing extra.
"""
from __future__ import annotations

import torch


def reflect_index(idx: torch.Tensor, n: int, mode: str = "reflect"):
    """Fold integer indices into ``[0, n)`` according to a border mode.

    ``reflect``    cv2.BORDER_REFLECT     (fedcba|abcdefgh|hgfedcb)
    ``reflect101`` cv2.BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba)
    ``replicate``  cv2.BORDER_REPLICATE   (clamp)
    """
    if n == 1:
        return torch.zeros_like(idx)
    if mode == "replicate":
        return torch.clamp(idx, 0, n - 1)
    if mode == "reflect":
        period = 2 * n
        m = torch.remainder(idx, period)
        return torch.where(m < n, m, period - 1 - m)
    if mode == "reflect101":
        period = 2 * n - 2
        m = torch.remainder(idx, period)
        return torch.where(m < n, m, period - m)
    raise ValueError(f"unknown border mode {mode!r}")


def safe_floor(x: torch.Tensor, n: int):
    """floor(x) as an integer index and the fraction x - floor(x).

    The float is clamped to a range a few image sizes wide before the
    cast, so a NaN or huge coordinate (a ray near z = 0) never reaches an
    undefined float-to-int conversion; such samples are masked invalid
    by every caller.
    """
    x = torch.nan_to_num(x, nan=0.0, posinf=4.0 * n, neginf=-4.0 * n)
    x = torch.clamp(x, -4.0 * n, 4.0 * n)
    x0f = torch.floor(x)
    return x0f.to(torch.int64), x - x0f


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor, border: str = "reflect"):
    """Bilinear sampling of ``img`` (H, W[, C]) at float coordinates, like
    ``cv2.remap``; returns ``map_x.shape (+ (C,))``."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    qshape = map_x.shape
    x0, fx = safe_floor(map_x.reshape(-1).to(img.dtype), w)
    y0, fy = safe_floor(map_y.reshape(-1).to(img.dtype), h)
    fx, fy = fx[:, None], fy[:, None]
    ix0, ix1 = reflect_index(x0, w, border), reflect_index(x0 + 1, w, border)
    iy0, iy1 = reflect_index(y0, h, border), reflect_index(y0 + 1, h, border)
    flat = img.reshape(h * w, c)
    g00 = flat[iy0 * w + ix0]
    g01 = flat[iy0 * w + ix1]
    g10 = flat[iy1 * w + ix0]
    g11 = flat[iy1 * w + ix1]
    top = g00 * (1 - fx) + g01 * fx
    bot = g10 * (1 - fx) + g11 * fx
    out = (top * (1 - fy) + bot * fy).reshape(qshape + (c,))
    return out[..., 0] if squeeze else out


__all__ = ["reflect_index", "safe_floor", "remap_bilinear"]
