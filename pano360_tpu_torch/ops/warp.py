"""Gather-based bilinear resampling and perspective warp (counterpart of
``pano360_tpu.ops.warp``).

Border handling is index arithmetic (reflection, clamping or a constant
fill), so any out-of-range coordinate costs nothing extra.
"""
from __future__ import annotations

from typing import Optional

import torch

from pano360_tpu_torch.geometry import inv3x3


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


def bilinear_taps(img: torch.Tensor, map_x: torch.Tensor,
                  map_y: torch.Tensor, border: str = "reflect",
                  cval: float = 0.0, index: Optional[torch.Tensor] = None):
    """Bilinear samples of a stack of images at float coordinates.

    ``img``: (B, H, W, C); ``map_x``/``map_y``: (Q, ...) source x/y, batch
    q sampling image ``index[q]`` (default: image q). Returns (Q, ...,
    C). ``border='constant'`` fills taps outside the image with ``cval``
    (cv2's convention: a partial footprint blends with the constant); the
    other modes fold indices (``reflect_index``).
    """
    _, h, w, c = img.shape
    q = map_x.shape[0]
    qshape = map_x.shape
    if index is None:
        index = torch.arange(q, device=img.device)
    base = (index.to(torch.int64) * (h * w))[:, None]
    x0, fx = safe_floor(map_x.reshape(q, -1).to(img.dtype), w)
    y0, fy = safe_floor(map_y.reshape(q, -1).to(img.dtype), h)
    fx, fy = fx[..., None], fy[..., None]
    if border == "constant":
        ix0, ix1 = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
        iy0, iy1 = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    else:
        ix0, ix1 = reflect_index(x0, w, border), reflect_index(x0 + 1, w,
                                                               border)
        iy0, iy1 = reflect_index(y0, h, border), reflect_index(y0 + 1, h,
                                                               border)
    flat = img.reshape(-1, c)

    def tap(iy, ix, yy, xx):
        g = flat[base + iy * w + ix]
        if border != "constant":
            return g
        ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        return torch.where(ok[..., None], g, torch.full_like(g, cval))

    g00 = tap(iy0, ix0, y0, x0)
    g01 = tap(iy0, ix1, y0, x0 + 1)
    g10 = tap(iy1, ix0, y0 + 1, x0)
    g11 = tap(iy1, ix1, y0 + 1, x0 + 1)
    top = g00 * (1 - fx) + g01 * fx
    bot = g10 * (1 - fx) + g11 * fx
    return (top * (1 - fy) + bot * fy).reshape(qshape + (c,))


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor, border: str = "reflect",
                   cval: float = 0.0):
    """Bilinear sampling of ``img`` (H, W[, C]) at float coordinates, like
    ``cv2.remap``; returns ``map_x.shape (+ (C,))``. ``border`` as in
    ``bilinear_taps``."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    out = bilinear_taps(img[None], map_x[None], map_y[None], border,
                        cval)[0]
    return out[..., 0] if squeeze else out


def perspective_maps(homs: torch.Tensor, out_shape):
    """Source coordinates of a perspective warp, like
    ``cv2.warpPerspective``: ``homs`` (B, 3, 3) map SOURCE pixels to
    destination pixels and are inverted (closed form, in float32) for
    the sampling. Returns (map_x, map_y), each (B, oh, ow)."""
    oh, ow = out_shape
    m = inv3x3(homs.to(torch.float32))
    ys, xs = torch.meshgrid(
        torch.arange(oh, dtype=torch.float32, device=homs.device),
        torch.arange(ow, dtype=torch.float32, device=homs.device),
        indexing="ij")
    m = m[:, :, :, None, None]
    sx = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]
    sy = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    sz = m[:, 2, 0] * xs + m[:, 2, 1] * ys + m[:, 2, 2]
    inv_z = torch.where(sz != 0, 1.0 / sz, 0.0)
    return sx * inv_z, sy * inv_z


def warp_perspective(img: torch.Tensor, hom: torch.Tensor, out_shape,
                     border: str = "constant", cval: float = 0.0):
    """``img`` (H, W[, C]) warped by ``hom`` (source -> destination, the
    cv2 convention) into ``out_shape`` (height, width)."""
    map_x, map_y = perspective_maps(hom[None], out_shape)
    return remap_bilinear(img, map_x[0], map_y[0], border, cval)


__all__ = ["reflect_index", "safe_floor", "bilinear_taps", "remap_bilinear",
           "perspective_maps", "warp_perspective"]
