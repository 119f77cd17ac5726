"""Image resizing with cv2 semantics (counterpart of ``pano360_tpu.ops.resize``)."""
from __future__ import annotations

import torch

from pano360_tpu_torch.ops.warp import remap_bilinear


def resize_bilinear(img: torch.Tensor, out_shape) -> torch.Tensor:
    """Bilinear resize of (H, W[, C]) to ``(height, width)``,
    cv2.INTER_LINEAR convention (``src = (dst + 0.5) * scale - 0.5``,
    replicate border)."""
    oh, ow = out_shape
    h, w = img.shape[:2]
    ys = ((torch.arange(oh, dtype=torch.float32, device=img.device) + 0.5)
          * (h / oh) - 0.5)
    xs = ((torch.arange(ow, dtype=torch.float32, device=img.device) + 0.5)
          * (w / ow) - 0.5)
    my, mx = torch.meshgrid(ys, xs, indexing="ij")
    return remap_bilinear(img, mx, my, border="replicate")


def upsample2x_bilinear(img: torch.Tensor) -> torch.Tensor:
    """Exact 2x bilinear upsample of (..., H, W): even outputs
    0.75 x[i] + 0.25 x[i-1], odd 0.75 x[i] + 0.25 x[i+1], edges clamped."""
    def up_axis(x, axis):
        n = x.shape[axis]
        lo = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)],
                       dim=axis)
        hi = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)],
                       dim=axis)
        even = 0.75 * x + 0.25 * lo
        odd = 0.75 * x + 0.25 * hi
        ax = axis % x.ndim
        stacked = torch.stack([even, odd], dim=ax + 1)
        shape = list(x.shape)
        shape[ax] *= 2
        return stacked.reshape(shape)

    return up_axis(up_axis(img, -2), -1)


def shrink_area(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor area downsample of (H, W[, C]) (mean pool over
    factor x factor blocks, the rest cropped): cv2.INTER_AREA for
    integer factors. Integer images come back as float32."""
    h, w = img.shape[:2]
    nh, nw = h // factor, w // factor
    crop = img[:nh * factor, :nw * factor]
    if not crop.is_floating_point():
        crop = crop.float()
    return crop.reshape((nh, factor, nw, factor) + img.shape[2:]).mean(
        dim=(1, 3))


__all__ = ["resize_bilinear", "upsample2x_bilinear", "shrink_area"]
