"""Color conversion (counterpart of ``pano360_tpu.ops.color``)."""
from __future__ import annotations

import torch

from pano360_tpu_torch import graphs

# cv2 BGR -> gray weights (Rec.601): Y = 0.299 R + 0.587 G + 0.114 B
_BGR2GRAY = (0.114, 0.587, 0.299)


def bgr2gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR -> (..., H, W) luma, matching cv2.COLOR_BGR2GRAY."""
    w = graphs.constant(_BGR2GRAY, img.dtype, img.device)
    return img[..., 0] * w[0] + img[..., 1] * w[1] + img[..., 2] * w[2]


def add_alpha(img: torch.Tensor, alpha=None) -> torch.Tensor:
    """Append an alpha channel ((..., H, W, 3) -> (..., H, W, 4)); ones
    when ``alpha`` (..., H, W) is not given."""
    if alpha is None:
        alpha = torch.ones(img.shape[:-1], dtype=img.dtype, device=img.device)
    return torch.cat([img, alpha[..., None]], dim=-1)


__all__ = ["bgr2gray", "add_alpha"]
