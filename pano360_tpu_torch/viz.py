"""Visualization helpers: keypoints, descriptor tiles, match overlays
(the port's own copy of ``pano360_tpu.viz``; numpy only).

Plain numpy rasterization (lines and boxes), suitable for saving with
``imageio.imwrite``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from pano360_tpu_torch.features.msop import DSIZE


def _draw_line(img: np.ndarray, p0, p1, color):
    """Integer line via dense sampling (host drawing only)."""
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) * 2
    xs = np.linspace(p0[0], p1[0], n).round().astype(int)
    ys = np.linspace(p0[1], p1[1], n).round().astype(int)
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def plot_points(img: np.ndarray, points: Sequence) -> np.ndarray:
    """Draw oriented descriptor boxes (MSOP's patch footprint).

    ``points``: iterable of (x, y, theta, scale).
    """
    img = np.array(img, copy=True)
    rad = DSIZE / 2
    box = np.array([[0, 0], [rad, 0], [rad, -rad], [-rad, -rad],
                    [-rad, rad], [rad, rad], [rad, 0]], np.float32)
    for x, y, theta, scale in points:
        cos, sin = np.cos(theta), np.sin(theta)
        rot = np.array([[cos, sin], [-sin, cos]])
        pts = (box * scale) @ rot.T + np.array([x, y])
        for a, b in zip(pts[:-1], pts[1:]):
            _draw_line(img, a, b, (0, 0, 255))
    return img


def plot_descs(descs: np.ndarray, side: int = 25) -> np.ndarray:
    """Tile the first ``side**2`` descriptors."""
    n_tiles = side * side
    d = int(np.sqrt(descs.shape[1]))
    descs = descs[:, : d * d]
    if len(descs) < n_tiles:
        pad = np.zeros((n_tiles - len(descs), d * d), descs.dtype)
        descs = np.concatenate([descs, pad])
    else:
        descs = descs[:n_tiles]
    tiles = descs.reshape(side, side, d, d).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(side * d, side * d)
    rng = tiles.max() - tiles.min()
    tiles = 255 * (tiles - tiles.min()) / (rng if rng else 1)
    out = np.repeat(np.repeat(tiles, 4, axis=0), 4, axis=1)
    return out.astype(np.uint8)


def match_images(img1: np.ndarray, img2: np.ndarray, pts1: np.ndarray,
                 pts2: np.ndarray,
                 inliers: Optional[np.ndarray] = None) -> np.ndarray:
    """Side-by-side match overlay.

    ``pts1``/``pts2``: (M, 2) matched keypoint coords (image pixels).
    """
    h = max(img1.shape[0], img2.shape[0])
    w1 = img1.shape[1]
    canvas = np.zeros((h, w1 + img2.shape[1], 3), np.uint8)
    canvas[: img1.shape[0], : w1] = img1[..., :3]
    canvas[: img2.shape[0], w1:] = img2[..., :3]
    if inliers is None:
        inliers = np.ones(len(pts1), bool)
    for (x1, y1), (x2, y2), ok in zip(pts1, pts2, inliers):
        if not ok:
            continue
        _draw_line(canvas, (x1, y1), (x2 + w1, y2), (0, 255, 0))
    return canvas


__all__ = ["plot_points", "plot_descs", "match_images"]
