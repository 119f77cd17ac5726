"""Synthetic panorama dataset generation with known ground truth.

The environment ships no reference datasets (CMU0/CMU2/UAV etc. from
Readme.md:87-100 are not present), so tests and benchmarks render their own:
a feature-rich equirectangular world texture is sampled by a rotating pinhole
camera with known focal and rotations — exactly the image-formation model the
stitcher assumes. Ground truth enables:

- registration accuracy checks (estimated vs true rotations/focal),
- end-to-end mosaic PSNR against the reference CPU implementation run on the
  same inputs,
- benchmark datasets shaped like the reference ones (CMU2-like: ~15 views,
  ~1-2 Mpix each).

The port's own copy of ``pano360_tpu.synth`` (numpy only): the same seed
gives the same views, byte for byte.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def world_texture(height: int = 1024, width: int = 2048, seed: int = 0,
                  octaves: int = 7) -> np.ndarray:
    """Multi-octave value-noise RGB texture, rich in corners and blobs."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((height, width, 3), np.float32)
    for o in range(octaves):
        gh = max(2, height >> (octaves - 1 - o))
        gw = max(2, width >> (octaves - 1 - o))
        grid = rng.standard_normal((gh, gw, 3)).astype(np.float32)
        # bilinear upsample grid to full size (wrap horizontally)
        ys = np.linspace(0, gh - 1, height, dtype=np.float32)
        xs = np.linspace(0, gw, width, endpoint=False, dtype=np.float32)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        fy = (ys - y0)[:, None, None]
        fx = (xs - x0)[None, :, None]
        y1 = np.minimum(y0 + 1, gh - 1)
        x1 = (x0 + 1) % gw
        up = ((grid[y0][:, x0] * (1 - fy) + grid[y1][:, x0] * fy) * (1 - fx)
              + (grid[y0][:, x1] * (1 - fy) + grid[y1][:, x1] * fy) * fx)
        tex += up * (0.8 ** o)    # persistence: coarse structure + fine detail
    # normalize to [0, 1] with healthy contrast (clip 1st/99th percentile)
    lo, hi = np.percentile(tex, [1, 99])
    tex = np.clip((tex - lo) / (hi - lo), 0.0, 1.0)
    return tex


def render_view(texture: np.ndarray, rot: np.ndarray, focal: float,
                shape: Tuple[int, int]) -> np.ndarray:
    """Render one pinhole view of the equirect texture.

    Camera model matches the stitcher: pixel (centered) ``p`` looks along the
    world ray ``R^T K^-1 p``; the ray's spherical coordinates index the
    equirect texture. Returns float32 BGR in [0, 1].
    """
    th, tw = texture.shape[:2]
    h, w = shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    xs -= w / 2
    ys -= h / 2
    rays = np.stack([xs / focal, ys / focal, np.ones_like(xs)], axis=-1)
    rays = rays @ rot  # (R^T ray^T)^T
    lon = np.arctan2(rays[..., 0], rays[..., 2])           # [-pi, pi]
    hyp = np.hypot(rays[..., 0], rays[..., 2])
    lat = np.arctan2(rays[..., 1], hyp)                    # [-pi/2, pi/2]
    u = (lon / (2 * np.pi) + 0.5) * tw
    v = (lat / np.pi + 0.5) * th
    u0 = np.floor(u).astype(int)
    v0 = np.floor(v).astype(int)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0m, u1m = u0 % tw, (u0 + 1) % tw
    v0m = np.clip(v0, 0, th - 1)
    v1m = np.clip(v0 + 1, 0, th - 1)
    img = ((texture[v0m, u0m] * (1 - fu) + texture[v0m, u1m] * fu) * (1 - fv)
           + (texture[v1m, u0m] * (1 - fu) + texture[v1m, u1m] * fu) * fv)
    return img[..., ::-1].astype(np.float32)  # RGB -> BGR


def make_views(n_views: int = 8, shape: Tuple[int, int] = (480, 640),
               focal: Optional[float] = None, fov_deg: float = 55.0,
               overlap: float = 0.45, seed: int = 0,
               tilt_jitter: float = 0.02,
               texture: Optional[np.ndarray] = None):
    """Render a rotating-camera sweep with the given inter-view overlap.

    Returns ``(images, rots, focal)`` where ``images`` are float32 BGR
    [0, 1], ``rots`` the ground-truth rotations, and focal in pixels.
    """
    h, w = shape
    if focal is None:
        focal = w / (2 * np.tan(np.radians(fov_deg) / 2))
    fov = 2 * np.arctan(w / (2 * focal))
    step = fov * (1 - overlap)

    if texture is None:
        texture = world_texture(seed=seed)
    rng = np.random.default_rng(seed + 1)

    imgs, rots = [], []
    start = -step * (n_views - 1) / 2
    for i in range(n_views):
        yaw = start + i * step
        jit = rng.normal(0, tilt_jitter, 2)
        rot = _exp_so3_np(np.array([jit[0], yaw, jit[1]]))
        imgs.append(render_view(texture, rot, focal, shape))
        rots.append(rot)
    return imgs, np.stack(rots), focal


def _exp_so3_np(rad: np.ndarray) -> np.ndarray:
    """Rodrigues in pure numpy (keeps data generation jax-free)."""
    ang = np.linalg.norm(rad)
    if ang == 0:
        return np.eye(3)
    x, y, z = rad / ang
    cross = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return np.eye(3) + cross * np.sin(ang) + (1 - np.cos(ang)) * cross @ cross


def write_dataset(path: str, imgs: List[np.ndarray]) -> List[str]:
    """Write rendered views as PNGs (uint8 BGR) for the CLI."""
    from pano360_tpu_torch.imageio import imwrite
    os.makedirs(path, exist_ok=True)
    files = []
    for i, img in enumerate(imgs):
        fn = os.path.join(path, f"view{i:02d}.png")
        imwrite(fn, (img * 255).round())
        files.append(fn)
    return files


__all__ = ["world_texture", "render_view", "make_views", "write_dataset"]
