"""The benchmark's worlds: a rotating-camera sweep over a synthetic
equirectangular texture, made on the device from the seed.

A frozen copy of the port's ``synth`` model (``world_texture``,
``render_view``, ``make_views``): the random numbers come from numpy's
``default_rng`` exactly as there, in bulk, and the upsampling and the
views' rendering run in torch on the card. The same world seed gives the
views of ``synth.make_views`` within rounding (a CPU test holds them).
The ground truth (rotations, focal) stays with the world: the reference
judges the program by it.

Imports no module of the program: the harness hands the uint8 views to it.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

TEXTURE_HW = (1024, 2048)
TEXTURE_OCTAVES = 7


class World(NamedTuple):
    """One panorama's input and its ground truth."""

    views: List[np.ndarray]      # host uint8 BGR (H, W, 3), the input
    rots: np.ndarray             # (N, 3, 3) true rotations, world -> camera
    focal: float                 # true focal, pixels
    texture: torch.Tensor        # (th, tw, 3) float32 RGB in [0, 1]
    exposure: Optional[np.ndarray]   # (N,) per-view exposure factors


def world_texture(seed: int, device, height: int = TEXTURE_HW[0],
                  width: int = TEXTURE_HW[1],
                  octaves: int = TEXTURE_OCTAVES) -> torch.Tensor:
    """Multi-octave value noise, RGB in [0, 1], on ``device``."""
    rng = np.random.default_rng(seed)
    tex = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    for o in range(octaves):
        gh = max(2, height >> (octaves - 1 - o))
        gw = max(2, width >> (octaves - 1 - o))
        grid = torch.as_tensor(
            rng.standard_normal((gh, gw, 3)).astype(np.float32), device=device)
        ys = np.linspace(0, gh - 1, height, dtype=np.float32)
        xs = np.linspace(0, gw, width, endpoint=False, dtype=np.float32)
        y0 = np.floor(ys).astype(np.int64)
        x0 = np.floor(xs).astype(np.int64)
        fy = torch.as_tensor(ys - y0, device=device)[:, None, None]
        fx = torch.as_tensor(xs - x0, device=device)[None, :, None]
        y1 = torch.as_tensor(np.minimum(y0 + 1, gh - 1), device=device)
        x1 = torch.as_tensor((x0 + 1) % gw, device=device)
        y0 = torch.as_tensor(y0, device=device)
        x0 = torch.as_tensor(x0, device=device)
        up = ((grid[y0][:, x0] * (1 - fy) + grid[y1][:, x0] * fy) * (1 - fx)
              + (grid[y0][:, x1] * (1 - fy) + grid[y1][:, x1] * fy) * fx)
        tex += up * (0.8 ** o)
    lo, hi = torch.quantile(tex.reshape(-1).double(),
                            torch.tensor([0.01, 0.99], dtype=torch.float64,
                                         device=device))
    return torch.clamp((tex - lo.float()) / (hi - lo).float(), 0.0, 1.0)


def sample_texture(texture: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of the equirect ``texture`` along world ``rays``
    (..., 3), in the rays' dtype: -> (..., 3) RGB. Longitude wraps,
    latitude clamps (``synth.render_view``'s lookup)."""
    th, tw = texture.shape[:2]
    lon = torch.atan2(rays[..., 0], rays[..., 2])
    hyp = torch.hypot(rays[..., 0], rays[..., 2])
    lat = torch.atan2(rays[..., 1], hyp)
    u = (lon / (2 * math.pi) + 0.5) * tw
    v = (lat / math.pi + 0.5) * th
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0 = u0.to(torch.int64)
    v0 = v0.to(torch.int64)
    u0m, u1m = torch.remainder(u0, tw), torch.remainder(u0 + 1, tw)
    v0m = torch.clamp(v0, 0, th - 1)
    v1m = torch.clamp(v0 + 1, 0, th - 1)
    tex = texture.to(rays.dtype)
    return ((tex[v0m, u0m] * (1 - fu) + tex[v0m, u1m] * fu) * (1 - fv)
            + (tex[v1m, u0m] * (1 - fu) + tex[v1m, u1m] * fu) * fv)


def render_view(texture: torch.Tensor, rot: np.ndarray, focal: float,
                shape: Sequence[int]) -> torch.Tensor:
    """One pinhole view, float32 BGR in [0, 1] (H, W, 3) on the texture's
    device: pixel ``p`` (centred) looks along the world ray R^T K^-1 p.
    The rays are float64, as numpy computes them in ``synth``."""
    dev = texture.device
    h, w = shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    xs = xs - w / 2
    ys = ys - h / 2
    f32 = torch.tensor(focal, dtype=torch.float64).float().item()
    rays = torch.stack([xs / f32, ys / f32, torch.ones_like(xs)], dim=-1)
    rays = rays.double() @ torch.as_tensor(rot, dtype=torch.float64,
                                           device=dev)
    img = sample_texture(texture, rays)
    return img.flip(-1).float()


def exp_so3(rad: np.ndarray) -> np.ndarray:
    """Rodrigues' formula (``synth._exp_so3_np``)."""
    ang = np.linalg.norm(rad)
    if ang == 0:
        return np.eye(3)
    x, y, z = rad / ang
    cross = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return np.eye(3) + cross * np.sin(ang) + (1 - np.cos(ang)) * cross @ cross


def sweep(n_views: int, shape: Sequence[int], overlap: float, seed: int,
          fov_deg: float = 55.0, tilt_jitter: float = 0.02):
    """The sweep's rotations and focal (``synth.make_views``'s): -> (rots
    (N, 3, 3), focal)."""
    h, w = shape
    focal = w / (2 * np.tan(np.radians(fov_deg) / 2))
    fov = 2 * np.arctan(w / (2 * focal))
    step = fov * (1 - overlap)
    rng = np.random.default_rng(seed + 1)
    start = -step * (n_views - 1) / 2
    rots = []
    for i in range(n_views):
        jit = rng.normal(0, tilt_jitter, 2)
        rots.append(exp_so3(np.array([jit[0], start + i * step, jit[1]])))
    return np.stack(rots), float(focal)


def make_views(n_views: int, shape: Sequence[int], overlap: float,
               seed: int, device, fov_deg: float = 55.0,
               tilt_jitter: float = 0.02):
    """``synth.make_views`` on ``device``: -> (float32 BGR views on the
    device, rotations, focal, texture)."""
    texture = world_texture(seed, device)
    rots, focal = sweep(n_views, shape, overlap, seed, fov_deg, tilt_jitter)
    views = [render_view(texture, r, focal, shape) for r in rots]
    return views, rots, focal, texture


def world_seed(seed: int, k: int) -> int:
    """World ``k``'s seed of a run's ``--seed`` (any whole number >= 0)."""
    return int(np.random.SeedSequence([seed, k]).generate_state(1)[0])


def make_world(traffic: dict, seed: int, k: int, device) -> World:
    """World ``k`` of a run's ``--seed`` under a traffic mix's parameters:
    the views cast to uint8 by truncation (after the per-view exposure
    factors, when the mix has them) and copied to the host once."""
    ws = world_seed(seed, k)
    views, rots, focal, texture = make_views(
        traffic["views"], traffic["shape"], traffic["overlap"], ws, device,
        traffic.get("fov_deg", 55.0), traffic.get("tilt_jitter", 0.02))
    exposure = None
    if traffic.get("exposure"):
        lo, hi = traffic["exposure"]
        exposure = np.random.default_rng(
            np.random.SeedSequence([seed, k, 1])).uniform(lo, hi, len(views))
        views = [v.double() * float(a) for v, a in zip(views, exposure)]
    u8 = torch.stack([(v * 255).to(torch.uint8) for v in views])
    host = list(u8.cpu().numpy())
    return World(host, rots, focal, texture, exposure)


__all__ = ["World", "world_texture", "sample_texture", "render_view",
           "sweep", "make_views", "world_seed", "make_world"]
