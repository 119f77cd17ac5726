"""The benchmark's worlds, made on the device from the seed: a
rotating-camera sweep over a synthetic equirectangular texture, or a
panoramic head's rig of several rings over value noise that is regular
on the whole sphere (``rig``, ``sphere_texture``).

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
    texture: torch.Tensor        # (th, tw, 3) float32 RGB in [0, 1]; a
    #                              rig's is a ``SphereTexture``
    exposure: Optional[np.ndarray]   # (N,) per-view exposure factors
    rig: bool = False            # shot by a rig of rings, not a sweep


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


def look(az: float, el: float) -> np.ndarray:
    """World -> camera rotation of a camera with no roll that looks along
    azimuth ``az`` (``atan2(x, z)``) at elevation ``el``, in radians; up
    is the world's -y, as in the images."""
    axis = np.array([np.cos(el) * np.sin(az), -np.sin(el),
                     np.cos(el) * np.cos(az)])
    right = np.array([np.cos(az), 0.0, -np.sin(az)])
    return np.stack([right, np.cross(axis, right), axis])


def rig(rings: Sequence[dict], shape: Sequence[int], seed: int,
        fov_deg: float = 55.0, tilt_jitter: float = 0.02):
    """A panoramic head's rotations and focal, ring by ring and in yaw
    order within a ring: view k of a ring ``{"pitch_deg", "views",
    "yaw0_deg"}`` looks along azimuth ``yaw0_deg + 360 k / views`` at
    elevation ``pitch_deg`` (a ring of one view at +-90 is a pole), then
    turns by the sweep's jitter about its own x and z axes: -> (rots
    (N, 3, 3), focal)."""
    h, w = shape
    focal = w / (2 * np.tan(np.radians(fov_deg) / 2))
    rng = np.random.default_rng(seed + 1)
    rots = []
    for ring in rings:
        el = np.radians(ring["pitch_deg"])
        for k in range(ring["views"]):
            az = np.radians(ring["yaw0_deg"] + 360.0 * k / ring["views"])
            jit = rng.normal(0, tilt_jitter, 2)
            rots.append(exp_so3(np.array([jit[0], 0.0, jit[1]]))
                        @ look(az, el))
    return np.stack(rots), float(focal)


# ---------------------------------------------------------------------------
# A rig's texture: value noise on the sphere
# ---------------------------------------------------------------------------

SPHERE_SAMPLES = 1 << 20    # directions the 1 % and 99 % levels are read at
NOISE_BLOCK = 1 << 17       # directions a block: its tensors stay in the
#                             host's caches, and take tens of MB on a card
_M32 = 0xFFFFFFFF
_PRIMES = (73856093, 19349663, 83492791)    # a spatial hash's, each < 2**27
_OFFSET = 1 << 16           # makes the lattice's indices positive


def _mix32(x):
    """A 32-bit integer hash of ``x`` in [0, 2**32), a Python int or an
    int64 tensor (its products stay under 2**59, so nothing overflows)."""
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def _lerp(a, b, t):
    return a * (1 - t) + b * t


class SphereTexture(NamedTuple):
    """A rig world's texture: ``sphere_noise`` of ``seed``, mapped to
    [0, 1] by its 1 % and 99 % levels ``lo``, ``hi`` (0-d float64
    tensors on the world's device, as ``world_texture`` takes them)."""

    seed: int
    lo: torch.Tensor
    hi: torch.Tensor

    @property
    def device(self):
        return self.lo.device


def sphere_noise(dirs: torch.Tensor, seed: int) -> torch.Tensor:
    """``world_texture``'s noise made regular on the whole sphere: at the
    unit directions ``dirs`` (..., 3) float64, the sum over octaves o of
    value noise on a 3-D lattice with ``world_texture``'s rows per radian,
    interpolated trilinearly and weighted 0.8 ** o. A lattice point's
    value, uniform in (-1, 1) in each channel, is a hash of its indices,
    the octave and ``seed``. Computed on ``dirs``' device in blocks of
    ``NOISE_BLOCK`` directions, the lattice cells in float64 and the
    values in float32: -> (..., 3) float32 RGB, not normalised."""
    dev = dirs.device
    primes = torch.tensor(_PRIMES, dtype=torch.int64, device=dev)
    shifts = torch.tensor([0, 10, 20], dtype=torch.int64, device=dev)
    keys = [_mix32((seed + o * 0x9E3779B9) & _M32)
            for o in range(TEXTURE_OCTAVES)]
    flat = dirs.reshape(-1, 3)
    out = torch.zeros(flat.shape, dtype=torch.float32, device=dev)
    for d, acc in zip(flat.split(NOISE_BLOCK), out.split(NOISE_BLOCK)):
        for o, key in enumerate(keys):
            p = d * ((TEXTURE_HW[0] >> (TEXTURE_OCTAVES - 1 - o)) / math.pi)
            p0 = torch.floor(p)
            t = (p - p0).float()
            a = (p0.to(torch.int64) + _OFFSET) * primes
            a = torch.stack([a, a + primes], -1)        # (n, axis, corner)
            h = (a[:, 0, :, None, None] ^ a[:, 1, None, :, None]
                 ^ a[:, 2, None, None, :])              # (n, 2, 2, 2)
            h = _mix32((h & _M32) ^ key)
            v = ((h[..., None] >> shifts) & 1023).float()   # (n, 2, 2, 2, 3)
            v = _lerp(v[:, 0], v[:, 1], t[:, 0, None, None, None])
            v = _lerp(v[:, 0], v[:, 1], t[:, 1, None, None])
            v = _lerp(v[:, 0], v[:, 1], t[:, 2, None])
            acc += (v / 512 - 1023 / 1024) * (0.8 ** o)
    return out.reshape(dirs.shape)


def sphere_texture(seed: int, device) -> SphereTexture:
    """``sphere_noise`` of ``seed`` with its 1 % and 99 % levels over all
    channels, read at ``SPHERE_SAMPLES`` directions of a Fibonacci
    lattice (all but equal areas of the sphere), as ``world_texture``
    reads them over its texels."""
    i = torch.arange(SPHERE_SAMPLES, dtype=torch.float64, device=device)
    z = 1 - (2 * i + 1) / SPHERE_SAMPLES
    r = torch.sqrt(1 - z * z)
    phi = i * (math.pi * (3 - math.sqrt(5)))
    dirs = torch.stack([r * torch.cos(phi), z, r * torch.sin(phi)], -1)
    lo, hi = torch.quantile(sphere_noise(dirs, seed).reshape(-1).double(),
                            torch.tensor([0.01, 0.99], dtype=torch.float64,
                                         device=device))
    return SphereTexture(seed, lo, hi)


def render_rig_view(texture: SphereTexture, rot: np.ndarray, focal: float,
                    shape: Sequence[int]) -> torch.Tensor:
    """``render_view`` over the sphere's noise: the same float64 rays,
    each normalised and looked up in ``texture`` -> float32 BGR in
    [0, 1] (H, W, 3) on the texture's device."""
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
    rays = rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)
    lo, hi = texture.lo.float(), texture.hi.float()
    img = (sphere_noise(rays, texture.seed) - lo) / (hi - lo)
    return torch.clamp(img, 0.0, 1.0).flip(-1)


def make_rig_views(traffic: dict, seed: int, device):
    """``make_views`` for a traffic mix with a ``rig``, whose ``views``
    must be the rig's total: -> (float32 BGR views on the device,
    rotations, focal, texture)."""
    total = sum(ring["views"] for ring in traffic["rig"])
    if traffic["views"] != total:
        raise ValueError(f"the traffic's views ({traffic['views']}) are "
                         f"not its rig's total ({total})")
    texture = sphere_texture(seed, device)
    rots, focal = rig(traffic["rig"], traffic["shape"], seed,
                      traffic.get("fov_deg", 55.0),
                      traffic.get("tilt_jitter", 0.02))
    views = [render_rig_view(texture, r, focal, traffic["shape"])
             for r in rots]
    return views, rots, focal, texture


def world_seed(seed: int, k: int) -> int:
    """World ``k``'s seed of a run's ``--seed`` (any whole number >= 0)."""
    return int(np.random.SeedSequence([seed, k]).generate_state(1)[0])


def make_world(traffic: dict, seed: int, k: int, device) -> World:
    """World ``k`` of a run's ``--seed`` under a traffic mix's parameters
    (a sweep, or under ``rig`` a rig of rings, whose ``overlap`` is not
    read): the views cast to uint8 by truncation (after the per-view
    exposure factors, when the mix has them) and copied to the host
    once."""
    ws = world_seed(seed, k)
    is_rig = "rig" in traffic
    if is_rig:
        views, rots, focal, texture = make_rig_views(traffic, ws, device)
    else:
        views, rots, focal, texture = make_views(
            traffic["views"], traffic["shape"], traffic["overlap"], ws,
            device, traffic.get("fov_deg", 55.0),
            traffic.get("tilt_jitter", 0.02))
    exposure = None
    if traffic.get("exposure"):
        lo, hi = traffic["exposure"]
        exposure = np.random.default_rng(
            np.random.SeedSequence([seed, k, 1])).uniform(lo, hi, len(views))
        views = [v.double() * float(a) for v, a in zip(views, exposure)]
    u8 = torch.stack([(v * 255).to(torch.uint8) for v in views])
    host = list(u8.cpu().numpy())
    return World(host, rots, focal, texture, exposure, is_rig)


__all__ = ["World", "world_texture", "sample_texture", "render_view",
           "sweep", "make_views", "rig", "SphereTexture", "sphere_noise",
           "sphere_texture", "render_rig_view", "world_seed", "make_world"]
