"""Backward warp of every region into its mosaic patch, exact bilinear
sampling, spherical or cylindrical.

Counterpart of ``pano360_tpu.ops.pallas_warp.pallas_backward_warp`` at
mip level 0, which computes ``pano360_tpu.render.backward_warp_all``.
The CUDA kernel (``csrc/backward_warp.cu``) runs on CUDA tensors; the
plain PyTorch version ``backward_warp_ref`` (a port of
``backward_warp_all``) is what a CPU tensor gets.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from pano360_tpu_torch import _kernels
from pano360_tpu_torch.geometry import CylProj, SphProj
from pano360_tpu_torch.ops.warp import reflect_index, safe_floor

launches = 0           # CUDA kernel launches (main-path evidence)


def _default_wins(n: int, device) -> torch.Tensor:
    return torch.tensor([[-1.0, -1.0, math.inf, math.inf]] * n,
                        dtype=torch.float32, device=device)


def mosaic_coords(bottoms, resolution, range_min, ph: int, pw: int,
                  period: Optional[int] = None):
    """Mosaic pixel coordinates of every patch pixel and their
    (azimuth, height) angles: -> px, py, xs, ys, each (N, ph, pw).
    Columns past a periodic seam take their final column's azimuth."""
    dev = bottoms.device
    bottoms = bottoms.to(torch.float32)
    y_i, x_i = torch.meshgrid(
        torch.arange(ph, dtype=torch.float32, device=dev),
        torch.arange(pw, dtype=torch.float32, device=dev), indexing="ij")
    px = x_i[None] + bottoms[:, 0, None, None]
    py = y_i[None] + bottoms[:, 1, None, None]
    px_s = px if period is None else px - period * (px >= period)
    xs = px_s * resolution[0] + range_min[0]
    ys = py * resolution[1] + range_min[1]
    return px, py, xs, ys


def project_rays(projs, xs, ys, cylindrical: bool = False):
    """K R times the spherical (or cylindrical) rays of angles (xs, ys):
    -> (u, v, z), each (N, ph, pw)."""
    proj = CylProj if cylindrical else SphProj
    rays = proj.proj2hom(torch.stack([xs, ys], dim=-1))     # (N, ph, pw, 3)
    p = projs.to(torch.float32)[:, None, None]              # (N, 1, 1, 3, 3)
    return [p[..., i, 0] * rays[..., 0] + p[..., i, 1] * rays[..., 1]
            + p[..., i, 2] * rays[..., 2] for i in range(3)]


def outside_windows(wins, px, py):
    """Pixels outside each region's true window [lo_x, lo_y, hi_x, hi_y)."""
    wn = wins.to(torch.float32)[:, :, None, None]
    return (px < wn[:, 0]) | (py < wn[:, 1]) | (px >= wn[:, 2]) | \
        (py >= wn[:, 3])


def backward_warp_ref(imgs, projs, bottoms, resolution, range_min,
                      ph: int, pw: int, wins=None,
                      period: Optional[int] = None,
                      cylindrical: bool = False):
    """Plain PyTorch version. imgs: (N, H, W, 4) f32; projs: (N, 3, 3)
    = K R; bottoms: (N, 2) patch origins [x, y]; resolution/range_min:
    (2,); wins: optional (N, 4) [lo_x, lo_y, hi_x, hi_y) true windows;
    period: full-turn width of a periodic canvas; cylindrical: the
    cylindrical projection instead of the spherical one. Returns
    (patches (N, ph, pw, 4), invalid (N, ph, pw) bool)."""
    n, h, w, c = imgs.shape
    if wins is None:
        wins = _default_wins(n, imgs.device)
    px, py, xs, ys = mosaic_coords(bottoms, resolution, range_min, ph, pw,
                                   period)
    u, v, z = project_rays(projs, xs, ys, cylindrical)
    mask = z < 0
    x_pr = u / z + w / 2
    y_pr = v / z + h / 2
    mask |= (x_pr < 0) | (x_pr > w - 1) | (y_pr < 0) | (y_pr > h - 1)
    mask |= outside_windows(wins, px, py)

    x0, fx = safe_floor(x_pr, w)
    y0, fy = safe_floor(y_pr, h)
    fx, fy = fx[..., None], fy[..., None]
    ix0, ix1 = reflect_index(x0, w), reflect_index(x0 + 1, w)
    iy0, iy1 = reflect_index(y0, h), reflect_index(y0 + 1, h)
    flat = imgs.reshape(n, h * w, c)

    def tap(iy, ix):
        idx = (iy * w + ix).reshape(n, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(n, ph, pw, c)

    top = tap(iy0, ix0) * (1 - fx) + tap(iy0, ix1) * fx
    bot = tap(iy1, ix0) * (1 - fx) + tap(iy1, ix1) * fx
    out = top * (1 - fy) + bot * fy
    out = torch.cat([out[..., :3], (out[..., 3] * (~mask))[..., None]],
                    dim=-1)
    return out, mask


def backward_warp(imgs, projs, bottoms, resolution, range_min,
                  ph: int, pw: int, wins=None,
                  period: Optional[int] = None, cylindrical: bool = False):
    """The CUDA kernel for CUDA tensors, the plain version for CPU ones
    (same arguments and results as ``backward_warp_ref``)."""
    global launches
    if imgs.device.type == "cpu":
        return backward_warp_ref(imgs, projs, bottoms, resolution,
                                 range_min, ph, pw, wins, period,
                                 cylindrical)
    if imgs.device.type != "cuda":
        raise ValueError(f"backward_warp: unsupported device {imgs.device}")
    n, h, w, c = imgs.shape
    if imgs.dtype != torch.float32 or c != 4 or not imgs.is_contiguous():
        raise ValueError("backward_warp takes a contiguous (N, H, W, 4) "
                         f"float32 stack, got {tuple(imgs.shape)} "
                         f"{imgs.dtype}")
    dev = imgs.device
    if wins is None:
        wins = _default_wins(n, dev)
    args = []
    for name, t, shape in (("projs", projs, (n, 3, 3)),
                           ("bottoms", bottoms, (n, 2)),
                           ("wins", wins, (n, 4))):
        t = torch.as_tensor(t)
        if tuple(t.shape) != shape:
            raise ValueError(f"backward_warp: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        args.append(t.to(device=dev, dtype=torch.float32).contiguous())
    projs_d, bottoms_d, wins_d = args
    res = [float(v) for v in torch.as_tensor(resolution).reshape(2)]
    rmin = [float(v) for v in torch.as_tensor(range_min).reshape(2)]
    patches = torch.empty((n, ph, pw, 4), dtype=torch.float32, device=dev)
    invalid = torch.empty((n, ph, pw), dtype=torch.uint8, device=dev)
    code = _kernels.lib().p360_backward_warp(
        imgs.data_ptr(), projs_d.data_ptr(), bottoms_d.data_ptr(),
        wins_d.data_ptr(), patches.data_ptr(), invalid.data_ptr(), n, h, w,
        ph, pw, res[0], res[1], rmin[0], rmin[1],
        -1 if period is None else int(period), int(bool(cylindrical)),
        _kernels.stream_ptr(dev))
    _kernels.check(code, "p360_backward_warp")
    launches += 1
    return patches, invalid.bool()


__all__ = ["backward_warp", "backward_warp_ref", "mosaic_coords",
           "project_rays", "outside_windows"]
