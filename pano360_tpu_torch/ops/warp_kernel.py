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
# float operations of one patch pixel, as the plain version does them:
# mosaic coordinates (8), the ray (7), K R times it (15), the projection
# and the validity tests (20), floor and fraction (8), reflect indices
# (16), the bilinear blend of 4 channels (38), the alpha mask (1)
OPS_PER_PX = 113


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


def sample_points(img_hw, projs, bottoms, resolution, range_min, ph: int,
                  pw: int, wins=None, period: Optional[int] = None,
                  cylindrical: bool = False):
    """Where every patch pixel samples its region, and whether it is
    invalid: -> (x_pr, y_pr, invalid), each (N, ph, pw)."""
    h, w = img_hw
    if wins is None:
        wins = _default_wins(projs.shape[0], bottoms.device)
    px, py, xs, ys = mosaic_coords(bottoms, resolution, range_min, ph, pw,
                                   period)
    u, v, z = project_rays(projs, xs, ys, cylindrical)
    mask = z < 0
    x_pr = u / z + w / 2
    y_pr = v / z + h / 2
    mask |= (x_pr < 0) | (x_pr > w - 1) | (y_pr < 0) | (y_pr > h - 1)
    mask |= outside_windows(wins, px, py)
    return x_pr, y_pr, mask


def _taps(x_pr, y_pr, h: int, w: int):
    """Bilinear tap rows and columns (BORDER_REFLECT) and fractions:
    -> ((iy0, iy1, ix0, ix1), fx, fy)."""
    x0, fx = safe_floor(x_pr, w)
    y0, fy = safe_floor(y_pr, h)
    return ((reflect_index(y0, h), reflect_index(y0 + 1, h),
             reflect_index(x0, w), reflect_index(x0 + 1, w)), fx, fy)


def warp_cost(n_px: int, n_texels: int):
    """The least work of a warp that writes ``n_px`` patch pixels (RGBA
    f32 and a mask byte) from ``n_texels`` distinct RGBA f32 source
    texels: bytes (each read once, each output written once), operations
    (``OPS_PER_PX``) and the bound in ms on the H100 (as
    ``gauss_octave.octave_stack_cost``)."""
    from pano360_tpu_torch.ops.gauss_octave import (F32_FLOPS_PER_S,
                                                    HBM_BYTES_PER_S)
    nbytes = 16 * n_texels + 17 * n_px
    flops = OPS_PER_PX * n_px
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / F32_FLOPS_PER_S * 1e3
    return dict(bytes=nbytes, flops=flops, bytes_ms=bytes_ms,
                flops_ms=flops_ms, bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations")


def backward_warp_cost(imgs, projs, bottoms, resolution, range_min,
                       ph: int, pw: int, wins=None,
                       period: Optional[int] = None,
                       cylindrical: bool = False):
    """``warp_cost`` of one ``backward_warp`` call on these inputs: the
    texels are the distinct bilinear taps of every patch pixel."""
    n, h, w, _ = imgs.shape
    x_pr, y_pr, _ = sample_points((h, w), projs, bottoms, resolution,
                                  range_min, ph, pw, wins, period,
                                  cylindrical)
    (iy0, iy1, ix0, ix1), _, _ = _taps(x_pr, y_pr, h, w)
    img = torch.arange(n, device=x_pr.device)[:, None, None] * (h * w)
    idx = torch.stack([img + iy * w + ix for iy in (iy0, iy1)
                       for ix in (ix0, ix1)])
    return warp_cost(n * ph * pw, int(torch.unique(idx).numel()))


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
    x_pr, y_pr, mask = sample_points((h, w), projs, bottoms, resolution,
                                     range_min, ph, pw, wins, period,
                                     cylindrical)
    (iy0, iy1, ix0, ix1), fx, fy = _taps(x_pr, y_pr, h, w)
    fx, fy = fx[..., None], fy[..., None]
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
           "project_rays", "outside_windows", "sample_points", "warp_cost",
           "backward_warp_cost", "OPS_PER_PX"]
