"""Backward warp of every region into its mosaic patch, exact bilinear
sampling, spherical or cylindrical.

Counterpart of ``pano360_tpu.ops.pallas_warp.pallas_backward_warp`` at
mip level 0, which computes ``pano360_tpu.render.backward_warp_all``.
The CUDA kernel (``csrc/backward_warp.cu``) runs on CUDA tensors; the
plain PyTorch version ``backward_warp_ref`` (a port of
``backward_warp_all``) is what a CPU tensor gets.

A render prepares its warp once (``prepare_warp``: the per-region
parameters packed into one pinned buffer, copied to the card by a copy
that does not wait) and launches it with the images (``launch_warp``:
two output allocations and one kernel, nothing read back).
``backward_warp`` does both.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from pano360_tpu_torch import _kernels
from pano360_tpu_torch.geometry import CylProj, SphProj
from pano360_tpu_torch.ops.warp import reflect_index, safe_floor

PARAM_FLOATS = 20      # one region's packed parameters (csrc/warp_common.cuh)
MAX_GRID = 65535       # regions, and the exact kernel's patch rows
# float operations of one patch pixel, as the plain version does them:
# mosaic coordinates (8), the ray (7), K R times it (15), the projection
# and the validity tests (20), floor and fraction (8), reflect indices
# (16), the bilinear blend of 4 channels (38), the alpha mask (1)
OPS_PER_PX = 113


def _default_wins(n: int, device) -> torch.Tensor:
    return torch.tensor([[-1.0, -1.0, math.inf, math.inf]] * n,
                        dtype=torch.float32, device=device)


def on_device(device, *arrays):
    """Each array (numpy or a tensor; None stays None) as float32 on
    ``device``: the plain versions' small arguments."""
    return [None if a is None else
            torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


def mosaic_coords(bottoms, resolution, range_min, ph: int, pw: int,
                  period: Optional[int] = None):
    """Mosaic pixel coordinates of every patch pixel and their
    (azimuth, height) angles: -> px, py, xs, ys, each (N, ph, pw).
    Columns past a periodic seam take their final column's azimuth."""
    dev = bottoms.device
    bottoms = bottoms.to(torch.float32)
    # host values stay on the host: a 0-dim CPU tensor is a scalar to a
    # CUDA op
    resolution = torch.as_tensor(resolution, dtype=torch.float32)
    range_min = torch.as_tensor(range_min, dtype=torch.float32)
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


def true_dims(img_hw, shapes, n: int, device):
    """Each region's true (h, w) as two (N, 1, 1) float32 tensors:
    ``shapes`` (N, 2), where a row of zeros (or ``shapes=None``) means
    the stack's own ``img_hw``."""
    hw = torch.tensor(img_hw, dtype=torch.float32, device=device)
    if shapes is None:
        dims = hw.expand(n, 2)
    else:
        shapes = torch.as_tensor(shapes, dtype=torch.float32, device=device)
        dims = torch.where(shapes > 0, shapes, hw)
    return dims[:, 0, None, None], dims[:, 1, None, None]


def sample_points(img_hw, projs, bottoms, resolution, range_min, ph: int,
                  pw: int, wins=None, period: Optional[int] = None,
                  cylindrical: bool = False, shapes=None):
    """Where every patch pixel samples its region, and whether it is
    invalid: -> (x_pr, y_pr, invalid), each (N, ph, pw). ``shapes``:
    optional (N, 2) true (h, w) of regions zero-padded into a stack of
    ``img_hw``; the centre offset and the bounds test take them."""
    h, w = true_dims(img_hw, shapes, projs.shape[0], bottoms.device)
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


def warp_cost(n_px: int, n_texels: int, n_sectors: Optional[int] = None):
    """The least work of a warp that writes ``n_px`` patch pixels (RGBA
    f32 and a mask byte) from ``n_texels`` distinct RGBA f32 source
    texels: bytes (each read once, each output written once), operations
    (``OPS_PER_PX``) and the bound in ms on the H100 (as
    ``gauss_octave.octave_stack_cost``). With ``n_sectors``, the distinct
    32-byte sectors those texels lie in, also ``sector_floor_ms``: the
    same writes with the reads at sector granularity, the least that a
    gather moves."""
    from pano360_tpu_torch.ops.gauss_octave import (F32_FLOPS_PER_S,
                                                    HBM_BYTES_PER_S)
    nbytes = 16 * n_texels + 17 * n_px
    flops = OPS_PER_PX * n_px
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / F32_FLOPS_PER_S * 1e3
    out = dict(bytes=nbytes, flops=flops, bytes_ms=bytes_ms,
               flops_ms=flops_ms, bound_ms=max(bytes_ms, flops_ms),
               bound_by="bytes" if bytes_ms >= flops_ms else "operations")
    if n_sectors is not None:
        out.update(sectors=n_sectors, sector_floor_ms=(
            32 * n_sectors + 17 * n_px) / HBM_BYTES_PER_S * 1e3)
    return out


def _texel_cost(n_px: int, idx: torch.Tensor):
    """``warp_cost`` of flat texel indices ``idx`` (every tap of every
    pixel, into buffers that start on a 128-byte boundary with a texel
    count per image and level that is a multiple of 8); also the
    distinct 64- and 128-byte segments of the taps (``segments_64``,
    ``segments_128``)."""
    texels = torch.unique(idx)
    out = warp_cost(n_px, int(texels.numel()),
                    int(torch.unique(texels // 2).numel()))
    out.update(segments_64=int(torch.unique(texels // 4).numel()),
               segments_128=int(torch.unique(texels // 8).numel()))
    return out


def backward_warp_cost(imgs, projs, bottoms, resolution, range_min,
                       ph: int, pw: int, wins=None,
                       period: Optional[int] = None,
                       cylindrical: bool = False, shapes=None):
    """``warp_cost`` of one ``backward_warp`` call on these inputs: the
    texels are the distinct bilinear taps of every patch pixel."""
    n, h, w, _ = imgs.shape
    projs, bottoms, wins, shapes = on_device(imgs.device, projs, bottoms,
                                             wins, shapes)
    x_pr, y_pr, _ = sample_points((h, w), projs, bottoms, resolution,
                                  range_min, ph, pw, wins, period,
                                  cylindrical, shapes)
    (iy0, iy1, ix0, ix1), _, _ = _taps(x_pr, y_pr, h, w)
    img = torch.arange(n, device=x_pr.device)[:, None, None] * (h * w)
    idx = torch.stack([img + iy * w + ix for iy in (iy0, iy1)
                       for ix in (ix0, ix1)])
    return _texel_cost(n * ph * pw, idx)


def backward_warp_ref(imgs, projs, bottoms, resolution, range_min,
                      ph: int, pw: int, wins=None,
                      period: Optional[int] = None,
                      cylindrical: bool = False, shapes=None):
    """Plain PyTorch version. imgs: (N, H, W, 4) f32; projs: (N, 3, 3)
    = K R; bottoms: (N, 2) patch origins [x, y]; resolution/range_min:
    (2,); wins: optional (N, 4) [lo_x, lo_y, hi_x, hi_y) true windows;
    period: full-turn width of a periodic canvas; cylindrical: the
    cylindrical projection instead of the spherical one; shapes:
    optional (N, 2) true (h, w) of images zero-padded into the stack
    (the centre offset and the bounds test take the true size, the
    reflect indexing the stack's). Returns (patches (N, ph, pw, 4),
    invalid (N, ph, pw) bool). The small arguments may come from the
    host."""
    n, h, w, c = imgs.shape
    projs, bottoms, wins, shapes = on_device(imgs.device, projs, bottoms,
                                             wins, shapes)
    x_pr, y_pr, mask = sample_points((h, w), projs, bottoms, resolution,
                                     range_min, ph, pw, wins, period,
                                     cylindrical, shapes)
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


@dataclass(frozen=True)
class WarpPlan:
    """What one render's warp needs besides the images, built once from
    host data by ``prepare_warp``: every region's K R, patch origin, true
    window and true size packed in ``params`` ((N, PARAM_FLOATS) float32 on
    ``device``, copied there without a wait from the pinned ``host``
    buffer), and the scalars that go into a launch by value (also as
    ``c_launch``, the C entry's structure of them)."""
    device: torch.device
    n: int
    ph: int
    pw: int
    res: Tuple[float, float]      # float32 values, as Python floats
    rmin: Tuple[float, float]
    period: Optional[int]
    cylindrical: bool
    params: torch.Tensor
    host: torch.Tensor
    c_launch: ctypes.Structure

    @property
    def projs(self) -> torch.Tensor:
        return self.params[:, :9].reshape(self.n, 3, 3)

    @property
    def bottoms(self) -> torch.Tensor:
        return self.params[:, 9:11]

    @property
    def wins(self) -> torch.Tensor:
        return self.params[:, 11:15]

    @property
    def true_hw(self) -> torch.Tensor:
        """(N, 2) true (h, w); a row of zeros means the stack's size."""
        return self.params[:, 15:17]

    def ref_args(self):
        """(projs, bottoms, resolution, range_min) and the keywords of the
        plain version, from the plan (the same float32 values)."""
        return ((self.projs, self.bottoms, torch.tensor(self.res),
                 torch.tensor(self.rmin)),
                dict(wins=self.wins, period=self.period,
                     cylindrical=self.cylindrical, shapes=self.true_hw))


def host_array(who: str, name: str, value, shape=None,
               dtype=np.float32) -> np.ndarray:
    """``value`` (numpy, numbers or a CPU tensor) as a numpy array of
    ``dtype`` (None: its own); a tensor on another device raises: a plan
    is built from host data and reads nothing back from the card."""
    if isinstance(value, torch.Tensor):
        if value.device.type != "cpu":
            raise ValueError(f"{who}: {name} is a {value.device.type} "
                             "tensor; pass it from the host (numpy, floats "
                             "or a CPU tensor)")
        value = value.detach().numpy()
    arr = np.asarray(value)
    if shape is not None and arr.shape != tuple(shape):
        raise ValueError(f"{who}: {name} must be {tuple(shape)}, got "
                         f"{arr.shape}")
    return arr if dtype is None else arr.astype(dtype, copy=False)


def pack_params(who: str, n: int, projs, bottoms, wins,
                shapes=None) -> np.ndarray:
    """-> (n, PARAM_FLOATS) float32: each region's K R (row-major),
    bottom [x, y], true window [lo_x, lo_y, hi_x, hi_y) (default: no
    window) and true size [h, w] (default 0, 0: the stack's), as
    ``csrc/warp_common.cuh`` reads them."""
    out = np.zeros((n, PARAM_FLOATS), np.float32)
    out[:, :9] = host_array(who, "projs", projs, (n, 3, 3)).reshape(n, 9)
    out[:, 9:11] = host_array(who, "bottoms", bottoms, (n, 2))
    out[:, 11:15] = (-1.0, -1.0, math.inf, math.inf) if wins is None else \
        host_array(who, "wins", wins, (n, 4))
    if shapes is not None:
        out[:, 15:17] = host_array(who, "shapes", shapes, (n, 2))
    return out


def upload(buf: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One float32 buffer to ``device``: -> (host tensor, device tensor).
    On a card the host copy is pinned and the copy does not wait for the
    device; the pinned block is not reused before the copy has run."""
    flat = np.ascontiguousarray(buf, np.float32).reshape(-1)
    if device.type == "cpu":
        host = torch.from_numpy(flat)
        return host, host
    host = torch.empty(flat.size, dtype=torch.float32, pin_memory=True)
    host.numpy()[:] = flat
    return host, host.to(device, non_blocking=True)


def _scalars(who: str, resolution, range_min):
    res = host_array(who, "resolution", resolution).reshape(2)
    rmin = host_array(who, "range_min", range_min).reshape(2)
    return (float(res[0]), float(res[1])), (float(rmin[0]), float(rmin[1]))


def warp_view(n: int, ph: int, pw: int, res, rmin, period: Optional[int],
              cylindrical: bool) -> _kernels.WarpView:
    return _kernels.WarpView(n, ph, pw, -1 if period is None else period,
                             int(cylindrical), *res, *rmin)


def check_sizes(who: str, n: int, ph: int, pw: int):
    if not (0 < n <= MAX_GRID and 0 < ph <= MAX_GRID and pw > 0):
        raise ValueError(f"{who}: 1 to {MAX_GRID} regions and a "
                         f"non-empty patch of at most {MAX_GRID} rows, got "
                         f"n={n}, {ph}x{pw}")


def prepare_warp(projs, bottoms, wins, resolution, range_min, ph: int,
                 pw: int, period: Optional[int] = None,
                 cylindrical: bool = False, device="cuda",
                 shapes=None) -> WarpPlan:
    """The plan of one render's exact warp, from host data (numpy,
    numbers or CPU tensors; a tensor on the card raises): projs (N, 3, 3)
    = K R; bottoms (N, 2); wins (N, 4) or None; resolution/range_min
    (2,); shapes (N, 2) true (h, w) of images zero-padded into one stack,
    or None when every image fills it. Packs them into one buffer and copies it to ``device`` with a
    copy that does not wait for the card."""
    who = "prepare_warp"
    device = torch.device(device)
    n = int(np.shape(bottoms)[0])
    check_sizes(who, n, ph, pw)
    res, rmin = _scalars(who, resolution, range_min)
    host, params = upload(pack_params(who, n, projs, bottoms, wins, shapes),
                          device)
    period = None if period is None else int(period)
    return WarpPlan(params.device, n, int(ph), int(pw), res, rmin, period,
                    bool(cylindrical), params.view(n, PARAM_FLOATS), host,
                    warp_view(n, ph, pw, res, rmin, period, cylindrical))


def _launch_cuda(imgs: torch.Tensor, plan: WarpPlan):
    """The kernel on a CUDA stack with a plan on its device; allocates
    the outputs. -> (patches, invalid bool)."""
    n, h, w, c = imgs.shape
    if imgs.dtype != torch.float32 or c != 4 or not imgs.is_contiguous():
        raise ValueError("backward_warp takes a contiguous (N, H, W, 4) "
                         f"float32 stack, got {tuple(imgs.shape)} "
                         f"{imgs.dtype}")
    dev = plan.device
    if n != plan.n or imgs.device != dev:
        raise ValueError(f"backward_warp: a plan of {plan.n} regions on "
                         f"{dev}, got {n} images on {imgs.device}")
    patches = torch.empty((n, plan.ph, plan.pw, 4), dtype=torch.float32,
                          device=dev)
    invalid = torch.empty((n, plan.ph, plan.pw), dtype=torch.bool,
                          device=dev)
    _kernels.launch(
        "p360_backward_warp", plan.c_launch, imgs.data_ptr(), h, w,
        plan.params.data_ptr(), patches.data_ptr(), invalid.data_ptr(),
        _kernels.stream_ptr(dev))
    return patches, invalid


def launch_warp(imgs: torch.Tensor, plan: WarpPlan):
    """The exact warp of ``imgs`` with a prepared plan: the CUDA kernel
    for a CUDA stack, the plain version for a CPU one. -> (patches (N,
    ph, pw, 4), invalid (N, ph, pw) bool)."""
    if imgs.is_cuda:
        return _launch_cuda(imgs, plan)
    if imgs.device.type != "cpu":
        raise ValueError(f"backward_warp: unsupported device {imgs.device}")
    if plan.device.type != "cpu":
        raise ValueError(f"backward_warp: a plan on {plan.device}, images "
                         "on the cpu")
    args, kw = plan.ref_args()
    return backward_warp_ref(imgs, *args, plan.ph, plan.pw, **kw)


def backward_warp(imgs, projs, bottoms, resolution, range_min,
                  ph: int, pw: int, wins=None,
                  period: Optional[int] = None, cylindrical: bool = False,
                  shapes=None):
    """Prepare, then launch: the CUDA kernel for CUDA images, the plain
    version for CPU ones (same arguments and results as
    ``backward_warp_ref``; the small arguments come from the host)."""
    if imgs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"backward_warp: unsupported device {imgs.device}")
    plan = prepare_warp(projs, bottoms, wins, resolution, range_min, ph, pw,
                        period, cylindrical, imgs.device, shapes)
    return launch_warp(imgs, plan)


__all__ = ["WarpPlan", "prepare_warp", "launch_warp", "backward_warp",
           "backward_warp_ref", "mosaic_coords", "project_rays",
           "outside_windows", "sample_points", "warp_cost",
           "backward_warp_cost", "OPS_PER_PX", "PARAM_FLOATS"]
