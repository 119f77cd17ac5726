"""Mip-sampled backward warp: the ``--warp pallas`` path under
minification.

Counterpart of ``pano360_tpu.ops.pallas_warp`` with ``n_levels > 1``.
Each 32x128 output tile samples one (win_y, win_x) source window of one
level of a 2x box mip pyramid, at the origin and level ``plan_windows``
chose for it, with bilinear taps clamped into the window. The CUDA kernel
(``csrc/backward_warp_mip.cu``) runs on CUDA tensors; the plain PyTorch
version ``backward_warp_mip_ref`` is what a CPU tensor gets.

The plan is the JAX package's, origins included: the window decides where
taps are clamped, so it shapes the RGB that invalid pixels carry, which
the multiband blender blurs into valid neighbours. Its caps (the
``MAX_WIN_*`` budgets) are the level-choice rule. What was specific to
the TPU (the VMEM window copy, the one-hot sampling matmuls) is gone:
the card gathers directly from the level buffers.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from pano360_tpu_torch import _kernels
from pano360_tpu_torch.ops.warp_kernel import (PARAM_FLOATS, WarpPlan,
                                               _default_wins, _scalars,
                                               _texel_cost, check_sizes,
                                               host_array, mosaic_coords,
                                               on_device, outside_windows,
                                               pack_params, project_rays,
                                               upload, warp_view)

TILE_Y = 32
TILE_X = 128
MAX_WIN_Y = 256          # window caps; plan_windows shrinks to the image
MAX_WIN_X = 512
MARGIN = 8
MAX_LEVELS = _kernels.MAX_LEVELS   # the CUDA kernel's parameter block
# |v| >= 2^23 holds only integers in float32: clamping there before the
# int cast keeps every fraction
_COORD_LIM = float(2 ** 24)


def _level_dims(img_shape: Tuple[int, int], lvl: int):
    """(true, padded) dims of mip level ``lvl`` (ceil-halved, then aligned
    to 8 rows and 128 columns)."""
    h, w = img_shape
    hl = -(-h // (1 << lvl))
    wl = -(-w // (1 << lvl))
    return (hl, wl), ((-(-hl // 8)) * 8, (-(-wl // 128)) * 128)


def plan_windows(projs: np.ndarray, bottoms: np.ndarray,
                 resolution: np.ndarray, range_min: np.ndarray,
                 img_shape: Tuple[int, int], ph: int, pw: int,
                 period: Optional[int] = None, cylindrical: bool = False):
    """Per-tile source windows with mip-level selection (host, numpy).

    Returns ``(origins (N, nty, ntx, 3) int32 [y, x, level], ok, win_y,
    win_x, n_levels)``. Each output tile samples the coarsest level whose
    window of its projected corners (plus a margin) fits the caps; one
    (win_y, win_x) window shape serves every tile, sized by the worst
    need, and each origin is aligned down to (8, 128) and clamped into its
    level's padded dims. ``ok`` is False when that window exceeds the
    caps. ``img_shape`` is the TRUE (h, w). Every tile of every region at
    once, with the JAX package's float64 operations per tile corner (its
    loop over tiles gives the same plan).
    """
    h, w = img_shape
    n = projs.shape[0]
    nty = -(-ph // TILE_Y)
    ntx = -(-pw // TILE_X)
    # max level-0 extent that still fits the caps after alignment slack
    budget_y = MAX_WIN_Y - 2 * 8
    budget_x = MAX_WIN_X - 2 * 128

    ys = np.arange(nty + 1) * TILE_Y
    xs = np.arange(ntx + 1) * TILE_X
    gy, gx = np.meshgrid(ys, xs, indexing="ij")          # (nty+1, ntx+1)
    gxa = gx + bottoms[:, 0, None, None]                 # (N, nty+1, ntx+1)
    if period is not None:
        gxa = gxa - period * (gxa >= period)
    mx = gxa * resolution[0] + range_min[0]
    my = (gy + bottoms[:, 1, None, None]) * resolution[1] + range_min[1]
    sxv, cxv = np.sin(mx), np.cos(mx)
    txv = my if cylindrical else np.tan(my)
    p = projs[:, :, :, None, None]
    u = p[:, 0, 0] * sxv + p[:, 0, 1] * txv + p[:, 0, 2] * cxv
    v = p[:, 1, 0] * sxv + p[:, 1, 1] * txv + p[:, 1, 2] * cxv
    z = p[:, 2, 0] * sxv + p[:, 2, 1] * txv + p[:, 2, 2] * cxv
    zs = np.where(np.abs(z) > 1e-12, z, 1e-12)
    px = np.clip(u / zs + w / 2, -1, w)
    py = np.clip(v / zs + h / 2, -1, h)
    valid = z > 0

    def corners(a):                                      # (4, N, nty, ntx)
        return np.stack([a[:, :-1, :-1], a[:, :-1, 1:], a[:, 1:, :-1],
                         a[:, 1:, 1:]])

    cval = corners(valid)
    live = cval.any(axis=0)                              # (N, nty, ntx)
    cpx, cpy = corners(px), corners(py)
    x0 = np.floor(np.where(cval, cpx, np.inf).min(axis=0))[live]
    x1 = np.ceil(np.where(cval, cpx, -np.inf).max(axis=0))[live]
    y0 = np.floor(np.where(cval, cpy, np.inf).min(axis=0))[live]
    y1 = np.ceil(np.where(cval, cpy, -np.inf).max(axis=0))[live]
    lvl = np.zeros(x0.shape, np.int64)
    while True:
        up = ((y1 - y0) / (1 << lvl) + 2 * MARGIN > budget_y) | \
            ((x1 - x0) / (1 << lvl) + 2 * MARGIN > budget_x)
        if not up.any():
            break
        lvl += up
    sy0 = np.floor((y0 + 0.5) / (1 << lvl) - 0.5) - MARGIN
    sx0 = np.floor((x0 + 0.5) / (1 << lvl) - 0.5) - MARGIN
    sy1 = np.ceil((y1 + 0.5) / (1 << lvl) - 0.5) + MARGIN
    sx1 = np.ceil((x1 + 0.5) / (1 << lvl) - 0.5) + MARGIN

    def round_up(v, m):
        return -(-v // m) * m

    need_y = int(max(1, (sy1 - sy0).astype(np.int64).max(initial=1)))
    need_x = int(max(1, (sx1 - sx0).astype(np.int64).max(initial=1)))
    _, (hp0, wp0) = _level_dims((h, w), 0)
    win_y = min(round_up(need_y, 8) + 8, hp0)
    win_x = min(round_up(need_x, 128) + 128, wp0)
    ok = win_y <= MAX_WIN_Y and win_x <= MAX_WIN_X
    # each level's padded dims, as _level_dims gives them
    hpl = round_up(-(-h // (1 << lvl)), 8)
    wpl = round_up(-(-w // (1 << lvl)), 128)
    origins = np.zeros((n, nty, ntx, 3), np.int32)
    origins[live] = np.stack([
        np.clip(sy0, 0, np.maximum(hpl - win_y, 0)).astype(np.int64)
        // 8 * 8,
        np.clip(sx0, 0, np.maximum(wpl - win_x, 0)).astype(np.int64)
        // 128 * 128, lvl], axis=-1)
    max_lvl = int(lvl.max(initial=0))
    return origins, ok, int(win_y), int(win_x), max_lvl + 1


def _edge_pad(imgs: torch.Tensor, ht: int, wt: int) -> torch.Tensor:
    """Edge-pad (N, H, W, C) to (ht, wt) by repeating the last row and
    column (copies only: no index tensor, no host sync)."""
    n, h, w, c = imgs.shape
    if ht > h:
        imgs = torch.cat([imgs, imgs[:, h - 1:].expand(n, ht - h, w, c)], 1)
    if wt > w:
        imgs = torch.cat([imgs, imgs[:, :, w - 1:].expand(n, ht, wt - w, c)],
                         2)
    return imgs


def pad_to_tiling(imgs: torch.Tensor,
                  min_shape: Tuple[int, int] = (8, 128)) -> torch.Tensor:
    """Edge-pad (N, H, W, C) to (8, 128)-aligned H/W, and to at least
    ``min_shape``, so every window origin can reach the trailing rows
    and columns of an unaligned image."""
    h, w = imgs.shape[1:3]
    ht = max((-(-h // 8)) * 8, min_shape[0])
    wt = max((-(-w // 128)) * 128, min_shape[1])
    return _edge_pad(imgs, ht, wt)


def build_mips(imgs: torch.Tensor, n_levels: int, win_y: int = 8,
               win_x: int = 128) -> List[torch.Tensor]:
    """2x box mip pyramid of an (N, H, W, 4) stack: each level the 2x2
    mean of the one before, ceil-halved (edge-padded to even dims first),
    then edge-padded to (8, 128) tiling and to at least the window.
    -> ``n_levels`` contiguous (N, Hl, Wl, 4) tensors."""
    levels = [pad_to_tiling(imgs, (win_y, win_x)).contiguous()]
    cur = imgs
    for _ in range(1, n_levels):
        h, w = cur.shape[1:3]
        cur = _edge_pad(cur, h + h % 2, w + w % 2)
        cur = 0.25 * (cur[:, ::2, ::2] + cur[:, 1::2, ::2]
                      + cur[:, ::2, 1::2] + cur[:, 1::2, 1::2])
        levels.append(pad_to_tiling(cur, (win_y, win_x)).contiguous())
    return levels


def backward_warp_mip_ref(mips: List[torch.Tensor], projs, bottoms,
                          resolution, range_min, origins, ph: int, pw: int,
                          win_y: int, win_x: int,
                          img_shape: Tuple[int, int], wins=None,
                          period: Optional[int] = None,
                          cylindrical: bool = False):
    """Plain PyTorch version. mips: levels from ``build_mips``; projs
    (N, 3, 3) = K R; bottoms (N, 2) patch origins [x, y];
    resolution/range_min (2,); origins (N, nty, ntx, 3) [y, x, level]
    and win_y/win_x from ``plan_windows``; img_shape: the TRUE level-0
    (h, w), which alone decides validity; wins: optional (N, 4) true
    windows; period: full-turn width of a periodic canvas. Returns
    (patches (N, ph, pw, 4), invalid (N, ph, pw) bool)."""
    n = mips[0].shape[0]
    idx, wps, fx, fy, mask = _mip_taps(mips, projs, bottoms, resolution,
                                       range_min, origins, ph, pw, win_y,
                                       win_x, img_shape, wins, period,
                                       cylindrical)
    fx, fy = fx[..., None], fy[..., None]
    # all levels of an image in one flat buffer: a pixel's taps index it
    # at its level's offset and row width
    flat = torch.cat([m.reshape(n, -1, 4) for m in mips], dim=1)

    def tap(off):
        i = (idx + off).reshape(n, -1, 1).expand(-1, -1, 4)
        return torch.gather(flat, 1, i).reshape(n, ph, pw, 4)

    top = tap(0) * (1 - fx) + tap(1) * fx
    bot = tap(wps) * (1 - fx) + tap(wps + 1) * fx
    out = top * (1 - fy) + bot * fy
    out = torch.cat([out[..., :3], (out[..., 3] * (~mask))[..., None]],
                    dim=-1)
    return out, mask


def mip_sample_points(mips: List[torch.Tensor], projs, bottoms, resolution,
                      range_min, origins, ph: int, pw: int,
                      img_shape: Tuple[int, int], wins=None,
                      period: Optional[int] = None,
                      cylindrical: bool = False):
    """Where every patch pixel samples its tile's level, in that level's
    own pixel coordinates (before the window clamp): -> (x, y, level,
    oy, ox, invalid), each (N, ph, pw)."""
    n = mips[0].shape[0]
    dev = mips[0].device
    h, w = img_shape
    if wins is None:
        wins = _default_wins(n, dev)
    org = torch.as_tensor(np.asarray(origins), device=dev).long()
    ty = torch.arange(ph, device=dev) // TILE_Y
    tx = torch.arange(pw, device=dev) // TILE_X
    org = org[:, ty][:, :, tx]                             # (N, ph, pw, 3)
    oy, ox, lvl = org[..., 0], org[..., 1], org[..., 2]

    projs, bottoms, wins = on_device(dev, projs, bottoms, wins)
    px, py, xs, ys = mosaic_coords(bottoms, resolution, range_min, ph, pw,
                                   period)
    u, v, z = project_rays(projs, xs, ys, cylindrical)
    mask = z < 0
    zs = torch.where(z.abs() > 1e-12, z, 1e-12)
    x_pr = u / zs + w / 2
    y_pr = v / zs + h / 2
    mask |= (x_pr < 0) | (x_pr > w - 1) | (y_pr < 0) | (y_pr > h - 1)
    mask |= outside_windows(wins, px, py)

    scale = torch.tensor([1.0 / (1 << lv) for lv in range(len(mips))],
                         dtype=torch.float32, device=dev)[lvl]
    return ((x_pr + 0.5) * scale - 0.5, (y_pr + 0.5) * scale - 0.5, lvl,
            oy, ox, mask)


def _mip_taps(mips, projs, bottoms, resolution, range_min, origins, ph, pw,
              win_y, win_x, img_shape, wins, period, cylindrical):
    """Each pixel's top-left tap as an index into its image's levels laid
    end to end, its level's row width, the fractions and the invalid
    mask: -> (idx, wps, fx, fy, invalid)."""
    dev = mips[0].device
    cx, cy, lvl, oy, ox, mask = mip_sample_points(
        mips, projs, bottoms, resolution, range_min, origins, ph, pw,
        img_shape, wins, period, cylindrical)

    def level_tap(c, origin, win):
        c = c - origin.to(torch.float32)
        c = torch.nan_to_num(c).clamp(-_COORD_LIM, _COORD_LIM)
        c0 = torch.floor(c)
        return (c0.long().clamp(0, win - 2) + origin), c - c0

    x0, fx = level_tap(cx, ox, win_x)
    y0, fy = level_tap(cy, oy, win_y)
    sizes = [m.shape[1] * m.shape[2] for m in mips]
    offs = torch.tensor(np.cumsum([0] + sizes[:-1]), device=dev)[lvl]
    wps = torch.tensor([m.shape[2] for m in mips], device=dev)[lvl]
    return offs + y0 * wps + x0, wps, fx, fy, mask


def backward_warp_mip_cost(mips: List[torch.Tensor], projs, bottoms,
                           resolution, range_min, origins, ph: int, pw: int,
                           win_y: int, win_x: int,
                           img_shape: Tuple[int, int], wins=None,
                           period: Optional[int] = None,
                           cylindrical: bool = False):
    """``warp_kernel.warp_cost`` of one ``backward_warp_mip`` call on
    these inputs: the texels are the distinct level taps of every patch
    pixel (the pyramid's build is not counted)."""
    n = mips[0].shape[0]
    idx, wps, _, _, _ = _mip_taps(mips, projs, bottoms, resolution,
                                  range_min, origins, ph, pw, win_y, win_x,
                                  img_shape, wins, period, cylindrical)
    per_img = sum(m.shape[1] * m.shape[2] for m in mips)
    idx = idx + torch.arange(n, device=idx.device)[:, None, None] * per_img
    taps = torch.stack([idx, idx + 1, idx + wps, idx + wps + 1])
    return _texel_cost(n * ph * pw, taps)


def _check_origins(origins: np.ndarray, n: int, ph: int, pw: int,
                   dims: List[Tuple[int, int]], win_y: int, win_x: int):
    shape = (n, -(-ph // TILE_Y), -(-pw // TILE_X), 3)
    if origins.shape != shape:
        raise ValueError(f"backward_warp_mip: origins must be {shape}, got "
                         f"{origins.shape}")
    oy, ox, lvl = origins[..., 0], origins[..., 1], origins[..., 2]
    if lvl.min() < 0 or lvl.max() >= len(dims):
        raise ValueError("backward_warp_mip: origins name a level outside "
                         f"[0, {len(dims)})")
    hp = np.array([d[0] for d in dims])[lvl]
    wp = np.array([d[1] for d in dims])[lvl]
    if (oy < 0).any() or (ox < 0).any() or (oy + win_y > hp).any() \
            or (ox + win_x > wp).any():
        raise ValueError("backward_warp_mip: a window at its origin "
                         "leaves its level's buffer")


@dataclass(frozen=True)
class MipWarpPlan(WarpPlan):
    """``WarpPlan`` of the mip-sampled warp: also every tile's checked
    [oy, ox, level] (``origins`` on the host; on the device as (N, nty,
    ntx) int4 [oy, ox, level, 0] after the parameters, in the same
    buffer and copy), the window, the true level-0 (h, w) and the levels'
    padded (hp, wp), which the launch's levels must have (``shapes``:
    their (N, hp, wp, 4))."""
    origins: np.ndarray
    origins_dev: torch.Tensor
    win: Tuple[int, int]
    img_shape: Tuple[int, int]
    dims: Tuple[Tuple[int, int], ...]
    shapes: List[torch.Size]

    def ref_args(self):
        (projs, bottoms, res, rmin), kw = super().ref_args()
        del kw["shapes"]        # the mip warp takes one image size
        return ((projs, bottoms, res, rmin, self.origins, self.ph, self.pw,
                 *self.win, self.img_shape), kw)


def prepare_mip_warp(projs, bottoms, wins, resolution, range_min, origins,
                     ph: int, pw: int, win_y: int, win_x: int,
                     img_shape: Tuple[int, int], level_dims,
                     period: Optional[int] = None, cylindrical: bool = False,
                     device="cuda") -> MipWarpPlan:
    """The plan of one render's mip-sampled warp, from host data (a
    tensor on the card raises): the exact warp's inputs (``prepare_warp``)
    plus ``origins``/``win_y``/``win_x`` from ``plan_windows``, the TRUE
    level-0 ``img_shape`` and ``level_dims``, the padded (hp, wp) of each
    level (``build_mips``'s shapes). Checks every origin here, once:
    integer, in shape, naming an existing level, its window inside that
    level. One buffer, one copy to ``device`` that does not wait."""
    who = "prepare_mip_warp"
    device = torch.device(device)
    n = int(np.shape(bottoms)[0])
    check_sizes(who, n, ph, pw)
    dims = tuple((int(hp), int(wp)) for hp, wp in level_dims)
    if not 1 <= len(dims) <= MAX_LEVELS:
        raise ValueError(f"backward_warp_mip: 1 to {MAX_LEVELS} levels, got "
                         f"{len(dims)}")
    if win_y < 2 or win_x < 2:
        raise ValueError(f"backward_warp_mip: a window of at least 2x2, got "
                         f"{win_y}x{win_x}")
    org = host_array(who, "origins", origins, dtype=None)
    if not np.issubdtype(org.dtype, np.integer):
        raise ValueError(f"backward_warp_mip: integer origins, got "
                         f"{org.dtype}")
    _check_origins(org, n, ph, pw, list(dims), win_y, win_x)
    res, rmin = _scalars(who, resolution, range_min)
    params = pack_params(who, n, projs, bottoms, wins)
    buf = np.zeros(params.size + 4 * org[..., 0].size, np.float32)
    buf[:params.size] = params.ravel()
    buf[params.size:].view(np.int32).reshape(-1, 4)[:, :3] = \
        org.reshape(-1, 3)
    host, dev = upload(buf, device)
    period = None if period is None else int(period)
    h, w = int(img_shape[0]), int(img_shape[1])
    pad = [0] * (MAX_LEVELS - len(dims))
    c_launch = _kernels.MipLaunch(
        warp_view(n, ph, pw, res, rmin, period, cylindrical), h, w,
        int(win_y), int(win_x), len(dims), (ctypes.c_int * MAX_LEVELS)(
            *[d[0] for d in dims], *pad),
        (ctypes.c_int * MAX_LEVELS)(*[d[1] for d in dims], *pad))
    return MipWarpPlan(
        dev.device, n, int(ph), int(pw), res, rmin, period,
        bool(cylindrical), dev[:params.size].view(n, PARAM_FLOATS), host,
        c_launch, origins=org.astype(np.int64),
        origins_dev=dev[params.size:].view(torch.int32),
        win=(int(win_y), int(win_x)), img_shape=(h, w), dims=dims,
        shapes=[torch.Size((n, hp, wp, 4)) for hp, wp in dims])


def _check_levels(mips: List[torch.Tensor], plan: MipWarpPlan):
    index = plan.device.index if plan.device.type == "cuda" else -1
    if [m.shape for m in mips] == plan.shapes and all(
            m.dtype == torch.float32 and m.is_contiguous()
            and m.get_device() == index for m in mips):
        return
    got = [(m.dtype, m.shape, m.is_contiguous(), m.device) for m in mips]
    if len(mips) != len(plan.dims):
        raise ValueError(f"backward_warp_mip: a plan of {len(plan.dims)} "
                         f"levels, got {len(mips)}")
    raise ValueError("backward_warp_mip takes contiguous (N, Hl, Wl, 4) "
                     "float32 levels of the plan's dims on its device "
                     f"{plan.device}: expected shapes {plan.shapes}, got "
                     f"{got}")


def _launch_cuda(mips: List[torch.Tensor], plan: MipWarpPlan):
    """The kernel on CUDA levels with a plan on their device; allocates
    the outputs. -> (patches, invalid bool)."""
    _check_levels(mips, plan)
    dev = plan.device
    ptrs = (ctypes.c_void_p * len(mips))(*[m.data_ptr() for m in mips])
    patches = torch.empty((plan.n, plan.ph, plan.pw, 4), dtype=torch.float32,
                          device=dev)
    invalid = torch.empty((plan.n, plan.ph, plan.pw), dtype=torch.bool,
                          device=dev)
    _kernels.launch(
        "p360_backward_warp_mip", plan.c_launch, ptrs,
        plan.origins_dev.data_ptr(), plan.params.data_ptr(),
        patches.data_ptr(), invalid.data_ptr(), _kernels.stream_ptr(dev))
    return patches, invalid


def launch_mip_warp(mips: List[torch.Tensor], plan: MipWarpPlan):
    """The mip-sampled warp of ``build_mips`` levels with a prepared
    plan: the CUDA kernel for CUDA levels, the plain version for CPU
    ones. -> (patches (N, ph, pw, 4), invalid (N, ph, pw) bool)."""
    if mips[0].is_cuda:
        return _launch_cuda(mips, plan)
    if mips[0].device.type != "cpu":
        raise ValueError("backward_warp_mip: unsupported device "
                         f"{mips[0].device}")
    _check_levels(mips, plan)
    args, kw = plan.ref_args()
    return backward_warp_mip_ref(mips, *args, **kw)


def backward_warp_mip(mips: List[torch.Tensor], projs, bottoms, resolution,
                      range_min, origins, ph: int, pw: int, win_y: int,
                      win_x: int, img_shape: Tuple[int, int], wins=None,
                      period: Optional[int] = None,
                      cylindrical: bool = False):
    """Prepare, then launch: the CUDA kernel for CUDA levels, the plain
    version for CPU ones (same arguments and results as
    ``backward_warp_mip_ref``; the small arguments come from the host).
    Raises when an origin names a missing level or puts its window
    outside its level's buffer."""
    dev = mips[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"backward_warp_mip: unsupported device {dev}")
    plan = prepare_mip_warp(projs, bottoms, wins, resolution, range_min,
                            origins, ph, pw, win_y, win_x, img_shape,
                            [m.shape[1:3] for m in mips], period,
                            cylindrical, dev)
    return launch_mip_warp(mips, plan)


__all__ = ["plan_windows", "pad_to_tiling", "build_mips", "MipWarpPlan",
           "prepare_mip_warp", "launch_mip_warp", "backward_warp_mip",
           "backward_warp_mip_ref", "mip_sample_points",
           "backward_warp_mip_cost", "TILE_Y", "TILE_X",
           "MAX_WIN_Y", "MAX_WIN_X"]
