"""Rendering: projection extents, layout, hat weights, exposure gains,
backward warp, blenders, crop (counterpart of ``pano360_tpu.render``).

The host keeps the small data-dependent pieces (resolution rule, canvas
and patch-window layout, periodic-seam bookkeeping, the per-pair overlap
windows and the f64 gain solve, the crop rectangle) in numpy, exactly as
the JAX package computes them; the device runs the border projection,
the weights, the pairwise overlap warps, the backward warp (the CUDA
kernels on the card: ``ops.warp_kernel.launch_warp``, exact, and
``ops.warp_mip.launch_mip_warp``, mip-sampled for ``warp="pallas"``)
and the blend. Multiband blends bands from DoGs of each patch with
sigma = sqrt(2l+1)*4 and sharp argmax-weight seams; periodic canvases
paste on an x-extended canvas and fold the spilled strip back.
"""
from __future__ import annotations

import logging
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pano360_tpu_torch import geometry as geo
from pano360_tpu_torch import profiling
from pano360_tpu_torch.ops.filters import gaussian_blur
from pano360_tpu_torch.ops.warp import bilinear_taps, perspective_maps
from pano360_tpu_torch.ops.warp_kernel import launch_warp, prepare_warp
from pano360_tpu_torch.ops.warp_mip import (build_mips, launch_mip_warp,
                                            plan_windows, prepare_mip_warp)
from pano360_tpu_torch.register import PanoImage

MAX_RESOLUTION = 1400
WARP_POLICIES = ("auto", "pallas", "xla")
LOG = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Projection extents & resolution
# ---------------------------------------------------------------------------

def _border_points(shape: Tuple[int, int], nel: int) -> np.ndarray:
    """(4 nel, 3) center-relative border samples, f32 (built in f64)."""
    h, w = np.float32(shape[0]), np.float32(shape[1])
    frac = np.linspace(0.0, 1.0, nel)
    zeros, ones = np.zeros(nel), np.ones(nel)
    side_x = (frac * w).astype(np.float32)
    side_y = (frac * h).astype(np.float32)
    b = np.concatenate([
        np.stack([zeros, side_y, ones], axis=1),
        np.stack([np.full(nel, w), side_y, ones], axis=1),
        np.stack([side_x, zeros, ones], axis=1),
        np.stack([side_x, np.full(nel, h), ones], axis=1),
    ]).astype(np.float32)
    return b - np.array([w / 2, h / 2, 0.0], np.float32)


def proj_img_range_border(shape: Tuple[int, int], homs: torch.Tensor,
                          projection=geo.SphProj, nel: int = 100,
                          shapes: Optional[np.ndarray] = None
                          ) -> torch.Tensor:
    """Projected extent of the image borders for (N, 3, 3) homs: one
    (4, N, 2) array [rmin, rmax, uw_min, uw_max], where the ``uw`` pair
    is the azimuth range unwrapped around each view's center direction
    (a contiguous interval that may leave [-pi, pi) at the seam).
    ``shapes``: optional per-image (N, 2) (h, w) in place of the single
    ``shape`` when the images have mixed sizes."""
    homs = homs.to(torch.float32)
    profiling.count("host_syncs")       # the borders' blocking copy
    if shapes is None:
        borders = torch.as_tensor(_border_points(shape, nel),
                                  device=homs.device)
        pts = torch.einsum("nij,kj->nki", homs, borders)
    else:
        borders = torch.as_tensor(np.stack(
            [_border_points((hh, ww), nel) for hh, ww in np.asarray(shapes)]),
            device=homs.device)
        pts = torch.einsum("nij,nkj->nki", homs, borders)
    pts = projection.hom2proj(pts)
    rmin = pts.min(dim=1).values
    rmax = pts.max(dim=1).values
    azc = projection.hom2proj(homs[:, :, 2])[:, 0]
    ax = pts[..., 0]
    ax_u = azc[:, None] + torch.remainder(ax - azc[:, None] + torch.pi,
                                          2 * torch.pi) - torch.pi
    uw_min = torch.stack([ax_u.min(dim=1).values, rmin[:, 1]], dim=-1)
    uw_max = torch.stack([ax_u.max(dim=1).values, rmax[:, 1]], dim=-1)
    return torch.stack([rmin, rmax, uw_min, uw_max])


def _np_hom2proj(pts: np.ndarray, projection=geo.SphProj) -> np.ndarray:
    hypot = np.hypot(pts[..., 0], pts[..., 2])
    theta = np.arctan2(pts[..., 0], pts[..., 2])
    if projection is geo.CylProj:
        return np.stack([theta, pts[..., 1] / hypot], axis=-1)
    return np.stack([theta, np.arctan2(pts[..., 1], hypot)], axis=-1)


def proj_img_range_corners(shape: Tuple[int, int], hom: np.ndarray,
                           projection=geo.SphProj):
    """Corner-based extent with wraparound fix. Host."""
    height, width = shape
    pts = np.array([[-width / 2, -height / 2, 1], [width / 2, -height / 2, 1],
                    [-width / 2, height / 2, 1], [width / 2, height / 2, 1]])
    pts = _np_hom2proj(pts @ hom.T, projection)
    xmin = min(pts[0, 0], pts[2, 0])
    xmax = max(pts[1, 0], pts[3, 0])
    ymin = min(pts[0, 1], pts[1, 1])
    ymax = max(pts[2, 1], pts[3, 1])
    if xmin > xmax:
        xmax += 2 * np.pi
    if ymin > ymax:
        ymax += np.pi
    return np.array([xmin, ymin]), np.array([xmax, ymax])


def estimate_resolution(regions: List[PanoImage],
                        max_resolution: int = MAX_RESOLUTION,
                        projection=geo.SphProj):
    """Output resolution (rad/px) and global range. Host."""
    min_r = np.min(np.stack([r.range[0] for r in regions]), axis=0)
    max_r = np.max(np.stack([r.range[1] for r in regions]), axis=0)
    size = max_r - min_r
    mid = regions[len(regions) // 2]
    im_shape = np.array(mid.img.shape[:2][::-1])
    mid_range = proj_img_range_corners(mid.img.shape[:2], mid.hom(),
                                       projection)
    resolution = (mid_range[1] - mid_range[0]) / im_shape
    max_side = np.max(size / resolution)
    if max_side > max_resolution:
        resolution *= max_side / max_resolution
    return resolution, (min_r, max_r)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def hat(size: int, device=None) -> torch.Tensor:
    """Triangular 0-0.5-0 ramp."""
    xx = torch.arange(size, dtype=torch.float32, device=device) - size / 2
    return 0.5 - torch.abs(xx / size)


def add_weights(imgs: torch.Tensor,
                shapes: Optional[np.ndarray] = None) -> torch.Tensor:
    """(N, H, W, 3) BGR [0, 1] -> (N, H, W, 4) with hat-product alpha.
    ``shapes``: optional per-image (N, 2) true (h, w) of a stack
    zero-padded to a common shape; the hat then spans each image's true
    extent and is zero over the padding."""
    n, h, w, _ = imgs.shape
    dev = imgs.device
    if shapes is None:
        alpha = hat(h, dev)[:, None] * hat(w, dev)[None, :]
        alpha = alpha.expand(n, h, w)
    else:
        profiling.count("host_syncs")
        dims = torch.as_tensor(np.asarray(shapes), dtype=torch.float32,
                               device=dev)
        hs, ws = dims[:, 0, None, None], dims[:, 1, None, None]
        yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
        xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
        hy = torch.clamp(0.5 - torch.abs((yy - hs / 2) / hs), min=0.0)
        hx = torch.clamp(0.5 - torch.abs((xx - ws / 2) / ws), min=0.0)
        alpha = hy * hx * (yy < hs) * (xx < ws)
    return torch.cat([imgs, alpha[..., None]], dim=-1).contiguous()


# ---------------------------------------------------------------------------
# Exposure compensation
# ---------------------------------------------------------------------------

def find_gains(overlaps: np.ndarray, sizes: np.ndarray,
               stdn: float = 0.1, stdg: float = 2.0) -> np.ndarray:
    """Solve the Brown-Lowe eq.(29) gain system. Host, float64."""
    nsize1 = (sizes + sizes.T) / (stdn * stdn)
    nsize2 = sizes / (stdg * stdg)
    aa = np.diag(np.sum(nsize1 * overlaps * overlaps + nsize2, axis=1))
    aa -= nsize1 * overlaps * overlaps.T
    return np.linalg.solve(aa, np.sum(nsize2, axis=1))


def _pair_overlap_stats(imgs: torch.Tensor, homs_win: torch.Tensor,
                        pair_i: torch.Tensor, pair_j: torch.Tensor,
                        origins: torch.Tensor, wh: int, ww: int,
                        dims_i: Optional[torch.Tensor] = None):
    """Overlap mean intensities of all pairs in one batched warp.

    Pair p works in its (wh, ww) window of image i's frame, at
    ``origins[p]`` (oy, ox): image j is warped into the window by
    ``homs_win[p]`` (j's pixels -> window pixels, cv2 convention) with a
    zero constant border, and the overlap is where the warped alpha is
    nonzero. imgs: (N, H, W, 4). ``dims_i``: optional per-pair (P, 2)
    true (h_i, w_i), restricting the overlap to image i's true region
    (zero-padded mixed-size stacks). Returns (mean_i, mean_j, count),
    each (P,): the mean of i's and of j's RGB over the overlap.
    """
    map_x, map_y = perspective_maps(homs_win, (wh, ww))
    overlap = bilinear_taps(imgs, map_x, map_y, "constant", 0.0,
                            index=pair_j)                 # (P, wh, ww, 4)
    dev = imgs.device
    yy = origins[:, 0, None, None] + torch.arange(wh, device=dev)[:, None]
    xx = origins[:, 1, None, None] + torch.arange(ww, device=dev)[None, :]
    mask = overlap[..., 3] != 0
    if dims_i is not None:
        mask = mask & (yy < dims_i[:, 0, None, None]) \
            & (xx < dims_i[:, 1, None, None])
    mask = mask[..., None]
    cnt = mask.sum(dim=(1, 2, 3))
    win_i = imgs[pair_i[:, None, None], yy, xx]           # (P, wh, ww, 4)
    zero = torch.zeros((), device=dev)
    sum_i = torch.where(mask, win_i[..., :3], zero).sum(dim=(1, 2, 3))
    sum_j = torch.where(mask, overlap[..., :3], zero).sum(dim=(1, 2, 3))
    denom = torch.clamp(cnt * 3, min=1)
    return sum_i / denom, sum_j / denom, cnt


def _np_hom_to_from(c1: PanoImage, c2: PanoImage) -> np.ndarray:
    return (c1.intr @ c1.rot) @ (c2.rot.T @ np.linalg.inv(c2.intr))


def overlap_matrices(regions: List[PanoImage], imgs_rgba: torch.Tensor,
                     shapes: Optional[np.ndarray] = None):
    """(overlaps, sizes) matrices feeding the gain solve: overlaps[i, j]
    = mean intensity of image i over the (i, j) overlap, sizes[i, j] =
    the overlap's pixel count. Pairs are pruned on the host (a warped
    corner behind the camera, or a warped-quad bbox missing i's frame);
    the rest share one window shape (64-px buckets), clamped into the
    frame. ``shapes``: optional per-image true (h, w) of a zero-padded
    mixed-size stack."""
    n = len(regions)
    height, width = imgs_rgba.shape[1:3]
    mixed = shapes is not None
    if shapes is None:
        shapes = np.array([[height, width]] * n)
    pair_i, pair_j, homs, boxes = [], [], [], []
    for i in range(n):
        hi, wi = shapes[i]
        tr = np.array([[1, 0, wi / 2], [0, 1, hi / 2], [0, 0, 1]])
        for j in range(i + 1, n):
            hj, wj = shapes[j]
            inv_tr = np.array([[1, 0, -wj / 2], [0, 1, -hj / 2],
                               [0, 0, 1]])
            corners = np.array([[0, 0, 1], [wj, 0, 1],
                                [wj, hj, 1], [0, hj, 1]])
            hom = tr @ _np_hom_to_from(regions[i], regions[j]) @ inv_tr
            pts = corners @ hom.T
            if np.any(pts[:, 2] < 0):
                continue
            q = pts[:, :2] / pts[:, 2:3]
            x0 = max(int(np.floor(q[:, 0].min())) - 2, 0)
            y0 = max(int(np.floor(q[:, 1].min())) - 2, 0)
            x1 = min(int(np.ceil(q[:, 0].max())) + 2, int(wi))
            y1 = min(int(np.ceil(q[:, 1].max())) + 2, int(hi))
            if x0 >= x1 or y0 >= y1:
                continue
            pair_i.append(i)
            pair_j.append(j)
            homs.append(hom)
            boxes.append((y0, x0, y1, x1))
    overlaps = np.zeros((n, n))
    sizes = np.zeros((n, n))
    if not homs:
        return overlaps, sizes
    boxes = np.array(boxes)
    wh = min(-(-int((boxes[:, 2] - boxes[:, 0]).max()) // 64) * 64, height)
    ww = min(-(-int((boxes[:, 3] - boxes[:, 1]).max()) // 64) * 64, width)
    oy = np.minimum(boxes[:, 0], height - wh)
    ox = np.minimum(boxes[:, 1], width - ww)
    shift = [np.array([[1, 0, -x], [0, 1, -y], [0, 0, 1]])
             for y, x in zip(oy, ox)]
    homs_win = np.stack([s @ h for s, h in zip(shift, homs)])
    dev = imgs_rgba.device
    # four (five) blocking copies to the device, three reads back
    profiling.count("host_syncs", 7 + mixed)
    mi, mj, cnt = (t.cpu().numpy() for t in _pair_overlap_stats(
        imgs_rgba, torch.as_tensor(homs_win, dtype=torch.float32,
                                   device=dev),
        torch.as_tensor(pair_i, device=dev),
        torch.as_tensor(pair_j, device=dev),
        torch.as_tensor(np.stack([oy, ox], axis=1), device=dev), wh, ww,
        torch.as_tensor(shapes[np.asarray(pair_i)], device=dev)
        if mixed else None))
    for k in range(len(homs)):
        i, j = pair_i[k], pair_j[k]
        if cnt[k] == 0:
            continue
        sizes[i, j] = sizes[j, i] = cnt[k]
        overlaps[i, j] = mi[k]
        overlaps[j, i] = mj[k]
    return overlaps, sizes


def estimate_gains(regions: List[PanoImage], imgs_rgba: torch.Tensor,
                   shapes: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-image exposure gains over the pairwise overlaps: (N,).
    ``shapes``: per-image true (h, w) of a zero-padded stack."""
    gains = find_gains(*overlap_matrices(regions, imgs_rgba, shapes))
    LOG.debug("Gains: %s", gains)
    return gains


def apply_gains(imgs_rgba: torch.Tensor, gains) -> torch.Tensor:
    """Scale rgb by per-image gains, clipped to [0, 1]."""
    profiling.count("host_syncs")
    g = torch.as_tensor(gains, dtype=torch.float32,
                        device=imgs_rgba.device)[:, None, None, None]
    rgb = torch.clamp(imgs_rgba[..., :3] * g, 0.0, 1.0)
    return torch.cat([rgb, imgs_rgba[..., 3:]], dim=-1).contiguous()


def equalize_gains(regions: List[PanoImage], imgs_rgba: torch.Tensor,
                   shapes: Optional[np.ndarray] = None) -> torch.Tensor:
    """Estimate and apply exposure gains: the corrected (N, H, W, 4)."""
    return apply_gains(imgs_rgba,
                       estimate_gains(regions, imgs_rgba, shapes))


# ---------------------------------------------------------------------------
# Blenders
# ---------------------------------------------------------------------------

def _ext(shape: Tuple[int, int], period: Optional[int], pw: int):
    """Paste-canvas shape: x-extended past the full turn when periodic."""
    if period is None:
        return shape
    return (shape[0], max(shape[1], period) + pw)


def _windows(bottoms: np.ndarray, ph: int, pw: int):
    return [(slice(int(y), int(y) + ph), slice(int(x), int(x) + pw))
            for x, y in np.asarray(bottoms)]


def _fold_add(acc: torch.Tensor, shape, period: Optional[int], pw: int):
    if period is None:
        return acc
    out = acc[:, :shape[1]].clone()
    out[:, :pw] += acc[:, period:period + pw]
    return out


def _to_u8(mosaic: torch.Tensor) -> torch.Tensor:
    return torch.clamp(mosaic * 255, 0, 255).to(torch.uint8)


def blend_none(patches, masks, bottoms, shape, period=None, mesh=None):
    """Sequential paste without blending (last writer wins).

    ``mesh`` (``parallel.mesh.Mesh``, this and the other blenders): the
    patches are this rank's contiguous shard; each rank pastes its shard
    on its own canvas and the canvases combine in ascending rank order
    (here the largest global writer id), so every rank returns the
    mosaic."""
    n, ph, pw = patches.shape[:3]
    dev = patches.device
    k0 = 0 if mesh is None else mesh.rank * n       # global id of patch 0
    acc = torch.zeros(_ext(shape, period, pw) + (4,), device=dev)
    for k, win in enumerate(_windows(bottoms, ph, pw)):
        tile = torch.cat([patches[k, ..., :3],
                          torch.full((ph, pw, 1), k0 + k + 1.0, device=dev)],
                         -1)
        acc[win] = torch.where(masks[k][..., None], acc[win], tile)
    if mesh is not None:
        acc = mesh.ordered_take(acc, 3)
    if period is None:
        return _to_u8(acc[..., :3])
    marg = acc[:, period:period + pw]
    main = acc[:, :shape[1]].clone()
    take = (marg[..., 3] > main[:, :pw, 3])[..., None]
    main[:, :pw] = torch.where(take, marg, main[:, :pw])
    return _to_u8(main[..., :3])


def blend_linear(patches, masks, bottoms, shape, period=None, mesh=None):
    """Alpha-weighted average (``mesh``: the canvases' ordered sum)."""
    n, ph, pw = patches.shape[:3]
    acc = torch.zeros(_ext(shape, period, pw) + (4,), device=patches.device)
    for k, win in enumerate(_windows(bottoms, ph, pw)):
        p = patches[k]
        tile = torch.where(masks[k][..., None], 0.0, p[..., :3])
        acc[win] += torch.cat([tile * p[..., 3:], p[..., 3:]], dim=-1)
    if mesh is not None:
        acc = mesh.ordered_sum(acc)
    acc = _fold_add(acc, shape, period, pw)
    wsum = torch.where(acc[..., 3] == 0, 1.0, acc[..., 3])
    return _to_u8(acc[..., :3] / wsum[..., None])


def blend_multiband(patches, masks, bottoms, shape, n_levels: int = 5,
                    period: Optional[int] = None, mesh=None):
    """Multi-band blending with sharp argmax-weight seams. ``mesh``: the
    seam canvases combine by the strictly greater weight in ascending
    rank order (the sequential loop's first-writer-wins), the validity
    by OR and each band's sums by the ordered sum; the per-level blurs
    run on the local shard."""
    n, ph, pw = patches.shape[:3]
    dev = patches.device
    ext = _ext(shape, period, pw)
    wins = _windows(bottoms, ph, pw)
    k0 = 0 if mesh is None else mesh.rank * n

    # 1) argmax-weight seam assignment (first writer wins ties)
    best_w = torch.zeros(ext, device=dev)
    best_i = torch.full(ext, -1.0, device=dev)
    for k, win in enumerate(wins):
        w_new = patches[k, ..., 3]
        take = w_new > best_w[win]
        best_w[win] = torch.where(take, w_new, best_w[win])
        best_i[win] = torch.where(take, float(k0 + k), best_i[win])
    packed = torch.stack([best_w, best_i], dim=-1)
    if mesh is not None:
        packed = mesh.ordered_take(packed, 0)
    if period is not None:
        marg = packed[:, period:period + pw]
        folded = packed[:, :shape[1]].clone()
        take = (marg[..., 0] > folded[:, :pw, 0])[..., None]
        folded[:, :pw] = torch.where(take, marg, folded[:, :pw])
        if period > shape[1]:
            folded = torch.cat([folded, packed[:, shape[1]:period]], dim=1)
        packed = torch.cat([folded[:, :period],
                            folded[:, :ext[1] - period]], dim=1)
    best_i = packed[..., 1].to(torch.int32)

    # sharp masks: alpha := (argmax == k)
    sharp = torch.stack([(best_i[win] == k0 + k).to(torch.float32)
                         for k, win in enumerate(wins)])
    patches = torch.cat([patches[..., :3], sharp[..., None]], dim=-1)

    # union of valid pixels
    allmask = torch.zeros(ext, dtype=torch.bool, device=dev)
    for k, win in enumerate(wins):
        allmask[win] |= ~masks[k]
    if mesh is not None:
        allmask = mesh.any(allmask)
    if period is not None:
        marg = allmask[:, period:period + pw]
        allmask = allmask[:, :shape[1]].clone()
        allmask[:, :pw] |= marg

    mosaic = torch.zeros(shape + (3,), device=dev)
    prevs = patches
    for lvl in range(n_levels):
        sigma = float(np.sqrt(2 * lvl + 1.0) * 4)
        is_last = lvl == n_levels - 1
        if not is_last:
            blurred = gaussian_blur(patches, sigma)
            tiles_rgb = prevs[..., :3] - blurred[..., :3]
            tiles_a = blurred[..., 3]
        else:
            tiles_rgb = prevs[..., :3]
            tiles_a = prevs[..., 3]
        acc = torch.zeros(ext + (4,), device=dev)
        for k, win in enumerate(wins):
            acc[win] += torch.cat([tiles_rgb[k] * tiles_a[k][..., None],
                                   tiles_a[k][..., None]], dim=-1)
        if mesh is not None:
            acc = mesh.ordered_sum(acc)
        acc = _fold_add(acc, shape, period, pw)
        layer = torch.where(allmask[..., None], acc[..., :3], 0.0)
        wsum = torch.where(acc[..., 3] == 0, 1.0, acc[..., 3])
        mosaic = mosaic + layer / wsum[..., None]
        if not is_last:
            prevs = blurred
    mosaic = torch.clamp(mosaic, 0.0, 1.0)
    return (mosaic * 255).to(torch.uint8)


BLENDERS = {
    "none": blend_none,
    "linear": blend_linear,
    "multiband": blend_multiband,
}


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

class MosaicLayout(NamedTuple):
    """Canvas + patch-window geometry of a render (host-side plan)."""

    shape: Tuple[int, int]      # padded canvas (H, W) for the blenders
    out_hw: Tuple[int, int]     # true output (H, W) sliced at the end
    bottoms: np.ndarray         # (N, 2) int patch origins [x, y]
    wins: np.ndarray            # (N, 4) true windows [lo_x, lo_y, hi_x, hi_y)
    ph: int
    pw: int
    period: Optional[int]       # full-turn width when periodic, else None
    resolution: np.ndarray      # (2,) rad/px
    im_range: Tuple[np.ndarray, np.ndarray]
    # (N, 2) true (h, w) of mixed-size images zero-padded into one stack
    # (set by ``prepare``); None when all share one shape
    shapes: Optional[np.ndarray] = None


def plan_layout(regions: List[PanoImage], ranges: np.ndarray, blender: str,
                max_resolution: int, proj=geo.SphProj) -> MosaicLayout:
    """Canvas shape, patch windows and periodicity for a render: the JAX
    package's plan (wrapped ranges set the canvas; seam-crossing views
    take their unwrapped footprint modulo the full-turn width; canvas
    padded to 64 px and patches to 32 px, the padding masked by ``wins``)."""
    n = len(regions)
    rmin, rmax, uw_min, uw_max = np.asarray(ranges, np.float64)
    resolution, im_range = estimate_resolution(regions, max_resolution,
                                               proj)
    target = (im_range[1] - im_range[0]) / resolution
    shape = tuple(int(t) for t in np.round(target))[::-1]

    period = int(round(2 * np.pi / resolution[0]))
    eps = 0.5 * float(resolution[0])
    crossing = ((uw_min[:, 0] < im_range[0][0] - eps)
                | (uw_max[:, 0] > im_range[1][0] + eps))
    use_wrap = bool(crossing.any()) and period + 1 >= shape[1]

    lo_r = np.where(crossing[:, None], uw_min, rmin) if use_wrap else rmin
    hi_r = np.where(crossing[:, None], uw_max, rmax) if use_wrap else rmax
    bottoms, tops = [], []
    for k in range(n):
        bottom = np.round((lo_r[k] - im_range[0]) / resolution)
        top = np.round((hi_r[k] - im_range[0]) / resolution)
        bottom, top = bottom.astype(np.int64), top.astype(np.int64)
        if blender == "multiband":
            bottom, top = bottom - 10, top + 10
            bottom[1] = max(bottom[1], 0)
            top[1] = min(top[1], int(target[1]))
            if not use_wrap:
                bottom[0] = max(bottom[0], 0)
                top[0] = min(top[0], int(target[0]))
        bottoms.append(bottom)
        tops.append(top)
    bottoms = np.stack(bottoms)
    tops = np.stack(tops)
    if use_wrap and int((tops[:, 0] - bottoms[:, 0]).max()) > period:
        use_wrap = False
        bottoms = np.round((rmin - im_range[0]) / resolution).astype(np.int64)
        tops = np.round((rmax - im_range[0]) / resolution).astype(np.int64)
        if blender == "multiband":
            bottoms = np.maximum(bottoms - 10, 0)
            tops = np.minimum(tops + 10, target.astype(np.int64))

    ph = int((tops[:, 1] - bottoms[:, 1]).max())
    pw = int((tops[:, 0] - bottoms[:, 0]).max())
    out_hw = shape
    shape = (-(-shape[0] // 64) * 64, -(-shape[1] // 64) * 64)
    ph = -(-ph // 32) * 32
    pw = -(-pw // 32) * 32
    wins = np.concatenate([bottoms, tops], axis=1)
    ph, pw = min(ph, shape[0]), min(pw, shape[1])
    if use_wrap:
        x0 = bottoms[:, 0] % period
        shift = x0 - bottoms[:, 0]
        wins[:, 0] += shift
        wins[:, 2] += shift
        bottoms[:, 0] = x0
    else:
        bottoms[:, 0] = np.clip(bottoms[:, 0], 0, shape[1] - pw)
    bottoms[:, 1] = np.clip(bottoms[:, 1], 0, shape[0] - ph)
    return MosaicLayout(shape, out_hw, bottoms, wins, ph, pw,
                        period if use_wrap else None, resolution, im_range)


def _crop_valid(invalid: np.ndarray, bottoms: np.ndarray, ph: int,
                pw: int, shape: Tuple[int, int],
                period: Optional[int]) -> np.ndarray:
    """Union of valid patch pixels on the canvas (host, for crop). With a
    periodic canvas the spilled strip folds back as the blenders' pastes
    do, on a canvas anchored at max(width, period) as in ``_ext``."""
    ext_w = shape[1] if period is None else max(shape[1], period) + pw
    valid = np.zeros((shape[0], ext_w), bool)
    for k in range(invalid.shape[0]):
        x0, y0 = bottoms[k]
        valid[y0:y0 + ph, x0:x0 + pw] |= ~invalid[k]
    if period is not None:
        valid[:, :pw] |= valid[:, period:period + pw]
    return valid[:, :shape[1]]


# ---------------------------------------------------------------------------
# Stitch
# ---------------------------------------------------------------------------

def prepare(regions: List[PanoImage], blender: str,
            max_resolution: int, device, dev_images=None,
            projection=geo.SphProj):
    """Upload (or reuse) the images, set each region's range and plan the
    layout: -> (imgs_rgba (N, H, W, 4) f32 on ``device``, layout).
    Images of mixed sizes are zero-padded to the largest (H, W) and
    ``layout.shapes`` is their (N, 2) true (h, w) (None when all share
    one shape): it masks the padding in the weights, the warp bounds and
    the equalization. ``dev_images``: the uint8 stack already on the
    device, or a ``pipeline.BucketStacks`` (padded there, not uploaded
    again) when it holds all N regions."""
    n = len(regions)
    shapes = np.array([r.img.shape[:2] for r in regions])
    uniform = bool((shapes == shapes[0]).all())
    h, w = int(shapes[:, 0].max()), int(shapes[:, 1].max())
    if dev_images is not None and hasattr(dev_images, "to_padded"):
        dev_images = dev_images.to_padded(h, w) if dev_images.n == n else None
    if dev_images is not None and dev_images.shape[0] == n:
        imgs = dev_images
    elif uniform:
        profiling.count("host_syncs")
        imgs = torch.as_tensor(np.stack([r.img for r in regions]),
                               device=device)
    else:
        stack = np.zeros((n, h, w, 3), regions[0].img.dtype)
        for k, r in enumerate(regions):
            hk, wk = r.img.shape[:2]
            stack[k, :hk, :wk] = r.img
        profiling.count("host_syncs")
        imgs = torch.as_tensor(stack, device=device)
    if imgs.dtype == torch.uint8:
        imgs = imgs.to(torch.float32) / 255.0
    imgs = imgs.to(torch.float32)
    shapes = None if uniform else shapes
    profiling.count("host_syncs", 2)    # the homographies' copy, the read
    homs = torch.as_tensor(np.stack([r.hom() for r in regions]),
                           dtype=torch.float32, device=device)
    ranges = proj_img_range_border((h, w), homs, projection, shapes=shapes
                                   ).cpu().numpy().astype(np.float64)
    for k, reg in enumerate(regions):
        reg.range = (ranges[0][k], ranges[1][k])
    layout = plan_layout(regions, ranges, blender, max_resolution,
                         projection)._replace(shapes=shapes)
    return add_weights(imgs, shapes), layout


def warp_patches(imgs_rgba: torch.Tensor, projs: np.ndarray,
                 layout: MosaicLayout, projection=geo.SphProj,
                 warp: str = "auto"):
    """Backward-warp every region into its patch: -> (patches (N, ph,
    pw, 4), invalid (N, ph, pw) bool), alpha zeroed where invalid. Each
    warp's plan goes to the card in one copy that does not wait, so no
    step from the host inputs to the returned patches waits for the
    card (the ``gpu`` test holds it to PyTorch's sync-debug mode and to
    a profiler trace of the CUDA runtime calls).

    ``warp``: "auto" and "xla" take the exact kernel at any resolution;
    "pallas" takes the mip-sampled kernel at ``plan_windows``'s levels,
    or, when a tile's window fits the caps at no level, warns and takes
    the exact kernel (the JAX package's policy). With ``layout.shapes``
    (a zero-padded mixed-size stack) "pallas" takes the exact kernel
    too, as the JAX package does: the mip-sampled kernel takes one
    image size.
    """
    if warp not in WARP_POLICIES:
        raise ValueError(f"warp must be one of {WARP_POLICIES}, got {warp!r}")
    cyl = projection is geo.CylProj
    dev = imgs_rgba.device
    args = (projs, layout.bottoms, layout.wins, layout.resolution,
            layout.im_range[0])
    if warp == "pallas" and layout.shapes is None:
        hw = tuple(imgs_rgba.shape[1:3])
        origins, ok, win_y, win_x, n_levels = plan_windows(
            projs, layout.bottoms, layout.resolution, layout.im_range[0], hw,
            layout.ph, layout.pw, period=layout.period, cylindrical=cyl)
        if ok:
            mips = build_mips(imgs_rgba, n_levels, win_y, win_x)
            plan = prepare_mip_warp(
                *args, origins, layout.ph, layout.pw, win_y, win_x, hw,
                [m.shape[1:3] for m in mips], layout.period, cyl, dev)
            return launch_mip_warp(mips, plan)
        LOG.warning("pallas warp requested but a tile source window "
                    "cannot fit the window caps at any mip level; using "
                    "the exact warp")
    plan = prepare_warp(*args, layout.ph, layout.pw, layout.period, cyl, dev,
                        layout.shapes)
    return launch_warp(imgs_rgba, plan)


def _region_shard(imgs_rgba: torch.Tensor, projs: np.ndarray,
                  layout: MosaicLayout, mesh):
    """This rank's contiguous shard of the regions, padded to the mesh's
    shard size with regions that warp to nothing: identity projection,
    zero image, an all-invalid window (the JAX package's padding). ->
    (images, projections, layout of the shard)."""
    n = imgs_rgba.shape[0]
    per = mesh.per(n)
    lo = min(mesh.rank * per, n)
    hi = min(lo + per, n)
    pad = per - (hi - lo)
    rgba = imgs_rgba[lo:hi]
    if pad:
        rgba = torch.cat([rgba, rgba.new_zeros((pad,) + rgba.shape[1:])])

    def rows(a, fill):
        a = np.asarray(a)[lo:hi]
        return np.concatenate([a, np.broadcast_to(
            np.asarray(fill, a.dtype), (pad,) + a.shape[1:])])
    shapes = layout.shapes
    if shapes is not None:
        shapes = rows(shapes, imgs_rgba.shape[1:3])
    return rgba, rows(projs, np.eye(3)), layout._replace(
        bottoms=rows(layout.bottoms, 0), wins=rows(layout.wins, -1),
        shapes=shapes)


@profiling.span("render")
def stitch(regions: List[PanoImage], blender: str = "multiband",
           equalize: bool = False, crop: bool = False, dev_images=None,
           max_resolution: int = MAX_RESOLUTION, warp: str = "auto",
           projection: str = "spherical", device="cuda",
           mesh=None) -> np.ndarray:
    """Full render: ranges -> layout -> weights -> (gains) -> warp ->
    blend -> (crop).

    ``regions[k].img``: uint8 BGR (or float BGR in [0, 1]); mixed image
    shapes are zero-padded to the largest with each image's true size
    masking the padding. ``dev_images``: the (N, H, W, 3) uint8 stack
    already on the device (or ``pipeline.BucketStacks``).
    ``equalize``: exposure gains from the pairwise overlaps, applied
    before the warp. ``crop``: cut to the largest rectangle of valid
    pixels (the native library, else its Python fallback).
    ``warp``: see ``warp_patches``. ``projection``: "spherical" or
    "cylindrical". ``mesh`` (``parallel.mesh.Mesh``): the layout, the
    weights and the gains are computed on every rank, each rank warps
    its shard of the regions (the exact kernel, whatever ``warp`` says,
    as in the JAX package) and blends it, the canvases combine across
    the ranks, and the crop reads the gathered masks; every rank returns
    the mosaic, on ``mesh.device``. Returns the uint8 BGR mosaic.
    """
    proj = geo.PROJECTIONS[projection]
    device = torch.device(device if mesh is None else mesh.device)
    imgs_rgba, layout = prepare(regions, blender, max_resolution, device,
                                dev_images, proj)
    if equalize:
        imgs_rgba = equalize_gains(regions, imgs_rgba, layout.shapes)
    projs = np.stack([r.proj() for r in regions])
    if mesh is None:
        patches, invalid = warp_patches(imgs_rgba, projs, layout, proj, warp)
        lay = layout
    else:
        rgba, projs, lay = _region_shard(imgs_rgba, projs, layout, mesh)
        patches, invalid = warp_patches(rgba, projs, lay, proj, "auto")
    mosaic = BLENDERS[blender](patches, invalid, lay.bottoms, layout.shape,
                               period=layout.period, mesh=mesh)
    if mesh is not None:
        invalid = mesh.gather_rows(invalid, len(regions))
    out_h, out_w = layout.out_hw
    profiling.count("host_syncs")
    mosaic = mosaic.cpu().numpy()[:out_h, :out_w]
    if crop:
        from pano360_tpu_torch import native
        profiling.count("host_syncs")
        valid = _crop_valid(invalid.cpu().numpy(), layout.bottoms, layout.ph,
                            layout.pw, layout.shape, layout.period)
        mosaic = native.crop_mosaic(mosaic, valid[:out_h, :out_w])
    return mosaic


__all__ = ["MAX_RESOLUTION", "WARP_POLICIES", "proj_img_range_border",
           "proj_img_range_corners", "estimate_resolution", "hat",
           "add_weights", "find_gains", "overlap_matrices", "estimate_gains",
           "apply_gains", "equalize_gains", "MosaicLayout", "plan_layout",
           "prepare", "warp_patches", "blend_none", "blend_linear",
           "blend_multiband", "BLENDERS", "stitch"]
