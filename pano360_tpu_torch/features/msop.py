"""MSOP (Multi-Scale Oriented Patches) detector (counterpart of
``pano360_tpu.features.msop``).

A 4-level Harris pyramid with 3x3 local maxima, SSC adaptive non-maximal
suppression for homogeneous keypoint coverage, and oriented, blurred 8x8
patch descriptors. The device runs the Harris response, the max filter,
the pyramid, the candidate ordering and the patch sampling; the SSC
binary search is sequential host logic (the native ``ssc_select``, else
the Python version here).

Only the device-resident extraction is carried (``msop_extract_device``):
one packed pull of candidate codes and counts for all levels, SSC on the
host coordinates, and the selected candidates gathered and described on
the device, so orientations and descriptors never cross the host link.
"""
from __future__ import annotations

import math
import time
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from pano360_tpu_torch.ops.color import bgr2gray
from pano360_tpu_torch.ops.filters import (feature_ksize, gaussian_blur,
                                           harris_response, max_pool3x3,
                                           pyr_down, sobel)

DSIZE = 8                        # descriptor patch side
MAX_FEAT = (5000, 100, 25, 10)   # per-level keypoint budgets


class MsopFeatures(NamedTuple):
    """What ``pipeline.matching`` takes of a set of images: ``kpts``, the
    per-image (N_i, 2) float32 keypoint lists (level-major, SSC order),
    and the device buffers ``kp`` (N, C, 2), ``desc`` (N, C, 64) and
    ``valid`` (N, C) holding each image's ``counts[i]`` keypoints in the
    same order in their first rows."""

    kpts: List[np.ndarray]
    kp: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor
    counts: np.ndarray


# ---------------------------------------------------------------------------
# SSC adaptive non-maximal suppression
# ---------------------------------------------------------------------------

def ssc(keypoints: np.ndarray, im_size: Tuple[int, int], n_points: int,
        tol: float = 0.1) -> np.ndarray:
    """Pick ~n_points spatially homogeneous keypoints from score-ordered
    (x, y) input: a binary search over the suppression radius, each trial
    greedily keeping points whose grid cell is uncovered and covering a
    square of the current radius around them. Returns indices into
    ``keypoints``. ``use_native=False`` runs the Python version even when
    the native library is there."""
    cols, rows = im_size
    n_kpts = len(keypoints)
    if n_kpts <= n_points:
        return np.arange(n_kpts)

    from pano360_tpu_torch.native import ssc_select
    sel = ssc_select(keypoints, im_size, n_points, tol)
    if sel is not None:
        return sel

    # upper bound on the radius from the closed-form solution of
    # (rows+w)(cols+w) / (w/2)^2 = n_points
    exp1 = rows + cols + 2 * n_points
    exp2 = (4 * cols + 4 * n_points + 4 * rows * n_points + rows * rows
            + cols * cols - 2 * rows * cols + 4 * rows * cols * n_points)
    exp3 = math.sqrt(max(exp2, 0))
    exp4 = max(n_points - 1, 1)
    high = max(-round((exp1 + exp3) / exp4), -round((exp1 - exp3) / exp4))
    low = math.floor(math.sqrt(n_kpts / n_points))

    k_min = round(n_points - n_points * tol)
    k_max = round(n_points + n_points * tol)

    prev_width = -1
    result = np.arange(min(n_kpts, n_points))
    while True:
        width = low + (high - low) / 2
        if width == prev_width or low > high:
            break
        cgr = width / 2
        n_cc = int(cols / cgr)
        n_cr = int(rows / cgr)
        covered = np.zeros((n_cr + 1, n_cc + 1), bool)
        sel = []
        span = int(width / cgr)
        for i in range(n_kpts):
            row = int(keypoints[i, 1] / cgr)
            col = int(keypoints[i, 0] / cgr)
            if not covered[row, col]:
                sel.append(i)
                r0, r1 = max(row - span, 0), min(row + span, n_cr)
                c0, c1 = max(col - span, 0), min(col + span, n_cc)
                covered[r0:r1 + 1, c0:c1 + 1] = True
        if k_min <= len(sel) <= k_max:
            result = np.asarray(sel)
            break
        if len(sel) < k_min:
            high = width - 1
        else:
            low = width + 1
        prev_width = width
        result = np.asarray(sel)
    return np.asarray(result)


# ---------------------------------------------------------------------------
# Device stages
# ---------------------------------------------------------------------------

def msop_gray(stack_u8: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 BGR -> (N, H, W) float gray in 0..255."""
    return bgr2gray(stack_u8.to(torch.float32))


def _each(fn, stack: torch.Tensor, *args) -> torch.Tensor:
    """A filter of ``ops.filters`` over every image of a (B, H, W) stack
    (those read a bare rank 3 as (H, W, C))."""
    return fn(stack[..., None], *args)[..., 0]


def top_candidates(hrs: torch.Tensor, cap: int):
    """The ``cap`` strongest 3x3 local maxima of (B, H, W) Harris maps:
    -> (vals, idx), each (B, min(cap, H W)), by descending response; equal
    responses keep ascending pixel index (flat regions tie exactly, and
    SSC consumes this order), and slots past the maxima hold -inf."""
    b, h, w = hrs.shape
    locmax = _each(max_pool3x3, hrs) == hrs
    score = torch.where(locmax, hrs, -math.inf).reshape(b, -1)
    vals, idx = torch.sort(score, dim=1, descending=True, stable=True)
    cap = min(cap, h * w)
    return vals[:, :cap], idx[:, :cap]


def msop_level(gray: torch.Tensor, cap: int):
    """One pyramid level of a (B, H, W) gray batch: Harris, 3x3 maxima and
    the top ``cap`` candidates with their gradient orientations, plus the
    blurred map the descriptors sample and the next level.

    -> (vals, rows, cols, theta, blurred, next_gray), the candidate arrays
    (B, cap) by descending Harris response."""
    b, h, w = gray.shape
    g4 = gray[..., None]
    gx = gaussian_blur(sobel(g4, 1, 0), 1.0, feature_ksize(1.0))[..., 0]
    gy = gaussian_blur(sobel(g4, 0, 1), 1.0, feature_ksize(1.0))[..., 0]
    blurred = gaussian_blur(g4, 2.0, feature_ksize(2.0))[..., 0]
    vals, idx = top_candidates(harris_response(g4)[..., 0], cap)
    rows = torch.div(idx, w, rounding_mode="floor")
    cols = idx % w
    # orientation of the smoothed gradient: x first
    theta = torch.atan2(gx.reshape(b, -1).gather(1, idx),
                        gy.reshape(b, -1).gather(1, idx))
    return vals, rows, cols, theta, blurred, pyr_down(g4)[..., 0]


def oriented_descriptors(blurred: torch.Tensor, rows: torch.Tensor,
                         cols: torch.Tensor, thetas: torch.Tensor):
    """8x8 oriented patch descriptors: blurred (B, H, W); rows, cols,
    thetas (B, K) -> (B, K, 64). Patch pixel (u, v) samples the blurred
    image at ``center + R(theta)^T (u - 4, v - 4)``, bilinear with a zero
    constant border; each descriptor is normalized to zero mean and unit
    (population) standard deviation."""
    b, h, w = blurred.shape
    g = torch.arange(DSIZE, dtype=torch.float32,
                     device=blurred.device) - DSIZE / 2
    gv, gu = torch.meshgrid(g, g, indexing="ij")            # (8, 8)
    sin = torch.sin(thetas)[..., None, None]
    cos = torch.cos(thetas)[..., None, None]
    sx = cols.to(torch.float32)[..., None, None] + cos * gu + sin * gv
    sy = rows.to(torch.float32)[..., None, None] - sin * gu + cos * gv

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    inb = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 2)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 2)
    flat = blurred.reshape(b, -1)

    def tap(yi, xi):
        return flat.gather(1, (yi * w + xi).reshape(b, -1)).reshape(sx.shape)

    i00, i01 = tap(y0i, x0i), tap(y0i, x0i + 1)
    i10, i11 = tap(y0i + 1, x0i), tap(y0i + 1, x0i + 1)
    tile = ((i00 * (1 - fx) + i01 * fx) * (1 - fy)
            + (i10 * (1 - fx) + i11 * fx) * fy)
    tile = torch.where(inb, tile, 0.0)                      # constant border

    desc = tile.reshape(*tile.shape[:2], -1)
    mean = desc.mean(dim=-1, keepdim=True)
    std = desc.std(dim=-1, keepdim=True, unbiased=False)
    return (desc - mean) / (std + 1e-8)


def pack_candidates(vals: torch.Tensor, rows: torch.Tensor,
                    cols: torch.Tensor, w: int):
    """Candidate readback payload: flat int32 codes (row * w + col, -1 in
    an unfilled slot) and per-image valid counts. The host needs only the
    coordinates for SSC: scores are implicit in the order, orientations
    stay on the device."""
    finite = torch.isfinite(vals)
    codes = torch.where(finite, rows * w + cols, -1).to(torch.int32)
    return codes, finite.sum(dim=1).to(torch.int32)


def level_descriptors(blurred, rows, cols, theta, idx, kcounts, scale):
    """Gather the SSC-selected candidates (``idx`` (B, K) into the
    candidate arrays, ``kcounts`` (B,) of them valid) on the device and
    describe them: -> (kp (B, K, 2) full-resolution (x, y), desc (B, K,
    64), valid (B, K))."""
    r = rows.gather(1, idx)
    c = cols.gather(1, idx)
    t = theta.gather(1, idx)
    desc = oriented_descriptors(blurred, r, c, t)
    kp = torch.stack([c.to(torch.float32) * scale,
                      r.to(torch.float32) * scale], dim=-1)
    valid = (torch.arange(idx.shape[1], device=idx.device)[None, :]
             < kcounts[:, None])
    return kp, desc, valid


def msop_extract_device(stack_u8: torch.Tensor,
                        max_feat: Sequence[int] = MAX_FEAT, stats=None):
    """Device-resident MSOP extraction of a same-shape (N, H, W, 3) uint8
    BGR stack (already on its device).

    Every level's candidate pass is enqueued before the one host pull
    (codes and counts of all levels in one packed int32 array); SSC runs
    on the host coordinates; the selected candidates are gathered and
    described on the device.

    Returns ``(kpts_host, kp_dev (N, C, 2), ds_dev (N, C, 64), va_dev
    (N, C), counts (N,) int32)``: ``kpts_host`` is the per-image
    full-resolution (x, y) float32 list, level-major in SSC order, the
    order the device buffers hold their valid rows in, so match indices
    index it directly after valid-first compaction. With no keypoint at
    all the buffers are (N, 64, ...) zeros.

    ``stats``: an optional dict to which ``candidates`` and ``keypoints``
    (per level, summed over images) and ``ssc_seconds`` are added, and
    whose ``level_caps`` (each level's rows in the buffers, 0 for a level
    without keypoints) is raised to this call's."""
    n = stack_u8.shape[0]
    dev = stack_u8.device
    cur = msop_gray(stack_u8)
    levels, packs, counts_l = [], [], []
    for maxf in max_feat:
        vals, rows, cols, theta, blurred, nxt = msop_level(cur, maxf * 20)
        codes, cnt = pack_candidates(vals, rows, cols, cur.shape[2])
        levels.append((rows, cols, theta, blurred, tuple(cur.shape[1:])))
        packs.append(codes)
        counts_l.append(cnt)
        cur = nxt
    packed = torch.cat(packs + [torch.stack(counts_l, dim=1)],
                       dim=1).cpu().numpy()
    counts_np = packed[:, -len(max_feat):]

    kp_parts, ds_parts, va_parts = [], [], []
    kpts_host: List[list] = [[] for _ in range(n)]
    total = np.zeros(n, np.int32)
    off = 0
    ssc_s = 0.0
    n_kept, level_caps = [], []
    for lvl, (maxf, (rows_d, cols_d, theta_d, blurred, hw)) in \
            enumerate(zip(max_feat, levels)):
        h, w = hw
        cap_l = packs[lvl].shape[1]
        codes = packed[:, off:off + cap_l]
        off += cap_l
        scale = 2.0 ** lvl
        sels = []
        for i in range(n):
            cs = codes[i, :int(counts_np[i, lvl])]
            cc = (cs % w).astype(np.float32)
            rr = (cs // w).astype(np.float32)
            t0 = time.perf_counter()
            sel = ssc(np.stack([cc, rr], axis=1), (w, h), maxf)
            ssc_s += time.perf_counter() - t0
            sels.append(np.asarray(sel, np.int32))
            kpts_host[i].append(np.stack(
                [cc[sel] * scale, rr[sel] * scale], axis=1
            ).astype(np.float32))
        n_kept.append(int(sum(len(s) for s in sels)))
        top = max((len(s) for s in sels), default=0)
        level_caps.append(0 if top == 0
                          else max(64, 1 << (top - 1).bit_length()))
        if top == 0:
            continue
        capd = level_caps[-1]
        idx_b = np.zeros((n, capd), np.int64)
        kcnt = np.zeros(n, np.int32)
        for i in range(n):
            idx_b[i, :len(sels[i])] = sels[i]
            kcnt[i] = len(sels[i])
        kp, desc, valid = level_descriptors(
            blurred, rows_d, cols_d, theta_d,
            torch.as_tensor(idx_b, device=dev),
            torch.as_tensor(kcnt, device=dev), scale)
        kp_parts.append(kp)
        ds_parts.append(desc)
        va_parts.append(valid)
        total += kcnt

    if stats is not None:
        for key, new in (("candidates", counts_np.sum(axis=0)),
                         ("keypoints", n_kept)):
            old = stats.get(key, [0] * len(max_feat))
            stats[key] = [int(a) + int(b) for a, b in zip(old, new)]
        stats["ssc_seconds"] = stats.get("ssc_seconds", 0.0) + ssc_s
        stats["level_caps"] = [max(a, b) for a, b in zip(
            stats.get("level_caps", level_caps), level_caps)]
    kpts_out = [np.concatenate(k) if k else np.zeros((0, 2), np.float32)
                for k in kpts_host]
    if not kp_parts:
        return (kpts_out, torch.zeros((n, 64, 2), device=dev),
                torch.zeros((n, 64, DSIZE * DSIZE), device=dev),
                torch.zeros((n, 64), dtype=torch.bool, device=dev), total)
    return (kpts_out, torch.cat(kp_parts, dim=1), torch.cat(ds_parts, dim=1),
            torch.cat(va_parts, dim=1), total)


__all__ = ["DSIZE", "MAX_FEAT", "MsopFeatures", "ssc", "msop_gray", "top_candidates",
           "msop_level", "oriented_descriptors", "pack_candidates",
           "level_descriptors", "msop_extract_device"]
