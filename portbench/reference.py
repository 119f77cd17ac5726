"""The plain reference that decides ``correct``: what each output of the
timed path must say about the world it was made from.

The worlds are the benchmark's own (``world.py``), so their geometry is
known: every view's true rotation and focal, and the texture the views
were rendered from. The reference works out from that alone, in plain
numpy and torch, what the program's outputs should be, and the program's
outputs are read only to be judged:

- the match graph (the features and matching): every pair of views that
  truly overlaps by at least ``STRONG_OVERLAP`` of a view is an edge, and
  each edge's homography maps the points of the true overlap where the
  true homography K R_j R_i^T K^-1 maps them;
- the registration: every view placed, and each adjacent pair's relative
  rotation and each focal as the truth has them (adjacent: a sweep's
  index neighbours, a rig's strongly overlapping pairs);
- the render: every covered pixel of the mosaic shows what the views
  show along the ray that the mosaic's spherical frame gives it, under
  the registered cameras (the views' mean, each divided by its true
  exposure; one global gain is fitted where the views carry exposure
  factors). The frame follows the registered cameras (the CLI's
  documented layout: the middle view's angular resolution, capped at
  ``max_resolution`` px, spanning every view's border). So the render is
  judged on its own, the registration by the cameras' numbers.

``judge`` computes the numbers of one panorama; ``control`` computes the
same numbers with the reference's own answers, worked out in bfloat16,
put in the program's place. Imports no module of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.world import World

STRONG_OVERLAP = 0.3        # share of a view's pixels seen by the other
COVER_MARGIN = 8            # view pixels kept clear of a view's border
GRID = 24                   # points per side of a view's sample grid


def intrinsics(focal: float) -> np.ndarray:
    return np.diag([focal, focal, 1.0])


def true_homography(rots: np.ndarray, focal: float, i: int, j: int,
                    dtype=np.float64) -> np.ndarray:
    """Centre-relative pixels of view i -> view j: K R_j R_i^T K^-1."""
    if dtype is np.float64:
        k = intrinsics(focal)
        return k @ rots[j] @ rots[i].T @ np.linalg.inv(k)
    t = torch.tensor
    k = t(intrinsics(focal), dtype=torch.bfloat16)
    kinv = t(np.linalg.inv(intrinsics(focal)), dtype=torch.bfloat16)
    ri = t(rots[i], dtype=torch.bfloat16)
    rj = t(rots[j], dtype=torch.bfloat16)
    return (k @ rj @ ri.T @ kinv).double().numpy()


def _grid(shape: Sequence[int], n: int = GRID) -> np.ndarray:
    """(n*n, 3) centre-relative homogeneous points over a view."""
    h, w = shape
    ys, xs = np.meshgrid(np.linspace(-h / 2, h / 2, n),
                         np.linspace(-w / 2, w / 2, n), indexing="ij")
    return np.stack([xs.ravel(), ys.ravel(), np.ones(n * n)], axis=1)


def _apply(hom: np.ndarray, pts: np.ndarray) -> np.ndarray:
    q = pts @ hom.T
    return q[:, :2] / q[:, 2:3]


def overlap_points(world: World, i: int, j: int) -> np.ndarray:
    """Grid points of view i whose true image lies inside view j, in
    front of it."""
    h, w = world.views[0].shape[:2]
    pts = _grid((h, w))
    hom = true_homography(world.rots, world.focal, i, j)
    q = pts @ hom.T
    front = q[:, 2] > 0
    xy = q[:, :2] / np.where(front, q[:, 2], 1.0)[:, None]
    inside = front & (np.abs(xy[:, 0]) <= w / 2) & (np.abs(xy[:, 1]) <= h / 2)
    return pts[inside]


def strong_pairs(world: World) -> List[Tuple[int, int, np.ndarray]]:
    """(i, j, overlap points) of every pair i < j that truly overlaps by at
    least ``STRONG_OVERLAP`` of a view's grid."""
    out = []
    n = len(world.views)
    for i in range(n):
        for j in range(i + 1, n):
            pts = overlap_points(world, i, j)
            if len(pts) >= STRONG_OVERLAP * GRID * GRID:
                out.append((i, j, pts))
    return out


def _rot_deg(a: np.ndarray) -> float:
    """The angle of the rotation ``a`` in degrees, from its distance to the
    identity (2 sin(t/2) sqrt(2) for a rotation by t): well conditioned
    near 0, where arccos of the trace is not."""
    d = np.linalg.norm(a - np.eye(3)) / (2 * np.sqrt(2))
    return float(np.degrees(2 * np.arcsin(min(d, 1.0))))


def _pair_err(hom: np.ndarray, truth: np.ndarray, pts: np.ndarray):
    """(largest, root mean square) distance between two homographies'
    images of ``pts``."""
    d = np.hypot(*(_apply(hom, pts) - _apply(truth, pts)).T)
    return float(np.max(d)), float(np.sqrt(np.mean(d * d)))


# ---------------------------------------------------------------------------
# The mosaic's frame
# ---------------------------------------------------------------------------

def _sph(pts: np.ndarray) -> np.ndarray:
    return np.stack([np.arctan2(pts[..., 0], pts[..., 2]),
                     np.arctan2(pts[..., 1], np.hypot(pts[..., 0],
                                                      pts[..., 2]))], -1)


def _border(shape: Sequence[int], nel: int = 100) -> np.ndarray:
    h, w = float(shape[0]), float(shape[1])
    frac = np.linspace(0.0, 1.0, nel)
    z, o = np.zeros(nel), np.ones(nel)
    b = np.concatenate([np.stack([z, frac * h, o], 1),
                        np.stack([np.full(nel, w), frac * h, o], 1),
                        np.stack([frac * w, z, o], 1),
                        np.stack([frac * w, np.full(nel, h), o], 1)])
    return b - np.array([w / 2, h / 2, 0.0])


def mosaic_frame(cams: List[Tuple[np.ndarray, np.ndarray]],
                 shape: Sequence[int], max_resolution: int):
    """The spherical frame of a mosaic of views ``shape`` (H, W) under the
    registered cameras ``cams`` [(rot, intr)] in placed order: -> (rad/px
    (2,), the frame's lowest (azimuth, height) angle (2,), (H, W) of the
    uncropped mosaic). The resolution is the middle view's angular extent
    over its pixels, scaled down so the longer side fits
    ``max_resolution``; the frame spans every view's border."""
    h, w = shape
    homs = [rot.T @ np.linalg.inv(intr) for rot, intr in cams]
    b = _border(shape)
    ranges = np.stack([_sph(b @ hm.T) for hm in homs])       # (N, 4nel, 2)
    rmin = ranges.min(axis=(0, 1))
    rmax = ranges.max(axis=(0, 1))
    mid = homs[len(homs) // 2]
    corners = np.array([[-w / 2, -h / 2, 1], [w / 2, -h / 2, 1],
                        [-w / 2, h / 2, 1], [w / 2, h / 2, 1]])
    c = _sph(corners @ mid.T)
    xmin, xmax = min(c[0, 0], c[2, 0]), max(c[1, 0], c[3, 0])
    ymin, ymax = min(c[0, 1], c[1, 1]), max(c[2, 1], c[3, 1])
    if xmin > xmax:
        xmax += 2 * np.pi
    if ymin > ymax:
        ymax += np.pi
    res = np.array([xmax - xmin, ymax - ymin]) / np.array([w, h])
    size = rmax - rmin
    side = np.max(size / res)
    if side > max_resolution:
        res = res * side / max_resolution
    out = tuple(int(t) for t in np.round(size / res))[::-1]
    return res, rmin, out


def mosaic_rays(res, rmin, out_hw, device, dtype) -> torch.Tensor:
    """(H, W, 3) rays of the mosaic's pixels in the registered frame."""
    h, w = out_hw
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=dtype),
                            torch.arange(w, device=device, dtype=dtype),
                            indexing="ij")
    az = xs * torch.tensor(res[0], dtype=dtype) + torch.tensor(rmin[0],
                                                               dtype=dtype)
    el = ys * torch.tensor(res[1], dtype=dtype) + torch.tensor(rmin[1],
                                                               dtype=dtype)
    return torch.stack([torch.sin(az), torch.tan(el), torch.cos(az)], -1)


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear samples of ``img`` (H, W, C) at (x, y), inside the image."""
    h, w = img.shape[:2]
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = (x - x0.to(x.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]
    top = img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx
    bot = img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def expected_mosaic(world: World, cams, placed: Sequence[int],
                    max_resolution: int, dtype=torch.float64):
    """The reference's mosaic under the registered cameras: -> (float BGR
    in [0, 1] (H, W, 3), covered (H, W) bool), computed in ``dtype`` on
    the texture's device. Each pixel is the mean of the views that see
    it, each sampled where its camera puts the pixel's ray and divided by
    its true exposure; covered are the pixels that some view sees
    ``COVER_MARGIN`` px inside its border."""
    dev = world.texture.device
    h, w = world.views[0].shape[:2]
    res, rmin, out_hw = mosaic_frame(cams, (h, w), max_resolution)
    # a few columns and rows more: a side rounded the other way still fits
    out_hw = (out_hw[0] + 4, out_hw[1] + 4)
    rays = mosaic_rays(res, rmin, out_hw, dev, dtype)
    acc = torch.zeros(out_hw + (3,), dtype=dtype, device=dev)
    count = torch.zeros(out_hw, dtype=dtype, device=dev)
    covered = torch.zeros(out_hw, dtype=torch.bool, device=dev)
    m = COVER_MARGIN
    for k, (rot, intr) in zip(placed, cams):
        p = rays @ torch.as_tensor(intr @ rot, dtype=dtype, device=dev).T
        z = p[..., 2]
        x = p[..., 0] / z + w / 2
        y = p[..., 1] / z + h / 2
        seen = (z > 0) & (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
        covered |= seen & (x >= m) & (x <= w - 1 - m) & (y >= m) & \
            (y <= h - 1 - m)
        view = torch.as_tensor(world.views[k], device=dev).to(dtype) / 255
        if world.exposure is not None:
            view = view / float(world.exposure[k])
        got = _bilinear(view, torch.where(seen, x, 0), torch.where(seen, y, 0))
        acc += torch.where(seen[..., None], got, 0)
        count += seen.to(dtype)
    img = acc / torch.clamp(count, min=1)[..., None]
    return img.double(), covered


def _locate(mosaic: torch.Tensor, ref: torch.Tensor) -> Tuple[int, int]:
    """Integer offset (dy, dx) of a (cropped) mosaic inside the reference
    canvas: the peak of their cross-correlation in gray, by FFT."""
    hm, wm = mosaic.shape[:2]
    hr, wr = ref.shape[:2]
    a = ref.mean(-1)
    b = torch.zeros_like(a)
    m = mosaic.mean(-1)
    b[:hm, :wm] = m - m.mean()
    a = a - a.mean()
    fa, fb = torch.fft.rfft2(a), torch.fft.rfft2(b)
    corr = torch.fft.irfft2(fa * torch.conj(fb), s=a.shape)
    valid = corr[:hr - hm + 1, :wr - wm + 1]
    k = int(torch.argmax(valid))
    return divmod(k, valid.shape[1])


def mosaic_error(mosaic: np.ndarray, ref: torch.Tensor,
                 covered: torch.Tensor, fit_gain: bool) -> float:
    """Mean absolute difference, in gray levels of 255, over the covered
    pixels of ``mosaic`` (uint8 or float BGR in [0, 255]) against ``ref``
    (float BGR in [0, 1]); a cropped mosaic is located in the canvas
    first. ``fit_gain``: one global gain (the median ratio) first."""
    m = torch.as_tensor(np.ascontiguousarray(mosaic), device=ref.device
                        ).double()
    if m.ndim != 3 or m.shape[0] > ref.shape[0] or m.shape[1] > ref.shape[1]:
        return math.inf
    dy, dx = _locate(m, ref * 255)
    r = ref[dy:dy + m.shape[0], dx:dx + m.shape[1]] * 255
    cov = covered[dy:dy + m.shape[0], dx:dx + m.shape[1]]
    if int(cov.sum()) == 0:
        return math.inf
    if fit_gain:
        bright = cov & (r.mean(-1) > 25)
        gain = torch.median(m[bright].mean(-1) / r[bright].mean(-1))
        r = torch.clamp(r * gain, 0, 255)
    return float((m - r).abs().mean(-1)[cov].mean())


# ---------------------------------------------------------------------------
# The numbers
# ---------------------------------------------------------------------------

def judge(world: World, kpts, matches: dict,
          cams: Dict[int, Tuple[np.ndarray, np.ndarray]],
          mosaic: Optional[np.ndarray], max_resolution: int,
          mosaic_dtype=torch.float64) -> Dict[str, float]:
    """The numbers of one panorama: ``matches[i][j] = (idx, hom)`` (the
    match graph, hom mapping view i's centre-relative pixels to view
    j's), ``cams[k] = (rot, intr)`` (the registered views by index),
    ``mosaic`` (uint8 BGR, or None when the program gave none).

    - ``views_unplaced``: views the registration left out;
    - ``edges_missing``: strongly overlapping pairs with no edge;
    - ``hom_err_px``: over those edges, the largest distance between the
      edge's and the true homography's image of a point of the overlap;
      ``hom_rms_px``: the mean over the edges of that distance's root
      mean square;
    - ``rot_err_deg``: the mean error of adjacent views' relative
      rotations; ``cam_err_px``: the mean over adjacent views of the root
      mean square distance, over their true overlap, between the images
      under the homography their cameras induce and the true one.
      Adjacent are a sweep's index neighbours k, k + 1 and a rig's
      strongly overlapping pairs (each ring's closing pair and the
      neighbours across rings among them). ``cam_worst_px``: the largest
      of those root mean squares (a rig's mean runs over some fifty
      pairs, of which one view may hold two);
      ``focal_err``: the largest relative focal error;
    - ``mosaic_err``: the mosaic's mean absolute difference from the
      reference's, in gray levels.
    """
    n = len(world.views)
    out = {"views_unplaced": float(n - len(cams))}
    missing, hmax, hrms = 0, 0.0, []
    pairs = strong_pairs(world)
    for i, j, pts in pairs:
        edge = matches.get(i, {}).get(j)
        if edge is None:
            missing += 1
            continue
        worst, rms = _pair_err(np.asarray(edge[1], np.float64),
                               true_homography(world.rots, world.focal, i, j),
                               pts)
        hmax = max(hmax, worst)
        hrms.append(rms)
    out["edges_missing"] = float(missing)
    out["hom_err_px"] = hmax
    out["hom_rms_px"] = float(np.mean(hrms)) if hrms else 0.0
    adjacent = pairs if world.rig else [
        (k, k + 1, overlap_points(world, k, k + 1)) for k in range(n - 1)]
    rel, cam = [], []
    for i, j, pts in adjacent:
        if i not in cams or j not in cams:
            continue
        (ra, ka), (rb, kb) = cams[i], cams[j]
        rel.append(_rot_deg((rb @ ra.T)
                            @ (world.rots[j] @ world.rots[i].T).T))
        if len(pts):
            cam.append(_pair_err(kb @ rb @ ra.T @ np.linalg.inv(ka),
                                 true_homography(world.rots, world.focal,
                                                 i, j), pts)[1])
    out["rot_err_deg"] = float(np.mean(rel)) if rel else math.inf
    out["cam_err_px"] = float(np.mean(cam)) if cam else math.inf
    out["cam_worst_px"] = float(np.max(cam)) if cam else math.inf
    foc = [abs(intr[0, 0] - world.focal) / world.focal
           for _, intr in cams.values()]
    out["focal_err"] = float(max(foc)) if foc else math.inf
    if mosaic is None or len(cams) < 2:
        out["mosaic_err"] = math.inf
        return out
    placed = sorted(cams)
    ref, covered = expected_mosaic(world, [cams[k] for k in placed], placed,
                                   max_resolution, mosaic_dtype)
    out["mosaic_err"] = mosaic_error(mosaic, ref, covered,
                                     world.exposure is not None)
    return out


def control(world: World, max_resolution: int) -> Dict[str, float]:
    """``judge``'s numbers with the reference's own answers worked out in
    bfloat16 put in the program's place: the true homographies and
    cameras rounded through bfloat16, and the mosaic rendered in
    bfloat16 under those cameras."""
    bf = torch.bfloat16
    n = len(world.views)
    matches: dict = {i: {} for i in range(n)}
    for i, j, _ in strong_pairs(world):
        matches[i][j] = (None, true_homography(world.rots, world.focal, i, j,
                                               dtype=bf))

    def rnd(a):
        return torch.tensor(a, dtype=bf).double().numpy()
    cams = {k: (rnd(world.rots[k]), rnd(intrinsics(world.focal)))
            for k in range(n)}
    placed = list(range(n))
    img, _ = expected_mosaic(world, [cams[k] for k in placed], placed,
                             max_resolution, bf)
    mosaic = (img * 255).clamp(0, 255).cpu().numpy()
    return judge(world, None, matches, cams, mosaic, max_resolution)


__all__ = ["judge", "control", "true_homography", "strong_pairs",
           "mosaic_frame", "expected_mosaic", "mosaic_error"]
