"""Batched SIFT extraction (counterpart of ``pano360_tpu.features.sift``).

The configuration of the JAX package, on PyTorch tensors: the base
upscaled 2x (or not, ``upscale=False``), the incremental Gaussian chain
(one fused CUDA pass per octave through ``ops.gauss_octave.octave_stack``
wherever the single reflect101 extension is legal), exact top-k DoG
candidates, the dense Newton-step field and per-candidate refinement,
the refined-contrast compaction (``sel_shift``), 36-bin orientation with
up to two peaks, the descriptor (``descr_mode``: the rotated 16x16
``grid``, or ``dense``, cv2's integer window) and a global
top-``max_kpts``. Keypoint buffers have a fixed capacity with a validity
mask. The refinement, the orientation and the grid descriptor run
through ``ops.sift_tail``: a CUDA kernel each on a card (the refinement's
computes each Newton step where a candidate visits it, so the dense
field is made only on the CPU), the plain versions here on the CPU. On
the CPU the keypoint stage runs in chunks (2048 keypoints for ``grid``,
256 for ``dense``, which bins 25x the samples) to bound its transients;
on a card the two kernels take a batch's keypoints at once (the dense
descriptor keeps its chunks).
The orientation's and the grid descriptor's sums run in one fixed order
(``geometry.tree_sum``), so a keypoint's result does not depend on its
chunk and the kernels repeat it bit for bit.

The fused octave op and the per-layer chain (the JAX package's CPU
path, kept here for the octaves too small to reflect-pad) compute the
same stacks to f32 rounding: blurring a reflect101 extension with a
symmetric kernel preserves the reflection. The base image and the
small octaves' chain, DoG and score run through ``ops.sift_front``: a
CUDA kernel each on a card, the plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
import os
from functools import partial
from typing import List, NamedTuple, Optional, Tuple

import torch

from pano360_tpu_torch.geometry import det3x3, inv3x3, tree_sum
from pano360_tpu_torch.ops import gauss_octave, sift_front, sift_tail
from pano360_tpu_torch.ops.filters import blur_bhw, cv2_sift_ksize

DESCR_MODES = ("grid", "dense")
# keypoint-stage chunk per descriptor mode (the JAX package's lax.map
# chunks): dense bins (2 * 40)^2 = 6400 samples per keypoint and
# orientation, 25x the grid's 256
KP_CHUNK = {"grid": 2048, "dense": 256}


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    n_layers: int = 3
    sigma: float = 1.6
    init_sigma: float = 0.5
    contrast_thresh: float = 0.04
    edge_thresh: float = 10.0
    max_kpts: int = 4096
    img_border: int = 5
    refine_iters: int = 5
    n_orientations: int = 2
    ori_bins: int = 36
    descr_width: int = 4
    descr_ori_bins: int = 8
    descr_samples: int = 16
    descr_mag_thresh: float = 0.2
    sel_shift: int = 2
    upscale: bool = True            # cv2 firstOctave = -1
    # the JAX package's default comes from the same variable (its CLI
    # reaches the dense descriptor through it)
    descr_mode: str = dataclasses.field(
        default_factory=lambda: os.environ.get("PANO_SIFT_DESCR", "grid"))

    def __post_init__(self):
        if self.descr_mode not in DESCR_MODES:
            raise ValueError(f"descr_mode {self.descr_mode!r}: expected one "
                             f"of {DESCR_MODES}")

    @property
    def patch_half(self) -> int:
        """Half-extent of the per-keypoint patch: 32 for ``grid`` (its
        farthest gradient read is 30.07 px from the keypoint), 40 for
        ``dense`` (cv2's window reaches 38.1 px from the rounded centre
        at the largest octave-relative sigma; pano360_tpu's derivation)."""
        return 32 if self.descr_mode == "grid" else 40

    @property
    def dim(self) -> int:
        return self.descr_width * self.descr_width * self.descr_ori_bins


class SiftFeatures(NamedTuple):
    """Fixed-capacity keypoint set for a batch of images."""

    xy: torch.Tensor        # (N, K, 2) f32, original-image pixels
    size: torch.Tensor      # (N, K) keypoint diameter
    angle: torch.Tensor     # (N, K) radians
    response: torch.Tensor  # (N, K) |contrast|
    desc: torch.Tensor      # (N, K, 128) f32
    valid: torch.Tensor     # (N, K) bool


def n_octaves_for(shape: Tuple[int, int], upscale: bool = True) -> int:
    """cv2: round(log2(min(H, W))) - 2, plus one with the 2x upscaled
    base."""
    side = min(shape) * (2 if upscale else 1)
    return max(int(round(math.log2(side))) - 2, 1)


def _base_image(gray: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """The upscaled (``cfg.upscale``) and blurred base: a CUDA kernel on
    a card (``ops.sift_front.base_image``)."""
    return sift_front.base_image(gray.contiguous(), cfg)


def _gaussian_stack(base: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """The per-layer chain: (N, H, W) -> (N, S+3, H, W)."""
    s = cfg.n_layers
    k = 2.0 ** (1.0 / s)
    sigs = [cfg.sigma * (k ** i) for i in range(s + 3)]
    imgs = [base]
    for i in range(1, s + 3):
        delta = math.sqrt(sigs[i] ** 2 - sigs[i - 1] ** 2)
        imgs.append(blur_bhw(imgs[-1], delta, cv2_sift_ksize(delta)))
    return torch.stack(imgs, dim=1)


def _gauss_and_dog(base: torch.Tensor, cfg: SiftConfig, taps, score_cfg):
    """One octave's (Gaussian stack, DoG stack, extrema score): the
    octave kernel where its single reflect101 extension is legal, else
    the per-layer chain (``ops.sift_front.small_octave``)."""
    h, w = base.shape[1:]
    if gauss_octave.reflect_legal(h, w, taps):
        return gauss_octave.octave_stack(base.contiguous(), taps, score_cfg)
    return sift_front.small_octave(base.contiguous(), cfg)


def _octave_candidates(dog: torch.Tensor, cfg: SiftConfig, cap: int,
                       score=None):
    """Top-``cap`` extrema per image -> (layer, y, x, score > 0). Without
    ``score`` (a caller's own DoG stack) the dense score is made here."""
    n, nl, h, w = dog.shape
    s = cfg.n_layers
    if score is None:
        score = gauss_octave._extrema_score(
            dog, 0.5 * cfg.contrast_thresh / s, cfg.edge_thresh,
            cfg.img_border)
    flat = score.reshape(n, s * h * w)
    top, idx = torch.topk(flat, min(cap, s * h * w), dim=1)
    layer = idx // (h * w) + 1
    rem = idx % (h * w)
    return layer, rem // w, rem % w, top > 0


def _newton_step_field(dog: torch.Tensor) -> torch.Tensor:
    """Packed dense Newton step per interior DoG pixel, layers 1..S:
    bit 0 converged, bits 1-2 / 3-4 / 5-6 = step_x/y/l + 1."""
    cm, cl, cu = dog[:, 1:-1], dog[:, :-2], dog[:, 2:]

    def shx(a, d):
        return torch.roll(a, -d, dims=-1)

    def shy(a, d):
        return torch.roll(a, -d, dims=-2)

    dx = (shx(cm, 1) - shx(cm, -1)) * 0.5
    dy = (shy(cm, 1) - shy(cm, -1)) * 0.5
    ds = (cu - cl) * 0.5
    dxx = shx(cm, 1) - 2 * cm + shx(cm, -1)
    dyy = shy(cm, 1) - 2 * cm + shy(cm, -1)
    dss = cu - 2 * cm + cl
    dxy = (shy(shx(cm, 1), 1) - shy(shx(cm, -1), 1)
           - shy(shx(cm, 1), -1) + shy(shx(cm, -1), -1)) * 0.25
    dxs = (shx(cu, 1) - shx(cu, -1) - shx(cl, 1) + shx(cl, -1)) * 0.25
    dys = (shy(cu, 1) - shy(cu, -1) - shy(cl, 1) + shy(cl, -1)) * 0.25

    det0 = (dxx * (dyy * dss - dys * dys)
            - dxy * (dxy * dss - dys * dxs)
            + dxs * (dxy * dys - dyy * dxs))
    a, e, i = dxx + 1e-12, dyy + 1e-12, dss + 1e-12
    b, c, f = dxy, dxs, dys
    co00, co01, co02 = e * i - f * f, c * f - b * i, b * f - c * e
    co10, co11, co12 = f * c - b * i, a * i - c * c, c * b - a * f
    co20, co21, co22 = b * f - e * c, b * c - a * f, a * e - b * b
    det = a * co00 + b * co01 + c * co02
    solve = torch.abs(det0) > 1e-20
    zero = torch.zeros_like(det)
    ox = torch.where(solve, -(co00 * dx + co01 * dy + co02 * ds) / det, zero)
    oy = torch.where(solve, -(co10 * dx + co11 * dy + co12 * ds) / det, zero)
    ol = torch.where(solve, -(co20 * dx + co21 * dy + co22 * ds) / det, zero)
    conv = (torch.abs(ox) < 0.5) & (torch.abs(oy) < 0.5) & \
        (torch.abs(ol) < 0.5)

    def step(o):
        return torch.clamp(torch.round(o), -1, 1).to(torch.int32) + 1

    return (conv.to(torch.int32) | (step(ox) << 1) | (step(oy) << 3)
            | (step(ol) << 5))


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row gather along dim 1 of (N, M, ...) with (N, K) indices."""
    shape = idx.shape + a.shape[2:]
    flat = idx.reshape(idx.shape + (1,) * (a.ndim - 2)).expand(shape)
    return torch.gather(a, 1, flat)


def _refine(dog, field, l0, y0, x0, cfg: SiftConfig):
    """Newton refinement of (N, C) candidates: integer re-centering by
    the packed step field, then the cube at the final position for the
    subpixel offsets and the contrast / edge tests."""
    n, nl, h, w = dog.shape
    s, b = cfg.n_layers, cfg.img_border
    flat = field.reshape(n, -1)
    l, y, x = l0, y0, x0
    conv = torch.zeros_like(l, dtype=torch.bool)
    for _ in range(cfg.refine_iters):
        word = torch.gather(flat, 1, (l - 1) * (h * w) + y * w + x)
        conv = (word & 1) > 0
        nx = torch.clamp(x + ((word >> 1) & 3) - 1, b, w - 1 - b)
        ny = torch.clamp(y + ((word >> 3) & 3) - 1, b, h - 1 - b)
        nl_ = torch.clamp(l + ((word >> 5) & 3) - 1, 1, s)
        l = torch.where(conv, l, nl_)
        y = torch.where(conv, y, ny)
        x = torch.where(conv, x, nx)

    dl = torch.arange(-1, 2, device=dog.device)
    cube_idx = ((l[..., None, None, None] + dl[:, None, None]) * (h * w)
                + (y[..., None, None, None] + dl[None, :, None]) * w
                + (x[..., None, None, None] + dl[None, None, :]))
    # only invalid (zero-score) slots can reach past the planes; their
    # values are discarded, so a clamp keeps the gather in bounds
    cube_idx = cube_idx.reshape(n, -1).clamp(0, nl * h * w - 1)
    c = torch.gather(dog.reshape(n, -1), 1, cube_idx).reshape(
        l.shape + (3, 3, 3))

    def cc(i, j, k):
        return c[..., i, j, k]

    dd = torch.stack([(cc(1, 1, 2) - cc(1, 1, 0)) * 0.5,
                      (cc(1, 2, 1) - cc(1, 0, 1)) * 0.5,
                      (cc(2, 1, 1) - cc(0, 1, 1)) * 0.5], dim=-1)
    dxx = cc(1, 1, 2) - 2 * cc(1, 1, 1) + cc(1, 1, 0)
    dyy = cc(1, 2, 1) - 2 * cc(1, 1, 1) + cc(1, 0, 1)
    dss = cc(2, 1, 1) - 2 * cc(1, 1, 1) + cc(0, 1, 1)
    dxy = (cc(1, 2, 2) - cc(1, 2, 0) - cc(1, 0, 2) + cc(1, 0, 0)) * 0.25
    dxs = (cc(2, 1, 2) - cc(2, 1, 0) - cc(0, 1, 2) + cc(0, 1, 0)) * 0.25
    dys = (cc(2, 2, 1) - cc(2, 0, 1) - cc(0, 2, 1) + cc(0, 0, 1)) * 0.25
    hess = torch.stack([torch.stack([dxx, dxy, dxs], -1),
                        torch.stack([dxy, dyy, dys], -1),
                        torch.stack([dxs, dys, dss], -1)], -2)
    det = det3x3(hess)
    eye = torch.eye(3, dtype=dog.dtype, device=dog.device)
    inv = inv3x3(hess + 1e-12 * eye)
    sol = -(inv[..., 0] * dd[..., 0:1] + inv[..., 1] * dd[..., 1:2]
            + inv[..., 2] * dd[..., 2:3])
    offs = torch.where((conv & (torch.abs(det) > 1e-20))[..., None], sol,
                       torch.zeros_like(sol))
    contrast = cc(1, 1, 1) + 0.5 * (dd[..., 0] * offs[..., 0]
                                    + dd[..., 1] * offs[..., 1]
                                    + dd[..., 2] * offs[..., 2])
    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    r = cfg.edge_thresh
    edge_ok = (det2 > 0) & (tr * tr * r < (r + 1) ** 2 * det2)
    contrast_ok = torch.abs(contrast) * s >= cfg.contrast_thresh
    return l, y, x, offs, contrast, conv & edge_ok & contrast_ok


def _extract_patches(gauss, l, y, x, ps_y: int, ps_x: int):
    """(ps_y, ps_x) patch of layer ``l`` around each (y, x), clipped
    inside the image per dimension. Returns (patches, corner_y, corner_x)."""
    n, nl, h, w = gauss.shape
    cy = torch.clamp(y - ps_y // 2, 0, max(h - ps_y, 0))
    cx = torch.clamp(x - ps_x // 2, 0, max(w - ps_x, 0))
    ry = torch.arange(ps_y, device=gauss.device)
    rx = torch.arange(ps_x, device=gauss.device)
    idx = ((l * (h * w) + cy * w + cx)[..., None, None]
           + ry[:, None] * w + rx[None, :])
    k = l.shape[1]
    patches = torch.gather(gauss.reshape(n, -1), 1,
                           idx.reshape(n, -1)).reshape(n, k, ps_y, ps_x)
    return patches, cy, cx


def _orientation_samples(gx, gy, y, x, cy, cx, sig, oh, ow,
                         cfg: SiftConfig):
    """The orientation histogram's samples of (K, psg, psg) patch
    gradients: (K, psg^2) weighted magnitudes (zero outside the window
    of radius round(4.5 sigma) and the image; Gaussian weights of sigma
    1.5 sigma) and their bins by rounded angle."""
    k, psg, _ = gx.shape
    ar = torch.arange(psg, device=gx.device)
    ay = cy[:, None, None] + 1 + ar[None, :, None]
    ax = cx[:, None, None] + 1 + ar[None, None, :]
    dyc = (ay - y[:, None, None]).to(torch.float32)
    dxc = (ax - x[:, None, None]).to(torch.float32)
    radius = torch.round(4.5 * sig)[:, None, None]
    hh, ww = oh[:, None, None], ow[:, None, None]
    inside = ((torch.abs(dyc) <= radius) & (torch.abs(dxc) <= radius)
              & (ay >= 1) & (ay <= hh - 2) & (ax >= 1) & (ax <= ww - 2))
    mag = torch.sqrt(gx * gx + gy * gy)
    ori = torch.atan2(gy, gx)
    rr = dyc * dyc + dxc * dxc
    s15 = (1.5 * sig)[:, None, None]
    wgt = torch.exp(rr / (-2.0 * (s15 * s15))) * inside
    nb = cfg.ori_bins
    bins = torch.round(ori * (nb / (2 * math.pi))).to(torch.int64) % nb
    return (mag * wgt).reshape(k, -1), bins.reshape(k, -1)


def _orientation_hist(gx, gy, y, x, cy, cx, sig, oh, ow, cfg: SiftConfig):
    """Smoothed 36-bin orientation histograms of (K, psg, psg) patch
    gradients (``_orientation_samples``), cv2's circular smoothing. The
    plain version of ``ops.sift_tail.orientation``'s kernel."""
    val, bins = _orientation_samples(gx, gy, y, x, cy, cx, sig, oh, ow, cfg)
    # each bin sums its samples in one fixed order, the halving tree over
    # the psg^2 samples zero-padded to a power of two, which the kernel
    # repeats (a reduction on the card splits by the shape it is given)
    n = val.shape[1]
    pad = (0, (1 << (n - 1).bit_length()) - n)
    val = torch.nn.functional.pad(val, pad)
    bins = torch.nn.functional.pad(bins, pad, value=-1)
    hist = torch.stack([tree_sum(torch.where(bins == i, val, 0.0), 1)
                        for i in range(cfg.ori_bins)], dim=1)
    hm2, hm1 = torch.roll(hist, 2, -1), torch.roll(hist, 1, -1)
    hp1, hp2 = torch.roll(hist, -1, -1), torch.roll(hist, -2, -1)
    return (hm2 + hp2) * (1 / 16) + (hm1 + hp1) * (4 / 16) + hist * (6 / 16)


def _peak_angles(hist: torch.Tensor, cfg: SiftConfig):
    """Up to ``n_orientations`` interpolated peak angles per histogram:
    (angles (K, n_ori), valid (K, n_ori)). Peaks are taken by value, a
    tie by the lower bin first (a stable sort), so that the kernel
    repeats the choice, also among the non-peaks of an invalid slot."""
    nb = cfg.ori_bins
    hm1, hp1 = torch.roll(hist, 1, -1), torch.roll(hist, -1, -1)
    mx = hist.max(dim=-1, keepdim=True).values
    is_peak = (hist > hm1) & (hist > hp1) & (hist >= 0.8 * mx) & (mx > 0)
    peak_val = torch.where(is_peak, hist, -math.inf)
    vals, idx = torch.sort(peak_val, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :cfg.n_orientations], idx[:, :cfg.n_orientations]
    hm1i, hi, hp1i = (torch.gather(a, 1, idx) for a in (hm1, hist, hp1))
    denom = hm1i - 2 * hi + hp1i
    safe = torch.where(torch.abs(denom) > 1e-12, denom, 1.0)
    interp = torch.where(torch.abs(denom) > 1e-12,
                         0.5 * (hm1i - hp1i) / safe, 0.0)
    bin_pos = torch.remainder(idx + interp, nb)
    return bin_pos * (2 * math.pi / nb), torch.isfinite(vals)


def _grid_positions(xf, yf, sig, angle, gu, gv):
    """Where the grid's samples (gu, gv) (S,), in bins of 3 sigma, lie in
    the octave for keypoints at (xf, yf) turned by ``angle`` (K, n_ori):
    -> (sx, sy) (K, n_ori, S). The angle is counter-clockwise on screen,
    as the gradients' y points up (``gy`` is the row above less the row
    below), so the grid's u axis runs along (cos, -sin) in pixels, whose
    y points down, and its v axis along (sin, cos)."""
    cosa, sina = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    hw_ = (3.0 * sig)[:, None, None]
    sx = xf[:, None, None] + (gu * cosa + gv * sina) * hw_
    sy = yf[:, None, None] + (gv * cosa - gu * sina) * hw_
    return sx, sy


def _descriptor_samples(gx, gy, yf, xf, cy, cx, sig, angle, oh, ow,
                        cfg: SiftConfig):
    """The grid descriptor's samples: rotated 16x16 bilinear samples of
    the patch gradients, weighted. -> (val (K, n_ori, S) weighted
    magnitudes, oh_o (K, n_ori, S, nob) orientation-bin weights, wrc (S,
    d^2) the constant row-times-column weights of the inner spatial
    bins).

    gx/gy: (K, psg, psg) anchored at (cy+1, cx+1); angle: (K, n_ori)."""
    k, psg, _ = gx.shape
    no = angle.shape[1]
    d, p, nob = cfg.descr_width, cfg.descr_samples, cfg.descr_ori_bins
    dev = gx.device
    g = (torch.arange(p, dtype=torch.float32, device=dev) + 0.5) / p * d \
        - d / 2
    gv, gu = torch.meshgrid(g, g, indexing="ij")       # gu varies along x
    gu, gv = gu.reshape(-1), gv.reshape(-1)            # (S,)
    sx, sy = _grid_positions(xf, yf, sig, angle, gu, gv)   # (K, no, S)
    px = sx - (cx[:, None, None] + 1)
    py = sy - (cy[:, None, None] + 1)
    x0f, y0f = torch.floor(px), torch.floor(py)
    fx, fy = px - x0f, py - y0f
    x0 = torch.clamp(x0f, -2, psg + 1).to(torch.int64)
    y0 = torch.clamp(y0f, -2, psg + 1).to(torch.int64)
    xa, xb = x0.clamp(0, psg - 1), (x0 + 1).clamp(0, psg - 1)
    ya, yb = y0.clamp(0, psg - 1), (y0 + 1).clamp(0, psg - 1)

    def sample(pch):
        flat = pch.reshape(k, 1, psg * psg).expand(k, no, psg * psg)

        def at(yy, xx):
            return torch.gather(flat, 2, yy * psg + xx)
        col0 = at(ya, xa) * (1 - fy) + at(yb, xa) * fy
        col1 = at(ya, xb) * (1 - fy) + at(yb, xb) * fy
        return col0 * (1 - fx) + col1 * fx

    sgx, sgy = sample(gx), sample(gy)
    pin = (px >= 0) & (px <= psg - 2) & (py >= 0) & (py <= psg - 2)
    hh, ww = oh[:, None, None], ow[:, None, None]
    inb = pin & (sx >= 1) & (sx <= ww - 2) & (sy >= 1) & (sy <= hh - 2)
    mag = torch.sqrt(sgx * sgx + sgy * sgy)
    ori = torch.remainder(torch.atan2(sgy, sgx) - angle[..., None],
                          2 * math.pi)
    wgt = torch.exp(-(gu * gu + gv * gv) / (2 * (0.5 * d) ** 2)) * inb
    val = mag * wgt                                     # (K, no, S)

    # trilinear binning: the row/col weights depend only on the fixed
    # grid, so they fold into one constant (S, d^2) matrix of the inner
    # bins (cv2's (d+2)^2 frame cropped); the orientation axis (2-entry
    # wrap one-hot) varies per sample
    def axis_w(binc, nbins):
        i0 = torch.floor(binc)
        frac = binc - i0
        i0 = i0.to(torch.int64) + 1
        ii = torch.arange(nbins, device=dev)[None, :]
        a = torch.clamp(i0, 0, nbins - 1)[:, None]
        b = torch.clamp(i0 + 1, 0, nbins - 1)[:, None]
        return ((ii == a) * (1 - frac[:, None]) + (ii == b) * frac[:, None])

    oh_r = axis_w(gv + d / 2 - 0.5, d + 2)             # (S, d+2)
    oh_c = axis_w(gu + d / 2 - 0.5, d + 2)
    wrc = (oh_r[:, :, None] * oh_c[:, None, :])[:, 1:-1, 1:-1]
    wrc = wrc.reshape(p * p, d * d)                    # (S, d^2)
    obin = ori * (nob / (2 * math.pi))
    o0f = torch.floor(obin)
    fo = obin - o0f
    o0 = torch.remainder(o0f.to(torch.int64), nob)
    io = torch.arange(nob, device=dev)
    oh_o = ((io == o0[..., None]) * (1 - fo[..., None])
            + (io == (o0[..., None] + 1) % nob) * fo[..., None])
    return val, oh_o, wrc


def _descriptors(gx, gy, yf, xf, cy, cx, sig, angle, oh, ow,
                 cfg: SiftConfig):
    """Grid descriptors: ``_descriptor_samples`` binned trilinearly into
    4x4x8, cv2 normalization. The plain version of
    ``ops.sift_tail.descriptors``' kernel: each bin and both norms sum in
    the halving tree's fixed order, which it repeats.

    gx/gy: (K, psg, psg) anchored at (cy+1, cx+1); angle: (K, n_ori).
    Returns (K, n_ori, 128)."""
    val, oh_o, wrc = _descriptor_samples(gx, gy, yf, xf, cy, cx, sig, angle,
                                         oh, ow, cfg)
    # sample s adds wrc[s, rc] * (val[s] * oh_o[s, o]) to bin (rc, o);
    # one spatial bin at a time bounds the (K, no, S, nob) terms
    vo = val[..., None] * oh_o
    acc = torch.stack([tree_sum(wrc[:, rc, None] * vo, -2)
                       for rc in range(wrc.shape[1])], -2).flatten(-2)
    nrm = torch.sqrt(tree_sum(acc * acc, -1))[..., None]
    acc = torch.minimum(acc, cfg.descr_mag_thresh
                        * torch.clamp(nrm, min=1e-12))
    nrm2 = torch.sqrt(tree_sum(acc * acc, -1))[..., None]
    return acc / torch.clamp(nrm2, min=1e-12)


def _descriptors_dense(gx, gy, yf, xf, cy, cx, sig, angle, oh, ow,
                       cfg: SiftConfig):
    """cv2's integer-window descriptors (``descr_mode='dense'``): every
    pixel (i, j) of the patch, offset from the ROUNDED keypoint centre,
    whose rotated bin coordinates lie in (-1, d) and whose gradient
    footprint lies inside the image, adds its own f32 gradient with
    weight exp(-(c^2 + r^2) / (d^2 / 2)), binned trilinearly into the
    (d+2) x (d+2) x nob histogram by scatter-adds of its 8 corners; then
    cv2's clip and renormalisation.

    gx/gy: (K, psg, psg) anchored at (cy+1, cx+1); angle: (K, n_ori).
    Returns (K, n_ori, 128)."""
    k, psg, _ = gx.shape
    no = angle.shape[1]
    d, nob = cfg.descr_width, cfg.descr_ori_bins
    dev = gx.device
    ar = torch.arange(psg, device=dev)
    ay = cy[:, None] + 1 + ar[None, :]                 # (K, psg) rows
    ax = cx[:, None] + 1 + ar[None, :]                 # (K, psg) columns
    di = (ay - torch.round(yf)[:, None]).to(torch.float32)
    dj = (ax - torch.round(xf)[:, None]).to(torch.float32)
    hist_width = 3.0 * sig[:, None]
    cosw = (torch.cos(angle) / hist_width)[..., None, None]   # (K, no, 1, 1)
    sinw = (torch.sin(angle) / hist_width)[..., None, None]
    dj = dj[:, None, None, :]                           # (K, 1, 1, psg)
    di = di[:, None, :, None]                           # (K, 1, psg, 1)
    c_rot = dj * cosw - di * sinw                       # (K, no, psg, psg)
    r_rot = dj * sinw + di * cosw
    rbin = r_rot + d / 2 - 0.5
    cbin = c_rot + d / 2 - 0.5
    hh, ww = oh[:, None], ow[:, None]
    inb = (((ay >= 1) & (ay <= hh - 2))[:, :, None]
           & ((ax >= 1) & (ax <= ww - 2))[:, None, :])  # (K, psg, psg)
    valid = ((rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d)
             & inb[:, None])
    mag = torch.sqrt(gx * gx + gy * gy)[:, None]
    ori = torch.remainder(torch.atan2(gy, gx)[:, None]
                          - angle[..., None, None], 2 * math.pi)
    obin = ori * (nob / (2 * math.pi))
    wgt = torch.exp((c_rot * c_rot + r_rot * r_rot) * (-1.0 / (d * d * 0.5)))
    val = (mag * wgt * valid).reshape(k * no, -1)

    def corners(binc, n, wrap):
        i0 = torch.floor(binc)
        frac = (binc - i0).reshape(k * no, -1)
        i0 = i0.to(torch.int64).reshape(k * no, -1)
        if wrap:
            i0 = torch.remainder(i0, n)
            return ((i0, 1 - frac), (torch.remainder(i0 + 1, n), frac))
        return ((torch.clamp(i0 + 1, 0, n - 1), 1 - frac),
                (torch.clamp(i0 + 2, 0, n - 1), frac))

    acc = torch.zeros((k * no, (d + 2) * (d + 2) * nob), device=dev)
    for ri, rw in corners(rbin, d + 2, False):
        vr = val * rw
        for oi, ow_ in corners(obin, nob, True):
            vro = vr * ow_
            for ci, cw in corners(cbin, d + 2, False):
                acc.scatter_add_(1, (ri * (d + 2) + ci) * nob + oi, vro * cw)
    acc = acc.reshape(k, no, d + 2, d + 2, nob)[:, :, 1:-1, 1:-1]
    acc = acc.reshape(k, no, -1)
    nrm = torch.sqrt(torch.sum(acc * acc, dim=-1, keepdim=True))
    acc = torch.minimum(acc, cfg.descr_mag_thresh
                        * torch.clamp(nrm, min=1e-12))
    nrm2 = torch.sqrt(torch.sum(acc * acc, dim=-1, keepdim=True))
    return acc / torch.clamp(nrm2, min=1e-12)


def _octave_caps(cfg: SiftConfig, n_oct: int,
                 base_shape: Tuple[int, int]) -> List[int]:
    """Per-octave DoG candidate budgets (half the geometric budget on
    octaves of >= 0.75 Mpix)."""
    h, w = base_shape
    caps = []
    for o in range(n_oct):
        pix = (h >> o) * (w >> o)
        shift = o + 1 if pix >= 750_000 else o
        caps.append(max(cfg.max_kpts >> shift, 128))
    return caps


def _chunked(fn, chunk: int, *args):
    """``fn`` over the rows of ``args`` in chunks of ``chunk`` (one call
    when it covers them all): the results concatenated."""
    m = args[0].shape[0]
    outs = [fn(*(a[c0:c0 + chunk] for a in args))
            for c0 in range(0, m, chunk)]
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def sift_extract(gray: torch.Tensor, cfg: Optional[SiftConfig] = None
                 ) -> SiftFeatures:
    """SIFT keypoints + descriptors of (N, H, W) f32 gray images in
    [0, 1]; fixed-capacity ``SiftFeatures`` sorted by response.
    ``cfg``: by default ``SiftConfig()``, made at the call (so that
    ``PANO_SIFT_DESCR`` is read then)."""
    cfg = SiftConfig() if cfg is None else cfg
    n, h0, w0 = gray.shape
    gray = gray.to(torch.float32)
    n_oct = n_octaves_for((h0, w0), cfg.upscale)
    up = 2 if cfg.upscale else 1
    caps = _octave_caps(cfg, n_oct, (up * h0, up * w0))
    scale0 = 1.0 / up                       # octave -> original pixels
    s = cfg.n_layers
    half = cfg.patch_half
    taps = gauss_octave.chain_taps(cfg.sigma, s)
    score_cfg = sift_front.score_cfg(cfg)

    octv = _base_image(gray, cfg)
    outs = []
    for o in range(n_oct):
        gauss, dog, cscore = _gauss_and_dog(octv, cfg, taps, score_cfg)
        oh, ow = gauss.shape[2], gauss.shape[3]
        cap = min(caps[o], s * oh * ow)
        l0, y0, x0, cand_ok = _octave_candidates(dog, cfg, cap, cscore)
        l, y, x, offs, contrast, ok = sift_tail.refine(dog, l0, y0, x0, cfg)
        ok = ok & cand_ok
        sel_cap = cap if cap < 1024 else max(cap >> cfg.sel_shift, 512)
        if sel_cap < cap:
            score = torch.where(ok, torch.abs(contrast), -math.inf)
            _, sel = torch.topk(score, sel_cap, dim=1)
            l, y, x = _take(l, sel), _take(y, sel), _take(x, sel)
            offs, contrast, ok = (_take(offs, sel), _take(contrast, sel),
                                  _take(ok, sel))
        lf = l.to(torch.float32) + offs[..., 2]
        sig = cfg.sigma * torch.pow(2.0, lf / s)
        xf = x.to(torch.float32) + offs[..., 0]
        yf = y.to(torch.float32) + offs[..., 1]

        ps_y = min(2 * half + 2, oh)
        ps_x = min(2 * half + 2, ow)
        patches, pcy, pcx = _extract_patches(gauss, l, y, x, ps_y, ps_x)
        gxp = patches[..., 1:-1, 2:] - patches[..., 1:-1, :-2]
        gyp = patches[..., :-2, 1:-1] - patches[..., 2:, 1:-1]
        psg = 2 * half
        pad = (0, psg - gxp.shape[-1], 0, psg - gxp.shape[-2])
        if any(pad):
            gxp = torch.nn.functional.pad(gxp, pad)
            gyp = torch.nn.functional.pad(gyp, pad)
        k = l.shape[1]
        factor = scale0 * (2.0 ** o)
        outs.append(dict(
            gxp=gxp, gyp=gyp, y=y, x=x, yf=yf, xf=xf, pcy=pcy, pcx=pcx,
            sig=sig, response=torch.abs(contrast), ok=ok,
            factor=torch.full((n, k), factor, device=gray.device),
            oh=torch.full((n, k), oh, device=gray.device),
            ow=torch.full((n, k), ow, device=gray.device)))
        if o + 1 < n_oct:
            octv = gauss[:, s, ::2, ::2].contiguous()
        del gauss, dog, cscore, patches

    cat = {key: torch.cat([d[key] for d in outs], dim=1) for key in outs[0]}
    del outs
    total = cat["y"].shape[1]
    m = n * total
    flat = {key: v.reshape((m,) + v.shape[2:]) for key, v in cat.items()}
    no = cfg.n_orientations
    # a kernel has no transients to bound: on a card the orientation and
    # the grid descriptor take every keypoint of the batch in one launch
    # (each keypoint's result is the same in any chunk)
    chunk = KP_CHUNK[cfg.descr_mode]
    on_card = gray.device.type == "cuda"
    grid = cfg.descr_mode == "grid"
    angles, avalid = _chunked(
        partial(sift_tail.orientation, cfg=cfg), m if on_card else chunk,
        *(flat[key] for key in ("gxp", "gyp", "y", "x", "pcy", "pcx", "sig",
                                "oh", "ow")))
    descs = _chunked(
        partial(sift_tail.descriptors if grid else _descriptors_dense,
                cfg=cfg), m if on_card and grid else chunk,
        *(flat[key] for key in ("gxp", "gyp", "yf", "xf", "pcy", "pcx",
                                "sig")), angles, flat["oh"], flat["ow"])

    angles = angles.reshape(n, total, no)
    avalid = avalid.reshape(n, total, no)
    descs = descs.reshape(n, total, no, cfg.dim)
    xy = torch.stack([cat["xf"], cat["yf"]], dim=-1) * cat["factor"][..., None]
    size = cat["sig"] * 2.0 * cat["factor"]
    kp_ok = cat["ok"][..., None] & avalid
    t2 = total * no
    feats = dict(
        xy=xy[:, :, None, :].expand(n, total, no, 2).reshape(n, t2, 2),
        size=size[:, :, None].expand(n, total, no).reshape(n, t2),
        angle=angles.reshape(n, t2),
        response=cat["response"][:, :, None].expand(n, total, no
                                                    ).reshape(n, t2),
        desc=descs.reshape(n, t2, cfg.dim),
        valid=kp_ok.reshape(n, t2))
    score = torch.where(feats["valid"], feats["response"], -math.inf)
    _, sel = torch.topk(score, min(cfg.max_kpts, t2), dim=1)
    return SiftFeatures(**{key: _take(v, sel) for key, v in feats.items()})


def root_sift(desc: torch.Tensor) -> torch.Tensor:
    """RootSIFT normalization: sqrt(des / (sum + 1e-7))."""
    return torch.sqrt(desc / (torch.sum(desc, dim=-1, keepdim=True) + 1e-7))


__all__ = ["SiftConfig", "SiftFeatures", "sift_extract", "root_sift",
           "n_octaves_for"]
