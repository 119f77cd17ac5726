"""SIFT's tail after the octave kernel: three CUDA kernels.

The JAX package runs ``sift_extract`` as one jitted program, and XLA
fuses its tail into a few loops (no Pallas kernel lies behind them).
Here each is a kernel written for the card, beside its plain PyTorch
version in ``features/sift.py``:

- ``refine`` (``csrc/sift_refine.cu``, ``csrc/newton_step.cuh``): each
  candidate's Newton steps, each computed from the DoG stack where the
  candidate stands, then its cube's offsets, contrast and edge tests
  (plain: ``_refine`` on the dense field of ``_newton_step_field``, the
  packed step of every DoG pixel of layers 1..S, which the card never
  makes);
- ``orientation`` (``csrc/sift_orient.cu``): each keypoint's smoothed
  36-bin histogram and its two interpolated peaks (``_orientation_hist``
  and ``_peak_angles``), a warp per keypoint on the grid mode's 64x64
  patches, a block per keypoint on other patches (the dense mode's
  80x80);
- ``descriptors`` (``csrc/sift_descr.cu``): the rotated grid descriptor
  of each keypoint and orientation (``_descriptors``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(on the current stream, writing only into tensors allocated here, with
no host sync, so that a CUDA graph captures it); another device raises.
On the card each kernel equals its plain version bit for bit: built with
``-fmad=false``, with IEEE division and square root and the math
library's ``atan2f``, ``expf``, ``sinf`` and ``cosf``, and summing in
the halving order (``geometry.tree_sum``) that the plain versions use.
Each launch counts in ``_kernels.LAUNCHES`` under its entry point's
name; the ``*_cost`` helpers give a call's least bytes and operations
and its bound on an H100.
"""
from __future__ import annotations

import math

import torch

from pano360_tpu_torch import _kernels
from pano360_tpu_torch.ops.gauss_octave import bound

# f32 operations counted per unit of work, from the plain versions'
# arithmetic (a math library call counts one): per Newton step (the 27
# derivative terms, the determinant, cofactors and three solves, the
# tests and the packing); per refined candidate (its moves, the cube's
# derivatives, solve and tests); per orientation sample inside the window
# (gradient magnitude and angle, weight, bin, and one add into its bin);
# per descriptor sample (rotation, two bilinear samples, magnitude,
# angle, weight, and its 8 trilinear terms)
NEWTON_OPS = 130
REFINE_OPS = 180
ORIENT_OPS = 20
DESCR_OPS = 70


def _plain():
    """The module of the plain versions (imported at the call: it
    imports this one)."""
    from pano360_tpu_torch.features import sift
    return sift


def _on_card(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _check(name: str, device, **args):
    """Each ``arg=(tensor, dtype, shape)`` contiguous, on ``device``, of
    that dtype and shape (a None entry of the shape takes any size)."""
    for key, (t, dtype, shape) in args.items():
        ok = (t.device == device and t.dtype == dtype and t.is_contiguous()
              and t.ndim == len(shape)
              and all(s is None or s == d for s, d in zip(shape, t.shape)))
        if not ok:
            raise ValueError(
                f"{name}: {key} must be a contiguous {dtype} tensor of shape "
                f"{shape} on {device}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")


def refine(dog, l0, y0, x0, cfg):
    """Newton refinement of (N, C) candidates (layer, y, x) in the (N,
    S+2, H, W) DoG stack: -> (l, y, x int64 (N, C), offs (N, C, 3) f32,
    contrast (N, C) f32, ok (N, C) bool). On the CPU the plain version
    steps along the dense field of Newton steps; the kernel computes
    each step where a candidate visits it."""
    if not _on_card(dog, "refine"):
        sift = _plain()
        return sift._refine(dog, sift._newton_step_field(dog), l0, y0, x0,
                            cfg)
    n, nl, h, w = dog.shape if dog.ndim == 4 else (0,) * 4
    c = l0.shape[1] if l0.ndim == 2 else 0
    s = cfg.n_layers
    _check("refine", dog.device, dog=(dog, torch.float32, (n, s + 2, h, w)),
           l0=(l0, torch.int64, (n, c)), y0=(y0, torch.int64, (n, c)),
           x0=(x0, torch.int64, (n, c)))
    dev = dog.device
    l, y, x = (torch.empty((n, c), dtype=torch.int64, device=dev)
               for _ in range(3))
    offs = torch.empty((n, c, 3), dtype=torch.float32, device=dev)
    contrast = torch.empty((n, c), dtype=torch.float32, device=dev)
    ok = torch.empty((n, c), dtype=torch.bool, device=dev)
    r = cfg.edge_thresh
    _kernels.launch(
        "p360_sift_refine", dog.data_ptr(), l0.data_ptr(), y0.data_ptr(),
        x0.data_ptr(), l.data_ptr(), y.data_ptr(), x.data_ptr(),
        offs.data_ptr(), contrast.data_ptr(), ok.data_ptr(), n, c, s, h, w,
        cfg.img_border, cfg.refine_iters, cfg.contrast_thresh, r,
        (r + 1) ** 2, _kernels.stream_ptr(dev))
    return l, y, x, offs, contrast, ok


def _keypoint_args(name, gx, gy, ints, floats):
    """Checks a keypoint stage's patches (M, psg, psg) and per-keypoint
    vectors -> (m, psg)."""
    m, psg = gx.shape[:2] if gx.ndim == 3 else (0, 0)
    _check(name, gx.device, gx=(gx, torch.float32, (m, psg, psg)),
           gy=(gy, torch.float32, (m, psg, psg)),
           **{k: (v, torch.int64, (m,)) for k, v in ints.items()},
           **{k: (v, torch.float32, (m,)) for k, v in floats.items()})
    return m, psg


def orientation(gx, gy, y, x, pcy, pcx, sig, oh, ow, cfg):
    """Orientations of M keypoints from their (M, psg, psg) gradient
    patches anchored at (pcy + 1, pcx + 1): -> (angles (M, 2) f32, valid
    (M, 2) bool). The kernel takes 36 bins, two orientations and
    psg^2 <= 8192: 64x64 patches take its warp-per-keypoint design,
    others its block-per-keypoint one (``p360_sift_orient_block``,
    counted as ``sift_orient_block``)."""
    if not _on_card(gx, "orientation"):
        sift = _plain()
        return sift._peak_angles(sift._orientation_hist(
            gx, gy, y, x, pcy, pcx, sig, oh, ow, cfg), cfg)
    m, psg = _keypoint_args("orientation", gx, gy,
                            dict(y=y, x=x, pcy=pcy, pcx=pcx, oh=oh, ow=ow),
                            dict(sig=sig))
    if cfg.ori_bins != 36 or cfg.n_orientations != 2 or psg * psg > 8192:
        raise ValueError("orientation: the kernel takes 36 bins, 2 "
                         "orientations and patches of <= 8192 samples")
    dev = gx.device
    angles = torch.empty((m, 2), dtype=torch.float32, device=dev)
    valid = torch.empty((m, 2), dtype=torch.bool, device=dev)
    nb = cfg.ori_bins
    entry = "p360_sift_orient" if psg == 64 else "p360_sift_orient_block"
    _kernels.launch(
        entry, gx.data_ptr(), gy.data_ptr(), y.data_ptr(), x.data_ptr(),
        pcy.data_ptr(), pcx.data_ptr(), oh.data_ptr(), ow.data_ptr(),
        sig.data_ptr(), angles.data_ptr(), valid.data_ptr(), m, psg,
        nb / (2 * math.pi), 2 * math.pi / nb, _kernels.stream_ptr(dev))
    return angles, valid


def descriptors(gx, gy, yf, xf, pcy, pcx, sig, angle, oh, ow, cfg):
    """Grid descriptors of M keypoints at each of their orientations
    ``angle`` (M, n_ori): -> (M, n_ori, 128) f32. The kernel takes the
    4x4x8 descriptor of 16x16 samples."""
    if not _on_card(gx, "descriptors"):
        return _plain()._descriptors(gx, gy, yf, xf, pcy, pcx, sig, angle,
                                     oh, ow, cfg)
    m, psg = _keypoint_args("descriptors", gx, gy,
                            dict(pcy=pcy, pcx=pcx, oh=oh, ow=ow),
                            dict(yf=yf, xf=xf, sig=sig))
    no = angle.shape[1] if angle.ndim == 2 else 0
    _check("descriptors", gx.device,
           angle=(angle, torch.float32, (m, no)))
    if (cfg.descr_width, cfg.descr_samples, cfg.descr_ori_bins) != (4, 16, 8):
        raise ValueError("descriptors: the kernel takes 4x4 bins of 8 "
                         "orientations over 16x16 samples")
    dev = gx.device
    desc = torch.empty((m, no, 128), dtype=torch.float32, device=dev)
    _kernels.launch(
        "p360_sift_descr", gx.data_ptr(), gy.data_ptr(), yf.data_ptr(),
        xf.data_ptr(), sig.data_ptr(), pcy.data_ptr(), pcx.data_ptr(),
        oh.data_ptr(), ow.data_ptr(), angle.data_ptr(), desc.data_ptr(), m,
        no, psg, 2 * math.pi, cfg.descr_ori_bins / (2 * math.pi),
        cfg.descr_mag_thresh, _kernels.stream_ptr(dev))
    return desc


# ---------------------------------------------------------------------------
# Least work of each call (bytes each input needed read once, each output
# written once; the operations above), and the bound on an H100
# ---------------------------------------------------------------------------

def refine_cost(dog, l0, y0, x0, cfg) -> dict:
    """Per candidate: its position (3 int64) read, the 19 DoG values of
    each distinct position its steps visit (the final cube's included;
    the steps replayed here on the plain field), a Newton step per
    distinct position it steps from, and its six outputs written."""
    n, nl, h, w = dog.shape
    s, b = cfg.n_layers, cfg.img_border
    flat = _plain()._newton_step_field(dog).reshape(n, -1)
    l, y, x = l0, y0, x0
    seen = []
    for _ in range(cfg.refine_iters):
        idx = (l - 1) * (h * w) + y * w + x
        seen.append(idx)
        word = torch.gather(flat, 1, idx)
        conv = (word & 1) > 0
        l = torch.where(conv, l, torch.clamp(l + ((word >> 5) & 3) - 1, 1, s))
        y = torch.where(conv, y, torch.clamp(y + ((word >> 3) & 3) - 1, b,
                                             h - 1 - b))
        x = torch.where(conv, x, torch.clamp(x + ((word >> 1) & 3) - 1, b,
                                             w - 1 - b))

    def distinct(idx):
        idx = torch.sort(torch.stack(idx, -1), -1).values
        return int(idx.numel() - (idx[..., 1:] == idx[..., :-1]).sum())
    steps = distinct(seen) if seen else 0
    positions = distinct(seen + [(l - 1) * (h * w) + y * w + x])
    cands = l0.numel()
    return bound(cands * (3 * 8 + 3 * 8 + 4 * 4 + 1) + 19 * 4 * positions,
                 REFINE_OPS * cands + NEWTON_OPS * steps)


def _span(lo, hi, a, b):
    """Length of [lo, hi] intersected with [a, b] (elementwise)."""
    return torch.clamp(torch.minimum(hi, b) - torch.maximum(lo, a) + 1, min=0)


def orientation_cost(y, x, pcy, pcx, sig, oh, ow, psg: int) -> dict:
    """Per keypoint: the gradient samples its window uses (inside radius
    round(4.5 sigma), the patch and the image), its 7 scalars, and its
    two angles and flags."""
    r = torch.round(4.5 * sig).to(torch.int64)
    rows = _span(y - r, y + r, torch.maximum(pcy + 1, torch.ones_like(y)),
                 torch.minimum(pcy + psg, oh - 2))
    cols = _span(x - r, x + r, torch.maximum(pcx + 1, torch.ones_like(x)),
                 torch.minimum(pcx + psg, ow - 2))
    samples = int((rows * cols).sum())
    m = y.numel()
    return bound(8 * samples + m * (6 * 8 + 4) + m * 2 * (4 + 1),
                 ORIENT_OPS * samples)


def descriptors_cost(yf, xf, pcy, pcx, sig, angle, oh, ow, psg: int,
                     cfg) -> dict:
    """Per keypoint: the distinct gradient texels that the bilinear taps
    of its in-bounds samples read (both maps, over its orientations), its
    8 scalars and orientations, and its descriptors."""
    d, p = cfg.descr_width, cfg.descr_samples
    m, no = angle.shape
    g = (torch.arange(p, dtype=torch.float32, device=yf.device) + 0.5) \
        / p * d - d / 2
    gv, gu = (t.reshape(-1) for t in torch.meshgrid(g, g, indexing="ij"))
    sx, sy = _plain()._grid_positions(xf, yf, sig, angle, gu, gv)
    px = sx - (pcx[:, None, None] + 1)
    py = sy - (pcy[:, None, None] + 1)
    inb = ((px >= 0) & (px <= psg - 2) & (py >= 0) & (py <= psg - 2)
           & (sx >= 1) & (sx <= ow[:, None, None] - 2) & (sy >= 1)
           & (sy <= oh[:, None, None] - 2))
    x0 = torch.floor(px).clamp(0, psg - 2).to(torch.int64)
    y0 = torch.floor(py).clamp(0, psg - 2).to(torch.int64)
    used = torch.zeros((m, psg * psg), dtype=torch.bool, device=yf.device)
    kk = torch.arange(m, device=yf.device)[:, None, None].expand_as(x0)
    for dy in (0, 1):
        for dx in (0, 1):
            idx = (y0 + dy) * psg + x0 + dx
            used[kk[inb], idx[inb]] = True
    texels = int(used.sum())
    return bound(8 * texels + m * (8 * 8 + 4 * no) + m * no * 128 * 4,
                 DESCR_OPS * m * no * p * p)


__all__ = ["refine", "orientation", "descriptors", "refine_cost",
           "orientation_cost", "descriptors_cost"]
