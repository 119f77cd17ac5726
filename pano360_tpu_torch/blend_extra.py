"""Experimental blenders: full-image warp, graph-cut seams, Laplacian and
Poisson blending (counterpart of ``pano360_tpu.blend_extra``).

- ``warp``: forward cylindrical/spherical warp of a whole image;
- ``alpha_blend``: linear ramp mix (host);
- ``graph_cut``: max-colour-difference seam through the native
  two-source priority flood (``pano360_tpu_torch.native``);
- ``laplacian_blending``: pyr_down/pyr_up Laplacian pyramids mixed
  through a Gaussian mask pyramid;
- ``poisson_blend``: Poisson image editing, the 5-point system solved
  matrix-free by Jacobi-preconditioned conjugate gradient. All channels
  run in one loop of tensor operations whose step sizes stay on the
  device, so no iteration waits for the host.

The device functions take numpy images and a ``device`` (default
``cuda``; the CPU runs only when named) and return numpy.

Usage: ``python -m pano360_tpu_torch.blend_extra [--device cpu]``
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from pano360_tpu_torch import geometry as geo
from pano360_tpu_torch import resolve_device
from pano360_tpu_torch.native import seam_flood
from pano360_tpu_torch.ops.filters import pyr_down, pyr_up
from pano360_tpu_torch.ops.resize import resize_bilinear
from pano360_tpu_torch.ops.warp import remap_bilinear


def warp(img: np.ndarray, kint: np.ndarray, hom: Optional[np.ndarray] = None,
         projector=geo.SphProj, device="cuda") -> np.ndarray:
    """Warp a full image into spherical/cylindrical coordinates: an RGBA
    uint8 image with a transparent background (bilinear, as cv2.remap
    samples whatever interpolation flag the original passed)."""
    dev = resolve_device(device)
    hh, ww = img.shape[:2]
    f32 = dict(dtype=torch.float32, device=dev)
    hom = torch.as_tensor(np.eye(3) if hom is None else hom, **f32)
    kint = torch.as_tensor(np.asarray(kint), **f32)

    ys, xs = torch.meshgrid(torch.arange(hh, **f32), torch.arange(ww, **f32),
                            indexing="ij")
    pts = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)
    pts = geo.mm(pts, hom.T)
    pts = geo.mm(pts, geo.inv3x3(kint).T)
    x_pr = geo.mm(projector.proj2hom(pts), kint.T)
    x_pr = x_pr[:, :2] / x_pr[:, 2:]
    inb = ((x_pr[:, 0] >= 0) & (x_pr[:, 0] < ww)
           & (x_pr[:, 1] >= 0) & (x_pr[:, 1] < hh))
    qx = torch.where(inb, x_pr[:, 0], -1.0).reshape(hh, ww)
    qy = torch.where(inb, x_pr[:, 1], -1.0).reshape(hh, ww)

    rgba = torch.cat([torch.as_tensor(np.asarray(img), **f32),
                      torch.full((hh, ww, 1), 255.0, **f32)], dim=-1)
    out = remap_bilinear(rgba, qx, qy, border="constant", cval=0.0)
    return torch.clamp(out, 0, 255).to(torch.uint8).cpu().numpy()


def alpha_blend(img1: np.ndarray, img2: np.ndarray,
                mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Linear-ramp alpha blend."""
    if mask is None:
        delta = img1.shape[1]
        mask = np.linspace(1, 0, delta).reshape((1, delta, 1))
    return (img1 * mask + img2 * (1 - mask)).astype("uint8")


def graph_cut(img1: np.ndarray, img2: np.ndarray, shrink: int = 5,
              device="cuda") -> np.ndarray:
    """Seam mask between two overlapping images: the cost is the largest
    channel difference (transparent pixels lowest), min-pooled by
    ``shrink``; the native two-source priority flood splits it; the mask
    comes back at full size, uint8 (255 = take img1)."""
    dev = resolve_device(device)
    diff = np.max(np.abs(img1.astype(np.float32)
                         - img2.astype(np.float32)), axis=2)
    if img1.shape[2] == 4:   # borders are low priority
        diff[img1[:, :, 3] == 0] = -1
        diff[img2[:, :, 3] == 0] = -1
    if shrink > 1:
        hh, ww = diff.shape
        hh, ww = hh // shrink, ww // shrink
        diff = diff[: shrink * hh, : shrink * ww]
        diff = diff.reshape(hh, shrink, ww, shrink).min(axis=(1, 3))

    border = int(13 / shrink) + 1
    mask = seam_flood(diff, border)
    full = resize_bilinear(
        torch.as_tensor((mask == -1).astype(np.float32), device=dev),
        img1.shape[:2]).cpu().numpy()
    return (full[..., None] * 255).astype("uint8")


def laplacian_blending(img1: np.ndarray, img2: np.ndarray,
                       mask: Optional[np.ndarray] = None,
                       n_levels: int = 6, device="cuda") -> np.ndarray:
    """Laplacian-pyramid blending of two (H, W, C) images through the
    Gaussian pyramid of ``mask`` (default: a steep sigmoid left to
    right)."""
    dev = resolve_device(device)
    if mask is None:
        hh, ww, cc = img1.shape
        m = np.linspace(1, -1, ww).reshape((1, ww, 1))
        m = 1.0 / (1 + np.exp(-100 * m))
        mask = np.tile(m, (hh, 1, cc))
    mask = np.asarray(mask, np.float32)
    if mask.ndim == 2:
        mask = mask[..., None]
    if mask.shape[2] == 1:
        mask = np.repeat(mask, img1.shape[2], axis=2)

    f32 = dict(dtype=torch.float32, device=dev)
    a = torch.as_tensor(np.asarray(img1), **f32)
    b = torch.as_tensor(np.asarray(img2), **f32)
    m = torch.as_tensor(mask, **f32)

    def gaussian_pyr(x):
        pyr = [x]
        for _ in range(n_levels):
            x = pyr_down(x)
            pyr.append(x)
        return pyr

    def laplacian_pyr(x):
        pyr = gaussian_pyr(x)
        lap = [pyr[-1]]
        for idx in range(n_levels, 0, -1):
            up = pyr_up(pyr[idx], out_shape=pyr[idx - 1].shape[:2])
            lap.append(pyr[idx - 1] - up)
        return lap

    pyr1 = laplacian_pyr(a)
    pyr2 = laplacian_pyr(b)
    pyrm = gaussian_pyr(m)[::-1]

    blended = None
    for la, lb, gm in zip(pyr1, pyr2, pyrm):
        lvl = la * gm + lb * (1.0 - gm)
        if blended is None:
            blended = lvl
        else:
            blended = lvl + pyr_up(blended, out_shape=lvl.shape[:2])
    return torch.clamp(blended, 0, 255).to(torch.uint8).cpu().numpy()


# ---------------------------------------------------------------------------
# Poisson blending via matrix-free CG
# ---------------------------------------------------------------------------

def _laplacian_apply(x: torch.Tensor, interior: torch.Tensor) -> torch.Tensor:
    """The masked 5-point system on (..., H, W): A x = 4x - sum of the
    neighbours (zero outside the image) on interior pixels, x elsewhere
    (Dirichlet rows)."""
    pad = torch.nn.functional.pad(x, (1, 1, 1, 1))
    nb = (pad[..., :-2, 1:-1] + pad[..., 2:, 1:-1]
          + pad[..., 1:-1, :-2] + pad[..., 1:-1, 2:])
    return torch.where(interior, 4.0 * x - nb, x)


def poisson_cg(src_lap: torch.Tensor, target: torch.Tensor,
               interior: torch.Tensor, iters: int = 400):
    """Jacobi-preconditioned CG on the masked Poisson system, every
    (C, H, W) channel with its own step sizes, which stay on the device:
    -> (x, r0, r), the solution and the residual norms (C,) before the
    first and after the last iteration."""
    def dot(u, v):
        return (u * v).sum(dim=(-2, -1), keepdim=True)

    bb = torch.where(interior, src_lap, target)
    minv = torch.where(interior, 0.25, 1.0)
    x = target
    r = bb - _laplacian_apply(x, interior)
    z = minv * r
    p = z
    rz = dot(r, z)
    r0 = torch.sqrt(dot(r, r)).flatten()
    for _ in range(iters):
        ap = _laplacian_apply(p, interior)
        alpha = rz / torch.clamp(dot(p, ap), min=1e-12)
        x = x + alpha * p
        r = r - alpha * ap
        z = minv * r
        rz_new = dot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-12)
        p = z + beta * p
        rz = rz_new
    return x, r0, torch.sqrt(dot(r, r)).flatten()


def poisson_blend(img_source: np.ndarray, img_target: np.ndarray,
                  img_mask: np.ndarray, iters: int = 400, device="cuda",
                  stats: Optional[dict] = None) -> np.ndarray:
    """Poisson editing: paste the source's gradients into the target
    inside the mask, matching the target's values at the boundary.
    ``stats``: an optional dict that receives the per-channel residual
    norms ``residual0`` and ``residual``."""
    dev = resolve_device(device)
    mask = np.asarray(img_mask) != 0
    if mask.ndim == 3:
        mask = mask[..., 0]
    interior = torch.as_tensor(mask, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    src = torch.as_tensor(np.asarray(img_source), **f32).movedim(-1, 0)
    tgt = torch.as_tensor(np.asarray(img_target), **f32).movedim(-1, 0)
    src_lap = _laplacian_apply(src, torch.ones_like(interior))
    sol, r0, r = poisson_cg(src_lap, tgt, interior, iters)
    if stats is not None:
        stats["residual0"] = r0.cpu().numpy()
        stats["residual"] = r.cpu().numpy()
    sol = torch.clamp(sol, 0, 255).movedim(0, -1).cpu().numpy()
    return sol.astype(img_target.dtype)


def demo(shape=(360, 480), device="cuda", stats: Optional[dict] = None):
    """The two-image blend demo on two synthetic views of ``shape``:
    warp both, cut a seam through the overlap, blend it by Laplacian
    pyramids and by Poisson editing. -> dict of the uint8 results
    (``warped`` (2), ``mask``, ``laplacian``, ``poisson``, ``blended``);
    ``stats`` receives each step's seconds and the Poisson residuals."""
    from pano360_tpu_torch import synth
    dev = resolve_device(device)
    stats = {} if stats is None else stats

    def timed(name, fn, *args, **kw):
        start = time.perf_counter()
        out = fn(*args, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats[f"{name}_seconds"] = time.perf_counter() - start
        return out

    hh, ww = shape
    imgs, _, focal = synth.make_views(n_views=2, shape=shape, overlap=0.55,
                                      seed=0)
    u8 = [(im * 255).astype(np.uint8) for im in imgs]
    kint = geo.intrinsics(torch.tensor(focal, dtype=torch.float32),
                          (ww / 2.0, hh / 2.0)).numpy()
    w1, w2 = timed("warp", lambda: [warp(im, kint, device=dev) for im in u8])

    delta = ww * 13 // 24
    left, right = w1[:, -delta:], w2[:, :delta]
    mask = timed("graph_cut", graph_cut, left, right, device=dev)
    lap = timed("laplacian", laplacian_blending, left[..., :3],
                right[..., :3], mask.astype(np.float32) / 255, device=dev)
    overlap = timed("poisson", poisson_blend, left[..., :3],
                    right[..., :3].copy(), mask > 127, device=dev,
                    stats=stats)
    blended = np.concatenate(
        [w1[:, :-delta, :3], overlap, w2[:, delta:, :3]], axis=1)
    return dict(warped=[w1, w2], mask=mask, laplacian=lap, poisson=overlap,
                blended=blended)


def main(argv=None):
    """Run the demo and save the concatenated result."""
    import argparse
    from pano360_tpu_torch.imageio import imwrite
    parser = argparse.ArgumentParser(description="Two-image blend demo.")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda).")
    parser.add_argument("-o", "--out", default="blend_demo.png")
    args = parser.parse_args(argv)
    blended = demo(device=args.device)["blended"]
    imwrite(args.out, blended)
    print(f"saved {args.out} ({blended.shape[1]}x{blended.shape[0]})")


__all__ = ["warp", "alpha_blend", "graph_cut", "laplacian_blending",
           "poisson_cg", "poisson_blend", "demo", "main"]

if __name__ == "__main__":
    main()
