"""SIFT's grid descriptor turned with its keypoint (CPU, plain versions).

The keypoint's angle is counter-clockwise on screen (the gradients' y
points up) and the descriptor's grid turns with it, so a view turned in
plane keeps its descriptors. Two tests hold that:

- the port's ``_descriptors``, given the gradient patches that
  ``sift_extract`` cuts, against ``plain_sift_descriptor`` (plain torch,
  written from Lowe's paper, no import of either package) at seeded
  random keypoints, scales and angles over a value-noise image: within
  1e-4 for >= 99 % of the keypoints (the two sum in different orders);
- a value-noise view against copies of itself turned about its centre:
  ratio matches (``match.knn2_matches`` of RootSIFT) that land within
  3 px of the true map, at least half of the unturned view's count.

A grid turned against its keypoint (the sign of the turn flipped)
misaligns a turn of theta by 2 theta: it fails the first test at every
angle but 0 and pi, and keeps 0-1 matches of the second at 30, 60 and
90 degrees.
"""
import math

import numpy as np
import pytest
import torch

from pano360_tpu_torch import match as tmatch
from pano360_tpu_torch.features import sift as tsift

import plain_sift_descriptor as plain

torch.set_num_threads(1)

CFG = tsift.SiftConfig(max_kpts=600, descr_mode="grid")


def value_noise(xs, ys, seed, octaves=5, cell=32.0):
    """Smooth value noise at points (xs, ys) (float64 arrays), levels
    spread over [0, 1]: a bicubic-faded lattice an octave, persistence
    0.8, defined for coordinates in [0, 1000)."""
    rng = np.random.default_rng(seed)
    out = np.zeros(np.shape(xs))
    for o in range(octaves):
        size = cell / 2 ** o
        n = int(1000 / size) + 3
        grid = rng.standard_normal((n, n))
        u, v = xs / size, ys / size
        x0, y0 = np.floor(u).astype(int), np.floor(v).astype(int)
        fx, fy = u - x0, v - y0
        fx, fy = fx * fx * (3 - 2 * fx), fy * fy * (3 - 2 * fy)
        top = grid[y0, x0] * (1 - fx) + grid[y0, x0 + 1] * fx
        bottom = grid[y0 + 1, x0] * (1 - fx) + grid[y0 + 1, x0 + 1] * fx
        out += (top * (1 - fy) + bottom * fy) * 0.8 ** o
    lo, hi = np.percentile(out, [1, 99])
    return np.clip((out - lo) / (hi - lo), 0.0, 1.0)


def turned_view(side, degrees, seed=7):
    """A (side, side) float32 view of the noise, turned counter-clockwise
    on screen by ``degrees`` about the view's centre: pixel p of the
    turned view shows the unturned view's point R^-1 (p - c) + c."""
    c = (side - 1) / 2
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float64)
    t = math.radians(degrees)
    dx, dy = xx - c, yy - c
    x1 = math.cos(t) * dx + math.sin(t) * dy + c
    y1 = -math.sin(t) * dx + math.cos(t) * dy + c
    return value_noise(x1 + 300, y1 + 300, seed).astype(np.float32)


def port_descriptors(img, xf, yf, sig, angle):
    """The port's grid descriptors of keypoints (xf, yf, sig, angle) of
    one image, on the 66x66 patches and the central-difference gradient
    patches that ``sift_extract`` cuts around the rounded keypoints."""
    half = CFG.patch_half
    h, w = img.shape
    gauss = img[None, None]
    y = torch.round(yf).long()[None]
    x = torch.round(xf).long()[None]
    patches, pcy, pcx = tsift._extract_patches(
        gauss, torch.zeros_like(y), y, x, 2 * half + 2, 2 * half + 2)
    gx = patches[..., 1:-1, 2:] - patches[..., 1:-1, :-2]
    gy = patches[..., :-2, 1:-1] - patches[..., 2:, 1:-1]
    k = xf.shape[0]
    full = torch.full((k,), 1, dtype=torch.int64)
    return tsift._descriptors(gx[0], gy[0], yf, xf, pcy[0], pcx[0], sig,
                              angle[:, None], full * h, full * w,
                              CFG)[:, 0]


def test_grid_descriptor_matches_plain_reference():
    """400 keypoints at random positions, scales 1.6-3.2 and angles over
    the full turn. They keep 6 px from the top and left edges, as the
    detector's border leaves them, so that windows leave the image
    there, and 34 px from the bottom and right ones: a patch cut against
    those is shifted inside the image, and samples whose bilinear taps
    reach its last gradient row count nothing (the JAX package's rule
    too), where the reference takes every sample inside the image."""
    h, w = 160, 200
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = torch.from_numpy(value_noise(xx + 50, yy + 50, 3)
                           .astype(np.float32))
    rng = np.random.default_rng(11)
    k = 400
    xf = torch.from_numpy(rng.uniform(6, w - 34, k).astype(np.float32))
    yf = torch.from_numpy(rng.uniform(6, h - 34, k).astype(np.float32))
    sig = torch.from_numpy(rng.uniform(1.6, 3.2, k).astype(np.float32))
    angle = torch.from_numpy(rng.uniform(0, 2 * math.pi, k)
                             .astype(np.float32))
    ours = port_descriptors(img, xf, yf, sig, angle)
    theirs = torch.stack([
        plain.descriptor(img, float(xf[i]), float(yf[i]), float(sig[i]),
                         float(angle[i])) for i in range(k)])
    err = (ours - theirs).abs().amax(dim=1)
    assert (err <= 1e-4).float().mean() >= 0.99, torch.quantile(err, 0.99)
    # and the turn reaches the descriptor: a keypoint's own angle against
    # a quarter turn of it gives another descriptor
    other = port_descriptors(img, xf, yf, sig, angle + math.pi / 2)
    assert ((other - ours).abs().amax(dim=1) > 1e-2).float().mean() > 0.9


def _features(img):
    return tsift.sift_extract(torch.from_numpy(img)[None], CFG)


def _true_matches(f0, f1, side, degrees):
    """Ratio matches of f0 against f1 that land within 3 px of where the
    turn takes f0's keypoints."""
    best, good = tmatch.knn2_matches(tsift.root_sift(f0.desc),
                                     tsift.root_sift(f1.desc),
                                     f0.valid, f1.valid)
    good = good[0]
    p0 = f0.xy[0][good].double().numpy()
    p1 = f1.xy[0][best[0][good]].double().numpy()
    c = (side - 1) / 2
    t = math.radians(degrees)
    d = p0 - c
    tx = math.cos(t) * d[:, 0] - math.sin(t) * d[:, 1] + c
    ty = math.sin(t) * d[:, 0] + math.cos(t) * d[:, 1] + c
    return int((np.hypot(tx - p1[:, 0], ty - p1[:, 1]) < 3.0).sum())


SIDE = 256


@pytest.fixture(scope="module")
def unturned():
    f0 = _features(turned_view(SIDE, 0))
    return f0, _true_matches(f0, f0, SIDE, 0)


@pytest.mark.parametrize("degrees", [30, 60, 90])
def test_turned_copy_keeps_its_matches(unturned, degrees):
    f0, at_zero = unturned
    assert at_zero >= 300
    f1 = _features(turned_view(SIDE, degrees))
    got = _true_matches(f0, f1, SIDE, degrees)
    assert got >= at_zero / 2, (got, at_zero)
