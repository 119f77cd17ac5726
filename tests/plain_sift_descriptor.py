"""A plain SIFT descriptor of one keypoint, written from Lowe (IJCV 2004,
section 6.1, "Descriptor representation") and the conventions that the
port's grid descriptor states, independent of both packages: plain
torch in float32, no import of ``pano360_tpu`` or ``pano360_tpu_torch``.

``descriptor(img, x, y, sigma, theta)`` takes a gray image (the Gaussian
layer of the keypoint's scale, in its own pixels) and one keypoint: its
position (x along columns, y along rows), its scale ``sigma`` and its
orientation ``theta``. The orientation is counter-clockwise on screen,
as a gradient's angle is when its y points up, and the descriptor's
grid turns with it: the grid's u axis runs along the keypoint's
direction, (cos theta, -sin theta) in pixels, whose y points down, and
its v axis along (sin theta, cos theta). So a view turned in plane
gives its keypoints the same descriptors.

What the paper says, and is done here: gradient magnitudes and
orientations sampled around the keypoint; coordinates and gradient
orientations taken relative to the keypoint's orientation; a Gaussian
weight of sigma one half of the descriptor window's width; a 4x4 array
of cells, 8 orientation bins each (128 numbers); each sample spread into
its neighbouring bins by trilinear interpolation, each of the three
axes weighted by 1 - d for its distance d to the bin's centre in bin
units; the vector normalised to unit length, every entry clipped at
0.2, and normalised again.

Where this departs from the paper (the conventions of the port's grid
descriptor, which OpenCV's SIFT shares in part):

- The samples are a fixed grid of 16x16 points, 4x4 a cell, at the
  cells' sub-centres, each taking the gradient interpolated bilinearly
  between the four pixels around it; the paper samples the image's
  pixels in the window.
- A cell is 3 sigma wide (OpenCV's ``SIFT_DESCR_SCL_FCTR``); the paper
  sizes the window by the keypoint's scale without giving the factor.
- The gradient is the central difference, the pixel to the right less
  the one to the left and the one above less the one below, without
  the factor 1/2 (the normalisation removes it); it exists on the
  image's interior only, rows and columns 1 .. n - 2, and a sample
  whose point lies outside that interior counts nothing.
- The Gaussian weight, exp(-(u^2 + v^2) / 8) in cell units, is the
  paper's sigma of half the 4-cell width.
- The orientation bin of a gradient at angle a against the keypoint is
  a 8 / (2 pi), bin 0 centred where the angle is 0 and the bins wrapping
  around; the spatial bins' centres lie at cell coordinates 0.5 .. 3.5,
  and what falls outside the 4x4 cells is dropped.
"""
import math

import torch

CELLS = 4              # cells a side
ORI_BINS = 8           # orientation bins a cell
SAMPLES = 16           # grid samples a side
CELL_SIGMAS = 3.0      # a cell's width in units of the keypoint's sigma
CLIP = 0.2             # the clip of the unit vector's entries


def gradients(img: torch.Tensor):
    """Central differences of a (H, W) image: (gx, gy), y pointing up,
    zero on the border rows and columns, where they do not exist."""
    img = img.to(torch.float32)
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[1:-1, 1:-1] = img[1:-1, 2:] - img[1:-1, :-2]
    gy[1:-1, 1:-1] = img[:-2, 1:-1] - img[2:, 1:-1]
    return gx, gy


def _bilinear(a: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """``a`` interpolated at points (x, y) of its pixel grid, indices
    held inside the array (a point's far taps weigh 0 on the edge)."""
    h, w = a.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    xa = x0.long().clamp(0, w - 1)
    xb = (x0.long() + 1).clamp(0, w - 1)
    ya = y0.long().clamp(0, h - 1)
    yb = (y0.long() + 1).clamp(0, h - 1)
    top = a[ya, xa] * (1 - fx) + a[ya, xb] * fx
    bottom = a[yb, xa] * (1 - fx) + a[yb, xb] * fx
    return top * (1 - fy) + bottom * fy


def descriptor(img: torch.Tensor, x: float, y: float, sigma: float,
               theta: float) -> torch.Tensor:
    """The 128 numbers of one keypoint of a (H, W) image, cell (row r,
    column c) and orientation bin o at index (4 r + c) 8 + o."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _descriptor(img, x, y, sigma, theta)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _descriptor(img, x, y, sigma, theta):
    f32 = dict(dtype=torch.float32, device=img.device)
    h, w = img.shape
    gx, gy = gradients(img)
    # the grid in cell units, centred on the keypoint: u along columns,
    # v along rows before the turn
    g = (torch.arange(SAMPLES, **f32) + 0.5) * (CELLS / SAMPLES) - CELLS / 2
    v, u = torch.meshgrid(g, g, indexing="ij")
    u, v = u.reshape(-1), v.reshape(-1)
    c = torch.cos(torch.tensor(theta, **f32))
    s = torch.sin(torch.tensor(theta, **f32))
    width = CELL_SIGMAS * sigma
    px = x + (u * c + v * s) * width
    py = y + (v * c - u * s) * width
    inside = (px >= 1) & (px <= w - 2) & (py >= 1) & (py <= h - 2)
    sgx = _bilinear(gx, px, py)
    sgy = _bilinear(gy, px, py)
    mag = torch.sqrt(sgx * sgx + sgy * sgy)
    ang = torch.remainder(torch.atan2(sgy, sgx) - theta, 2 * math.pi)
    weight = torch.exp(-(u * u + v * v) / (2 * (CELLS / 2) ** 2))
    val = mag * weight * inside

    # trilinear: each sample's 2 x 2 x 2 neighbouring bins
    rb = v + CELLS / 2 - 0.5
    cb = u + CELLS / 2 - 0.5
    ob = ang * (ORI_BINS / (2 * math.pi))
    r0, c0, o0 = torch.floor(rb), torch.floor(cb), torch.floor(ob)
    fr, fc, fo = rb - r0, cb - c0, ob - o0
    hist = torch.zeros(CELLS * CELLS * ORI_BINS, **f32)
    for dr in (0, 1):
        wr = fr if dr else 1 - fr
        r = r0.long() + dr
        for dc in (0, 1):
            wc = fc if dc else 1 - fc
            col = c0.long() + dc
            keep = (r >= 0) & (r < CELLS) & (col >= 0) & (col < CELLS)
            for do in (0, 1):
                wo = fo if do else 1 - fo
                o = torch.remainder(o0.long() + do, ORI_BINS)
                idx = (r * CELLS + col) * ORI_BINS + o
                hist.index_put_((idx[keep],), (val * wr * wc * wo)[keep],
                                accumulate=True)

    norm = torch.linalg.vector_norm(hist)
    if norm <= 0:
        return hist
    hist = torch.clamp(hist / norm, max=CLIP)
    return hist / torch.linalg.vector_norm(hist)
