"""RANSAC's hypothesis scoring: one CUDA kernel beside its plain version.

The match graph's parallel RANSAC (``match._hypotheses``) scores each of
a pair's K hypotheses against all M correspondences, counts the inliers
and keeps the first best. The JAX package leaves this to XLA inside the
jitted match graph (no Pallas kernel lies behind it); in PyTorch it is
about two dozen elementwise operations, each writing a (B, K, M) float
tensor. Here it is ``csrc/ransac_score.cu``, two launches a call: the
scoring of every (hypothesis, point) with integer partial counts, and a
block per pair that sums them, picks the winner and recomputes its mask.
No (B, K, M) tensor reaches device memory.

A CPU tensor takes the plain version (``score_ref``); a CUDA tensor
launches the kernel (on the current stream, writing only into tensors
allocated here, with no host sync, so that a CUDA graph captures it);
another device raises. On the card the kernel equals the plain version
bit for bit: every count, the winner, its homography and its mask (the
error operation by operation, separate multiplies and adds, the IEEE
reciprocal). ``_kernels.LAUNCHES["ransac_score"]`` counts the calls (one
a chunk of pairs; each launches both kernels); ``ransac_score_cost``
gives a call's least bytes and operations and its bound on an H100.
"""
from __future__ import annotations

import torch

from pano360_tpu_torch import _kernels
from pano360_tpu_torch.ops.gauss_octave import bound
from pano360_tpu_torch.ops.sift_tail import _check, _on_card

SPLIT = 256             # points a block of the score kernel takes (PTS)
# f32 operations a (hypothesis, point) test: u, v and w (two multiplies
# and two adds each), |w| and its guard, the reciprocal, du and dv (a
# multiply and a subtraction each), the squared error (two multiplies and
# an add) and the threshold's compare
TEST_OPS = 23


def reproj_errors(hom, p1, p2):
    """Squared forward reprojection error; hom (..., 3, 3) broadcasts
    against points (..., M, 2)."""
    h = hom[..., None, :, :]
    x, y = p1[..., 0], p1[..., 1]
    u = h[..., 0, 0] * x + h[..., 0, 1] * y + h[..., 0, 2]
    v = h[..., 1, 0] * x + h[..., 1, 1] * y + h[..., 1, 2]
    w = h[..., 2, 0] * x + h[..., 2, 1] * y + h[..., 2, 2]
    okw = torch.abs(w) > 1e-12
    inv_w = torch.where(okw, 1.0 / w, 0.0)
    du = u * inv_w - p2[..., 0]
    dv = v * inv_w - p2[..., 1]
    return torch.where(okw, du * du + dv * dv, torch.inf)


def score_ref(homs, p1, p2, valid, thresh: float):
    """Plain version: -> (the best hypothesis (B, 3, 3), its inlier mask
    (B, M), every hypothesis's count (B, K) int64)."""
    errs = reproj_errors(homs, p1[:, None], p2[:, None])  # (B, K, M)
    inl = (errs < thresh * thresh) & valid[:, None, :]
    finite = torch.isfinite(homs.reshape(homs.shape[:2] + (9,))).all(-1)
    counts = torch.where(finite, inl.sum(-1), 0)
    best = torch.argmax(counts, dim=-1)
    ar = torch.arange(homs.shape[0], device=homs.device)
    return homs[ar, best], inl[ar, best], counts


def _launch(homs, p1, p2, valid, thresh: float, counts: bool):
    b, k, m = homs.shape[0], homs.shape[1], p1.shape[1]
    dev = homs.device
    part = torch.empty((b, -(-m // SPLIT), k), dtype=torch.int32, device=dev)
    best = torch.empty((b, 3, 3), dtype=torch.float32, device=dev)
    mask = torch.empty((b, m), dtype=torch.bool, device=dev)
    cnt = (torch.empty((b, k), dtype=torch.int32, device=dev) if counts
           else None)
    _kernels.launch(
        "p360_ransac_score", homs.data_ptr(), p1.data_ptr(), p2.data_ptr(),
        valid.data_ptr(), part.data_ptr(), best.data_ptr(), mask.data_ptr(),
        None if cnt is None else cnt.data_ptr(), b, k, m,
        float(thresh) * float(thresh), _kernels.stream_ptr(dev))
    return best, mask, cnt


def _checked(homs, p1, p2, valid) -> bool:
    """Refuse what the kernel cannot take; -> True on a card."""
    name = "ransac score"
    card = _on_card(homs, name)
    _check(name, homs.device, homs=(homs, torch.float32, (None, None, 3, 3)))
    b, k = homs.shape[:2]
    _check(name, homs.device, p1=(p1, torch.float32, (b, None, 2)))
    m = p1.shape[1]
    _check(name, homs.device, p2=(p2, torch.float32, (b, m, 2)),
           valid=(valid, torch.bool, (b, m)))
    if min(b, k, m) < 1 or b > 65535:
        raise ValueError(f"{name}: takes 1..65535 pairs and at least one "
                         f"hypothesis and point, got B={b}, K={k}, M={m}")
    return card


def score(homs, p1, p2, valid, thresh: float):
    """Each pair's best hypothesis: homs (B, K, 3, 3) against p1, p2 (B,
    M, 2) with valid (B, M): -> (its homography (B, 3, 3), its inlier
    mask (B, M)); the count of a hypothesis is its valid points with a
    squared error < thresh^2, 0 if any entry is not finite, and the first
    largest count wins."""
    if not _checked(homs, p1, p2, valid):
        return score_ref(homs, p1, p2, valid, thresh)[:2]
    return _launch(homs, p1, p2, valid, thresh, counts=False)[:2]


def score_counts(homs, p1, p2, valid, thresh: float):
    """``score`` with every hypothesis's count (B, K) int64 too (the
    kernel's are written only here: for tests and measurements)."""
    if not _checked(homs, p1, p2, valid):
        return score_ref(homs, p1, p2, valid, thresh)
    best, mask, cnt = _launch(homs, p1, p2, valid, thresh, counts=True)
    return best, mask, cnt.to(torch.int64)


def ransac_score_cost(b: int, k: int, m: int) -> dict:
    """A call's least work: every hypothesis and point read once, the
    winners and masks written once; ``TEST_OPS`` a (hypothesis, point)."""
    nbytes = 36 * b * k + 17 * b * m + b * (36 + m)
    return bound(nbytes, TEST_OPS * b * k * m)


__all__ = ["score", "score_ref", "score_counts", "reproj_errors",
           "ransac_score_cost", "SPLIT", "TEST_OPS"]
