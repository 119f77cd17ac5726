"""The match's exact top-2 search: one CUDA kernel beside its plain version.

``match.knn2_matches`` finds, for every row of ``desc1`` (B, M1, D), its
nearest and second-nearest valid rows of ``desc2`` (B, M2, D) by squared
L2 distance and runs Lowe's ratio test on the two. The JAX package
leaves this to XLA around one matrix product inside the jitted match
graph (no Pallas kernel lies behind it). The plain version, ``knn2_ref``,
is about eight PyTorch operations around one GEMM, each reading or
writing a (B, M1, M2) float tensor: at MSOP's chunk, one pair of 8192
keypoints, 268 MB a pass. Here it is ``csrc/knn2.cu``, three launches a
call: the rows' squared norms, a search kernel that keeps each row's
two nearest from its tiles of dot products, in slices of the columns,
and a small kernel that merges the slices and runs the ratio test. No
(B, M1, M2) tensor reaches device memory.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(on the current stream, writing only into tensors allocated here, with
no host sync, so that a CUDA graph captures it); another device raises.
The kernel searches with the plain version's arithmetic in float32 (the
dot products in float32 FMAs: no TF32 or bf16), summed in other orders
(each dot product in two chains, the norms in float64, rounded once),
keeps each row's two nearest, and ranks the two again on their float64
distances, the test then taking the nearest float32 of those. So it
agrees with the plain version to float32 rounding: the nearest is a
nearest of the exact distances within ``rounding_margin``, and ``good``
is the exact test's wherever the distances lie farther than that from
the ratio's line; where the plain version's rounding decides a near tie
or a row on the line, the kernel gives float64's answer. The column
slices change no bit. ``_kernels.LAUNCHES["knn2"]`` counts the calls
(one a match chunk); ``knn2_cost`` gives a call's least bytes and
operations over the valid columns and its bound on an H100.
"""
from __future__ import annotations

import functools

import torch

from pano360_tpu_torch import _kernels
from pano360_tpu_torch.ops.gauss_octave import bound
from pano360_tpu_torch.ops.sift_tail import _check, _on_card

ROWS = 128              # desc1 rows a block (csrc/knn2.cu BM)
COLS = 64               # desc2 columns a tile (BN)
CHUNK = 32              # the widths the kernel takes: multiples of it
MAX_D = 128             # up to it
BLOCKS_PER_SM = 2       # the search kernel's residency (launch bounds)
MAX_SLICES = 64
MAX_M2 = 65535          # desc2 rows: their indices packed in 16 bits


def knn2_ref(desc1, desc2, valid1, valid2, ratio: float):
    """Plain version: -> (best_idx (B, M1) int64, good (B, M1) bool)."""
    d1 = desc1.to(torch.float32)
    d2 = desc2.to(torch.float32)
    sq1 = torch.sum(d1 * d1, dim=-1, keepdim=True)
    sq2 = torch.sum(d2 * d2, dim=-1)
    cross = torch.matmul(d1, d2.transpose(-1, -2))
    dist2 = sq1 + sq2[..., None, :] - 2.0 * cross
    dist2 = torch.clamp(dist2, min=0.0)
    dist2 = torch.where(valid2[..., None, :], dist2, torch.inf)
    d1min, best_idx = torch.min(dist2, dim=-1)
    cols = torch.arange(dist2.shape[-1], device=dist2.device)
    masked = torch.where(cols == best_idx[..., None], torch.inf, dist2)
    d2min = torch.min(masked, dim=-1).values
    best = torch.sqrt(d1min)
    second = torch.sqrt(d2min)
    good = valid1 & (best < ratio * second) & torch.isfinite(second)
    return best_idx, good


def rounding_margin(sq1, sq2, d: int):
    """A bound on how far the kernel's or the plain version's float32
    squared distance of rows with squared norms ``sq1`` and ``sq2`` lies
    from the exact one: each of the two norms and the dot product is a
    sum of d float32 products (relative error at most d u, u = 2^-24, of
    its terms' absolute sum), and three roundings join them; all of it
    under (d + 3) u (|a| + |b|)^2, here doubled."""
    return (d + 3) * 2.0 ** -23 * (sq1.sqrt() + sq2.sqrt()) ** 2


def slices(b: int, m1: int, m2: int, sms: int) -> int:
    """The column slices a row tile's search is cut into: the count that
    finishes first when each block takes its share of the column tiles
    and ``BLOCKS_PER_SM`` blocks run on each of ``sms`` multiprocessors
    (waves times a block's tiles and one tile's worth for its rows, its
    scan of the masks and its merge), the fewest among equals. MSOP's one
    pair of 8192 (64 row tiles) takes 4; the rig's 16 pairs of 2048, 1."""
    base = b * -(-m1 // ROWS)
    tiles = -(-m2 // COLS)
    slots = BLOCKS_PER_SM * sms
    best, cost = 1, None
    for s in range(1, min(tiles, MAX_SLICES) + 1):
        c = -(-base * s // slots) * (-(-tiles // s) + 1)
        if cost is None or c < cost:
            best, cost = s, c
    return best


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _checked(desc1, desc2, valid1, valid2):
    """Refuse what the kernel cannot take; -> the float32 descriptors and
    the masks, contiguous."""
    name = "knn2"
    dev = desc1.device
    for key, t in (("desc1", desc1), ("desc2", desc2)):
        if t.ndim != 3 or not t.is_floating_point() or t.device != dev:
            raise ValueError(f"{name}: {key} must be a (B, M, D) float tensor"
                             f" on {dev}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    a = desc1.to(torch.float32).contiguous()
    b = desc2.to(torch.float32).contiguous()
    v1, v2 = valid1.contiguous(), valid2.contiguous()
    nb, m1, d = a.shape
    _check(name, dev, desc2=(b, torch.float32, (nb, None, d)),
           valid1=(v1, torch.bool, (nb, m1)),
           valid2=(v2, torch.bool, (nb, b.shape[1])))
    if d % CHUNK or not CHUNK <= d <= MAX_D:
        raise ValueError(f"{name}: takes a descriptor width that is a "
                         f"multiple of {CHUNK} up to {MAX_D}, got D={d}")
    if (min(nb, m1, b.shape[1]) < 1 or nb > 65535 or m1 > 65535 * ROWS
            or b.shape[1] >= MAX_M2):
        raise ValueError(f"{name}: takes 1..65535 pairs, at least one row a "
                         f"side and fewer than {MAX_M2} desc2 rows, got "
                         f"B={nb}, M1={m1}, M2={b.shape[1]}")
    for key, t in (("desc1", a), ("desc2", b)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: takes 16-byte aligned descriptors, "
                             f"got {key} at {t.data_ptr():#x}")
    return a, b, v1, v2


def knn2(desc1, desc2, valid1, valid2, ratio: float):
    """Each desc1 row's nearest valid desc2 row and Lowe's ratio test:
    desc1 (B, M1, D), desc2 (B, M2, D), valid1 (B, M1), valid2 (B, M2)
    -> (best_idx (B, M1) int64, good (B, M1) bool)."""
    if not _on_card(desc1, "knn2"):
        return knn2_ref(desc1, desc2, valid1, valid2, ratio)
    a, b, v1, v2 = _checked(desc1, desc2, valid1, valid2)
    nb, m1, d = a.shape
    m2 = b.shape[1]
    dev = a.device
    s = slices(nb, m1, m2, _sms(dev.index if dev.index is not None
                                else torch.cuda.current_device()))
    norms = torch.empty((nb, m1 + m2), dtype=torch.float32, device=dev)
    part = torch.empty((nb, s, m1, 4), dtype=torch.float32, device=dev)
    best = torch.empty((nb, m1), dtype=torch.int64, device=dev)
    good = torch.empty((nb, m1), dtype=torch.bool, device=dev)
    _kernels.launch("p360_knn2", a.data_ptr(), b.data_ptr(), v1.data_ptr(),
                    v2.data_ptr(), norms.data_ptr(), part.data_ptr(),
                    best.data_ptr(),
                    good.data_ptr(), nb, m1, m2, d, s, float(ratio),
                    _kernels.stream_ptr(dev))
    return best, good


def knn2_cost(b: int, m1: int, m2: int, d: int, cols=None) -> dict:
    """A call's least work, over ``cols`` desc2 rows in all (the valid
    ones, summed over the B pairs; every row if None): an invalid
    column's distance is +inf by definition, so no operation on it is
    needed, while every desc1 row's index is an output. The cross term's
    2 D operations a (row, valid column), the norms' 2 D a row, the
    distance's add and subtraction a (row, valid column) and the ratio
    test's two roots and a multiply a row; every desc1 row and valid
    desc2 row read once, every valid flag read once, the indices and the
    test written once; its bound on an H100 (``gauss_octave.bound``)."""
    n2 = b * m2 if cols is None else int(cols)
    flops = (2 * m1 * n2 * d + 2 * (b * m1 + n2) * d + 2 * m1 * n2
             + 3 * b * m1)
    nbytes = 4 * (b * m1 + n2) * d + b * (m1 + m2) + 9 * b * m1
    return bound(nbytes, flops)


__all__ = ["knn2", "knn2_ref", "knn2_cost", "rounding_margin", "slices",
           "ROWS", "COLS", "CHUNK", "MAX_D"]
