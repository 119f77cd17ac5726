"""Descriptor matching and RANSAC homographies (counterpart of
``pano360_tpu.match``).

Exact brute-force top-2 matching by L2 distance (one batched matrix
product per chunk of pairs) with Lowe's ratio test, then a
fixed-hypothesis parallel RANSAC: K 4-point samples -> closed-form
homographies -> inlier counts -> argmax, and a weighted DLT +
Gauss-Newton refit on the winning inlier set. Every function is batched
over a leading pair axis B.

Hypothesis draws: ``draws`` (B, K, 4) integers in [0, n_valid) may be
given (the tests inject the JAX package's own draws); otherwise they
come from uniforms of a ``torch.Generator`` on the device, drawn chunk
by chunk in pair order (``match_all_pairs``), so that a process-group
mesh can replay the same sequence on every rank.

``match_all_pairs`` runs the whole graph as steps on static buffers
(``graphs``), on a card replayed from CUDA graphs: the JAX package's one
``lax.map`` over all pairs.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

import torch

from pano360_tpu_torch import graphs, profiling
from pano360_tpu_torch.geometry import inv3x3

LOWE_RATIO = 0.7
N_MIN_MATCH = 8
RANSAC_THRESH = 3.0
RANSAC_ITERS = 2048

DrawFn = Callable[[int, int], torch.Tensor]


class PairMatch(NamedTuple):
    """Results for B ordered pairs (static shapes)."""

    idx: torch.Tensor        # (B, M, 2) indices into (kpts1, kpts2)
    inlier: torch.Tensor     # (B, M) ratio-test pass AND RANSAC inlier
    hom: torch.Tensor        # (B, 3, 3) homography kpts1 -> kpts2
    n_inliers: torch.Tensor  # (B,)
    ok: torch.Tensor         # (B,) >= N_MIN_MATCH ratio matches, valid H


def knn2_matches(desc1, desc2, valid1, valid2, ratio: float = LOWE_RATIO):
    """Top-2 L2 matches of each desc1 row against desc2 (batched over B):
    returns (best_idx (B, M1), good (B, M1))."""
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


def _normalization(pts, w):
    """Hartley similarity from weighted moments: (B, M, 2), (B, M) ->
    (B, 3, 3)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-8)
    mean = torch.sum(pts * w[..., None], dim=-2) / wsum[..., None]
    d = torch.sqrt(torch.sum((pts - mean[..., None, :]) ** 2, dim=-1))
    scale = (2.0 ** 0.5) / torch.clamp(torch.sum(d * w, dim=-1) / wsum,
                                       min=1e-8)
    t = torch.zeros(pts.shape[:-2] + (3, 3), dtype=pts.dtype,
                    device=pts.device)
    t[..., 0, 0] = scale
    t[..., 1, 1] = scale
    t[..., 0, 2] = -scale * mean[..., 0]
    t[..., 1, 2] = -scale * mean[..., 1]
    t[..., 2, 2].fill_(1.0)        # no host tensor: a captured step
    return t


def _dlt_rows(p1, p2):
    """Two DLT rows per correspondence: (B, M, 2) x2 -> (B, 2M, 9)."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], dim=-1)
    return torch.cat([r1, r2], dim=-2)


def _quad_to_basis(q):
    """(..., 4, 2) -> 3x3 map sending the projective basis to the quad."""
    qh = torch.cat([q, torch.ones(q.shape[:-1] + (1,), dtype=q.dtype,
                                  device=q.device)], dim=-1)
    m = qh[..., :3, :].transpose(-1, -2)
    c = torch.matmul(inv3x3(m), qh[..., 3, :, None])[..., 0]
    return m * c[..., None, :]


def hom_from_4pts(p1, p2):
    """Exact homography from 4 correspondences (..., 4, 2), closed form;
    degenerate quads give inf/NaN entries (scored as zero inliers)."""
    a = _quad_to_basis(p1)
    b = _quad_to_basis(p2)
    hom = torch.matmul(b, inv3x3(a))
    z = hom[..., 2, 2]
    z = torch.where(torch.abs(z) > 1e-20, z, torch.inf)
    return hom / z[..., None, None]


def _reproj_errors(hom, p1, p2):
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


def _refit_system(p1, p2, w):
    """The weighted normalized DLT system of ``refit_homography``: ->
    (t1, t2, A^T W A (B, 9, 9), bad (B,)). A pair without inliers has no
    finite system: its homography comes out non-finite, as in the JAX
    package (the caller then keeps the best hypothesis), while the
    decomposition sees the identity (``bad``)."""
    t1 = _normalization(p1, w)
    t2 = _normalization(p2, w)
    n1 = p1 * t1[..., None, 0, 0, None] + t1[..., None, :2, 2]
    n2 = p2 * t2[..., None, 0, 0, None] + t2[..., None, :2, 2]
    rows = _dlt_rows(n1, n2)
    ww = torch.cat([w, w], dim=-1)[..., None]
    ata = torch.matmul(rows.transpose(-1, -2), rows * ww)
    bad = ~torch.isfinite(ata).all(dim=-1).all(dim=-1)
    ata = torch.where(bad[..., None, None],
                      torch.eye(9, dtype=ata.dtype, device=ata.device), ata)
    return t1, t2, ata, bad


def _refit_polish(p1, p2, w, t1, t2, evecs, bad, gn_iters: int = 3):
    """The DLT homography from the system's eigenvectors ``evecs`` (B,
    9, 9), then the Gauss-Newton polish (h33 fixed)."""
    h = evecs[..., :, 0].reshape(evecs.shape[:-2] + (3, 3))
    h = torch.where(bad[..., None, None], torch.nan, h)
    hom = inv3x3(t2) @ h @ t1
    hom = hom / hom[..., 2:3, 2:3]

    x, y = p1[..., 0], p1[..., 1]
    eye8 = torch.eye(8, dtype=p1.dtype, device=p1.device)
    for _ in range(gn_iters):
        hv = (hom / hom[..., 2:3, 2:3]).reshape(hom.shape[:-2] + (9,))
        h0, h1, h2, h3, h4, h5, h6, h7 = (hv[..., i, None] for i in range(8))
        u0 = x * h0 + y * h1 + h2
        u1 = x * h3 + y * h4 + h5
        z = x * h6 + y * h7 + 1.0
        r = torch.stack([(u0 / z - p2[..., 0]) * w,
                         (u1 / z - p2[..., 1]) * w], dim=-1)
        zero = torch.zeros_like(x)
        a, b = x / z * w, y / z * w
        c = w / z
        z2 = z * z
        j0 = torch.stack([a, b, c, zero, zero, zero,
                          -u0 * x / z2 * w, -u0 * y / z2 * w], dim=-1)
        j1 = torch.stack([zero, zero, zero, a, b, c,
                          -u1 * x / z2 * w, -u1 * y / z2 * w], dim=-1)
        jac = torch.stack([j0, j1], dim=-2).reshape(
            x.shape[:-1] + (-1, 8))
        rv = r.reshape(x.shape[:-1] + (-1,))
        jtj = jac.transpose(-1, -2) @ jac + 1e-6 * eye8
        # a system that is singular or not finite (a degenerate pair)
        # keeps the step's input, as the non-finite solution does in the
        # JAX package; torch.linalg.solve would raise for the whole batch
        delta, info = torch.linalg.solve_ex(
            jtj, (jac.transpose(-1, -2) @ rv[..., None])[..., 0])
        new = hv[..., :8] - delta
        newh = torch.cat([new, torch.ones_like(new[..., :1])],
                         dim=-1).reshape(hom.shape)
        okh = torch.isfinite(newh).reshape(newh.shape[:-2] + (9,)).all(-1)
        okh = okh & (info == 0)
        hom = torch.where(okh[..., None, None], newh, hom)
    return hom


def refit_homography(p1, p2, w, gn_iters: int = 3):
    """Weighted normalized DLT + Gauss-Newton polish (h33 fixed) on
    (B, M) weights."""
    t1, t2, ata, bad = _refit_system(p1, p2, w)
    _, evecs = torch.linalg.eigh(ata)
    return _refit_polish(p1, p2, w, t1, t2, evecs, bad, gn_iters)


def _gather_rows(a, idx):
    """a (B, M, C), idx (B, ...) -> (B, ..., C)."""
    b, c = a.shape[0], a.shape[-1]
    flat = idx.reshape(b, -1)
    out = torch.gather(a, 1, flat[..., None].expand(-1, -1, c))
    return out.reshape(idx.shape + (c,))


def _hypotheses(p1, p2, valid, draws, thresh: float):
    """RANSAC's parallel hypotheses over B pairs: -> (the best one (B, 3,
    3), its inlier mask (B, M))."""
    bsz, m = valid.shape
    dev = p1.device
    cum = torch.cumsum(valid.to(torch.int64), dim=-1)
    pos = torch.where(valid, cum - 1, m)
    rank_map = torch.zeros((bsz, m + 1), dtype=torch.int64, device=dev)
    rank_map.scatter_(1, pos, torch.arange(m, device=dev).expand(bsz, m))
    sample_idx = torch.gather(rank_map, 1, draws.reshape(bsz, -1).to(
        torch.int64)).reshape(draws.shape)
    s1 = _gather_rows(p1, sample_idx)                     # (B, K, 4, 2)
    s2 = _gather_rows(p2, sample_idx)
    homs = hom_from_4pts(s1, s2)                          # (B, K, 3, 3)
    errs = _reproj_errors(homs, p1[:, None], p2[:, None])  # (B, K, M)
    inl = (errs < thresh * thresh) & valid[:, None, :]
    finite = torch.isfinite(homs.reshape(homs.shape[:2] + (9,))).all(-1)
    counts = torch.where(finite, inl.sum(-1), 0)
    best = torch.argmax(counts, dim=-1)
    ar = torch.arange(bsz, device=dev)
    return homs[ar, best], inl[ar, best]


def _final_inliers(p1, p2, valid, hom, best_hom, best_inl, thresh: float):
    """The refit's inliers, or the best hypothesis and its inliers where
    the refit is not finite: -> (hom, inlier mask, n_inliers)."""
    final_inl = (_reproj_errors(hom, p1, p2) < thresh * thresh) & valid
    ok = torch.isfinite(hom.reshape(-1, 9)).all(-1)
    hom = torch.where(ok[:, None, None], hom, best_hom)
    final_inl = torch.where(ok[:, None], final_inl, best_inl)
    return hom, final_inl, final_inl.sum(-1)


def ransac_homography(p1, p2, valid, draws,
                      thresh: float = RANSAC_THRESH):
    """Parallel-hypothesis RANSAC over B pairs.

    p1, p2: (B, M, 2) correspondences; valid: (B, M); draws: (B, K, 4)
    ranks in [0, max(n_valid, 1)) among the valid rows. Returns
    (hom (B, 3, 3), inlier mask (B, M), n_inliers (B,)).
    """
    best_hom, best_inl = _hypotheses(p1, p2, valid, draws, thresh)
    hom = refit_homography(p1, p2, best_inl.to(p1.dtype))
    return _final_inliers(p1, p2, valid, hom, best_hom, best_inl, thresh)


def draws_from_uniforms(u: torch.Tensor, n_valid: torch.Tensor):
    """(B, K, 4) uniforms in [0, 1) -> ranks in [0, n_valid)."""
    nv = n_valid.to(torch.float32)[:, None, None]
    return torch.minimum(torch.floor(u * nv).to(torch.int64),
                         n_valid[:, None, None] - 1)


class DrawTable:
    """Recorded RANSAC draws as a picklable ``draw_fn``: ``table[k]`` is
    pair k's (K, 4) draws, made for that pair's ``n_valid`` (the tests
    hand the JAX package's draws to spawned ranks this way)."""

    def __init__(self, table: Dict[int, np.ndarray]):
        self.table = table

    def __call__(self, k: int, n_valid: int) -> torch.Tensor:
        return torch.as_tensor(self.table[k])


def _pair_inputs(kpts, desc, valid, pair_a, pair_b, ratio: float):
    """Top-2 -> ratio test of a chunk of ordered pairs: -> (best_idx (B,
    M), good (B, M), p1, p2 (B, M, 2) correspondences, n_good (B,))."""
    best_idx, good = knn2_matches(desc[pair_a], desc[pair_b], valid[pair_a],
                                  valid[pair_b], ratio)
    p1 = kpts[pair_a].to(torch.float32)
    p2 = _gather_rows(kpts[pair_b].to(torch.float32), best_idx)
    return best_idx, good, p1, p2, good.sum(-1)


def _host_draws(draw_fn: DrawFn, first_pair: int, n_valid: torch.Tensor):
    """``draw_fn``'s (B, K, 4) draws of pairs ``first_pair`` on, made for
    each pair's ``n_valid`` (read on the host)."""
    profiling.count("host_syncs")
    nv = n_valid.tolist()
    return torch.stack([torch.as_tensor(draw_fn(first_pair + j, int(nv[j])))
                        for j in range(len(nv))]).to(n_valid.device)


def _pair_rows(best_idx, good, n_good, hom, inl, n_inl) -> PairMatch:
    ok = ((n_good >= N_MIN_MATCH)
          & torch.isfinite(hom.reshape(-1, 9)).all(-1) & (n_inl >= 4))
    m = best_idx.shape[1]
    ar = torch.arange(m, device=best_idx.device).expand_as(best_idx)
    idx = torch.stack([ar, best_idx], dim=-1)
    return PairMatch(idx=idx, inlier=inl & good, hom=hom, n_inliers=n_inl,
                     ok=ok)


def match_pairs(kpts, desc, valid, pair_a, pair_b, first_pair: int = 0,
                draw_fn: Optional[DrawFn] = None,
                uniforms: Optional[torch.Tensor] = None,
                ratio: float = LOWE_RATIO,
                thresh: float = RANSAC_THRESH) -> PairMatch:
    """Match a chunk of ordered pairs: top-2 -> ratio -> RANSAC.

    kpts/desc/valid: (N, K, ...) feature buffers; pair_a/pair_b: (B,)
    image indices. ``draw_fn(k, n_valid)`` returns pair k's (K, 4) draws
    (k counts from ``first_pair``); else ``uniforms`` (B, K, 4) in [0, 1)
    scale to them.
    """
    best_idx, good, p1, p2, n_good = _pair_inputs(kpts, desc, valid, pair_a,
                                                  pair_b, ratio)
    n_valid = torch.clamp(n_good, min=1)
    if draw_fn is not None:
        draws = _host_draws(draw_fn, first_pair, n_valid)
    else:
        draws = draws_from_uniforms(uniforms, n_valid)
    hom, inl, n_inl = ransac_homography(p1, p2, good, draws, thresh)
    return _pair_rows(best_idx, good, n_good, hom, inl, n_inl)


def match_pairs_batch(kpts, desc, valid, pair_a, pair_b,
                      generator: Optional[torch.Generator] = None,
                      draw_fn: Optional[DrawFn] = None,
                      uniforms: Optional[torch.Tensor] = None,
                      ratio: float = LOWE_RATIO,
                      n_iters: int = RANSAC_ITERS,
                      thresh: float = RANSAC_THRESH) -> PairMatch:
    """``match_pairs`` with the JAX package's argument order: the pairs
    (pair_a[j], pair_b[j]) of the (N, K, ...) buffers. The RANSAC draws
    of pair j are ``draw_fn(j, n_valid)``, or come from ``uniforms`` (P,
    n_iters, 4), or else from ``generator`` (on the buffers' device)."""
    if draw_fn is None and uniforms is None:
        uniforms = torch.rand((len(pair_a), n_iters, 4), generator=generator,
                              device=kpts.device)
    return match_pairs(kpts, desc, valid, pair_a, pair_b, draw_fn=draw_fn,
                       uniforms=uniforms, ratio=ratio, thresh=thresh)


def match_pair(kpts1, desc1, valid1, kpts2, desc2, valid2,
               generator: Optional[torch.Generator] = None,
               draw_fn: Optional[DrawFn] = None,
               uniforms: Optional[torch.Tensor] = None,
               ratio: float = LOWE_RATIO, n_iters: int = RANSAC_ITERS,
               thresh: float = RANSAC_THRESH) -> PairMatch:
    """One pair (unbatched ``PairMatch``): image 1's (M, ...) features
    against image 2's; draws as ``match_pairs_batch``'s (pair 0,
    ``uniforms`` (n_iters, 4)). The shorter buffer is padded with
    invalid rows; rows of image 1 come back as given."""
    m = max(kpts1.shape[0], kpts2.shape[0])

    def pad(*ts):
        return torch.stack([torch.cat([t, t.new_zeros((m - t.shape[0],)
                                                      + t.shape[1:])])
                            for t in ts])
    res = match_pairs_batch(
        pad(kpts1, kpts2), pad(desc1, desc2), pad(valid1, valid2),
        torch.tensor([0], device=kpts1.device),
        torch.tensor([1], device=kpts1.device), generator, draw_fn,
        None if uniforms is None else uniforms[None], ratio, n_iters, thresh)
    n = kpts1.shape[0]
    return PairMatch(res.idx[0, :n], res.inlier[0, :n], res.hom[0],
                     res.n_inliers[0], res.ok[0])


# The match graph as steps on one state (``graphs``): the inputs
# ``kpts``, ``desc``, ``valid``, the pair indices ``pair_a``, ``pair_b``
# and the uniforms ``u`` (P, K, 4); each chunk's intermediates under
# "name.c"; the rows, ``PairMatch``'s fields, at the end. ``eigh`` checks
# its result with a host sync, so it runs eagerly between two captured
# steps, one call per chunk as in a chunk loop (cuSOLVER picks its
# algorithm by the batch size).
_CARRIED = ("best_idx", "good", "n_good", "p1", "p2", "best_hom",
            "best_inl", "w", "t1", "t2", "bad")


def _uniform_draws(first_pair: int, n_valid: torch.Tensor, state: dict):
    return draws_from_uniforms(
        state["u"][first_pair:first_pair + n_valid.shape[0]], n_valid)


def _fn_draws(draw_fn: DrawFn, first_pair: int, n_valid: torch.Tensor,
              state: dict):
    return _host_draws(draw_fn, first_pair, n_valid)


def _hypotheses_step(chunks, draws, state: dict):
    """Each chunk up to the refit's decomposition: top-2 -> ratio ->
    draws -> RANSAC's hypotheses -> the refit's system."""
    for c, (lo, hi) in enumerate(chunks):
        best_idx, good, p1, p2, n_good = _pair_inputs(
            state["kpts"], state["desc"], state["valid"],
            state["pair_a"][lo:hi], state["pair_b"][lo:hi], LOWE_RATIO)
        best_hom, best_inl = _hypotheses(
            p1, p2, good, draws(lo, torch.clamp(n_good, min=1), state),
            RANSAC_THRESH)
        w = best_inl.to(p1.dtype)
        t1, t2, ata, bad = _refit_system(p1, p2, w)
        for k, v in zip(_CARRIED + ("ata",),
                        (best_idx, good, n_good, p1, p2, best_hom, best_inl,
                         w, t1, t2, bad, ata)):
            state[f"{k}.{c}"] = v


def _eigh_step(chunks, state: dict):
    """The refit's decomposition, one ``eigh`` per chunk (its result
    check syncs)."""
    for c in range(len(chunks)):
        profiling.count("host_syncs")
        state[f"evecs.{c}"].copy_(torch.linalg.eigh(state[f"ata.{c}"])[1])


def _rows_step(chunks, state: dict):
    """Each chunk from the decomposition on: the refit's polish -> the
    final inliers -> the pairs' rows, all chunks' in ``state``."""
    rows = []
    for c in range(len(chunks)):
        g = {k: state[f"{k}.{c}"] for k in _CARRIED}
        hom = _refit_polish(g["p1"], g["p2"], g["w"], g["t1"], g["t2"],
                            state[f"evecs.{c}"], g["bad"])
        hom, inl, n_inl = _final_inliers(g["p1"], g["p2"], g["good"], hom,
                                         g["best_hom"], g["best_inl"],
                                         RANSAC_THRESH)
        rows.append(_pair_rows(g["best_idx"], g["good"], g["n_good"], hom,
                               inl, n_inl))
    state.update(zip(PairMatch._fields, (torch.cat(ts) for ts in zip(*rows))))


def _graph_state(kpts, desc, valid, pairs, chunks) -> dict:
    """The state of the steps over ``chunks`` of ``pairs``."""
    dev = kpts.device
    ab = graphs.upload(np.asarray(pairs, np.int64).reshape(-1, 2).T, dev)
    state = dict(kpts=kpts, desc=desc, valid=valid, pair_a=ab[0],
                 pair_b=ab[1], u=torch.empty((len(pairs), RANSAC_ITERS, 4),
                                             device=dev))
    for c, (lo, hi) in enumerate(chunks):
        state[f"evecs.{c}"] = torch.empty((hi - lo, 9, 9), device=dev)
    return state


def _graph_steps(chunks, draws):
    return (partial(_hypotheses_step, chunks, draws),
            partial(_eigh_step, chunks), partial(_rows_step, chunks))


def _replayed_graph(kpts, desc, valid, pairs, chunks):
    """-> (static state, steps): the first and last step replayed from
    CUDA graphs in the process's pool, ``eigh`` between them eager."""
    state = _graph_state(torch.empty_like(kpts), torch.empty_like(desc),
                         torch.empty_like(valid), pairs, chunks)
    hyp, eig, rows = _graph_steps(chunks, _uniform_draws)
    pool = graphs.PROGRAMS.pool
    return state, (graphs.Replayed(hyp, state, pool), partial(eig, state),
                   graphs.Replayed(rows, state, pool))


def match_all_pairs(kpts, desc, valid, pairs: List[Tuple[int, int]],
                    batch: int, generator: Optional[torch.Generator] = None,
                    draw_fn: Optional[DrawFn] = None, mesh=None,
                    capture: bool = True) -> PairMatch:
    """Every pair of ``pairs`` in chunks of ``batch``: -> ``PairMatch``
    of host (numpy) arrays, one row per pair, copied in one host read.

    The generator draws each chunk's uniforms in chunk order. The chunks
    run as three steps on one state: up to the refit's decomposition,
    ``eigh``, and the rest. On a card, without a mesh or a ``draw_fn``,
    the first and the last are captured as CUDA graphs once per process
    and key (the shapes, ``batch`` and ``pairs``) and replayed: the
    counterpart of the JAX package's one ``lax.map`` over all pairs.
    ``capture=False`` runs the same steps eagerly (the CPU's, the
    mesh's and ``draw_fn``'s path). With a ``mesh``
    (``parallel.mesh.Mesh``) each rank runs a contiguous block of whole
    chunks and draws every chunk's uniforms, so a pair gets the same
    draws and the same result on any rank; the rows are gathered in rank
    order (chunk order) onto every rank."""
    dev = kpts.device
    chunks = [(lo, min(lo + batch, len(pairs)))
              for lo in range(0, len(pairs), batch)]
    mine = chunks if mesh is None else mesh.block(chunks)
    if not mine:
        m = kpts.shape[1]
        rows = PairMatch(torch.zeros((0, m, 2), dtype=torch.int64, device=dev),
                         torch.zeros((0, m), dtype=torch.bool, device=dev),
                         torch.zeros((0, 3, 3), device=dev),
                         torch.zeros((0,), dtype=torch.int64, device=dev),
                         torch.zeros((0,), dtype=torch.bool, device=dev))
    else:
        if capture and dev.type == "cuda" and mesh is None \
                and draw_fn is None:
            key = ("match", kpts.shape, desc.shape, desc.dtype, batch,
                   tuple(pairs), dev)
            state, steps = graphs.PROGRAMS.get(key, partial(
                _replayed_graph, kpts, desc, valid, pairs, chunks))
            for k, t in (("kpts", kpts), ("desc", desc), ("valid", valid)):
                state[k].copy_(t)
        else:
            state = _graph_state(kpts, desc, valid, pairs, mine)
            draws = (_uniform_draws if draw_fn is None
                     else partial(_fn_draws, draw_fn))
            steps = [partial(f, state) for f in _graph_steps(mine, draws)]
        if draw_fn is None:
            for lo, hi in chunks:
                state["u"][lo:hi].uniform_(generator=generator)
        for step in steps:
            step()
        rows = PairMatch(*(state[f] for f in PairMatch._fields))
    if mesh is not None:        # only the last chunk, the last rows, is short
        per = mesh.per(len(chunks)) * batch
        rows = PairMatch(*[mesh.gather_rows(t, len(pairs), per)
                           for t in rows])
    return PairMatch(*graphs.to_host(*rows))


__all__ = ["PairMatch", "knn2_matches", "hom_from_4pts", "refit_homography",
           "ransac_homography", "draws_from_uniforms",
           "DrawTable", "match_pair", "match_pairs", "match_pairs_batch",
           "match_all_pairs",
           "LOWE_RATIO", "N_MIN_MATCH", "RANSAC_THRESH", "RANSAC_ITERS"]
