"""Panorama registration: traverse + incremental LM bundle adjustment
(counterpart of ``pano360_tpu.register``).

The best-first heap walk over the match graph runs on the host and fixes
the order of adds up front (it depends only on match scores). The
numbers then run as a PyTorch loop on the device: seed each new camera
from its pair homography, gate its edges by initial RMSE (< 150), run
the fixed-lambda LM (lambda 5, at most 100 iterations, accept only on a
1e-3 RMSE gain, stop at the first rejection), then an adaptive-damping
polish, the median Szeliski-Shum focal and straightening.

Jacobians are written analytically: each edge's homography H(pa, pb)
has a closed-form derivative (E x 9 x 12 numbers, ``_edge_hom_jac``),
the per-point derivative of the projected residual w.r.t. H is written
out, and the normal equations are assembled as dH/dp^T (sum over
points) dH/dp per edge. (``torch.func.jacfwd`` computes the same numbers
but measured ~10 s on its first call and ~20 ms a call after that on an
H100; PERF.md.)
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pano360_tpu_torch import geometry as geo

LM_LAMBDA = 5.0
LM_MAX_ITER = 100
LM_MIN_IMPROVE = 1e-3
MIN_MATCH_ERROR = 150.0
POLISH_MAX_ITER = 150
POLISH_MAX_REJECTS = 12


@dataclasses.dataclass
class PanoImage:
    """Host-side registered image (the BA cache's record)."""

    img: Optional[np.ndarray]
    rot: np.ndarray
    intr: np.ndarray
    range: tuple = (np.zeros(2), np.zeros(2))

    def hom(self) -> np.ndarray:
        """Pixel -> world-ray homography R^T K^-1."""
        return self.rot.T.dot(np.linalg.inv(self.intr))

    def proj(self) -> np.ndarray:
        """World-ray -> pixel projection K R."""
        return self.intr.dot(self.rot)


def _np_exp_so3(rad: np.ndarray) -> np.ndarray:
    ang = np.linalg.norm(rad)
    if ang < 1e-12:
        return np.eye(3)
    x, y, z = rad / ang
    cross = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return np.eye(3) + np.sin(ang) * cross + (1 - np.cos(ang)) * cross @ cross


def _np_camera_from_params(p: np.ndarray) -> PanoImage:
    intr = np.array([[p[0], 0, p[1]], [0, p[0], p[2]], [0, 0, 1.0]])
    return PanoImage(None, _np_exp_so3(p[3:6]), intr)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., i, k) @ (..., k, j), broadcast, as one product and a left
    fold over k of elementwise adds. Every output then depends on its own
    operands only, so an edge's bits do not change with the rows computed
    beside it: on the card a batched GEMM's kernel and a reduction's split
    follow the shape they are given."""
    p = a[..., :, :, None] * b[..., None, :, :]
    out = p[..., 0, :]
    for k in range(1, p.shape[-2]):
        out = out + p[..., k, :]
    return out


def _tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` (a power-of-two length) by pairwise halving adds:
    elementwise, as ``_mm``."""
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.squeeze(dim)


def _dk(dtype, device) -> torch.Tensor:
    """dK / d(f, cx, cy): three constant basis matrices, (3, 3, 3)."""
    dk = torch.zeros((3, 3, 3), dtype=dtype, device=device)
    dk[0, 0, 0] = dk[0, 1, 1] = 1.0
    dk[1, 0, 2] = 1.0
    dk[2, 1, 2] = 1.0
    return dk


def _exp_so3_jac(rad: torch.Tensor) -> torch.Tensor:
    """dR/dr_i of ``geo.exp_so3`` = I + a K + b K^2: (..., 3) -> (..., 3
    [i], 3, 3). With c1 = a'(t)/t and c2 = b'(t)/t,
    dR_i = c1 r_i K + a [e_i]x + c2 r_i K^2 + b ([e_i]x K + K [e_i]x);
    below t^2 = 1e-2 the coefficients come from their Taylor series."""
    t2 = torch.sum(rad * rad, dim=-1)[..., None, None, None]
    small = t2 < 1e-12
    series = t2 < 1e-2
    one = torch.ones_like(t2)
    t = torch.sqrt(torch.where(small, one, t2))
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2)
    safe = torch.where(series, one, t2)
    c1 = torch.where(series, -1 / 3 + t2 / 30 - t2 * t2 / 840,
                     (torch.cos(t) - a) / safe)
    c2 = torch.where(series, -1 / 12 + t2 / 180 - t2 * t2 / 6720,
                     (a - 2 * b) / safe)
    k = geo.cross_mat(rad)[..., None, :, :]                   # (..., 1, 3, 3)
    ei = geo.cross_mat(torch.eye(3, dtype=rad.dtype, device=rad.device))
    r = rad[..., :, None, None]                               # (..., 3, 1, 1)
    return (c1 * r * k + a * ei + c2 * r * (k @ k)
            + b * (ei @ k + k @ ei))


def _camera_terms(params: torch.Tensor, dk: Optional[torch.Tensor] = None):
    """Per-camera factors of the edge homographies H = K_a R_a R_b^T
    K_b^-1 for (C, 6) params: ``proj`` K R and ``back`` R^T K^-1 (C, 3,
    3); with ``dk`` (``_dk``) also those of their derivatives: ``rot`` R,
    ``k_dr`` K dR/dr_i, ``drt_kinv`` dR/dr_i^T K^-1 and ``dk_kinv``
    dK/d(f, cx, cy) K^-1 (C, 3, 3, 3). A dict of tensors indexed by
    camera first."""
    cam = geo.params_to_camera(params)
    kinv = geo.inv3x3(cam.intr)
    out = dict(proj=geo.mm(cam.intr, cam.rot),
               back=geo.mm(cam.rot.transpose(-1, -2), kinv))
    if dk is not None:
        d_rot = _exp_so3_jac(params[..., 3:6])
        out.update(rot=cam.rot, k_dr=geo.mm(cam.intr[..., None, :, :], d_rot),
                   drt_kinv=geo.mm(d_rot.transpose(-1, -2),
                                   kinv[..., None, :, :]),
                   dk_kinv=geo.mm(dk, kinv[..., None, :, :]))
    return out


def _rows(terms: dict, idx: torch.Tensor) -> dict:
    """The cameras ``idx`` of ``_camera_terms``' result."""
    return {k: v[idx] for k, v in terms.items()}


def _hom(ca: dict, cb: dict) -> torch.Tensor:
    """Homographies mapping camera b's pixels into camera a's, from the
    ``_camera_terms`` rows of each edge's two cameras: (E, 3, 3)."""
    return _mm(ca["proj"], cb["back"])


def _hom_jac(ca: dict, cb: dict, hom: torch.Tensor, dk: torch.Tensor):
    """dH/dpa, dH/dpb of ``_hom``: two (E, 9, 6). With K = [[f, 0, cx],
    [0, f, cy], [0, 0, 1]], dK/d(f, cx, cy) are constant basis matrices
    and d(K^-1) = -K^-1 dK K^-1, so dH/d(K_b) = -H dK K_b^-1."""
    da_k = _mm(dk, _mm(ca["rot"], cb["back"])[:, None])      # (E, 3, 3, 3)
    da_r = _mm(ca["k_dr"], cb["back"][:, None])
    db_k = -_mm(hom[:, None], cb["dk_kinv"])
    db_r = _mm(ca["proj"][:, None], cb["drt_kinv"])
    e = hom.shape[0]
    ja = torch.cat([da_k, da_r], dim=1).reshape(e, 6, 9).transpose(1, 2)
    jb = torch.cat([db_k, db_r], dim=1).reshape(e, 6, 9).transpose(1, 2)
    return ja, jb


def _edge_hom(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """Homography mapping camera b's pixels into camera a's (batched)."""
    return _hom(_camera_terms(pa), _camera_terms(pb))


def _edge_hom_jac(pa: torch.Tensor, pb: torch.Tensor):
    """dH/dpa, dH/dpb of ``_edge_hom`` for (E, 6) params: two (E, 9, 6)."""
    dk = _dk(pa.dtype, pa.device)
    ca, cb = _camera_terms(pa, dk), _camera_terms(pb, dk)
    return _hom_jac(ca, cb, _hom(ca, cb), dk)


class Problem:
    """The bundle-adjustment problem: E edges of M padded match points.

    ``pts`` (E, M, 6): [x_a, y_a, 1, x_b, y_b, 1] per match (camera a =
    ``cam1``, b = ``cam2``); ``mask`` (E, M) 0/1.

    Every quantity is reduced in two stages: per-edge terms first (the
    residual sums, the 6x6 blocks and 6-vectors of the normal equations),
    then one reduction over the E edges. The per-edge terms come from
    per-camera factors (``_camera_terms``, over all C cameras) by
    elementwise operations only (``_mm``, ``_tree_sum`` over the points,
    padded to a power of two with masked points): an edge's terms have
    the same bits whichever edges are computed beside it. With a ``mesh``
    (``parallel.mesh.Mesh``) each rank holds a contiguous shard of ceil(E
    / size) edges (the last padded with all-masked edges) and computes
    the per-edge terms of its shard; they are gathered and the second
    stage runs on every rank as on one process, so every rank takes the
    one process's LM steps. ``mask`` arguments of the methods are
    shard-local (``local`` takes a global per-edge vector to the shard).
    """

    def __init__(self, cam1, cam2, pts, mask, n_cams: int, mesh=None):
        self.mesh = mesh
        e, m = int(cam1.shape[0]), int(pts.shape[1])
        self.n_edges = e
        eye = torch.eye(n_cams, dtype=pts.dtype, device=pts.device)
        self.sel1, self.sel2 = eye[cam1], eye[cam2]      # (E, C) one-hot
        size, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
        per = -(-e // size)                               # edges per shard
        p2 = 1 << max(m - 1, 0).bit_length()
        full = torch.zeros((per * size, p2, 6), dtype=pts.dtype,
                           device=pts.device)
        full[..., 2] = full[..., 5] = 1.0    # benign homogeneous padding
        full[:e, :m] = pts
        fmask = mask.new_zeros((per * size, p2))
        fmask[:e, :m] = mask
        self.lo = rank * per
        sl = slice(self.lo, self.lo + per)
        self.cam1, self.cam2 = (torch.cat([c, c.new_zeros(per * size - e)])[sl]
                                for c in (cam1, cam2))
        self.pts, self.mask = full[sl], fmask[sl]
        self.dk = _dk(pts.dtype, pts.device)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """A global per-edge (E, ...) tensor -> this shard's rows."""
        rows = t[self.lo:self.lo + self.cam1.shape[0]]
        short = self.cam1.shape[0] - rows.shape[0]
        return torch.cat([rows, rows.new_zeros((short,) + rows.shape[1:])])

    def _gather(self, rows: torch.Tensor) -> torch.Tensor:
        """This shard's per-edge rows -> all E edges' rows, on every rank."""
        if self.mesh is None:
            return rows
        return self.mesh.gather_rows(rows, self.n_edges)

    def _residuals(self, ca: dict, cb: dict, mask):
        """The shard's homographies (S, 3, 3), masked residuals (S, P, 2),
        projections (S, P, 3) and their guarded depth (S, P)."""
        hom = _hom(ca, cb)
        u = _mm(self.pts[..., None, 3:6],
                hom.transpose(-1, -2)[:, None])[..., 0, :]
        z = torch.where(torch.abs(u[..., 2]) > 1e-12, u[..., 2], 1.0)
        res = (self.pts[..., :2] - u[..., :2] / z[..., None]) * mask[..., None]
        return hom, res, u, z

    def edge_sums(self, params, mask):
        """Per-edge squared residual sums and match counts: two (E,)."""
        terms = _camera_terms(params)
        _, res, _, _ = self._residuals(_rows(terms, self.cam1),
                                       _rows(terms, self.cam2), mask)
        sq = res[..., 0] * res[..., 0] + res[..., 1] * res[..., 1]
        sums = self._gather(torch.stack([_tree_sum(sq, 1),
                                         _tree_sum(mask, 1)], dim=1))
        return sums[:, 0], sums[:, 1]

    def loss(self, params, mask) -> torch.Tensor:
        sq, cnt = self.edge_sums(params, mask)
        return torch.sqrt(torch.sum(sq)
                          / torch.clamp(2.0 * torch.sum(cnt), min=1.0))

    def edge_rmse(self, params) -> torch.Tensor:
        sq, cnt = self.edge_sums(params, self.mask)
        return torch.sqrt(sq / torch.clamp(2.0 * cnt, min=1.0))

    def _edge_terms(self, params, mask) -> torch.Tensor:
        """The shard's per-edge (S, 120): J_a^T J_a, J_b^T J_b, J_a^T J_b
        (6x6 each) and J_a^T r, J_b^T r."""
        terms = _camera_terms(params, self.dk)
        ca, cb = _rows(terms, self.cam1), _rows(terms, self.cam2)
        hom, res, u, z = self._residuals(ca, cb, mask)
        q = self.pts[..., 3:6]
        guard = (torch.abs(u[..., 2]) > 1e-12).to(q.dtype)
        w = mask[..., None]
        # d res_r / d H (row-major 9-vector): -q / z at H's row r, u_r q /
        # z^2 at its row 2, i.e. [a, 0, c_0] and [0, a, c_1]
        a = -q * (1.0 / z)[..., None] * w
        zz = (guard / (z * z))[..., None]
        c0 = u[..., 0:1] * q * zz * w
        c1 = u[..., 1:2] * q * zz * w
        r0, r1 = res[..., 0:1], res[..., 1:2]

        def outer(x, y):
            return (x[..., :, None] * y[..., None, :]).flatten(-2)
        sums = _tree_sum(torch.cat([
            outer(a, a), outer(a, c0), outer(a, c1),
            outer(c0, c0) + outer(c1, c1),
            a * r0, a * r1, c0 * r0 + c1 * r1], dim=-1), 1)    # (S, 45)
        aa, ac0, ac1, cc = (sums[:, 9 * i:9 * (i + 1)].reshape(-1, 3, 3)
                            for i in range(4))
        zero = torch.zeros_like(aa)
        gram = torch.cat([torch.cat([aa, zero, ac0], -1),
                          torch.cat([zero, aa, ac1], -1),
                          torch.cat([ac0.transpose(1, 2),
                                     ac1.transpose(1, 2), cc], -1)], 1)
        ja, jb = _hom_jac(ca, cb, hom, self.dk)
        jac = torch.cat([ja, jb], dim=-1)                      # (S, 9, 12)
        jt = jac.transpose(1, 2)
        jtgj = _mm(jt, _mm(gram, jac))                         # (S, 12, 12)
        jtr = _mm(jt, sums[:, 36:45, None])[..., 0]            # (S, 12)
        s = jtgj.shape[0]
        return torch.cat([jtgj[:, :6, :6].reshape(s, 36),
                          jtgj[:, 6:, 6:].reshape(s, 36),
                          jtgj[:, :6, 6:].reshape(s, 36), jtr], dim=1)

    def normal_equations(self, params, mask):
        """(J^T J (6C, 6C), J^T r (6C,)) of the masked problem."""
        c = params.shape[0]
        terms = self._gather(self._edge_terms(params, mask))
        jaa, jbb, jab = (terms[:, 36 * i:36 * (i + 1)].reshape(-1, 6, 6)
                         for i in range(3))
        ra, rb = terms[:, 108:114], terms[:, 114:120]
        s1, s2 = self.sel1, self.sel2
        blocks = (torch.einsum("ea,eb,eij->aibj", s1, s1, jaa)
                  + torch.einsum("ea,eb,eij->aibj", s2, s2, jbb)
                  + torch.einsum("ea,eb,eij->aibj", s1, s2, jab)
                  + torch.einsum("ea,eb,eji->aibj", s2, s1, jab))
        jtr = (torch.einsum("ea,ei->ai", s1, ra)
               + torch.einsum("ea,ei->ai", s2, rb))
        return blocks.reshape(6 * c, 6 * c), jtr.reshape(-1)


def _damped_step(jtj, jtr, lam: float, shape):
    """Jacobi-preconditioned solve of (J^T J + lam I) delta = J^T r."""
    a = jtj + lam * torch.eye(jtj.shape[0], dtype=jtj.dtype,
                              device=jtj.device)
    d = torch.rsqrt(torch.diagonal(a) + 1e-12)
    # a singular system yields a non-finite step whose loss is rejected,
    # as jnp.linalg.solve's does in the JAX package
    delta, _ = torch.linalg.solve_ex(a * d[:, None] * d[None, :], jtr * d)
    return (delta * d).reshape(shape)


def lm_core(params, prob: Problem, mask, max_iter: int = LM_MAX_ITER):
    """Fixed-lambda LM; with rollback-on-reject the state after the first
    rejection is frozen, so the loop stops there (the JAX package's
    ``_lm_core`` schedule). Returns the best params and the number of
    iterations run (the rejected one included)."""
    best = params
    best_err = np.float32(prob.loss(params, mask).item())
    n_iter = 0
    for _ in range(max_iter):
        n_iter += 1
        jtj, jtr = prob.normal_equations(best, mask)
        trial = best - _damped_step(jtj, jtr, LM_LAMBDA, best.shape)
        err = np.float32(prob.loss(trial, mask).item())
        # f32 threshold arithmetic, as on the device in the JAX package
        if not err < best_err - np.float32(LM_MIN_IMPROVE):
            break
        best, best_err = trial, err
    return best, n_iter


def lm_polish(params, prob: Problem, mask):
    """Adaptive-damping LM past the fixed-lambda stop: halve lambda on
    accept, 4x on reject, stop after 12 consecutive rejects. Returns the
    best params and the number of iterations run."""
    best = params
    best_err = np.float32(prob.loss(params, mask).item())
    lam = np.float32(LM_LAMBDA)
    rejects = 0
    n_iter = 0
    for _ in range(POLISH_MAX_ITER):
        if rejects >= POLISH_MAX_REJECTS:
            break
        n_iter += 1
        jtj, jtr = prob.normal_equations(best, mask)
        trial = best - _damped_step(jtj, jtr, float(lam), best.shape)
        err = np.float32(prob.loss(trial, mask).item())
        if err < best_err:
            best, best_err = trial, err
            lam, rejects = lam * np.float32(0.5), 0
        else:
            lam, rejects = lam * np.float32(4.0), rejects + 1
        lam = np.float32(np.clip(lam, np.float32(1e-5), np.float32(1e6)))
    return best, n_iter


def traverse(imgs: List[np.ndarray], matches: Dict, badjust: str = "incr",
             use_straighten: bool = True, polish: bool = True,
             device="cuda", stats=None, mesh=None) -> List[PanoImage]:
    """Best-first expansion over the match graph + bundle adjustment.

    ``matches[i][j] = (kpt_pairs (M, 6), hom, n_inliers)`` (the cache's
    rehydrated form). ``badjust``: ``incr`` (LM after every add),
    ``last`` (one LM at the end) or ``none``. ``stats``: an optional dict
    that receives the initial focal (``focal0``), the number of edges
    (``ba_edges``) and of those that passed the RMSE gate
    (``ba_edges_enabled``), the largest edge (``ba_edge_points``) and the
    LM iterations run (``lm_iterations``, one count per optimisation,
    and ``polish_iterations``). ``mesh`` (``parallel.mesh.Mesh``): the
    edges of the problem are sharded over the ranks (``Problem``); every
    rank returns the same cameras, and runs on ``mesh.device``.
    """
    if badjust not in ("incr", "last", "none"):
        raise ValueError(f"badjust {badjust!r}")
    device = torch.device(device if mesh is None else mesh.device)
    pair_list = [(i, matches[i][j][1], matches[i][j][2])
                 for i in matches.keys() for j in matches[i].keys()]
    if not pair_list:
        return []
    ids, homs_all, scores = zip(*pair_list)
    src = ids[int(np.argmax(scores))]

    placed = {src}
    adds: List[Tuple[int, int, np.ndarray]] = []
    edges: List[Tuple[int, int, np.ndarray, int]] = []
    qq = [(-matches[src][j][2], src, j) for j in matches[src].keys()]
    heapq.heapify(qq)
    while qq:
        _, src_i, dst = heapq.heappop(qq)
        if dst in placed:
            continue
        k = len(adds)
        adds.append((dst, src_i, matches[src_i][dst][1]))
        for other in range(len(imgs)):
            if other in placed and other in matches.get(dst, {}):
                edges.append((dst, other, matches[dst][other][0], k))
        placed.add(dst)
        for new in matches[dst].keys():
            heapq.heappush(qq, (-matches[dst][new][2], dst, new))

    n = len(imgs)
    f32 = torch.float32
    mp = max((m.shape[0] for _, _, m, _ in edges), default=1)
    ne = max(len(edges), 1)
    pts = np.zeros((ne, mp, 6), np.float32)
    pts[..., 2] = 1.0    # benign homogeneous padding
    pts[..., 5] = 1.0
    mask = np.zeros((ne, mp), np.float32)
    cam1 = np.zeros(ne, np.int64)
    cam2 = np.zeros(ne, np.int64)
    edge_add = np.full(ne, -1, np.int64)
    for e, (c1, c2, m, k) in enumerate(edges):
        cam1[e], cam2[e], edge_add[e] = c1, c2, k
        pts[e, :len(m)] = m
        mask[e, :len(m)] = 1.0
    tt = dict(device=device)
    prob = Problem(torch.as_tensor(cam1, **tt), torch.as_tensor(cam2, **tt),
                   torch.as_tensor(pts, **tt), torch.as_tensor(mask, **tt),
                   n, mesh)
    edge_add_t = torch.as_tensor(edge_add, **tt)

    homs_t = torch.as_tensor(np.stack(homs_all).astype(np.float32), **tt)
    focal = torch.quantile(geo.focal_from_hom(homs_t), 0.5)
    intr = geo.intrinsics(focal)
    kinv = geo.inv3x3(intr)
    lead = torch.stack([intr[0, 0], intr[0, 2], intr[1, 2]])
    params = torch.zeros((n, 6), dtype=f32, device=device)
    params[:, 0] = 1.0
    params[src] = 0.0
    params[src, :3] = lead
    enabled = torch.zeros(ne, dtype=torch.bool, device=device)
    lm_iters, polish_iters = [], 0
    for k, (dst, src_i, hom) in enumerate(adds):
        r_src = geo.exp_so3(params[src_i, 3:6])
        hom_t = torch.as_tensor(np.asarray(hom, np.float32), **tt)
        r_rel = geo.nearest_rotation(geo.mm(geo.mm(kinv, hom_t), intr))
        params = params.clone()
        params[dst] = torch.cat([lead, geo.log_so3(geo.mm(r_rel, r_src))])
        rmse = prob.edge_rmse(params)
        enabled = enabled | ((edge_add_t == k) & (rmse < MIN_MATCH_ERROR))
        if badjust == "incr":
            params, it = lm_core(params, prob,
                                 prob.mask * prob.local(enabled)[:, None])
            lm_iters.append(it)
    emask = prob.mask * prob.local(enabled)[:, None]
    if badjust == "last":
        params, it = lm_core(params, prob, emask)
        lm_iters.append(it)
    if polish and badjust != "none":
        params, polish_iters = lm_polish(params, prob, emask)
    if stats is not None:
        stats.update(focal0=float(focal), ba_edges=len(edges),
                     ba_edges_enabled=int(enabled.sum()),
                     ba_edge_points=mp, lm_iterations=lm_iters,
                     polish_iterations=polish_iters)
    placed_idx = torch.as_tensor(sorted(placed), **tt)
    if use_straighten:
        rots = geo.exp_so3(params[placed_idx, 3:6])
        params = params.clone()
        params[placed_idx, 3:6] = geo.log_so3(geo.straighten(rots))
    params = params.cpu().numpy().astype(np.float64)

    cameras: List[Optional[PanoImage]] = [None] * n
    for i in sorted(placed):
        cam = _np_camera_from_params(params[i])
        cam.img = imgs[i]
        cameras[i] = cam
    return [c for c in cameras if c is not None]


__all__ = ["PanoImage", "traverse", "Problem", "lm_core", "lm_polish",
           "LM_LAMBDA", "LM_MAX_ITER", "MIN_MATCH_ERROR"]
