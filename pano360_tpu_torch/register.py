"""Panorama registration: traverse + incremental LM bundle adjustment
(counterpart of ``pano360_tpu.register``).

The best-first heap walk over the match graph runs on the host and fixes
the order of adds up front (it depends only on match scores); the
schedule is uploaded once. The numbers then run on the device: seed each
new camera from its pair homography, gate its edges by initial RMSE (<
150), run the fixed-lambda LM (lambda 5, at most 100 iterations, accept
only on a 1e-3 RMSE gain, stop at the first rejection), then an
adaptive-damping polish, the median Szeliski-Shum focal and
straightening. The LM loops keep their state and their stop flag on the
device (``lm_step``, ``polish_step``); a host loop (``drive``) runs
them in chunks and reads the flag once per chunk, and on a card each
step is one CUDA graph replayed (the JAX package's ``_traverse_impl``
runs the same schedule as one XLA program with ``while_loop``s; PyTorch
2.11 captures no device-side loop in eager mode).

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
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pano360_tpu_torch import geometry as geo
from pano360_tpu_torch import profiling
from pano360_tpu_torch.graphs import Replayed, upload as _upload
from pano360_tpu_torch import resolve_device

PARAMS_PER_CAMERA = geo.PARAMS_PER_CAMERA
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


def _dk(dtype, device) -> torch.Tensor:
    """dK / d(f, cx, cy): three constant basis matrices, (3, 3, 3)."""
    dk = torch.zeros((3, 3, 3), dtype=dtype, device=device)
    for i, r, c in ((0, 0, 0), (0, 1, 1), (1, 0, 2), (2, 1, 2)):
        dk[i, r, c].fill_(1.0)      # a kernel, not a copy from the host
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
    elementwise operations only (``_mm``, ``geo.tree_sum`` over the points,
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
        sums = self._gather(torch.stack([geo.tree_sum(sq, 1),
                                         geo.tree_sum(mask, 1)], dim=1))
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
        sums = geo.tree_sum(torch.cat([
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


def _damped_step(jtj, jtr, lam, shape):
    """Jacobi-preconditioned solve of (J^T J + lam I) delta = J^T r;
    ``lam`` a number or a 0-d tensor."""
    a = jtj + lam * torch.eye(jtj.shape[0], dtype=jtj.dtype,
                              device=jtj.device)
    d = torch.rsqrt(torch.diagonal(a) + 1e-12)
    # a singular system yields a non-finite step whose loss is rejected,
    # as jnp.linalg.solve's does in the JAX package
    delta, _ = torch.linalg.solve_ex(a * d[:, None] * d[None, :], jtr * d)
    return (delta * d).reshape(shape)


# The LM loops keep their whole state on the device, in a dict of
# tensors: ``best`` (C, 6), ``mask`` the problem's (S, P) mask, ``err``
# the loss of ``best`` and ``lam`` the damping (0-d, params' dtype), and
# ``ctr`` (3,) int32 = [iterations run, stalls (LM) or consecutive
# rejects (polish), stopped]. A step reads and writes the state in place
# with no host sync; once ``stopped`` is set a step changes nothing, so a
# host loop may run several steps between reads of ``ctr``.

def _lm_state(params, prob: Problem, mask) -> dict:
    return dict(best=params.clone(), mask=mask, err=prob.loss(params, mask),
                lam=torch.full((), LM_LAMBDA, dtype=params.dtype,
                               device=params.device),
                ctr=torch.zeros(3, dtype=torch.int32, device=params.device))


def _lm_restart(prob: Problem, state: dict):
    """Start another loop from ``state['best']`` on ``state['mask']``."""
    state["err"].copy_(prob.loss(state["best"], state["mask"]))
    state["lam"].fill_(LM_LAMBDA)
    state["ctr"].zero_()


def _trial(prob: Problem, state: dict):
    """The damped Gauss-Newton trial from ``best`` and its loss."""
    best, mask = state["best"], state["mask"]
    jtj, jtr = prob.normal_equations(best, mask)
    trial = best - _damped_step(jtj, jtr, state["lam"], best.shape)
    return trial, prob.loss(trial, mask)


def _accept(state: dict, improved, trial, err):
    state["best"].copy_(torch.where(improved, trial, state["best"]))
    state["err"].copy_(torch.where(improved, err, state["err"]))


def lm_step(prob: Problem, state: dict, max_iter: int = LM_MAX_ITER):
    """One fixed-lambda iteration (the JAX package's ``_lm_core`` body):
    accept on a loss gain above 1e-3, in the loss's dtype on the device;
    with rollback on reject the state after the first rejection is frozen,
    so the loop stops there (``_lm_core``'s ``stalls < 1``)."""
    trial, err = _trial(prob, state)
    ctr = state["ctr"]
    run = ctr[2] == 0
    improved = run & (err < state["err"] - LM_MIN_IMPROVE)
    _accept(state, improved, trial, err)
    it = ctr[0] + run.int()
    stalls = ctr[1] + (run & ~improved).int()
    stop = ~improved | (it >= max_iter)
    ctr.copy_(torch.stack([it, stalls, stop.int()]))


def polish_step(prob: Problem, state: dict, max_iter: int = POLISH_MAX_ITER):
    """One adaptive-damping iteration (``_lm_polish``'s body): halve
    lambda on accept, 4x on reject, clipped to [1e-5, 1e6]; stop after
    ``POLISH_MAX_REJECTS`` consecutive rejects or ``max_iter``."""
    trial, err = _trial(prob, state)
    ctr, lam = state["ctr"], state["lam"]
    run = ctr[2] == 0
    improved = run & (err < state["err"])
    _accept(state, improved, trial, err)
    lam.copy_(torch.where(run, torch.clamp(
        torch.where(improved, lam * 0.5, lam * 4.0), 1e-5, 1e6), lam))
    it = ctr[0] + run.int()
    rejects = torch.where(run, torch.where(improved, 0, ctr[1] + 1), ctr[1])
    stop = ~run | (rejects >= POLISH_MAX_REJECTS) | (it >= max_iter)
    ctr.copy_(torch.stack([it, rejects, stop.int()]))


# Steps between host reads of ``ctr`` (a function of the counters read).
# A step after the stop is masked but still costs a whole step of device
# time (1.0-2.1 ms on an H100 at 23-309 edges, PERF.md), where a read
# only waits for the device to drain, so a chunk is what is sure or
# likely to run: an add's LM ran 2-11 iterations (never fewer than 2 in
# PERF.md's worlds), so 2 before the first read and 1 after; the polish
# stops only after 12 consecutive rejects, so the steps up to that are
# certain.

def _lm_chunk(it: int, stalls: int) -> int:
    return 2 if it == 0 else 1


def _polish_chunk(it: int, rejects: int) -> int:
    return POLISH_MAX_REJECTS - rejects


def drive(step, ctr, chunk) -> int:
    """Run ``step()`` until ``ctr`` (the loop state's counters) says
    stopped, ``chunk(iterations, count)`` steps between host reads of
    the counters: the one host sync of each chunk. -> the iterations
    run."""
    n = chunk(0, 0)
    while True:
        for _ in range(n):
            step()
        profiling.count("host_syncs")
        it, count, stopped = ctr.tolist()
        if stopped:
            return it
        n = chunk(it, count)


def _every(k: int):
    return lambda it, count: k


def lm_core(params, prob: Problem, mask, max_iter: int = LM_MAX_ITER,
            k: Optional[int] = None):
    """Fixed-lambda LM (``lm_step``) driven in chunks of ``_lm_chunk``, or
    of k. Returns the best params and the number of iterations run (the
    rejected one included)."""
    state = _lm_state(params, prob, mask)
    n = drive(lambda: lm_step(prob, state, max_iter), state["ctr"],
              _every(k) if k else _lm_chunk)
    return state["best"], n


def lm_polish(params, prob: Problem, mask, k: Optional[int] = None):
    """Adaptive-damping LM past the fixed-lambda stop (``polish_step``)
    driven in chunks of ``_polish_chunk``, or of k. Returns the best
    params and the number of iterations run."""
    state = _lm_state(params, prob, mask)
    n = drive(lambda: polish_step(prob, state), state["ctr"],
              _every(k) if k else _polish_chunk)
    return state["best"], n


def _add_step(prob: Problem, sched: dict, state: dict):
    """Place the next camera of the schedule (add ``state['k']``, a (1,)
    counter): seed its rotation from its pair's (``sched['r_rel']``) and
    its source camera's, gate the edges it brings by initial RMSE, mask
    the problem with the edges gated so far and restart the LM there.
    The JAX package's ``add_step`` of ``_traverse_impl``."""
    k, best = state["k"], state["best"]
    r_src = geo.exp_so3(best.index_select(
        0, sched["src"].index_select(0, k))[0, 3:6])
    r_rel = sched["r_rel"].index_select(0, k)[0]
    row = torch.cat([sched["lead"], geo.log_so3(geo.mm(r_rel, r_src))])
    best.index_copy_(0, sched["dst"].index_select(0, k), row[None])
    rmse = prob.edge_rmse(best)
    enabled = state["enabled"]
    enabled.copy_(enabled | ((sched["edge_add"] == k)
                             & (rmse < MIN_MATCH_ERROR)))
    state["mask"].copy_(prob.mask * prob.local(enabled)[:, None])
    _lm_restart(prob, state)
    k.add_(1)


def traverse(imgs: List[np.ndarray], matches: Dict, badjust: str = "incr",
             use_straighten: bool = True, polish: bool = True,
             device="cuda", stats=None, mesh=None,
             capture: bool = True) -> List[PanoImage]:
    """Best-first expansion over the match graph + bundle adjustment.

    ``matches[i][j] = (kpt_pairs (M, 6), hom, n_inliers)`` (the cache's
    rehydrated form). ``badjust``: ``incr`` (LM after every add),
    ``last`` (one LM at the end) or ``none``. ``stats``: an optional dict
    that receives the initial focal (``focal0``), the number of edges
    (``ba_edges``) and of those that passed the RMSE gate
    (``ba_edges_enabled``), the largest edge (``ba_edge_points``) and the
    LM iterations run (``lm_iterations``, one count per optimisation,
    and ``polish_iterations``), and the spans and totals of the recorder
    (``profiling.recording``: ``register`` and its five parts, the
    graphs' captures). ``mesh`` (``parallel.mesh.Mesh``): the
    edges of the problem are sharded over the ranks (``Problem``); every
    rank returns the same cameras, and runs on ``mesh.device``.

    As the JAX package's ``_traverse_impl``, the schedule (which camera
    is added when, from which camera and pair homography, gating which
    edges) is fixed on the host and uploaded once; the problem holds
    every edge from the start and only its mask grows. Each add, LM and
    polish iteration is a step on the device with no host sync; on a
    card without a mesh each of the three is captured once as a CUDA
    graph on static buffers and replayed (``capture=False`` runs the
    same steps eagerly: the check of the graphs). On the CPU, and under
    a mesh, whose gloo collectives stage through the host and cannot be
    captured, the steps run eagerly on the device asked for.
    """
    if badjust not in ("incr", "last", "none"):
        raise ValueError(f"badjust {badjust!r}")
    device = torch.device(device if mesh is None else mesh.device)
    with profiling.recording(stats), profiling.span("register"):
        return _traverse(imgs, matches, badjust, use_straighten, polish,
                         device, stats, mesh, capture)


def _traverse(imgs, matches, badjust, use_straighten, polish, device,
              stats, mesh, capture) -> List[PanoImage]:
    """``traverse``'s body in five spans: ``register.schedule`` (the heap
    walk, the packing and the uploads), ``register.rotations`` (the
    focal and each add's SVD), ``register.lm`` (the adds and their LM
    drives, the graphs' captures inside), ``register.polish`` and
    ``register.readback`` (straightening, ``stats`` and the cameras'
    read)."""
    with profiling.span("register.schedule"):
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
        prob = Problem(_upload(cam1, device), _upload(cam2, device),
                       _upload(pts, device), _upload(mask, device), n, mesh)
        homs_t = _upload(np.stack(homs_all).astype(np.float32), device)
        add_homs = _upload(np.stack([np.asarray(h, np.float32)
                                     for _, _, h in adds]), device)
        place = _upload(np.array([(d, s) for d, s, _ in adds], np.int64).T,
                        device)
        placed_idx = _upload(np.array(sorted(placed), np.int64), device)
        edge_add = _upload(edge_add, device)

    with profiling.span("register.rotations"):
        focal = torch.quantile(geo.focal_from_hom(homs_t), 0.5)
        zero = torch.zeros_like(focal)
        intr = geo.intrinsics(focal, (zero, zero))
        kinv = geo.inv3x3(intr)
        lead = torch.stack([intr[0, 0], intr[0, 2], intr[1, 2]])
        # each add's relative rotation depends on the focal and its pair
        # homography only: the SVDs (each checks its result with a host
        # sync) run here, one per add as in the loop they come from
        sched = dict(dst=place[0], src=place[1], lead=lead,
                     edge_add=edge_add,
                     r_rel=torch.stack([geo.nearest_rotation(geo.mm(geo.mm(
                         kinv, add_homs[k]), intr))
                         for k in range(len(adds))]))

    with profiling.span("register.lm"):
        params = torch.zeros((n, 6), dtype=f32, device=device)
        params[:, 0] = 1.0
        params[src] = 0.0
        params[src, :3] = lead
        state = _lm_state(params, prob, torch.zeros_like(prob.mask))
        state.update(enabled=torch.zeros(ne, dtype=torch.bool,
                                         device=device),
                     k=torch.zeros(1, dtype=torch.int64, device=device))
        steps = [partial(_add_step, prob, sched), partial(lm_step, prob),
                 partial(polish_step, prob)]
        if capture and device.type == "cuda" and mesh is None:
            add, lm, pol = (Replayed(f, state) for f in steps)
        else:
            add, lm, pol = (partial(f, state) for f in steps)

        lm_iters, polish_iters = [], 0
        for _ in adds:
            add()
            if badjust == "incr":
                lm_iters.append(drive(lm, state["ctr"], _lm_chunk))
        if badjust == "last":
            lm_iters.append(drive(lm, state["ctr"], _lm_chunk))

    with profiling.span("register.polish"):
        if polish and badjust != "none":
            _lm_restart(prob, state)
            polish_iters = drive(pol, state["ctr"], _polish_chunk)

    with profiling.span("register.readback"):
        params = state["best"]
        if use_straighten:
            rots = geo.exp_so3(params[placed_idx, 3:6])
            params = params.clone()
            params[placed_idx, 3:6] = geo.log_so3(geo.straighten(rots))
        if stats is not None:
            profiling.count("host_syncs", 2)    # float, int
            stats.update(focal0=float(focal), ba_edges=len(edges),
                         ba_edges_enabled=int(state["enabled"].sum()),
                         ba_edge_points=mp, lm_iterations=lm_iters,
                         polish_iterations=polish_iters)
        profiling.count("host_syncs")
        params = params.cpu().numpy().astype(np.float64)

        cameras: List[Optional[PanoImage]] = [None] * n
        for i in sorted(placed):
            cam = _np_camera_from_params(params[i])
            cam.img = imgs[i]
            cameras[i] = cam
        return [c for c in cameras if c is not None]


# ---------------------------------------------------------------------------
# The incremental bundle adjuster and the finite-difference check
# ---------------------------------------------------------------------------

def _next_pow2(x: int, lo: int) -> int:
    n = lo
    while n < x:
        n *= 2
    return n


def _np_log_so3(rot: np.ndarray) -> np.ndarray:
    """Host Rodrigues log (f64)."""
    rad = np.array([rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0],
                    rot[1, 0] - rot[0, 1]])
    mod = np.linalg.norm(rad)
    if mod < 1e-7:
        return np.zeros(3)
    theta = np.arccos(np.clip((np.trace(rot) - 1) / 2, -1, 1))
    return rad * (theta / mod)


def _np_params_from_camera(cam: PanoImage) -> np.ndarray:
    intr = cam.intr
    lead = np.array([intr[0, 0], intr[0, 2], intr[1, 2]])
    return np.concatenate([lead, _np_log_so3(cam.rot)])


def _edge_rmse(cam1: PanoImage, cam2: PanoImage, match: np.ndarray) -> float:
    """Initial RMSE of an edge (host, f64) for the mismatch gate."""
    hom = cam1.intr @ cam1.rot @ cam2.rot.T @ np.linalg.inv(cam2.intr)
    tr = match[:, 3:6] @ hom.T
    res = match[:, :2] - tr[:, :2] / tr[:, 2:3]
    return float(np.sqrt(np.mean(np.square(res))))


class BundleAdjuster:
    """Incremental bundle adjustment (the JAX package's
    ``BundleAdjuster``): cameras arrive one by one with their edges.

    The match points live on ``device`` and are appended to as cameras
    arrive (the buffers grow by doubling; ``edge_cap``/``match_cap`` fix
    their size up front), so each ``optimize()`` uploads only the params
    and the edges' camera indices and runs ``lm_core`` once. ``device``
    defaults to the card, as every entry point of the port.
    """

    def __init__(self, n_cameras: int, mode: str = "incr",
                 dtype=np.float32, edge_cap: Optional[int] = None,
                 match_cap: Optional[int] = None, device="cuda"):
        self.cameras: List[Optional[PanoImage]] = [None] * n_cameras
        self.matches: List[Tuple[int, int, np.ndarray]] = []
        self.mode = mode
        self.dtype = dtype
        self.device = resolve_device(device)
        self._cp = _next_pow2(n_cameras, 4)
        self._ep = _next_pow2(edge_cap, 4) if edge_cap else 4
        self._mp = _next_pow2(match_cap, 64) if match_cap else 64
        self._pts = None        # device (EP, MP, 6)
        self._mask = None       # device (EP, MP)
        self._n_dev = 0         # edges uploaded so far

    def add(self, idx: int, camera: PanoImage, matches: Dict) -> None:
        """Add a camera and those of its edges to placed cameras whose
        initial RMSE is at most ``MIN_MATCH_ERROR``."""
        self.cameras[idx] = camera
        for new, cam in enumerate(self.cameras):
            if cam is None or new not in matches[idx]:
                continue
            match = matches[idx][new][0]
            if _edge_rmse(camera, cam, match) > MIN_MATCH_ERROR:
                continue
            self.matches.append((new, idx, match))
        if self.mode == "incr":
            self.optimize()

    def _benign_rows(self, k: int) -> np.ndarray:
        rows = np.zeros((k, self._mp, 6), self.dtype)
        rows[..., 2] = 1.0   # benign homogeneous padding
        rows[..., 5] = 1.0
        return rows

    def _sync_device(self) -> None:
        """Upload the edges added since the last sync (rebuild the
        buffers at a doubled size when they are full)."""
        need_mp = max((len(m) for _, _, m in self.matches), default=1)
        grow = need_mp > self._mp
        while self._mp < need_mp:
            self._mp *= 2
        while self._ep < len(self.matches):
            self._ep *= 2
            grow = True
        if self._pts is None or grow or self._pts.shape[0] != self._ep:
            self._pts = _upload(self._benign_rows(self._ep), self.device)
            self._mask = torch.zeros((self._ep, self._mp),
                                     dtype=self._pts.dtype,
                                     device=self.device)
            self._n_dev = 0
        new = self.matches[self._n_dev:]
        if not new:
            return
        rows = self._benign_rows(len(new))
        mrows = np.zeros((len(new), self._mp), self.dtype)
        for e, (_, _, m) in enumerate(new):
            rows[e, :len(m)] = m
            mrows[e, :len(m)] = 1.0
        e0 = self._n_dev
        self._pts[e0:e0 + len(new)] = _upload(rows, self.device)
        self._mask[e0:e0 + len(new)] = _upload(mrows, self.device)
        self._n_dev = len(self.matches)

    def _assemble(self):
        """The padded problem on the host, cameras compacted: -> (placed
        indices, params (CP, 6), cam1, cam2 (EP,), pts (EP, MP, 6), mask
        (EP, MP))."""
        idx = [i for i, c in enumerate(self.cameras) if c is not None]
        pos = {c: k for k, c in enumerate(idx)}
        cp = _next_pow2(len(idx), 4)
        ep = _next_pow2(max(len(self.matches), 1), 4)
        mp = _next_pow2(max((len(m) for _, _, m in self.matches),
                            default=1), 64)
        params = np.zeros((cp, 6), self.dtype)
        params[:, 0] = 1.0  # benign focal for padding cameras
        for k, i in enumerate(idx):
            params[k] = _np_params_from_camera(self.cameras[i])
        cam1 = np.zeros(ep, np.int32)
        cam2 = np.zeros(ep, np.int32)
        pts = np.zeros((ep, mp, 6), self.dtype)
        pts[..., 2] = 1.0
        pts[..., 5] = 1.0
        mask = np.zeros((ep, mp), self.dtype)
        for e, (i_new, j_idx, m) in enumerate(self.matches):
            cam1[e] = pos[j_idx]
            cam2[e] = pos[i_new]
            pts[e, :len(m)] = m
            mask[e, :len(m)] = 1.0
        return idx, params, cam1, cam2, pts, mask

    def optimize(self) -> None:
        """One ``lm_core`` over every camera placed so far."""
        if not self.matches:
            return
        self._sync_device()
        idx = [i for i, c in enumerate(self.cameras) if c is not None]
        params = np.zeros((self._cp, 6), self.dtype)
        params[:, 0] = 1.0  # benign focal for unplaced cameras
        for i in idx:
            params[i] = _np_params_from_camera(self.cameras[i])
        cam1 = np.zeros(self._ep, np.int64)
        cam2 = np.zeros(self._ep, np.int64)
        for e, (i_new, j_idx, _) in enumerate(self.matches):
            cam1[e], cam2[e] = j_idx, i_new
        prob = Problem(_upload(cam1, self.device), _upload(cam2, self.device),
                       self._pts, self._mask, self._cp)
        best, _ = lm_core(_upload(params, self.device), prob, prob.mask)
        best = best.cpu().numpy().astype(np.float64)
        for i in idx:
            cam = _np_camera_from_params(best[i])
            cam.img = self.cameras[i].img
            self.cameras[i] = cam


def jacobian_numeric(params: np.ndarray, cam1_idx, cam2_idx, pts, mask,
                     step: float = 1e-6):
    """(J^T J, J^T r) from symmetric differences of the port's masked
    residuals (``Problem``), in f64 on the host: the check of the
    analytic ``Problem.normal_equations`` on small problems."""
    params = np.asarray(params, np.float64)
    f64 = torch.float64
    prob = Problem(torch.as_tensor(np.asarray(cam1_idx), dtype=torch.int64),
                   torch.as_tensor(np.asarray(cam2_idx), dtype=torch.int64),
                   torch.as_tensor(np.asarray(pts), dtype=f64),
                   torch.as_tensor(np.asarray(mask), dtype=f64),
                   params.shape[0])

    def res_vec(p):
        terms = _camera_terms(torch.as_tensor(p))
        _, res, _, _ = prob._residuals(_rows(terms, prob.cam1),
                                       _rows(terms, prob.cam2), prob.mask)
        return res.numpy().ravel()

    base = res_vec(params)
    cols = []
    for i in range(params.shape[0]):
        for j in range(6):
            dp = params.copy()
            dp[i, j] += step
            rp = res_vec(dp)
            dp[i, j] -= 2 * step
            rm = res_vec(dp)
            cols.append((rp - rm) / (2 * step))
    jac = np.stack(cols, axis=1)
    return jac.T @ jac, jac.T @ base


__all__ = ["PanoImage", "BundleAdjuster", "traverse", "Problem", "lm_core",
           "lm_polish", "lm_step", "polish_step", "drive",
           "jacobian_numeric", "PARAMS_PER_CAMERA", "LM_LAMBDA",
           "LM_MAX_ITER", "MIN_MATCH_ERROR"]
