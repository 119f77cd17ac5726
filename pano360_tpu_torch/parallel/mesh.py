"""Process-group parallelism for the stitching pipeline (counterpart of
``pano360_tpu.parallel.mesh``).

The JAX package shards across the devices of one program
(``shard_map`` over a 1-D ``Mesh(("data",))``); PyTorch shards across
processes. A ``Mesh`` here is one rank of a ``torch.distributed`` process
group, made inside a rank process that ``launch`` spawned. The same
three scale-out axes as in the JAX package:

- extraction over images (each rank runs whole batches of the
  single-process path, so every image is extracted in the batch it has
  there);
- the match graph over pairs (each rank runs whole chunks of the
  single-process chunk loop and replays the one generator's uniforms of
  every chunk, so pair k gets the same RANSAC draws on any rank);
- the bundle adjuster's edges (the per-edge normal-equation blocks are
  gathered and reduced once, in the single-process order, on every rank)
  and the render's regions (warp and blend on the local shard, canvases
  combined in ascending rank order).

Two helpers carry every reduction: ``Mesh.all_gather_cat`` (equal shapes
on every rank, concatenated in rank order) and ``Mesh.ordered_sum`` (a
gather, then a left fold in ascending rank order), so that no result
depends on the backend's reduction order and every rank holds the same
bits. Nothing here uses ``all_reduce``: a decision that a rank took from
a rank-local value could send the ranks different ways and deadlock the
next collective.

Backends: ``nccl`` when every rank has a GPU of its own, else ``gloo``
(on the CPU, or ranks that share a GPU, which NCCL refuses). Under gloo
a collective on CUDA tensors goes through host copies; the compute stays
on the card.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pano360_tpu_torch import resolve_device

TIMEOUT_S = 120     # every collective; a broken rank fails the run


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank of a 1-D process group: its ``rank`` of ``size``, its
    ``device`` and the group's ``backend``. ``stats`` accumulates the
    seconds spent in collectives (``gather_seconds``) and their number
    (``gathers``)."""

    group: Any
    rank: int
    size: int
    device: torch.device
    backend: str
    stats: dict = dataclasses.field(default_factory=dict, compare=False)

    def block(self, items: Sequence) -> list:
        """This rank's contiguous block of ``items``: ceil(n / size) of
        them, the last rank's block cut short where n does not divide."""
        per = -(-len(items) // self.size)
        return list(items[self.rank * per:(self.rank + 1) * per])

    def per(self, n: int) -> int:
        """Items in each rank's block of n."""
        return -(-n // self.size)

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.stats["gather_seconds"] = (self.stats.get("gather_seconds", 0.0)
                                        + time.perf_counter() - t0)
        self.stats["gathers"] = self.stats.get("gathers", 0) + 1
        return out

    def _gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        src = t.contiguous()
        if src.dtype == torch.bool:
            src = src.to(torch.uint8)
        if self.backend == "gloo" and src.is_cuda:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return [p.to(device=t.device, dtype=t.dtype) for p in parts]

    def gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (equal shapes), in rank order."""
        return self._timed(self._gather, t)

    def all_gather_cat(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0 in rank order."""
        return torch.cat(self.gather(t), dim=0)

    def gather_rows(self, t: torch.Tensor, n: int,
                    per: Optional[int] = None) -> torch.Tensor:
        """The n rows of a sharded axis, on every rank: each rank's ``t``
        holds its contiguous block of at most ``per`` rows (default
        ``per(n)``), padded here with zero rows to ``per``; the blocks
        are concatenated in rank order and cut to n."""
        per = self.per(n) if per is None else per
        if t.shape[0] < per:
            t = torch.cat([t, t.new_zeros((per - t.shape[0],) + t.shape[1:])])
        return self.all_gather_cat(t)[:n]

    def ordered_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, folded left in ascending rank
        order: the same bits on every rank and under any backend."""
        parts = self.gather(t)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def ordered_take(self, t: torch.Tensor, key: int) -> torch.Tensor:
        """Combine per-rank packed canvases (..., C): scanning ranks in
        ascending order, a rank's pixel replaces the current one where
        its channel ``key`` is strictly greater. Over contiguous
        ascending shards this is the sequential paste loop's
        first-writer-wins rule (weights) or last-writer-wins rule
        (ascending writer ids)."""
        parts = self.gather(t)
        cur = parts[0]
        for p in parts[1:]:
            cur = torch.where((p[..., key] > cur[..., key])[..., None], p,
                              cur)
        return cur

    def any(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise OR of every rank's bool ``t``."""
        parts = self.gather(t)
        out = parts[0]
        for p in parts[1:]:
            out = out | p
        return out

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order."""
        out = [None] * self.size

        def run():
            dist.all_gather_object(out, obj, group=self.group)
            return out
        return self._timed(run)


def make_mesh(n: Optional[int] = None, device=None) -> Mesh:
    """This process's ``Mesh``, inside a rank process after
    ``torch.distributed.init_process_group`` (``launch`` does both).
    ``n``: the expected world size (raises if the group differs);
    ``device``: this rank's device (default: ``cuda:(rank % count)``,
    whatever the backend; without a card it raises as
    ``resolve_device`` does: the CPU only when named)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(run inside parallel.mesh.launch)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n is not None and n != size:
        raise ValueError(f"mesh of {n} ranks asked for in a group of {size}")
    if device is None:
        resolve_device()                     # raises without a card
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(dist.group.WORLD, rank, size, torch.device(device),
                dist.get_backend())


def backend_for(n: int, device_type: str) -> str:
    """nccl when each of the n ranks has a GPU of its own, else gloo."""
    if (device_type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= n):
        return "nccl"
    return "gloo"


def rank_threads(n: int) -> int:
    """CPU threads of each of n CPU ranks: cpus // n. PyTorch's CPU
    reductions split their work by thread, so a one-process run gives
    the ranks' bits only at this thread count."""
    return max(1, (os.cpu_count() or 1) // n)


def _rank_main(rank: int, n: int, device_type: str, init: str, out: str,
               fn: Callable, args: tuple):
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(rank_threads(n))
    backend = backend_for(n, device_type)
    dist.init_process_group(
        backend, init_method=init, rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        result = fn(make_mesh(n, dev), *args)
        if rank == 0:
            with open(out, "wb") as fid:
                pickle.dump(result, fid, protocol=pickle.HIGHEST_PROTOCOL)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, device, *args):
    """Run ``fn(mesh, *args)`` in n spawned rank processes and return
    rank 0's result.

    ``fn`` and ``args`` must be picklable (``fn`` a module-level function
    of this package: a spawned child imports its module). Rendezvous is a
    ``file://`` store in a fresh temporary directory, so concurrent
    launches never share a port; every collective times out after
    ``TIMEOUT_S``. On the CPU each rank takes ``rank_threads(n)``; on CUDA
    rank r takes ``cuda:(r % device_count)``. A rank that raises fails
    the whole launch (``torch.multiprocessing.spawn`` re-raises it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA ranks requested but torch.cuda is not "
                           "available; pass device='cpu' explicitly")
    if device.type == "cuda":
        from pano360_tpu_torch import _kernels
        _kernels.build()            # once, before the ranks load it
    tmp = tempfile.mkdtemp(prefix="pano360_mesh_")
    try:
        out = os.path.join(tmp, "rank0.pkl")
        torch.multiprocessing.spawn(
            _rank_main, args=(n, device.type, f"file://{tmp}/store", out,
                              fn, args),
            nprocs=n, join=True)
        with open(out, "rb") as fid:
            return pickle.load(fid)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# The JAX module's building blocks, over a process-group mesh
# ---------------------------------------------------------------------------

def _gather_fields(mesh: Mesh, tup):
    return type(tup)(*[mesh.all_gather_cat(t) for t in tup])


def sharded_extract(mesh: Mesh, gray: torch.Tensor, cfg=None):
    """SIFT extraction of (N, H, W) gray images, N a multiple of the
    mesh size, sharded over the ranks in contiguous blocks; the features
    come back on every rank (all-gathered)."""
    from pano360_tpu_torch.features import sift as S
    lo = mesh.rank * mesh.per(gray.shape[0])
    local = gray[lo:lo + mesh.per(gray.shape[0])].to(mesh.device)
    return _gather_fields(mesh, S.sift_extract(local, cfg))


def sharded_color_extract(mesh: Mesh, stack_u8, cfg=None):
    """The production extraction (uint8 BGR -> gray -> SIFT, batches of
    ``pipeline.BATCH``) of a same-shape (N, H, W, 3) stack sharded over
    the ranks by whole batches: the features of every image, on every
    rank, bit-identical to ``pipeline.upload_extract`` on one process."""
    from pano360_tpu_torch import pipeline
    imgs = [np.asarray(im) for im in stack_u8]
    return pipeline.upload_extract(imgs, mesh.device, cfg, mesh=mesh)[1]


def sharded_pair_match(mesh: Mesh, kpts, desc, valid, pair_a, pair_b,
                       seeds):
    """Match P pairs sharded over the ranks in contiguous blocks, P a
    multiple of the mesh size: pair k draws its RANSAC hypotheses from a
    generator seeded with ``seeds[k]`` (the counterpart of the JAX
    package's per-pair PRNG keys), so its result does not depend on the
    rank that runs it. Returns the ``match.PairMatch`` of all P pairs on
    every rank."""
    from pano360_tpu_torch import match as pm
    per = mesh.per(len(pair_a))
    lo = mesh.rank * per
    dev = kpts.device
    us = []
    for k in range(lo, lo + per):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seeds[k]))
        us.append(torch.rand((pm.RANSAC_ITERS, 4), generator=gen,
                             device=dev))
    res = pm.match_pairs(kpts, desc, valid,
                         torch.as_tensor(pair_a[lo:lo + per], device=dev),
                         torch.as_tensor(pair_b[lo:lo + per], device=dev),
                         uniforms=torch.stack(us))
    return _gather_fields(mesh, res)


def sharded_match_all_pairs(mesh: Mesh, kpts, desc, valid, pairs,
                            seed: int = 0, batch_size: int = 16,
                            draw_fn=None):
    """``match.match_all_pairs`` with the pair axis sharded over the
    ranks: each runs whole chunks of ``batch_size`` pairs of the
    single-process chunk loop, replaying the generator seeded with
    ``seed`` over every chunk, so the result is bit-identical to one
    process's. -> ``PairMatch`` of numpy arrays, one row per pair, on
    every rank."""
    from pano360_tpu_torch import match as pm
    gen = None
    if draw_fn is None:
        gen = torch.Generator(device=kpts.device)
        gen.manual_seed(seed)
    return pm.match_all_pairs(kpts, desc, valid, pairs, batch_size,
                              generator=gen, draw_fn=draw_fn, mesh=mesh)


def distributed_lm_stats(mesh: Mesh, params, cam1, cam2, pts, mask):
    """One LM linearization with the edges sharded over the ranks: ->
    (squared residual sum, number of residual terms, J^T J (6C, 6C),
    J^T r (6C,)), the JAX package's ``register._lm_stats`` quadruple.
    Each rank computes the per-edge terms of its shard; they are gathered
    and reduced once, in edge order, on every rank."""
    from pano360_tpu_torch import register as R
    dev = mesh.device
    prob = R.Problem(torch.as_tensor(cam1, device=dev),
                     torch.as_tensor(cam2, device=dev),
                     torch.as_tensor(pts, device=dev),
                     torch.as_tensor(mask, device=dev),
                     int(params.shape[0]), mesh=mesh)
    params = torch.as_tensor(params, device=dev)
    sq, cnt = prob.edge_sums(params, prob.mask)
    jtj, jtr = prob.normal_equations(params, prob.mask)
    return torch.sum(sq), 2.0 * torch.sum(cnt), jtj, jtr


def distributed_step(mesh: Mesh, gray: torch.Tensor, cfg=None,
                     lm_lambda: Optional[float] = None):
    """One distributed pipeline step, the JAX package's demo: extraction
    sharded over images, matching over the ring of adjacent pairs, and
    one damped Gauss-Newton update of every camera from the gathered
    normal equations. -> (updated params (N, 6), total inliers)."""
    from pano360_tpu_torch import register as R
    from pano360_tpu_torch.features import sift as S
    lm_lambda = R.LM_LAMBDA if lm_lambda is None else lm_lambda
    n = gray.shape[0]
    feats = sharded_extract(mesh, gray, cfg)
    desc = S.root_sift(feats.desc)
    pair_a = np.arange(n)
    pair_b = (np.arange(n) + 1) % n
    res = sharded_pair_match(mesh, feats.xy, desc, feats.valid, pair_a,
                             pair_b, np.arange(n))
    m = feats.xy.shape[1]
    ones = torch.ones((n, m, 1), device=feats.xy.device)
    p1 = torch.cat([feats.xy[pair_a], ones], dim=-1)
    p2 = torch.gather(feats.xy[pair_b], 1,
                      res.idx[..., 1:2].expand(-1, -1, 2))
    pts = torch.cat([p1, p2, ones], dim=-1)                  # (E, M, 6)
    mask = res.inlier.to(torch.float32)
    params = torch.zeros((n, 6), device=feats.xy.device)
    params[:, 0] = gray.shape[2] * 1.2
    _, _, jtj, jtr = distributed_lm_stats(mesh, params, pair_a, pair_b,
                                          pts, mask)
    jtj = jtj + lm_lambda * torch.eye(jtj.shape[0], device=jtj.device)
    delta = torch.linalg.solve(jtj, jtr)
    return params - delta.reshape(params.shape), int(res.n_inliers.sum())


__all__ = ["Mesh", "make_mesh", "launch", "backend_for", "rank_threads",
           "sharded_extract",
           "sharded_pair_match", "distributed_lm_stats", "distributed_step",
           "sharded_color_extract", "sharded_match_all_pairs", "TIMEOUT_S"]
