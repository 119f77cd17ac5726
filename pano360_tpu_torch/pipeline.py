"""Detection + all-pairs match graph (counterpart of ``pano360_tpu.pipeline``).

Produces the JAX package's cache structure exactly:

- ``kpts``: object array of per-image float32 (N_i, 2) center-relative
  keypoints;
- ``matches[src][dst] = (match_idx (M, 2) int32, hom float64)`` for every
  connected ordered pair, the reverse edge being (fliplr, inv(hom));
- ``idx_to_keypoints`` rehydrates to homogeneous coords + confidence.

SIFT runs in batches of 4 images, each batch uploaded from pinned host
memory with a non-blocking copy and, on a card, replayed from the
process's CUDA graph of its shape (``graphs``); the match graph needs one
host read before it (the valid counts that size its buffers) and one
after. Mixed image sizes run one shape bucket at a time (SIFT and MSOP
alike) and the features come back in the input order.
"""
from __future__ import annotations

import logging
import time
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from pano360_tpu_torch import graphs, profiling
from pano360_tpu_torch import match as pm
from pano360_tpu_torch.features import msop as M
from pano360_tpu_torch.features import sift as S
from pano360_tpu_torch.ops.color import bgr2gray

LOG = logging.getLogger(__name__)
BATCH = 4


def gray_extract(stack_u8: torch.Tensor, cfg: S.SiftConfig) -> S.SiftFeatures:
    """(B, H, W, 3) uint8 BGR stack -> SIFT features of its gray images."""
    gray = bgr2gray(stack_u8.to(torch.float32) / 255.0)
    return S.sift_extract(gray, cfg)


def _extract_step(cfg: S.SiftConfig, state: dict):
    """One batch's extraction as a step on static buffers: ``state['u8']``
    (B, H, W, 3) uint8 -> ``state[f]`` for each ``SiftFeatures`` field."""
    state.update(zip(S.SiftFeatures._fields, gray_extract(state["u8"], cfg)))


def _extractor(shape: tuple, cfg: S.SiftConfig, device: torch.device,
               replay: bool):
    """-> (run, state) of a batch of ``shape`` (B, H, W, 3): replayed from
    the process's graph of (shape, cfg), or eager on a state of its own."""
    def make():
        state = {"u8": torch.zeros(shape, dtype=torch.uint8, device=device)}
        fn = partial(_extract_step, cfg)
        return (graphs.Replayed(fn, state, graphs.PROGRAMS.pool) if replay
                else partial(fn, state)), state
    return (graphs.PROGRAMS.get(("sift", shape, cfg, device), make)
            if replay else make())


def _shape_buckets(imgs: List[np.ndarray]) -> Dict[tuple, List[int]]:
    """Image indices grouped by (H, W), so each bucket batches one shape."""
    buckets: Dict[tuple, List[int]] = {}
    for i, im in enumerate(imgs):
        buckets.setdefault(im.shape[:2], []).append(i)
    return buckets


def _input_order(order: List[int], device) -> torch.Tensor:
    """The permutation that brings bucket-major rows (image ``order[r]``
    in row r) back to the input order."""
    return torch.as_tensor(np.argsort(np.asarray(order)), device=device)


class BucketStacks:
    """Per-shape-bucket device image stacks (mixed-size inputs): one
    uint8 stack per (H, W) bucket, so the pixels are uploaded once and
    ``render.stitch`` zero-pads each bucket to the largest shape on the
    device instead of uploading a host-padded stack."""

    def __init__(self, parts):
        self.parts = parts      # list of (image indices, (B, h, w, 3) u8)
        self.n = sum(len(idxs) for idxs, _ in parts)

    def to_padded(self, h: int, w: int) -> torch.Tensor:
        """(N, h, w, 3) uint8 stack, zero-padded, in the input order."""
        rows, order = [], []
        for idxs, stack in self.parts:
            bh, bw = stack.shape[1:3]
            rows.append(torch.nn.functional.pad(
                stack, (0, 0, 0, w - bw, 0, h - bh)))
            order.extend(idxs)
        out = torch.cat(rows, dim=0)
        return out[_input_order(order, out.device)]


@profiling.span("features")
def upload_extract(imgs: List[np.ndarray], device: torch.device,
                   cfg: Optional[S.SiftConfig] = None, mesh=None,
                   capture: bool = True):
    """Upload the uint8 images in batches of 4 and extract each batch.

    Returns ``(stack (N, H, W, 3) uint8 on the device, SiftFeatures over
    all N)``; the stack is reused by the render, so the pixels cross the
    host link once. Mixed image shapes run one shape bucket at a time:
    the stack is then a ``BucketStacks`` and the features are in the
    input order (every bucket shares the ``max_kpts`` capacity).
    ``cfg``: by default ``SiftConfig()``, made at the call.

    On a card each batch is copied from pinned memory into the static
    input of the process's CUDA graph of its shape and ``cfg`` (captured
    at the first batch of that key, the short last batch under a key of
    its own) and replayed: the counterpart of the JAX package's jitted
    extraction. ``capture=False`` runs the same step eagerly (the CPU's
    and the mesh's path).

    ``mesh`` (``parallel.mesh.Mesh``): each rank uploads and extracts a
    contiguous block of whole batches (a rank short of a block repeats
    the last batch), the features are gathered in batch order, and the
    stack is None: every image is extracted in the same batch as on one
    process, so the features are bit-identical to it.
    """
    cfg = S.SiftConfig() if cfg is None else cfg
    buckets = _shape_buckets(imgs)
    if len(buckets) != 1:
        feat_parts, order, stacks = [], [], []
        for idxs in buckets.values():
            st, f = upload_extract([imgs[i] for i in idxs], device, cfg,
                                   mesh, capture)
            feat_parts.append(f)
            order.extend(idxs)
            stacks.append((idxs, st))
        inv = _input_order(order, device)
        feats = S.SiftFeatures(*[torch.cat(xs, dim=0)[inv]
                                 for xs in zip(*feat_parts)])
        return (None if mesh else BucketStacks(stacks)), feats
    replay = capture and device.type == "cuda" and mesh is None
    starts = list(range(0, len(imgs), BATCH))
    if mesh is not None:
        mine = mesh.block(starts)
        starts = mine + [starts[-1]] * (mesh.per(len(starts)) - len(mine))
    # a replay's buffers are the next replay's: keep copies
    keep = (lambda t: t.clone()) if replay else (lambda t: t)
    chunks, parts = [], []
    for b0 in starts:
        batch = np.stack(imgs[b0:b0 + BATCH])
        run, state = _extractor(batch.shape, cfg, device, replay)
        graphs.upload_into(state["u8"], batch)
        run()
        chunks.append(keep(state["u8"]))
        parts.append([keep(state[f]) for f in S.SiftFeatures._fields])
    feats = S.SiftFeatures(*[torch.cat(xs, dim=0) for xs in zip(*parts)])
    if mesh is not None:        # only the last batch, the last rows, is short
        per = len(starts) * BATCH
        return None, S.SiftFeatures(*[mesh.gather_rows(t, len(imgs), per)
                                      for t in feats])
    return torch.cat(chunks, dim=0), feats


def valid_first(kp_buf, ds_buf, va_buf, counts, ccap: int):
    """Compact to ``ccap`` slots: valid rows first in ascending order, so
    match indices index the compact per-image keypoint lists of the
    cache. A buffer narrower than ``ccap`` is zero-padded."""
    dev = kp_buf.device
    sel = torch.argsort((~va_buf).to(torch.uint8), dim=1,
                        stable=True)[:, :ccap]
    kp_buf = torch.gather(kp_buf, 1, sel[..., None].expand(-1, -1, 2))
    ds_buf = torch.gather(ds_buf, 1, sel[..., None].expand(
        -1, -1, ds_buf.shape[-1]))
    short = ccap - sel.shape[1]
    if short > 0:
        kp_buf = torch.nn.functional.pad(kp_buf, (0, 0, 0, short))
        ds_buf = torch.nn.functional.pad(ds_buf, (0, 0, 0, short))
    va_buf = (torch.arange(ccap, device=dev)[None, :]
              < graphs.upload(np.asarray(counts), dev)[:, None])
    return kp_buf, ds_buf, va_buf


def _msop_cap(counts: np.ndarray, widths) -> int:
    """The compact buffers' width: the largest valid count rounded up to
    a power of two (at least 64), within the widest bucket's buffers."""
    cmax = int(counts.max()) if len(counts) else 0
    return min(max(64, 1 << max(cmax - 1, 0).bit_length()), max(widths))


def msop_extract(imgs: List[np.ndarray], device: torch.device,
                 stats=None, mesh=None) -> M.MsopFeatures:
    """Upload the uint8 images and run the device-resident MSOP
    extraction once per shape bucket: -> the features of all images in
    the input order, keypoints relative to each image's centre and the
    buffers compacted valid first.

    ``mesh``: each rank extracts a contiguous block of each bucket's
    images (extraction is per image, so the features do not depend on
    the block); the host keypoint lists, the counts and each level's
    buffer rows are gathered, so that every rank compacts to the width
    one process would, and the buffers are gathered. ``stats`` then
    counts this rank's block."""
    n = len(imgs)
    kpts: List[Optional[np.ndarray]] = [None] * n
    parts, order, widths = [], [], []
    for (h, w), idxs in _shape_buckets(imgs).items():
        mine = idxs if mesh is None else mesh.block(idxs)
        st = {}
        if mine:
            stack = graphs.upload(np.stack([imgs[i] for i in mine]), device)
            kp_host, kp, ds, va, counts = M.msop_extract_device(stack,
                                                                stats=st)
        else:
            kp_host, counts = [], np.zeros(0, np.int32)
            kp = torch.zeros((0, 0, 2), device=device)
            ds = torch.zeros((0, 0, M.DSIZE * M.DSIZE), device=device)
            va = torch.zeros((0, 0), dtype=torch.bool, device=device)
        if stats is not None:
            for key in ("candidates", "keypoints"):
                if key in st:
                    old = stats.get(key, [0] * len(st[key]))
                    stats[key] = [a + b for a, b in zip(old, st[key])]
            stats["ssc_seconds"] = (stats.get("ssc_seconds", 0.0)
                                    + st.get("ssc_seconds", 0.0))
        caps = st.get("level_caps", [])
        if mesh is not None:
            got = mesh.all_gather_object((kp_host, counts, caps))
            kp_host = [k for g in got for k in g[0]]
            counts = np.concatenate([g[1] for g in got])
            caps = [max(c) for c in zip(*[g[2] for g in got if g[2]])]
        cent = np.array([w / 2, h / 2], np.float32)
        for i, k in zip(idxs, kp_host):
            kpts[i] = k - cent
        widths.append(int(sum(caps)) or 64)
        parts.append([kp - torch.as_tensor(cent, device=device), ds, va,
                      counts, len(mine)])
        order.extend(idxs)
    counts = np.concatenate([p[3] for p in parts])
    cap = _msop_cap(counts, widths)
    bufs = []
    for kp, ds, va, cnt, n_mine in parts:
        if mesh is None:
            bufs.append(valid_first(kp, ds, va, cnt, cap))
            continue
        lo = mesh.rank * mesh.per(len(cnt))
        local = valid_first(kp, ds, va, cnt[lo:lo + n_mine], cap)
        bufs.append([mesh.gather_rows(t, len(cnt)) for t in local])
    inv = _input_order(order, device)
    kp_buf, ds_buf, va_buf = (torch.cat(xs, dim=0)[inv] for xs in zip(*bufs))
    return M.MsopFeatures(kpts, kp_buf, ds_buf, va_buf,
                          counts[np.argsort(np.asarray(order))])


def reverse_homography(hom: np.ndarray) -> np.ndarray:
    """The homography of an edge taken the other way: the inverse, or the
    pseudo-inverse where ``hom`` is exactly singular. Several keypoints
    matched to one (MSOP's border keypoints between views that share no
    pixel) pass RANSAC with a rank-1 homography; the JAX package's comes
    out singular only up to rounding, so its inverse is some finite
    matrix and its run goes on to the registration, which gates such an
    edge out by its RMSE. An exactly singular one must not end the run
    here either."""
    try:
        return np.linalg.inv(hom)
    except np.linalg.LinAlgError:
        return np.linalg.pinv(hom)


def sift_buffers(imgs: List[np.ndarray], feats: S.SiftFeatures):
    """The match graph's inputs from SIFT features, with the one host
    read they need (the keypoints and their valid masks): -> (per-image
    host keypoint lists, centre-relative, and the keypoint, RootSIFT and
    valid buffers compacted valid first to the largest valid count
    rounded up to a power of two, at least 64; ``remap``: the match
    indices of uncompacted buffers into the compact lists, else None)."""
    device = feats.xy.device
    cents = graphs.upload(np.array([[im.shape[1] / 2, im.shape[0] / 2]
                                    for im in imgs], np.float32), device)
    kp_buf = feats.xy - cents[:, None, :]
    ds_buf = S.root_sift(feats.desc)
    va_buf = feats.valid
    cap0 = cap = int(kp_buf.shape[1])
    kp_host, valid_np = graphs.to_host(kp_buf, va_buf)
    counts = valid_np.sum(axis=1)
    cmax = int(counts.max())
    # compact to the max valid count (pair cost scales with cap^2)
    ccap = max(64, 1 << max(cmax - 1, 0).bit_length())
    if ccap < cap:
        kp_buf, ds_buf, va_buf = valid_first(kp_buf, ds_buf, va_buf,
                                              counts, ccap)
        cap = ccap
    kpts_host = [kp_host[i][valid_np[i]].astype(np.float32)
                 for i in range(len(imgs))]
    remap = np.cumsum(valid_np, axis=1) - 1 if cap == cap0 else None
    return kpts_host, kp_buf, ds_buf, va_buf, remap


def match_graph(kp_buf, ds_buf, va_buf, seed: int = 0,
                draw_fn: Optional[pm.DrawFn] = None, mesh=None,
                capture: bool = True) -> pm.PairMatch:
    """Every pair a < b of the (N, C, ...) buffers through
    ``match.match_all_pairs``: -> ``PairMatch`` of host arrays, one row
    per pair. The RANSAC draws come from ``draw_fn`` or from a
    ``torch.Generator`` on the buffers' device seeded with ``seed``; the
    pairs per chunk are bounded by the distance-matrix memory."""
    n, cap = kp_buf.shape[:2]
    pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
    generator = None
    if draw_fn is None:
        generator = torch.Generator(device=kp_buf.device)
        generator.manual_seed(seed)
    batch = max(1, min(16, (1 << 28) // max(cap * cap * 4, 1)))
    return pm.match_all_pairs(kp_buf, ds_buf, va_buf, pairs, batch,
                              generator=generator, draw_fn=draw_fn,
                              mesh=mesh, capture=capture)


def matching(imgs: List[np.ndarray], device, max_kpts: int = 4096,
             seed: int = 0, feats=None,
             draw_fn: Optional[pm.DrawFn] = None, detector: str = "sift",
             stats=None, mesh=None, capture: bool = True):
    """All-pairs feature matching -> ``(kpts, matches)`` object arrays.

    ``detector``: "sift" (RootSIFT, 128-d) or "msop" (64-d oriented
    patches, no RootSIFT). ``feats``: precomputed features of that
    detector (``SiftFeatures`` from ``upload_extract``, ``MsopFeatures``
    from ``msop_extract``). ``draw_fn(pair_k, n_valid)``: optional RANSAC
    hypothesis draws per pair (index k into the a < b pair list); by
    default a ``torch.Generator`` on the device seeded with ``seed``
    draws them. ``stats``: an optional dict for ``msop_extract``'s
    counts and the stage's spans and totals (``profiling.recording``).
    ``mesh`` (``parallel.mesh.Mesh``): extraction sharded over
    images and the match graph over pairs; every rank returns the same
    ``(kpts, matches)``, bit-identical to one process's. ``capture``:
    SIFT's extraction and the match graph replayed from CUDA graphs on a
    card (``upload_extract``, ``match.match_all_pairs``); False runs the
    same steps eagerly. MSOP's extraction runs eagerly (its SSC runs on
    the host inside it).
    """
    if not imgs:
        raise ValueError("no images to process (empty directory?)")
    if detector not in ("sift", "msop"):
        raise ValueError(f"detector must be sift or msop, got {detector!r}")
    with profiling.recording(stats), profiling.span("match"):
        device = torch.device(device)
        n = len(imgs)
        start = time.time()
        if detector == "msop":
            if feats is None:
                feats = msop_extract(imgs, device, stats, mesh)
            kpts_host, kp_buf, ds_buf, va_buf = feats[:4]
            remap = None                # compact already
        else:
            if feats is None:
                _, feats = upload_extract(imgs, device,
                                          S.SiftConfig(max_kpts=max_kpts),
                                          mesh, capture)
            kpts_host, kp_buf, ds_buf, va_buf, remap = sift_buffers(imgs,
                                                                    feats)
        LOG.info("Extracted keypoints, time: %s", time.time() - start)

        start = time.time()
        res = match_graph(kp_buf, ds_buf, va_buf, seed, draw_fn, mesh,
                          capture)
        pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
        matches: Dict[int, Dict[int, tuple]] = {i: {} for i in range(n)}
        for k, (src, dst) in enumerate(pairs):
            if not bool(res.ok[k]):
                continue
            idx = res.idx[k][res.inlier[k]].astype(np.int32)
            if remap is not None:
                idx = np.stack([remap[src][idx[:, 0]],
                                remap[dst][idx[:, 1]]],
                               axis=1).astype(np.int32)
            hom = res.hom[k].astype(np.float64)
            matches[src][dst] = (idx, hom)
            matches[dst][src] = (np.fliplr(idx), reverse_homography(hom))
        LOG.info("Matched features, time: %s", time.time() - start)

        matches = {i: col for i, col in matches.items() if col}
        kpts_arr = np.empty(n, dtype=object)
        for i, kp in enumerate(kpts_host):
            kpts_arr[i] = kp
        return kpts_arr, np.array(matches, dtype=object)


@profiling.span("keypoints")
def idx_to_keypoints(matches, kpts):
    """Keypoint indices -> homogeneous coords + confidence (the cache's
    rehydrated form, ``matches[i][j] = (pts (M, 6), hom, M)``)."""
    def _i_to_k(match, kpt1, kpt2):
        return np.concatenate([kpt1[match[:, 0]], kpt2[match[:, 1]]], axis=1)

    kpts = [np.concatenate([kp, np.ones((kp.shape[0], 1))], axis=1)
            for kp in kpts]
    matches = matches.item() if isinstance(matches, np.ndarray) else matches
    return {i: {j: (_i_to_k(m, kpts[i], kpts[j]), h, len(m))
                for j, (m, h) in col.items()}
            for i, col in matches.items()}


__all__ = ["gray_extract", "upload_extract", "msop_extract", "BucketStacks",
           "sift_buffers", "match_graph",
           "matching", "reverse_homography", "idx_to_keypoints"]
