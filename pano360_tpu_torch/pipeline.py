"""Detection + all-pairs match graph (counterpart of ``pano360_tpu.pipeline``).

Produces the JAX package's cache structure exactly:

- ``kpts``: object array of per-image float32 (N_i, 2) center-relative
  keypoints;
- ``matches[src][dst] = (match_idx (M, 2) int32, hom float64)`` for every
  connected ordered pair, the reverse edge being (fliplr, inv(hom));
- ``idx_to_keypoints`` rehydrates to homogeneous coords + confidence.

SIFT runs in batches of 4 images, each batch uploaded from pinned host
memory with a non-blocking copy so the next upload overlaps the current
extraction. Mixed image sizes run one shape bucket at a time (SIFT and
MSOP alike) and the features come back in the input order.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pano360_tpu_torch import match as pm
from pano360_tpu_torch.features import msop as M
from pano360_tpu_torch.features import sift as S
from pano360_tpu_torch.ops.color import bgr2gray

LOG = logging.getLogger(__name__)
BATCH = 4


def _upload(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def gray_extract(stack_u8: torch.Tensor, cfg: S.SiftConfig) -> S.SiftFeatures:
    """(B, H, W, 3) uint8 BGR stack -> SIFT features of its gray images."""
    gray = bgr2gray(stack_u8.to(torch.float32) / 255.0)
    return S.sift_extract(gray, cfg)


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


def upload_extract(imgs: List[np.ndarray], device: torch.device,
                   cfg: S.SiftConfig = S.SiftConfig()):
    """Upload the uint8 images in batches of 4 and extract each batch.

    Returns ``(stack (N, H, W, 3) uint8 on the device, SiftFeatures over
    all N)``; the stack is reused by the render, so the pixels cross the
    host link once. Mixed image shapes run one shape bucket at a time:
    the stack is then a ``BucketStacks`` and the features are in the
    input order (every bucket shares the ``max_kpts`` capacity).
    """
    buckets = _shape_buckets(imgs)
    if len(buckets) != 1:
        feat_parts, order, stacks = [], [], []
        for idxs in buckets.values():
            st, f = upload_extract([imgs[i] for i in idxs], device, cfg)
            feat_parts.append(f)
            order.extend(idxs)
            stacks.append((idxs, st))
        inv = _input_order(order, device)
        feats = S.SiftFeatures(*[torch.cat(xs, dim=0)[inv]
                                 for xs in zip(*feat_parts)])
        return BucketStacks(stacks), feats
    chunks, parts = [], []
    for b0 in range(0, len(imgs), BATCH):
        chunk = _upload(np.stack(imgs[b0:b0 + BATCH]), device)
        chunks.append(chunk)
        parts.append(gray_extract(chunk, cfg))
    stack = torch.cat(chunks, dim=0)
    feats = S.SiftFeatures(*[torch.cat(xs, dim=0) for xs in zip(*parts)])
    return stack, feats


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
              < torch.as_tensor(counts, device=dev)[:, None])
    return kp_buf, ds_buf, va_buf


def msop_extract(imgs: List[np.ndarray], device: torch.device,
                 stats=None) -> M.MsopFeatures:
    """Upload the uint8 images and run the device-resident MSOP
    extraction once per shape bucket: -> the features of all images in
    the input order, keypoints relative to each image's centre and the
    buffers compacted valid first."""
    n = len(imgs)
    kpts: List[Optional[np.ndarray]] = [None] * n
    parts, order = [], []
    for (h, w), idxs in _shape_buckets(imgs).items():
        stack = _upload(np.stack([imgs[i] for i in idxs]), device)
        kp_host, kp, ds, va, counts = M.msop_extract_device(stack,
                                                            stats=stats)
        cent = np.array([w / 2, h / 2], np.float32)
        for i, k in zip(idxs, kp_host):
            kpts[i] = k - cent
        parts.append((kp - torch.as_tensor(cent, device=device), ds, va,
                      counts))
        order.extend(idxs)
    counts = np.concatenate([p[3] for p in parts])
    cmax = int(counts.max()) if len(counts) else 0
    cap = min(max(64, 1 << max(cmax - 1, 0).bit_length()),
              max(int(p[0].shape[1]) for p in parts))
    bufs = [valid_first(*p, cap) for p in parts]
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


def matching(imgs: List[np.ndarray], device, max_kpts: int = 4096,
             seed: int = 0, feats=None,
             draw_fn: Optional[pm.DrawFn] = None, detector: str = "sift",
             stats=None):
    """All-pairs feature matching -> ``(kpts, matches)`` object arrays.

    ``detector``: "sift" (RootSIFT, 128-d) or "msop" (64-d oriented
    patches, no RootSIFT). ``feats``: precomputed features of that
    detector (``SiftFeatures`` from ``upload_extract``, ``MsopFeatures``
    from ``msop_extract``). ``draw_fn(pair_k, n_valid)``: optional RANSAC
    hypothesis draws per pair (index k into the a < b pair list); by
    default a ``torch.Generator`` on the device seeded with ``seed``
    draws them. ``stats``: an optional dict for ``msop_extract``'s
    counts.
    """
    if not imgs:
        raise ValueError("no images to process (empty directory?)")
    if detector not in ("sift", "msop"):
        raise ValueError(f"detector must be sift or msop, got {detector!r}")
    device = torch.device(device)
    n = len(imgs)
    start = time.time()
    if detector == "msop":
        if feats is None:
            feats = msop_extract(imgs, device, stats)
        kpts_host, kp_buf, ds_buf, va_buf = feats[:4]
        cap = int(kp_buf.shape[1])
        remap = None                # compact already
    else:
        if feats is None:
            _, feats = upload_extract(imgs, device,
                                      S.SiftConfig(max_kpts=max_kpts))
        cents = torch.tensor([[im.shape[1] / 2, im.shape[0] / 2]
                              for im in imgs], dtype=torch.float32,
                             device=device)
        kp_buf = feats.xy - cents[:, None, :]
        ds_buf = S.root_sift(feats.desc)
        va_buf = feats.valid
        cap0 = cap = int(kp_buf.shape[1])
        kp_host = kp_buf.cpu().numpy()
        valid_np = va_buf.cpu().numpy()
        counts = valid_np.sum(axis=1)
        cmax = int(counts.max())
        # compact to the max valid count (pair cost scales with cap^2)
        ccap = max(64, 1 << max(cmax - 1, 0).bit_length())
        if ccap < cap:
            kp_buf, ds_buf, va_buf = valid_first(kp_buf, ds_buf, va_buf,
                                                  counts, ccap)
            cap = ccap
        kpts_host = [kp_host[i][valid_np[i]].astype(np.float32)
                     for i in range(n)]
        # match indices of uncompacted buffers -> the compact lists
        remap = np.cumsum(valid_np, axis=1) - 1 if cap == cap0 else None
    LOG.info("Extracted keypoints, time: %s", time.time() - start)

    pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
    start = time.time()
    generator = None
    if draw_fn is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    # pairs per chunk bounded by the distance-matrix memory
    batch = max(1, min(16, (1 << 28) // max(cap * cap * 4, 1)))
    results = []
    for p0 in range(0, len(pairs), batch):
        chunk = pairs[p0:p0 + batch]
        pa = torch.tensor([p[0] for p in chunk], device=device)
        pb = torch.tensor([p[1] for p in chunk], device=device)
        res = pm.match_pairs(kp_buf, ds_buf, va_buf, pa, pb, first_pair=p0,
                             generator=generator, draw_fn=draw_fn)
        results.append(pm.PairMatch(*[t.cpu().numpy() for t in res]))

    matches: Dict[int, Dict[int, tuple]] = {i: {} for i in range(n)}
    k = 0
    for res in results:
        for j in range(res.ok.shape[0]):
            src, dst = pairs[k]
            k += 1
            if not bool(res.ok[j]):
                continue
            idx = res.idx[j][res.inlier[j]].astype(np.int32)
            if remap is not None:
                idx = np.stack([remap[src][idx[:, 0]],
                                remap[dst][idx[:, 1]]], axis=1
                               ).astype(np.int32)
            hom = res.hom[j].astype(np.float64)
            matches[src][dst] = (idx, hom)
            matches[dst][src] = (np.fliplr(idx), reverse_homography(hom))
    LOG.info("Matched features, time: %s", time.time() - start)

    matches = {i: col for i, col in matches.items() if col}
    kpts_arr = np.empty(n, dtype=object)
    for i, kp in enumerate(kpts_host):
        kpts_arr[i] = kp
    return kpts_arr, np.array(matches, dtype=object)


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
           "matching", "reverse_homography", "idx_to_keypoints"]
