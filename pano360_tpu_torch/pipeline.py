"""Detection + all-pairs match graph (counterpart of ``pano360_tpu.pipeline``).

Produces the JAX package's cache structure exactly:

- ``kpts``: object array of per-image float32 (N_i, 2) center-relative
  keypoints;
- ``matches[src][dst] = (match_idx (M, 2) int32, hom float64)`` for every
  connected ordered pair, the reverse edge being (fliplr, inv(hom));
- ``idx_to_keypoints`` rehydrates to homogeneous coords + confidence.

SIFT runs in batches of 4 images, each batch uploaded from pinned host
memory with a non-blocking copy so the next upload overlaps the current
extraction.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pano360_tpu_torch import match as pm
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


def upload_extract(imgs: List[np.ndarray], device: torch.device,
                   cfg: S.SiftConfig = S.SiftConfig()):
    """Upload the uint8 images in batches of 4 and extract each batch.

    Returns ``(stack (N, H, W, 3) uint8 on the device, SiftFeatures over
    all N)``; the stack is reused by the render, so the pixels cross the
    host link once. All images must share one shape.
    """
    if len({im.shape for im in imgs}) != 1:
        raise NotImplementedError(
            "mixed image shapes are not ported yet (ROADMAP Queue 1: "
            "mixed image shapes)")
    chunks, parts = [], []
    for b0 in range(0, len(imgs), BATCH):
        chunk = _upload(np.stack(imgs[b0:b0 + BATCH]), device)
        chunks.append(chunk)
        parts.append(gray_extract(chunk, cfg))
    stack = torch.cat(chunks, dim=0)
    feats = S.SiftFeatures(*[torch.cat(xs, dim=0) for xs in zip(*parts)])
    return stack, feats


def matching(imgs: List[np.ndarray], device, max_kpts: int = 4096,
             seed: int = 0, feats: Optional[S.SiftFeatures] = None,
             draw_fn: Optional[pm.DrawFn] = None):
    """All-pairs feature matching -> ``(kpts, matches)`` object arrays.

    ``feats``: precomputed features (from ``upload_extract``).
    ``draw_fn(pair_k, n_valid)``: optional RANSAC hypothesis draws per
    pair (index k into the a < b pair list); by default a
    ``torch.Generator`` on the device seeded with ``seed`` draws them.
    """
    if not imgs:
        raise ValueError("no images to process (empty directory?)")
    device = torch.device(device)
    n = len(imgs)
    start = time.time()
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
    # compact to the max valid count (pair cost scales with cap^2): valid
    # rows first in ascending order, so match indices index the compact
    # per-image keypoint lists of the cache
    ccap = max(64, 1 << max(cmax - 1, 0).bit_length())
    if ccap < cap:
        sel = torch.argsort((~va_buf).to(torch.uint8), dim=1,
                            stable=True)[:, :ccap]
        kp_buf = torch.gather(kp_buf, 1, sel[..., None].expand(-1, -1, 2))
        ds_buf = torch.gather(ds_buf, 1, sel[..., None].expand(
            -1, -1, ds_buf.shape[-1]))
        va_buf = (torch.arange(ccap, device=device)[None, :]
                  < torch.as_tensor(counts, device=device)[:, None])
        cap = ccap
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

    kpts_host = [kp_host[i][valid_np[i]].astype(np.float32)
                 for i in range(n)]
    remap = np.cumsum(valid_np, axis=1) - 1 if cap == cap0 else None
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
            matches[dst][src] = (np.fliplr(idx), np.linalg.inv(hom))
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


__all__ = ["gray_extract", "upload_extract", "matching", "idx_to_keypoints"]
