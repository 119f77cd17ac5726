"""Carry state across from the JAX package, given as numpy arrays.

These let one stage's JAX output feed the port's next stage (the tests
hold each port stage against its JAX counterpart this way). Nothing here
imports jax: the JAX objects are read through their attributes.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from pano360_tpu_torch.features.msop import MsopFeatures
from pano360_tpu_torch.features.sift import SiftConfig, SiftFeatures
from pano360_tpu_torch.register import PanoImage


def sift_config_from_jax(cfg) -> SiftConfig:
    """A ``pano360_tpu`` SiftConfig -> the port's. Raises on what the
    port does not carry: ``gauss_mode='direct'`` and a bfloat16
    ``patch_dtype``. The JAX ``pallas`` and ``incremental`` modes are one
    scale space here (the octave kernel and the chain agree to f32
    rounding)."""
    if cfg.gauss_mode not in ("pallas", "incremental"):
        raise ValueError(f"gauss_mode {cfg.gauss_mode!r} is not ported")
    if cfg.patch_dtype != "float32":
        raise ValueError(f"patch_dtype {cfg.patch_dtype!r} is not ported")
    keep = ("n_layers", "sigma", "init_sigma", "contrast_thresh",
            "edge_thresh", "max_kpts", "img_border",
            "refine_iters", "n_orientations", "ori_bins", "descr_width",
            "descr_ori_bins", "descr_samples", "descr_mag_thresh",
            "sel_shift", "upscale", "descr_mode")
    return SiftConfig(**{k: getattr(cfg, k) for k in keep})


def features_from_jax(feats, device="cpu") -> SiftFeatures:
    """``SiftFeatures`` fields (arrays) -> the port's tensors."""
    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return SiftFeatures(xy=t(feats.xy, torch.float32),
                        size=t(feats.size, torch.float32),
                        angle=t(feats.angle, torch.float32),
                        response=t(feats.response, torch.float32),
                        desc=t(feats.desc, torch.float32),
                        valid=t(feats.valid, torch.bool))


def msop_level_from_jax(level, device="cpu"):
    """One MSOP pyramid level of the JAX package, ``(vals, rows, cols,
    theta, blurred, next_gray)`` as arrays -> the port's tensors (float32,
    the candidate rows and columns int64)."""
    vals, rows, cols, theta, blurred, nxt = level

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return (t(vals), t(rows, torch.int64), t(cols, torch.int64), t(theta),
            t(blurred), t(nxt))


def msop_features_from_jax(extracted, img_shape, device="cpu") -> MsopFeatures:
    """``pano360_tpu.features.msop.msop_extract_device``'s result for
    same-shape images of ``img_shape`` (h, w) -> what the port's
    ``pipeline.matching(detector="msop", feats=...)`` takes: keypoints
    relative to the image centre and the device buffers compacted valid
    first, as the JAX ``matching`` prepares them."""
    from pano360_tpu_torch.pipeline import valid_first
    kpts_full, kp, ds, va, counts = extracted
    h, w = img_shape
    cent = np.array([w / 2, h / 2], np.float32)
    counts = np.asarray(counts)
    kp = torch.as_tensor(np.asarray(kp) - cent, dtype=torch.float32,
                         device=device)
    ds = torch.as_tensor(np.asarray(ds), dtype=torch.float32, device=device)
    va = torch.as_tensor(np.asarray(va), dtype=torch.bool, device=device)
    cmax = int(counts.max()) if len(counts) else 0
    cap = min(max(64, 1 << max(cmax - 1, 0).bit_length()), int(kp.shape[1]))
    kp, ds, va = valid_first(kp, ds, va, counts, cap)
    return MsopFeatures([np.asarray(k) - cent for k in kpts_full], kp, ds,
                        va, counts)


def regions_from_jax(regions) -> List[PanoImage]:
    """Registered JAX ``PanoImage``s -> the port's (rot, focal, img)."""
    return [PanoImage(np.asarray(r.img), np.asarray(r.rot, np.float64),
                      np.asarray(r.intr, np.float64)) for r in regions]


def matches_from_npz(path: str):
    """(kpts, matches) from a ``matches_*.npz`` cache of either package
    (the two share one structure; ``cli.load_match_cache``)."""
    from pano360_tpu_torch.cli import load_match_cache
    return load_match_cache(path)


__all__ = ["sift_config_from_jax", "features_from_jax",
           "msop_level_from_jax", "msop_features_from_jax",
           "regions_from_jax", "matches_from_npz"]
