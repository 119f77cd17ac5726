"""Command-line stitcher (counterpart of ``pano360_tpu.cli``).

Same flags, defaults and cache files as the JAX package
(``matches_{name}_s{shrink}.npz``, ``ba_{name}_s{shrink}.pkl``), plus
``--device`` (default ``cuda``; the CPU runs only when named).
``--mesh N`` runs the pipeline over N rank processes
(``parallel.mesh.launch``): N is clamped to the GPUs there are with
``--device cuda`` (one GPU runs the single-process path, as the JAX CLI
does on one chip) and is N gloo ranks with ``--device cpu``.

``run`` = ``load_images`` + ``run_images(imgs, args, name)``; the latter
is the entry point for in-memory images (``chip_smoke.py``).

Usage: ``python -m pano360_tpu_torch.cli <dir> -s 1 -o mosaic.png``
"""
from __future__ import annotations

import argparse
import contextlib
import io
import logging
import os
import pickle
import sys
import zipfile
from typing import List, Optional

import numpy as np
import torch

from pano360_tpu_torch import profiling, render, resolve_device
from pano360_tpu_torch.imageio import imread, imwrite, list_images
from pano360_tpu_torch.pipeline import (idx_to_keypoints, matching,
                                        upload_extract)
from pano360_tpu_torch.profiling import StageTimer
from pano360_tpu_torch.register import traverse

LOG = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Stitch images.")
    parser.add_argument("path", type=str,
                        help="directory with the images to process.")
    parser.add_argument("-s", "--shrink", type=float, default=2,
                        help="downsample the images by this amount.")
    parser.add_argument("--ba", default="incr",
                        choices=["none", "incr", "last"],
                        help="bundle adjustment type.")
    parser.add_argument("--equalize", "-e", action="store_true",
                        help="equalize image gain before stitching.")
    parser.add_argument("--crop", "-c", action="store_true",
                        help="remove the black borders.")
    parser.add_argument("--blend", "-b", default="multiband",
                        choices=list(render.BLENDERS.keys()),
                        help="blending algorithm.")
    parser.add_argument("-o", "--out", type=str,
                        help="save result to this file")
    parser.add_argument("--detector", default="sift",
                        choices=["sift", "msop"], help="feature detector.")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the RANSAC hypothesis generator.")
    parser.add_argument("--cache-dir", default=".",
                        help="directory for the match/BA cache files.")
    parser.add_argument("--max-resolution", type=int,
                        default=render.MAX_RESOLUTION,
                        help="cap on the mosaic's longest side.")
    parser.add_argument("--projection", default="spherical",
                        choices=["spherical", "cylindrical"],
                        help="output projection surface.")
    parser.add_argument("--warp", default="auto",
                        choices=list(render.WARP_POLICIES),
                        help="warp policy: auto and xla run the exact "
                             "backward-warp kernel; pallas runs the "
                             "mip-sampled kernel (anti-aliased under "
                             "minification).")
    parser.add_argument("--mesh", type=int, default=0,
                        help="run over this many rank processes (clamped "
                             "to the GPUs there are with --device cuda).")
    parser.add_argument("--show", action="store_true",
                        help="display the mosaic in an image viewer.")
    parser.add_argument("--profile", action="store_true",
                        help="cProfile the host pipeline and print a "
                             "per-stage wall-clock report.")
    parser.add_argument("--trace-dir", type=str, default=None,
                        help="write a torch.profiler (Chrome trace) of "
                             "the run to this directory.")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda).")
    return parser


def mesh_ranks(args) -> int:
    """The rank processes ``--mesh N`` runs: N, clamped with a warning
    to ``torch.cuda.device_count()`` with a CUDA device (the JAX CLI's
    clamp); N gloo ranks on the CPU. 1 means the single-process path."""
    n = args.mesh or 0
    if n <= 1:
        return 1
    have = (torch.cuda.device_count()
            if resolve_device(args.device).type == "cuda" else n)
    if have < n:
        LOG.warning("--mesh %d requested but only %d device(s) available; "
                    "using %d", n, have, have)
    return max(1, min(n, have))


def shrink_images(imgs: List[np.ndarray], shrink: float,
                  device) -> List[np.ndarray]:
    """uint8 BGR images resized by 1/shrink (cv2 linear), for shrink > 1."""
    from pano360_tpu_torch.ops.resize import resize_bilinear
    if shrink <= 1:
        return imgs
    out = []
    for im in imgs:
        h, w = im.shape[:2]
        small = resize_bilinear(
            torch.as_tensor(im.astype(np.float32), device=device),
            (round(h / shrink), round(w / shrink)))
        out.append(np.clip(small.cpu().numpy(), 0, 255).astype(np.uint8))
    return out


def load_images(path: str, shrink: float, device) -> List[np.ndarray]:
    """uint8 BGR images of a directory, resized by 1/shrink."""
    return shrink_images([imread(f) for f in list_images(path)], shrink,
                         device)


class _CacheUnpickler(pickle.Unpickler):
    """Loads only this package's classes and numpy's array helpers."""

    _NUMPY = {"_reconstruct", "ndarray", "dtype", "_frombuffer", "scalar"}
    _ROOTS = ("pano360_tpu_torch",)
    WHAT = "BA cache"

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in self._ROOTS or (root == "numpy" and name in self._NUMPY):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"{self.WHAT} holds {module}.{name}, which this package does not "
            "load (a cache written by another package?): delete the cache")


class _NpzUnpickler(_CacheUnpickler):
    """The object arrays of a ``matches_*.npz``: numpy's array helpers
    and the builtin containers and numbers only."""

    _ROOTS = ()
    _BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int",
                 "float", "complex", "bool", "str", "bytes", "slice"}
    WHAT = "match cache"

    def find_class(self, module, name):
        if module == "builtins" and name in self._BUILTINS:
            return super(_CacheUnpickler, self).find_class(module, name)
        return super().find_class(module, name)


def load_ba_cache(path: str):
    """Regions from a ``ba_*.pkl`` cache written by this package."""
    with open(path, "rb") as fid:
        return _CacheUnpickler(fid).load()


def _npz_member(zf: zipfile.ZipFile, key: str) -> np.ndarray:
    buf = io.BytesIO(zf.read(key + ".npy"))
    major, _ = np.lib.format.read_magic(buf)
    read = (np.lib.format.read_array_header_1_0 if major == 1
            else np.lib.format.read_array_header_2_0)
    _, _, dtype = read(buf)
    if dtype.hasobject:
        return _NpzUnpickler(buf).load()
    buf.seek(0)
    return np.lib.format.read_array(buf, allow_pickle=False)


def load_match_cache(path: str):
    """``(kpts, matches)`` of a ``matches_*.npz`` cache of either package
    (the two share one layout). Its object arrays are read through a
    restricted unpickler, which refuses any class but numpy's arrays and
    the builtin containers."""
    with zipfile.ZipFile(path) as zf:
        return _npz_member(zf, "kpts"), _npz_member(zf, "matches")


def _stitch(mesh, imgs: List[np.ndarray], args, name: str, draw_fn,
            matched, regions, timer: Optional[StageTimer] = None,
            capture: bool = True):
    """Match (unless ``matched`` holds the match cache's ``(kpts,
    matches)``), register (unless ``regions`` holds the BA cache's) and
    render. One process, or one rank of ``mesh``: then rank 0 alone
    writes the caches. -> (mosaic or None without connected images, the
    stage seconds, the stages' counts)."""
    timer = timer or StageTimer()
    device = resolve_device(args.device) if mesh is None else mesh.device
    write = mesh is None or mesh.rank == 0
    dev_images = None
    if matched is None:
        with timer.stage("Matched features"):
            feats = None
            if args.detector == "sift" and mesh is None:
                dev_images, feats = upload_extract(imgs, device,
                                                   capture=capture)
            kpts, matches = matching(imgs, device, seed=args.seed,
                                     feats=feats, draw_fn=draw_fn,
                                     detector=args.detector,
                                     stats=timer.extra, mesh=mesh,
                                     capture=capture)
            if write:
                np.savez(os.path.join(args.cache_dir,
                                      f"matches_{name}.npz"),
                         kpts=kpts, matches=matches)
    else:
        kpts, matches = matched
    if regions is None:
        with timer.stage("Image registration"):
            regions = traverse(imgs, idx_to_keypoints(matches, kpts),
                               badjust=args.ba, device=device,
                               stats=timer.extra, mesh=mesh,
                               capture=capture)
        if write:
            with open(os.path.join(args.cache_dir, f"ba_{name}.pkl"),
                      "wb") as fid:
                pickle.dump(regions, fid, protocol=pickle.HIGHEST_PROTOCOL)
    mosaic = None
    if regions:
        with timer.stage("Built mosaic"):
            mosaic = render.stitch(regions, blender=args.blend,
                                   equalize=args.equalize, crop=args.crop,
                                   dev_images=dev_images,
                                   max_resolution=args.max_resolution,
                                   warp=args.warp,
                                   projection=args.projection,
                                   device=device, mesh=mesh)
    return mosaic, timer.stages, timer.extra


def run_images(imgs: List[np.ndarray], args, name: str,
               timer: Optional[StageTimer] = None, draw_fn=None,
               capture: bool = True):
    """Stitch in-memory uint8 BGR images; ``name`` keys the caches.

    ``draw_fn(pair_k, n_valid)``: optional RANSAC draws (tests inject the
    JAX package's; picklable, e.g. ``match.DrawTable``, under
    ``--mesh``). ``capture``: on a card, SIFT's extraction, the match
    graph and the registration's steps are replayed from CUDA graphs;
    False runs the same steps eagerly (the CPU and ``--mesh`` always
    do). SIFT uploads the images once for extraction and render
    (one stack per shape when the sizes are mixed); MSOP extracts inside
    ``matching`` and the render uploads. The caches are read here, before
    any rank starts. Returns the uint8 BGR mosaic.
    """
    timer = timer or StageTimer()
    device = resolve_device(args.device)
    if not imgs:
        raise ValueError("no images to process (empty directory?)")
    matched = regions = None
    try:
        matched = load_match_cache(
            os.path.join(args.cache_dir, f"matches_{name}.npz"))
    except IOError:
        pass
    try:
        regions = load_ba_cache(os.path.join(args.cache_dir,
                                             f"ba_{name}.pkl"))
    except IOError:
        pass
    ranks = mesh_ranks(args)
    if ranks > 1:
        from pano360_tpu_torch.parallel.mesh import launch
        mosaic, stages, extra = launch(_stitch, ranks, device, imgs, args,
                                       name, draw_fn, matched, regions)
        timer.stages.update(stages)
        timer.extra.update(extra)
    else:
        mosaic, _, _ = _stitch(None, imgs, args, name, draw_fn, matched,
                               regions, timer, capture)
    if mosaic is None:
        raise SystemExit(
            "no connected images: the match graph is empty (need "
            "overlapping views with enough texture)")
    return mosaic


def run(args, timer: Optional[StageTimer] = None) -> np.ndarray:
    """Stitch the images of ``args.path`` (the CLI's main path)."""
    timer = timer or StageTimer()
    device = resolve_device(args.device)
    name = f"{os.path.basename(os.path.normpath(args.path))}_s{args.shrink}"
    with timer.stage("Loaded images"):
        imgs = load_images(args.path, args.shrink, device)
    return run_images(imgs, args, name, timer)


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """torch.profiler over the run, saved as a Chrome trace, with the
    program's spans (``profiling.span``) as ranges on its timeline."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof, profiling.annotated():
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def main(argv=None):
    args = build_parser().parse_args(argv)
    timer = StageTimer()
    with device_trace(args.trace_dir):
        if args.profile:
            mosaic = profiling.profile(run, args, timer)
        else:
            mosaic = run(args, timer)
    if args.profile:
        print(timer.report())
    if args.out:
        imwrite(args.out, mosaic)
        print(f"saved {args.out} ({mosaic.shape[1]}x{mosaic.shape[0]})")
    if args.show:
        if os.environ.get("DISPLAY") or sys.platform == "darwin":
            from PIL import Image
            Image.fromarray(mosaic[..., ::-1]).show()
        else:
            LOG.warning("--show: no display available (headless host); "
                        "use -o to save the mosaic instead")
    return mosaic


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
