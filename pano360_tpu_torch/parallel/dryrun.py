"""Multi-rank dryrun: the production pipeline over n ranks against one
process (counterpart of ``pano360_tpu.parallel.dryrun``).

Runs ``pipeline.matching`` (extraction sharded over images, the match
graph over pairs), ``register.traverse`` (bundle-adjustment edges
sharded) and ``render.stitch`` (warp and blend sharded over regions) in
n rank processes (``mesh.launch``), then the same functions on one
process, and asserts that the features and the match graph are equal,
the cameras agree (rotations within 5e-5, focal within 1e-4 relative,
the same LM iteration counts) and the mosaics are within ``MIN_PSNR_DB``.

Usage: ``python -m pano360_tpu_torch.parallel.dryrun N [--device
cuda|cpu] [--views V] [--shape H W]``. The device is ``cuda`` unless
the CPU is named. With ``--device cuda`` and fewer GPUs than ranks, the
ranks share the GPUs over gloo (one GPU: every rank on ``cuda:0``), which
is how the sharded code runs on a one-GPU machine at all: a correctness
configuration, not a speedup. Prints one line of results.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

MIN_PSNR_DB = 70.0
ROT_ATOL = 5e-5
FOCAL_RTOL = 1e-4


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def pipeline(mesh, imgs: List[np.ndarray], device="cuda",
             blender: str = "multiband", equalize: bool = False,
             crop: bool = False, detector: str = "sift", seed: int = 0,
             draw_fn=None, max_kpts: int = 4096) -> dict:
    """matching -> traverse (``--ba incr``) -> stitch on one process
    (``mesh`` None) or as one rank of ``mesh``: -> dict of ``kpts``,
    ``matches``, ``cams`` ((rot, intr) per placed view), ``lm_iterations``,
    ``polish_iterations``, ``mosaic`` and ``ranks`` (per rank: the
    stages' seconds, the seconds in collectives, the kernel launches,
    the peak device memory)."""
    from pano360_tpu_torch import render
    from pano360_tpu_torch._kernels import LAUNCHES
    from pano360_tpu_torch.pipeline import idx_to_keypoints, matching
    from pano360_tpu_torch.register import traverse
    dev = torch.device(device) if mesh is None else mesh.device
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    extra, secs = {}, {}
    t0 = time.perf_counter()
    kpts, matches = matching(imgs, dev, max_kpts=max_kpts, seed=seed,
                             draw_fn=draw_fn, detector=detector,
                             stats=extra, mesh=mesh)
    _sync(dev)
    secs["matching"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    regions = traverse(imgs, idx_to_keypoints(matches, kpts),
                       badjust="incr", device=dev, stats=extra, mesh=mesh)
    _sync(dev)
    secs["traverse"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mosaic = render.stitch(regions, blender=blender, equalize=equalize,
                           crop=crop, device=dev, mesh=mesh)
    _sync(dev)
    secs["stitch"] = time.perf_counter() - t0
    mine = dict(rank=0 if mesh is None else mesh.rank, seconds=secs,
                gather_seconds=0.0 if mesh is None else
                mesh.stats.get("gather_seconds", 0.0),
                gathers=0 if mesh is None else mesh.stats.get("gathers", 0),
                launches=dict(LAUNCHES),
                peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                          if dev.type == "cuda" else None))
    ranks = [mine] if mesh is None else mesh.all_gather_object(mine)
    return dict(kpts=kpts, matches=matches,
                cams=[(r.rot, r.intr) for r in regions],
                lm_iterations=extra.get("lm_iterations"),
                polish_iterations=extra.get("polish_iterations"),
                mosaic=mosaic, ranks=ranks)


def jobs(mesh, todo) -> list:
    """``fn(*args, mesh=mesh, **kwargs)`` for each ``(fn, args, kwargs)``
    of ``todo``, in order, as one rank of ``mesh`` (``fn`` a function of
    this package, which a spawned rank can import): -> the results. Lets
    one ``launch`` hold several sharded stages to their one-process
    runs."""
    return [fn(*args, mesh=mesh, **kwargs) for fn, args, kwargs in todo]


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float(np.mean(d * d))
    return 99.0 if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def matches_equal(a, b) -> bool:
    """Two match graphs (``matches`` object arrays) edge for edge, bit
    for bit."""
    a = a.item() if isinstance(a, np.ndarray) else a
    b = b.item() if isinstance(b, np.ndarray) else b
    if set(a) != set(b):
        return False
    for i in a:
        if set(a[i]) != set(b[i]):
            return False
        for j in a[i]:
            if not (np.array_equal(a[i][j][0], b[i][j][0])
                    and np.array_equal(a[i][j][1], b[i][j][1])):
                return False
    return True


def compare(mesh_res: dict, ref: dict) -> dict:
    """A mesh run against a one-process run of the same images (``ref``
    needs the same keys as ``pipeline``'s result, ``ranks`` aside): ->
    the comparison and ``ok`` for every gate."""
    feats = (len(mesh_res["kpts"]) == len(ref["kpts"])
             and all(np.array_equal(a, b) for a, b in
                     zip(mesh_res["kpts"], ref["kpts"])))
    graph = matches_equal(mesh_res["matches"], ref["matches"])
    placed = (len(mesh_res["cams"]), len(ref["cams"]))
    rot = focal = float("inf")
    if placed[0] == placed[1]:
        rot = max((float(np.abs(a[0] - b[0]).max()) for a, b in
                   zip(mesh_res["cams"], ref["cams"])), default=0.0)
        focal = max((abs(a[1][0, 0] - b[1][0, 0]) / abs(b[1][0, 0]) for a, b
                     in zip(mesh_res["cams"], ref["cams"])), default=0.0)
    lm = (mesh_res["lm_iterations"] == ref["lm_iterations"]
          and mesh_res["polish_iterations"] == ref["polish_iterations"])
    same = mesh_res["mosaic"].shape == ref["mosaic"].shape
    db = psnr(mesh_res["mosaic"], ref["mosaic"]) if same else float("-inf")
    out = dict(features_equal=feats, match_graph_equal=graph, placed=placed,
               rot_max_diff=rot, focal_max_rel_diff=float(focal),
               lm_iterations_equal=lm, mosaic_shape=mesh_res["mosaic"].shape,
               mosaic_psnr_db=db)
    out["ok"] = bool(feats and graph and placed[0] == placed[1]
                     and rot <= ROT_ATOL and focal <= FOCAL_RTOL and lm
                     and db >= MIN_PSNR_DB)
    return out


def run(n: int, device="cuda", views: Optional[int] = None,
        shape=(64, 96), overlap: float = 0.5, seed: int = 0,
        blender: str = "multiband", equalize: bool = False,
        crop: bool = False, max_kpts: int = 256) -> dict:
    """The pipeline over n ranks, then on one process (on the CPU at the
    ranks' thread count), on ``views`` (default n) synthetic views of
    ``shape`` (``max_kpts`` 256 at the default tiny shape, as the JAX
    package's dryrun); raises unless every gate of ``compare`` holds. ->
    the comparison, with the per-rank stats."""
    from pano360_tpu_torch import synth
    from pano360_tpu_torch.parallel.mesh import launch, rank_threads
    imgs, _, _ = synth.make_views(n_views=views or n, shape=tuple(shape),
                                  overlap=overlap, seed=seed)
    u8 = [np.clip(im * 255, 0, 255).astype(np.uint8) for im in imgs]
    opts = (blender, equalize, crop, "sift", 0, None, max_kpts)
    mesh_res = launch(pipeline, n, device, u8, device, *opts)
    threads = torch.get_num_threads()
    if torch.device(device).type == "cpu":
        torch.set_num_threads(rank_threads(n))    # the ranks' reductions
    try:
        ref = pipeline(None, u8, device, *opts)
    finally:
        torch.set_num_threads(threads)
    out = compare(mesh_res, ref)
    out["ranks"] = mesh_res["ranks"]
    if not out["ok"]:
        raise AssertionError(f"mesh run differs from one process: {out}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=2,
                    help="rank processes")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--views", type=int, default=None,
                    help="synthetic views (default: n)")
    ap.add_argument("--shape", type=int, nargs=2, default=(64, 96))
    args = ap.parse_args(argv)
    from pano360_tpu_torch import resolve_device
    device = resolve_device(args.device)
    out = run(args.n, device.type, args.views, args.shape)
    shape = out["mosaic_shape"]
    print(f"dryrun({args.n}): ok on {device.type} x{args.n} ranks — "
          f"matching/traverse/stitch sharded, mosaic {shape[1]}x{shape[0]}, "
          f"parity vs one process {out['mosaic_psnr_db']:.1f} dB; "
          + json.dumps({k: v for k, v in out.items()
                        if k not in ("mosaic_shape",)}, default=str),
          flush=True)


__all__ = ["pipeline", "jobs", "compare", "matches_equal", "psnr", "run",
           "main", "MIN_PSNR_DB", "ROT_ATOL", "FOCAL_RTOL"]


if __name__ == "__main__":
    sys.exit(main())
