#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Usage: ``python3 chip_smoke.py`` (no arguments; needs one CUDA card)

Phases (any failure exits non-zero):

1. device: CUDA present; torch/CUDA versions, card name and power limit;
2. build: compile ``pano360_tpu_torch/csrc/*.cu`` with nvcc, and print
   ptxas's report (registers, spills) of the octave kernel (its dynamic
   shared memory per launch is in phase 3);
3. kernel 1 (octave stack) vs its plain PyTorch version on the card, at
   every octave of the bench images where the kernel runs (batch 4):
   bit for bit and no score flip at every octave; each octave's kernel
   time, its bound and the share of the bound;
   B. SIFT's tail (``ops.sift_tail``: the refinement with its Newton
   steps, the orientation and the grid descriptor) vs the plain versions
   (the refinement's: the steps on the dense Newton field), bit for
   bit, on the inputs of the bench world's first upload batch (its 9
   octaves' DoG stacks and candidates, its keypoints), recorded from one
   eager extraction: each kernel's launch, device time with the L2
   flushed, bound, plain version, and the PyTorch call of the same
   function where one exists (the histogram's one-hot ``torch.matmul``,
   the descriptor binning's contraction); ptxas's report of each;
   C. SIFT's front end (``ops.sift_front``: the base image, upsampled and
   blurred, and the small octaves' chain, DoG and score) vs the plain
   versions, bit for bit, on the bench world's first upload batch (its
   base and its octaves 6-8, recorded from one eager extraction): each
   kernel's launch, device time with the L2 flushed, bound and plain
   version (no single PyTorch call computes either); the base without
   the upsample (``upscale=False``) bit for bit; ptxas's report;
   D. RANSAC's scoring (``ops.ransac``: every hypothesis of a chunk of
   pairs against every correspondence, the first best and its mask) vs
   the plain scorer, bit for bit (every count, the winner's homography
   and mask), on the bench world's first chunk of pairs, recorded from
   one eager match graph (with the graph's first top-2 call, for F): the
   launch, the device time of its two
   kernels with the L2 flushed, the bound and the plain version (no
   single PyTorch call computes it); ptxas's report;
   E. the multiband blend's blur (``ops.band_blur``) vs the plain
   ``gaussian_blur``, bit for bit, on a stack of the rig cell's shape
   (33 patches of 352x1408x4, random, invalid corners zeroed) at the
   blend's four sigmas (33, 57, 73, 87 taps): each level's launch, the
   device time of its two kernels with the L2 flushed, the bound and
   the plain version, and the four levels' sums; ptxas's report;
   F. the match's top-2 search (``ops.knn2``) vs the plain chain and
   float64 on the bench world's first chunk of pairs (recorded in D:
   the main path's RootSIFT rows and ragged masks; its numbers go to
   the kernels line), then at MSOP's chunk (one pair of 8192 64-d rows,
   6,500 valid a side) and the rig's (16 pairs of 2048 RootSIFT rows,
   1,950 valid a side), random descriptors of each kind with noisy
   copies: no row a float32 search may not give
   (``measure.knn2_misses``; the gate), the rows that differ from
   float64 and from the chain; the launch, the device time of its norms,
   search and merge kernels with the L2 flushed, the bound over the
   valid columns and the plain version (no single PyTorch call computes
   it); ptxas's report;
4. kernel 2 (backward warp) vs its plain version at the bench's render
   layout, bit for bit with no mask flip: the launch with a prepared
   plan, the prepare step (host), the device time per launch, the bound
   and the taps' sector floor, and ``grid_sample``'s gather on its
   sample grid;
5. the CLI main path (``cli.run_images``) on the bench dataset (15 views
   of 864x1152, seed 42, overlap 0.45): a cold run (it captures the
   extraction's and the match graph's CUDA graphs) and a warm one
   (replays), per-stage seconds, peak device memory (allocated, and
   reserved by where the allocator keeps it), kernel launch
   counts (the warm run's are the main path's: SIFT's front end 4 and
   12, its tail 36, 4 and 4 inside the replays, RANSAC's scoring and
   the top-2 search once a chunk of pairs, as in 3 D, the blend's blur
   once a level, 4;
   neither the mip warp nor the
   orientation's block design), three more warm runs'
   stage seconds, registration accuracy against the synthetic ground
   truth, and a cached re-run; SIFT's extraction and the match graph
   replayed against the same steps run eagerly (features and match rows
   bit for bit; seconds and host syncs of each); on the match cache
   ``register.traverse`` with its add, LM and polish steps replayed from
   CUDA graphs against the same steps run eagerly (the same cameras bit
   for bit, the same LM counts; seconds per iteration and host syncs per
   traverse of each), and ``BundleAdjuster`` on the card against the
   CPU;
6. profile: one more uncached run of the main path under
   ``torch.profiler``: device busy time, the device's idle share, the
   device operations that take the most time, and the kernels' entries;
   the launches of the octave kernel, of SIFT's front end and tail, of
   RANSAC's scoring and the top-2 search in the profile (inside the
   replays) and of the
   blend's blur (its rows kernel) equal to their counts, the front
   end's 4 and 12, the tail's 36, 4 and 4, the blur's 4;
7. render options, each path with the kernel counts
   (``_kernels.LAUNCHES``) set to 0 just before it and read just after:
   B. ``-e -c --warp pallas`` on the bench views at known per-view
      exposures (cold and warm, uncached): 15 of 15 placed, the
      recovered gain ratios of adjacent views, the mip plan (``ok``,
      at least 2 levels; ``plan_windows`` and ``build_mips`` timed),
      kernel 3 (mip-sampled warp) vs its plain version at that plan, as
      kernel 2 in phase 4, and its crop rectangle inside its valid
      mask, the native crop library loaded;
   C. ``--max-resolution 4000`` from phase 5's caches: a mosaic wider
      than 1400 px;
   D. ``--projection cylindrical -c`` from the same caches, and kernel 2
      vs its plain version in cylindrical mode at D's layout;
8. the MSOP detector, mixed image sizes and the extras, the kernel counts
   set to 0 just before each path and read just after:
   A. ``--detector msop`` through ``cli.run_images`` at full size on
      the 15 bench views and on five 864x1152 views (the JAX package's
      own MSOP configuration), and on the latter at the CLI's default
      ``-s 2``, uncached, at each seed of ``MSOP_RUNS``. Whether MSOP
      registers a world depends on the RANSAC draws in both packages
      (see ``MSOP_RUNS``), so each run's outcome is reported (placed
      views, focal and rotation errors, initial focal, edges under the
      bundle adjustment's gate, LM iterations; a registered run's cached
      re-run must be identical) and the gates are on what no draw
      changes: the native library loaded (SSC runs there), the
      extraction's counts, no SIFT kernel launched, RANSAC's scoring and
      the top-2 search launched, and every truly overlapping pair joined
      by an
      edge with enough inliers whose homography gives the true relative
      rotation; then the extraction alone on the 15 full-size bench
      views (seconds, counts, SSC's share), the top device operations
      of a profiled extraction and match graph, and its candidate
      ordering timed beside ``torch.topk``;
   B. mixed image sizes: the same world with the odd-numbered views at
      768x1024, ``-e -c`` with SIFT (cold and warm): 15 of 15 placed,
      phase 5's registration bounds, the octave kernel, SIFT's tail and
      the exact warp launched, the crop rectangle inside its valid mask;
      the
      replayed extraction and match graph against the eager ones, as in
      phase 5;
   C. kernel 2 with per-image true sizes vs its plain version at B's
      layout, bit for bit, as in phase 4;
   D. the extras: ``blend_extra.demo`` on two 864x1152 views (warp,
      graph-cut seam, Laplacian blend, Poisson blend): uint8 results of
      the expected shapes, the Poisson residual fallen, each step's
      seconds;
9. the mesh and the dense descriptor:
   A. the production pipeline (``parallel.dryrun.pipeline``: matching,
      ``--ba incr``, multiband) over 2 rank processes that share the one
      GPU over gloo, on phase 5's views, held to phase 5's one-process
      run: features and match graph equal, 15 of 15 placed within phase
      5's bounds, the same LM iteration counts, the mosaic >= 70 dB, the
      octave kernel, SIFT's tail and the exact warp launched in each rank
      (counted per rank); each rank's stage seconds, seconds in
      collectives and peak memory. In the same launch ``distributed_lm_stats`` of 137 random
      edges, bit for bit one process's; in this process the bundle
      adjuster's per-edge terms of every shard of those edges over 2, 3
      and 4 ranks, bit for bit the one-process rows. Then the pipeline
      at ``-e -c`` on phase 8 B's mixed-size views against a one-process
      run, and ``--mesh 2`` through the CLI, which on one GPU warns and
      runs the one-process path;
   B. the orientation kernel's block design, which the dense mode's
      80x80 patches take, against its plain version on the keypoints of
      the first upload batch under ``descr_mode='dense'``, as in 3 B
      (bit for bit, times, bound, the one-hot ``torch.matmul``);
      ``upload_extract`` with ``descr_mode='dense'`` on the bench views
      beside the grid descriptor's (time, peak memory): the same
      keypoints, descriptors of unit norm; the CLI with
      ``PANO_SIFT_DESCR=dense`` registers within phase 5's bounds and
      launches the orientation kernel's block design
      (``sift_orient_block``, its launches in the kernels line) but not
      the grid descriptor; one
      ``upscale=False`` extraction (keypoints, time);
10. the kernels line.

Phase 5 also holds ``render.add_weights``'s per-image branch, fed the
uniform sizes, to its uniform branch on the bench stack (within 1e-6;
they are not bit-equal on the card).

Times: CUDA events over ``REPS`` calls (a warp's and ``grid_sample``'s
over 50), kernel and plain version in turns; a
warp's ``ms`` is its launch with a prepared plan, its
``device_ms`` the kernel alone (``torch.profiler``, the L2 flushed
before each launch, so that the bound's device-memory rate applies;
back to back it is logged too) and its ``plan_ms``
the prepare step on the host (once per render; see
``pano360_tpu_torch.measure``). ``bound_ms`` is the least time of the
same work on an H100
(bytes over 3.35 TB/s or operations over the f32 peak, counted from this
run's inputs by the ops modules' ``*_cost`` helpers; SIFT's tail counts
the samples, texels and field words its inputs need). ``library_ms``
times ``torch.nn.functional.grid_sample`` (bilinear, reflection,
align_corners=False) on each warp's own sample grid, built outside the
timed window: the gather alone, without the ray mapping, the mask or
the seam; no PyTorch call computes the octave stack, SIFT's front end or
the refinement (null); for the orientation the one-hot
``torch.matmul`` of the histogram and for the descriptor the binning's
contraction (``torch.matmul``), the JAX package's forms, inputs built
outside the timed window. The refinement's ``ms``, ``plain_ms`` and
``bound_ms`` are per upload batch (9 launches), the small octave's too
(3 launches), the other kernels' per launch; the entries of SIFT's
front end and tail also carry ``device_ms``.

The last lines are one JSON object per kernel (``{"kernels": [...]}``),
the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

BENCH_VIEWS, BENCH_SEED = 15, 42     # measure.bench_views's world
REPS = 5
# phase 7 B: per-view exposure factors, and the bound on
# max |log(g_i a_i / (g_j a_j))| over adjacent views. The JAX package's
# estimate_gains reaches 0.0032 and 0.0020 on this world with the true
# cameras at 216x288 and 432x576 (CPU); the bound is a few times above.
EXPOSURE = np.random.default_rng(BENCH_SEED).uniform(0.7, 1.0, BENCH_VIEWS)
GAIN_LOG_BOUND = 0.01
# phase 8 A: MSOP's worlds, seeds and bounds. Besides the bench world, the
# JAX package's own MSOP configuration (benchmarks/run_configs.py,
# cmu1_like_msop: 5 views, overlap 0.5, seed 13, -s 2) at the bench's
# image size, at full size and at the CLI's default -s 2. Whether MSOP
# registers a world depends on the RANSAC draws, in both packages: its
# 64-d patch descriptors also give views that share no pixel 8 or more
# ratio-test matches, which is all an edge needs besides 4 RANSAC
# inliers; the initial focal is the median over every edge's homography,
# those included, and an edge enters the bundle adjustment only under an
# initial RMSE of 150 px, whatever the image size. So the registration is
# run at every seed of MSOP_SEEDS and reported, and the gates are on what
# no draw changes: the extraction's counts, and every pair of views that
# truly overlap joined by an edge of at least MSOP_MIN_INLIERS inliers
# whose homography gives the true relative rotation within
# MSOP_EDGE_ROT_BOUND_DEG (the JAX package's own test of MSOP holds a
# pair's homography to 1 deg; on the CPU it gives these edges 166-255
# inliers). A run counts as registered when every view is placed with the
# focal within MSOP_FOCAL_BOUND and the mean relative rotation within
# MSOP_ROT_MEAN_BOUND_DEG (the JAX package, CPU, where it registers the
# 5 views at -s 2: 0.00081 and 0.0674 deg).
BENCH_WORLD = dict(n_views=BENCH_VIEWS, shape=(864, 1152), overlap=0.45,
                   seed=BENCH_SEED)
MSOP_WORLD = dict(n_views=5, shape=(864, 1152), overlap=0.5, seed=13)
# (label, world, shrink, seeds)
MSOP_RUNS = (("15 bench views at full size", BENCH_WORLD, 1, (0, 1)),
             ("5 views at full size", MSOP_WORLD, 1, (0, 1, 2)),
             ("5 views at -s 2", MSOP_WORLD, 2, (0, 1, 2)))
MSOP_MIN_INLIERS = 50
MSOP_EDGE_ROT_BOUND_DEG = 1.0
MSOP_FOCAL_BOUND = 0.008
MSOP_ROT_MEAN_BOUND_DEG = 0.5
BASE_FLAGS = ["-s", "1", "--ba", "incr", "-b", "multiband"]


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


T_START = time.time()


def log(msg: str):
    """Print; a phase's heading also says the seconds since the start."""
    if msg.startswith("phase "):
        msg += f" [{time.time() - T_START:.0f} s]"
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_octave(torch, u8):
    from pano360_tpu_torch.features import sift as S
    from pano360_tpu_torch.measure import alternate, octave_bases
    from pano360_tpu_torch.ops import gauss_octave as G
    cfg = S.SiftConfig()
    taps = G.chain_taps(cfg.sigma, cfg.n_layers)
    score_cfg = (0.5 * cfg.contrast_thresh / cfg.n_layers, cfg.edge_thresh,
                 cfg.img_border)
    t_kernel = t_plain = bytes_ms = flops_ms = 0.0
    bases = octave_bases(u8, cfg)
    for o, octv in bases:
        n, h, w = octv.shape
        out = G.octave_stack(octv, taps, score_cfg)
        ref = G.octave_stack_ref(octv, taps, score_cfg)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        n_cand = int((ref[2] > 0).sum())
        flips = int(((out[2] > 0) != (ref[2] > 0)).sum())
        check(err == 0.0 and flips == 0,
              f"octave_stack octave {o}: max|d| {err}, {flips} score flips")
        tp, tk = alternate(lambda: G.octave_stack_ref(octv, taps, score_cfg),
                           lambda: G.octave_stack(octv, taps, score_cfg),
                           REPS)
        cost = G.octave_stack_cost(n, h, w, taps)
        ty, tx, smem = G.kernel_tile(taps, n, h, w)
        log(f"  octave {o} {h}x{w}: max|d| {err}, candidates {n_cand}, "
            f"flips {flips}; kernel {tk:.4f} ms, plain {tp:.3f} ms, bound "
            f"{cost['bound_ms']:.4f} ms ({cost['bound_by']}), share "
            f"{cost['bound_ms'] / tk:.3f}; tile {ty}x{tx} ({smem} bytes "
            f"shared), {G.kernel_taps_per_px(n, h, w, taps):.1f} taps per px")
        t_kernel += tk
        t_plain += tp
        bytes_ms += cost["bytes_ms"]
        flops_ms += cost["flops_ms"]
        del out, ref
    check(len(bases) > 0, "octave_stack ran on no octave")
    bound = max(bytes_ms, flops_ms)
    bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
    log(f"  octaves {bases[0][0]}-{bases[-1][0]}: kernel {t_kernel:.4f} ms, "
        f"plain {t_plain:.3f} ms, bound {bound:.4f} ms ({bound_by}), share "
        f"{bound / t_kernel:.3f}")
    return dict(max_abs_err=0.0, ms=t_kernel, plain_ms=t_plain,
                bound_ms=bound, bound_by=bound_by, library_ms=None)


# SIFT's tail: (wrapper, kernel and count name, source, the JAX
# computation replaced)
SIFT_TAIL_LINE = (
    ("refine", "sift_refine", "sift_refine.cu",
     "pano360_tpu/features/sift.py:403 and :488 (XLA fusion)"),
    ("orientation", "sift_orient", "sift_orient.cu",
     "pano360_tpu/features/sift.py:594 and :635 (XLA fusion)"),
    ("descriptors", "sift_descr", "sift_descr.cu",
     "pano360_tpu/features/sift.py:658 and :741 (XLA fusion)"))
SIFT_TAIL = tuple(row[0] for row in SIFT_TAIL_LINE)
# SIFT's tail's launches per warm panorama on the main path (inside the
# replays): the refinement at each of the 9 octaves of 4 upload batches,
# the orientation and the descriptor once a batch
TAIL_LAUNCHES = dict(sift_refine=36, sift_orient=4, sift_descr=4)
# SIFT's front end: (wrapper, kernel and count name, source, the JAX
# computation replaced)
SIFT_FRONT_LINE = (
    ("base_image", "sift_base", "sift_base.cu",
     "pano360_tpu/features/sift.py:164 (XLA fusion)"),
    ("small_octave", "sift_small_octave", "sift_small_octave.cu",
     "pano360_tpu/features/sift.py:216 and :308 (XLA fusion)"))
SIFT_FRONT = tuple(row[0] for row in SIFT_FRONT_LINE)
# its launches per warm panorama on the main path (inside the replays):
# the base once per upload batch (4), each of the 3 small octaves (6-8)
# once per batch
FRONT_LAUNCHES = dict(sift_base=4, sift_small_octave=12)
# the blend's blur: (kernel and count name, source, the JAX computation
# replaced); its calls a panorama (one a blurred level of the multiband
# blend's 5), the blend's sigmas, and the rig cell's patch stack
BAND_LINE = ("band_blur", "band_blur.cu",
             "pano360_tpu/render.py:593 (XLA fusion of gaussian_blur)")
BAND_LAUNCHES = 4
BAND_SIGMAS = tuple(float(np.sqrt(2 * lvl + 1.0) * 4)
                    for lvl in range(BAND_LAUNCHES))
RIG_STACK = (33, 352, 1408, 4)
# the kernels the default path does not take: the mip warp (``--warp
# pallas``) and the orientation's block design (``descr_mode='dense'``)
OFF_MAIN_PATH = ("backward_warp_mip", "sift_orient_block")
# device names of the kernels whose launches phase 6 holds to the profile
# (the orientation's: its grid design, a warp per keypoint)
PROFILED = {"octave_stack": "octave_stack_kernel",
            "sift_base": "p360_sift_base_kernel",
            "sift_small_octave": "p360_sift_small_octave_kernel",
            "sift_refine": "p360_sift_refine_kernel",
            "sift_orient": "p360_sift_orient_kernel",
            "sift_descr": "p360_sift_descr_kernel",
            "ransac_score": "p360_ransac_score_kernel",
            "knn2": "p360_knn2_kernel",
            "band_blur": "p360_band_blur_rows_kernel"}
# RANSAC's scoring: (wrapper, kernel and count name, source, the JAX
# computation replaced)
RANSAC_LINE = ("score", "ransac_score", "ransac_score.cu",
               "pano360_tpu/match.py:245-250 (XLA fusion)")
# the match's top-2 search: (kernel and count name, source, the JAX
# computation replaced) and the chunks phase 3 F times: (label, pairs,
# rows a side, width, valid rows a side), MSOP's one pair at width 8192
# (~6,500 keypoints a view) and the rig's 16 pairs at 2048 (~1,950)
KNN2_LINE = ("knn2", "knn2.cu",
             "pano360_tpu/match.py:57 knn2_matches (XLA fusion around the "
             "matrix product)")
KNN2_CHUNKS = (("MSOP", 1, 8192, 64, 6500), ("rig", 16, 2048, 128, 1950))
# the orientation kernel's block design, which the dense mode's 80x80
# patches take (phase 9 B; counted as sift_orient)
BLOCK_ORIENT_KERNEL = "p360_sift_orient_block_kernel"


def bits_equal(torch, a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def max_abs(torch, outs, refs) -> float:
    return max(float((a.double() - b.double()).abs().max()) if a.numel()
               else 0.0 for a, b in zip(outs, refs))


def phase_sift_tail(torch, u8):
    """3 B: the three kernels of SIFT's tail vs their plain versions on the
    bench world's first upload batch (4 views): the DoG stacks of its 9
    octaves (the refinement on its candidates, against the plain steps on
    the dense Newton field) and its keypoints (orientation, descriptor),
    recorded from one eager extraction; bit for bit; per kernel the
    launch (CUDA events), the device time with the L2 flushed
    (``torch.profiler``), the bound, the plain version and a PyTorch call
    of the same function where one exists (the one-hot ``torch.matmul``
    of the histogram, the binning's contraction, as the JAX package
    computes them). -> {wrapper: dict for the kernels line},
    ms, bound and plain summed over the octaves of the batch for the
    refinement."""
    from pano360_tpu_torch import _kernels, pipeline
    from pano360_tpu_torch.measure import recording
    from pano360_tpu_torch.ops import sift_tail as T
    dev = torch.device("cuda")
    with recording(T, SIFT_TAIL) as calls:
        pipeline.upload_extract(u8[:4], dev, capture=False)
    torch.cuda.synchronize()
    check([len(calls[k]) for k in SIFT_TAIL] == [9, 1, 1],
          f"3 B: recorded calls {[len(calls[k]) for k in SIFT_TAIL]}")
    device_name = {fn: PROFILED[kernel]
                   for fn, kernel, _, _ in SIFT_TAIL_LINE}
    out = {}
    for name in SIFT_TAIL:
        tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bytes_ms=0.0,
                   flops_ms=0.0, library_ms=None, max_abs_err=0.0)
        for args, kw in calls[name]:
            one = hold_tail_call(torch, name, args, kw, device_name[name],
                                 "3 B")
            for key in ("ms", "device_ms", "plain_ms", "bytes_ms",
                        "flops_ms"):
                tot[key] += one[key]
            tot["max_abs_err"] = max(tot["max_abs_err"], one["max_abs_err"])
            tot["library_ms"] = one["library_ms"]
        tot["bound_ms"] = max(tot["bytes_ms"], tot["flops_ms"])
        tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["flops_ms"]
                           else "operations")
        if len(calls[name]) > 1:
            log(f"  {name}, the batch's {len(calls[name])} octaves: kernel "
                f"{tot['ms']:.4f} ms, device {tot['device_ms']:.4f} ms, "
                f"bound {tot['bound_ms']:.4f} ms, plain "
                f"{tot['plain_ms']:.3f} ms")
        out[name] = tot
    log("  ptxas -v:" + "\n    ".join([""] + [
        ln.strip() for _, stem, _, _ in SIFT_TAIL_LINE
        for ln in _kernels.build_log(stem).splitlines()
        if ": Used" in ln or "spill" in ln]))
    del calls
    torch.cuda.empty_cache()
    return out


def phase_sift_front(torch, u8):
    """3 C: the two kernels of SIFT's front end vs their plain versions on
    the bench world's first upload batch (4 views), recorded from one
    eager extraction: the base of its gray views and its 3 small octaves
    (6-8); bit for bit, every output plane; per kernel the launch (CUDA
    events), the device time with the L2 flushed (``torch.profiler``),
    the bound and the plain version; no single PyTorch call computes
    either (library null). Then the base without the upsample
    (``upscale=False``), bit for bit. -> {wrapper: dict for the kernels
    line}, the small octave's ms, bound and plain summed over its 3
    octaves."""
    from pano360_tpu_torch import _kernels, pipeline
    from pano360_tpu_torch.features import sift as S
    from pano360_tpu_torch.measure import alternate, device_ms, recording
    from pano360_tpu_torch.ops import sift_front as F
    dev = torch.device("cuda")
    with recording(F, SIFT_FRONT) as calls:
        pipeline.upload_extract(u8[:4], dev, capture=False)
    torch.cuda.synchronize()
    check([len(calls[k]) for k in SIFT_FRONT] == [1, 3],
          f"3 C: recorded calls {[len(calls[k]) for k in SIFT_FRONT]}")
    out = {}
    for name, kernel, _, _ in SIFT_FRONT_LINE:
        tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bytes_ms=0.0,
                   flops_ms=0.0, library_ms=None, max_abs_err=0.0)
        for args, kw in calls[name]:
            x, cfg = args

            def kern():
                return getattr(F, name)(x, cfg)

            def ref():
                return getattr(F, f"{name}_ref")(x, cfg)
            got, want = kern(), ref()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            same = all(bits_equal(torch, a, b) for a, b in zip(got, want))
            err = max_abs(torch, got, want)
            del got, want
            tp, tk = alternate(ref, kern, REPS)
            td = device_ms(kern, PROFILED[kernel], REPS, flush=True)
            base = name == "base_image"
            cost = getattr(F, "base_cost" if base
                           else "small_octave_cost")(*x.shape, cfg)
            log(f"  {name} {tuple(x.shape)}: bit for bit {same} (max|d| "
                f"{err}); kernel {tk:.4f} ms, device {td:.4f} ms with the "
                f"L2 flushed, bound {cost['bound_ms']:.5f} ms "
                f"({cost['bound_by']}: {cost['bytes']} bytes, "
                f"{cost['flops']} operations), plain {tp:.3f} ms"
                + ("" if base else "; in shared memory "
                   f"{F.small_octave_in_shared(*x.shape[1:])}"))
            check(same, f"3 C: {name} {tuple(x.shape)} differs from its "
                  f"plain version (max|d| {err})")
            for key, v in (("ms", tk), ("device_ms", td), ("plain_ms", tp),
                           ("bytes_ms", cost["bytes_ms"]),
                           ("flops_ms", cost["flops_ms"])):
                tot[key] += v
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["bound_ms"] = max(tot["bytes_ms"], tot["flops_ms"])
        tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["flops_ms"]
                           else "operations")
        if len(calls[name]) > 1:
            log(f"  {name}, the batch's {len(calls[name])} octaves: kernel "
                f"{tot['ms']:.4f} ms, device {tot['device_ms']:.4f} ms, "
                f"bound {tot['bound_ms']:.5f} ms, plain "
                f"{tot['plain_ms']:.3f} ms")
        out[name] = tot
    gray = calls["base_image"][0][0][0]
    flat = S.SiftConfig(upscale=False)
    same = bits_equal(torch, F.base_image(gray, flat),
                      F.base_image_ref(gray, flat))
    log(f"  base_image {tuple(gray.shape)}, upscale=False (13 taps): bit "
        f"for bit {same}")
    check(same, "3 C: base_image with upscale=False differs from its "
          "plain version")
    log("  ptxas -v:" + "\n    ".join([""] + [
        ln.strip() for _, stem, _, _ in SIFT_FRONT_LINE
        for ln in _kernels.build_log(stem).splitlines()
        if ": Used" in ln or "spill" in ln or (
            "Compiling entry" in ln and "ILi11ELb1E" in ln)]))
    del calls, gray
    torch.cuda.empty_cache()
    return out


def phase_ransac(torch, u8):
    """3 D: RANSAC's scoring kernel vs the plain scorer on the bench
    world's first chunk of pairs, recorded from one eager match graph:
    every hypothesis's count, the winner's homography and its mask bit
    for bit; the launch (CUDA events), the device time of its two
    kernels with the L2 flushed (``torch.profiler``), the bound and the
    plain version; no single PyTorch call computes it (library null).
    The same match graph's first top-2 call is recorded for 3 F.
    -> (dict for the kernels line, the match graph's chunks, that call's
    arguments)."""
    from pano360_tpu_torch import _kernels, pipeline
    from pano360_tpu_torch.measure import alternate, device_ms, recording
    from pano360_tpu_torch.ops import knn2 as K
    from pano360_tpu_torch.ops import ransac as R
    dev = torch.device("cuda")
    _, feats = pipeline.upload_extract(u8, dev, capture=False)
    _, kp, ds, va, _ = pipeline.sift_buffers(u8, feats)
    with recording(R, ("score",)) as calls, \
            recording(K, ("knn2",)) as top2:
        pipeline.match_graph(kp, ds, va, capture=False)
    torch.cuda.synchronize()
    chunks = len(calls["score"])
    args = calls["score"][0][0]
    top2_args = top2["knn2"][0][0]
    del top2
    b, k, m = args[0].shape[0], args[0].shape[1], args[1].shape[1]
    got, want = R.score_counts(*args), R.score_ref(*args)
    same = all(bits_equal(torch, a, c) for a, c in zip(got, want))
    # a pair whose winner is not finite (a pair with no valid point)
    # carries its NaNs in both
    err = max_abs(torch, [torch.nan_to_num(got[0])],
                  [torch.nan_to_num(want[0])])
    n_best = int(want[2].max(-1).values.sum())
    del got, want, calls
    tp, tk = alternate(lambda: R.score_ref(*args), lambda: R.score(*args),
                       REPS)
    td = {part: device_ms(lambda: R.score(*args), f"p360_ransac_{part}",
                          REPS, flush=True) for part in ("score", "select")}
    cost = R.ransac_score_cost(b, k, m)
    log(f"  score, first of {chunks} chunks (B {b}, K {k}, M {m}): bit for "
        f"bit {same} (max|d| {err}; winners' inliers {n_best}); kernel "
        f"{tk:.4f} ms, device {td['score']:.4f} + {td['select']:.4f} ms "
        f"with the L2 flushed, bound {cost['bound_ms']:.5f} ms "
        f"({cost['bound_by']}: {cost['bytes']} bytes, {cost['flops']} "
        f"operations), plain {tp:.3f} ms")
    check(same, f"3 D: the scoring kernel differs from the plain scorer "
          f"(max|d| {err})")
    log("  ptxas -v:" + "\n    ".join([""] + [
        ln.strip() for ln in _kernels.build_log("ransac_score").splitlines()
        if ": Used" in ln or "spill" in ln]))
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=tk, device_ms=td["score"] + td["select"],
                plain_ms=tp, bound_ms=cost["bound_ms"],
                bound_by=cost["bound_by"], library_ms=None), chunks, top2_args


def phase_band_blur(torch):
    """3 E: the blend's blur vs ``gaussian_blur`` on a random stack of the
    rig cell's shape (each patch's invalid corner zeroed, its alpha 0 or
    1) at the blend's four sigmas: bit for bit; each level's launch (CUDA
    events), the device time of its rows and columns kernels with the L2
    flushed, the bound and the plain version; no single PyTorch call
    computes it (library null). -> dict for the kernels line, the four
    levels summed."""
    from pano360_tpu_torch import _kernels
    from pano360_tpu_torch.measure import alternate, device_ms
    from pano360_tpu_torch.ops.band_blur import band_blur, band_blur_cost
    from pano360_tpu_torch.ops.filters import auto_ksize, gaussian_blur
    g = torch.Generator(device="cuda").manual_seed(BENCH_SEED)
    x = torch.rand(RIG_STACK, generator=g, device="cuda")
    x[..., 3] = (x[..., 3] > 0.3).to(torch.float32)
    n, h, w, _ = RIG_STACK
    for i in range(n):
        x[i, :(i * 11) % h + 1, :(i * 43) % w + 1] = 0.0
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bytes_ms=0.0,
               flops_ms=0.0, library_ms=None, max_abs_err=0.0)
    for sigma in BAND_SIGMAS:
        k = auto_ksize(sigma)
        got, want = band_blur(x, sigma), gaussian_blur(x, sigma)
        same = bits_equal(torch, got, want)
        err = max_abs(torch, [got], [want])
        del got, want
        tp, tk = alternate(lambda: gaussian_blur(x, sigma),
                           lambda: band_blur(x, sigma), REPS)
        td = {part: device_ms(lambda: band_blur(x, sigma),
                              f"p360_band_blur_{part}", REPS, flush=True)
              for part in ("rows", "cols")}
        cost = band_blur_cost(n, h, w, k)
        log(f"  sigma {sigma:.3f} ({k} taps) on {RIG_STACK}: bit for bit "
            f"{same} (max|d| {err}); kernel {tk:.4f} ms, device "
            f"{td['rows']:.4f} + {td['cols']:.4f} ms with the L2 flushed, "
            f"bound {cost['bound_ms']:.4f} ms ({cost['bound_by']}: "
            f"{cost['bytes']} bytes, {cost['flops']} operations; "
            f"{100 * cost['bound_ms'] / (td['rows'] + td['cols']):.1f} % of "
            f"it), plain {tp:.3f} ms")
        check(same, f"3 E: band_blur at sigma {sigma} differs from "
              f"gaussian_blur (max|d| {err})")
        for key, v in (("ms", tk), ("device_ms", td["rows"] + td["cols"]),
                       ("plain_ms", tp), ("bytes_ms", cost["bytes_ms"]),
                       ("flops_ms", cost["flops_ms"])):
            tot[key] += v
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
    tot["bound_ms"] = max(tot["bytes_ms"], tot["flops_ms"])
    tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["flops_ms"]
                       else "operations")
    log(f"  the four levels: kernel {tot['ms']:.4f} ms, device "
        f"{tot['device_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
        f"({100 * tot['bound_ms'] / tot['device_ms']:.1f} %), plain "
        f"{tot['plain_ms']:.3f} ms")
    log("  ptxas -v:" + "\n    ".join([""] + [
        ln.strip() for ln in _kernels.build_log("band_blur").splitlines()
        if ": Used" in ln or "spill" in ln]))
    del x
    torch.cuda.empty_cache()
    return tot


def hold_knn2(torch, label, d1, d2, v1, v2):
    """One chunk of the top-2 search against the plain chain and float64:
    no row a float32 search may not give (the gate); the launch (CUDA
    events), the device time of its norms, search and merge kernels with
    the L2 flushed, the bound over the chunk's valid columns and the plain
    version. -> dict for the kernels line (an index output: the rows off
    float64 beyond the margin and the rows differing from the plain
    chain, no error magnitude)."""
    from pano360_tpu_torch.measure import alternate, device_ms, knn2_misses
    from pano360_tpu_torch.ops.knn2 import knn2, knn2_cost, knn2_ref, slices
    (b, m1, d), m2 = d1.shape, d2.shape[1]
    got, want = knn2(d1, d2, v1, v2, 0.7), knn2_ref(d1, d2, v1, v2, 0.7)
    (k_wrong, k_differ), (p_wrong, p_differ) = knn2_misses(
        [got, want], d1, d2, v1, v2)
    between = int((v1 & ((got[0] != want[0]) | (got[1] != want[1]))).sum())
    n_good = int(got[1].sum())
    del got, want
    tp, tk = alternate(lambda: knn2_ref(d1, d2, v1, v2, 0.7),
                       lambda: knn2(d1, d2, v1, v2, 0.7), REPS)
    td = {part: device_ms(lambda: knn2(d1, d2, v1, v2, 0.7),
                          f"p360_knn2_{part}", REPS, flush=True)
          for part in ("norms", "kernel", "merge")}
    cols = int(v2.sum())
    cost = knn2_cost(b, m1, m2, d, cols=cols)
    dev_ms = sum(td.values())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"  {label} chunk (B {b}, M1 {m1}, M2 {m2}, D {d}; valid rows "
        f"{int(v1.sum())} and columns {cols} in all; "
        f"{slices(b, m1, m2, sms)} slices): rows off float64 beyond the "
        f"margin {k_wrong} (chain {p_wrong}); rows differing from float64 "
        f"{k_differ} (chain {p_differ}), from the chain {between}; good "
        f"{n_good}; kernel {tk:.4f} ms, device {td['norms']:.4f} + "
        f"{td['kernel']:.4f} + {td['merge']:.4f} ms (norms, search, merge) "
        f"with the L2 flushed, bound {cost['bound_ms']:.4f} ms over the "
        f"valid columns ({cost['bound_by']}: {cost['bytes']} bytes, "
        f"{cost['flops']} operations; {100 * cost['bound_ms'] / dev_ms:.1f}"
        f" % of it), plain {tp:.3f} ms")
    check(k_wrong == 0, f"3 F: {label}: {k_wrong} rows off float64 beyond "
          "the rounding margin")
    return dict(rows_off_float64=k_wrong, rows_differing=between, ms=tk,
                device_ms=dev_ms, plain_ms=tp, bound_ms=cost["bound_ms"],
                bound_by=cost["bound_by"], library_ms=None)


def phase_knn2(torch, bench_args):
    """3 F: the top-2 search (``hold_knn2``) on the bench world's first
    chunk of pairs (``bench_args``, recorded in 3 D: the main path's
    RootSIFT rows and ragged masks), then at MSOP's and the rig's chunks
    (``KNN2_CHUNKS``, random rows with a valid prefix a side); no single
    PyTorch call computes it (library null). -> dict for the kernels
    line, of the bench's chunk (the others logged)."""
    from pano360_tpu_torch import _kernels
    from pano360_tpu_torch.measure import knn2_inputs
    d1, d2, v1, v2 = bench_args[:4]
    row = hold_knn2(torch, "bench", d1, d2, v1, v2)
    for label, b, m, d, n_valid in KNN2_CHUNKS:
        d1, d2, v1, v2 = (t.cuda() for t in knn2_inputs(
            b, m, m, d, seed=BENCH_SEED, ragged=False))
        v1[:, n_valid:] = False
        v2[:, n_valid:] = False
        hold_knn2(torch, label, d1, d2, v1, v2)
        del d1, d2, v1, v2
        torch.cuda.empty_cache()
    log("  ptxas -v:" + "\n    ".join([""] + [
        ln.strip() for ln in _kernels.build_log("knn2").splitlines()
        if ": Used" in ln or "spill" in ln]))
    return row


def hold_tail_call(torch, name, args, kw, device_name, phase):
    """One recorded call of a SIFT tail wrapper against its plain version:
    bit for bit (fails otherwise), the launch and the plain version in
    turns (CUDA events), the device time of the kernel named
    ``device_name`` with the L2 flushed, the bound and the library call's
    time. -> dict(ms, device_ms, plain_ms, bytes_ms, flops_ms, bound_ms,
    bound_by, library_ms, max_abs_err)."""
    from pano360_tpu_torch.features import sift as S
    from pano360_tpu_torch.measure import alternate, device_ms
    from pano360_tpu_torch.ops import sift_tail as T
    plain = dict(
        refine=lambda dog, l0, y0, x0, cfg: S._refine(
            dog, S._newton_step_field(dog), l0, y0, x0, cfg),
        orientation=lambda *a, cfg: S._peak_angles(
            S._orientation_hist(*a, cfg), cfg),
        descriptors=S._descriptors)[name]

    def kern():
        return getattr(T, name)(*args, **kw)

    def ref():
        return plain(*args, **kw)
    got, want = kern(), ref()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    same = all(bits_equal(torch, a, b) for a, b in zip(got, want))
    err = max_abs(torch, got, want)
    del got, want
    tp, tk = alternate(ref, kern, REPS)
    td = device_ms(kern, device_name, REPS, flush=True)
    cfg = kw["cfg"] if "cfg" in kw else args[-1]   # refine's: positional
    cost, lib, shape = _tail_cost(torch, T, S, cfg, name, args)
    log(f"  {name} {shape}: bit for bit {same} (max|d| {err}); "
        f"kernel {tk:.4f} ms, device {td:.4f} ms with the L2 "
        f"flushed, bound {cost['bound_ms']:.4f} ms "
        f"({cost['bound_by']}: {cost['bytes']} bytes, "
        f"{cost['flops']} operations), plain {tp:.3f} ms"
        + ("" if lib is None else f", library {lib:.4f} ms"))
    check(same, f"{phase}: {name} {shape} differs from its plain "
          f"version (max|d| {err})")
    return dict(ms=tk, device_ms=td, plain_ms=tp, bytes_ms=cost["bytes_ms"],
                flops_ms=cost["flops_ms"], bound_ms=cost["bound_ms"],
                bound_by=cost["bound_by"], library_ms=lib, max_abs_err=err)


def _tail_cost(torch, T, S, cfg, name, args):
    """(the bound of one recorded call, its library ms or None, its shape
    for the log)."""
    from pano360_tpu_torch.measure import timed

    def timed_warm(fn):
        fn()
        return timed(fn, REPS)
    if name == "refine":
        dog, l0, y0, x0 = args[:4]
        return (T.refine_cost(dog, l0, y0, x0, cfg), None,
                f"{tuple(l0.shape)} on {tuple(dog.shape)}")
    gx = args[0]
    m, psg = gx.shape[:2]
    if name == "orientation":
        gx, gy, y, x, pcy, pcx, sig, oh, ow = args
        cost = T.orientation_cost(y, x, pcy, pcx, sig, oh, ow, psg)
        val, bins = S._orientation_samples(*args, cfg)
        onehot = (bins[:, :, None] == torch.arange(
            cfg.ori_bins, device=gx.device)).float()
        lhs = val[:, None, :]
        lib = timed_warm(lambda: torch.matmul(lhs, onehot))
        del onehot, lhs, val, bins
        return cost, lib, f"{m} keypoints, {psg}x{psg} patches"
    gx, gy, yf, xf, pcy, pcx, sig, angle, oh, ow = args
    cost = T.descriptors_cost(yf, xf, pcy, pcx, sig, angle, oh, ow, psg, cfg)
    val, oh_o, wrc = S._descriptor_samples(*args, cfg)
    rhs, lhs = val[..., None] * oh_o, wrc.T.contiguous()
    lib = timed_warm(lambda: torch.matmul(lhs, rhs))
    del rhs, val, oh_o
    return cost, lib, f"{m} keypoints x {angle.shape[1]} orientations"


def hold_warp(name, row):
    """Gates of a warp kernel against its plain version (``measure``'s
    row): bit for bit, no mask flip, the mask a bool tensor. Logs the
    times: the launch with a prepared plan, the prepare step, the
    device time, the plain version, the bound and sector floor,
    ``grid_sample``."""
    log(f"  {row['n']} patches of {row['ph']}x{row['pw']}: max|d| "
        f"{row['max_abs_err']}, mask flips {row['flips']}, invalid "
        f"{row['invalid_dtype']}; launch {row['ms']:.4f} ms (plan "
        f"{row['plan_ms'] * 1e3:.1f} us on the host), device "
        f"{row['device_ms']:.4f} ms with the L2 flushed "
        f"({row['device_warm_ms']:.4f} back to back), plain "
        f"{row['plain_ms']:.3f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {row['bytes']} "
        f"bytes; {row['sectors']} sectors, floor "
        f"{row['sector_floor_ms']:.4f} ms), grid_sample "
        f"{row['library_ms']} ms; host per call: launch "
        f"{row['launch_host_ms'] * 1e3:.1f} us, grid_sample "
        f"{row['library_host_ms'] * 1e3:.1f} us")
    check(row["identical"] and row["flips"] == 0
          and row["invalid_dtype"] == "torch.bool",
          f"{name}: max|d| {row['max_abs_err']}, {row['flips']} mask flips, "
          f"invalid {row['invalid_dtype']}")
    return row


def hold_exact_warp(regions, projection="spherical"):
    """Kernel 2 vs its plain version at a render layout."""
    from pano360_tpu_torch.measure import measure_exact, warp_inputs
    rgba, small, lay = warp_inputs(regions, projection)
    log(f"  layout ({projection}): canvas {lay.shape}, period "
        f"{lay.period}")
    row = measure_exact(rgba, small, lay.ph, lay.pw, lay.period,
                        projection == "cylindrical")
    row.pop("_out")
    return hold_warp("backward_warp", row)


def warp_times(row):
    """A warp's times for the kernels line: the launch with a prepared
    plan, the plain version, the bound, ``grid_sample``, the device time
    per launch and the prepare step (host ms)."""
    return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "device_ms", "plan_ms")}


def phase_warp(u8, rots, focal):
    from pano360_tpu_torch.register import PanoImage
    intr = np.diag([focal, focal, 1.0])
    regions = [PanoImage(im, r, intr.copy()) for im, r in zip(u8, rots)]
    return hold_exact_warp(regions)


def rel_rot_errors_deg(regs, rots):
    errs = []
    for i in range(len(regs) - 1):
        est = regs[i + 1].rot @ regs[i].rot.T
        true = rots[i + 1] @ rots[i].T
        c = np.clip((np.trace(est @ true.T) - 1) / 2, -1, 1)
        errs.append(np.degrees(np.arccos(c)))
    return np.array(errs)


def registration_errors(regs, rots, focal):
    """(largest relative focal error, relative-rotation errors in deg)."""
    foc = np.array([r.intr[0, 0] for r in regs])
    return float(np.abs(foc - focal).max() / focal), \
        rel_rot_errors_deg(regs, rots)


def phase_slice(torch, u8, rots, focal, chunks):
    from pano360_tpu_torch import cli
    from pano360_tpu_torch._kernels import LAUNCHES
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    runs = {}
    walls = {}
    for label in ("cold", "warm"):
        cache = os.path.join(work, label)
        os.makedirs(cache)
        args = cli.build_parser().parse_args(
            [cache, "-s", "1", "--ba", "incr", "-b", "multiband",
             "--cache-dir", cache])
        timer = cli.StageTimer()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
        t0 = time.time()
        mosaic = cli.run_images(u8, args, "bench_s1.0", timer)
        torch.cuda.synchronize()
        total = time.time() - t0
        walls[label] = total
        launches = dict(LAUNCHES)
        off = {k: launches.pop(k) for k in OFF_MAIN_PATH}
        check(not any(off.values()), f"the default path took {off}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        reserved = torch.cuda.max_memory_reserved() / 2 ** 30
        stages = {k: round(v, 4) for k, v in timer.stages.items()}
        log(f"  {label} run: {total:.3f} s; stages {stages}; peak device "
            f"memory {peak:.2f} GiB ({reserved:.2f} GiB reserved); BA edges "
            f"{timer.extra['ba_edges']}; LM iterations "
            f"{timer.extra['lm_iterations']} + polish "
            f"{timer.extra['polish_iterations']}; launches {launches}")
        runs[label] = (args, mosaic, timer.extra)
    log(f"  reserved after the warm run, GiB: {reserved_split(torch)}")
    # the warm run replays every graph: its counts are the main path's
    # (the cold run's also count the eager first runs of the captures)
    check(all(v > 0 for v in launches.values()),
          f"main path did not launch every kernel: {launches}")
    check(all(launches[k] == v for k, v in TAIL_LAUNCHES.items()),
          f"SIFT's tail on the main path: {launches}, not {TAIL_LAUNCHES}")
    check(all(launches[k] == v for k, v in FRONT_LAUNCHES.items()),
          f"SIFT's front end on the main path: {launches}, not "
          f"{FRONT_LAUNCHES}")
    check(launches["ransac_score"] == chunks, f"RANSAC's scoring on the "
          f"main path: {launches['ransac_score']}, not {chunks} chunks")
    check(launches["knn2"] == chunks, f"the top-2 search on the main "
          f"path: {launches['knn2']}, not {chunks} chunks")
    check(launches["band_blur"] == BAND_LAUNCHES, f"the blend's blur on the "
          f"main path: {launches['band_blur']}, not {BAND_LAUNCHES}")
    for rep in range(3):
        cache = os.path.join(work, f"again{rep}")
        os.makedirs(cache)
        again_args = cli.build_parser().parse_args(
            [cache, *BASE_FLAGS, "--cache-dir", cache])
        timer = cli.StageTimer()
        t0 = time.time()
        cli.run_images(u8, again_args, "bench_s1.0", timer)
        torch.cuda.synchronize()
        stages = {k: round(v, 4) for k, v in timer.stages.items()}
        log(f"  warm run again ({rep + 1} of 3): {time.time() - t0:.3f} s; "
            f"stages {stages}")

    args, mosaic, _ = runs["warm"]
    regs = cli.load_ba_cache(os.path.join(args.cache_dir,
                                          "ba_bench_s1.0.pkl"))
    check(len(regs) == BENCH_VIEWS, f"{len(regs)} of {BENCH_VIEWS} placed")
    f_err, r_err = registration_errors(regs, rots, focal)
    log(f"  focal max rel err {f_err:.5f}; rel-rot err mean "
        f"{r_err.mean():.4f} max {r_err.max():.4f} deg")
    check(f_err <= 0.005, f"focal error {f_err}")
    check(r_err.mean() <= 0.1, f"mean relative rotation error {r_err.mean()}")
    check(mosaic.dtype == np.uint8 and mosaic.ndim == 3
          and mosaic.shape[2] == 3 and min(mosaic.shape[:2]) > 0,
          f"mosaic {mosaic.shape} {mosaic.dtype}")
    check(max(mosaic.shape[:2]) <= 1400, f"mosaic {mosaic.shape} > 1400")
    check(mosaic.any(), "mosaic is empty")
    again = cli.run_images(u8, args, "bench_s1.0")
    check(np.array_equal(again, mosaic), "cached re-run differs")
    log(f"  mosaic {mosaic.shape}; cached re-run identical")
    hold_add_weights(torch, u8)
    kpts, matches = cli.load_match_cache(os.path.join(
        args.cache_dir, "matches_bench_s1.0.npz"))
    hold_features(torch, u8, "bench world")
    hold_traverse(torch, u8, kpts, matches)
    hold_bundle_adjuster(regs, kpts, matches)
    extra = runs["warm"][2]
    ref = dict(kpts=kpts, matches=matches, mosaic=mosaic,
               cams=[(r.rot, r.intr) for r in regs],
               lm_iterations=extra["lm_iterations"],
               polish_iterations=extra["polish_iterations"])
    return launches, walls["warm"], args.cache_dir, ref


def reserved_split(torch) -> dict:
    """The caching allocator's reserved GiB by where it is kept: blocks
    of the default pool on the current stream and on the capture stream
    (a captured step's eager first run), and the CUDA graphs' pools."""
    from pano360_tpu_torch import graphs
    names = {torch.cuda.current_stream().cuda_stream: "current stream"}
    names.update({s.cuda_stream: "capture stream"
                  for s in graphs._STREAMS.values()})
    out = {}
    for seg in torch.cuda.memory_snapshot():
        key = ("graph pools" if tuple(seg.get("segment_pool_id", (0, 0)))
               != (0, 0) else names.get(seg["stream"], "other streams"))
        out[key] = out.get(key, 0.0) + seg["total_size"] / 2 ** 30
    return {k: round(v, 2) for k, v in sorted(out.items())}


def hold_features(torch, u8, label):
    """SIFT's extraction and the match graph replayed from CUDA graphs
    against the same steps run eagerly (``capture=False``) on ``u8``: the
    features (every ``SiftFeatures`` field) and the match rows (indices,
    inlier masks, homographies, inlier counts, ``ok``) bit for bit; each
    one's seconds (host clock ending in a sync; the graphs were captured
    by the runs before) and host syncs."""
    from pano360_tpu_torch import pipeline
    from pano360_tpu_torch.features.sift import SiftFeatures
    from pano360_tpu_torch.match import PairMatch
    from pano360_tpu_torch.measure import synced, host_syncs
    dev = torch.device("cuda")
    out = {}
    for capture, name in ((True, "replayed"), (False, "eager")):
        def extract():
            return pipeline.upload_extract(u8, dev, capture=capture)[1]
        t_ex, feats = synced(extract)
        _, kp, ds, va, _ = pipeline.sift_buffers(u8, feats)

        def graph():
            return pipeline.match_graph(kp, ds, va, capture=capture)
        t_mg, rows = synced(graph)
        syncs = [sum(host_syncs(fn)[1].values()) for fn in (extract, graph)]
        log(f"  {label}, {name}: extraction {t_ex:.4f} s ({syncs[0]} host "
            f"syncs), match graph of {len(rows.ok)} pairs {t_mg:.4f} s "
            f"({syncs[1]} host syncs), {int(rows.ok.sum())} edges")
        out[capture] = (feats, rows)
    (fr, rr), (fe, re) = out[True], out[False]
    fr, fe = ([t.cpu().numpy() for t in f] for f in (fr, fe))
    # the bits (a pair without a homography has NaNs, which no
    # comparison of values calls equal)
    differ = [f for f, a, b in zip(SiftFeatures._fields + PairMatch._fields,
                                   [*fr, *rr], [*fe, *re])
              if a.dtype != b.dtype or a.shape != b.shape
              or a.tobytes() != b.tobytes()]
    log(f"  {label}: replayed vs eager, features and match rows bit for "
        f"bit: {'equal' if not differ else f'differ in {differ}'}")
    check(not differ, f"{label}: the replayed extraction or match graph "
          f"differs from the eager one in {differ}")


def hold_traverse(torch, u8, kpts, matches):
    """``register.traverse`` with its add, LM and polish steps replayed
    from CUDA graphs against the same steps run eagerly, on phase 5's match
    cache: the same cameras bit for bit and the same LM counts; each
    one's seconds (the median of four runs in turns after a first), per
    LM or polish iteration, and host syncs per traverse
    (``torch.cuda.set_sync_debug_mode("warn")``)."""
    from pano360_tpu_torch import register
    from pano360_tpu_torch.measure import host_syncs
    from pano360_tpu_torch.pipeline import idx_to_keypoints
    graph = idx_to_keypoints(matches, kpts)
    runs, secs = {}, {True: [], False: []}
    for capture in (True, False) + (True, False, False, True) * 2:
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        regs = register.traverse(u8, graph, stats=stats, capture=capture)
        secs[capture].append(time.perf_counter() - t0)
        runs[capture] = (stats, regs)
    for capture, label in ((True, "graphs"), (False, "eager")):
        stats = runs[capture][0]
        med = float(np.median(secs[capture][1:]))
        iters = sum(stats["lm_iterations"]) + stats["polish_iterations"]
        _, sites = host_syncs(lambda: register.traverse(u8, graph,
                                                        capture=capture))
        log(f"  traverse, steps {label}: {med:.4f} s (median of "
            f"{[round(x, 4) for x in secs[capture][1:]]}; first "
            f"{secs[capture][0]:.4f} s); "
            f"{med / iters * 1e3:.3f} ms per LM or polish iteration "
            f"({iters}: {stats['lm_iterations']} + polish "
            f"{stats['polish_iterations']}); host syncs per traverse "
            f"{sum(sites.values())} {json.dumps(sites)}")
    (s_g, r_g), (s_e, r_e) = runs[True], runs[False]
    same = all(np.array_equal(a.rot, b.rot) and np.array_equal(a.intr, b.intr)
               for a, b in zip(r_g, r_e)) and len(r_g) == len(r_e)
    counts = (s_g["lm_iterations"] == s_e["lm_iterations"]
              and s_g["polish_iterations"] == s_e["polish_iterations"])
    log(f"  traverse, graphs vs eager on the same match cache: cameras "
        f"equal {same}, LM counts equal {counts}")
    check(same and counts, "the replayed traverse differs from the eager one")


def hold_bundle_adjuster(regs, kpts, matches):
    """``register.BundleAdjuster`` on the card against the same problem
    on the CPU: phase 5's cameras with rotations perturbed by ~3e-3 rad
    (numpy seed 0), every edge of the match cache, one ``optimize()``.
    Held on what the residuals see (f32 rounding moves the two along the
    global rotation): relative rotations of adjacent views and focals
    within 1e-4."""
    from pano360_tpu_torch import register as R
    from pano360_tpu_torch.pipeline import idx_to_keypoints
    graph = idx_to_keypoints(matches, kpts)
    rng = np.random.default_rng(0)
    start = [R.PanoImage(None, R._np_exp_so3(0.003 * rng.standard_normal(3))
                         @ r.rot, r.intr.copy()) for r in regs]
    cams, secs = {}, {}
    for dev in ("cuda", "cpu"):
        ba = R.BundleAdjuster(len(start), mode="none", device=dev)
        for i, cam in enumerate(start):
            ba.add(i, cam, graph)
        t0 = time.perf_counter()
        ba.optimize()
        secs[dev] = time.perf_counter() - t0
        cams[dev] = ba.cameras
    pairs = list(zip(cams["cuda"], cams["cpu"]))
    rel = max(rot_angle_deg(a1.rot @ a0.rot.T, b1.rot @ b0.rot.T)
              for (a0, b0), (a1, b1) in zip(pairs, pairs[1:]))
    foc = max(abs(a.intr[0, 0] / b.intr[0, 0] - 1) for a, b in pairs)
    log(f"  BundleAdjuster, {len(ba.matches)} edges, one optimize(): card "
        f"{secs['cuda']:.3f} s, CPU {secs['cpu']:.3f} s; card vs CPU: "
        f"relative rotations within {np.radians(rel):.2e} rad, focals "
        f"within {foc:.2e}")
    check(np.radians(rel) <= 1e-4 and foc <= 1e-4,
          f"BundleAdjuster on the card differs from the CPU: {rel}, {foc}")


def hold_add_weights(torch, u8):
    """``render.add_weights``'s per-image branch fed the uniform sizes
    against its uniform branch on the bench stack. They are not bit-equal
    on the card (the uniform hat divides by a host scalar, which CUDA
    turns into a multiply by its reciprocal), so both stay; the gate is
    f32 rounding."""
    from pano360_tpu_torch import render
    imgs = torch.as_tensor(np.stack(u8), device="cuda").float() / 255
    n, h, w = imgs.shape[:3]
    uniform = render.add_weights(imgs)
    per_image = render.add_weights(imgs, np.array([[h, w]] * n))
    d = (uniform - per_image).abs()
    err = float(d.max())
    log(f"  add_weights on the {n}x{h}x{w} stack, per-image branch vs "
        f"uniform: equal {bool(torch.equal(uniform, per_image))}, max|d| "
        f"{err:.3e} at {int((d > 0).sum())} values")
    check(err <= 1e-6, f"add_weights' branches differ by {err}")


def run_cli(torch, imgs, flags, cache, label, timer=None):
    """One ``cli.run_images`` with every kernel count set to 0 just
    before it: -> (mosaic, {kernel: launches}, seconds)."""
    from pano360_tpu_torch import cli
    from pano360_tpu_torch._kernels import LAUNCHES
    args = cli.build_parser().parse_args([cache, *flags, "--cache-dir",
                                          cache])
    timer = timer or cli.StageTimer()
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    t0 = time.time()
    mosaic = cli.run_images(imgs, args, "bench_s1.0", timer)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(LAUNCHES)
    stages = {k: round(v, 4) for k, v in timer.stages.items()}
    log(f"  {label}: {' '.join(flags)}: {wall:.3f} s; stages {stages}; "
        f"launches {launches}; mosaic {mosaic.shape}")
    check(mosaic.dtype == np.uint8 and mosaic.ndim == 3
          and mosaic.shape[2] == 3 and min(mosaic.shape[:2]) > 0
          and mosaic.any(), f"{label}: mosaic {mosaic.shape} {mosaic.dtype}")
    return mosaic, launches, wall


def crop_rect(render, native, invalid, lay):
    """The crop's valid canvas and its largest rectangle (top, left,
    bottom, right), as ``render.stitch`` computes them."""
    valid = render._crop_valid(invalid.cpu().numpy(), lay.bottoms, lay.ph,
                               lay.pw, lay.shape, lay.period)
    valid = valid[:lay.out_hw[0], :lay.out_hw[1]]
    return valid, np.array(native.largest_rectangle(valid))


def phase_options_b(torch, imgs_f):
    """B: -e -c --warp pallas on the bench views at known exposures."""
    from pano360_tpu_torch import cli, render
    from pano360_tpu_torch import native
    from pano360_tpu_torch.ops import warp_mip as M
    u8 = [(im * a * 255).astype(np.uint8) for im, a in zip(imgs_f, EXPOSURE)]
    flags = ["-s", "1", "--ba", "incr", "-b", "multiband", "-e", "-c",
             "--warp", "pallas"]
    work = tempfile.mkdtemp(prefix="chip_smoke_b_")
    for label in ("cold", "warm"):
        cache = os.path.join(work, label)
        os.makedirs(cache)
        mosaic, launches, _ = run_cli(torch, u8, flags, cache,
                                      f"B {label}")
        if label == "cold":
            cold_launches = launches
            check(launches["octave_stack"] > 0
                  and launches["backward_warp_mip"] > 0,
                  f"B did not launch the octave and mip kernels: {launches}")
    regs = cli.load_ba_cache(os.path.join(cache, "ba_bench_s1.0.pkl"))
    check(len(regs) == BENCH_VIEWS, f"B: {len(regs)} of {BENCH_VIEWS} placed")

    # the gains stitch computed, recomputed from the same registration
    from pano360_tpu_torch.measure import measure_mip, warp_inputs
    rgba, small, lay = warp_inputs(regs, "spherical")
    gains = render.estimate_gains(regs, rgba)
    ga = gains * EXPOSURE
    log_ratio = np.abs(np.log(ga[:-1] / ga[1:]))
    log(f"  gains {np.round(gains, 4).tolist()}; adjacent "
        f"|log(g_i a_i / g_j a_j)| max {log_ratio.max():.5f} mean "
        f"{log_ratio.mean():.5f} (bound {GAIN_LOG_BOUND})")
    check(log_ratio.max() <= GAIN_LOG_BOUND,
          f"B: gain ratios off by {log_ratio.max()}")

    row = measure_mip(render.apply_gains(rgba, gains), small, lay)
    log(f"  mip plan: ok {row['ok']}, window {row['window']}, "
        f"{row['n_levels']} levels, tiles per level "
        f"{row['tiles_per_level']}; plan_windows "
        f"{row['plan_windows_ms'] * 1e3:.1f} us on the host; build_mips "
        f"{row['build_mips_ms']:.4f} ms ({row['build_mips_device_ms']:.4f} "
        "ms on the device)")
    check(row["ok"] and row["n_levels"] >= 2,
          f"B: the mip plan has ok {row['ok']}, {row['n_levels']} levels")
    _, invalid = row.pop("_out")
    hold_warp("backward_warp_mip", row)

    valid, rect = crop_rect(render, native, invalid, lay)
    top, left, bottom, right = rect
    log(f"  crop rectangle {rect.tolist()}; native library loaded: "
        f"{native.loaded()}")
    check(native.loaded(), "B: the native crop library did not load (g++ "
          "build failed?)")
    check(mosaic.shape[:2] == (bottom - top + 1, right - left + 1),
          f"B: cropped mosaic {mosaic.shape} is not the rectangle {rect}")
    check(valid[top:bottom + 1, left:right + 1].all(),
          "B: the crop leaves the valid mask")
    row["launches"] = cold_launches["backward_warp_mip"]
    return row


def phase_options(torch, imgs_f, cache5):
    """Phase 7: B, then C and D from phase 5's caches."""
    from pano360_tpu_torch import cli, render
    from pano360_tpu_torch import geometry
    k3 = phase_options_b(torch, imgs_f)
    log("phase 7 C, D: render options from phase 5's caches")
    u8 = [(im * 255).astype(np.uint8) for im in imgs_f]
    base = ["-s", "1", "--ba", "incr", "-b", "multiband"]
    mosaic, launches, _ = run_cli(torch, u8,
                                  base + ["--max-resolution", "4000"],
                                  cache5, "C")
    check(launches["backward_warp"] > 0, f"C: launches {launches}")
    check(mosaic.shape[1] > 1400, f"C: mosaic {mosaic.shape} not > 1400")

    mosaic, launches, _ = run_cli(
        torch, u8, base + ["--projection", "cylindrical", "-c"], cache5, "D")
    check(launches["backward_warp"] > 0, f"D: launches {launches}")
    regs = cli.load_ba_cache(os.path.join(cache5, "ba_bench_s1.0.pkl"))
    _, lay = render.prepare(regs, "multiband", render.MAX_RESOLUTION,
                            torch.device("cuda"),
                            projection=geometry.CylProj)
    check(mosaic.shape[0] <= lay.out_hw[0] and mosaic.shape[1]
          <= lay.out_hw[1], f"D: crop {mosaic.shape} exceeds {lay.out_hw}")
    log("  D: kernel 2 vs plain in cylindrical mode at D's layout")
    k2c = hold_exact_warp(regs, "cylindrical")
    return k3, k2c


def cold_warm(torch, imgs, flags, prefix, label, need):
    """``flags`` through ``run_cli`` cold and warm without caches: -> (the
    warm mosaic, the cold launches, the warm seconds, the warm cache
    directory, the warm timer). ``need``: the kernels the path must
    launch."""
    from pano360_tpu_torch import cli
    work = tempfile.mkdtemp(prefix=prefix)
    for run in ("cold", "warm"):
        cache = os.path.join(work, run)
        os.makedirs(cache)
        timer = cli.StageTimer()
        mosaic, launches, wall = run_cli(torch, imgs, flags, cache,
                                         f"{label} {run}", timer)
        if run == "cold":
            cold = launches
            check(all(launches[k] > 0 for k in need),
                  f"{label} did not launch {need}: {launches}")
    return mosaic, cold, wall, cache, timer


def rot_angle_deg(a, b) -> float:
    c = np.clip((np.trace(a @ b.T) - 1) / 2, -1, 1)
    return float(np.degrees(np.arccos(c)))


def msop_graph_gates(label, cache, rots, focal, width):
    """The match graph of one MSOP run against the ground truth. Views
    overlap when the angle between them is under 0.7 of the horizontal
    field of view. Gates: every overlapping pair is an edge of at least
    MSOP_MIN_INLIERS inliers whose homography H (centre-relative pixels,
    K^-1 H K = R_j R_i^T) gives the true relative rotation within
    MSOP_EDGE_ROT_BOUND_DEG."""
    from pano360_tpu_torch import cli
    _, matches = cli.load_match_cache(os.path.join(cache,
                                                   "matches_bench_s1.0.npz"))
    matches = matches.item()
    n = len(rots)
    fov = np.degrees(2 * np.arctan(width / 2 / focal))
    k = np.diag([focal, focal, 1.0])
    true_inl, true_err, false_inl, missing = [], [], [], []
    for i in range(n):
        for j in range(i + 1, n):
            overlap = rot_angle_deg(rots[i], rots[j]) < 0.7 * fov
            edge = matches.get(i, {}).get(j)
            if edge is None:
                if overlap:
                    missing.append((i, j))
                continue
            if not overlap:
                false_inl.append(len(edge[0]))
                continue
            rel = np.linalg.inv(k) @ (edge[1] / edge[1][2, 2]) @ k
            u, _, vt = np.linalg.svd(rel)
            true_inl.append(len(edge[0]))
            true_err.append(rot_angle_deg(u @ vt, rots[j] @ rots[i].T))
    log(f"  {label}: match graph: {len(true_inl)} edges between overlapping "
        f"views, inliers {min(true_inl, default=0)}-"
        f"{max(true_inl, default=0)}, their homographies' rotation error "
        f"max {max(true_err, default=0):.4f} deg; {len(false_inl)} edges "
        f"between views that share no pixel (of "
        f"{n * (n - 1) // 2 - len(true_inl) - len(missing)} such pairs), "
        f"inliers {sorted(false_inl)}")
    check(not missing, f"A, {label}: overlapping views not joined: {missing}")
    check(min(true_inl) >= MSOP_MIN_INLIERS,
          f"A, {label}: an overlapping pair has {min(true_inl)} inliers")
    check(max(true_err) <= MSOP_EDGE_ROT_BOUND_DEG,
          f"A, {label}: an edge's rotation is off by {max(true_err)} deg")


def msop_run(torch, label, u8, rots, focal, seed):
    """One uncached ``--detector msop`` run through ``cli.run_images`` at
    a seed: -> (registered, seconds, the timer, the cache directory, the
    mosaic or None). An exception counts as a failed registration, and
    not as a failed phase, only when the match graph was written and the
    bundle adjustment left no cameras or cameras outside MSOP's bounds
    (non-finite cameras end in the SVD of the next add or in the
    render)."""
    from pano360_tpu_torch import cli
    from pano360_tpu_torch._kernels import LAUNCHES
    cache = tempfile.mkdtemp(prefix="chip_smoke_msop_")
    flags = BASE_FLAGS + ["--detector", "msop", "--seed", str(seed)]
    args = cli.build_parser().parse_args([cache, *flags, "--cache-dir",
                                          cache])
    timer = cli.StageTimer()
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    mosaic = error = None
    t0 = time.time()
    try:
        mosaic = cli.run_images(u8, args, "bench_s1.0", timer)
    except Exception as exc:        # judged below, never swallowed unseen
        error = exc
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(LAUNCHES)
    sift = {k: v for k, v in launches.items()
            if k == "octave_stack" or k.startswith("sift_")}
    check(not any(sift.values()), f"A, {label}: MSOP ran SIFT's kernels: "
          f"{sift}")
    check(launches["ransac_score"] > 0 and launches["knn2"] > 0,
          f"A, {label}: MSOP's match graph did not score RANSAC or search "
          f"the top-2 on the card: {launches}")
    check(os.path.exists(os.path.join(cache, "matches_bench_s1.0.npz")),
          f"A, {label}, seed {seed}: no match graph: {error!r}")
    ba = os.path.join(cache, "ba_bench_s1.0.pkl")
    regs = cli.load_ba_cache(ba) if os.path.exists(ba) else []
    f_err = r_mean = float("nan")
    if len(regs) == len(u8):
        f_err, r_err = registration_errors(regs, rots, focal)
        r_mean = float(r_err.mean())
    registered = bool(f_err <= MSOP_FOCAL_BOUND
                      and r_mean <= MSOP_ROT_MEAN_BOUND_DEG)
    check(error is None or not registered,
          f"A, {label}, seed {seed}: registered, yet raised {error!r}")
    ex = timer.extra
    stages = {k: round(v, 4) for k, v in timer.stages.items()}
    log(f"  {label}, seed {seed}: {wall:.3f} s; stages {stages}; registered "
        f"{registered}: {len(regs)} of {len(u8)} placed, focal max rel err "
        f"{f_err:.5f}, rel-rot err mean {r_mean:.4f} deg; initial focal "
        f"{ex.get('focal0', float('nan')):.1f} (true {focal:.1f}); "
        f"{ex.get('ba_edges_enabled')} of {ex.get('ba_edges')} edges under "
        f"the 150-px gate; LM iterations {ex.get('lm_iterations')} + polish "
        f"{ex.get('polish_iterations')}"
        + ("" if error is None else f"; ended in {error!r}"[:200]))
    if registered:
        check(launches["backward_warp"] > 0,
              f"A, {label}: no exact warp launched")
        check(mosaic.dtype == np.uint8 and mosaic.ndim == 3
              and max(mosaic.shape[:2]) <= 1400 and mosaic.any(),
              f"A, {label}: mosaic {mosaic.shape} {mosaic.dtype}")
        again = cli.run_images(u8, args, "bench_s1.0")
        check(np.array_equal(again, mosaic),
              f"A, {label}: cached re-run differs")
    return registered, wall, timer, cache, mosaic


def phase_msop(torch, bench):
    """8 A: ``--detector msop`` on ``MSOP_RUNS``."""
    from pano360_tpu_torch import cli, native, pipeline, synth
    from pano360_tpu_torch.features import msop
    from pano360_tpu_torch.measure import alternate
    bench_u8, bench_rots, bench_focal = bench
    dev = torch.device("cuda")
    pipeline.msop_extract(bench_u8[:2], dev)      # CUDA set-up, the build
    check(native.loaded(), "A: the native library did not load (SSC on "
          "100 000 candidates in Python is not a run)")
    worlds = {}
    for label, world, shrink, seeds in MSOP_RUNS:
        key = tuple(world.items())
        if world == BENCH_WORLD:
            worlds[key] = (bench_u8, bench_rots, bench_focal)
        elif key not in worlds:
            imgs, rots, focal = synth.make_views(**world)
            worlds[key] = ([(im * 255).astype(np.uint8) for im in imgs],
                           rots, focal)
        u8, rots, focal = worlds[key]
        u8 = cli.shrink_images(u8, shrink, dev)
        focal = focal / shrink
        n_ok = 0
        for seed in seeds:
            ok, _, timer, cache, _ = msop_run(torch, label, u8, rots, focal,
                                              seed)
            n_ok += ok
            msop_graph_gates(f"{label}, seed {seed}", cache, rots, focal,
                             u8[0].shape[1])
        ex = timer.extra
        log(f"  {label}: registered at {n_ok} of {len(seeds)} seeds; levels, "
            f"all views: candidates {ex['candidates']}, keypoints "
            f"{ex['keypoints']}; SSC on the host {ex['ssc_seconds']:.3f} s of "
            f"{timer.stages['Matched features']:.3f} s of matching")
        check(ex["keypoints"][0] > 1000 * len(u8),
              f"A, {label}: level 0 kept {ex['keypoints'][0]} keypoints")

    # the stage MSOP changes, alone on the 15 full-size bench views
    u8 = bench_u8
    for run in ("cold", "warm"):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.time()
        feats = pipeline.msop_extract(u8, dev, stats)
        torch.cuda.synchronize()
        wall = time.time() - t0
    log(f"  extraction of {len(u8)} views of {u8[0].shape[:2]}, warm: "
        f"{wall:.3f} s, SSC on the host {stats['ssc_seconds']:.3f} s of it; "
        f"candidates {stats['candidates']}, keypoints {stats['keypoints']}; "
        f"buffers {tuple(feats.desc.shape)}")
    check(int(feats.counts.min()) > 1000 and feats.desc.shape[-1] == 64,
          f"A: full-size extraction kept {feats.counts.tolist()}")
    log("  profile of the extraction and the match graph (105 pairs)")
    profile_device(torch,
                   lambda: pipeline.matching(u8, dev, detector="msop"))
    del feats
    # its candidate ordering at level 0 (a stable full sort, so that ties
    # keep their pixel order), beside torch.topk, which promises no order
    # among ties and is used nowhere in the package
    stack = torch.as_tensor(np.stack(u8), device="cuda")
    gray = msop.msop_gray(stack)
    from pano360_tpu_torch.ops.filters import harris_response
    hrs = harris_response(gray[..., None])[..., 0]
    del stack, gray
    cap = msop.MAX_FEAT[0] * 20
    score = hrs.reshape(len(u8), -1)
    t_sort, t_topk = alternate(lambda: msop.top_candidates(hrs, cap),
                               lambda: torch.topk(score, cap), REPS)
    log(f"  level 0 candidates, top {cap} of {score.shape[1]} per view, "
        f"{len(u8)} views: max filter + stable sort {t_sort:.3f} ms; "
        f"torch.topk alone {t_topk:.3f} ms")
    del hrs, score


def phase_mixed(torch, rots, focal):
    """8 B and C: mixed image sizes, and kernel 2 with per-image sizes."""
    from pano360_tpu_torch import cli, native, render
    from pano360_tpu_torch.measure import (MIXED_SHAPE, bench_mixed_views,
                                           measure_exact, warp_inputs)
    u8, _, _ = bench_mixed_views()
    sizes = sorted({im.shape[:2] for im in u8})
    check(len(sizes) == 2 and MIXED_SHAPE in sizes, f"B: sizes {sizes}")
    flags = BASE_FLAGS + ["-e", "-c"]
    mosaic, launches, _, cache, _ = cold_warm(
        torch, u8, flags, "chip_smoke_mixed_", "B",
        ["octave_stack", "backward_warp", "sift_base", "sift_small_octave",
         "sift_refine", "sift_orient", "sift_descr"])
    check(launches["backward_warp_mip"] == 0, f"B: launches {launches}")
    regs = cli.load_ba_cache(os.path.join(cache, "ba_bench_s1.0.pkl"))
    check(len(regs) == BENCH_VIEWS, f"B: {len(regs)} of {BENCH_VIEWS} placed")
    check([r.img.shape[:2] for r in regs] == [im.shape[:2] for im in u8],
          "B: the regions lost their image sizes")
    f_err, r_err = registration_errors(regs, rots, focal)
    log(f"  focal max rel err {f_err:.5f}; rel-rot err mean "
        f"{r_err.mean():.4f} max {r_err.max():.4f} deg")
    check(f_err <= 0.005, f"B: focal error {f_err}")
    check(r_err.mean() <= 0.1, f"B: mean relative rotation error "
          f"{r_err.mean()}")

    hold_features(torch, u8, "mixed sizes")
    log("  C: kernel 2 with per-image true sizes vs plain at B's layout")
    rgba, small, lay = warp_inputs(regs)
    check(lay.shapes is not None and len(lay.shapes) == BENCH_VIEWS,
          "C: the layout carries no per-image sizes")
    log(f"  layout: stack {tuple(rgba.shape[1:3])}, true sizes {sizes}, "
        f"canvas {lay.shape}, period {lay.period}")
    gains = render.estimate_gains(regs, rgba, lay.shapes)
    row = measure_exact(render.apply_gains(rgba, gains), small, lay.ph,
                        lay.pw, lay.period, False, shapes=lay.shapes)
    _, invalid = row.pop("_out")
    hold_warp("backward_warp (per-image sizes)", row)

    valid, rect = crop_rect(render, native, invalid, lay)
    top, left, bottom, right = rect
    log(f"  crop rectangle {rect.tolist()}")
    check(mosaic.shape[:2] == (bottom - top + 1, right - left + 1),
          f"B: cropped mosaic {mosaic.shape} is not the rectangle {rect}")
    check(valid[top:bottom + 1, left:right + 1].all(),
          "B: the crop leaves the valid mask")
    return row


def phase_extras(torch):
    """8 D: the two-view blend demo at full size."""
    from pano360_tpu_torch import blend_extra
    shape = (864, 1152)
    for run in ("cold", "warm"):
        stats = {}
        res = blend_extra.demo(shape=shape, device="cuda", stats=stats)
    delta = shape[1] * 13 // 24
    secs = {k[:-8]: round(v, 4) for k, v in stats.items()
            if k.endswith("_seconds")}
    log(f"  warm demo on two {shape[0]}x{shape[1]} views, overlap strip "
        f"{shape[0]}x{delta}: seconds {secs}; Poisson residual "
        f"{stats['residual0'].round(2).tolist()} -> "
        f"{stats['residual'].round(5).tolist()} (400 iterations)")
    for key, want in (("mask", (shape[0], delta, 1)),
                      ("laplacian", (shape[0], delta, 3)),
                      ("poisson", (shape[0], delta, 3)),
                      ("blended", (shape[0], 2 * shape[1] - delta, 3))):
        check(res[key].dtype == np.uint8 and res[key].shape == want,
              f"D: {key} is {res[key].dtype} {res[key].shape}, not uint8 "
              f"{want}")
    check(all(w.shape == shape + (4,) and w.dtype == np.uint8
              for w in res["warped"]), "D: the warped views' shape")
    check((res["mask"] == 255).any() and (res["mask"] == 0).any(),
          "D: the seam mask takes one side only")
    check(bool((stats["residual"] < 1e-2 * stats["residual0"]).all()),
          f"D: the Poisson residual did not fall: {stats['residual0']} -> "
          f"{stats['residual']}")
    check(res["poisson"].any() and res["laplacian"].any(), "D: empty blend")


def cams_errors(cams, rots, focal):
    from pano360_tpu_torch.register import PanoImage
    return registration_errors([PanoImage(None, r, k) for r, k in cams],
                               rots, focal)


def lm_inputs(e: int, m: int = 1024, c: int = BENCH_VIEWS, seed: int = 7):
    """A random bundle-adjustment problem of e edges between c cameras
    of m match points each (30 % masked): the keyword arguments of
    ``distributed_lm_stats``."""
    rng = np.random.default_rng(seed)
    params = (rng.standard_normal((c, 6)) * 0.1
              + np.array([1000, 0, 0, 0, 0, 0])).astype(np.float32)
    cam1 = rng.integers(0, c, e)
    cam2 = (rng.integers(1, c, e) + cam1) % c
    pts = np.ones((e, m, 6), np.float32)
    pts[..., :2] = rng.uniform(-400, 400, (e, m, 2))
    pts[..., 3:5] = rng.uniform(-400, 400, (e, m, 2))
    mask = (rng.random((e, m)) > 0.3).astype(np.float32)
    return dict(params=params, cam1=cam1, cam2=cam2, pts=pts, mask=mask)


def lm_one_process(torch, kw):
    """``distributed_lm_stats``' quadruple on one process, and the
    ``Problem`` it came from."""
    from pano360_tpu_torch import register
    t = {k: torch.as_tensor(v, device="cuda") for k, v in kw.items()}
    prob = register.Problem(t["cam1"], t["cam2"], t["pts"], t["mask"],
                            t["params"].shape[0])
    sq, cnt = prob.edge_sums(t["params"], prob.mask)
    return (torch.sum(sq), 2.0 * torch.sum(cnt),
            *prob.normal_equations(t["params"], prob.mask)), prob, t


def hold_edge_shards(torch, kw):
    """The per-edge terms of every shard of ``kw``'s edges over 2, 3 and
    4 ranks against the one-process rows: -> the shards that differ."""
    from types import SimpleNamespace
    from pano360_tpu_torch import register
    _, one, t = lm_one_process(torch, kw)
    want = torch.cat([one._edge_terms(t["params"], one.mask),
                      torch.stack(one.edge_sums(t["params"], one.mask), 1)],
                     1)
    bad = []
    for world in (2, 3, 4):
        for rank in range(world):
            prob = register.Problem(t["cam1"], t["cam2"], t["pts"], t["mask"],
                                    t["params"].shape[0],
                                    SimpleNamespace(rank=rank, size=world))
            prob.mesh = None                   # the shard's rows alone
            got = torch.cat([prob._edge_terms(t["params"], prob.mask),
                             torch.stack(prob.edge_sums(t["params"],
                                                        prob.mask), 1)], 1)
            n = min(got.shape[0], one.n_edges - prob.lo)
            if not torch.equal(got[:n], want[prob.lo:prob.lo + n]):
                bad.append((world, rank))
    return bad


def mesh_run(torch, label, u8, ref, rots, focal, opts=(), extra=()):
    """``dryrun.pipeline`` over 2 ranks on the one GPU, held to ``ref``
    (a one-process run of the same images and options), with the jobs
    of ``extra`` in the same launch: -> (the pipeline's result, the
    extra jobs' results)."""
    from pano360_tpu_torch.parallel import dryrun, mesh
    todo = [(dryrun.pipeline, (), dict(
        imgs=u8, device="cuda", **dict(zip(("blender", "equalize", "crop"),
                                           opts)))), *extra]
    t0 = time.time()
    res, *more = mesh.launch(dryrun.jobs, 2, "cuda", todo)
    wall = time.time() - t0
    cmp = dryrun.compare(res, ref)
    log(f"  {label}: 2 ranks sharing one GPU over gloo (a correctness "
        f"configuration, not a speedup): {wall:.3f} s with the ranks' "
        f"start; features equal {cmp['features_equal']}, match graph "
        f"equal {cmp['match_graph_equal']}, placed {cmp['placed']}, "
        f"rotations within {cmp['rot_max_diff']:.2e}, focal within "
        f"{cmp['focal_max_rel_diff']:.2e}, LM iterations equal "
        f"{cmp['lm_iterations_equal']} ({res['lm_iterations']} + polish "
        f"{res['polish_iterations']}), mosaic {cmp['mosaic_shape']} at "
        f"{cmp['mosaic_psnr_db']:.1f} dB")
    for r in res["ranks"]:
        secs = {k: round(v, 4) for k, v in r["seconds"].items()}
        log(f"    rank {r['rank']}: seconds {secs}; in collectives "
            f"{r['gather_seconds']:.4f} s ({r['gathers']} of them); "
            f"launches {r['launches']}; peak device memory "
            f"{r['peak_gib']:.2f} GiB")
    check(cmp["ok"], f"9 A, {label}: the mesh run differs: {cmp}")
    check(all(v > 0 for r in res["ranks"] for k, v in r["launches"].items()
              if k not in OFF_MAIN_PATH),
          f"9 A, {label}: a rank did not launch every kernel: "
          f"{[r['launches'] for r in res['ranks']]}")
    f_err, r_err = cams_errors(res["cams"], rots, focal)
    log(f"  focal max rel err {f_err:.5f}; rel-rot err mean "
        f"{r_err.mean():.4f} max {r_err.max():.4f} deg")
    check(len(res["cams"]) == BENCH_VIEWS and f_err <= 0.005
          and r_err.mean() <= 0.1, f"9 A, {label}: registration {f_err}, "
          f"{r_err.mean()}")
    return res, more


LM_EDGES = 137          # neither 2, 3 nor 4 divides it


def phase_mesh(torch, u8, rots, focal, ref5):
    """9 A: the sharded pipeline on the card, 2 ranks on cuda:0."""
    from pano360_tpu_torch.measure import bench_mixed_views
    from pano360_tpu_torch.parallel import dryrun, mesh
    kw = lm_inputs(LM_EDGES)
    _, (got,) = mesh_run(torch, "bench views", u8, ref5, rots, focal,
                         extra=[(mesh.distributed_lm_stats, (), kw)])
    want = lm_one_process(torch, kw)[0]
    same = all(torch.equal(a.cuda(), b) for a, b in zip(got, want))
    bad = hold_edge_shards(torch, kw)
    log(f"  distributed_lm_stats of {LM_EDGES} edges over 2 ranks: one "
        f"process's bit for bit {same}; per-edge terms of the shards over "
        f"2, 3 and 4 ranks equal to the one-process rows: "
        f"{'all' if not bad else f'not {bad}'}")
    check(same, "9 A: distributed_lm_stats differs from one process")
    check(not bad, f"9 A: per-edge terms of shards {bad} differ")
    mixed, _, _ = bench_mixed_views()
    opts = ("multiband", True, True)
    ref = dryrun.pipeline(None, mixed, "cuda", *opts)
    mesh_run(torch, "mixed sizes, -e -c", mixed, ref, rots, focal, opts)
    cache = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    mosaic, launches, _ = run_cli(torch, u8, BASE_FLAGS + ["--mesh", "2"],
                                  cache, "--mesh 2 on one GPU")
    check(all(v > 0 for k, v in launches.items() if k not in OFF_MAIN_PATH),
          f"9 A: --mesh 2 on one GPU did not run in this process: "
          f"{launches}")
    check(mosaic.shape == ref5["mosaic"].shape,
          f"9 A: --mesh 2 mosaic {mosaic.shape}")


def phase_dense(torch, u8, rots, focal):
    """9 B: the dense descriptor and upscale=False on the card; the
    orientation kernel's block design (the dense mode's 80x80 patches)
    against its plain version on the first upload batch's keypoints, as
    in 3 B. -> that call's dict for the kernels line, with the launches
    of the CLI run under ``PANO_SIFT_DESCR=dense``."""
    from pano360_tpu_torch import cli, pipeline
    from pano360_tpu_torch.features import sift as S
    from pano360_tpu_torch.measure import recording
    from pano360_tpu_torch.ops import sift_tail as T
    dev = torch.device("cuda")
    with recording(T, ("orientation",)) as calls:
        pipeline.upload_extract(u8[:4], dev,
                                S.SiftConfig(descr_mode="dense"),
                                capture=False)
    (args, kw), = calls["orientation"]
    check(args[0].shape[1:] == (80, 80),
          f"9 B: dense orientation patches {tuple(args[0].shape)}")
    block = hold_tail_call(torch, "orientation", args, kw,
                           BLOCK_ORIENT_KERNEL, "9 B")
    del calls, args
    feats, secs, peak = {}, {}, {}
    for mode in ("grid", "dense", "grid", "dense"):   # cold, then warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        _, feats[mode] = pipeline.upload_extract(
            u8, dev, S.SiftConfig(descr_mode=mode))
        torch.cuda.synchronize()
        secs[mode] = time.time() - t0
        peak[mode] = torch.cuda.max_memory_allocated() / 2 ** 30
    grid, dense = feats["grid"], feats["dense"]
    norms = dense.desc[dense.valid].norm(dim=-1)
    same = bool(torch.equal(grid.valid, dense.valid)
                and torch.equal(grid.xy, dense.xy))
    # orientations on the circle: the two histograms sum different
    # patches, so a peak near 0 may land on either side of 2 pi
    dang = torch.remainder(grid.angle - dense.angle + np.pi,
                           2 * np.pi) - np.pi
    log(f"  extraction of {len(u8)} views, warm: grid {secs['grid']:.3f} s "
        f"(peak {peak['grid']:.2f} GiB), dense {secs['dense']:.3f} s (peak "
        f"{peak['dense']:.2f} GiB); keypoints {int(dense.valid.sum())}, the "
        f"grid's {same}; angles within "
        f"{float(dang[dense.valid].abs().max()):.2e} rad; "
        f"|norm - 1| max {float((norms - 1).abs().max()):.2e}")
    check(same, "9 B: the dense run's keypoints differ from the grid's")
    check(float((norms - 1).abs().max()) <= 1e-4, "9 B: descriptor norms")
    del feats, grid, dense
    cache = tempfile.mkdtemp(prefix="chip_smoke_dense_")
    os.environ["PANO_SIFT_DESCR"] = "dense"
    try:
        timer = cli.StageTimer()
        _, launches, _ = run_cli(torch, u8, BASE_FLAGS, cache,
                                 "PANO_SIFT_DESCR=dense", timer)
    finally:
        del os.environ["PANO_SIFT_DESCR"]
    check(launches["sift_orient_block"] >= 1 and launches["sift_descr"] == 0,
          f"9 B: under dense the orientation kernel's block design runs and "
          f"the grid descriptor does not: {launches}")
    block["launches"] = launches["sift_orient_block"]
    regs = cli.load_ba_cache(os.path.join(cache, "ba_bench_s1.0.pkl"))
    f_err, r_err = registration_errors(regs, rots, focal)
    log(f"  {len(regs)} of {BENCH_VIEWS} placed; focal max rel err "
        f"{f_err:.5f}; rel-rot err mean {r_err.mean():.4f} max "
        f"{r_err.max():.4f} deg; LM iterations "
        f"{timer.extra['lm_iterations']}")
    check(len(regs) == BENCH_VIEWS and f_err <= 0.005
          and r_err.mean() <= 0.1, f"9 B: dense registration {f_err}, "
          f"{r_err.mean()}")
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.time()
        _, f = pipeline.upload_extract(u8, dev, S.SiftConfig(upscale=False))
        torch.cuda.synchronize()
        wall = time.time() - t0
    log(f"  upscale=False extraction, warm: {wall:.3f} s, keypoints "
        f"{int(f.valid.sum())} ({S.n_octaves_for(u8[0].shape[:2], False)} "
        f"octaves)")
    check(int(f.valid.sum()) > 100 * len(u8), "9 B: upscale=False keypoints")
    return block


def phase_profile(torch, u8, warm_s: float):
    """One more uncached run of ``cli.run_images`` (the main path) under
    torch.profiler: each profiled kernel's launches in the profile equal
    to its count (SIFT's and RANSAC's inside the replays, the blend's
    blur eager)."""
    from pano360_tpu_torch import cli
    from pano360_tpu_torch._kernels import LAUNCHES
    cache = tempfile.mkdtemp(prefix="chip_smoke_prof_")
    args = cli.build_parser().parse_args(
        [cache, *BASE_FLAGS, "--cache-dir", cache])
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    by_name = profile_device(
        torch, lambda: cli.run_images(u8, args, "bench_s1.0"), warm_s)
    launches = dict(LAUNCHES)
    if by_name is None:
        log(f"  launches counted {launches}; in the profile: not measured")
        return
    for kernel, key in PROFILED.items():
        seen = [v for k, v in by_name.items() if key in k]
        n_seen = sum(c for _, c in seen)
        per = sum(t for t, _ in seen) / 1e3 / max(n_seen, 1)
        log(f"  {kernel}: {launches[kernel]} launches counted, {n_seen} "
            f"in the profile, {per:.4f} ms per launch on the device")
        check(n_seen == launches[kernel], f"{kernel}'s count "
              f"{launches[kernel]} is not the profile's {n_seen}")
    check(all(launches[k] == v for k, v in TAIL_LAUNCHES.items()),
          f"SIFT's tail in the profiled run: {launches}, not "
          f"{TAIL_LAUNCHES}")
    check(all(launches[k] == v for k, v in FRONT_LAUNCHES.items()),
          f"SIFT's front end in the profiled run: {launches}, not "
          f"{FRONT_LAUNCHES}")
    check(launches["band_blur"] == BAND_LAUNCHES, f"the blend's blur in the "
          f"profiled run: {launches['band_blur']}, not {BAND_LAUNCHES}")


def profile_device(torch, fn, warm_s=None):
    """``fn()`` under torch.profiler: the device's busy time and idle
    share (also of ``warm_s``, the same work's unprofiled seconds) and
    the device operations that take the most time. -> {name: (device
    us, count)}, or None when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import busy_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        log(f"  profiled run {wall:.3f} s; device time not measured (the "
            "profiler saw no device activity)")
        return None
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in dev])
    log(f"  profiled run {wall:.3f} s; device busy {busy / 1e3:.1f} ms in "
        f"{len(dev)} device operations; idle share "
        f"{1 - busy / 1e6 / wall:.3f} of the profiled run"
        + ("" if warm_s is None else
           f", {1 - busy / 1e6 / warm_s:.3f} of the warm run's "
           f"{warm_s:.3f} s"))
    by_name = {}
    for e in dev:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"    {t / 1e3:8.2f} ms {c:6d}x  {name[:90]}")
    for label, key in (*PROFILED.items(),
                       ("exact warp kernel", "backward_warp_kernel"),
                       ("mip warp kernel", "backward_warp_mip_kernel")):
        for name, (t, c) in by_name.items():
            if key in name:
                log(f"  {label}: {t / 1e3:.4f} ms in {c} launches")
    return by_name


def main():
    if len(sys.argv) > 1:
        fail(f"takes no arguments, got {sys.argv[1:]}")
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    log("phase 1: device")
    sys.path.insert(0, ROOT)
    try:
        from pano360_tpu_torch import _kernels
        from pano360_tpu_torch.measure import bench_views
    except ImportError as exc:
        fail(f"the port package is missing next to this script: {exc}")
    smi = smi_line()
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    log(f"  nvidia-smi: {smi}")

    log("phase 2: build")
    t0 = time.time()
    libs = _kernels.build()
    _kernels.lib()
    log(f"  built {', '.join(os.path.relpath(p, ROOT) for p in libs.values())}"
        f" in {time.time() - t0:.1f} s (one nvcc per source, in parallel)")
    report = [ln.strip() for ln in _kernels.build_log(
        "gauss_octave").splitlines() if ": Used" in ln or "spill" in ln]
    check(bool(report), "no ptxas report for gauss_octave.cu")
    log("  ptxas -v, gauss_octave.cu:" + "\n    ".join([""] + report))

    imgs_f, u8, rots, focal = bench_views()
    log("phase 3: octave_stack kernel vs plain")
    k1 = phase_octave(torch, u8)
    log("phase 3 B: SIFT's tail, three kernels vs plain")
    tail = phase_sift_tail(torch, u8)
    log("phase 3 C: SIFT's front end, two kernels vs plain")
    front = phase_sift_front(torch, u8)
    log("phase 3 D: RANSAC's scoring kernel vs plain")
    score, chunks, top2_args = phase_ransac(torch, u8)
    log("phase 3 E: the multiband blend's blur vs plain")
    band = phase_band_blur(torch)
    log("phase 3 F: the match's top-2 search vs plain and float64")
    top2 = phase_knn2(torch, top2_args)
    del top2_args
    log("phase 4: backward_warp kernel vs plain")
    k2 = phase_warp(u8, rots, focal)
    log("phase 5: CLI main path on the bench dataset")
    launches, warm_s, cache5, ref5 = phase_slice(torch, u8, rots, focal,
                                                 chunks)
    log("phase 6: profile of one more main-path run")
    phase_profile(torch, u8, warm_s)
    log("phase 7 B: render options")
    k3, k2c = phase_options(torch, imgs_f, cache5)
    log("phase 8 A: MSOP")
    phase_msop(torch, (u8, rots, focal))
    log("phase 8 B, C: mixed image sizes")
    k2m = phase_mixed(torch, rots, focal)
    log("phase 8 D: the extras")
    phase_extras(torch)
    log("phase 9 A: the mesh, 2 ranks on one GPU")
    phase_mesh(torch, u8, rots, focal, ref5)
    log("phase 9 B: the dense descriptor")
    block = phase_dense(torch, u8, rots, focal)
    log("phase 10: the kernels line")

    kernels = [
        dict(name="octave_stack", route="cuda",
             source="pano360_tpu_torch/csrc/gauss_octave.cu",
             replaces="pano360_tpu/ops/pallas_gauss.py:285",
             launches=launches["octave_stack"],
             max_abs_err=k1["max_abs_err"], ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=k1["library_ms"]),
        dict(name="backward_warp", route="cuda",
             source="pano360_tpu_torch/csrc/backward_warp.cu",
             replaces="pano360_tpu/ops/pallas_warp.py:398",
             launches=launches["backward_warp"],
             max_abs_err=max(k2["max_abs_err"], k2c["max_abs_err"],
                             k2m["max_abs_err"]),
             **warp_times(k2)),
        dict(name="backward_warp_mip", route="cuda",
             source="pano360_tpu_torch/csrc/backward_warp_mip.cu",
             replaces="pano360_tpu/ops/pallas_warp.py:398 (n_levels > 1)",
             launches=k3["launches"], max_abs_err=k3["max_abs_err"],
             **warp_times(k3)),
    ] + [dict(name=kernel, route="cuda",
              source=f"pano360_tpu_torch/csrc/{src}", replaces=replaces,
              launches=launches[kernel],
              **{k: rows[fn][k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "device_ms")})
         for rows, line in ((front, SIFT_FRONT_LINE), (tail, SIFT_TAIL_LINE))
         for fn, kernel, src, replaces in line] + [
        dict(name=RANSAC_LINE[1], route="cuda",
             source=f"pano360_tpu_torch/csrc/{RANSAC_LINE[2]}",
             replaces=RANSAC_LINE[3], launches=launches[RANSAC_LINE[1]],
             **score),
        dict(name=KNN2_LINE[0], route="cuda",
             source=f"pano360_tpu_torch/csrc/{KNN2_LINE[1]}",
             replaces=KNN2_LINE[2], launches=launches[KNN2_LINE[0]],
             **top2),
        dict(name=BAND_LINE[0], route="cuda",
             source=f"pano360_tpu_torch/csrc/{BAND_LINE[1]}",
             replaces=BAND_LINE[2], launches=launches[BAND_LINE[0]],
             **{k: band[k] for k in ("max_abs_err", "ms", "device_ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}),
        dict(name="sift_orient_block", route="cuda",
             source="pano360_tpu_torch/csrc/sift_orient.cu",
             replaces="pano360_tpu/features/sift.py:594 and :635 (XLA "
             "fusion; descr_mode='dense')",
             **{k: block[k] for k in ("launches", "max_abs_err", "ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "device_ms")})]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
