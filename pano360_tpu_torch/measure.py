"""Measurement on the card: CUDA-event timing in turns, the bench
octave bases, the warps at the bench layouts, and (as a script) the
octave-stack kernel or the two warps against other builds of their
sources.

Usage, on a CUDA machine::

    python -m pano360_tpu_torch.measure [--against A.cu [B.cu ...]]
    python -m pano360_tpu_torch.measure --warps [--before DIR]
    python -m pano360_tpu_torch.measure --traverse [DIR ...]
    python -m pano360_tpu_torch.measure --features [DIR ...]
    python -m pano360_tpu_torch.measure --tail [DIR] [--descr A.cu ...]
        [--orient A.cu ...]

The first form builds ``csrc/gauss_octave.cu`` (and each ``--against``
source: an octave-stack source with the same ``p360_octave_stack`` C
interface, e.g. an earlier version or a variant), checks each bit for bit
against the plain version at the bench octaves (4 views of 864x1152,
seed 42, 2x upscaled SIFT base, octaves 0-5), times this one per wrapper
call (CUDA events) and per launch on the device (``torch.profiler``), and
times each other build against this one in turns (this, other, other,
this) with CUDA events over ``REPS`` calls. Prints ptxas's report of
each build, one line per octave and a JSON summary; exits non-zero if
this source's kernel differs from the plain version.

``--warps`` does the same for the two backward warps on the 15-view bench
world with its true cameras: at the 1400-px cap the exact warp spherical
(``chip_smoke.py`` phase 4's layout) and cylindrical (phase 7 D's
projection), and the mip-sampled warp at the ``--warp pallas`` plan
(phase 7 B's: every tile at level 2); the exact warp also at the 4000-px
cap (phase 7 C's layout, ~1x minification, where the taps' texels fill
their sectors). For each: the launch with a
prepared plan (CUDA events over back-to-back launches), the prepare step
alone (host), the device time per launch (``torch.profiler``; with
the L2 flushed before each launch, and back to back), the bound and the
distinct 32-byte sectors of the taps, ``grid_sample`` on the warp's own
sample grid, and bit-identity to the plain version; for the mip plan
also ``plan_windows`` (host) and ``build_mips`` (per call and on the
device). The exact warp is also taken at the mixed-size layout
(``chip_smoke.py`` phase 8 B's: the odd views at 768x1024, zero-padded
into the 864x1152 stack with their true sizes in the plan). ``--before
DIR``: another checkout of the package, whose two warp sources are
timed in turns with this tree's and its ``plan_windows`` beside this
one. The checkout must have the warp plans (``prepare_warp``): its entry
points have this tree's interface and take the parameter rows at that
checkout's own ``PARAM_FLOATS`` (an older one knows no per-image sizes,
so the mixed-size layout is not run on it).

``--traverse`` times ``register.traverse`` (``--ba incr`` with the
polish, one process) on the bench world and on the 25- and 50-view
worlds of ``benchmarks/measure_scale.py`` (1296x1728, overlap 0.45, seed
7), from one match graph per world made by this tree. Besides this
tree's (LM and polish steps replayed from CUDA graphs) it runs this
tree's steps eagerly (``capture=False``), and each ``DIR`` is another
checkout of the package whose ``register.py`` is timed in turns with
this tree's on the same graph (after one untimed run of each, in
``TRAVERSE_ROUNDS`` rounds of turns: versions in order, then reversed).
Per version: the seconds of each run (host clock; the cameras come back
to the host), their median and the median per LM or polish iteration,
the device operations and busy milliseconds of one more run
(``torch.profiler``), the host syncs of one more
(``torch.cuda.set_sync_debug_mode("warn")``, by source line), the LM
iterations, and the cameras' largest difference from this tree's (and
whether they are identical).

``--features`` times the two halves of "Matched features" apart, on the
bench world and on its mixed-size variant (``bench_mixed_views``, phase
8 B's): the extraction (``pipeline.upload_extract``) and the match graph
(``pipeline.matching`` on those features: the host read of the
keypoints, the compaction, ``match.match_all_pairs`` and the host's
edges). Versions: this tree's replayed from CUDA graphs, the same steps
eager (``capture=False``), and each ``DIR``, another checkout of the
package imported whole. After one untimed run of each (the captures),
``FEATURE_ROUNDS`` rounds of turns (versions in order, then reversed);
per version and half: the seconds of each run (host clock ending in a
device sync) and their median, the device operations and busy
milliseconds of one more run (``torch.profiler``), the host syncs of one
more (by source line), and whether its features and match graph are
this tree's replayed ones bit for bit; each version but the replayed one
also against it as features that may differ (``features_against``);
then each version's registration on its own match graph (its tree's
``register.traverse``): its LM iterations and whether its cameras are
the replayed version's bit for bit. On
the bench world each tree's eager steps are also split by stage
(``stage_split``), in turns (this tree, the others, then reversed): the
device time and operations of the gray image and upload, the base, the
scale space, the candidates, the Newton field (where a tree makes it),
the refinement, the compaction and patches, the orientation, the
descriptor, and the final top-k with the keypoint stage's copies.

``--tail`` takes SIFT's refinement, orientation and grid descriptor on
the bench's first upload batch (4 views, 9 octaves, one orientation and
one descriptor launch over the batch's keypoints), recorded from one
eager extraction, and holds each of this tree's kernels bit for bit to
its plain version. ``DIR``: another checkout of the package, whose
refinement (with its dense Newton field, where it has one), orientation
and descriptor are held to the same plain versions
and timed in turns with this tree's (CUDA events); each ``--descr``
source (a ``sift_descr.cu`` with this tree's C interface) and each
``--orient`` source (a ``sift_orient.cu``) likewise, through this tree's
wrapper. Per kernel also the device time with the L2 flushed, the bound,
the descriptor's sampling phase alone (this tree's and the other's
source cut after it), the orientation's work per keypoint (window rows,
columns, samples, (column, bin) row trees) and ptxas's registers, shared
memory and theoretical occupancy.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import ctypes
import functools
import hashlib
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

BENCH_VIEWS, BENCH_SHAPE, BENCH_OVERLAP, BENCH_SEED = 15, (864, 1152), 0.45, 42
REPS = 10
# back-to-back launches per timing of a warp (and of grid_sample beside
# it): enough that the first launch's host latency weighs little
WARP_REPS = 50


def timed(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` runs, with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flush_l2():
    """Read a buffer five times the size of the H100's 50 MB L2, so that
    the next kernel finds none of its inputs there and leaves no dirty
    line to write back: its device time is then held to the bytes it must
    move from device memory, which ``bound_ms`` counts."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.ones(64 << 20, device="cuda")
    _FLUSH.sum()


_FLUSH = None


def device_ms(fn, name: str, reps: int, tries: int = 3,
              flush: bool = False) -> float:
    """Mean device time in ms of the kernel whose name holds ``name``
    per call of ``fn`` (``torch.profiler``): the launch without the host
    work around it; with ``flush``, each call after ``flush_l2``. Each
    session runs ``reps`` calls more than it keeps: the profiler can miss
    a session's first device entries, so the last ``reps`` are averaged; a
    session that kept fewer is run again (up to ``tries`` times) and then
    raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2 * reps):
                if flush:
                    flush_l2()
                fn()
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.time_range.elapsed_us())
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA and name in e.name)
        if len(ev) >= reps:
            return sum(us for _, us in ev[-reps:]) / reps / 1e3
    raise RuntimeError(f"device_ms: {len(ev)} device entries named {name!r} "
                       f"for {2 * reps} calls")


def device_turns(first, second, name: str, reps: int, flush: bool = False):
    """``device_ms`` of two functions in turns (first, second, second,
    first) -> (ms first, ms second)."""
    t1 = device_ms(first, name, reps, flush=flush)
    t2 = device_ms(second, name, reps, flush=flush)
    t2 = (t2 + device_ms(second, name, reps, flush=flush)) / 2
    return (t1 + device_ms(first, name, reps, flush=flush)) / 2, t2


def alternate(first, second, reps: int):
    """Times of ``first`` and ``second`` taken in turns (first, second,
    second, first) after one warm-up of each -> (ms first, ms second)."""
    first()
    second()
    torch.cuda.synchronize()
    t1 = timed(first, reps)
    t2 = timed(second, reps)
    t2 = (t2 + timed(second, reps)) / 2
    t1 = (t1 + timed(first, reps)) / 2
    return t1, t2


def bench_views():
    """The bench world: -> (float BGR views, their uint8 cast, rotations,
    focal)."""
    from pano360_tpu_torch import synth
    imgs, rots, focal = synth.make_views(
        n_views=BENCH_VIEWS, shape=BENCH_SHAPE, overlap=BENCH_OVERLAP,
        seed=BENCH_SEED)
    return imgs, [(im * 255).astype(np.uint8) for im in imgs], rots, focal


MIXED_SHAPE = (768, 1024)      # the odd views of the mixed-size bench world


def bench_mixed_views():
    """The bench world with its odd-numbered views rendered at
    ``MIXED_SHAPE`` (same rotations, focal and texture): -> (uint8 views,
    rotations, focal)."""
    from pano360_tpu_torch import synth
    _, u8, rots, focal = bench_views()
    tex = synth.world_texture(seed=BENCH_SEED)
    u8 = list(u8)
    for i in range(1, len(u8), 2):
        view = synth.render_view(tex, rots[i], focal, MIXED_SHAPE)
        u8[i] = (view * 255).astype(np.uint8)
    return u8, rots, focal


def octave_bases(u8, cfg=None, device="cuda"):
    """The bases of the first four views' octaves, as SIFT builds them:
    -> [(octave, base (4, H, W) f32)] for every octave where the kernel
    runs (the single reflect pad is legal); each next base is the plain
    version's layer S, halved."""
    from pano360_tpu_torch.features import sift as S
    from pano360_tpu_torch.ops import gauss_octave as G
    from pano360_tpu_torch.ops.color import bgr2gray
    cfg = cfg or S.SiftConfig()
    taps = G.chain_taps(cfg.sigma, cfg.n_layers)
    stack = torch.as_tensor(np.stack(u8[:4]), device=device)
    octv = S._base_image(bgr2gray(stack.float() / 255.0), cfg).contiguous()
    out = []
    for o in range(S.n_octaves_for(u8[0].shape[:2])):
        h, w = octv.shape[1:]
        if G.reflect_legal(h, w, taps):
            out.append((o, octv))
            gauss = G.octave_stack_ref(octv, taps)[0]
        else:
            gauss = S._gaussian_stack(octv, cfg)
        octv = gauss[:, cfg.n_layers, ::2, ::2].contiguous()
    return out


def build_others(srcs):
    """Compile other CUDA sources with the package's flags into
    ``build/kernels/``, one ``nvcc`` each, all at once -> {src: (shared
    library handle, nvcc output)}."""
    from pano360_tpu_torch import _kernels
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in srcs:
        digest = hashlib.sha256(src.read_bytes())
        for hdr in sorted(src.parent.glob("*.cuh")):
            digest.update(hdr.read_bytes())
        digest.update(" ".join(_kernels.NVCC_FLAGS).encode())
        out = _kernels.BUILD_DIR / \
            f"libp360_other_{digest.hexdigest()[:16]}.so"
        procs[src] = (out, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(out),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    built = {}
    for src, (out, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{stderr}")
        built[src] = (ctypes.CDLL(str(out)), stdout + stderr)
    return built


def entry(handle, name: str, argtypes):
    fn = getattr(handle, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build_other(src: Path):
    """Compile another octave-stack source -> (its ``p360_octave_stack``
    entry, nvcc output)."""
    from pano360_tpu_torch import _kernels
    handle, log = build_others([src])[src]
    return entry(handle, "p360_octave_stack",
                 _kernels._SIGNATURES["gauss_octave"]["p360_octave_stack"]), \
        log


PLAN_REPS = 50
HOST_REPS = 200


def host_ms(fn, reps: int):
    """Mean host ms of ``fn()`` over ``reps`` calls (nothing waits for
    the device) -> (ms, the last result)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) / reps * 1e3, out


def device_total_ms(fn, reps: int) -> float:
    """Mean device time in ms of everything one ``fn()`` runs on the
    card (``torch.profiler``): 2 ``reps`` calls in one session, the
    device entries of the last ``reps`` summed (the profiler can miss a
    session's first entries)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2 * reps):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e.time_range.start, e.time_range.elapsed_us())
                for e in prof.events() if e.device_type == DeviceType.CUDA)
    per_call = max(round(len(ev) / (2 * reps)), 1)
    return sum(us for _, us in ev[-reps * per_call:]) / reps / 1e3


def grid_sample_fn(img_nhwc, x, y):
    """One ``grid_sample`` (bilinear, reflection, align_corners False) of
    an (N, H, W, 4) stack at pixel coordinates x, y (N, ph, pw), as a
    function; the input and the grid are built here, outside any timed
    window."""
    _, h, w, _ = img_nhwc.shape
    inp = img_nhwc.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([(2 * x + 1) / w - 1, (2 * y + 1) / h - 1],
                       dim=-1).float().contiguous()

    def run():
        return torch.nn.functional.grid_sample(
            inp, grid, mode="bilinear", padding_mode="reflection",
            align_corners=False)
    return run


def warp_inputs(regions, projection="spherical", max_resolution=1400):
    """A render's warp inputs on the card: -> (RGBA stack (N, H, W, 4)
    on the device, host small arguments (projs, bottoms, wins,
    resolution, range_min), layout)."""
    from pano360_tpu_torch import geometry, render
    proj = geometry.PROJECTIONS[projection]
    rgba, lay = render.prepare(regions, "multiband", max_resolution,
                               torch.device("cuda"), projection=proj)
    projs = np.stack([r.proj() for r in regions])
    return rgba, (projs, lay.bottoms, lay.wins, lay.resolution,
                  lay.im_range[0]), lay


def _against(row, kernel, others, name, reps):
    """Each other launch (name -> fn) in turns with ``kernel``: wrapper
    ms and device ms (this, other, other, this), and bit-identity of its
    output to ``row``'s plain version (``others`` give (patches,
    invalid))."""
    ref = row.pop("_ref")
    for label, fn in others.items():
        kp, ki = fn()
        torch.cuda.synchronize()
        o = dict(identical=torch.equal(kp, ref[0])
                 and torch.equal(ki.bool(), ref[1]))
        o["this_ms"], o["ms"] = alternate(kernel, fn, reps)
        o["this_device_ms"], o["device_ms"] = device_turns(
            kernel, fn, name, reps, flush=True)
        row[label] = o


def _gate(row, kp, ki, rp, ri):
    torch.cuda.synchronize()
    row.update(identical=torch.equal(kp, rp) and torch.equal(ki, ri),
               flips=int((ki != ri).sum()),
               max_abs_err=float((kp - rp).abs().max()),
               invalid_dtype=str(ki.dtype), _out=(kp, ki), _ref=(rp, ri))


def _launch_times(row, kernel, library, reps):
    """The kernel's launch and the library call in turns (CUDA events
    over back-to-back calls: ``ms``, ``library_ms``), and each one's host
    time per call, nothing waiting for the device (``launch_host_ms``,
    ``library_host_ms``)."""
    row["ms"], row["library_ms"] = alternate(kernel, library, reps)
    row["launch_host_ms"] = host_ms(kernel, HOST_REPS)[0]
    row["library_host_ms"] = host_ms(library, HOST_REPS)[0]
    torch.cuda.synchronize()


def _device_times(row, kernel, name, reps):
    """The kernel's device ms per launch with the L2 flushed before each
    (``device_ms``, held to ``bound_ms``) and back to back, its inputs
    partly left in L2 by the launch before (``device_warm_ms``)."""
    row["device_ms"] = device_ms(kernel, name, reps, flush=True)
    row["device_warm_ms"] = device_ms(kernel, name, reps)


def _cost(row, cost):
    row.update({k: cost[k] for k in ("bytes", "bound_ms", "bound_by",
                                     "sectors", "sector_floor_ms",
                                     "segments_64", "segments_128")})


def measure_exact(imgs, small, ph: int, pw: int, period, cylindrical: bool,
                  reps: int = WARP_REPS, others=None, shapes=None):
    """One exact-warp case on the card -> a dict: the prepare step's host
    ms (``plan_ms``), the launch with that plan (``ms``, in turns with
    ``grid_sample`` on the same sample grid: ``library_ms``), the plain
    version (``plain_ms``), the kernel's device ms per launch,
    bit-identity and mask flips, the bound and the sector floor, the
    kernel's outputs (``_out``); ``others``: other launches (name -> fn)
    timed in turns with this one; ``shapes``: the true (h, w) of images
    of mixed sizes zero-padded into ``imgs``."""
    from pano360_tpu_torch.ops import warp_kernel as W
    projs, bottoms, wins, res, rmin = small
    kw = dict(wins=wins, period=period, cylindrical=cylindrical,
              shapes=shapes)
    plan_ms, plan = host_ms(lambda: W.prepare_warp(
        projs, bottoms, wins, res, rmin, ph, pw, period, cylindrical,
        imgs.device, shapes), PLAN_REPS)

    def kernel():
        return W.launch_warp(imgs, plan)

    def plain():
        return W.backward_warp_ref(imgs, projs, bottoms, res, rmin, ph, pw,
                                   **kw)
    row = dict(n=len(projs), ph=ph, pw=pw, cylindrical=cylindrical,
               plan_ms=plan_ms)
    _gate(row, *kernel(), *plain())
    row["plain_ms"] = timed(plain, reps)
    _device_times(row, kernel, "backward_warp_kernel", reps)
    _cost(row, W.backward_warp_cost(imgs, projs, bottoms, res, rmin, ph, pw,
                                    **kw))
    p_d, b_d, w_d, s_d = W.on_device(imgs.device, projs, bottoms, wins,
                                     shapes)
    x, y, _ = W.sample_points(tuple(imgs.shape[1:3]), p_d, b_d, res, rmin,
                              ph, pw, w_d, period, cylindrical, s_d)
    _launch_times(row, kernel, grid_sample_fn(imgs, x, y), reps)
    _against(row, kernel, others or {}, "backward_warp_kernel", reps)
    return row


def measure_mip(rgba, small, lay, reps: int = WARP_REPS, others=None,
                before_plan=None):
    """The mip-sampled warp at the ``--warp pallas`` plan of a spherical
    layout, as ``measure_exact``; also ``plan_windows`` (host ms, and
    ``before_plan``'s beside it), ``build_mips`` (per call and on the
    device), the plan's levels, and ``grid_sample`` on the level's grid
    when every tile samples one level. ``others``: name -> a function of
    (levels, plan) that binds another launch."""
    from pano360_tpu_torch.ops import warp_mip as M
    projs, bottoms, wins, res, rmin = small
    hw = tuple(rgba.shape[1:3])
    args = (projs, bottoms, res, rmin, hw, lay.ph, lay.pw)
    kw = dict(period=lay.period)
    row = dict(n=len(projs), ph=lay.ph, pw=lay.pw)
    row["plan_windows_ms"], (origins, ok, wy, wx, nl) = host_ms(
        lambda: M.plan_windows(*args, **kw), PLAN_REPS)
    if before_plan is not None:
        row["before_plan_windows_ms"], theirs = host_ms(
            lambda: before_plan(*args, **kw), PLAN_REPS)
        row["plan_identical"] = bool(np.array_equal(theirs[0], origins)
                                     and theirs[1:] == (ok, wy, wx, nl))
    levels = np.bincount(origins[..., 2].ravel(), minlength=nl).tolist()
    row.update(ok=bool(ok), window=(wy, wx), n_levels=nl,
               tiles_per_level=levels)

    def mips_fn():
        return M.build_mips(rgba, nl, wy, wx)
    mips = mips_fn()
    row["build_mips_ms"] = timed(mips_fn, reps)
    row["build_mips_device_ms"] = device_total_ms(mips_fn, reps)
    dims = [m.shape[1:3] for m in mips]
    row["plan_ms"], plan = host_ms(lambda: M.prepare_mip_warp(
        projs, bottoms, wins, res, rmin, origins, lay.ph, lay.pw, wy, wx, hw,
        dims, lay.period, False, rgba.device), PLAN_REPS)

    def kernel():
        return M.launch_mip_warp(mips, plan)

    margs = (mips, projs, bottoms, res, rmin, origins, lay.ph, lay.pw, wy,
             wx, hw)

    def plain():
        return M.backward_warp_mip_ref(*margs, wins=wins, **kw)
    _gate(row, *kernel(), *plain())
    row["plain_ms"] = timed(plain, reps)
    _device_times(row, kernel, "backward_warp_mip_kernel", reps)
    _cost(row, M.backward_warp_mip_cost(*margs, wins=wins, **kw))
    if sum(v > 0 for v in levels) == 1:       # one level: one gather
        x, y, *_ = M.mip_sample_points(mips, projs, bottoms, res, rmin,
                                       origins, lay.ph, lay.pw, hw, wins,
                                       **kw)
        _launch_times(row, kernel, grid_sample_fn(
            mips[int(np.argmax(levels))], x, y), reps)
    else:
        row["ms"], row["library_ms"] = timed(kernel, reps), None
    _against(row, kernel, {k: bind(mips, plan)
                           for k, bind in (others or {}).items()},
             "backward_warp_mip_kernel", reps)
    return row


def _narrow_params(plan, floats: int):
    """A plan's parameter rows cut to another checkout's PARAM_FLOATS (the
    leading entries have one layout)."""
    return plan.params[:, :floats].contiguous()


def _before_exact(fn, floats, imgs, small, ph, pw, period, cylindrical):
    """A launch of another checkout's exact warp entry: this tree's plan,
    its parameter rows at that checkout's width."""
    from pano360_tpu_torch import _kernels
    from pano360_tpu_torch.ops import warp_kernel as W
    projs, bottoms, wins, res, rmin = small
    dev = imgs.device
    plan = W.prepare_warp(projs, bottoms, wins, res, rmin, ph, pw, period,
                          cylindrical, dev)
    prm = _narrow_params(plan, floats)
    n, h, w, _ = imgs.shape

    def run():
        patches = torch.empty((n, ph, pw, 4), device=dev)
        invalid = torch.empty((n, ph, pw), dtype=torch.bool, device=dev)
        _kernels.check(fn(plan.c_launch, imgs.data_ptr(), h, w,
                          prm.data_ptr(), patches.data_ptr(),
                          invalid.data_ptr(), _kernels.stream_ptr(dev)),
                       "before")
        return patches, invalid
    return run


def _before_mip(fn, floats):
    """A function of (levels, plan) that binds a launch of the other
    checkout's mip warp entry, as ``_before_exact``."""
    from pano360_tpu_torch import _kernels

    def bind(mips, plan):
        dev = plan.device
        prm = _narrow_params(plan, floats)

        def run():
            ptrs = (ctypes.c_void_p * len(mips))(*[m.data_ptr()
                                                   for m in mips])
            patches = torch.empty((plan.n, plan.ph, plan.pw, 4), device=dev)
            invalid = torch.empty((plan.n, plan.ph, plan.pw),
                                  dtype=torch.bool, device=dev)
            _kernels.check(fn(plan.c_launch, ptrs,
                              plan.origins_dev.data_ptr(), prm.data_ptr(),
                              patches.data_ptr(), invalid.data_ptr(),
                              _kernels.stream_ptr(dev)), "before")
            return patches, invalid
        return run
    return bind


def _load_module(path: Path, name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod         # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def _before_entries(tree: Path):
    """The warps of another checkout of the package, built here -> (a
    function binding its exact launch, a function binding its mip
    launch, its ``plan_windows``)."""
    import re
    from pano360_tpu_torch import _kernels
    pkg = tree / "pano360_tpu_torch"
    wrapper = (pkg / "ops" / "warp_kernel.py").read_text()
    srcs = [pkg / "csrc" / "backward_warp.cu",
            pkg / "csrc" / "backward_warp_mip.cu"]
    names = ("p360_backward_warp", "p360_backward_warp_mip")
    built = build_others(srcs)
    for src in srcs:
        print(f"ptxas, {src}:\n{built[src][1]}", flush=True)
    plan_windows = _load_module(pkg / "ops" / "warp_mip.py",
                                "p360_before_warp_mip").plan_windows
    floats = re.search(r"^PARAM_FLOATS = (\d+)", wrapper, re.M)
    if floats is None:
        sys.exit(f"measure: {tree} is from before the warp plans (no "
                 "PARAM_FLOATS): its C interface is not this tree's")
    floats = int(floats.group(1))
    exact, mip = [entry(built[src][0], name,
                        _kernels._SIGNATURES[src.stem][name])
                  for src, name in zip(srcs, names)]
    return (functools.partial(_before_exact, exact, floats),
            _before_mip(mip, floats), plan_windows)


def warps_main(args, smi: str):
    from pano360_tpu_torch import _kernels
    from pano360_tpu_torch.register import PanoImage
    _kernels.lib()
    for stem in ("backward_warp", "backward_warp_mip"):
        print(f"ptxas, {stem}.cu:\n" + _kernels.build_log(stem), flush=True)
    before = None if args.before is None else _before_entries(args.before)

    imgs_f, u8, rots, focal = bench_views()
    intr = np.diag([focal, focal, 1.0])
    regions = [PanoImage(im, r, intr.copy()) for im, r in zip(u8, rots)]
    rows = {}
    for projection, cap in (("spherical", 1400), ("cylindrical", 1400),
                            ("spherical", 4000)):
        rgba, small, lay = warp_inputs(regions, projection, cap)
        cyl = projection == "cylindrical"
        others = {} if before is None else {"before": before[0](
            rgba, small, lay.ph, lay.pw, lay.period, cyl)}
        key = f"exact_{projection}" + ("" if cap == 1400 else f"_{cap}")
        rows[key] = measure_exact(rgba, small, lay.ph, lay.pw, lay.period,
                                  cyl, others=others)
        rows[key].pop("_out")
        print(json.dumps({key: rows[key]}), flush=True)
        del rgba
    # the mixed-size layout: true sizes in the plan
    mixed_u8, _, _ = bench_mixed_views()
    mixed = [PanoImage(im, r, intr.copy()) for im, r in zip(mixed_u8, rots)]
    rgba, small, lay = warp_inputs(mixed)
    rows["exact_mixed"] = measure_exact(rgba, small, lay.ph, lay.pw,
                                        lay.period, False, shapes=lay.shapes)
    rows["exact_mixed"].pop("_out")
    print(json.dumps({"exact_mixed": rows["exact_mixed"]}), flush=True)
    del rgba
    rgba, small, lay = warp_inputs(regions, "spherical")
    rows["mip"] = measure_mip(
        rgba, small, lay,
        others={} if before is None else {"before": before[1]},
        before_plan=None if before is None else before[2])
    rows["mip"].pop("_out")
    print(json.dumps({"mip": rows["mip"]}), flush=True)
    summary = dict(card=smi, identical=all(r["identical"]
                                           for r in rows.values()))
    print(json.dumps(summary), flush=True)
    if not summary["identical"]:
        sys.exit("measure: a warp kernel differs from its plain version")


SCALE_SHAPE, SCALE_OVERLAP, SCALE_SEED = (1296, 1728), 0.45, 7


# rounds of turns (every version in order, then reversed) per world: the
# host's clock varies between runs by tens of percent on the card's
# machine, so each version's median of 2 x TRAVERSE_ROUNDS runs is kept
TRAVERSE_ROUNDS = 3

TRAVERSE_WORLDS = [
    ("bench", BENCH_VIEWS, BENCH_SHAPE, BENCH_OVERLAP, BENCH_SEED),
    ("scale25", 25, SCALE_SHAPE, SCALE_OVERLAP, SCALE_SEED),
    ("scale50", 50, SCALE_SHAPE, SCALE_OVERLAP, SCALE_SEED)]


def _sync_site(filename: str, lineno: int) -> str:
    """"file:line" of a host sync: the line of the package that made it
    (the innermost frame of ``pano360_tpu_torch`` but this module when the
    warning names a line of torch)."""
    here = Path(__file__).resolve()
    if "pano360_tpu_torch" not in filename:
        import traceback
        for frame in reversed(traceback.extract_stack()):
            path = Path(frame.filename)
            if ("pano360_tpu_torch" in frame.filename
                    and path.resolve() != here):
                return f"{path.name}:{frame.lineno}"
    return f"{Path(filename).name}:{lineno}"


def host_syncs(fn):
    """(``fn()``, {"file:line": count}) of the host syncs it made: the
    warnings of ``torch.cuda.set_sync_debug_mode("warn")``, each at the
    line of the package that made it (``_sync_site``)."""
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        # not the mode's own notice ("Synchronization debug mode is a
        # prototype feature"), which a first use in a process prints
        if "called a synchronizing CUDA operation" in str(message):
            sites[_sync_site(filename, lineno)] += 1
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, dict(sites)


def _traverse_run(fn, imgs, matches, device):
    stats = {}
    t0 = time.perf_counter()
    regs = fn(imgs, matches, device=device, stats=stats)
    return time.perf_counter() - t0, stats, regs


def _device_ops(fn):
    """(device operations, busy ms) of one ``fn()`` (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -float("inf")
    for a, b in ev:
        if b > end:
            busy += b - max(a, end)
            end = b
    return len(ev), busy / 1e3


def traverse_main(args, smi: str, device="cuda"):
    from pano360_tpu_torch import register, synth
    from pano360_tpu_torch.pipeline import idx_to_keypoints, matching
    versions = {"this": register.traverse,
                "this, eager": functools.partial(register.traverse,
                                                 capture=False)}
    for i, tree in enumerate(args.traverse):
        versions[str(tree)] = _load_module(
            tree / "pano360_tpu_torch" / "register.py",
            f"p360_other_register_{i}").traverse
    for name, n, shape, overlap, seed in TRAVERSE_WORLDS:
        imgs, _, _ = synth.make_views(n_views=n, shape=shape, overlap=overlap,
                                      seed=seed)
        u8 = [(im * 255).astype(np.uint8) for im in imgs]
        del imgs
        t0 = time.perf_counter()
        kpts, matches = matching(u8, torch.device(device))
        match_s = time.perf_counter() - t0
        graph = idx_to_keypoints(matches, kpts)
        for fn in versions.values():         # first runs: the allocator
            fn(u8, graph, device=device)      # grows for this world's sizes
        order = (list(versions) + list(versions)[::-1]) * TRAVERSE_ROUNDS
        rows = {v: dict(seconds=[]) for v in versions}
        for v in order:
            secs, stats, regs = _traverse_run(versions[v], u8, graph, device)
            rows[v]["seconds"].append(secs)
            rows[v].update(lm_iterations=stats["lm_iterations"],
                           polish_iterations=stats["polish_iterations"],
                           placed=len(regs), _regs=regs, edges=stats[
                               "ba_edges"], edge_points=stats["ba_edge_points"])
        mine = rows["this"].pop("_regs")
        for v, row in rows.items():
            theirs = row.pop("_regs", mine)
            row["median_s"] = float(np.median(row["seconds"]))
            iters = sum(row["lm_iterations"]) + row["polish_iterations"]
            row["s_per_iteration"] = row["median_s"] / iters
            row["ops"], row["busy_ms"] = _device_ops(
                lambda: versions[v](u8, graph, device=device))
            row["busy_ms_per_iteration"] = row["busy_ms"] / iters
            _, sites = host_syncs(lambda: versions[v](u8, graph,
                                                      device=device))
            row["host_syncs"] = sum(sites.values())
            row["sync_sites"] = sites
            row["rot_max_diff"] = max(
                (float(np.abs(a.rot - b.rot).max()) for a, b in
                 zip(theirs, mine)), default=0.0) \
                if len(theirs) == len(mine) else None
            row["identical"] = len(theirs) == len(mine) and all(
                np.array_equal(a.rot, b.rot) and np.array_equal(a.intr, b.intr)
                for a, b in zip(theirs, mine))
        print(json.dumps(dict(world=name, views=n, shape=list(shape),
                              match_s=match_s, versions=rows)), flush=True)
    print(json.dumps(dict(card=smi)), flush=True)


# rounds of turns (versions in order, then reversed) per world in
# ``--features``: six timed runs of each version
FEATURE_ROUNDS = 3


def _import_tree(tree: Path, names=("pipeline",)):
    """Another checkout's ``pano360_tpu_torch.<name>`` modules (a tuple,
    one for each of ``names``) with the rest of its package: this tree's
    modules are set aside while they import and put back after, and the
    other modules keep their own."""
    import importlib

    def ours():
        return [k for k in sys.modules
                if k.split(".")[0] == "pano360_tpu_torch"]
    mine = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, str(tree))
    try:
        return tuple(importlib.import_module(f"pano360_tpu_torch.{name}")
                     for name in names)
    finally:
        sys.path.remove(str(tree))
        for k in ours():
            del sys.modules[k]
        sys.modules.update(mine)


def synced(fn):
    """(seconds of ``fn()`` on the host clock, ending in a device sync,
    its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


# the extraction's stages and the functions that run them: names in the
# SIFT module, or "sift_front.<name>" and "sift_tail.<name>" in the
# kernels of its front end and tail
SIFT_STAGES = (
    ("base", ("_base_image", "sift_front.base_image")),
    ("scale space", ("_gauss_and_dog", "sift_front.small_octave")),
    ("candidates", ("_octave_candidates",)),
    ("Newton field", ("_newton_step_field", "sift_tail.newton_field")),
    ("refine", ("_refine", "sift_tail.refine")),
    ("compaction and patches", ("_extract_patches",)),
    ("orientation", ("_orientation_hist", "_peak_angles",
                     "sift_tail.orientation")),
    ("descriptor", ("_descriptors", "_descriptors_dense",
                    "sift_tail.descriptors")),
)
_STAGE = "sift stage: "


@contextlib.contextmanager
def stage_ranges(sift):
    """Inside, each function of ``SIFT_STAGES`` found in the SIFT module
    ``sift`` (this tree's or another checkout's) runs in a
    ``record_function`` range named for its stage."""
    saved = []
    for stage, names in SIFT_STAGES:
        for name in names:
            owner, attr = sift, name
            if "." in name:
                mod, attr = name.split(".")
                owner = getattr(sift, mod, None)
            fn = getattr(owner, attr, None)
            if fn is None:
                continue

            def ranged(*a, _fn=fn, _label=_STAGE + stage, **kw):
                with torch.profiler.record_function(_label):
                    return _fn(*a, **kw)
            saved.append((owner, attr, fn))
            setattr(owner, attr, ranged)
    try:
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


@contextlib.contextmanager
def recording(module, names):
    """Inside, each function ``names`` of ``module`` keeps its arguments
    before it runs: yields {name: [(args, kwargs), ...]}."""
    calls = {name: [] for name in names}
    saved = {name: getattr(module, name) for name in names}

    def spy(name):
        def fn(*args, **kwargs):
            calls[name].append((args, kwargs))
            return saved[name](*args, **kwargs)
        return fn
    for name in names:
        setattr(module, name, spy(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def _stage_of(t: float, ranges, starts) -> str:
    """The stage of host time ``t``: the innermost range around it, else
    by the range before it (none: the gray image and the upload; the
    keypoint stage: the final top-k and the keypoint stage's copies; any
    other: the compaction and the patches)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 4, -1), -1):
        if ranges[j][1] >= t:
            return ranges[j][2]
    if i < 0:
        return "gray and upload"
    if ranges[i][2] in ("orientation", "descriptor"):
        return "final top-k and copies"
    return "compaction and patches"


def stage_split(fn, sift) -> dict:
    """The device time and operations of one eager ``fn()`` by stage of
    the SIFT extraction (``SIFT_STAGES``), from ``torch.profiler``: each
    device operation belongs to the CUDA runtime call that launched it
    (the same correlation id; PyTorch's kernels and those launched
    through ``ctypes`` alike), and that one to its stage by host time.
    -> {stage: {"ms", "ops"}} with "total" (every device operation of
    the run) and "unattributed" (no launching call found)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with stage_ranges(sift), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end,
                     e.name[len(_STAGE):]) for e in events
                    if e.device_type == DeviceType.CPU
                    and e.name.startswith(_STAGE))
    starts = [r[0] for r in ranges]
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU
                and e.name.startswith(("cuda", "cu"))}
    out = collections.defaultdict(lambda: dict(ms=0.0, ops=0))
    total = dict(ms=0.0, ops=0)
    for e in events:
        if (e.device_type != DeviceType.CUDA
                or e.name.startswith(_STAGE)):   # the ranges' own spans
            continue
        t = launched.get(e.id)
        for row in (total, out["unattributed"] if t is None else
                    out[_stage_of(t, ranges, starts)]):
            row["ms"] += e.time_range.elapsed_us() / 1e3
            row["ops"] += 1
    out["total"] = total
    return dict(out)


def features_against(feats, res, ref_feats, ref_res) -> dict:
    """Features and match graph of one version against another's: the
    share of the valid keypoints whose position is among the other's
    valid ones (per image, as multisets), the largest angle (on the
    circle) and descriptor differences between keypoints at the same
    position (each the nearest in angle), and whether the two match
    graphs have the same edges."""
    a, b = ([t.cpu().numpy() for t in (f.xy, f.angle, f.desc, f.valid)]
            for f in (feats, ref_feats))
    same = total = 0
    dang = ddesc = 0.0
    for i in range(a[0].shape[0]):
        va, vb = a[3][i], b[3][i]
        theirs = collections.defaultdict(list)
        for xy, ang, desc in zip(b[0][i][vb], b[1][i][vb], b[2][i][vb]):
            theirs[xy.tobytes()].append((ang, desc))
        total += max(int(va.sum()), int(vb.sum()))
        for xy, ang, desc in zip(a[0][i][va], a[1][i][va], a[2][i][va]):
            cands = theirs.get(xy.tobytes())
            if not cands:
                continue
            k = min(range(len(cands)), key=lambda j: abs(np.angle(
                np.exp(1j * (float(cands[j][0]) - float(ang))))))
            other_ang, other_desc = cands.pop(k)
            same += 1
            dang = max(dang, abs(float(np.angle(np.exp(
                1j * (float(other_ang) - float(ang)))))))
            ddesc = max(ddesc, float(np.abs(other_desc - desc).max()))
    mine, other = ({(int(i), int(j)) for i in m for j in m[i]}
                   for m in (res[1].item(), ref_res[1].item()))
    return dict(keypoints_same_share=same / max(total, 1),
                angle_max_diff=dang, desc_max_diff=ddesc,
                match_edges_equal=mine == other)


def features_main(args, smi: str, device="cuda"):
    """``--features``: the extraction and the match graph, each timed
    alone, replayed, eager and in each other checkout, in turns; then
    each version's registration (its tree's ``register.traverse``) on
    its match graph, its cameras held to the replayed version's."""
    from pano360_tpu_torch import pipeline, register
    from pano360_tpu_torch.parallel.dryrun import matches_equal
    dev = torch.device(device)
    versions = {"replayed": (pipeline.upload_extract, pipeline.matching),
                "eager": (functools.partial(pipeline.upload_extract,
                                            capture=False),
                          functools.partial(pipeline.matching,
                                            capture=False))}
    # each tree's eager steps and SIFT module, for the stage split
    splits = {"eager": (pipeline.upload_extract, pipeline.S)}
    registers = dict(replayed=register, eager=register)
    for tree in args.features:
        other, registers[str(tree)] = _import_tree(tree,
                                                   ("pipeline", "register"))
        versions[str(tree)] = (other.upload_extract, other.matching)
        splits[str(tree)] = (other.upload_extract, other.S)
    worlds = [("bench", bench_views()[1]), ("mixed", bench_mixed_views()[0])]
    for name, u8 in worlds:
        def extract(v):
            return versions[v][0](u8, dev)[1]

        def graph(v, feats):
            return versions[v][1](u8, dev, feats=feats)
        for v in versions:                  # first runs: the captures and
            graph(v, extract(v))            # the allocator's growth
        rows = {v: dict(extract_s=[], match_s=[]) for v in versions}
        outs = {}
        order = (list(versions) + list(versions)[::-1]) * FEATURE_ROUNDS
        for v in order:
            t_ex, feats = synced(lambda: extract(v))
            t_mg, res = synced(lambda: graph(v, feats))
            rows[v]["extract_s"].append(t_ex)
            rows[v]["match_s"].append(t_mg)
            outs[v] = (feats, res)
        ref_feats, (ref_kpts, ref_matches) = outs["replayed"]
        cams = {}
        for v, row in rows.items():
            stats = {}
            kpts, matches = outs[v][1]
            cams[v] = registers[v].traverse(u8, pipeline.idx_to_keypoints(
                matches, kpts), stats=stats)
            row["lm_iterations"] = [stats["lm_iterations"],
                                    stats["polish_iterations"]]
            row["cameras_identical"] = len(cams[v]) == len(
                cams["replayed"]) and all(
                np.array_equal(a.rot, b.rot) and np.array_equal(a.intr, b.intr)
                for a, b in zip(cams[v], cams["replayed"]))
        for v, row in rows.items():
            feats, (kpts, matches) = outs[v]
            row["extract_median_s"] = float(np.median(row["extract_s"]))
            row["match_median_s"] = float(np.median(row["match_s"]))
            row["features_identical"] = all(
                torch.equal(a, b) for a, b in zip(feats, ref_feats))
            row["match_graph_identical"] = bool(
                all(np.array_equal(a, b) for a, b in zip(kpts, ref_kpts))
                and matches_equal(matches, ref_matches))
            if v != "replayed":
                row["against_replayed"] = features_against(
                    feats, (kpts, matches), ref_feats,
                    (ref_kpts, ref_matches))
            for half, fn in (("extract", lambda: extract(v)),
                             ("match", lambda: graph(v, feats))):
                row[f"{half}_ops"], row[f"{half}_busy_ms"] = _device_ops(fn)
                _, sites = host_syncs(fn)
                row[f"{half}_host_syncs"] = sum(sites.values())
                row[f"{half}_sync_sites"] = sites
        if name == "bench":             # the stage split, in turns
            for v in list(splits) + list(splits)[::-1]:
                upload, sift = splits[v]
                rows[v].setdefault("stages", []).append(stage_split(
                    lambda: upload(u8, dev, capture=False), sift))
        print(json.dumps(dict(world=name, views=len(u8), shapes=sorted(
            {im.shape[:2] for im in u8}), versions=rows)), flush=True)
    print(json.dumps(dict(card=smi)), flush=True)


# SIFT's tail in ``--tail``: the threads per block of each kernel (for the
# occupancy that ptxas's registers and shared memory allow), and where
# the grid descriptor's sampling phase ends in each version of its
# source, with a tail that stores what the samples hold instead of
# binning them (so that the compiler keeps the sampling)
TAIL_THREADS = {"p360_newton_field_kernel": 256,
                "p360_sift_refine_kernel": 128,
                "p360_sift_orient_block_kernel": 256,
                "p360_sift_orient_kernel": 128,
                "p360_sift_descr_kernel": 128}
# an orientation source without the block design's entry point has the
# block design alone, under the grid's kernel name
BLOCK_ORIENT_THREADS = {**TAIL_THREADS, "p360_sift_orient_kernel": 256}
TAIL_STEMS = ("sift_refine", "sift_orient", "sift_descr")
_DESCR_SAMPLING_ONLY = (
    ("  // bin q of thread t",          # one block of 128 threads each
     "  desc[(size_t)kj * THREADS + t] = (sa[t] + sa[t + 128]) + (sb[t] + "
     "sb[t + 128]) + (float)(so0[t] + so0[t + 128]);\n}\n"),
    ("  // binning: lane (c, o)",       # one warp each
     "  float* out = desc + (size_t)kj * DIM + lane;\n"
     "  for (int q = 0; q < 4; ++q)\n"
     "    out[32 * q] = (sab[64 * q + lane].x + sab[64 * q + 32 + lane].y) "
     "+ (float)(so0[64 * q + lane] + so0[64 * q + 32 + lane]);\n}\n"),
)
VARIANT_DIR = Path(__file__).resolve().parent.parent / "build" / "variants"
# H100 (compute capability 9.0): per SM
SM_WARPS, SM_BLOCKS, SM_REGS, SM_SMEM = 64, 32, 65536, 233472


def occupancy(regs: int, smem: int, threads: int) -> float:
    """The theoretical share of an SM's 64 warps that blocks of
    ``threads`` threads of ``regs`` registers each and ``smem`` bytes of
    shared memory keep resident on an H100 (registers allocated in units
    of 256 a warp, 1 KB of shared memory reserved a block)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(SM_BLOCKS, SM_WARPS // warps,
                 SM_REGS // (per_warp * warps), SM_SMEM // (smem + 1024))
    return blocks * warps / SM_WARPS


def ptxas_kernels(log: str, threads=None) -> dict:
    """{kernel name: dict(regs, smem, spill, occupancy)} from ptxas's
    ``-v`` report (a kernel's mangled name holds its plain one; a
    template's instances share it, and the last reported is kept), at
    ``threads`` per block by name (default ``TAIL_THREADS``)."""
    threads = threads or TAIL_THREADS
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = next((k for k in threads if k in mangled), mangled)
        elif "spill stores" in line and name:
            out.setdefault(name, {})["spill"] = line.strip()
        elif ": Used" in line and name:
            words = line.split(":", 1)[1].replace(",", " ").split()
            regs = int(words[words.index("registers") - 1])
            smem = int(words[words.index("smem") - 2]) \
                if "smem" in words else 0
            row = out.setdefault(name, {})
            row.update(regs=regs, smem=smem, occupancy=occupancy(
                regs, smem, threads.get(name, 128)))
    return out


def sampling_only(src: Path) -> Path:
    """A copy of a grid descriptor source (this tree's or an earlier
    one's) whose kernel stops after its sampling phase, written beside
    the builds."""
    text = src.read_text()
    for marker, tail in _DESCR_SAMPLING_ONLY:
        if marker in text:
            head, rest = text.split(marker, 1)
            end = rest.index("\n}\n\n}  // namespace")
            digest = hashlib.sha256(text.encode()).hexdigest()[:12]
            out = VARIANT_DIR / f"sampling_only_{digest}.cu"
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(head + tail + rest[end + 3:])
            return out
    raise ValueError(f"{src}: no sampling phase marker")


@contextlib.contextmanager
def entry_swapped(kernels, name: str, fn):
    """Inside, the kernel entry point ``name`` of a package's loaded
    libraries (``kernels``: its ``_kernels`` module) is ``fn``."""
    lib = kernels.lib()
    saved = getattr(lib, name)
    setattr(lib, name, fn)
    try:
        yield
    finally:
        setattr(lib, name, saved)


def _bits_equal(outs, refs) -> bool:
    return all(a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))
        for a, b in zip(outs, refs))


def tail_main(args, smi: str, device="cuda"):
    """``--tail``: SIFT's refinement, orientation and grid descriptor on
    the bench's first upload batch (this tree's calls, recorded from one
    eager extraction), this tree's kernels against another checkout's in
    turns. Per octave: the refinement here against the other tree's (its
    dense Newton field and its refinement, where it has the field); the
    orientation and the descriptor likewise, and each ``--descr`` source
    through this tree's wrapper. Each: the outputs bit for bit this
    tree's plain version's, the times of each version in turns (CUDA
    events), the device time of each of its kernels with the L2 flushed
    (the orientation's also in turns), and the bound. The descriptor's
    sampling phase alone (each source cut after it, ``sampling_only``)
    and ptxas's registers, shared memory and theoretical occupancy of
    every kernel."""
    from pano360_tpu_torch import _kernels, pipeline
    from pano360_tpu_torch.features import sift as S
    from pano360_tpu_torch.ops import sift_tail as T
    dev = torch.device(device)
    cfg = S.SiftConfig()
    _, u8, _, _ = bench_views()
    with recording(T, ("refine", "orientation", "descriptors")) as calls:
        pipeline.upload_extract(u8[:4], dev, capture=False)
    torch.cuda.synchronize()
    other = _import_tree(args.tail)[0].S.sift_tail if args.tail else None
    fused = other is not None and not hasattr(other, "newton_field")
    out = dict(card=smi, other=str(args.tail), ptxas={
        "this": {k: v for stem in TAIL_STEMS
                 for k, v in ptxas_kernels(_kernels.build_log(stem)).items()}})
    if other is not None:
        other._kernels.lib()
        block = "p360_sift_orient_block" not in (
            other._kernels.CSRC / "sift_orient.cu").read_text()
        out["ptxas"]["other"] = {
            k: v for stem in ("newton_field",) + TAIL_STEMS
            if (other._kernels.CSRC / f"{stem}.cu").exists()
            for k, v in ptxas_kernels(
                other._kernels.build_log(stem),
                BLOCK_ORIENT_THREADS if block else None).items()}

    # the refinement, per octave
    rows = []
    for (dog, l0, y0, x0, c), _ in calls["refine"]:
        def this():
            return T.refine(dog, l0, y0, x0, c)

        def theirs():
            if fused:
                return other.refine(dog, l0, y0, x0, c)
            return other.refine(dog, other.newton_field(dog), l0, y0, x0, c)
        want = S._refine(dog, S._newton_step_field(dog), l0, y0, x0, c)
        row = dict(shape=list(dog.shape), candidates=l0.numel(),
                   identical=_bits_equal(this(), want),
                   bound_ms=T.refine_cost(dog, l0, y0, x0, c)["bound_ms"],
                   device_ms=device_ms(this, "p360_sift_refine_kernel", REPS,
                                       flush=True))
        if other is not None:
            row["other_identical"] = _bits_equal(theirs(), want)
            row["ms"], row["other_ms"] = alternate(this, theirs, REPS)
            names = ["p360_sift_refine_kernel"] + \
                ([] if fused else ["p360_newton_field_kernel"])
            row["other_device_ms"] = {n: device_ms(theirs, n, REPS,
                                                   flush=True)
                                      for n in names}
        else:
            row["ms"] = timed(this, REPS)
        print(json.dumps(dict(refine=row)), flush=True)
        rows.append(row)
    out["refine"] = {k: sum(r[k] for r in rows)
                     for k in ("ms", "device_ms", "bound_ms")}
    out["refine"]["identical"] = all(r["identical"] for r in rows)
    if other is not None:
        out["refine"]["other_ms"] = sum(r["other_ms"] for r in rows)
        out["refine"]["other_device_ms"] = {
            n: sum(r["other_device_ms"][n] for r in rows)
            for n in rows[0]["other_device_ms"]}
        out["refine"]["other_identical"] = all(r["other_identical"]
                                               for r in rows)

    out["orientation"] = orientation_turns(calls["orientation"], other,
                                           args.orient)

    # the descriptor, one launch over the batch's keypoints
    (dargs, dkw), = calls["descriptors"]
    want = S._descriptors(*dargs, **dkw)

    def this_descr():
        return T.descriptors(*dargs, **dkw)
    gx, gy, yf, xf, pcy, pcx, sig, angle, oh, ow = dargs
    row = dict(keypoints=gx.shape[0], orientations=angle.shape[1],
               identical=_bits_equal((this_descr(),), (want,)),
               bound_ms=T.descriptors_cost(yf, xf, pcy, pcx, sig, angle, oh,
                                           ow, gx.shape[1], cfg)["bound_ms"])
    srcs = {"this": _kernels.CSRC / "sift_descr.cu"}
    if other is not None:
        srcs["other"] = other._kernels.CSRC / "sift_descr.cu"
    srcs.update({str(p): p for p in args.descr})
    variants = {name: sampling_only(srcs[name]) for name in srcs
                if name in ("this", "other")}
    built = build_others([p for p in srcs.values() if p != srcs["this"]]
                         + list(variants.values()))
    sig_ = _kernels._SIGNATURES["sift_descr"]["p360_sift_descr"]

    def through(handle):
        fn = entry(handle, "p360_sift_descr", sig_)

        def run():
            with entry_swapped(_kernels, "p360_sift_descr", fn):
                return T.descriptors(*dargs, **dkw)
        return run
    for name, src in srcs.items():
        run = this_descr if name == "this" else through(built[src][0])
        part = dict(identical=_bits_equal((run(),), (want,)),
                    device_ms=device_ms(run, "p360_sift_descr_kernel", REPS,
                                        flush=True))
        if name in variants:
            part["sampling_device_ms"] = device_ms(
                through(built[variants[name]][0]), "p360_sift_descr_kernel",
                REPS, flush=True)
        if name == "this":
            part["ms"] = timed(run, REPS)
        else:
            part["this_ms"], part["ms"] = alternate(this_descr, run, REPS)
            part["ptxas"] = ptxas_kernels(built[src][1])
        row[name] = part
    out["descriptors"] = row
    print(json.dumps(out), flush=True)
    if not (out["refine"]["identical"] and out["orientation"]["identical"]
            and row["this"]["identical"]):
        sys.exit("measure: a kernel differs from its plain version")


def orientation_work(args, cfg) -> dict:
    """What the grid orientation kernel's lanes do for a call's keypoints,
    per keypoint: window rows, window columns, samples inside the window,
    and (column, bin) pairs present (one row tree each)."""
    from pano360_tpu_torch.features import sift as S
    gx, _, y, x, pcy, pcx, sig, oh, ow = args
    m, psg = gx.shape[:2]
    bins = S._orientation_samples(*args, cfg)[1]
    ar = torch.arange(psg, device=gx.device)
    r = torch.round(4.5 * sig)[:, None]
    rows = (((pcy[:, None] + 1 + ar - y[:, None]).abs() <= r)
            & (pcy[:, None] + 1 + ar >= 1)
            & (pcy[:, None] + 1 + ar <= oh[:, None] - 2))
    cols = (((pcx[:, None] + 1 + ar - x[:, None]).abs() <= r)
            & (pcx[:, None] + 1 + ar >= 1)
            & (pcx[:, None] + 1 + ar <= ow[:, None] - 2))
    inside = rows[:, :, None] & cols[:, None, :]
    nb = cfg.ori_bins
    idx = torch.where(inside, bins.reshape(m, psg, psg), nb)
    seen = torch.zeros((m, psg, nb + 1), dtype=torch.bool, device=gx.device)
    seen.scatter_(2, idx.transpose(1, 2), True)    # (keypoint, column, bin)
    return dict(rows=float(rows.sum()) / m, columns=float(cols.sum()) / m,
                samples=float(inside.sum()) / m,
                column_bins=float(seen[..., :nb].sum()) / m)


def orientation_turns(calls, other, variants=()) -> dict:
    """The orientation's one launch over the batch's keypoints (``calls``,
    its recorded call): this tree's kernel and the other tree's
    (``other``: its ``sift_tail``, or None) against this tree's plain
    version bit for bit, in turns: CUDA events, and the device time with
    the L2 flushed; the bound and the work per keypoint
    (``orientation_work``). Each of ``variants`` (other ``sift_orient.cu``
    sources with this tree's C interface) likewise, through this tree's
    wrapper, in turns with this tree's kernel."""
    from pano360_tpu_torch import _kernels
    from pano360_tpu_torch.features import sift as S
    from pano360_tpu_torch.ops import sift_tail as T
    (args, kw), = calls
    gx, gy, y, x, pcy, pcx, sig, oh, ow = args
    want = S._peak_angles(S._orientation_hist(*args, **kw), **kw)

    def this():
        return T.orientation(*args, **kw)
    cost = T.orientation_cost(y, x, pcy, pcx, sig, oh, ow, gx.shape[1])
    row = dict(keypoints=gx.shape[0], identical=_bits_equal(this(), want),
               bound_ms=cost["bound_ms"], bound_by=cost["bound_by"],
               bytes=cost["bytes"], flops=cost["flops"],
               work=orientation_work(args, kw["cfg"]))
    name = "p360_sift_orient_kernel"
    if other is None:
        row["ms"] = timed(this, REPS)
        row["device_ms"] = device_ms(this, name, REPS, flush=True)
    else:
        def theirs():
            return other.orientation(*args, **kw)
        row["other_identical"] = _bits_equal(theirs(), want)
        row["ms"], row["other_ms"] = alternate(this, theirs, REPS)
        row["device_ms"], row["other_device_ms"] = device_turns(
            this, theirs, name, REPS, flush=True)
    built = build_others(list(variants))
    sig_ = _kernels._SIGNATURES["sift_orient"]["p360_sift_orient"]
    for src in variants:
        fn = entry(built[src][0], "p360_sift_orient", sig_)

        def run():
            with entry_swapped(_kernels, "p360_sift_orient", fn):
                return T.orientation(*args, **kw)
        part = dict(identical=_bits_equal(run(), want),
                    ptxas=ptxas_kernels(built[src][1]))
        part["this_ms"], part["ms"] = alternate(this, run, REPS)
        part["this_device_ms"], part["device_ms"] = device_turns(
            this, run, name, REPS, flush=True)
        row[str(src)] = part
        print(json.dumps({str(src): part}), flush=True)
    print(json.dumps(dict(orientation=row)), flush=True)
    return row


def _identical(outs, refs) -> bool:
    return all(torch.equal(a, b) for a, b in zip(outs, refs))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, nargs="*", default=[],
                        help="other gauss_octave.cu sources to time beside "
                        "this one")
    parser.add_argument("--warps", action="store_true",
                        help="time the two backward warps instead")
    parser.add_argument("--before", type=Path, default=None,
                        help="with --warps: another checkout of the package, "
                        "its warps timed in turns with this one's")
    parser.add_argument("--traverse", type=Path, nargs="*", default=None,
                        help="time register.traverse instead, beside the "
                        "register.py of each other checkout given")
    parser.add_argument("--features", type=Path, nargs="*", default=None,
                        help="time the extraction and the match graph "
                        "instead, beside each other checkout given")
    parser.add_argument("--tail", type=Path, nargs="?", const=False,
                        default=None,
                        help="time SIFT's refinement, orientation and grid "
                        "descriptor instead, beside another checkout's if "
                        "given")
    parser.add_argument("--descr", type=Path, nargs="*", default=[],
                        help="with --tail: other sift_descr.cu sources to "
                        "time beside this one")
    parser.add_argument("--orient", type=Path, nargs="*", default=[],
                        help="with --tail: other sift_orient.cu sources to "
                        "time beside this one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("measure: needs a CUDA device")
    from pano360_tpu_torch import _kernels
    from pano360_tpu_torch.features import sift as S
    from pano360_tpu_torch.ops import gauss_octave as G

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    if args.warps:
        return warps_main(args, smi)
    if args.traverse is not None:
        return traverse_main(args, smi)
    if args.features is not None:
        return features_main(args, smi)
    if args.tail is not None:
        return tail_main(args, smi)
    this = _kernels.lib().p360_octave_stack
    print("ptxas, this source:\n" + _kernels.build_log("gauss_octave"))
    others = []
    for src in args.against:
        fn, log = build_other(src)
        print(f"ptxas, {src}:\n{log}")
        others.append((str(src), fn))

    cfg = S.SiftConfig()
    taps = G.chain_taps(cfg.sigma, cfg.n_layers)
    score_cfg = (0.5 * cfg.contrast_thresh / cfg.n_layers, cfg.edge_thresh,
                 cfg.img_border)
    _, u8, _, _ = bench_views()
    rows = []
    for o, base in octave_bases(u8, cfg):
        n, h, w = base.shape
        ref = G.octave_stack_ref(base, taps, score_cfg)

        def runner(fn):
            return lambda: G.launch(fn, base, taps, score_cfg)
        row = dict(octave=o, h=h, w=w, bound_ms=G.octave_stack_cost(
            n, h, w, taps)["bound_ms"],
            taps_per_px=G.kernel_taps_per_px(n, h, w, taps),
            tile=G.kernel_tile(taps, n, h, w)[:2],
            identical=_identical(runner(this)(), ref))
        row["ms"] = timed(runner(this), REPS)
        row["device_ms"] = device_ms(runner(this), "octave_stack_kernel",
                                     REPS)
        for name, fn in others:
            row[name] = dict(identical=_identical(runner(fn)(), ref))
            row[name]["this_ms"], row[name]["ms"] = alternate(
                runner(this), runner(fn), REPS)
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = dict(card=smi, octaves=len(rows),
                   ms=sum(r["ms"] for r in rows),
                   device_ms=sum(r["device_ms"] for r in rows),
                   bound_ms=sum(r["bound_ms"] for r in rows),
                   identical=all(r["identical"] for r in rows))
    for name, _ in others:
        summary[name] = dict(
            ms=sum(r[name]["ms"] for r in rows),
            this_ms=sum(r[name]["this_ms"] for r in rows),
            identical=all(r[name]["identical"] for r in rows))
    print(json.dumps(summary), flush=True)
    if not summary["identical"]:
        sys.exit("measure: the kernel differs from its plain version")


if __name__ == "__main__":
    main()
