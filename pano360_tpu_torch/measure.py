"""Measurement on the card for ``chip_smoke.py`` and the ``gpu`` tests.

- Timing: ``timed`` (CUDA events over back-to-back calls), ``alternate``
  (two functions in turns), ``device_ms`` (a kernel's device time per
  call from ``torch.profiler``, optionally with the L2 flushed before
  each call) and ``synced`` (host seconds ending in a device sync).
- Inputs: the bench world (``bench_views``: 15 views of 864x1152,
  overlap 0.45, seed 42), its mixed-size variant (``bench_mixed_views``:
  the odd views at ``MIXED_SHAPE``), its octave bases (``octave_bases``)
  and a render's warp inputs (``warp_inputs``).
- The warps against their plain versions at a render layout
  (``measure_exact``, ``measure_mip``): bit-identity and mask flips, the
  prepare step, the launch beside ``grid_sample`` on the same sample
  grid, the device time and the bound.
- The match's top-2 search: a chunk's inputs (``knn2_inputs``) and, held
  to float64's answer within the rows' rounding margins, the rows a
  float32 search gets wrong or differs on (``knn2_misses``).
- Witnesses: ``host_syncs`` (the host syncs of a call, by the line of the
  package that made them, from ``torch.cuda.set_sync_debug_mode``) and
  ``recording`` (the arguments of a module's functions as they are
  called).

An A/B of two trees is ``portbench/run.py --trace 1`` run in each
checkout.
"""
from __future__ import annotations

import collections
import contextlib
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from pano360_tpu_torch.ops.knn2 import rounding_margin

_BENCH = dict(n_views=15, shape=(864, 1152), overlap=0.45, seed=42)
# back-to-back launches per timing of a warp (and of grid_sample beside
# it): enough that the first launch's host latency weighs little
_WARP_REPS = 50


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


def _flush_l2():
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
    work around it; with ``flush``, each call after ``_flush_l2``. Each
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
                    _flush_l2()
                fn()
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.time_range.elapsed_us())
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA and name in e.name)
        if len(ev) >= reps:
            return sum(us for _, us in ev[-reps:]) / reps / 1e3
    raise RuntimeError(f"device_ms: {len(ev)} device entries named {name!r} "
                       f"for {2 * reps} calls")


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
    imgs, rots, focal = synth.make_views(**_BENCH)
    return imgs, [(im * 255).astype(np.uint8) for im in imgs], rots, focal


MIXED_SHAPE = (768, 1024)      # the odd views of the mixed-size bench world


def bench_mixed_views():
    """The bench world with its odd-numbered views rendered at
    ``MIXED_SHAPE`` (same rotations, focal and texture): -> (uint8 views,
    rotations, focal)."""
    from pano360_tpu_torch import synth
    _, u8, rots, focal = bench_views()
    tex = synth.world_texture(seed=_BENCH["seed"])
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


_PLAN_REPS = 50
_HOST_REPS = 200


def _host_ms(fn, reps: int):
    """Mean host ms of ``fn()`` over ``reps`` calls (nothing waits for
    the device) -> (ms, the last result)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) / reps * 1e3, out


def _device_total_ms(fn, reps: int) -> float:
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


def _grid_sample_fn(img_nhwc, x, y):
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


def _gate(row, kp, ki, rp, ri):
    torch.cuda.synchronize()
    row.update(identical=torch.equal(kp, rp) and torch.equal(ki, ri),
               flips=int((ki != ri).sum()),
               max_abs_err=float((kp - rp).abs().max()),
               invalid_dtype=str(ki.dtype), _out=(kp, ki))


def _launch_times(row, kernel, library, reps):
    """The kernel's launch and the library call in turns (CUDA events
    over back-to-back calls: ``ms``, ``library_ms``), and each one's host
    time per call, nothing waiting for the device (``launch_host_ms``,
    ``library_host_ms``)."""
    row["ms"], row["library_ms"] = alternate(kernel, library, reps)
    row["launch_host_ms"] = _host_ms(kernel, _HOST_REPS)[0]
    row["library_host_ms"] = _host_ms(library, _HOST_REPS)[0]
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
                  reps: int = _WARP_REPS, shapes=None):
    """One exact-warp case on the card -> a dict: the prepare step's host
    ms (``plan_ms``), the launch with that plan (``ms``, in turns with
    ``grid_sample`` on the same sample grid: ``library_ms``), the plain
    version (``plain_ms``), the kernel's device ms per launch,
    bit-identity and mask flips, the bound and the sector floor, the
    kernel's outputs (``_out``); ``shapes``: the true (h, w) of images of
    mixed sizes zero-padded into ``imgs``."""
    from pano360_tpu_torch.ops import warp_kernel as W
    projs, bottoms, wins, res, rmin = small
    kw = dict(wins=wins, period=period, cylindrical=cylindrical,
              shapes=shapes)
    plan_ms, plan = _host_ms(lambda: W.prepare_warp(
        projs, bottoms, wins, res, rmin, ph, pw, period, cylindrical,
        imgs.device, shapes), _PLAN_REPS)

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
    _launch_times(row, kernel, _grid_sample_fn(imgs, x, y), reps)
    return row


def measure_mip(rgba, small, lay, reps: int = _WARP_REPS):
    """The mip-sampled warp at the ``--warp pallas`` plan of a spherical
    layout, as ``measure_exact``; also ``plan_windows`` (host ms),
    ``build_mips`` (per call and on the device), the plan's levels, and
    ``grid_sample`` on the level's grid when every tile samples one
    level."""
    from pano360_tpu_torch.ops import warp_mip as M
    projs, bottoms, wins, res, rmin = small
    hw = tuple(rgba.shape[1:3])
    args = (projs, bottoms, res, rmin, hw, lay.ph, lay.pw)
    kw = dict(period=lay.period)
    row = dict(n=len(projs), ph=lay.ph, pw=lay.pw)
    row["plan_windows_ms"], (origins, ok, wy, wx, nl) = _host_ms(
        lambda: M.plan_windows(*args, **kw), _PLAN_REPS)
    levels = np.bincount(origins[..., 2].ravel(), minlength=nl).tolist()
    row.update(ok=bool(ok), window=(wy, wx), n_levels=nl,
               tiles_per_level=levels)

    def mips_fn():
        return M.build_mips(rgba, nl, wy, wx)
    mips = mips_fn()
    row["build_mips_ms"] = timed(mips_fn, reps)
    row["build_mips_device_ms"] = _device_total_ms(mips_fn, reps)
    dims = [m.shape[1:3] for m in mips]
    row["plan_ms"], plan = _host_ms(lambda: M.prepare_mip_warp(
        projs, bottoms, wins, res, rmin, origins, lay.ph, lay.pw, wy, wx, hw,
        dims, lay.period, False, rgba.device), _PLAN_REPS)

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
        _launch_times(row, kernel, _grid_sample_fn(
            mips[int(np.argmax(levels))], x, y), reps)
    else:
        row["ms"], row["library_ms"] = timed(kernel, reps), None
    return row


def knn2_inputs(b, m1, m2, d, seed=0, ragged=True):
    """A chunk's inputs on the CPU: D 64 MSOP-like rows (zero mean, unit
    variance), else RootSIFT-like (non-negative, unit norm); desc1 holds
    noisy copies of desc2's rows for 60 % of its rows (so that the ratio
    test passes on many) and fresh rows for the rest; ``ragged``: each
    pair's desc2 valid up to its own count (at least half) with a few
    invalid rows among them, 90 % of desc1 valid."""
    g = torch.Generator().manual_seed(seed)

    def rows(n):
        x = torch.randn((b, n, d), generator=g)
        if d == 64:
            x = x - x.mean(-1, keepdim=True)
            return x / x.std(-1, keepdim=True, unbiased=False)
        x = x.abs()
        return x / x.norm(dim=-1, keepdim=True)
    desc2 = rows(m2)
    pick = torch.randint(0, m2, (b, m1), generator=g)
    near = torch.gather(desc2, 1, pick[..., None].expand(-1, -1, d))
    near = near + 0.3 * rows(m1) * (1.0 if d == 64 else 0.1)
    copy = torch.rand((b, m1), generator=g) < 0.6
    desc1 = torch.where(copy[..., None], near, rows(m1))
    valid1 = torch.ones((b, m1), dtype=torch.bool)
    valid2 = torch.ones((b, m2), dtype=torch.bool)
    if ragged:
        valid1 = torch.rand((b, m1), generator=g) < 0.9
        n2 = torch.randint(max(1, m2 // 2), m2 + 1, (b,), generator=g)
        valid2 = torch.arange(m2)[None] < n2[:, None]
        valid2 &= torch.rand((b, m2), generator=g) >= 0.05
        valid2[torch.arange(b), n2 - 1] = True
    return desc1, desc2, valid1, valid2


def knn2_misses(results, desc1, desc2, valid1, valid2, ratio=0.7):
    """Each ``(best_idx, good)`` of ``results`` against float64's top-2,
    one pair at a time: -> per result (the valid rows a float32 search
    may not give: an index that is no exact nearest within twice the
    rows' rounding margin, or a test that differs from the exact one
    where the distances lie farther than the margin's reach from the
    ratio's line; the valid rows that differ from the exact index or
    test at all)."""
    out = [[0, 0] for _ in results]
    d = desc1.shape[-1]
    for p in range(desc1.shape[0]):
        a, c = desc1[p].double(), desc2[p].double()
        sq1, sq2 = (a * a).sum(-1), (c * c).sum(-1)
        dist = torch.clamp(sq1[:, None] + sq2[None] - 2.0 * a @ c.T, min=0.0)
        dist = torch.where(valid2[p][None], dist, torch.inf)
        d1, idx = dist.min(-1)
        cols = torch.arange(dist.shape[-1], device=dist.device)
        d2 = torch.where(cols == idx[:, None], torch.inf,
                         dist).min(-1).values
        good = (valid1[p] & (d1.sqrt() < ratio * d2.sqrt())
                & torch.isfinite(d2))
        margin = rounding_margin(sq1, torch.where(valid2[p], sq2, 0.0).max(),
                                 d)
        reach = 1.7 * margin.sqrt() + 2.0 ** -21 * (d1.sqrt() + d2.sqrt())
        clear = (d1.sqrt() - ratio * d2.sqrt()).abs() > reach
        clear |= ~torch.isfinite(d2)
        for k, (bi, g) in enumerate(results):
            picked = torch.gather(dist, -1, bi[p][:, None])[:, 0]
            far = picked > d1 + 2 * margin
            out[k][0] += int((valid1[p] & (far | (clear & (g[p] != good))))
                             .sum())
            out[k][1] += int((valid1[p] & ((bi[p] != idx) | (g[p] != good)))
                             .sum())
    return [tuple(o) for o in out]


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


def synced(fn):
    """(seconds of ``fn()`` on the host clock, ending in a device sync,
    its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


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
