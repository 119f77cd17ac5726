#!/usr/bin/env python3
"""The benchmark of ``pano360_tpu_torch``: one run of one cell.

Usage, from the root of a checkout that holds the port:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, ``portbench/configs/<config>.json`` (the CLI's flags), and
a traffic mix, ``portbench/workloads/<traffic>.json`` (the worlds' sizes
and the limits of the check). Per-layer metrics are the readers
``portbench/metrics/<metric>.py``. All three are found by name.

Set-up: load the port's kernels, make the cell's fixed worlds on the
card (the same in every run), stitch the first cold through
``cli.run_images`` with a fresh cache directory (``first_pano_s``,
reported with ``--trace 1``: the CUDA graphs' captures, lazy
initialisation, the cache writes; ``peak_reserved_gib`` is read after
it), add one world made from the seed, and run each world once through
the window's path.
Window: a closed loop, one panorama after the other, the worlds in turn,
from host uint8 views to the host uint8 mosaic through the stage
sequence of ``cli._stitch`` (without its cache writes: its BA cache
pickles every view, some 45 MB a panorama).
With ``--trace 1`` every stage is a span that ends in a device sync and
``torch.profiler`` covers the window's first panoramas. After the window a
sample of the panoramas, drawn from the seed, and the first panorama are
judged by ``reference.py``.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks``: each number compared beside its limit,
also the last lines of standard error).
"""
import time

T_START = time.time()

import argparse                                         # noqa: E402
import contextlib                                       # noqa: E402
import importlib.util                                   # noqa: E402
import json                                             # noqa: E402
import os                                               # noqa: E402
import shutil                                           # noqa: E402
import statistics                                       # noqa: E402
import subprocess                                       # noqa: E402
import sys                                              # noqa: E402
import tempfile                                         # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "pano360_tpu")
FIXED_SEED = 20261017   # the cells' fixed worlds, chosen before any reading
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def fail(msg: str, code: int):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules(names=None) -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``pano360_tpu_torch`` is not ``pano360_tpu``)."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fid:
        return json.load(fid)


def load_cell(name: str, bench: dict) -> dict:
    """The cell's entry, its configuration, its traffic mix and the
    metrics it reports (``end_to_end``, ``per_layer``: entries of
    ``BENCHMARK.json`` that list the cell or list no cells)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        fail(f"no cell {name!r} in BENCHMARK.json (have {sorted(cells)})", 2)
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT, configs[cell["config"]]["file"])
    traffic = load_json(BENCH, "workloads", cell["traffic"] + ".json")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return dict(cell=cell, config=config, traffic=traffic,
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))


def load_reader(metric: str):
    """``portbench/metrics/<metric>.py``'s ``read``."""
    path = os.path.join(BENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


class Stitcher:
    """The window's path: ``cli._stitch``'s single-process stage sequence
    through the port's public stage functions, with the configuration's
    flags, the graphs replayed, and no cache written."""

    def __init__(self, args, device, traced: bool):
        import torch
        from pano360_tpu_torch import pipeline, register, render
        self.torch, self.pipeline = torch, pipeline
        self.register, self.render = register, render
        self.args, self.device, self.traced = args, device, traced
        self.spans = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.traced:
            yield
            return
        from portbench.trace import SPAN_PREFIX
        t0 = time.perf_counter()
        with self.torch.profiler.record_function(SPAN_PREFIX + name):
            yield
            self.torch.cuda.synchronize()
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def __call__(self, imgs):
        """-> (mosaic or None, kpts, matches dict, regions, stats)."""
        args, dev, pl = self.args, self.device, self.pipeline
        stats = {}
        feats = dev_images = None
        with self.span("features"):
            if args.detector == "sift":
                dev_images, feats = pl.upload_extract(imgs, dev, capture=True)
        with self.span("match"):
            kpts, matches = pl.matching(imgs, dev, seed=args.seed,
                                        feats=feats, detector=args.detector,
                                        stats=stats, capture=True)
        with self.span("keypoints"):
            pts = pl.idx_to_keypoints(matches, kpts)
        with self.span("register"):
            regions = self.register.traverse(imgs, pts, badjust=args.ba,
                                             device=dev, stats=stats,
                                             capture=True)
        mosaic = None
        with self.span("render"):
            if regions:
                mosaic = self.render.stitch(
                    regions, blender=args.blend, equalize=args.equalize,
                    crop=args.crop, dev_images=dev_images,
                    max_resolution=args.max_resolution, warp=args.warp,
                    projection=args.projection, device=dev)
        return mosaic, kpts, matches.item(), regions, stats


def cameras(regions, views) -> dict:
    """{view index: (rot, intr)} of the registered regions, matched to
    the input views by identity (the window) or content (a cache)."""
    out = {}
    for r in regions:
        for k, v in enumerate(views):
            if r.img is v or (k not in out and r.img.shape == v.shape
                              and (r.img == v).all()):
                out[k] = (r.rot, r.intr)
                break
    return out


class Sample:
    """A seeded reservoir of ``size`` panoramas per world, so that the
    judged panoramas are a uniform draw whatever the window's count."""

    def __init__(self, rng, n_worlds: int, size: int):
        self.rng, self.size = rng, size
        self.seen = [0] * n_worlds
        self.kept = [[] for _ in range(n_worlds)]

    def offer(self, k: int, item):
        self.seen[k] += 1
        if len(self.kept[k]) < self.size:
            self.kept[k].append(item)
        else:
            j = int(self.rng.integers(self.seen[k]))
            if j < self.size:
                self.kept[k][j] = item


def judge_all(judged, limits, max_resolution):
    """The worst of each number over the judged (world, panorama) pairs,
    against its limit: -> {number: {"value", "limit"}}."""
    from portbench.reference import judge
    worst = {}
    for world, (mosaic, kpts, matches, cams) in judged:
        got = judge(world, kpts, matches, cams, mosaic, max_resolution)
        for key, val in got.items():
            worst[key] = max(worst.get(key, -1.0), val)
    return {key: {"value": worst.get(key, float("inf")), "limit": lim}
            for key, lim in limits.items()}


def run(opts, spec: dict, device) -> dict:
    """Set-up, window and check of one run on ``device``: -> the result
    (its ``checks`` last). On the CPU (the tests) the window's path runs
    the port's plain versions and the device readings are left out."""
    import numpy as np
    import torch
    from pano360_tpu_torch import _kernels, cli
    from portbench.trace import (PANORAMA_SPAN, Trace, busy_us, by_name,
                                 from_profile, idle_gaps)
    from portbench.world import make_world
    traffic, config = spec["traffic"], spec["config"]
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # ---- set-up ---------------------------------------------------------
    if cuda:
        _kernels.lib()
    # the cell's fixed worlds, the same in every run, and one of the run's
    # seed: worlds differ in registration effort (up to 2.5x the LM
    # iterations) and the program's buffers follow their keypoint counts,
    # so worlds of the seed alone would change the window's work and the
    # memory from seed to seed; the seed's world is stitched and judged
    # like the others
    worlds = [make_world(traffic, FIXED_SEED, k, device)
              for k in range(traffic["worlds"])]
    sync()
    cache = tempfile.mkdtemp(prefix="portbench_")
    try:
        args = cli.build_parser().parse_args(
            [cache, *config["flags"], "--cache-dir", cache,
             "--device", device.type])
        t0 = time.time()
        first = cli.run_images(worlds[0].views, args, "world0")
        sync()
        first_pano_s = time.time() - t0
        cold_peak = torch.cuda.max_memory_reserved() if cuda else 0
        kpts0, matches0 = cli.load_match_cache(
            os.path.join(cache, "matches_world0.npz"))
        regions0 = cli.load_ba_cache(os.path.join(cache, "ba_world0.pkl"))
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    judged = [(worlds[0], (first, kpts0, matches0.item(),
                           cameras(regions0, worlds[0].views)))]
    worlds.append(make_world(traffic, opts.seed, 0, device))
    stitch = Stitcher(args, device, traced=bool(opts.trace) and cuda)
    for world in worlds:
        stitch(world.views)
    sync()
    stitch.spans.clear()

    # ---- window ---------------------------------------------------------
    rng = np.random.default_rng(np.random.SeedSequence([opts.seed, 7]))
    sample = Sample(rng, len(worlds), traffic.get("judged_per_world", 2))
    lat, stats, attempted, failed = [], [], 0, 0
    per_world = [[] for _ in worlds]
    n_prof = traffic.get("profiled", 2) if stitch.traced else 0
    prof, prof_spans = None, {}
    if n_prof:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    setup_s = time.time() - T_START
    setup_reserved = torch.cuda.memory_reserved() if cuda else 0
    if cuda:
        print(f"portbench: after the cold panorama: peak "
              f"{cold_peak / 2 ** 30:.3f} GiB; after set-up {setup_s:.2f} s: "
              f"reserved {setup_reserved / 2 ** 30:.3f} GiB, peak "
              f"{torch.cuda.max_memory_reserved() / 2 ** 30:.3f} GiB",
              file=sys.stderr)
    t_start = time.perf_counter()
    deadline = t_start + opts.seconds
    while time.perf_counter() < deadline or attempted < max(n_prof, 1):
        k = attempted % len(worlds)
        views = worlds[k].views
        t0 = time.perf_counter()
        attempted += 1
        mosaic = None
        try:
            with (torch.profiler.record_function(PANORAMA_SPAN)
                  if attempted <= n_prof else contextlib.nullcontext()):
                mosaic, kpts, matches, regions, st = stitch(views)
        except Exception as exc:      # a panorama that raises has failed
            print(f"portbench: panorama {attempted} raised {exc!r}",
                  file=sys.stderr, flush=True)
        if attempted == n_prof:
            prof.__exit__(None, None, None)
            prof_spans = dict(stitch.spans)
            stitch.spans = {}
        if mosaic is None:
            failed += 1
            continue
        lat.append(time.perf_counter() - t0)
        per_world[k].append(lat[-1])
        stats.append(st)
        sample.offer(k, (worlds[k], (mosaic, kpts, matches,
                                     cameras(regions, views))))
    elapsed = time.perf_counter() - t_start
    for k, got in enumerate(per_world):
        if got:
            print(f"portbench: world {k}: {len(got)} panoramas, median "
                  f"{statistics.median(got):.4f} s", file=sys.stderr)
    peak = torch.cuda.max_memory_reserved() if cuda else 0
    reserved = torch.cuda.memory_reserved() if cuda else 0
    done = attempted - failed
    if cuda:
        print(f"portbench: after the window: {done} panoramas, reserved "
              f"{reserved / 2 ** 30:.3f} GiB, peak {peak / 2 ** 30:.3f} GiB",
              file=sys.stderr)

    # ---- metrics --------------------------------------------------------
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": spec["cell"]["chips"], "memory_peak_bytes": int(peak)}
    metrics, breakdown = {}, None
    if not opts.trace:
        values = {"pano_s": elapsed / max(done, 1),
                  "peak_reserved_gib": cold_peak / 2 ** 30,
                  "setup_s": setup_s}
        if len(lat) >= 10:
            values["pano_p90_s"] = statistics.quantiles(
                lat, n=10, method="inclusive")[-1]
        for m in spec["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    elif prof is not None:
        device_ops, host_spans, window = from_profile(prof)
        trace = Trace(stitch.spans or prof_spans, stats, device_ops,
                      host_spans, window, n_prof,
                      {"views": traffic["views"], "shape": traffic["shape"]},
                      {"first_pano_s": first_pano_s,
                       "reserved_growth_mib": (reserved - setup_reserved)
                       / 2 ** 20 / max(done, 1)})
        for m in spec["per_layer"]:
            val = load_reader(m["name"])(trace)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        busy = busy_us([(max(s, window[0]), min(e, window[1]))
                        for _, s, e in device_ops
                        if e > window[0] and s < window[1]])
        dev_info.update(busy_s=busy / 1e6,
                        window_s=(window[1] - window[0]) / 1e6)
        ops = sorted(by_name(device_ops).items(), key=lambda kv: -kv[1][0])
        gaps = sorted(idle_gaps(device_ops, host_spans, window),
                      key=lambda g: -g[1])
        breakdown = {"device_ops": [[n[:120], t / 1e6]
                                    for n, (t, _) in ops[:10]],
                     "idle_gaps": [[n, t] for n, t in gaps[:10]]}

    # ---- correctness ----------------------------------------------------
    judged += [item for kept in sample.kept for item in kept]
    checks = judge_all(judged, traffic["limits"], args.max_resolution)
    correct = (failed == 0 and done > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opts = ap.parse_args(argv)
    if opts.seed < 0:
        fail("--seed must be >= 0", 2)
    spec = load_cell(opts.workload, load_json(ROOT, "BENCHMARK.json"))
    # one host thread for PyTorch's and BLAS's CPU operations, set before
    # either loads: on a card's shared host, runs with eight spread more
    # than runs with one and were no faster
    for var in THREAD_VARS:
        os.environ[var] = "1"
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no result", 3)
    chips = spec["cell"]["chips"]
    if torch.cuda.device_count() < chips:
        fail(f"{torch.cuda.device_count()} CUDA devices, the cell needs "
             f"{chips}: no result", 3)
    try:
        import pano360_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the port is not in this checkout ({exc}): no result", 4)
    print(f"portbench: {opts.workload} seed {opts.seed}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: "
          f"{smi_line()}", file=sys.stderr, flush=True)
    result = run(opts, spec, torch.device("cuda"))
    loaded = forbidden_modules()
    if loaded:
        fail(f"modules of JAX or the JAX package are loaded: {loaded}", 5)
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
