"""Measurement on the card: CUDA-event timing in turns, the bench
octave bases, and (as a script) the octave-stack kernel against another
build of its source.

Usage, on a CUDA machine::

    python -m pano360_tpu_torch.measure [--against A.cu [B.cu ...]]

builds ``csrc/gauss_octave.cu`` (and each ``--against`` source: an
octave-stack source with the same ``p360_octave_stack`` C interface,
e.g. an earlier version or a variant), checks each bit for bit against
the plain version at the bench octaves (4 views of 864x1152, seed 42,
2x upscaled SIFT base, octaves 0-5), times this one per wrapper call
(CUDA events) and per launch on the device (``torch.profiler``), and
times each other build against this one in turns (this, other, other,
this) with CUDA events over ``REPS`` calls. Prints ptxas's report of
each build, one line per octave and a JSON summary; exits non-zero if
this source's kernel differs from the plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

BENCH_VIEWS, BENCH_SHAPE, BENCH_OVERLAP, BENCH_SEED = 15, (864, 1152), 0.45, 42
REPS = 10


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


def device_ms(fn, name: str, reps: int) -> float:
    """Mean device time in ms of the kernels whose name holds ``name``
    over ``reps`` runs of ``fn`` (``torch.profiler``): the launches
    without the host work around them."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events() if name in e.name]
    return sum(us) / max(len(us), 1) / 1e3


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


def build_other(src: Path):
    """Compile another octave-stack source with the package's flags into
    ``build/kernels/`` -> (its ``p360_octave_stack`` entry, nvcc output)."""
    from pano360_tpu_torch import _kernels
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(_kernels.NVCC_FLAGS).encode())
    out = _kernels.BUILD_DIR / f"libp360_other_{digest.hexdigest()[:16]}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(out)).p360_octave_stack
    fn.argtypes = _kernels._SIGNATURES["gauss_octave"]["p360_octave_stack"]
    fn.restype = ctypes.c_int
    return fn, proc.stdout + proc.stderr


def _identical(outs, refs) -> bool:
    return all(torch.equal(a, b) for a, b in zip(outs, refs))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, nargs="*", default=[],
                        help="other gauss_octave.cu sources to time beside "
                        "this one")
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
