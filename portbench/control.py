#!/usr/bin/env python3
"""The readings that the check's limits are set from, at a cell's own
size on the card: the program's numbers (``reference.judge``) on every
world of ``--seeds`` seeds, through the window's path, and the control's
(``reference.control``: the reference's answers in bfloat16 put in the
program's place) on the worlds of ``--control-seeds`` seeds.

Usage, from the root of a checkout:

    python3 portbench/control.py --workload <cell> --seeds 12 \
        --control-seeds 3 [--first-seed N]

Prints one JSON line per world and, last, for each number the largest
program reading (the lower), the smallest control reading (the upper) and
their ratio. The benchmark's own runs do not run this.
"""
import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args(argv)
    import torch
    from portbench import reference
    from portbench.run import Stitcher, cameras, load_cell, load_json
    from portbench.world import make_world
    spec = load_cell(opts.workload, load_json(ROOT, "BENCHMARK.json"))
    traffic = spec["traffic"]
    device = torch.device(opts.device)
    from pano360_tpu_torch import _kernels, cli
    if device.type == "cuda":
        _kernels.lib()
    args = cli.build_parser().parse_args(
        [".", *spec["config"]["flags"], "--device", device.type])
    stitch = Stitcher(args, device, traced=False)
    prog, ctrl = {}, {}
    for s in range(opts.seeds):
        seed = opts.first_seed + s
        for k in range(traffic["worlds"]):
            world = make_world(traffic, seed, k, device)
            mosaic, kpts, matches, regions, _ = stitch(world.views)
            got = reference.judge(world, kpts, matches,
                                  cameras(regions, world.views), mosaic,
                                  args.max_resolution)
            print(json.dumps({"program": got, "seed": seed, "world": k}),
                  flush=True)
            for key, val in got.items():
                prog[key] = max(prog.get(key, -1.0), val)
            if s < opts.control_seeds:
                got = reference.control(world, args.max_resolution)
                print(json.dumps({"control": got, "seed": seed, "world": k}),
                      flush=True)
                for key, val in got.items():
                    ctrl[key] = min(ctrl.get(key, float("inf")), val)
    summary = {key: {"lower": prog[key], "upper": ctrl.get(key),
                     "ratio": (ctrl[key] / prog[key] if prog[key] > 0
                               and key in ctrl else None)}
               for key in prog}
    print(json.dumps({"workload": opts.workload, "summary": summary}),
          flush=True)


if __name__ == "__main__":
    main()
