"""A small full-sphere rig through the benchmark's window path on the CPU
(``portbench.run.Stitcher`` under the rig configuration's flags), judged
by ``portbench.reference.judge``, and the counters the rig's layers are
read by (``match.pairs``, ``match.edges``, ``render.patch_px``).

The world: a ring of 6 portrait views of 160x120 at +45 degrees and a
zenith view (``portbench.world.make_world``; field of view 75 degrees,
the harness's tilt jitter). Its 12 strongly overlapping pairs share
0.38-0.47 of a view and turn in plane by 49-178 degrees against each
other, which SIFT's grid descriptor matches only when it turns with its
keypoint: every view placed and every strong pair joined by an edge.
"""
import json
import os

import pytest
import torch

from pano360_tpu_torch import cli, profiling, render
from portbench import reference
from portbench.run import Stitcher, cameras
from portbench.world import make_world

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAFFIC = {"views": 7, "shape": [160, 120], "fov_deg": 75.0,
           "tilt_jitter": 0.02, "exposure": None,
           "rig": [{"pitch_deg": 45.0, "views": 6, "yaw0_deg": 0.0},
                   {"pitch_deg": 90.0, "views": 1, "yaw0_deg": 0.0}]}


@pytest.fixture(scope="module")
def stitched():
    """One panorama of the rig world under the rig configuration's
    flags, recorded (``profiling.recording``), with the render's
    layout."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "sift_incr_multiband_rig_1400.json")) as fid:
        flags = json.load(fid)["flags"]
    device = torch.device("cpu")
    world = make_world(TRAFFIC, 20261017, 0, device)
    args = cli.build_parser().parse_args(
        [".", *flags, "--device", "cpu"])
    layouts = []

    def plan(*a, **kw):
        layouts.append(plan_layout(*a, **kw))
        return layouts[-1]
    plan_layout = render.plan_layout
    rec = {}
    before = profiling.snapshot()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(render, "plan_layout", plan)
        with profiling.recording(rec):
            mosaic, kpts, matches, regions, _ = Stitcher(
                args, device, traced=False)(world.views)
    return dict(world=world, args=args, mosaic=mosaic, kpts=kpts,
                matches=matches, regions=regions, layouts=layouts,
                counters=profiling.delta(rec["totals"], before)["counters"])


def test_small_rig_places_every_view_and_joins_every_strong_pair(stitched):
    s = stitched
    assert len(reference.strong_pairs(s["world"])) == 12
    got = reference.judge(s["world"], s["kpts"], s["matches"],
                          cameras(s["regions"], s["world"].views),
                          s["mosaic"], s["args"].max_resolution)
    assert got["views_unplaced"] == 0, got
    assert got["edges_missing"] == 0, got


def test_rig_counters_count_pairs_edges_and_patch_pixels(stitched):
    s = stitched
    n = len(s["world"].views)
    edges = sum(len(col) for col in s["matches"].values()) // 2
    (layout,) = s["layouts"]
    got = s["counters"]
    assert got["match.pairs"] == n * (n - 1) // 2
    assert got["match.edges"] == edges >= 12
    assert got["render.patch_px"] == (len(s["regions"]) * layout.ph
                                      * layout.pw)
