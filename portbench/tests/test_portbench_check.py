"""The check that decides ``correct``: its control fails it at every
cell's own size and on a rig of several rings, the reference's own
answers pass it on the rig and faults planted in them fail it, and
faults planted under the timed path make a run's ``correct`` false (CPU;
the port's plain versions at a small size)."""
import argparse
import json
import os

import numpy as np
import pytest
import torch

from portbench import reference
from portbench import run as R
from portbench.world import exp_so3, make_world

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CPU = torch.device("cpu")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fid:
        return json.load(fid)


CELLS = [w["name"] for w in _bench()["workloads"]]
RIG_CASE = "example_rig"
RIG_LIMITS = "uav_12x1mp"       # the cell whose limits the rig is held to
# and one pair's camera error: above the port's worst pair on 15 rig worlds
# on a card (2.06 px) and on a weakly held view of cmu2_15x1mp (2.1 px),
# below the control's 3.06-4.40 px on the rig and the 7.8 px that a view
# turned by 0.5 degrees gives each of its pairs there
RIG_WORST_PX = 3.0


def _case(name: str):
    """(traffic, limits, max resolution) of a cell, or of the example rig
    (``example_rig.json``: 33 portrait views of 1152x864 in rings at
    -45, 0 and +45 degrees and a zenith view) under ``RIG_LIMITS``'."""
    spec = R.load_cell(RIG_LIMITS if name == RIG_CASE else name, _bench())
    flags = spec["config"]["flags"]
    traffic, limits = spec["traffic"], spec["traffic"]["limits"]
    if name == RIG_CASE:
        with open(os.path.join(HERE, "example_rig.json")) as fid:
            traffic = json.load(fid)
        limits = dict(limits, cam_worst_px=RIG_WORST_PX)
    return traffic, limits, int(flags[flags.index("--max-resolution") + 1])


@pytest.mark.parametrize("cell", CELLS + [RIG_CASE])
def test_control_fails_at_cell_size(cell):
    """The reference's own answers worked out in bfloat16, put in the
    program's place, fail the cell's check on three seeds: every bounded
    number other than the exact counts reads above its limit."""
    traffic, limits, max_res = _case(cell)
    bounded = [k for k, v in limits.items() if v > 0]
    for seed in (11, 12, 13):
        got = reference.control(make_world(traffic, seed, 0, CPU), max_res)
        assert all(got[k] > limits[k] for k in bounded), (seed, got)


@pytest.fixture(scope="module")
def rig_world():
    return make_world(_case(RIG_CASE)[0], 2 ** 31 + 21, 0, CPU)


def _true_cams(world) -> dict:
    return {k: (world.rots[k], reference.intrinsics(world.focal))
            for k in range(len(world.views))}


def _answers(world, cams: dict, max_res: int):
    """The reference's own answers in the program's place: each strong
    pair's true homography as its edge, and ``expected_mosaic`` under
    ``cams`` as the mosaic: -> (cams, matches, mosaic)."""
    matches: dict = {i: {} for i in range(len(world.views))}
    for i, j, _ in reference.strong_pairs(world):
        matches[i][j] = (None, reference.true_homography(world.rots,
                                                         world.focal, i, j))
    placed = sorted(cams)
    img, _ = reference.expected_mosaic(world, [cams[k] for k in placed],
                                       placed, max_res)
    return cams, matches, (img * 255).cpu().numpy()


def test_reference_answers_pass_on_rig(rig_world):
    """Every view placed, every strong pair an edge (the closing pairs
    and those across rings among them), and no error."""
    max_res = _case(RIG_CASE)[2]
    cams, matches, mosaic = _answers(rig_world, _true_cams(rig_world),
                                     max_res)
    got = reference.judge(rig_world, None, matches, cams, mosaic, max_res)
    assert got["views_unplaced"] == 0 and got["edges_missing"] == 0, got
    errors = [v for k, v in got.items() if k not in ("views_unplaced",
                                                     "edges_missing")]
    assert max(errors) < 1e-6, got


def _view_left_out(world, max_res):
    cams = _true_cams(world)
    del cams[16]
    return _answers(world, cams, max_res)


def _camera_turned(view: int):
    def fault(world, max_res):
        """One view turned by 0.5 degrees about its y axis, the mosaic
        rendered under the turned cameras."""
        cams = _true_cams(world)
        rot, intr = cams[view]
        cams[view] = (exp_so3(np.radians([0.0, 0.5, 0.0])) @ rot, intr)
        return _answers(world, cams, max_res)
    fault.__name__ = f"_camera_{view}_turned"
    return fault


def _edge_dropped(world, max_res):
    """The edge of the last strong pair (the zenith view's) left out."""
    cams, matches, mosaic = _answers(world, _true_cams(world), max_res)
    i, j, _ = reference.strong_pairs(world)[-1]
    del matches[i][j]
    return cams, matches, mosaic


def _mosaic_shifted(world, max_res):
    cams, matches, mosaic = _answers(world, _true_cams(world), max_res)
    return cams, matches, np.roll(mosaic, 1, axis=1)


@pytest.mark.parametrize("fault", [
    _view_left_out, *(_camera_turned(k) for k in (0, 16, 27, 32)),
    _edge_dropped, _mosaic_shifted], ids=lambda f: f.__name__.strip("_"))
def test_fault_fails_rig_check(fault, rig_world):
    """Each fault planted in the reference's answers on the rig pushes a
    number over the limits: a view of each ring (-45, 0, +45 degrees)
    and the zenith view turned in turn."""
    _, limits, max_res = _case(RIG_CASE)
    cams, matches, mosaic = fault(rig_world, max_res)
    got = reference.judge(rig_world, None, matches, cams, mosaic, max_res)
    assert any(got[k] > lim for k, lim in limits.items()), got


# a small world the CPU stitches in seconds, with limits of the cells' kind
TINY = {"views": 5, "shape": [240, 320], "overlap": 0.5, "worlds": 1,
        "judged_per_world": 1,
        "limits": {"views_unplaced": 0, "edges_missing": 0,
                   "hom_err_px": 1.0, "cam_err_px": 1.0, "mosaic_err": 3.0}}
FLAGS = ["-s", "1", "--ba", "incr", "-b", "multiband"]


def _run(seed=2 ** 31 + 3):
    torch.set_num_threads(4)
    spec = dict(cell={"chips": 1}, config={"flags": FLAGS}, traffic=TINY,
                end_to_end=[], per_layer=[])
    opts = argparse.Namespace(seed=seed, seconds=0.0, trace=0)
    return R.run(opts, spec, CPU)


def test_window_path_is_the_cli_path(tmp_path):
    """The window's stage sequence gives ``cli.run_images``'s mosaic."""
    from pano360_tpu_torch import cli
    torch.set_num_threads(4)
    world = make_world(TINY, 5, 0, CPU)
    args = cli.build_parser().parse_args(["x", *FLAGS, "--device", "cpu",
                                          "--cache-dir", str(tmp_path)])
    want = cli.run_images(world.views, args, "w")
    got = R.Stitcher(args, CPU, traced=False)(world.views)[0]
    np.testing.assert_array_equal(got, want)


def _unchanged_state(monkeypatch):
    """The registration's steps return their state unchanged: every
    camera stays at its starting rotation."""
    from pano360_tpu_torch import register
    real = register.traverse

    def traverse(*a, **k):
        regions = real(*a, **k)
        for r in regions:
            r.rot = np.eye(3)
        return regions
    monkeypatch.setattr(register, "traverse", traverse)


def _half_batch(monkeypatch):
    """Half of the views' features left out of the extraction."""
    from pano360_tpu_torch import pipeline
    real = pipeline.upload_extract

    def upload_extract(imgs, *a, **k):
        stack, feats = real(imgs, *a, **k)
        valid = feats.valid.clone()
        valid[len(imgs) // 2:] = False
        return stack, feats._replace(valid=valid)
    monkeypatch.setattr(pipeline, "upload_extract", upload_extract)


def _altered_answer(monkeypatch):
    """The mosaic altered where it is made: its columns one pixel off."""
    from pano360_tpu_torch import render
    real = render.stitch
    monkeypatch.setattr(render, "stitch",
                        lambda *a, **k: np.roll(real(*a, **k), 1, axis=1))


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_answer])
def test_fault_makes_run_incorrect(fault, monkeypatch):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"], res["checks"]
