"""The check that decides ``correct``: its control fails it at every
cell's own size, and faults planted under the timed path make a run's
``correct`` false (CPU; the port's plain versions at a small size)."""
import argparse
import json
import os

import numpy as np
import pytest
import torch

from portbench import reference
from portbench import run as R
from portbench.world import make_world

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CPU = torch.device("cpu")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fid:
        return json.load(fid)


CELLS = [w["name"] for w in _bench()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(cell):
    """The reference's own answers worked out in bfloat16, put in the
    program's place, fail the cell's check on three seeds: every bounded
    number other than the exact counts reads above its limit."""
    spec = R.load_cell(cell, _bench())
    max_res = int(spec["config"]["flags"][
        spec["config"]["flags"].index("--max-resolution") + 1])
    limits = spec["traffic"]["limits"]
    bounded = [k for k, v in limits.items() if v > 0]
    for seed in (11, 12, 13):
        got = reference.control(make_world(spec["traffic"], seed, 0, CPU),
                                max_res)
        assert all(got[k] > limits[k] for k in bounded), (seed, got)


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
