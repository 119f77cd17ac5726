"""The benchmark's frozen copies against the port's originals, and its
own arithmetic, on the CPU."""
import json
import os

import numpy as np
import pytest
import torch

from portbench import cost, trace
from portbench.reference import strong_pairs
from portbench.world import (World, look, make_views, make_world, render_view,
                             rig, world_seed, world_texture)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CPU = torch.device("cpu")
CELL_SHAPES = [(15, (864, 1152)), (10, (1080, 1440)), (12, (864, 1152))]


def _json(*parts):
    with open(os.path.join(*parts)) as fid:
        return json.load(fid)


TRAFFICS = sorted({w["traffic"] for w in _json(ROOT, "BENCHMARK.json")[
    "workloads"]})
# portrait views of a panoramic head: rings of 10 at -45, 12 at 0 and 10 at
# +45 degrees and a zenith view
RIG = _json(HERE, "example_rig.json")


@pytest.mark.parametrize("seed", [0, 7])
def test_generator_matches_synth(seed):
    """The worlds' generator gives ``synth.make_views``'s views, rotations
    and focal at a small size (float rounding apart)."""
    from pano360_tpu_torch import synth
    want, rots, focal = synth.make_views(4, (48, 64), overlap=0.5, seed=seed)
    got, grots, gfocal, _ = make_views(4, (48, 64), 0.5, seed,
                                       torch.device("cpu"))
    assert gfocal == focal
    np.testing.assert_array_equal(grots, rots)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=2e-6)
        # uint8 by truncation: a rounding can move a value across an
        # integer, never further
        da = (a * 255).to(torch.uint8).numpy().astype(int)
        assert np.abs(da - (b * 255).astype(np.uint8)).max() <= 1


def test_worlds_follow_the_seed():
    traffic = {"views": 3, "shape": [32, 48], "overlap": 0.5,
               "exposure": [0.7, 1.0]}
    dev = torch.device("cpu")
    big = 2 ** 31 + 12345
    a = make_world(traffic, big, 0, dev)
    b = make_world(traffic, big, 0, dev)
    c = make_world(traffic, big, 1, dev)
    assert all(np.array_equal(x, y) for x, y in zip(a.views, b.views))
    assert not np.array_equal(a.views[0], c.views[0])
    assert world_seed(big, 0) != world_seed(big, 1)
    assert np.all((a.exposure >= 0.7) & (a.exposure <= 1.0))


@pytest.mark.parametrize("n,shape", CELL_SHAPES)
def test_octave_cost_frozen(n, shape):
    """The frozen scale-space cost is the port's at every octave of the
    cells' views, and the octaves are the ones SIFT runs."""
    from pano360_tpu_torch.features import sift
    from pano360_tpu_torch.ops import gauss_octave as G
    taps = G.chain_taps(1.6, 3)
    assert cost.chain_taps(1.6, 3) == taps
    shapes = cost.octave_shapes(shape)
    assert len(shapes) == sift.n_octaves_for(shape)
    base = torch.zeros(1, 2 * shape[0], 2 * shape[1])
    for h, w in shapes:
        assert base.shape[1:] == (h, w)
        assert cost.octave_stack_cost(n, h, w, taps) == \
            G.octave_stack_cost(n, h, w, taps)
        base = base[:, ::2, ::2]
    assert cost.HBM_BYTES_PER_S == G.HBM_BYTES_PER_S
    assert cost.F32_FLOPS_PER_S == G.F32_FLOPS_PER_S
    assert cost.SCORE_OPS == G.SCORE_OPS


def test_busy_and_gaps():
    dev = [("k", 0.0, 10.0), ("k", 5.0, 20.0), ("m", 30.0, 40.0)]
    assert trace.busy_us([(s, e) for _, s, e in dev]) == 30.0
    host = [("portbench.match", 18.0, 35.0)]
    gaps = trace.idle_gaps(dev, host, (0.0, 50.0))
    assert gaps == [("match", 10e-6), ("host", 10e-6)]
    assert trace.by_name(dev) == {"k": (25.0, 2), "m": (10.0, 1)}


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
@pytest.mark.parametrize("name", TRAFFICS)
def test_sweep_worlds_unchanged(name, seed):
    """A sweep traffic's worlds are ``make_views``' at the world's seed,
    with the exposure factors drawn and applied as they always were."""
    traffic = _json(ROOT, "portbench", "workloads", name + ".json")
    got = make_world(traffic, seed, 1, CPU)
    views, rots, focal, _ = make_views(
        traffic["views"], traffic["shape"], traffic["overlap"],
        world_seed(seed, 1), CPU, traffic["fov_deg"], traffic["tilt_jitter"])
    if traffic["exposure"]:
        lo, hi = traffic["exposure"]
        gains = np.random.default_rng(np.random.SeedSequence(
            [seed, 1, 1])).uniform(lo, hi, len(views))
        views = [v.double() * float(a) for v, a in zip(views, gains)]
        np.testing.assert_array_equal(got.exposure, gains)
    assert got.focal == focal and not got.rig
    np.testing.assert_array_equal(got.rots, rots)
    for a, b in zip(got.views, views):
        np.testing.assert_array_equal(a, (b * 255).to(torch.uint8).numpy())


def _ring_of(k: int) -> int:
    ends = np.cumsum([ring["views"] for ring in RIG["rig"]])
    return int(np.searchsorted(ends, k, side="right"))


@pytest.mark.parametrize("seed", [world_seed(5, 0), world_seed(2 ** 31, 3)])
def test_rig_cameras_follow_their_rings(seed):
    """Ring by ring, in yaw order: each camera looks along its ring's
    angles turned by the seed's jitter about its own x (its axis moves by
    that draw) and z (its x axis moves by that one), within 3 jitters."""
    rots, focal = rig(RIG["rig"], RIG["shape"], seed, RIG["fov_deg"],
                      RIG["tilt_jitter"])
    assert focal == RIG["shape"][1] / (2 * np.tan(np.radians(27.5)))
    jit = np.random.default_rng(seed + 1).normal(0, RIG["tilt_jitter"],
                                                 (len(rots), 2))
    k = 0
    for ring in RIG["rig"]:
        for i in range(ring["views"]):
            want = look(np.radians(ring["yaw0_deg"] + 360 * i / ring["views"]),
                        np.radians(ring["pitch_deg"]))
            axis = np.degrees(np.arccos(np.clip(rots[k][2] @ want[2], -1, 1)))
            right = np.degrees(np.arccos(np.clip(rots[k][0] @ want[0], -1,
                                                 1)))
            # one rotation about (x, 0, z): each axis moves by its draw
            # less a share of (jitter's norm)^2 / 24
            np.testing.assert_allclose(
                [axis, right], np.degrees(np.abs(jit[k])), rtol=1e-3)
            assert max(axis, right) <= np.degrees(3 * RIG["tilt_jitter"])
            np.testing.assert_allclose(rots[k] @ rots[k].T, np.eye(3),
                                       atol=1e-12)
            k += 1
    assert k == RIG["views"] == len(rots)


@pytest.mark.parametrize("jitter", [0.0, RIG["tilt_jitter"]])
def test_rig_strong_pairs_close_rings_and_join_them(jitter):
    """Every ring's consecutive views and its closing pair overlap
    strongly (32 pairs); pairs across rings join each ring to the next
    and the zenith view to the +45 ring, so the graph is connected.
    Without jitter: 6 pairs between neighbouring rings, 4 for the zenith,
    48 in all."""
    rots, focal = rig(RIG["rig"], RIG["shape"], 5, RIG["fov_deg"], jitter)
    blank = np.zeros(tuple(RIG["shape"]) + (3,), np.uint8)
    world = World([blank] * len(rots), rots, focal, None, None, True)
    pairs = {(i, j) for i, j, _ in strong_pairs(world)}
    within, start = set(), 0
    for ring in RIG["rig"]:
        n = ring["views"]
        within |= {(start + min(i, (i + 1) % n), start + max(i, (i + 1) % n))
                   for i in range(n) if n > 1}
        start += n
    assert len(within) == 32 and within <= pairs
    across = {}
    for i, j in pairs - within:
        key = (_ring_of(i), _ring_of(j))
        across[key] = across.get(key, 0) + 1
    assert set(across) == {(0, 1), (1, 2), (2, 3)}
    if jitter == 0:
        assert across == {(0, 1): 6, (1, 2): 6, (2, 3): 4}
        assert len(pairs) == 48
    seen, todo = {0}, [0]
    while todo:
        k = todo.pop()
        for i, j in pairs:
            for a, b in ((i, j), (j, i)):
                if a == k and b not in seen:
                    seen.add(b)
                    todo.append(b)
    assert seen == set(range(len(rots)))


def _radial(view: np.ndarray) -> float:
    """Mean |cos| of the angle between each strong gray gradient (above
    the median magnitude) and the direction from the view's centre: ~0.6
    on a texture with no preferred direction, less on a starburst."""
    g = view.astype(np.float64).mean(-1)
    gy, gx = np.gradient(g)
    mag = np.hypot(gx, gy)
    h, w = g.shape
    ry, rx = np.mgrid[0:h, 0:w] - np.array([(h - 1) / 2, (w - 1) / 2])[
        :, None, None]
    cos = np.abs(gx * rx + gy * ry) / (mag * np.hypot(rx, ry) + 1e-12)
    strong = mag > np.median(mag)
    return float(cos[strong].mean())


def test_rig_zenith_view_shows_no_starburst():
    """A rig world's zenith view reads like its 0-degree views on the
    radial measure, where the sweeps' equirectangular texture, looked at
    from the same pole, reads a starburst."""
    small = dict(RIG, shape=[288, 216])
    world = make_world(small, 2 ** 31 + 5, 0, CPU)
    assert world.rig
    level = _radial(world.views[10])
    assert abs(_radial(world.views[-1]) - level) <= 0.05
    pole = render_view(world_texture(7, CPU), world.rots[-1], world.focal,
                       small["shape"])
    assert _radial((pole * 255).to(torch.uint8).numpy()) < level - 0.05


def test_rig_needs_its_view_count():
    with pytest.raises(ValueError, match="rig's total"):
        make_world(dict(RIG, views=32), 1, 0, CPU)
