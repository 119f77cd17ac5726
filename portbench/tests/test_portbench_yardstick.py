"""The benchmark's frozen copies against the port's originals, and its
own arithmetic, on the CPU."""
import numpy as np
import pytest
import torch

from portbench import cost, trace
from portbench.world import make_views, make_world, world_seed

CELL_SHAPES = [(15, (864, 1152)), (10, (1080, 1440)), (12, (864, 1152))]


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
