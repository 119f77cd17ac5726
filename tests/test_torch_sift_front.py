"""SIFT's front end (``pano360_tpu_torch.ops.sift_front``): the plain
versions of its two kernels held against the JAX package on the CPU, and
the wrappers' dispatch.

Inputs are numpy-seeded synthetic views and random fields; the JAX side
runs as its own tests run it on the CPU (``JAX_PLATFORMS=cpu``). JAX's
dense extrema score is not returned by ``_octave_candidates``: it is
rebuilt from an exact top-k over every position (its values are the
scores), as ``test_extrema_score_matches_jax_dense_path`` does for the
candidates.

Tolerances: the base image within 1e-6 (the same products and sums in
the same order); the small octave's Gaussian and DoG stacks within 1e-5,
its score the same nonzero set with values within 1e-5.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pano360_tpu import synth
from pano360_tpu.features import sift as jsift
from pano360_tpu.ops.color import bgr2gray as jbgr2gray

from pano360_tpu_torch._kernels import LAUNCHES
from pano360_tpu_torch.features import sift as tsift
from pano360_tpu_torch.ops import gauss_octave as TG
from pano360_tpu_torch.ops import sift_front as F

torch.set_num_threads(1)

BASE_TOL = 1e-6
STACK_TOL = 1e-5


def _views(shape, n=2, seed=11):
    """(n, H, W) f32 gray synthetic views at exactly ``shape``."""
    imgs, _, _ = synth.make_views(n_views=n, shape=shape, seed=seed)
    return np.stack([np.asarray(jbgr2gray(jnp.asarray(im)))
                     for im in imgs]).astype(np.float32)


def _field(shape, n=2, seed=0):
    """Uniform noise in [0, 1)."""
    return np.random.default_rng(seed).random((n,) + shape,
                                              dtype=np.float32)


def _blobs(shape, n=2, seed=0):
    """Gaussian blobs of either sign (sigma 1.5-3 px, one per 30 px) on
    0.5: noise blurred by the chain leaves no extremum, blobs do."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[:h, :w]
    out = np.full((n, h, w), 0.5)
    for i in range(n):
        for _ in range(max(h * w // 30, 2)):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            s = rng.uniform(1.5, 3.0)
            out[i] += (rng.choice([-1, 1]) * rng.uniform(0.2, 0.5) * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)))
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# The base image
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("upscale", [True, False])
@pytest.mark.parametrize("shape,src", [((7, 9), "field"), ((33, 65), "field"),
                                       ((2, 3), "field"),
                                       ((48, 64), "views")])
def test_base_image_matches_jax(upscale, shape, src):
    """Upscaled (11 taps on the 2x grid) and not (13 taps), on odd,
    tiny (narrower than the blur's halo) and view-sized shapes."""
    gray = _views(shape) if src == "views" else _field(shape)
    want = np.asarray(jsift._base_image(
        jnp.asarray(gray), jsift.SiftConfig(upscale=upscale)))
    got = F.base_image(torch.from_numpy(gray),
                       tsift.SiftConfig(upscale=upscale))
    up = 2 if upscale else 1
    assert got.shape == (2, up * shape[0], up * shape[1]) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BASE_TOL)


def test_base_image_cpu_tensor_takes_plain_version():
    gray = torch.from_numpy(_field((33, 65)))
    cfg = tsift.SiftConfig()
    before = LAUNCHES["sift_base"]
    assert torch.equal(F.base_image(gray, cfg), F.base_image_ref(gray, cfg))
    assert torch.equal(tsift._base_image(gray, cfg),
                       F.base_image_ref(gray, cfg))
    assert LAUNCHES["sift_base"] == before


def test_base_delta_and_taps():
    """cv2's base blur: sqrt(1.6^2 - 1^2) in 11 taps upscaled,
    sqrt(1.6^2 - 0.5^2) in 13 taps not."""
    for upscale, delta, k in ((True, (1.6 ** 2 - 1.0) ** 0.5, 11),
                              (False, (1.6 ** 2 - 0.25) ** 0.5, 13)):
        d = F.base_delta(tsift.SiftConfig(upscale=upscale))
        assert d == pytest.approx(delta, abs=1e-12)
        assert F._c_base_taps(d)[1] == k


# ---------------------------------------------------------------------------
# The small octaves
# ---------------------------------------------------------------------------

def _jax_small_octave(base: np.ndarray, cfg):
    """JAX's per-layer chain, its DoG and its dense extrema score."""
    jcfg = jsift.SiftConfig(n_layers=cfg.n_layers, cand_topk="exact")
    g = np.asarray(jsift._gaussian_stack(jnp.asarray(base), jcfg))
    dog = g[:, 1:] - g[:, :-1]
    n, _, h, w = dog.shape
    s = cfg.n_layers
    lay, y, x, ok = (np.asarray(a) for a in jsift._octave_candidates(
        jnp.asarray(dog), jcfg, s * h * w))
    score = np.zeros((n, s, h, w), np.float32)
    for i in range(n):
        li, yi, xi = lay[i][ok[i]], y[i][ok[i]], x[i][ok[i]]
        score[i, li - 1, yi, xi] = np.abs(dog[i, li, yi, xi])
    return g, dog, score


SMALL_SHAPES = [(27, 36), (13, 18), (6, 9), (40, 300)]


@pytest.mark.parametrize("shape", SMALL_SHAPES)
@pytest.mark.parametrize("src", ["views", "blobs"])
def test_small_octave_matches_jax(shape, src):
    """The bench's octaves 6-8 (a base of 4 x 54x72 halves to 27x36, then
    to 14x18, 7x9; here 13x18 and 6x9 too) and a strip whose long side
    sends the kernel through device memory."""
    base = _views(shape) if src == "views" else _blobs(shape, seed=2)
    cfg = tsift.SiftConfig()
    assert not TG.reflect_legal(*shape, TG.chain_taps(1.6, 3))
    g, d, sc = F.small_octave(torch.from_numpy(base), cfg)
    jg, jd, jsc = _jax_small_octave(base, cfg)
    np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=STACK_TOL)
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=STACK_TOL)
    np.testing.assert_array_equal(sc.numpy() > 0, jsc > 0)
    np.testing.assert_allclose(sc.numpy(), jsc, rtol=0, atol=STACK_TOL)
    if src == "blobs" and shape in ((27, 36), (40, 300)):
        assert (jsc > 0).sum() > 0


@pytest.mark.parametrize("n_layers", [2, 4])
def test_small_octave_other_chains_match_jax(n_layers):
    base = _blobs((27, 36), seed=5)
    cfg = tsift.SiftConfig(n_layers=n_layers)
    g, d, sc = F.small_octave(torch.from_numpy(base), cfg)
    jg, jd, jsc = _jax_small_octave(base, cfg)
    assert g.shape == (2, n_layers + 3, 27, 36)
    np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=STACK_TOL)
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=STACK_TOL)
    np.testing.assert_array_equal(sc.numpy() > 0, jsc > 0)
    np.testing.assert_allclose(sc.numpy(), jsc, rtol=0, atol=STACK_TOL)


def test_small_octave_cpu_tensor_takes_plain_version():
    base = torch.from_numpy(_field((27, 36)))
    cfg = tsift.SiftConfig()
    before = LAUNCHES["sift_small_octave"]
    outs = F.small_octave(base, cfg)
    gauss = tsift._gaussian_stack(base, cfg)
    refs = (gauss, gauss[:, 1:] - gauss[:, :-1], TG._extrema_score(
        gauss[:, 1:] - gauss[:, :-1], *F.score_cfg(cfg)))
    assert all(torch.equal(a, b) for a, b in zip(outs, refs))
    assert LAUNCHES["sift_small_octave"] == before


def test_gauss_and_dog_scores_every_octave():
    """The small octaves now come with their score, and the candidates
    from it equal those that ``_octave_candidates`` scores itself."""
    cfg = tsift.SiftConfig()
    taps = TG.chain_taps(cfg.sigma, cfg.n_layers)
    base = torch.from_numpy(_views((27, 36)))
    gauss, dog, score = tsift._gauss_and_dog(base, cfg, taps,
                                             F.score_cfg(cfg))
    assert score is not None and score.shape == (2, 3, 27, 36)
    for a, b in zip(tsift._octave_candidates(dog, cfg, 128, score),
                    tsift._octave_candidates(dog, cfg, 128)):
        assert torch.equal(a, b)


def test_small_octave_shared_memory_rule():
    """6 planes of the octave beside the taps' 2 KB in a block's 227 KB:
    the bench's small octaves and squares up to 42x42 fit, a 40x300
    strip does not."""
    assert all(F.small_octave_in_shared(h, w)
               for h, w in [(27, 36), (14, 18), (7, 9), (42, 42), (42, 228)])
    assert not F.small_octave_in_shared(40, 300)
    assert not F.small_octave_in_shared(42, 229)


# ---------------------------------------------------------------------------
# Dispatch and the bounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wrapper", ["base_image", "small_octave"])
def test_wrappers_reject_bad_input(wrapper):
    fn = getattr(F, wrapper)
    cfg = tsift.SiftConfig()
    with pytest.raises(ValueError, match="unsupported device"):
        fn(torch.empty((1, 20, 24), device="meta"), cfg)
    with pytest.raises(ValueError, match="float32"):
        fn(torch.zeros((1, 20, 24), dtype=torch.float64), cfg)
    with pytest.raises(ValueError, match="float32"):
        fn(torch.zeros((20, 24)), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.zeros((1, 24, 20)).transpose(1, 2), cfg)


def test_base_cost_bench():
    """15 views of 864x1152 a panorama: 3.98 MB read and 15.9 MB written
    each, 298.6 MB, 0.089 ms at 3.35 TB/s; bytes bound it."""
    cfg = tsift.SiftConfig()
    costs = [F.base_cost(n, 864, 1152, cfg) for n in (4, 4, 4, 3)]
    nbytes = sum(c["bytes"] for c in costs)
    assert nbytes == 15 * 4 * (864 * 1152 + 1728 * 2304)
    assert abs(nbytes / 1e6 - 298.6) < 0.1
    assert abs(sum(c["bound_ms"] for c in costs) - 0.0891) < 1e-4
    assert all(c["bound_by"] == "bytes" for c in costs)
    assert costs[0]["flops"] == 4 * (3 * 1728 * 1152 + 3 * 1728 * 2304
                                     + 1728 * 2304 * 2 * 21)
    flat = F.base_cost(1, 864, 1152, tsift.SiftConfig(upscale=False))
    assert flat["bytes"] == 8 * 864 * 1152
    assert flat["flops"] == 864 * 1152 * 2 * 25


def test_small_octave_cost_is_the_octave_stacks():
    cfg = tsift.SiftConfig()
    taps = TG.chain_taps(1.6, 3)
    for h, w in [(27, 36), (14, 18), (7, 9)]:
        assert F.small_octave_cost(4, h, w, cfg) == TG.octave_stack_cost(
            4, h, w, taps)
    c = F.small_octave_cost(4, 27, 36, cfg)
    assert c["bytes"] == 4 * 4 * 27 * 36 * 15
