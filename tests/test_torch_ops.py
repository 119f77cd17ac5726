"""The PyTorch port's operators and kernels held against the JAX package.

The same inputs, made from a numpy seed, go through each JAX function
(on the CPU; Pallas kernels in ``interpret=True``) and its port; the
port runs its plain PyTorch versions here (the CUDA kernels themselves
are tested in ``test_torch_kernels.py``).

Tolerances: dense f32 operators 1e-5 (the JAX package's bar against
OpenCV); the octave stack's plain version vs the Pallas kernel 1e-6
(same taps and accumulation order, horizontal pass a matmul there);
geometry in float64 to 1e-9.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pano360_tpu import geometry as jgeo
from pano360_tpu import render as jrender
from pano360_tpu import synth
from pano360_tpu.features import sift as jsift
from pano360_tpu.ops import filters as jfilters
from pano360_tpu.ops import pallas_gauss as PG
from pano360_tpu.ops import pallas_warp as PW
from pano360_tpu.ops import resize as jresize
from pano360_tpu.ops import warp as jwarp
from pano360_tpu.ops.color import add_alpha as jadd_alpha
from pano360_tpu.ops.color import bgr2gray as jbgr2gray
from pano360_tpu.register import PanoImage as JPanoImage

from pano360_tpu_torch import cli as tcli
from pano360_tpu_torch import geometry as tgeo
from pano360_tpu_torch.features import sift as tsift
from pano360_tpu_torch.ops import filters as tfilters
from pano360_tpu_torch.ops import gauss_octave as TG
from pano360_tpu_torch.ops import resize as tresize
from pano360_tpu_torch.ops import warp as twarp
from pano360_tpu_torch.ops import warp_kernel as TW
from pano360_tpu_torch.ops.color import add_alpha as tadd_alpha
from pano360_tpu_torch.ops.color import bgr2gray as tbgr2gray

torch.set_num_threads(1)

DENSE_TOL = 1e-5
RNG = np.random.default_rng(1234)
ROOT = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Dense operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,sigma,ksize", [
    ((2, 40, 56, 3), 1.6, None),
    ((30, 44, 4), 4.0, None),
    ((2, 9, 7, 1), 2.0, 27),          # pad wider than the image
])
def test_gaussian_blur_matches_jax(shape, sigma, ksize):
    x = RNG.random(shape, np.float32)
    ref = np.asarray(jfilters.gaussian_blur(jnp.asarray(x), sigma, ksize))
    out = tfilters.gaussian_blur(_t(x), sigma, ksize).numpy()
    np.testing.assert_allclose(out, ref, atol=DENSE_TOL)


def test_sep_filter2d_matches_jax():
    img = RNG.random((33, 41, 2), np.float32)
    kx, ky = RNG.random(5, np.float32), RNG.random(7, np.float32)
    ref = np.asarray(jfilters.sep_filter2d(jnp.asarray(img), kx, ky))
    np.testing.assert_allclose(tfilters.sep_filter2d(_t(img), kx, ky).numpy(),
                               ref, atol=DENSE_TOL)


def test_resize_and_upsample_match_jax():
    img = RNG.random((37, 53, 3), np.float32) * 255
    ref = np.asarray(jresize.resize_bilinear(jnp.asarray(img), (19, 26)))
    out = tresize.resize_bilinear(_t(img), (19, 26)).numpy()
    np.testing.assert_allclose(out, ref, atol=DENSE_TOL * 255)
    g = RNG.random((2, 21, 17), np.float32)
    ref = np.asarray(jresize.upsample2x_bilinear(jnp.asarray(g)))
    out = tresize.upsample2x_bilinear(_t(g)).numpy()
    np.testing.assert_allclose(out, ref, atol=DENSE_TOL)


def test_shrink_area_matches_jax():
    for shape, factor in (((37, 53, 3), 2), ((37, 53), 3), ((36, 48, 4), 4)):
        img = RNG.random(shape, np.float32) * 255
        ref = np.asarray(jresize.shrink_area(jnp.asarray(img), factor))
        out = tresize.shrink_area(_t(img), factor).numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=DENSE_TOL * 255)


def test_add_alpha_matches_jax():
    img = RNG.random((2, 20, 30, 3), np.float32)
    alpha = RNG.random((2, 20, 30), np.float32)
    for a in (None, alpha):
        ref = np.asarray(jadd_alpha(jnp.asarray(img),
                                    None if a is None else jnp.asarray(a)))
        out = tadd_alpha(_t(img), None if a is None else _t(a)).numpy()
        np.testing.assert_array_equal(out, ref)


def test_bgr2gray_matches_jax():
    img = RNG.random((3, 20, 30, 3), np.float32)
    np.testing.assert_allclose(tbgr2gray(_t(img)).numpy(),
                               np.asarray(jbgr2gray(jnp.asarray(img))),
                               atol=DENSE_TOL)


@pytest.mark.parametrize("border", ["reflect", "reflect101", "replicate",
                                    "constant"])
def test_remap_bilinear_matches_jax(border):
    img = RNG.random((23, 31, 4), np.float32)
    mx = (RNG.random((40, 50)) * 60 - 15).astype(np.float32)
    my = (RNG.random((40, 50)) * 50 - 12).astype(np.float32)
    ref = np.asarray(jwarp.remap_bilinear(jnp.asarray(img), jnp.asarray(mx),
                                          jnp.asarray(my), border=border,
                                          cval=0.5))
    out = twarp.remap_bilinear(_t(img), _t(mx), _t(my), border,
                               cval=0.5).numpy()
    np.testing.assert_allclose(out, ref, atol=DENSE_TOL)


# ---------------------------------------------------------------------------
# Geometry (float64 on both sides)
# ---------------------------------------------------------------------------

def test_so3_and_camera_math_match_jax():
    rad = RNG.normal(0, 0.7, (6, 3))
    rad[0] = 0.0
    np.testing.assert_allclose(tgeo.exp_so3(_t(rad)).numpy(),
                               np.asarray(jgeo.exp_so3(jnp.asarray(rad))),
                               atol=1e-9)
    rots = np.asarray(jgeo.exp_so3(jnp.asarray(rad)))
    np.testing.assert_allclose(tgeo.log_so3(_t(rots)).numpy(),
                               np.asarray(jgeo.log_so3(jnp.asarray(rots))),
                               atol=1e-9)
    params = np.concatenate([RNG.uniform(200, 400, (6, 1)),
                             np.zeros((6, 2)), rad], axis=1)
    tc = tgeo.params_to_camera(_t(params))
    jc = jgeo.params_to_camera(jnp.asarray(params))
    np.testing.assert_allclose(tc.hom().numpy(), np.asarray(jc.hom()),
                               atol=1e-9)
    np.testing.assert_allclose(tgeo.camera_to_params(tc).numpy(),
                               np.asarray(jgeo.camera_to_params(jc)),
                               atol=1e-9)
    m = RNG.normal(size=(5, 3, 3))
    np.testing.assert_allclose(tgeo.inv3x3(_t(m)).numpy(),
                               np.linalg.inv(m), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("scale", [0.0, 1e-7, 1e-3, 0.05, 0.8])
def test_edge_hom_jacobian_matches_autodiff(scale):
    """The analytic dH/dp of the bundle adjuster equals forward-mode AD
    of the same homography (float64, 1e-9 relative), on both sides of
    the small-angle branches."""
    from torch.func import jacfwd, vmap
    from pano360_tpu_torch import register as treg
    rad = RNG.normal(size=(2, 4, 3)) * scale
    foc = RNG.uniform(200, 400, (2, 4, 1))
    pp = RNG.normal(size=(2, 4, 2))
    pa, pb = (_t(np.concatenate([foc[i], pp[i], rad[i]], axis=1))
              for i in range(2))
    ja, jb = treg._edge_hom_jac(pa, pb)
    ra, rb = vmap(jacfwd(treg._edge_hom, argnums=(0, 1)))(pa, pb)
    for ours, ref in ((ja, ra), (jb, rb)):
        ref = ref.reshape(4, 9, 6)
        err = float((ours - ref).abs().max() / ref.abs().max())
        assert err <= 1e-9, err


def test_focal_and_straighten_match_jax():
    _, rots, focal = synth.make_views(n_views=4, shape=(60, 80), seed=3)
    k = np.diag([focal, focal, 1.0])
    homs = np.stack([k @ rots[i] @ rots[i + 1].T @ np.linalg.inv(k)
                     for i in range(3)])
    np.testing.assert_allclose(
        tgeo.focal_from_hom(_t(homs)).numpy(),
        np.asarray(jgeo.focal_from_hom(jnp.asarray(homs))), rtol=1e-9)
    np.testing.assert_allclose(
        tgeo.straighten(_t(rots)).numpy(),
        np.asarray(jgeo.straighten(jnp.asarray(rots))), atol=1e-9)


# ---------------------------------------------------------------------------
# Kernel 1: the octave stack
# ---------------------------------------------------------------------------

TAPS = TG.chain_taps(1.6, 3)
SCORE_CFG = (0.5 * 0.04 / 3, 10.0, 5)


@pytest.fixture(scope="module")
def octave_base():
    """A 2x256x256 SIFT base image (upscaled + blurred synthetic view)."""
    imgs, _, _ = synth.make_views(n_views=2, shape=(128, 128), seed=5)
    gray = np.stack([np.asarray(jbgr2gray(jnp.asarray(im))) for im in imgs])
    return np.asarray(jsift._base_image(jnp.asarray(gray, jnp.float32),
                                        jsift.SiftConfig()), np.float32)


@pytest.fixture(scope="module")
def octave_interpret(octave_base):
    outs = PG.octave_stack(jnp.asarray(octave_base), PG.chain_taps(1.6, 3),
                           score_cfg=SCORE_CFG, interpret=True)
    return [np.asarray(o) for o in outs]


def test_chain_taps_match_jax():
    assert TAPS == PG.chain_taps(1.6, 3)
    assert TG.chain_halo(TAPS) == PG.chain_halo(PG.chain_taps(1.6, 3)) == 42
    assert [len(t) for t in TAPS] == [11, 13, 17, 21, 27]


def test_octave_stack_ref_matches_pallas_interpret(octave_base,
                                                   octave_interpret):
    g, d, sc = TG.octave_stack_ref(_t(octave_base), TAPS, SCORE_CFG)
    jg, jd, jsc = octave_interpret
    np.testing.assert_allclose(g.numpy(), jg, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), jd, atol=1e-6)
    # candidate sets equal: same nonzero score pattern
    np.testing.assert_array_equal(sc.numpy() > 0, jsc > 0)
    np.testing.assert_allclose(sc.numpy(), jsc, atol=1e-6)


def test_octave_stack_ref_matches_incremental_chain(octave_base):
    """Reflect-once + chain equals the per-layer reflected chain (the
    JAX CPU path) to f32 rounding: a symmetric blur of a reflect101
    extension stays reflect101."""
    g, d = TG.octave_stack_ref(_t(octave_base), TAPS)
    cfg = jsift.SiftConfig(gauss_mode="incremental")
    inc = np.asarray(jsift._gaussian_stack(jnp.asarray(octave_base), cfg))
    np.testing.assert_allclose(g.numpy(), inc, atol=3e-7)
    np.testing.assert_allclose(d.numpy(), inc[:, 1:] - inc[:, :-1],
                               atol=6e-7)


def test_extrema_score_matches_jax_dense_path(octave_base):
    """The plain score equals _octave_candidates' dense score: the top
    candidates of both are the same (exact top-k on the CPU)."""
    _, d = TG.octave_stack_ref(_t(octave_base), TAPS)
    sc = TG._extrema_score(d, *SCORE_CFG)
    cfg = jsift.SiftConfig(cand_topk="exact")
    lay, y, x, ok = (np.asarray(a) for a in jsift._octave_candidates(
        jnp.asarray(d.numpy()), cfg, 512))
    tl, ty, tx, tok = tsift._octave_candidates(d, tsift.SiftConfig(), 512,
                                               sc)
    jset = set(zip(lay[0][ok[0]], y[0][ok[0]], x[0][ok[0]]))
    tset = set(zip(*(a[0][tok[0]].tolist() for a in (tl, ty, tx))))
    assert jset == tset and len(jset) > 50


BENCH_OCTAVES = [(1728 >> o, 2304 >> o) for o in range(6)]


def test_octave_stack_cost_matches_hand_count():
    """A batch of 4 over octaves 0-5 of a 1728x2304 base: 21.2 Mpx read
    once and 14 f32 planes written, 1.274 GB, 0.380 ms at 3.35 TB/s; the
    178 taps per pixel (a multiply and an add each) bound it less."""
    costs = [TG.octave_stack_cost(4, h, w, TAPS) for h, w in BENCH_OCTAVES]
    px = 4 * sum(h * w for h, w in BENCH_OCTAVES)
    nbytes = sum(c["bytes"] for c in costs)
    assert nbytes == 4 * 15 * px
    assert abs(nbytes / 1e9 - 1.274) < 5e-4
    assert abs(sum(c["bound_ms"] for c in costs) - 0.380) < 5e-4
    assert all(c["bound_by"] == "bytes" for c in costs)
    assert costs[0]["flops"] == 4 * 1728 * 2304 * (
        2 * 178 + 5 + 3 * TG.SCORE_OPS)
    assert sum(c["flops_ms"] for c in costs) < 0.2
    no_score = TG.octave_stack_cost(4, 1728, 2304, TAPS, score=False)
    assert no_score["bytes"] == 4 * 12 * 4 * 1728 * 2304


def test_kernel_tile_and_taps_per_pixel():
    """The kernel's tile per launch (its issue model: 80x96 on the
    largest octaves, smaller tiles on more SMs for the small ones), its
    overdraw counted from the loop bounds (389.3 taps per pixel on whole
    80x96 tiles, 396.5 at octave 0, 412 over the bench octaves, against
    687 for the first version's 32x64 tile), and a tile for every chain
    the wrapper admits."""
    tiles = [TG.kernel_tile(TAPS, 4, h, w) for h, w in BENCH_OCTAVES]
    assert [t[:2] for t in tiles] == [(80, 96), (80, 96), (40, 96),
                                      (24, 96), (24, 32), (8, 32)]
    assert tiles[0][2] == 229664 and all(t[2] <= 232448 for t in tiles)
    assert TG.kernel_taps_per_px(4, 1680, 2304, TAPS) == pytest.approx(
        389.3, abs=0.05)
    assert TG.kernel_taps_per_px(4, 1728, 2304, TAPS) == pytest.approx(
        396.5, abs=0.05)
    px = sum(h * w for h, w in BENCH_OCTAVES)
    per_px = sum(TG.kernel_taps_per_px(4, h, w, TAPS) * h * w
                 for h, w in BENCH_OCTAVES) / px
    assert 405 < per_px < 420
    for n_layers, sigma in ((4, 2.0), (5, 2.0), (6, 2.0), (3, 3.0)):
        assert TG.kernel_tile(TG.chain_taps(sigma, n_layers), 1, 300,
                              400) is not None


# ---------------------------------------------------------------------------
# Kernel 2: the backward warp
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def warp_scene():
    """Two registered views, their RGBA stack and a level-0 layout."""
    shape = (120, 160)
    imgs, rots, focal = synth.make_views(n_views=2, shape=shape,
                                         overlap=0.5, seed=5)
    intr = np.diag([focal, focal, 1.0])
    regions = [JPanoImage((im * 255).astype(np.uint8), r, intr.copy())
               for im, r in zip(imgs, rots)]
    homs = np.stack([r.hom() for r in regions])
    ranges = np.asarray(jrender.proj_img_range_border(
        shape, jnp.asarray(homs), unwrapped=True), np.float64)
    for k, reg in enumerate(regions):
        reg.range = (ranges[0][k], ranges[1][k])
    layout = jrender.plan_layout(regions, ranges, "multiband", 4000)
    rgba = np.asarray(jrender.add_weights(jnp.asarray(
        np.stack([r.img for r in regions])).astype(jnp.float32) / 255))
    projs = np.stack([r.proj() for r in regions]).astype(np.float32)
    return regions, rgba, projs, layout, shape


def _warp_args(layout):
    return (layout.bottoms.astype(np.float32),
            np.asarray(layout.resolution, np.float32),
            np.asarray(layout.im_range[0], np.float32))


def test_backward_warp_ref_matches_jax_gather(warp_scene):
    _, rgba, projs, lay, _ = warp_scene
    bottoms, res, rmin = _warp_args(lay)
    wins = lay.wins.astype(np.float32)
    jp, ji = jrender.backward_warp_all(
        jnp.asarray(rgba), jnp.asarray(projs), jnp.asarray(lay.bottoms),
        jnp.asarray(res), jnp.asarray(rmin), lay.ph, lay.pw,
        wins=jnp.asarray(wins), period=lay.period)
    tp, ti = TW.backward_warp_ref(_t(rgba), _t(projs), _t(bottoms), _t(res),
                                  _t(rmin), lay.ph, lay.pw, wins=_t(wins),
                                  period=lay.period)
    ji = np.asarray(ji)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert (~ji).sum() > 1000
    np.testing.assert_allclose(tp.numpy()[~ji], np.asarray(jp)[~ji],
                               atol=DENSE_TOL)
    assert (tp.numpy()[ji][:, 3] == 0).all()


def test_backward_warp_cost_counts_distinct_taps(warp_scene):
    """The bound's bytes: every distinct source texel the bilinear taps
    touch (counted here in numpy) read once, RGBA and mask written."""
    _, rgba, projs, lay, (h, w) = warp_scene
    bottoms, res, rmin = _warp_args(lay)
    args = (_t(projs), _t(bottoms), _t(res), _t(rmin), lay.ph, lay.pw)
    kw = dict(wins=_t(lay.wins.astype(np.float32)), period=lay.period)
    cost = TW.backward_warp_cost(_t(rgba), *args, **kw)
    x, y, _ = TW.sample_points((h, w), *args, **kw)

    def taps(c, n):
        c = np.clip(np.nan_to_num(c.numpy(), nan=0.0, posinf=4.0 * n,
                                  neginf=-4.0 * n), -4.0 * n, 4.0 * n)
        c0 = np.floor(c).astype(np.int64)
        out = []
        for i in (c0, c0 + 1):
            m = np.mod(i, 2 * n)
            out.append(np.where(m < n, m, 2 * n - 1 - m))
        return out

    k = np.broadcast_to(np.arange(len(rgba))[:, None, None], x.shape)
    texels = {(kk, iy, ix) for yy in taps(y, h) for xx in taps(x, w)
              for kk, iy, ix in zip(k.ravel(), yy.ravel(), xx.ravel())}
    n_px = len(rgba) * lay.ph * lay.pw
    assert cost["bytes"] == 16 * len(texels) + 17 * n_px
    assert cost["flops"] == TW.OPS_PER_PX * n_px
    assert cost["bound_by"] == "bytes"
    assert cost["bound_ms"] == pytest.approx(cost["bytes"] / 3.35e9)


def test_backward_warp_ref_matches_pallas_level0_interpret(warp_scene):
    regions, rgba, projs, lay, hw = warp_scene
    bottoms, res, rmin = _warp_args(lay)
    origins, ok, wy, wx, nl = PW.plan_windows(
        projs, lay.bottoms, res, rmin, hw, lay.ph, lay.pw, period=lay.period)
    assert ok and nl == 1, "the scene must plan at mip level 0"
    mips = PW.build_mips(jnp.moveaxis(jnp.asarray(rgba), -1, 1), nl, wy, wx)
    pp, pi = PW.pallas_backward_warp(
        mips, jnp.asarray(projs), jnp.asarray(lay.bottoms), jnp.asarray(res),
        jnp.asarray(rmin), jnp.asarray(origins), lay.ph, lay.pw, wy, wx,
        img_shape=hw, interpret=True, period=lay.period)
    tp, ti = TW.backward_warp_ref(_t(rgba), _t(projs), _t(bottoms), _t(res),
                                  _t(rmin), lay.ph, lay.pw,
                                  period=lay.period)
    pi = np.asarray(pi)
    np.testing.assert_array_equal(ti.numpy(), pi)
    # the Pallas kernel samples through f32 one-hot matmuls
    np.testing.assert_allclose(tp.numpy()[~pi], np.asarray(pp)[~pi],
                               atol=1e-4)


# ---------------------------------------------------------------------------
# Package boundaries
# ---------------------------------------------------------------------------

def test_port_imports_no_jax():
    """Neither by module name nor by file path: after importing the
    port's entry points and host modules and building the native
    library, no loaded module is jax or lies under ``pano360_tpu/``."""
    code = ("import sys\n"
            "from pathlib import Path\n"
            "import numpy as np\n"
            "import pano360_tpu_torch, pano360_tpu_torch.cli\n"
            "import pano360_tpu_torch.convert, pano360_tpu_torch._kernels\n"
            "from pano360_tpu_torch import native, profiling, render, synth\n"
            "from pano360_tpu_torch import blend_extra, features_cli, viz\n"
            "from pano360_tpu_torch import measure\n"
            "from pano360_tpu_torch.features import msop\n"
            "import pano360_tpu_torch.parallel\n"
            "from pano360_tpu_torch.parallel import dryrun, mesh\n"
            "assert native.largest_rectangle(np.ones((4, 5))) == (0, 0, 3, 4)\n"
            "assert len(msop.ssc(np.zeros((9, 2), np.float32), (8, 8), 4))\n"
            "assert native.seam_flood(np.ones((6, 9), np.float32), 2).any()\n"
            "bad = [m for m in sys.modules if m in ('jax', 'pano360_tpu') "
            "or m.startswith(('jax.', 'pano360_tpu.'))]\n"
            "assert not bad, bad\n"
            "ref = Path('pano360_tpu').resolve()\n"
            "files = [Path(getattr(m, '__file__', None) or '/').resolve() "
            "for m in list(sys.modules.values())]\n"
            "inside = [str(f) for f in files if ref in f.parents]\n"
            "assert not inside, inside\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(ROOT))


def test_port_synth_equals_jax_synth():
    from pano360_tpu_torch import synth as tsynth
    a_imgs, a_rots, a_focal = tsynth.make_views(n_views=3, shape=(48, 64),
                                                overlap=0.4, seed=11)
    b_imgs, b_rots, b_focal = synth.make_views(n_views=3, shape=(48, 64),
                                               overlap=0.4, seed=11)
    assert a_focal == b_focal
    assert a_rots.tobytes() == b_rots.tobytes()
    for a, b in zip(a_imgs, b_imgs):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _seeded_mask(seed=21, shape=(37, 53)):
    """A random valid mask with a large valid core and ragged borders."""
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) > 0.04
    mask[:rng.integers(2, 6)] = False
    mask[:, -rng.integers(2, 6):] = False
    return mask


@pytest.mark.parametrize("fallback", [False, True])
def test_port_crop_matches_jax(fallback):
    from pano360_tpu import native as jnative
    from pano360_tpu_torch import native as tnative
    mask = _seeded_mask()
    mosaic = np.random.default_rng(3).integers(
        0, 255, mask.shape + (3,), dtype=np.uint8)
    want = jnative.largest_rectangle(mask)
    assert want[2] > want[0] and want[3] > want[1]
    if fallback:
        assert tnative._largest_rectangle_py(mask.astype(np.uint8)) == want
        return
    assert tnative.largest_rectangle(mask) == want
    np.testing.assert_array_equal(tnative.crop_mosaic(mosaic, mask),
                                  jnative.crop_mosaic(mosaic, mask))


def test_port_native_builds_under_build_dir():
    from pano360_tpu_torch import native as tnative
    assert tnative._build() is not None
    path = tnative.library_path()
    assert path.exists()
    assert path.parent == ROOT / "build" / "native"
    assert (ROOT / "pano360_tpu") not in path.parents
    assert tnative.SRC.parent == ROOT / "pano360_tpu_torch" / "native"


def test_ba_cache_loader_refuses_jax_pickle(tmp_path):
    import pickle
    reg = JPanoImage(np.zeros((4, 4, 3), np.uint8), np.eye(3), np.eye(3))
    path = tmp_path / "ba_x.pkl"
    path.write_bytes(pickle.dumps([reg]))
    with pytest.raises(pickle.UnpicklingError, match="delete the cache"):
        tcli.load_ba_cache(str(path))


def test_ba_cache_loader_reads_port_pickle(tmp_path):
    import pickle
    from pano360_tpu_torch.register import PanoImage
    reg = PanoImage(np.zeros((4, 4, 3), np.uint8), np.eye(3), np.eye(3))
    path = tmp_path / "ba_y.pkl"
    path.write_bytes(pickle.dumps([reg], protocol=pickle.HIGHEST_PROTOCOL))
    out = tcli.load_ba_cache(str(path))
    assert isinstance(out[0], PanoImage)
    np.testing.assert_array_equal(out[0].rot, np.eye(3))


def test_match_cache_loader_refuses_foreign_classes(tmp_path):
    """A ``matches_*.npz`` whose object arrays name any class but numpy's
    arrays and the builtin containers is refused before it runs."""
    import os
    import pickle

    class Payload:
        def __reduce__(self):
            return (os.system, ("echo loaded",))
    kpts = np.empty(1, dtype=object)
    kpts[0] = Payload()
    path = tmp_path / "matches_x.npz"
    np.savez(path, kpts=kpts, matches=np.array({}, dtype=object))
    with pytest.raises(pickle.UnpicklingError, match="delete the cache"):
        tcli.load_match_cache(str(path))


@pytest.mark.parametrize("kwargs,exc", [
    (dict(gauss_mode="direct"), TypeError),   # one scale space, no knob
    (dict(descr_mode="dense"), None),         # carried: cv2's window
    (dict(descr_mode="grd"), ValueError),
])
def test_sift_config_rejects_unknown_modes(kwargs, exc):
    if exc is None:
        assert tsift.SiftConfig(**kwargs).patch_half == 40
        return
    with pytest.raises(exc):
        tsift.SiftConfig(**kwargs)


def test_sift_config_from_jax():
    from pano360_tpu_torch import convert
    cfg = jsift.SiftConfig(max_kpts=1024, gauss_mode="incremental",
                           patch_dtype="float32", descr_mode="grid")
    assert convert.sift_config_from_jax(cfg) == tsift.SiftConfig(
        max_kpts=1024)
    for bad in (dict(gauss_mode="direct"), dict(patch_dtype="bfloat16")):
        with pytest.raises(ValueError):
            convert.sift_config_from_jax(jsift.SiftConfig(
                **{"patch_dtype": "float32", "descr_mode": "grid", **bad}))
    both = convert.sift_config_from_jax(jsift.SiftConfig(
        patch_dtype="float32", descr_mode="dense", upscale=False))
    assert both == tsift.SiftConfig(descr_mode="dense", upscale=False)
    assert both.patch_half == 40


@pytest.mark.parametrize("flags", [["--detector", "msop"], ["--mesh", "2"]])
def test_cli_flags_off_the_slice_raise(flags, tmp_path):
    """``--detector msop`` runs on one process, ``--mesh 2 --device
    cpu`` on two gloo ranks."""
    args = tcli.build_parser().parse_args([str(tmp_path), "--device", "cpu"]
                                          + flags)
    assert tcli.mesh_ranks(args) == (2 if flags[0] == "--mesh" else 1)


def test_cli_defaults_match_jax():
    from pano360_tpu import cli as jcli
    ours = vars(tcli.build_parser().parse_args(["p"]))
    theirs = vars(jcli.build_parser().parse_args(["p"]))
    ours.pop("device")
    assert ours == theirs


def test_entry_points_refuse_missing_cuda(monkeypatch):
    from pano360_tpu_torch import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
