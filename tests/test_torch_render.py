"""The port's render options held against the JAX package (CPU).

The same scenes (synthetic sweeps with their ground-truth cameras) go
through the JAX render functions and the port's: the mip-sampled warp
(``--warp pallas``) against the Pallas kernel in ``interpret=True``, its
window plan and mip pyramid, the cylindrical projection, the exposure
gains and an uncapped (``--max-resolution`` above 1400) render. The
render options on a registered scene and through the CLI are held in
``test_torch_pipeline.py``.

Tolerances: the mip warp 1e-4 on valid pixels and on the RGB that
invalid pixels carry (the Pallas kernel samples through f32 one-hot
matmuls; multiband blurs invalid pixels' RGB into valid ones), masks
equal; mip levels 1e-6; the exact warp and the dense ops 1e-5 (the JAX
package's bar against OpenCV); the f64 gain solve 1e-9; mosaics of the
same cameras >= 70 dB.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pano360_tpu import geometry as jgeo
from pano360_tpu import render as jrender
from pano360_tpu import synth
from pano360_tpu.ops import pallas_warp as PW
from pano360_tpu.ops import warp as jwarp
from pano360_tpu.register import PanoImage as JPanoImage

from pano360_tpu_torch import convert
from pano360_tpu_torch import geometry as tgeo
from pano360_tpu_torch import render as trender
from pano360_tpu_torch.ops import warp as twarp
from pano360_tpu_torch.ops import warp_kernel as TW
from pano360_tpu_torch.ops import warp_mip as TM

torch.set_num_threads(1)

RNG = np.random.default_rng(4321)


def _t(a):
    return torch.from_numpy(np.array(a))


def _psnr(a, b):
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float(np.mean(d * d))
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _regions(n_views, shape, overlap, seed=5, exposure=None):
    """JAX ``PanoImage``s of a synthetic sweep with its true cameras;
    ``exposure``: optional per-view factors applied before the uint8
    cast."""
    imgs, rots, focal = synth.make_views(n_views=n_views, shape=shape,
                                         overlap=overlap, seed=seed)
    if exposure is not None:
        imgs = [im * a for im, a in zip(imgs, exposure)]
    intr = np.diag([focal, focal, 1.0])
    return [JPanoImage((im * 255).astype(np.uint8), r, intr.copy())
            for im, r in zip(imgs, rots)]


def _jax_layout(regions, max_resolution, projection="spherical",
                blender="multiband"):
    """The JAX render's ranges, layout and RGBA stack for ``regions``."""
    proj = jgeo.PROJECTIONS[projection]
    shape = regions[0].img.shape[:2]
    homs = np.stack([r.hom() for r in regions])
    ranges = np.asarray(jrender.proj_img_range_border(
        shape, jnp.asarray(homs), projection=proj, unwrapped=True),
        np.float64)
    for k, reg in enumerate(regions):
        reg.range = (ranges[0][k], ranges[1][k])
    layout = jrender.plan_layout(regions, ranges, blender, max_resolution,
                                 proj)
    rgba = jrender.add_weights(jnp.asarray(
        np.stack([r.img for r in regions])).astype(jnp.float32) / 255)
    projs = np.stack([r.proj() for r in regions])
    return dict(regions=regions, ranges=ranges, layout=layout,
                rgba=rgba, projs=projs, hw=shape, proj=proj,
                cyl=projection == "cylindrical")


# ---------------------------------------------------------------------------
# The mip-sampled warp (--warp pallas)
# ---------------------------------------------------------------------------

# two views of 300x700 under a 120-px cap (every tile at level 2), and a
# 401-degree sweep of eight 120x320 views on a periodic 400-px canvas
MIP_SCENES = {
    "aperiodic": dict(n_views=2, shape=(300, 700), overlap=0.5,
                      max_resolution=120),
    "periodic": dict(n_views=8, shape=(120, 320), overlap=0.1,
                     max_resolution=400),
}


@pytest.fixture(scope="module", params=sorted(MIP_SCENES))
def mip_scene(request):
    cfg = dict(MIP_SCENES[request.param])
    max_res = cfg.pop("max_resolution")
    sc = _jax_layout(_regions(**cfg), max_res)
    lay = sc["layout"]
    sc["plan"] = PW.plan_windows(
        sc["projs"], lay.bottoms, lay.resolution, lay.im_range[0], sc["hw"],
        lay.ph, lay.pw, period=lay.period)
    sc["name"] = request.param
    return sc


def _mip_args(sc):
    lay = sc["layout"]
    return (np.asarray(sc["projs"], np.float32),
            lay.bottoms.astype(np.float32),
            np.asarray(lay.resolution, np.float32),
            np.asarray(lay.im_range[0], np.float32))


def test_plan_windows_matches_jax(mip_scene):
    lay = mip_scene["layout"]
    ours = TM.plan_windows(mip_scene["projs"], lay.bottoms, lay.resolution,
                           lay.im_range[0], mip_scene["hw"], lay.ph, lay.pw,
                           period=lay.period)
    theirs = mip_scene["plan"]
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[1:] == theirs[1:]
    assert ours[1] and ours[4] >= 2, "the scene must plan mip levels"
    assert (lay.period is not None) == (mip_scene["name"] == "periodic")


def test_build_mips_matches_jax(mip_scene):
    _, _, wy, wx, nl = mip_scene["plan"]
    rgba = mip_scene["rgba"]
    theirs = PW.build_mips(jnp.moveaxis(rgba, -1, 1), nl, wy, wx)
    ours = TM.build_mips(_t(rgba), nl, wy, wx)
    assert len(ours) == len(theirs) == nl
    for a, b in zip(ours, theirs):
        b = np.moveaxis(np.asarray(b), 1, -1)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6)


def test_backward_warp_mip_ref_matches_pallas_interpret(mip_scene):
    lay = mip_scene["layout"]
    origins, _, wy, wx, nl = mip_scene["plan"]
    projs, bottoms, res, rmin = _mip_args(mip_scene)
    mips = PW.build_mips(jnp.moveaxis(mip_scene["rgba"], -1, 1), nl, wy, wx)
    pp, pi = PW.pallas_backward_warp(
        mips, jnp.asarray(projs), jnp.asarray(lay.bottoms), jnp.asarray(res),
        jnp.asarray(rmin), jnp.asarray(origins), lay.ph, lay.pw, wy, wx,
        img_shape=mip_scene["hw"], interpret=True, period=lay.period)
    tmips = TM.build_mips(_t(mip_scene["rgba"]), nl, wy, wx)
    tp, ti = TM.backward_warp_mip_ref(
        tmips, _t(projs), _t(bottoms), _t(res), _t(rmin), origins, lay.ph,
        lay.pw, wy, wx, mip_scene["hw"], period=lay.period)
    pi, pp = np.asarray(pi), np.asarray(pp)
    np.testing.assert_array_equal(ti.numpy(), pi)
    assert (~pi).sum() > 500
    np.testing.assert_allclose(tp.numpy()[~pi], pp[~pi], atol=1e-4)
    # invalid pixels: the window-clamped taps' RGB, alpha zero
    np.testing.assert_allclose(tp.numpy()[pi][:, :3], pp[pi][:, :3],
                               atol=1e-4)
    assert (tp.numpy()[pi][:, 3] == 0).all()


def test_backward_warp_mip_cost_counts_level_taps(mip_scene):
    """The bound's bytes for the mip warp: the distinct window-clamped
    level texels (counted here in numpy) read once, RGBA and mask
    written; at these plans far fewer than four per output pixel."""
    lay = mip_scene["layout"]
    origins, _, wy, wx, nl = mip_scene["plan"]
    args = tuple(_t(a) for a in _mip_args(mip_scene))
    mips = TM.build_mips(_t(mip_scene["rgba"]), nl, wy, wx)
    call = (mips, *args, origins, lay.ph, lay.pw)
    cost = TM.backward_warp_mip_cost(*call, wy, wx, mip_scene["hw"],
                                     period=lay.period)
    x, y, lvl, oy, ox, _ = TM.mip_sample_points(*call, mip_scene["hw"],
                                                period=lay.period)

    def taps(c, o, win):
        c = np.clip(np.nan_to_num(c.numpy() - o.numpy()), -2.0 ** 24,
                    2.0 ** 24)
        c0 = np.clip(np.floor(c).astype(np.int64), 0, win - 2) + o.numpy()
        return c0, c0 + 1

    k = np.broadcast_to(np.arange(len(mips[0]))[:, None, None], x.shape)
    lv = lvl.numpy()
    texels = {(kk, ll, iy, ix) for yy in taps(y, oy, wy)
              for xx in taps(x, ox, wx)
              for kk, ll, iy, ix in zip(k.ravel(), lv.ravel(), yy.ravel(),
                                        xx.ravel())}
    n_px = len(mips[0]) * lay.ph * lay.pw
    assert cost["bytes"] == 16 * len(texels) + 17 * n_px
    assert len(texels) < 4 * n_px
    assert cost["bound_by"] == "bytes"


def test_backward_warp_mip_folds_true_windows(mip_scene):
    """``wins`` invalidates pixels outside each region's true window and
    zeroes their alpha, as ``render._mask_and_blend`` does after the
    Pallas kernel; nothing else changes."""
    lay = mip_scene["layout"]
    origins, _, wy, wx, nl = mip_scene["plan"]
    args = [_t(a) for a in _mip_args(mip_scene)]
    mips = TM.build_mips(_t(mip_scene["rgba"]), nl, wy, wx)
    kw = dict(period=lay.period)
    bare_p, bare_i = TM.backward_warp_mip(mips, *args, origins, lay.ph, lay.pw,
                                         wy, wx, mip_scene["hw"], **kw)
    wins = _t(lay.wins.astype(np.float32))
    p, i = TM.backward_warp_mip(mips, *args, origins, lay.ph, lay.pw, wy,
                                wx, mip_scene["hw"], wins=wins, **kw)
    py = _t(lay.bottoms[:, 1, None, None] + np.arange(lay.ph)[:, None])
    px = _t(lay.bottoms[:, 0, None, None] + np.arange(lay.pw)[None, :])
    w = wins[:, :, None, None]
    outside = (px < w[:, 0]) | (py < w[:, 1]) | (px >= w[:, 2]) | \
        (py >= w[:, 3])
    assert torch.equal(i, bare_i | outside)
    assert torch.equal(p[..., :3], bare_p[..., :3])
    assert torch.equal(p[..., 3], bare_p[..., 3] * ~i)


def _jax_mip_mosaic(sc, blender="multiband"):
    """The JAX render of the forced mip path, composed by hand: on the
    CPU ``render.stitch`` takes the XLA gather whatever ``use_pallas``."""
    lay = sc["layout"]
    projs, _, res, rmin = _mip_args(sc)
    origins, ok, wy, wx, nl = PW.plan_windows(
        sc["projs"], lay.bottoms, lay.resolution, lay.im_range[0], sc["hw"],
        lay.ph, lay.pw, period=lay.period, cylindrical=sc["cyl"])
    assert ok and nl >= 2
    mips = PW.build_mips(jnp.moveaxis(sc["rgba"], -1, 1), nl, wy, wx)
    patches, invalid = PW.pallas_backward_warp(
        mips, jnp.asarray(projs), jnp.asarray(lay.bottoms, jnp.int32),
        jnp.asarray(res), jnp.asarray(rmin), jnp.asarray(origins), lay.ph,
        lay.pw, wy, wx, img_shape=sc["hw"], period=lay.period,
        cylindrical=sc["cyl"], interpret=True)
    mosaic, _ = jrender._mask_and_blend(
        patches, invalid, jnp.asarray(lay.bottoms, jnp.int32),
        jnp.asarray(lay.wins, jnp.float32), lay.shape, blender,
        period=lay.period)
    out_h, out_w = lay.out_hw
    return np.asarray(mosaic)[:out_h, :out_w]


def test_stitch_warp_pallas_matches_jax_composed(mip_scene):
    """The whole mip render: the port's ``stitch(warp="pallas")`` against
    plan_windows + build_mips + the Pallas kernel + _mask_and_blend."""
    theirs = _jax_mip_mosaic(mip_scene)
    max_res = MIP_SCENES[mip_scene["name"]]["max_resolution"]
    ours = trender.stitch(convert.regions_from_jax(mip_scene["regions"]),
                          max_resolution=max_res, warp="pallas",
                          device="cpu")
    assert ours.shape == theirs.shape
    assert _psnr(ours, theirs) >= 70.0


def test_warp_pallas_unplannable_takes_exact_path(monkeypatch, caplog):
    """A plan whose window exceeds the caps (``ok`` False): the JAX
    policy, a warning and the exact warp."""
    regions = _regions(2, (300, 700), 0.5)
    exact = trender.stitch(convert.regions_from_jax(regions),
                           max_resolution=120, device="cpu")

    def refused(*args, **kwargs):
        origins, _, wy, wx, nl = TM.plan_windows(*args, **kwargs)
        return origins, False, wy, wx, nl

    monkeypatch.setattr(trender, "plan_windows", refused)
    ours = trender.stitch(convert.regions_from_jax(regions),
                          max_resolution=120, warp="pallas", device="cpu")
    assert "using the exact warp" in caplog.text
    np.testing.assert_array_equal(ours, exact)


def test_stitch_rejects_unknown_warp_policy():
    regions = convert.regions_from_jax(_regions(2, (60, 80), 0.5))
    with pytest.raises(ValueError, match="warp must be one of"):
        trender.stitch(regions, warp="gather", device="cpu")


# ---------------------------------------------------------------------------
# The cylindrical projection
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cyl_scene():
    return _jax_layout(_regions(3, (120, 160), 0.5), 4000, "cylindrical")


def test_cylindrical_extents_and_layout_match_jax(cyl_scene):
    regions = convert.regions_from_jax(cyl_scene["regions"])
    homs = torch.as_tensor(np.stack([r.hom() for r in regions]),
                           dtype=torch.float32)
    ranges = trender.proj_img_range_border(cyl_scene["hw"], homs,
                                           tgeo.CylProj).numpy()
    np.testing.assert_allclose(ranges, cyl_scene["ranges"], atol=1e-6)
    for k, reg in enumerate(regions):
        reg.range = cyl_scene["regions"][k].range
    ours = trender.plan_layout(regions, cyl_scene["ranges"], "multiband",
                               4000, tgeo.CylProj)
    theirs = cyl_scene["layout"]
    for a, b in zip(ours, theirs):
        if isinstance(b, tuple) and isinstance(b[0], np.ndarray):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)


def test_backward_warp_ref_cylindrical_matches_jax_gather(cyl_scene):
    lay = cyl_scene["layout"]
    projs, bottoms, res, rmin = _mip_args(cyl_scene)
    wins = lay.wins.astype(np.float32)
    jp, ji = jrender.backward_warp_all(
        cyl_scene["rgba"], jnp.asarray(projs), jnp.asarray(lay.bottoms),
        jnp.asarray(res), jnp.asarray(rmin), lay.ph, lay.pw,
        projection=jgeo.CylProj, wins=jnp.asarray(wins), period=lay.period)
    tp, ti = TW.backward_warp_ref(_t(cyl_scene["rgba"]), _t(projs),
                                  _t(bottoms), _t(res), _t(rmin), lay.ph,
                                  lay.pw, wins=_t(wins), period=lay.period,
                                  cylindrical=True)
    ji = np.asarray(ji)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert (~ji).sum() > 1000
    np.testing.assert_allclose(tp.numpy()[~ji], np.asarray(jp)[~ji],
                               atol=1e-5)


def test_cylindrical_stitch_matches_jax(cyl_scene):
    regions = cyl_scene["regions"]
    theirs = jrender.stitch(regions, projection="cylindrical",
                            max_resolution=4000)
    ours = trender.stitch(convert.regions_from_jax(regions),
                          projection="cylindrical", max_resolution=4000,
                          device="cpu")
    assert ours.shape == theirs.shape
    assert _psnr(ours, theirs) >= 70.0


# ---------------------------------------------------------------------------
# Exposure gains (-e)
# ---------------------------------------------------------------------------

def test_warp_perspective_constant_border_matches_jax():
    img = RNG.random((37, 45, 4), np.float32)
    hom = np.array([[0.9, 0.12, 6.0], [-0.08, 1.1, -4.0],
                    [4e-4, -3e-4, 1.0]], np.float32)
    ref = np.asarray(jwarp.warp_perspective(jnp.asarray(img),
                                            jnp.asarray(hom), (41, 50),
                                            border="constant", cval=0.25))
    out = twarp.warp_perspective(_t(img), _t(hom), (41, 50),
                                 border="constant", cval=0.25).numpy()
    assert (out == 0.25).all(axis=-1).sum() > 50       # constant fill
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.fixture(scope="module")
def gain_scene():
    """Three views at exposures 1.0, 0.8 and 0.9."""
    regions = _regions(3, (120, 160), 0.5, exposure=[1.0, 0.8, 0.9])
    sc = _jax_layout(regions, 4000)
    return sc


def test_overlap_matrices_match_jax(gain_scene):
    ov_j, sz_j = jrender.overlap_matrices(gain_scene["regions"],
                                          gain_scene["rgba"])
    ov_t, sz_t = trender.overlap_matrices(
        convert.regions_from_jax(gain_scene["regions"]),
        _t(gain_scene["rgba"]))
    assert (sz_j > 0).sum() >= 4
    np.testing.assert_allclose(ov_t, ov_j, atol=1e-5)
    np.testing.assert_allclose(sz_t, sz_j, rtol=1e-5)


def test_find_gains_matches_jax():
    n = 5
    sizes = RNG.integers(0, 5000, (n, n)).astype(np.float64)
    sizes = np.triu(sizes, 1) + np.triu(sizes, 1).T
    overlaps = RNG.uniform(0.2, 0.8, (n, n)) * (sizes > 0)
    np.testing.assert_allclose(trender.find_gains(overlaps, sizes),
                               jrender.find_gains(overlaps, sizes),
                               rtol=0, atol=1e-9)


def test_estimate_gains_recover_exposures(gain_scene):
    """The gains undo the per-view exposure: g_i a_i / (g_j a_j) near 1
    for the overlapping pairs, as the JAX package's gains do."""
    a = np.array([1.0, 0.8, 0.9])
    ours = trender.estimate_gains(
        convert.regions_from_jax(gain_scene["regions"]),
        _t(gain_scene["rgba"]))
    theirs = jrender.estimate_gains(gain_scene["regions"],
                                    gain_scene["rgba"])
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)
    ratios = [ours[i] * a[i] / (ours[i + 1] * a[i + 1]) for i in range(2)]
    assert np.abs(np.log(ratios)).max() < 0.05, ratios


def test_equalize_stitch_matches_jax(gain_scene):
    regions = gain_scene["regions"]
    theirs = jrender.stitch(regions, equalize=True)
    ours = trender.stitch(convert.regions_from_jax(regions), equalize=True,
                          device="cpu")
    assert ours.shape == theirs.shape
    assert _psnr(ours, theirs) >= 70.0


# ---------------------------------------------------------------------------
# --max-resolution above 1400
# ---------------------------------------------------------------------------

def test_uncapped_stitch_matches_jax():
    """A 401-degree sweep of eight 120x320 views: uncapped, the periodic
    canvas is about 2100 px wide.

    The two packages' f32 ``atan2`` differ by an ulp, so the border
    ranges, and with them the warp's angles, differ by ~2e-7 rad; on
    some sweeps that flips one boundary pixel of the mosaic (seeds 2 and
    5 of 1-7, ~60 dB), so the scene is one that flips none."""
    regions = _regions(8, (120, 320), 0.1, seed=1)
    theirs = jrender.stitch(regions, max_resolution=4000)
    ours = trender.stitch(convert.regions_from_jax(regions),
                          max_resolution=4000, device="cpu")
    assert ours.shape == theirs.shape
    assert ours.shape[1] > 1400
    assert _psnr(ours, theirs) >= 70.0
