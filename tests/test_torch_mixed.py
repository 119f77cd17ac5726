"""Mixed image sizes in the port, held against the JAX package (CPU).

The scene is ``tests/test_e2e.py``'s mixed-shape sweep: four views,
alternately 180x240 and 220x200. Both packages batch features per shape
bucket and zero-pad the images into one stack for the render, where each
image's true size drives the border extents, the hat weights, the warp's
centre offset and bounds, and the exposure overlaps.

Tolerances: per-image features of the mixed run equal to those of each
shape run alone; border ranges 1e-6 rad, weights 1e-6, overlap means
1e-5 and overlap sizes equal; ``backward_warp_ref`` with ``shapes``: the
mask equal and valid pixels within 1e-5 for >= 99.99 % and 1e-4 for all
against ``render.backward_warp_all(shapes=...)`` (the last bit of tan and
atan2 moves a sample by ~1e-4 px, which a steep texture edge turns into
just over 1e-5); a mosaic from the same
registration >= 70 dB (``none``, ``linear``, ``multiband``, with ``-e``,
with ``-c``); the two CLIs run independently >= 40 dB after the best
whole-pixel shift within 2 px (the gauge: each run fixes its own
reference frame).
"""
import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pano360_tpu import cli as jcli
from pano360_tpu import match as jmatch
from pano360_tpu import render as jrender
from pano360_tpu import synth
from pano360_tpu.register import PanoImage as JPanoImage

from pano360_tpu_torch import cli as tcli
from pano360_tpu_torch import convert
from pano360_tpu_torch import pipeline as tpipe
from pano360_tpu_torch import render as trender
from pano360_tpu_torch.ops import warp_kernel as TW

from jax_grid_turn import port_grid

torch.set_num_threads(1)

NAME = "views_s1.0"
SHAPES = [(180, 240), (220, 200), (180, 240), (220, 200)]


@pytest.fixture(scope="module", autouse=True)
def _port_grid():
    """The JAX package's grid descriptor turned as the port's
    (``jax_grid_turn``) for every JAX run of this module."""
    with port_grid():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _psnr(a, b):
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float(np.mean(d * d))
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _psnr_aligned(a, b, reach=2):
    """The best PSNR over whole-pixel shifts of up to ``reach`` px, on
    the common area of the two mosaics."""
    h = min(a.shape[0], b.shape[0]) - 2 * reach
    w = min(a.shape[1], b.shape[1]) - 2 * reach
    core = a[reach:reach + h, reach:reach + w]
    return max(_psnr(core, b[reach + dy:reach + dy + h,
                             reach + dx:reach + dx + w])
               for dy in range(-reach, reach + 1)
               for dx in range(-reach, reach + 1))


def jax_draw_fn(n_pairs, seed=0):
    keys = jax.random.split(jax.random.key(seed), max(n_pairs, 1))

    def fn(k, n_valid):
        return torch.as_tensor(np.asarray(jax.random.randint(
            keys[k], (jmatch.RANSAC_ITERS, 4), 0, n_valid)))
    return fn


def _views():
    tex = synth.world_texture(seed=3)
    focal = 240 / (2 * np.tan(np.radians(55) / 2))
    step = 2 * np.arctan(240 / (2 * focal)) * 0.5
    rots = [synth._exp_so3_np(np.array([0.0, (i - 1.5) * step, 0.0]))
            for i in range(len(SHAPES))]
    imgs = [synth.render_view(tex, rot, focal, shp)
            for rot, shp in zip(rots, SHAPES)]
    return imgs, rots, focal


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """One JAX CLI run of the scene (``-b linear``, as test_e2e runs
    it): its caches, registration and mosaic; and the true cameras."""
    root = tmp_path_factory.mktemp("torch_mixed")
    imgs, rots, focal = _views()
    ds = root / "views"
    synth.write_dataset(str(ds), imgs)
    jdir = root / "jax"
    jdir.mkdir()
    mosaic = jcli.run(jcli.build_parser().parse_args(
        [str(ds), "-s", "1", "-b", "linear", "--cache-dir", str(jdir)]))
    u8 = jcli.load_images(str(ds), 1)
    with open(jdir / f"ba_{NAME}.pkl", "rb") as fid:
        regions = pickle.load(fid)
    return dict(root=root, ds=ds, u8=u8, mosaic=mosaic, regions=regions,
                jdir=jdir, rots=rots, focal=focal)


@pytest.fixture(scope="module")
def truth(ref):
    """The scene at its true cameras, as JAX regions, with the JAX
    render's padded stack, ranges and layout."""
    intr = np.diag([ref["focal"], ref["focal"], 1.0])
    regions = [JPanoImage(im, r, intr.copy())
               for im, r in zip(ref["u8"], ref["rots"])]
    shapes = np.array(SHAPES)
    h, w = shapes.max(axis=0)
    stack = np.zeros((len(SHAPES), h, w, 3), np.uint8)
    for k, im in enumerate(ref["u8"]):
        stack[k, :im.shape[0], :im.shape[1]] = im
    sdev = jnp.asarray(shapes, jnp.float32)
    homs = np.stack([r.hom() for r in regions])
    ranges = np.asarray(jrender.proj_img_range_border(
        (int(h), int(w)), jnp.asarray(homs), shapes=sdev, unwrapped=True),
        np.float64)
    for k, reg in enumerate(regions):
        reg.range = (ranges[0][k], ranges[1][k])
    layout = jrender.plan_layout(regions, ranges, "multiband", 1400)
    rgba = jrender.add_weights(
        jnp.asarray(stack).astype(jnp.float32) / 255, sdev)
    return dict(regions=regions, shapes=shapes, stack=stack, ranges=ranges,
                layout=layout, rgba=np.asarray(rgba), homs=homs,
                projs=np.stack([r.proj() for r in regions]))


# ---------------------------------------------------------------------------
# Features per shape bucket
# ---------------------------------------------------------------------------

def test_shape_buckets_group_by_size(ref):
    buckets = tpipe._shape_buckets(ref["u8"])
    assert buckets == {(180, 240): [0, 2], (220, 200): [1, 3]}


@pytest.fixture(scope="module")
def mixed_extract(ref):
    return tpipe.upload_extract(ref["u8"], torch.device("cpu"))


def test_mixed_features_equal_the_uniform_paths(ref, mixed_extract):
    _, feats = mixed_extract
    for idxs in ([0, 2], [1, 3]):
        _, alone = tpipe.upload_extract([ref["u8"][i] for i in idxs],
                                        torch.device("cpu"))
        for field, part in zip(feats, alone):
            assert torch.equal(field[idxs], part)
    assert int(feats.valid.sum(dim=1).min()) > 100


def test_bucket_stacks_pad_in_input_order(ref, mixed_extract, truth):
    stacks, _ = mixed_extract
    assert isinstance(stacks, tpipe.BucketStacks) and stacks.n == 4
    padded = stacks.to_padded(220, 240)
    assert padded.dtype == torch.uint8
    np.testing.assert_array_equal(padded.numpy(), truth["stack"])


def test_mixed_sift_matches_jax(ref, mixed_extract):
    """Against JAX's own bucketed extraction: keypoints within 0.01 px
    for >= 99 % of the JAX set, per image."""
    from pano360_tpu import pipeline as jpipe
    _, jf = jpipe.upload_extract(ref["u8"])
    _, tf = mixed_extract
    for i in range(4):
        jv = np.asarray(jf.valid)[i]
        jxy = np.asarray(jf.xy)[i][jv]
        txy = tf.xy[i][tf.valid[i]].numpy()
        d2 = ((jxy[:, None] - txy[None]) ** 2).sum(-1).min(axis=1)
        assert (d2 < 1e-4).mean() >= 0.99


# ---------------------------------------------------------------------------
# The render's per-image shapes
# ---------------------------------------------------------------------------

def test_border_ranges_with_shapes_match_jax(truth):
    ours = trender.proj_img_range_border(
        (220, 240), _t(truth["homs"]), shapes=truth["shapes"]).numpy()
    np.testing.assert_allclose(ours, truth["ranges"], atol=1e-6)
    # a narrower image spans less azimuth
    width = ours[1, :, 0] - ours[0, :, 0]
    assert width[1] < width[0] and width[3] < width[2]


def test_add_weights_with_shapes_matches_jax(truth):
    imgs = _t(truth["stack"]).to(torch.float32) / 255
    ours = trender.add_weights(imgs, truth["shapes"]).numpy()
    np.testing.assert_allclose(ours, truth["rgba"], atol=1e-6)
    alpha = ours[..., 3]
    assert (alpha[0, 180:] == 0).all() and (alpha[1, :, 200:] == 0).all()
    assert alpha[0, 90, 120] == alpha[0].max()


def test_overlap_matrices_with_shapes_match_jax(truth):
    ov_j, sz_j = jrender.overlap_matrices(
        truth["regions"], jnp.asarray(truth["rgba"]), truth["shapes"])
    ov_t, sz_t = trender.overlap_matrices(
        convert.regions_from_jax(truth["regions"]), _t(truth["rgba"]),
        truth["shapes"])
    assert (sz_j > 0).sum() >= 6
    np.testing.assert_array_equal(sz_t, sz_j)
    np.testing.assert_allclose(ov_t, ov_j, atol=1e-5)


def _warp_args(truth):
    lay = truth["layout"]
    return (truth["projs"].astype(np.float32),
            lay.bottoms.astype(np.float32),
            lay.resolution.astype(np.float32),
            lay.im_range[0].astype(np.float32)), lay


def test_backward_warp_ref_with_shapes_matches_jax(truth):
    (projs, bottoms, res, rmin), lay = _warp_args(truth)
    wins = lay.wins.astype(np.float32)
    jp, ji = jrender.backward_warp_all(
        jnp.asarray(truth["rgba"]), jnp.asarray(projs),
        jnp.asarray(lay.bottoms), jnp.asarray(res), jnp.asarray(rmin),
        lay.ph, lay.pw, shapes=jnp.asarray(truth["shapes"], jnp.float32),
        wins=jnp.asarray(wins), period=lay.period)
    tp, ti = TW.backward_warp_ref(
        _t(truth["rgba"]), _t(projs), _t(bottoms), _t(res), _t(rmin),
        lay.ph, lay.pw, wins=_t(wins), period=lay.period,
        shapes=truth["shapes"])
    ji = np.asarray(ji)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert (~ji).sum() > 10000
    err = np.abs(tp.numpy() - np.asarray(jp))[~ji]
    assert (err <= 1e-5).mean() >= 0.9999 and err.max() <= 1e-4
    # the true size matters: with the stack's size for every region the
    # smaller images come out shifted
    wrong, _ = TW.backward_warp_ref(
        _t(truth["rgba"]), _t(projs), _t(bottoms), _t(res), _t(rmin),
        lay.ph, lay.pw, wins=_t(wins), period=lay.period)
    assert np.abs(wrong.numpy() - np.asarray(jp))[~ji].max() > 0.1


def test_warp_plan_carries_shapes(truth):
    """The plan packs each region's true (h, w); rows of zeros (no
    ``shapes``) mean the stack's size, and both give the plain
    version's result on a uniform stack."""
    (projs, bottoms, res, rmin), lay = _warp_args(truth)
    plan = TW.prepare_warp(projs, bottoms, lay.wins, res, rmin, lay.ph,
                           lay.pw, lay.period, False, "cpu",
                           truth["shapes"])
    np.testing.assert_array_equal(plan.true_hw.numpy(), truth["shapes"])
    assert plan.params.shape == (4, TW.PARAM_FLOATS)
    rgba = _t(truth["rgba"])
    out, bad = TW.launch_warp(rgba, plan)
    ref_out, ref_bad = TW.backward_warp_ref(
        rgba, projs, bottoms, res, rmin, lay.ph, lay.pw, wins=lay.wins,
        period=lay.period, shapes=truth["shapes"])
    assert torch.equal(out, ref_out) and torch.equal(bad, ref_bad)
    none = TW.prepare_warp(projs, bottoms, lay.wins, res, rmin, lay.ph,
                           lay.pw, lay.period, False, "cpu")
    assert (none.true_hw == 0).all()
    full = TW.prepare_warp(projs, bottoms, lay.wins, res, rmin, lay.ph,
                           lay.pw, lay.period, False, "cpu",
                           np.array([[220, 240]] * 4))
    for a, b in zip(TW.launch_warp(rgba, none), TW.launch_warp(rgba, full)):
        assert torch.equal(a, b)


def test_backward_warp_cost_takes_shapes(truth):
    (projs, bottoms, res, rmin), lay = _warp_args(truth)
    kw = dict(wins=lay.wins, period=lay.period)
    mixed = TW.backward_warp_cost(_t(truth["rgba"]), projs, bottoms, res,
                                  rmin, lay.ph, lay.pw,
                                  shapes=truth["shapes"], **kw)
    plain = TW.backward_warp_cost(_t(truth["rgba"]), projs, bottoms, res,
                                  rmin, lay.ph, lay.pw, **kw)
    assert mixed["bytes"] != plain["bytes"] and mixed["bound_ms"] > 0


# ---------------------------------------------------------------------------
# Mosaics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    dict(blender="none"), dict(blender="linear"), dict(blender="multiband"),
    dict(blender="multiband", equalize=True),
    dict(blender="linear", crop=True),
    dict(blender="multiband", warp="pallas"),
], ids=["none", "linear", "multiband", "equalize", "crop", "warp-pallas"])
def test_mixed_stitch_same_regions_matches_jax(ref, opts):
    """From JAX's registration of the mixed scene: >= 70 dB. ``--warp
    pallas`` on mixed shapes takes the exact warp in both packages."""
    jopts = dict(opts)
    if jopts.pop("warp", None):
        jopts["use_pallas"] = True
    theirs = jrender.stitch(ref["regions"], **jopts)
    ours = trender.stitch(convert.regions_from_jax(ref["regions"]),
                          device="cpu", **opts)
    assert ours.shape == theirs.shape and min(ours.shape[:2]) > 0
    assert _psnr(ours, theirs) >= 70.0


def test_mixed_stitch_from_bucket_stacks(ref, mixed_extract):
    """The per-bucket stacks padded on the device give the mosaic of the
    host-padded upload; stacks of another image count are not used."""
    stacks, _ = mixed_extract
    regions = convert.regions_from_jax(ref["regions"])
    assert len(regions) == 4
    a = trender.stitch(regions, blender="linear", device="cpu")
    b = trender.stitch(regions, blender="linear", device="cpu",
                       dev_images=stacks)
    np.testing.assert_array_equal(a, b)
    c = trender.stitch(regions[:3], blender="linear", device="cpu",
                       dev_images=stacks)
    assert c.shape[1] < a.shape[1]


@pytest.fixture(scope="module")
def port_run(ref):
    cache = ref["root"] / "port"
    cache.mkdir()
    args = tcli.build_parser().parse_args(
        [str(ref["ds"]), "-s", "1", "-b", "linear", "--cache-dir",
         str(cache), "--device", "cpu"])
    return args, tcli.run_images(ref["u8"], args, NAME,
                                 draw_fn=jax_draw_fn(6))


def test_cli_mixed_matches_jax(ref, port_run):
    _, mosaic = port_run
    assert mosaic.dtype == np.uint8
    assert abs(mosaic.shape[0] - ref["mosaic"].shape[0]) <= 2
    assert abs(mosaic.shape[1] - ref["mosaic"].shape[1]) <= 2
    assert _psnr_aligned(mosaic, ref["mosaic"]) >= 40.0


def test_cli_mixed_registers_every_view(ref, port_run):
    args, _ = port_run
    regs = tcli.load_ba_cache(f"{args.cache_dir}/ba_{NAME}.pkl")
    assert len(regs) == 4
    assert [r.img.shape[:2] for r in regs] == \
        [r.img.shape[:2] for r in ref["regions"]]
    assert abs(regs[0].intr[0, 0] - ref["focal"]) / ref["focal"] < 0.05


def test_cli_mixed_main_reads_a_directory(ref, port_run, tmp_path):
    """``main`` on the directory of mixed-size files, from the caches."""
    args, mosaic = port_run
    out = tmp_path / "m.png"
    tcli.main([str(ref["ds"]), "-s", "1", "-b", "linear", "--cache-dir",
               args.cache_dir, "--device", "cpu", "-o", str(out)])
    from pano360_tpu_torch.imageio import imread
    np.testing.assert_array_equal(imread(str(out)), mosaic)


def test_cli_mixed_msop(ref, tmp_path):
    """MSOP on mixed sizes: one device extraction per shape bucket. With
    the JAX package's RANSAC draws (on this scene MSOP leaves weak edges
    between non-adjacent views, and whether they pass the gate, and spoil
    the focal, depends on the draws in both packages)."""
    args = tcli.build_parser().parse_args(
        [str(ref["ds"]), "-s", "1", "--detector", "msop", "-e", "-c",
         "--cache-dir", str(tmp_path), "--device", "cpu"])
    mosaic = tcli.run_images(ref["u8"], args, NAME, draw_fn=jax_draw_fn(6))
    regs = tcli.load_ba_cache(f"{tmp_path}/ba_{NAME}.pkl")
    assert len(regs) == 4 and mosaic.shape[1] > 300
    assert abs(regs[0].intr[0, 0] - ref["focal"]) / ref["focal"] < 0.05
