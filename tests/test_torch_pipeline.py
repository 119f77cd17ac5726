"""The PyTorch port's main path held against the JAX package, stage by
stage and end to end (CPU, three 180x240 views).

One JAX CLI run (module fixture) provides every reference: its SIFT
features, its match-graph cache, its bundle-adjustment cache and its
mosaic. The JAX package turns its grid descriptor the other way from the
port, so its runs here take the exact transform to the port's turn
(``jax_grid_turn.port_grid``); the matcher's own tests (knn2, RANSAC,
``match_pair``, ``match_pairs_batch``) take the JAX package's features
as it makes them, since what they hold is the matcher on given
features. Each port stage then takes the JAX output of the stage before
(``pano360_tpu_torch.convert``) and is held to the JAX output of the
same stage; RANSAC gets the JAX package's own hypothesis draws, so the
match graphs compare edge for edge.

Tolerances: SIFT keypoints within 0.01 px for >= 99% of the JAX set and
matched descriptors within 1e-4 for >= 99% (a near-tie orientation peak
may flip a few); knn2 indices equal; RANSAC inlier masks equal and
homographies within 1e-4 relative; traverse rotations within 1e-3 rad
and focal within 1e-3 relative; a mosaic rendered from the same
registration >= 70 dB; the whole slice, run independently, the same
mosaic shape and >= 40 dB.
"""
import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pano360_tpu import cli as jcli
from pano360_tpu import match as jmatch
from pano360_tpu import pipeline as jpipe
from pano360_tpu import synth
from pano360_tpu.features import sift as jsift

from pano360_tpu_torch import cli as tcli
from pano360_tpu_torch import convert
from pano360_tpu_torch import match as tmatch
from pano360_tpu_torch import pipeline as tpipe
from pano360_tpu_torch import register as treg
from pano360_tpu_torch import render as trender
from pano360_tpu_torch.features import sift as tsift

from jax_grid_turn import port_grid

torch.set_num_threads(1)

NAME = "views_s1.0"


def _psnr(a, b):
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float(np.mean(d * d))
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def jax_draw_fn(n_pairs, seed=0):
    """The JAX pipeline's RANSAC draws: pair k uses keys[k] of
    split(key(seed), n_pairs) (pipeline.matching, match.py:238)."""
    keys = jax.random.split(jax.random.key(seed), max(n_pairs, 1))

    def fn(k, n_valid):
        return torch.as_tensor(np.asarray(jax.random.randint(
            keys[k], (jmatch.RANSAC_ITERS, 4), 0, n_valid)))
    return fn


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pipeline")
    imgs, rots, focal = synth.make_views(n_views=3, shape=(180, 240),
                                         overlap=0.5, seed=13)
    ds = root / "views"
    synth.write_dataset(str(ds), imgs)
    jdir = root / "jax"
    jdir.mkdir()
    u8 = jcli.load_images(str(ds), 1)

    def extract():
        feats = jpipe._gray_extract(jnp.asarray(np.stack(u8)),
                                    jsift.SiftConfig(max_kpts=4096))
        return jsift.SiftFeatures(*[np.asarray(a) for a in feats])
    own_feats = extract()
    with port_grid():
        mosaic = jcli.run(jcli.build_parser().parse_args(
            [str(ds), "-s", "1", "--cache-dir", str(jdir)]))
        feats = extract()
    kpts, matches = convert.matches_from_npz(str(jdir / f"matches_{NAME}.npz"))
    with open(jdir / f"ba_{NAME}.pkl", "rb") as fid:
        regions = pickle.load(fid)
    return dict(root=root, u8=u8, mosaic=mosaic, kpts=kpts, matches=matches,
                regions=regions, feats=feats, own_feats=own_feats, jdir=jdir,
                rots=rots, focal=focal)


@pytest.fixture(scope="module")
def port_feats(ref):
    return tpipe.gray_extract(torch.as_tensor(np.stack(ref["u8"])),
                              tsift.SiftConfig())


def _kp_sets(feats, i):
    v = np.asarray(feats.valid)[i]
    return (np.asarray(feats.xy)[i][v], np.asarray(feats.angle)[i][v],
            np.asarray(feats.desc)[i][v])


@pytest.mark.parametrize("img", [0, 1, 2])
def test_sift_matches_jax(ref, port_feats, img):
    jxy, jang, jdesc = _kp_sets(ref["feats"], img)
    txy, tang, tdesc = _kp_sets(port_feats, img)
    assert len(jxy) > 150
    d2 = ((jxy[:, None] - txy[None]) ** 2).sum(-1)
    dang = np.abs(np.angle(np.exp(1j * (jang[:, None] - tang[None]))))
    cost = np.where(d2 < 1e-4, dang, np.inf)
    best = cost.argmin(axis=1)
    matched = cost[np.arange(len(jxy)), best] < 1e-3
    assert matched.mean() >= 0.99, matched.mean()
    err = np.abs(jdesc[matched] - tdesc[best[matched]]).max(axis=1)
    assert (err <= 1e-4).mean() >= 0.99, (err <= 1e-4).mean()


def test_load_images_shrink_matches_jax(ref):
    """-s 2: cv2-linear resize on the device, then uint8 (+-1 for the
    truncation of values that differ in the last f32 bit)."""
    ds = str(ref["root"] / "views")
    ours = tcli.load_images(ds, 2, "cpu")
    theirs = jcli.load_images(ds, 2)
    assert [a.shape for a in ours] == [b.shape for b in theirs]
    for a, b in zip(ours, theirs):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def _rootsift_pair(ref, a, b):
    f = ref["own_feats"]
    desc = np.asarray(jsift.root_sift(jnp.asarray(f.desc)))
    return desc[a], desc[b], f.valid[a], f.valid[b]


def test_knn2_matches_jax(ref):
    d1, d2, v1, v2 = _rootsift_pair(ref, 0, 1)
    jb, jg = jmatch.knn2_matches(jnp.asarray(d1), jnp.asarray(d2),
                                 jnp.asarray(v1), jnp.asarray(v2))
    tb, tg = tmatch.knn2_matches(*(torch.tensor(x)[None]
                                   for x in (d1, d2, v1, v2)))
    jg = np.asarray(jg)
    np.testing.assert_array_equal(tg[0].numpy(), jg)
    np.testing.assert_array_equal(tb[0].numpy()[jg], np.asarray(jb)[jg])
    assert jg.sum() >= 20


def test_ransac_with_jax_draws_matches_jax(ref):
    d1, d2, v1, v2 = _rootsift_pair(ref, 0, 1)
    best, good = (np.asarray(a) for a in jmatch.knn2_matches(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2)))
    xy = ref["own_feats"].xy
    p1 = xy[0].astype(np.float32)
    p2 = xy[1][best].astype(np.float32)
    key = jax.random.key(7)
    ransac = jax.jit(jmatch.ransac_homography)
    jh, jinl, jn = (np.asarray(a) for a in ransac(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(good), key))
    draws = jax.random.randint(key, (jmatch.RANSAC_ITERS, 4), 0,
                               max(int(good.sum()), 1))
    th, tinl, tn = tmatch.ransac_homography(
        torch.tensor(p1)[None], torch.tensor(p2)[None],
        torch.tensor(good)[None], torch.tensor(np.asarray(draws))[None])
    np.testing.assert_array_equal(tinl[0].numpy(), jinl)
    assert int(tn[0]) == int(jn)
    rel = np.abs(th[0].numpy() - jh).max() / np.abs(jh).max()
    assert rel <= 1e-4, rel


def _same_pair_match(t, j):
    """A port ``PairMatch`` against JAX's: inliers, counts and flags
    equal, the matched index on the inlier rows (elsewhere it may be a
    near-tie's, as in ``test_knn2_matches_jax``), the homographies of
    the pairs that pass within 1e-4 relative."""
    for name in ("inlier", "n_inliers", "ok"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    inl = np.asarray(j.inlier)
    assert inl.sum() >= 8
    np.testing.assert_array_equal(t.idx.numpy()[inl], np.asarray(j.idx)[inl])
    ok = np.asarray(j.ok)
    jh = np.asarray(j.hom)[ok]
    rel = np.abs(t.hom.numpy()[ok] - jh).max() / np.abs(jh).max()
    assert rel <= 1e-4, rel


def test_match_pair_with_jax_draws_matches_jax(ref):
    f = ref["own_feats"]
    desc = np.asarray(jsift.root_sift(jnp.asarray(f.desc)))
    key = jax.random.key(5)
    args = (f.xy[0], desc[0], f.valid[0], f.xy[1], desc[1], f.valid[1])
    j = jmatch.match_pair(*(jnp.asarray(a) for a in args), key)

    def draws(k, n_valid):
        assert k == 0
        return torch.as_tensor(np.asarray(jax.random.randint(
            key, (jmatch.RANSAC_ITERS, 4), 0, n_valid)))
    t = tmatch.match_pair(*(torch.tensor(a) for a in args), draw_fn=draws)
    assert bool(t.ok) and int(t.n_inliers) >= 8
    _same_pair_match(t, j)


def test_match_pairs_batch_with_jax_draws_matches_jax(ref):
    f = ref["own_feats"]
    desc = np.asarray(jsift.root_sift(jnp.asarray(f.desc)))
    pair_a, pair_b = np.array([0, 1, 2, 0]), np.array([1, 2, 0, 2])
    keys = jax.random.split(jax.random.key(11), len(pair_a))
    j = jmatch.match_pairs_batch(
        jnp.asarray(f.xy), jnp.asarray(desc), jnp.asarray(f.valid),
        jnp.asarray(pair_a), jnp.asarray(pair_b), keys)

    def draws(k, n_valid):
        return torch.as_tensor(np.asarray(jax.random.randint(
            keys[k], (jmatch.RANSAC_ITERS, 4), 0, n_valid)))
    t = tmatch.match_pairs_batch(
        *(torch.tensor(a) for a in (f.xy, desc, f.valid, pair_a, pair_b)),
        draw_fn=draws)
    assert t.ok[:2].all()        # views 0 and 2 share no pixel
    _same_pair_match(t, j)


def test_match_graph_matches_jax(ref):
    n = len(ref["u8"])
    feats = convert.features_from_jax(ref["feats"])
    kpts, matches = tpipe.matching(ref["u8"], "cpu", feats=feats,
                                   draw_fn=jax_draw_fn(n * (n - 1) // 2))
    for a, b in zip(kpts, ref["kpts"]):
        np.testing.assert_allclose(a, b, atol=1e-5)
    tm, jm = matches.item(), ref["matches"].item()
    assert sorted(tm) == sorted(jm)
    n_edges = 0
    for i in jm:
        assert sorted(tm[i]) == sorted(jm[i])
        for j in jm[i]:
            np.testing.assert_array_equal(tm[i][j][0], jm[i][j][0])
            h_t, h_j = tm[i][j][1], jm[i][j][1]
            assert np.abs(h_t - h_j).max() / np.abs(h_j).max() <= 1e-4
            n_edges += 1
    assert n_edges >= 4


def test_cache_structure_matches_jax(ref):
    """The port's NPZ cache has the JAX package's structure."""
    feats = convert.features_from_jax(ref["feats"])
    kpts, matches = tpipe.matching(ref["u8"], "cpu", feats=feats, seed=3)
    assert kpts.dtype == object and len(kpts) == 3
    assert kpts[0].dtype == np.float32 and kpts[0].shape[1] == 2
    md = matches.item()
    src = next(iter(md))
    dst = next(iter(md[src]))
    m, hom = md[src][dst]
    assert m.dtype == np.int32 and m.shape[1] == 2
    assert hom.shape == (3, 3) and hom.dtype == np.float64
    mr, homr = md[dst][src]
    np.testing.assert_array_equal(mr, np.fliplr(m))
    np.testing.assert_allclose(homr, np.linalg.inv(hom), rtol=1e-8)


def _rot_err(a, b):
    c = np.clip((np.trace(a @ b.T) - 1) / 2, -1, 1)
    return float(np.arccos(c))


def test_traverse_matches_jax(ref):
    regs = treg.traverse(ref["u8"], tpipe.idx_to_keypoints(
        ref["matches"], ref["kpts"]), device="cpu")
    jregs = ref["regions"]
    assert len(regs) == len(jregs) == 3
    for a, b in zip(regs, jregs):
        assert _rot_err(a.rot, b.rot) <= 1e-3
        f_a, f_b = a.intr[0, 0], b.intr[0, 0]
        assert abs(f_a - f_b) / f_b <= 1e-3


@pytest.mark.parametrize("badjust", ["last", "none"])
def test_traverse_other_modes_register(ref, badjust):
    regs = treg.traverse(ref["u8"], tpipe.idx_to_keypoints(
        ref["matches"], ref["kpts"]), badjust=badjust, device="cpu")
    assert len(regs) == 3
    f = regs[0].intr[0, 0]
    assert abs(f - ref["focal"]) / ref["focal"] < 0.05


def test_stitch_same_regions_matches_jax(ref):
    mosaic = trender.stitch(convert.regions_from_jax(ref["regions"]),
                            device="cpu")
    assert mosaic.shape == ref["mosaic"].shape
    assert _psnr(mosaic, ref["mosaic"]) >= 70.0


@pytest.mark.parametrize("blender", ["linear", "none"])
def test_other_blenders_render(ref, blender):
    from pano360_tpu import render as jrender
    mosaic = trender.stitch(convert.regions_from_jax(ref["regions"]),
                            blender=blender, device="cpu")
    jm = jrender.stitch(ref["regions"], blender=blender)
    assert mosaic.shape == jm.shape
    assert _psnr(mosaic, jm) >= 70.0


@pytest.mark.parametrize("opts", [
    dict(equalize=True), dict(crop=True),
    dict(projection="cylindrical", crop=True),
], ids=["equalize", "crop", "cylindrical-crop"])
def test_render_options_same_regions_match_jax(ref, opts):
    """-e, -c and the cylindrical projection from the same registration:
    the mosaic's shape exactly (crop included) and >= 70 dB."""
    from pano360_tpu import render as jrender
    mosaic = trender.stitch(convert.regions_from_jax(ref["regions"]),
                            device="cpu", **opts)
    jm = jrender.stitch(ref["regions"], **opts)
    assert mosaic.shape == jm.shape and min(mosaic.shape[:2]) > 0
    assert _psnr(mosaic, jm) >= 70.0


@pytest.fixture(scope="module")
def port_run(ref):
    cache = ref["root"] / "port"
    cache.mkdir()
    args = tcli.build_parser().parse_args(
        [str(ref["root"] / "views"), "-s", "1", "--cache-dir", str(cache),
         "--device", "cpu"])
    mosaic = tcli.run_images(ref["u8"], args, NAME, draw_fn=jax_draw_fn(3))
    return args, mosaic


def test_cli_slice_matches_jax(ref, port_run):
    _, mosaic = port_run
    assert mosaic.dtype == np.uint8 and mosaic.shape == ref["mosaic"].shape
    assert _psnr(mosaic, ref["mosaic"]) >= 40.0


def test_cli_slice_registration_quality(ref, port_run):
    args, _ = port_run
    regs = tcli.load_ba_cache(f"{args.cache_dir}/ba_{NAME}.pkl")
    assert len(regs) == 3
    assert abs(regs[0].intr[0, 0] - ref["focal"]) / ref["focal"] < 0.03
    rots = ref["rots"]
    for i in range(2):
        est = regs[i + 1].rot @ regs[i].rot.T
        true = rots[i + 1] @ rots[i].T
        assert np.degrees(_rot_err(est, true)) < 0.5


def test_cli_equalize_crop_matches_jax(ref, port_run):
    """``-e -c`` through both CLIs, each on its own registration (the
    port's run with JAX's RANSAC draws): the slice's 40-dB bar."""
    args, _ = port_run
    flags = ["-s", "1", "-e", "-c"]
    ours = tcli.run_images(ref["u8"], tcli.build_parser().parse_args(
        [args.path, *flags, "--cache-dir", args.cache_dir,
         "--device", "cpu"]), NAME)
    with port_grid():
        theirs = jcli.run(jcli.build_parser().parse_args(
            [str(ref["root"] / "views"), *flags,
             "--cache-dir", str(ref["jdir"])]))
    assert ours.dtype == np.uint8 and ours.shape == theirs.shape
    assert _psnr(ours, theirs) >= 40.0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_match_cache_loader_reads_both_packages(ref, port_run, writer):
    """The restricted loader reads a cache the JAX CLI wrote and one the
    port wrote, to the same arrays as numpy's unrestricted one."""
    args, _ = port_run
    cache = ref["jdir"] if writer == "jax" else args.cache_dir
    path = f"{cache}/matches_{NAME}.npz"
    kpts, matches = tcli.load_match_cache(path)
    arr = np.load(path, allow_pickle=True)
    assert len(kpts) == len(arr["kpts"]) == 3
    for a, b in zip(kpts, arr["kpts"]):
        np.testing.assert_array_equal(a, b)
    m, want = matches.item(), arr["matches"].item()
    assert {i: sorted(c) for i, c in m.items()} == \
        {i: sorted(c) for i, c in want.items()}
    for i in want:
        for j in want[i]:
            np.testing.assert_array_equal(m[i][j][0], want[i][j][0])
            np.testing.assert_array_equal(m[i][j][1], want[i][j][1])


def test_cli_run_from_caches_reproduces(ref, port_run):
    args, mosaic = port_run
    again = tcli.run(args)
    np.testing.assert_array_equal(again, mosaic)


def test_cli_main_writes_mosaic(ref, port_run, tmp_path):
    args, mosaic = port_run
    out = tmp_path / "m.png"
    tcli.main([args.path, "-s", "1", "--cache-dir", args.cache_dir,
               "--device", "cpu", "-o", str(out)])
    from pano360_tpu_torch.imageio import imread
    np.testing.assert_array_equal(imread(str(out)), mosaic)


def test_cli_profile_and_trace_flags(ref, port_run, tmp_path, capsys):
    """--profile prints the cProfile and stage report; --trace-dir writes
    a torch.profiler Chrome trace (both consume the warm caches)."""
    args, _ = port_run
    trace = tmp_path / "trace"
    tcli.main([args.path, "-s", "1", "--cache-dir", args.cache_dir,
               "--device", "cpu", "--profile", "--trace-dir", str(trace)])
    out = capsys.readouterr().out
    assert "cumulative" in out and "Built mosaic" in out
    assert (trace / "trace.json").stat().st_size > 0


def _u8(imgs):
    return [(im * 255).astype(np.uint8) for im in imgs]


def test_two_image_minimum(tmp_path):
    """The smallest panorama: two overlapping views."""
    imgs, _, _ = synth.make_views(n_views=2, shape=(180, 240), overlap=0.5,
                                  seed=21)
    args = tcli.build_parser().parse_args(
        [str(tmp_path), "-s", "1", "-b", "linear", "--cache-dir",
         str(tmp_path), "--device", "cpu"])
    mosaic = tcli.run_images(_u8(imgs), args, "pair")
    assert mosaic.ndim == 3 and mosaic.shape[1] > 240


def test_unrelated_images_clean_exit(tmp_path):
    """No overlap: an empty match graph ends in a clean SystemExit."""
    a, _, _ = synth.make_views(n_views=1, shape=(180, 240), seed=31)
    b, _, _ = synth.make_views(n_views=1, shape=(180, 240), seed=77)
    args = tcli.build_parser().parse_args(
        [str(tmp_path), "-s", "1", "--cache-dir", str(tmp_path),
         "--device", "cpu"])
    with pytest.raises(SystemExit, match="match graph is empty"):
        tcli.run_images(_u8(a + b), args, "unrelated")
