"""The port's process-group mesh (``pano360_tpu_torch.parallel``) held
against its own one-process runs, and against the JAX package, on the
CPU with gloo ranks spawned by the port's launcher.

One spawned group per world size (4 and 3; 3 divides neither the pairs
nor the edges) runs every sharded stage at once (``dryrun.jobs``); the
test functions share its results. Against the port's one-process run:
features and match graph bit-equal (one shape, two shape buckets, MSOP),
cameras within rotation 5e-5 and focal 1e-4 relative with equal LM
iteration counts, mosaics >= 70 dB for every blender (the seam-crossing
9-view sweep included, every column it covers non-empty) and under
``-e -c``. Against the JAX package: ``distributed_lm_stats`` at
``tests/test_parallel.py``'s tolerances, the match graph on JAX's
features and RANSAC draws edge for edge, the render of JAX's regions
>= 70 dB. The CLI's ``--mesh 4 --device cpu`` end to end.
"""
import contextlib
import functools
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pano360_tpu import match as jmatch
from pano360_tpu import pipeline as jpipe
from pano360_tpu import register as jreg
from pano360_tpu import render as jrender
from pano360_tpu import synth
from pano360_tpu.features import sift as jsift

from pano360_tpu_torch import cli as tcli
from pano360_tpu_torch import convert
from pano360_tpu_torch import match as tmatch
from pano360_tpu_torch import pipeline as tpipe
from pano360_tpu_torch import register as treg
from pano360_tpu_torch import render as trender
from pano360_tpu_torch.features import sift as tsift
from pano360_tpu_torch.parallel import dryrun, mesh as tmesh


@contextlib.contextmanager
def _threads(n):
    """Run a one-process reference at the thread count of an n-rank
    group's ranks: on the CPU, reductions split their work by thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(tmesh.rank_threads(n))
    try:
        yield
    finally:
        torch.set_num_threads(old)

KP = 128                      # max_kpts at these sizes
BLENDERS = ("multiband", "linear", "none")


def _u8(imgs):
    return [np.clip(im * 255, 0, 255).astype(np.uint8) for im in imgs]


@functools.lru_cache(maxsize=None)
def _texture():
    return synth.world_texture(seed=0)     # one world for every scene


def _views(n, shape, overlap, seed):
    return _u8(synth.make_views(n_views=n, shape=shape, overlap=overlap,
                                seed=seed, texture=_texture())[0])


def _sweep(cls=treg.PanoImage):
    """``test_mesh_blend_wrap_parity``'s sweep at half its image size:
    9 views x 60 deg at 0.2 overlap span 444 deg, so views cross the
    seam and the canvas is periodic."""
    imgs, rots, focal = synth.make_views(n_views=9, shape=(60, 80),
                                         seed=5, fov_deg=60.0, overlap=0.2,
                                         texture=_texture())
    intr = np.diag([focal, focal, 1.0])
    return [cls((im * 255).astype(np.uint8), r.copy(), intr.copy())
            for im, r in zip(imgs, rots)]


def _lm_inputs(e=8, seed=4):
    """``tests/test_parallel.py``'s distributed LM inputs (e = 8)."""
    rng = np.random.default_rng(seed)
    c, m = 4, 64
    params = (rng.standard_normal((c, 6)) * 0.1
              + np.array([500, 0, 0, 0, 0, 0])).astype(np.float32)
    cam1 = rng.integers(0, c, e).astype(np.int32)
    cam2 = ((rng.integers(1, c, e) + cam1) % c).astype(np.int32)
    pts = np.ones((e, m, 6), np.float32)
    pts[..., :2] = rng.uniform(-100, 100, (e, m, 2))
    pts[..., 3:5] = rng.uniform(-100, 100, (e, m, 2))
    mask = (rng.random((e, m)) > 0.3).astype(np.float32)
    return params, cam1, cam2, pts, mask


@pytest.fixture(scope="module")
def scenes():
    uni = _views(4, (64, 96), 0.5, 0)
    mixed = _views(4, (64, 96), 0.5, 2)
    mixed[1], mixed[3] = mixed[1][:56, :80], mixed[3][:56, :80]
    msop = _views(4, (64, 96), 0.6, 3)
    with _threads(4):
        return _one_process(uni, mixed, msop)


def _one_process(uni, mixed, msop):
    """The one-process references of the 4-rank group's jobs."""
    ref = dryrun.pipeline(None, uni, "cpu", max_kpts=KP)
    _, feats = tpipe.upload_extract(uni, torch.device("cpu"),
                                    tsift.SiftConfig(max_kpts=KP))
    bufs = (feats.xy, tsift.root_sift(feats.desc), feats.valid)
    gen = torch.Generator().manual_seed(0)
    pairs = [(a, b) for a in range(4) for b in range(a + 1, 4)]
    regions = [treg.PanoImage(im, rot, intr)
               for im, (rot, intr) in zip(uni, ref["cams"])]
    sweep = _sweep()
    one = dict(
        pipeline=ref,
        mixed=tpipe.matching(mixed, "cpu", max_kpts=KP),
        msop=tpipe.matching(msop, "cpu", detector="msop"),
        sweep={b: trender.stitch(sweep, blender=b, device="cpu")
               for b in BLENDERS},
        ec=trender.stitch(regions, equalize=True, crop=True, device="cpu"),
        feats=feats,
        pairs=tmatch.match_all_pairs(*bufs, pairs, 2, generator=gen))
    return dict(uni=uni, mixed=mixed, msop=msop, regions=regions,
                sweep=sweep, one=one, bufs=bufs, pair_list=pairs)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's features, its match graph on them and its multiband mosaic
    of the sweep; the port's draws table replays JAX's RANSAC draws."""
    u8 = _views(4, (96, 128), 0.5, 11)
    jfeats = jpipe._gray_extract(jnp.asarray(np.stack(u8)),
                                 jsift.SiftConfig(max_kpts=KP))
    jfeats = jsift.SiftFeatures(*[np.asarray(a) for a in jfeats])
    jk, jm = jpipe.matching(u8, max_kpts=KP, seed=0, feats=jfeats)
    n_pairs = len(u8) * (len(u8) - 1) // 2
    keys = jax.random.split(jax.random.key(0), n_pairs)
    table = {}

    def record(k, n_valid):
        table[k] = np.asarray(jax.random.randint(
            keys[k], (jmatch.RANSAC_ITERS, 4), 0, n_valid))
        return torch.as_tensor(table[k])
    feats = convert.features_from_jax(jfeats)
    tpipe.matching(u8, "cpu", feats=feats, draw_fn=record)
    return dict(u8=u8, feats=feats, kpts=jk, matches=jm, table=table,
                sweep=jrender.stitch(_sweep(jreg.PanoImage)))


BIG_EDGES = 137     # more than a small world's; 3 and 4 do not divide it


def _big_lm_job():
    return (tmesh.distributed_lm_stats, (), dict(zip(
        ("params", "cam1", "cam2", "pts", "mask"),
        _lm_inputs(BIG_EDGES, seed=7))))


def _jobs4(scenes, jax_ref):
    stitch, match = trender.stitch, tpipe.matching
    todo = [
        (dryrun.pipeline, (), dict(imgs=scenes["uni"], device="cpu",
                                   max_kpts=KP)),
        (match, (scenes["mixed"], "cpu"), dict(max_kpts=KP)),
        (match, (scenes["msop"], "cpu"), dict(detector="msop")),
        (stitch, (scenes["regions"],), dict(equalize=True, crop=True,
                                            device="cpu")),
        (tmesh.distributed_lm_stats, (), dict(zip(
            ("params", "cam1", "cam2", "pts", "mask"), _lm_inputs()))),
        _big_lm_job(),
        (match, (jax_ref["u8"], "cpu"), dict(
            feats=jax_ref["feats"],
            draw_fn=tmatch.DrawTable(jax_ref["table"]))),
    ]
    todo += [(stitch, (scenes["sweep"],), dict(blender=b, device="cpu"))
             for b in BLENDERS]
    gray = torch.as_tensor(np.stack([im.mean(-1) / 255
                                     for im in scenes["uni"]]),
                           dtype=torch.float32)
    todo += [
        (tmesh.sharded_color_extract, (), dict(
            stack_u8=np.stack(scenes["uni"]),
            cfg=tsift.SiftConfig(max_kpts=KP))),
        (tmesh.sharded_match_all_pairs, (), dict(
            kpts=scenes["bufs"][0], desc=scenes["bufs"][1],
            valid=scenes["bufs"][2], pairs=scenes["pair_list"], seed=0,
            batch_size=2)),
        (tmesh.distributed_step, (), dict(
            gray=gray, cfg=tsift.SiftConfig(max_kpts=KP, upscale=False))),
    ]
    keys = ["pipeline", "mixed", "msop", "ec", "lm", "lm_big",
            "jax_graph"] + [
        f"sweep_{b}" for b in BLENDERS] + ["color_extract", "all_pairs",
                                          "step"]
    return keys, todo


@pytest.fixture(scope="module")
def mesh4(scenes, jax_ref):
    keys, todo = _jobs4(scenes, jax_ref)
    return dict(zip(keys, tmesh.launch(dryrun.jobs, 4, "cpu", todo)))


@pytest.fixture(scope="module")
def mesh3(scenes):
    todo = [(dryrun.pipeline, (), dict(imgs=scenes["uni"], device="cpu",
                                       max_kpts=KP)),
            (trender.stitch, (scenes["sweep"],), dict(device="cpu")),
            _big_lm_job()]
    keys = ["pipeline", "sweep_multiband", "lm_big"]
    return dict(zip(keys, tmesh.launch(dryrun.jobs, 3, "cpu", todo)))


@pytest.fixture(scope="module")
def one3(scenes):
    """The 3-rank group's one-process references: the 4-rank group's
    unless the two groups' ranks run different thread counts."""
    if tmesh.rank_threads(3) == tmesh.rank_threads(4):
        return scenes["one"]
    with _threads(3):
        return dict(pipeline=dryrun.pipeline(None, scenes["uni"], "cpu",
                                             max_kpts=KP),
                    sweep={"multiband": trender.stitch(scenes["sweep"],
                                                       device="cpu")})


@pytest.fixture(params=[4, 3], ids=["world4", "world3"])
def mesh_run(request, mesh4, mesh3, scenes, one3):
    """(the group's results, its one-process references, world size)."""
    if request.param == 4:
        return mesh4, scenes["one"], 4
    return mesh3, one3, 3


def _graphs_equal(a, b):
    assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))
    assert len(a[0]) == len(b[0])
    assert dryrun.matches_equal(a[1], b[1])


def test_pipeline_features_and_graph_bit_equal(mesh_run):
    got, one, _ = mesh_run
    cmp = dryrun.compare(got["pipeline"], one["pipeline"])
    assert cmp["features_equal"] and cmp["match_graph_equal"], cmp
    assert len(one["pipeline"]["matches"].item()) == 4


def test_pipeline_cameras_and_lm_counts(mesh_run):
    got, one, _ = mesh_run
    cmp = dryrun.compare(got["pipeline"], one["pipeline"])
    assert cmp["placed"] == (4, 4)
    assert cmp["rot_max_diff"] <= dryrun.ROT_ATOL
    assert cmp["focal_max_rel_diff"] <= dryrun.FOCAL_RTOL
    assert cmp["lm_iterations_equal"], (got["pipeline"]["lm_iterations"],
                                        one["pipeline"]["lm_iterations"])


def test_pipeline_mosaic(mesh_run):
    got, one, _ = mesh_run
    cmp = dryrun.compare(got["pipeline"], one["pipeline"])
    assert cmp["mosaic_psnr_db"] >= dryrun.MIN_PSNR_DB, cmp
    assert cmp["ok"]


def test_every_rank_reports(mesh_run):
    ranks = mesh_run[0]["pipeline"]["ranks"]
    assert [r["rank"] for r in ranks] == list(range(len(ranks)))
    assert all(r["gathers"] > 0 and r["gather_seconds"] >= 0
               and set(r["seconds"]) == {"matching", "traverse", "stitch"}
               for r in ranks)


def test_two_shape_buckets_bit_equal(mesh4, scenes):
    _graphs_equal(mesh4["mixed"], scenes["one"]["mixed"])
    assert {k.shape[0] > 0 for k in mesh4["mixed"][0]} == {True}


def test_msop_matching(mesh4, scenes):
    got, want = mesh4["msop"], scenes["one"]["msop"]
    for a, b in zip(got[0], want[0]):
        np.testing.assert_allclose(a, b, atol=1e-4)
    gm, wm = got[1].item(), want[1].item()
    assert {(i, j) for i in gm for j in gm[i]} == \
        {(i, j) for i in wm for j in wm[i]}
    _graphs_equal(got, want)


@pytest.mark.parametrize("blender", BLENDERS)
def test_seam_crossing_sweep(mesh4, scenes, blender):
    want = scenes["one"]["sweep"][blender]
    got = mesh4[f"sweep_{blender}"]
    assert got.shape == want.shape
    assert dryrun.psnr(got, want) >= dryrun.MIN_PSNR_DB
    assert (got.sum(axis=(0, 2)) > 0).all(), blender


def test_seam_crossing_sweep_three_ranks(mesh3, one3):
    got, want = mesh3["sweep_multiband"], one3["sweep"]["multiband"]
    assert got.shape == want.shape
    assert dryrun.psnr(got, want) >= dryrun.MIN_PSNR_DB
    assert (got.sum(axis=(0, 2)) > 0).all()


def test_equalize_crop_under_the_mesh(mesh4, scenes):
    got, want = mesh4["ec"], scenes["one"]["ec"]
    assert got.shape == want.shape and min(got.shape[:2]) > 0
    assert dryrun.psnr(got, want) >= dryrun.MIN_PSNR_DB


def test_sharded_color_extract_bit_equal(mesh4, scenes):
    got, want = mesh4["color_extract"], scenes["one"]["feats"]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_sharded_match_all_pairs_bit_equal(mesh4, scenes):
    """3 chunks of 2 pairs over 4 ranks: the replayed draws."""
    got, want = mesh4["all_pairs"], scenes["one"]["pairs"]
    assert all(np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
               for a, b in zip(got, want))
    assert got.ok.sum() >= 3


def test_distributed_step_demo(mesh4):
    """The ring-pair Gauss-Newton demo: one damped step of every camera
    from the gathered normal equations."""
    params, n_inliers = mesh4["step"]
    assert params.shape == (4, 6) and torch.isfinite(params).all()
    assert n_inliers > 0


def test_distributed_lm_stats_matches_jax(mesh4):
    params, cam1, cam2, pts, mask = _lm_inputs()
    d = mesh4["lm"]
    ref = jreg._lm_stats(jnp.asarray(params), jnp.asarray(cam1),
                         jnp.asarray(cam2), jnp.asarray(pts),
                         jnp.asarray(mask))
    np.testing.assert_allclose(float(d[0]), float(ref[0]), rtol=1e-5)
    np.testing.assert_allclose(float(d[1]), float(ref[1]), rtol=1e-6)
    np.testing.assert_allclose(d[2].numpy(), np.asarray(ref[2]), rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_allclose(d[3].numpy(), np.asarray(ref[3]), rtol=1e-4,
                               atol=1e-2)


def test_distributed_lm_stats_bit_equal_to_one_process(mesh_run):
    """137 edges sharded over 4 or 3 ranks: the loss sums
    and the normal equations bit for bit those of one process."""
    got, _, world = mesh_run
    params, cam1, cam2, pts, mask = (torch.as_tensor(a) for a in
                                     _lm_inputs(BIG_EDGES, seed=7))
    prob = treg.Problem(cam1, cam2, pts, mask, params.shape[0])
    with _threads(world):
        sq, cnt = prob.edge_sums(params, prob.mask)
        want = (torch.sum(sq), 2.0 * torch.sum(cnt),
                *prob.normal_equations(params, prob.mask))
    got = got["lm_big"]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_match_graph_on_jax_draws_matches_jax(mesh4, jax_ref):
    kpts, matches = mesh4["jax_graph"]
    for a, b in zip(kpts, jax_ref["kpts"]):
        np.testing.assert_allclose(a, b, atol=1e-5)
    tm, jm = matches.item(), jax_ref["matches"].item()
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


def test_render_of_jax_regions_matches_jax(mesh4, jax_ref):
    """The sweep's regions through the port's mesh render and JAX's."""
    got, want = mesh4["sweep_multiband"], jax_ref["sweep"]
    assert got.shape == want.shape
    assert dryrun.psnr(got, want) >= dryrun.MIN_PSNR_DB


def test_cli_mesh_end_to_end(tmp_path, scenes):
    """``--mesh 4 --device cpu`` through ``main`` on two views (so two
    ranks warp padding only): the caches equal the one-process run's
    (features and match graph bit for bit, cameras within the dryrun's
    gates), the mosaic >= 70 dB and written by -o."""
    ds = tmp_path / "views"
    synth.write_dataset(str(ds), [im.astype(np.float32) / 255
                                  for im in scenes["uni"][:2]])
    caches = {}
    for label, extra in (("one", []), ("mesh", ["--mesh", "4"])):
        cache = tmp_path / label
        cache.mkdir()
        out = tmp_path / f"{label}.png"
        with _threads(4):
            mosaic = tcli.main([str(ds), "-s", "1", "--device", "cpu",
                                "--cache-dir", str(cache), "-o", str(out),
                                *extra])
        from pano360_tpu_torch.imageio import imread
        np.testing.assert_array_equal(imread(str(out)), mosaic)
        name = "views_s1.0"
        caches[label] = (tcli.load_match_cache(str(cache /
                                                   f"matches_{name}.npz")),
                         tcli.load_ba_cache(str(cache / f"ba_{name}.pkl")),
                         mosaic)
    (m1, r1, a1), (m4, r4, a4) = caches["one"], caches["mesh"]
    _graphs_equal(m4, m1)
    assert len(r4) == len(r1) == 2
    for a, b in zip(r4, r1):
        np.testing.assert_allclose(a.rot, b.rot, atol=dryrun.ROT_ATOL)
        np.testing.assert_allclose(a.intr[0, 0], b.intr[0, 0],
                                   rtol=dryrun.FOCAL_RTOL)
    assert a4.shape == a1.shape
    assert dryrun.psnr(a4, a1) >= dryrun.MIN_PSNR_DB


def test_cli_mesh_clamps_to_the_gpus(monkeypatch, tmp_path, caplog):
    """``--device cuda`` with one GPU: --mesh 2 warns and takes the
    single-process path (the JAX CLI on one chip); --device cpu: N gloo
    ranks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    parse = tcli.build_parser().parse_args
    with caplog.at_level("WARNING"):
        assert tcli.mesh_ranks(parse([str(tmp_path), "--mesh", "2"])) == 1
    assert "only 1 device" in caplog.text
    assert tcli.mesh_ranks(parse([str(tmp_path), "--mesh", "2",
                                  "--device", "cpu"])) == 2
    assert tcli.mesh_ranks(parse([str(tmp_path), "--device", "cpu"])) == 1


def test_launch_fails_when_a_rank_fails():
    """A rank that raises fails the launch (no rank is left waiting)."""
    with pytest.raises(Exception, match="no images to process"):
        tmesh.launch(dryrun.jobs, 2, "cpu", [(tpipe.matching, ([], "cpu"),
                                              {})])


@pytest.mark.parametrize("world", [2, 3, 4])
def test_edge_terms_do_not_depend_on_the_shard(world):
    """``Problem``'s per-edge terms of a shard are the one-process
    problem's rows of those edges, bit for bit, at any thread count: they
    are computed by elementwise operations only."""
    params, cam1, cam2, pts, mask = (torch.as_tensor(a) for a in
                                     _lm_inputs(BIG_EDGES, seed=7))
    one = treg.Problem(cam1, cam2, pts, mask, params.shape[0])
    want = (one._edge_terms(params, one.mask),
            *one.edge_sums(params, one.mask))
    for rank in range(world):
        part = types.SimpleNamespace(rank=rank, size=world)
        prob = treg.Problem(cam1, cam2, pts, mask, params.shape[0], part)
        prob.mesh = None                       # the shard's rows alone
        got = (prob._edge_terms(params, prob.mask),
               *prob.edge_sums(params, prob.mask))
        lo, n = prob.lo, min(prob.cam1.shape[0], BIG_EDGES - prob.lo)
        for g, w in zip(got, want):
            assert torch.equal(g[:n], w[lo:lo + n])


def test_make_mesh_defaults_to_the_card(monkeypatch, tmp_path):
    """``make_mesh()`` in a gloo group takes ``cuda:(rank % count)``
    whenever CUDA is available; without a card it raises as
    ``resolve_device`` does: the CPU only when named."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert tmesh.make_mesh().device == torch.device("cuda", 0)
        assert tmesh.make_mesh(1, "cpu").device == torch.device("cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmesh.make_mesh()
    finally:
        dist.destroy_process_group()
