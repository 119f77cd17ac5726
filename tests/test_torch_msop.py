"""The port's MSOP detector (``--detector msop``) held against the JAX
package: the filter ops it rests on, each stage with the JAX stage's
outputs injected upstream, the whole extraction, and both CLIs.

Same inputs, made from a numpy seed, through both packages (JAX on the
CPU). Tolerances:

- filter ops: within 1e-5 of the reference's largest magnitude;
- candidates from the same Harris map: equal, in order, also where a
  flat region makes exact ties (``lax.top_k`` breaks ties towards the
  lower index; so must the port);
- orientations 1e-4 rad; descriptors from the same keypoints atol 1e-4
  for >= 99 % and 1e-2 for all (a descriptor is divided by its patch's
  standard deviation, so a low-contrast patch magnifies the last bit of
  sin and cos);
- ``ssc``: the native and the Python path equal, and equal to JAX's;
- the whole extraction: keypoint lists equal, in order, against the JAX
  functions run op by op (``jax.disable_jit``). Under ``jit`` XLA
  contracts a*b+c in the Harris response, which moves a response by an
  ulp and can flip near-ties, so against the jitted run the gate is that
  >= 99 % of its keypoints are the port's (ROADMAP, divergences);
- ``--detector msop`` through both CLIs: match-graph edges and cache
  structure equal with JAX's features and RANSAC draws injected, and the
  two independent runs' mosaics >= 40 dB;
- the registration of an MSOP match graph (``registration_parity``, also
  a command line for any size, see the end of the file): the graph equal
  on JAX's features and draws, both bundle adjustments within 1e-3 of
  each other's focal error and 0.01 deg, the LM iteration counts
  reported.
"""
import functools
import pickle
import time

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pano360_tpu import cli as jcli
from pano360_tpu import match as jmatch
from pano360_tpu import pipeline as jpipe
from pano360_tpu import register as jreg
from pano360_tpu import synth
from pano360_tpu.features import msop as jmsop
from pano360_tpu.ops import filters as jfilters

from pano360_tpu_torch import cli as tcli
from pano360_tpu_torch import convert, native
from pano360_tpu_torch import pipeline as tpipe
from pano360_tpu_torch import register as treg
from pano360_tpu_torch.features import msop as tmsop
from pano360_tpu_torch.ops import filters as tfilters

torch.set_num_threads(1)

DENSE_TOL = 1e-5
NAME = "views_s1.0"


def _t(a):
    return torch.from_numpy(np.array(a))


def _psnr(a, b):
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float(np.mean(d * d))
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _rot_err(a, b):
    return float(np.arccos(np.clip((np.trace(a @ b.T) - 1) / 2, -1, 1)))


def jax_draw_fn(n_pairs, seed=0):
    """The JAX pipeline's RANSAC draws: pair k uses keys[k] of
    split(key(seed), n_pairs)."""
    keys = jax.random.split(jax.random.key(seed), max(n_pairs, 1))

    def fn(k, n_valid):
        return torch.as_tensor(np.asarray(jax.random.randint(
            keys[k], (jmatch.RANSAC_ITERS, 4), 0, n_valid)))
    return fn


def _desc_close(out, ref):
    err = np.abs(out - ref).max(axis=-1)
    assert (err <= 1e-4).mean() >= 0.99, (err <= 1e-4).mean()
    assert err.max() <= 1e-2, err.max()


def _u8(imgs):
    return [(np.asarray(im) * 255).astype(np.uint8) for im in imgs]


def _scene(n=3, shape=(160, 200), seed=1, flat=True):
    imgs = _u8(synth.make_views(n_views=n, shape=shape, overlap=0.5,
                                seed=seed)[0])
    if flat:
        imgs[0][:60, :80] = 128          # exact Harris ties
    return imgs


# ---------------------------------------------------------------------------
# Filter ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("box_filter", (2,)), ("box_filter", (3,)), ("box_filter", (4,)),
    ("sobel", (1, 0)), ("sobel", (0, 1)), ("harris_response", ()),
    ("max_pool3x3", ()), ("pyr_down", ()), ("pyr_up", ()),
    ("pyr_up", ((89, 125),)),
], ids=lambda v: v if isinstance(v, str) else "-".join(map(str, v)))
@pytest.mark.parametrize("layout", ["hw", "nhwc"])
def test_filter_op_matches_jax(name, args, layout):
    rng = np.random.default_rng(5)
    shape = (45, 63) if layout == "hw" else (2, 45, 63, 3)
    x = (rng.random(shape) * 255).astype(np.float32)
    ref = np.asarray(getattr(jfilters, name)(jnp.asarray(x), *args))
    out = getattr(tfilters, name)(_t(x), *args).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= DENSE_TOL * np.abs(ref).max()


@pytest.mark.parametrize("sigma", [0.3, 1.0, 1.6, 2.0, 4.4])
def test_feature_ksize_matches_jax(sigma):
    assert tfilters.feature_ksize(sigma) == jfilters.feature_ksize(sigma)
    assert tfilters.feature_ksize(sigma) % 2 == 1


def test_box_filter_even_size_ends_at_the_pixel():
    """Size 2 sums the 2x2 window that ENDS at the pixel (cv2's anchor)."""
    x = np.zeros((6, 7), np.float32)
    x[3, 4] = 1.0
    out = tfilters.box_filter(_t(x), 2).numpy()
    assert set(zip(*np.nonzero(out))) == {(3, 4), (3, 5), (4, 4), (4, 5)}


def test_pyr_down_odd_size_rounds_up():
    x = _t(np.random.default_rng(0).random((45, 63)).astype(np.float32))
    assert tfilters.pyr_down(x).shape == (23, 32)


# ---------------------------------------------------------------------------
# Stage by stage, the JAX stage's outputs injected upstream
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def level0():
    """One jitted JAX level of the scene (with a flat region): its gray
    input, its outputs, and its Harris map."""
    stack = np.stack(_scene())
    gray = np.asarray(jmsop._msop_gray(jnp.asarray(stack)))
    level = [np.asarray(a) for a in jmsop._msop_level_batch(
        jnp.asarray(gray), 100000)]
    hrs = np.asarray(jax.jit(jax.vmap(jfilters.harris_response))(
        jnp.asarray(gray)))
    return dict(stack=stack, gray=gray, level=level, hrs=hrs)


def test_msop_gray_is_0_to_255(level0):
    gray = tmsop.msop_gray(_t(level0["stack"])).numpy()
    assert gray.max() > 100.0
    assert np.abs(gray - level0["gray"]).max() <= DENSE_TOL * 255


def test_candidates_equal_with_exact_ties(level0):
    """From the same Harris maps: the same candidates in the same order.
    The flat region gives thousands of exactly equal responses."""
    hrs = level0["hrs"]
    b, h, w = hrs.shape
    locmax = np.asarray(jax.vmap(jfilters.max_pool3x3)(jnp.asarray(hrs))) \
        == hrs
    score = np.where(locmax, hrs, -np.inf).reshape(b, -1)
    jvals, jidx = jax.lax.top_k(jnp.asarray(score), h * w)
    _, counts = np.unique(score[0][np.isfinite(score[0])],
                          return_counts=True)
    assert counts.max() > 1000           # the ties are there
    tvals, tidx = tmsop.top_candidates(_t(hrs), 100000)
    assert tidx.shape == (b, h * w)
    n_fin = np.isfinite(np.asarray(jvals)).sum(axis=1)
    for i in range(b):
        np.testing.assert_array_equal(tidx[i, :n_fin[i]].numpy(),
                                      np.asarray(jidx)[i, :n_fin[i]])
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))


def test_candidates_cap_cuts_the_order(level0):
    vals, idx = tmsop.top_candidates(_t(level0["hrs"]), 500)
    full_vals, full_idx = tmsop.top_candidates(_t(level0["hrs"]), 100000)
    assert idx.shape == (3, 500)
    assert torch.equal(idx, full_idx[:, :500])


def test_level_matches_jax(level0):
    """The port's level on JAX's gray: maps within 1e-5 of their range;
    the candidates both packages list get orientations within 1e-4 rad
    (atan2 takes the x gradient first)."""
    jvals, jrows, jcols, jtheta, jblur, jnext = level0["level"]
    vals, rows, cols, theta, blurred, nxt = tmsop.msop_level(
        _t(level0["gray"]), 100000)
    assert np.abs(blurred.numpy() - jblur).max() <= DENSE_TOL * 255
    assert np.abs(nxt.numpy() - jnext).max() <= DENSE_TOL * 255
    assert nxt.shape == (3, 80, 100)
    w = level0["gray"].shape[2]
    for i in range(3):
        fin = np.isfinite(jvals[i])
        jmap = dict(zip((jrows[i] * w + jcols[i])[fin], jtheta[i][fin]))
        tfin = torch.isfinite(vals[i]).numpy()
        codes = (rows[i] * w + cols[i]).numpy()[tfin]
        both = [k for k, c in enumerate(codes) if c in jmap]
        assert len(both) >= 0.99 * fin.sum()
        d = theta[i].numpy()[tfin][both] - np.array(
            [jmap[codes[k]] for k in both])
        d = np.abs(np.angle(np.exp(1j * d)))
        assert np.quantile(d, 0.99) <= 1e-4


def test_pack_candidates_codes_and_counts():
    vals = torch.tensor([[3.0, 1.0, -np.inf, -np.inf],
                         [2.0, -np.inf, -np.inf, -np.inf]])
    rows = torch.tensor([[1, 0, 0, 0], [2, 0, 0, 0]])
    cols = torch.tensor([[2, 5, 0, 0], [0, 0, 0, 0]])
    codes, cnt = tmsop.pack_candidates(vals, rows, cols, 10)
    jc, jn = jmsop._pack_candidates(jnp.asarray(vals.numpy()),
                                    jnp.asarray(rows.numpy()),
                                    jnp.asarray(cols.numpy()), w=10)
    assert codes.dtype == torch.int32 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(codes.numpy(),
                                  [[12, 5, -1, -1], [20, -1, -1, -1]])
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jn))


def test_descriptors_match_jax(level0):
    """From JAX's blurred map and keypoints (some on the border, where
    taps are clipped and samples outside the image read zero)."""
    _, jrows, jcols, jtheta, jblur, _ = level0["level"]
    rows = jrows[:, :400].copy()
    cols = jcols[:, :400].copy()
    h, w = jblur.shape[1:]
    rows[:, :4] = [0, 1, h - 1, h - 2]
    cols[:, 4:8] = [0, 2, w - 1, w - 3]
    theta = jtheta[:, :400]
    ref = np.asarray(jax.vmap(jmsop._oriented_descriptors)(
        jnp.asarray(jblur), jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(theta)))
    out = tmsop.oriented_descriptors(_t(jblur), _t(rows).long(),
                                     _t(cols).long(), _t(theta)).numpy()
    assert out.shape == (3, 400, 64)
    _desc_close(out, ref)
    # population std: each descriptor has unit mean square
    np.testing.assert_allclose((out ** 2).mean(axis=-1), 1.0, atol=1e-3)


def test_level_descriptors_gather_and_mask(level0):
    lvl = convert.msop_level_from_jax(level0["level"])
    _, rows, cols, theta, blurred, _ = lvl
    idx = torch.tensor([[5, 3, 0, 0], [1, 0, 0, 0], [7, 8, 9, 0]])
    kcnt = torch.tensor([2, 1, 3], dtype=torch.int32)
    kp, desc, valid = tmsop.level_descriptors(blurred, rows, cols, theta,
                                              idx, kcnt, 2.0)
    jkp, jdesc, jvalid = jmsop._level_descriptors_device(
        *(jnp.asarray(a) for a in (level0["level"][4], level0["level"][1],
                                   level0["level"][2], level0["level"][3],
                                   idx.numpy(), kcnt.numpy())),
        jnp.float32(2.0))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))
    _desc_close(desc.numpy(), np.asarray(jdesc))


@pytest.mark.parametrize("n_points", [10, 100, 700])
def test_ssc_native_python_and_jax_agree(n_points, monkeypatch):
    assert native.loaded()
    rng = np.random.default_rng(n_points)
    kp = np.stack([rng.integers(0, 200, 3000),
                   rng.integers(0, 160, 3000)], axis=1).astype(np.float32)
    nat = tmsop.ssc(kp, (200, 160), n_points)
    with monkeypatch.context() as mp:       # no library: the Python path
        mp.setattr(native, "ssc_select", lambda *a, **k: None)
        py = tmsop.ssc(kp, (200, 160), n_points)
    ref = jmsop.ssc(kp, (200, 160), n_points)
    np.testing.assert_array_equal(nat, py)
    np.testing.assert_array_equal(nat, ref)
    assert len(nat) > 0


def test_ssc_few_points_keeps_all():
    kp = np.zeros((5, 2), np.float32)
    np.testing.assert_array_equal(tmsop.ssc(kp, (10, 10), 8), np.arange(5))


# ---------------------------------------------------------------------------
# The whole extraction
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def extraction():
    imgs = _scene(n=2, shape=(120, 160), seed=4)
    with jax.disable_jit():
        eager = jmsop.msop_extract_device(imgs)
    jitted = jmsop.msop_extract_device(imgs)
    stats = {}
    port = tmsop.msop_extract_device(_t(np.stack(imgs)), stats=stats)
    return dict(imgs=imgs, eager=eager, jitted=jitted, port=port,
                stats=stats)


def test_extraction_keypoints_equal_in_order(extraction):
    jk, tk = extraction["eager"][0], extraction["port"][0]
    for a, b in zip(jk, tk):
        assert a.dtype == b.dtype == np.float32 and len(a) > 500
        np.testing.assert_array_equal(a, b)


def test_extraction_device_buffers_match(extraction):
    _, jkp, jds, jva, jcnt = extraction["eager"]
    _, kp, ds, va, cnt = extraction["port"]
    jva = np.asarray(jva)
    np.testing.assert_array_equal(va.numpy(), jva)
    np.testing.assert_array_equal(cnt, np.asarray(jcnt))
    assert cnt.dtype == np.int32
    np.testing.assert_array_equal(kp.numpy()[jva], np.asarray(jkp)[jva])
    _desc_close(ds.numpy()[jva], np.asarray(jds)[jva])
    # the valid rows are the host keypoint list, in order
    for i, k in enumerate(extraction["port"][0]):
        np.testing.assert_array_equal(kp.numpy()[i][jva[i]], k)


def test_extraction_against_jitted_jax(extraction):
    """XLA's fused Harris differs by an ulp: near-ties may flip."""
    for a, b in zip(extraction["jitted"][0], extraction["port"][0]):
        ours = {tuple(x) for x in b}
        hit = np.mean([tuple(x) in ours for x in a])
        assert hit >= 0.99, hit
        assert abs(len(a) - len(b)) <= 0.01 * len(a)


def test_extraction_stats(extraction):
    st = extraction["stats"]
    total = sum(len(k) for k in extraction["port"][0])
    assert sum(st["keypoints"]) == total
    assert all(c >= k for c, k in zip(st["candidates"], st["keypoints"]))
    assert st["ssc_seconds"] >= 0.0


def test_extraction_of_black_images_is_empty_but_shaped():
    black = torch.zeros((2, 64, 80, 3), dtype=torch.uint8)
    # a constant image ties everywhere: every pixel is a candidate; a
    # budget of 0 keeps none
    kpts, kp, ds, va, cnt = tmsop.msop_extract_device(black,
                                                      max_feat=(0, 0))
    assert [k.shape for k in kpts] == [(0, 2), (0, 2)]
    assert kp.shape == (2, 64, 2) and ds.shape == (2, 64, 64)
    assert va.shape == (2, 64) and not va.any() and cnt.tolist() == [0, 0]


def test_mixed_shapes_run_per_bucket():
    """Two sizes: each image's features are those of its own bucket run
    alone, back in the input order."""
    imgs = _scene(n=3, shape=(120, 160), seed=6, flat=False)
    imgs[1] = np.ascontiguousarray(imgs[1][:100, :140])
    feats = tpipe.msop_extract(imgs, torch.device("cpu"))
    for i in range(3):
        alone = tpipe.msop_extract([imgs[i]], torch.device("cpu"))
        np.testing.assert_array_equal(feats.kpts[i], alone.kpts[0])
        k = len(alone.kpts[0])
        assert int(feats.counts[i]) == k and feats.valid[i].sum() == k
        np.testing.assert_array_equal(feats.kp[i, :k].numpy(),
                                      alone.kp[0, :k].numpy())
        np.testing.assert_array_equal(feats.kp[i, :k].numpy(),
                                      feats.kpts[i])
        assert torch.allclose(feats.desc[i, :k], alone.desc[0, :k],
                              atol=1e-6)
    h, w = imgs[1].shape[:2]
    assert np.abs(feats.kpts[1][:, 0]).max() <= w / 2
    assert np.abs(feats.kpts[1][:, 1]).max() <= h / 2


# ---------------------------------------------------------------------------
# --detector msop through both CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_msop")
    imgs, rots, focal = synth.make_views(n_views=3, shape=(180, 240),
                                         overlap=0.5, seed=13)
    ds = root / "views"
    synth.write_dataset(str(ds), imgs)
    jdir = root / "jax"
    jdir.mkdir()
    mosaic = jcli.run(jcli.build_parser().parse_args(
        [str(ds), "-s", "1", "--detector", "msop", "--cache-dir",
         str(jdir)]))
    u8 = jcli.load_images(str(ds), 1)
    kpts, matches = convert.matches_from_npz(
        str(jdir / f"matches_{NAME}.npz"))
    with open(jdir / f"ba_{NAME}.pkl", "rb") as fid:
        regions = pickle.load(fid)
    return dict(root=root, u8=u8, mosaic=mosaic, kpts=kpts, matches=matches,
                regions=regions, jdir=jdir, rots=rots, focal=focal,
                extracted=jmsop.msop_extract_device(u8))


def test_msop_match_graph_matches_jax(ref):
    """JAX's MSOP features and RANSAC draws in: the same keypoint lists,
    the same edges with the same inlier indices, homographies to 1e-4."""
    feats = convert.msop_features_from_jax(ref["extracted"], (180, 240))
    assert feats.desc.shape[-1] == 64
    kpts, matches = tpipe.matching(ref["u8"], "cpu", feats=feats,
                                   detector="msop", draw_fn=jax_draw_fn(3))
    for a, b in zip(kpts, ref["kpts"]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    tm, jm = matches.item(), ref["matches"].item()
    assert sorted(tm) == sorted(jm)
    n_edges = 0
    for i in jm:
        assert sorted(tm[i]) == sorted(jm[i])
        for j in jm[i]:
            np.testing.assert_array_equal(tm[i][j][0], jm[i][j][0])
            assert tm[i][j][0].dtype == np.int32
            h_t, h_j = tm[i][j][1], jm[i][j][1]
            assert h_t.dtype == np.float64
            assert np.abs(h_t - h_j).max() / np.abs(h_j).max() <= 1e-4
            n_edges += 1
    assert n_edges >= 4


@pytest.fixture(scope="module")
def port_run(ref):
    cache = ref["root"] / "port"
    cache.mkdir()
    args = tcli.build_parser().parse_args(
        [str(ref["root"] / "views"), "-s", "1", "--detector", "msop",
         "--cache-dir", str(cache), "--device", "cpu"])
    timer = tcli.StageTimer()
    mosaic = tcli.run_images(ref["u8"], args, NAME, timer,
                             draw_fn=jax_draw_fn(3))
    return args, mosaic, timer


def test_cli_msop_matches_jax(ref, port_run):
    _, mosaic, timer = port_run
    assert mosaic.dtype == np.uint8 and mosaic.shape == ref["mosaic"].shape
    assert _psnr(mosaic, ref["mosaic"]) >= 40.0
    assert len(timer.extra["candidates"]) == 4


def test_cli_msop_cache_structure_and_registration(ref, port_run):
    args, _, _ = port_run
    kpts, matches = convert.matches_from_npz(
        f"{args.cache_dir}/matches_{NAME}.npz")
    assert kpts.dtype == object and len(kpts) == 3
    for a, b in zip(kpts, ref["kpts"]):
        assert a.dtype == np.float32 and a.shape[1] == 2
        assert abs(len(a) - len(b)) <= 0.01 * len(b)
    tm, jm = matches.item(), ref["matches"].item()
    # two independent runs: the adjacent views are joined in both (a weak
    # edge between the end views may pass RANSAC's gate in one only)
    edges = {(i, j) for i in tm for j in tm[i]}
    assert {(0, 1), (1, 0), (1, 2), (2, 1)} <= edges
    assert edges <= {(i, j) for i in range(3) for j in range(3)}
    for i in tm:
        for j, (m, hom) in tm[i].items():
            assert m.dtype == np.int32 and m.shape[1] == 2
            assert hom.shape == (3, 3) and hom.dtype == np.float64
            np.testing.assert_array_equal(tm[j][i][0], np.fliplr(m))
    regs = tcli.load_ba_cache(f"{args.cache_dir}/ba_{NAME}.pkl")
    assert len(regs) == 3
    assert abs(regs[0].intr[0, 0] - ref["focal"]) / ref["focal"] < 0.05
    for i in range(2):
        est = regs[i + 1].rot @ regs[i].rot.T
        true = ref["rots"][i + 1] @ ref["rots"][i].T
        assert np.degrees(_rot_err(est, true)) < 1.0


def test_cli_msop_from_caches_reproduces(ref, port_run):
    args, mosaic, _ = port_run
    np.testing.assert_array_equal(tcli.run(args), mosaic)


# ---------------------------------------------------------------------------
# the registration of an MSOP match graph, both packages on the same draws
# ---------------------------------------------------------------------------

def jax_traverse_counted(u8, matches, badjust="incr"):
    """The JAX package's ``traverse`` with the iterations of its LM loops
    reported by a host callback on each loop's final state (a fresh jit
    of ``_traverse_impl`` traced with a counting ``while_loop``): ->
    (regions, the fixed-lambda loops' counts, the polish loop's count).
    Padding adds optimise too, so only the first ``placed - 1`` counts
    are kept."""
    core, polish = [], []
    orig_loop, orig_kernel = jax.lax.while_loop, jreg._traverse_kernel

    def counting(cond, body, state):
        out = orig_loop(cond, body, state)
        if isinstance(state, tuple) and len(state) in (5, 6):
            log = core if len(state) == 5 else polish
            jax.debug.callback(lambda it: log.append(int(it)), out[0],
                               ordered=True)
        return out
    jax.lax.while_loop = counting
    # a partial of its own: jit caches by function, and a program traced
    # earlier with the plain loop would be reused
    jreg._traverse_kernel = jax.jit(
        functools.partial(jreg._traverse_impl),
        static_argnames=("mode", "use_straighten", "max_iter", "polish",
                         "axis_name", "gsize"))
    try:
        regs = jreg.traverse(u8, matches, badjust=badjust)
        jax.effects_barrier()
    finally:
        jax.lax.while_loop, jreg._traverse_kernel = orig_loop, orig_kernel
    return regs, core[:max(len(regs) - 1, 0)], polish


def jax_first_lm_stepwise(u8, matches):
    """The first add's fixed-lambda LM of the JAX package, stepped from
    the host with the package's own jitted pieces (``_lm_stats_local``,
    ``_loss_stats_local``) under ``_lm_core``'s acceptance rule, outside
    the fused ``while_loop``: -> (iterations, the losses, the largest
    condition number of the preconditioned normal matrix). The fused loop
    and this one differ only in how XLA compiles the same arithmetic."""
    from pano360_tpu import geometry as jgeo
    saved = {}

    class _Captured(Exception):
        pass

    def capture(*ops, **kw):
        saved.update(ops=ops, gsize=kw["gsize"])
        raise _Captured
    orig = jreg._traverse_kernel
    jreg._traverse_kernel = capture
    try:
        jreg.traverse(u8, matches)
    except _Captured:
        pass
    finally:
        jreg._traverse_kernel = orig
    (params, seed_idx, place_dst, place_src, homs, homs_all, _, cam1, cam2,
     pts, mask, edge_add) = saved["ops"]
    gsize = saved["gsize"]
    intr = jgeo.intrinsics(jreg._median_focal(homs_all)).astype(jnp.float32)
    lead = jnp.stack([intr[0, 0], intr[0, 2], intr[1, 2]])
    params = params.at[seed_idx, :3].set(lead)
    r_rel = jgeo.nearest_rotation(
        jgeo.mm(jgeo.mm(jgeo.inv3x3(intr), homs[0]), intr))
    r_src = jgeo.exp_so3(params[place_src[0], 3:6])
    params = params.at[place_dst[0]].set(
        jnp.concatenate([lead, jgeo.log_so3(jgeo.mm(r_rel, r_src))]))
    m = mask * (edge_add == 0)[:, None]

    def loss_of(p):
        sq, n = jreg._loss_stats_local(p, cam1, cam2, pts, m, None, gsize)
        return np.float32(jnp.sqrt(sq / jnp.maximum(n, 1.0)))
    best, best_err = params, loss_of(params)
    losses, conds = [float(best_err)], []
    for _ in range(jreg.LM_MAX_ITER):
        _, _, jtj, jtr = jreg._lm_stats_local(best, cam1, cam2, pts, m, None,
                                              gsize)
        a = jtj + jreg.LM_LAMBDA * jnp.eye(jtj.shape[0], dtype=jtj.dtype)
        d = jax.lax.rsqrt(jnp.diagonal(a) + 1e-12)
        a = a * d[:, None] * d[None, :]
        if not bool(jnp.isfinite(a).all()):      # degenerate cameras
            break
        conds.append(float(np.linalg.cond(np.asarray(a, np.float64))))
        trial = best - (jnp.linalg.solve(a, jtr * d) * d).reshape(best.shape)
        err = loss_of(trial)
        losses.append(float(err))
        if not err < best_err - np.float32(jreg.LM_MIN_IMPROVE):
            break
        best, best_err = trial, err
    return len(losses) - 1, losses, max(conds, default=float("nan"))


def registration_errors(regs, rots, focal):
    """(largest relative focal error, mean relative-rotation error in
    degrees between consecutive views) against the synthetic truth, for
    regions that hold every view in order."""
    f_err = max(abs(r.intr[0, 0] - focal) / focal for r in regs)
    ang = [np.degrees(_rot_err(regs[i + 1].rot @ regs[i].rot.T,
                               rots[i + 1] @ rots[i].T))
           for i in range(len(regs) - 1)]
    return float(f_err), float(np.mean(ang))


def _graph(matches):
    m = matches.item()
    return {(i, j): len(m[i][j][0]) for i in m for j in m[i] if i < j}


def registration_parity(n_views, shape, overlap, seed, shrink=1,
                        draw_seed=0):
    """``--detector msop --ba incr`` on a synthetic sweep through both
    packages on the CPU, with the same RANSAC draws: the JAX package
    whole; the port on its own features and on JAX's (the latter must
    give JAX's edges between overlapping views; the others hang on 4-7
    inliers and can change with the rounding of a matrix product, for
    one with the number of threads); then both bundle adjustments on
    JAX's match graph. -> a dict of what to compare. A pair of views
    "overlaps" when the true angle between them is under 0.7 of the
    horizontal field of view."""
    imgs, rots, focal = synth.make_views(n_views=n_views, shape=shape,
                                         overlap=overlap, seed=seed)
    u8 = tcli.shrink_images([(im * 255).astype(np.uint8) for im in imgs],
                            shrink, torch.device("cpu"))
    focal = focal / shrink
    h, w = u8[0].shape[:2]
    n_pairs = n_views * (n_views - 1) // 2
    fov = 2 * np.arctan(w / 2 / focal)
    overlapping = {(i, j) for i in range(n_views)
                   for j in range(i + 1, n_views)
                   if _rot_err(rots[i], rots[j]) < 0.7 * fov}
    out = dict(views=n_views, shape=(h, w), pairs=n_pairs,
               overlapping_pairs=len(overlapping))

    clock = [time.time()]

    def lap():
        clock.append(time.time())
        return round(clock[-1] - clock[-2], 1)
    extracted = jmsop.msop_extract_device(u8)
    jk, jm = jpipe.matching(u8, detector="msop", seed=draw_seed)
    secs = dict(jax_extract_match=lap())
    draws = jax_draw_fn(n_pairs, draw_seed)
    feats = convert.msop_features_from_jax(extracted, (h, w))
    _, tm = tpipe.matching(u8, "cpu", feats=feats, detector="msop",
                           draw_fn=draws)
    own = tpipe.msop_extract(u8, torch.device("cpu"))
    ok, om = tpipe.matching(u8, "cpu", feats=own, detector="msop",
                            draw_fn=draws)
    secs["port_extract_match_twice"] = lap()
    jg, tg, og = _graph(jm), _graph(tm), _graph(om)
    common = [len({tuple(p) for p in a.tolist()}
                  & {tuple(p) for p in b.tolist()}) / max(len(b), 1)
              for a, b in zip(ok, jk)]
    out.update(
        keypoints_jax=[len(k) for k in jk],
        keypoints_port=[len(k) for k in ok],
        keypoints_common_min=min(common),
        edges_jax=len(jg), edges_port_on_jax_features=len(tg),
        edges_port_own_features=len(og),
        graph_equal_on_jax_features=(jg == tg),
        true_edges_equal_on_jax_features=(
            {e: c for e, c in jg.items() if e in overlapping}
            == {e: c for e, c in tg.items() if e in overlapping}),
        edges_differing_own_features=sorted(set(jg) ^ set(og)),
        false_edges_jax=len(set(jg) - overlapping),
        false_edges_port_own=len(set(og) - overlapping),
        missing_true_edges_jax=sorted(overlapping - set(jg)),
        inliers_true_edges_jax=sorted(jg[e] for e in set(jg) & overlapping),
        inliers_false_edges_jax=sorted(jg[e] for e in set(jg) - overlapping),
        inliers_false_edges_port_own=sorted(
            og[e] for e in set(og) - overlapping))

    graph = jpipe.idx_to_keypoints(jm, jk)
    stats = {}
    try:
        t_regs = treg.traverse(u8, tpipe.idx_to_keypoints(jm, jk),
                               device="cpu", stats=stats)
    except torch.linalg.LinAlgError as exc:   # non-finite cameras
        t_regs = []
        out["port_traverse_error"] = repr(exc)[:120]
    secs["port_traverse"] = lap()
    j_regs, j_core, j_polish = jax_traverse_counted(u8, graph)
    secs["jax_traverse"] = lap()
    first_n, first_losses, first_cond = jax_first_lm_stepwise(u8, graph)
    out.update(placed_jax=len(j_regs), placed_port=len(t_regs),
               lm_iterations_jax=j_core, polish_iterations_jax=j_polish,
               lm_first_jax_stepped_from_host=first_n,
               lm_first_jax_stepped_final_loss=first_losses[-2:],
               lm_first_normal_matrix_cond_max=first_cond,
               lm_iterations_port=stats.get("lm_iterations"),
               polish_iterations_port=stats.get("polish_iterations"),
               ba_edges=stats.get("ba_edges"),
               ba_edges_enabled=stats.get("ba_edges_enabled"),
               cpu_seconds=secs, focal_true=float(focal),
               focal0_port=stats.get("focal0"),
               focal_jax=[float(r.intr[0, 0]) for r in j_regs],
               focal_port=[float(r.intr[0, 0]) for r in t_regs])
    if len(j_regs) == len(t_regs) == n_views:
        out.update(errors_jax=registration_errors(j_regs, rots, focal),
                   errors_port=registration_errors(t_regs, rots, focal),
                   rot_port_vs_jax_deg=max(
                       np.degrees(_rot_err(a.rot, b.rot))
                       for a, b in zip(t_regs, j_regs)))
    return out


def test_registration_parity_on_the_same_draws():
    """A small sweep through ``registration_parity``: JAX's features and
    draws give the port JAX's edges between overlapping views (inlier
    counts included; an edge between views that share no pixel hangs on
    4-7 inliers of an ill-conditioned fit and can differ), both
    bundle adjustments of that graph place every view and agree (focal
    1e-3 relative, rotations 0.01 deg), and the port's first LM runs as
    many iterations as the JAX package's own pieces stepped from the host
    (+-2: the two are the same f32 arithmetic up to rounding; JAX's fused
    loop may stop elsewhere on an ill-conditioned system, which is why it
    is reported and not held)."""
    out = registration_parity(3, (180, 240), 0.5, 13)
    assert out["true_edges_equal_on_jax_features"]
    assert out["missing_true_edges_jax"] == []
    assert out["placed_jax"] == out["placed_port"] == 3
    assert abs(out["lm_iterations_port"][0]
               - out["lm_first_jax_stepped_from_host"]) <= 2
    assert len(out["lm_iterations_jax"]) == len(out["lm_iterations_port"])
    assert all(1 <= it <= treg.LM_MAX_ITER
               for it in out["lm_iterations_port"])
    (fj, rj), (ft, rt) = out["errors_jax"], out["errors_port"]
    assert abs(fj - ft) <= 1e-3 and abs(rj - rt) <= 0.01
    assert out["rot_port_vs_jax_deg"] <= 0.01
    assert out["keypoints_common_min"] >= 0.99


def test_reverse_homography_of_a_singular_edge():
    """An edge whose homography is exactly singular (several keypoints
    matched to one; found on the 15-view MSOP world, where JAX's is
    singular only up to rounding) gets a finite reverse homography
    instead of ending the run; a regular one gets its inverse."""
    hom = np.array([[0.821340024471283, 0.0, 331.0],
                    [-1.0719603300094604, 0.0, -432.0],
                    [0.002481389557942748, 0.0, 1.0]])
    with pytest.raises(np.linalg.LinAlgError):
        np.linalg.inv(hom)
    rev = tpipe.reverse_homography(hom)
    assert rev.shape == (3, 3) and np.isfinite(rev).all()
    good = np.array([[1.02, 0.01, 5.0], [-0.02, 0.98, -3.0],
                     [1e-5, 2e-5, 1.0]])
    np.testing.assert_array_equal(tpipe.reverse_homography(good),
                                  np.linalg.inv(good))


def test_cli_mesh_still_raises(tmp_path, monkeypatch):
    """``--mesh 4 --device cpu`` hands the run to four ranks, and
    ``--mesh 1`` takes the one-process path (here it ends as any run
    without a match graph does)."""
    from pano360_tpu_torch.parallel import mesh as tmesh
    calls = []

    def fake_launch(fn, n, device, *args):
        calls.append((fn, n, torch.device(device).type))
        return np.zeros((4, 4, 3), np.uint8), {}, {}
    monkeypatch.setattr(tmesh, "launch", fake_launch)
    imgs = [np.zeros((8, 8, 3), np.uint8)] * 2
    parse = tcli.build_parser().parse_args
    args = parse([str(tmp_path), "--mesh", "4", "--device", "cpu",
                  "--cache-dir", str(tmp_path)])
    assert tcli.run_images(imgs, args, "x").shape == (4, 4, 3)
    assert calls == [(tcli._stitch, 4, "cpu")]
    args = parse([str(tmp_path), "--mesh", "1", "--device", "cpu",
                  "--cache-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="match graph is empty"):
        tcli.run_images(imgs, args, "y")
    assert len(calls) == 1


def test_refit_homography_survives_a_pair_without_inliers():
    """A pair whose best hypothesis has no inlier (all weights zero) has
    no finite system: the JAX package returns a non-finite homography and
    its caller keeps the best hypothesis. The port must do the same for
    that pair and still refit the others of its batch (torch.linalg.solve
    raises for the whole batch on a singular or non-finite matrix)."""
    from pano360_tpu_torch import match as tmatch
    rng = np.random.default_rng(8)
    p1 = (rng.random((2, 40, 2)) * 200 - 100).astype(np.float32)
    hom = np.array([[1.02, 0.01, 5.0], [-0.02, 0.98, -3.0],
                    [1e-5, 2e-5, 1.0]], np.float32)
    q = np.concatenate([p1, np.ones((2, 40, 1), np.float32)], -1) @ hom.T
    p2 = (q[..., :2] / q[..., 2:]).astype(np.float32)
    w = np.ones((2, 40), np.float32)
    w[0] = 0.0
    out = tmatch.refit_homography(_t(p1), _t(p2), _t(w)).numpy()
    ref = np.stack([np.asarray(jmatch.refit_homography(
        jnp.asarray(p1[i]), jnp.asarray(p2[i]), jnp.asarray(w[i])))
        for i in range(2)])
    assert not np.isfinite(out[0]).all() and not np.isfinite(ref[0]).all()
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out[1], hom, rtol=1e-3, atol=1e-3)
    # through RANSAC: no valid match at all in one pair of the batch
    valid = np.ones((2, 40), bool)
    valid[0] = False
    draws = torch.as_tensor(rng.integers(0, 40, (2, 64, 4)))
    draws[0] = 0
    h, inl, n = tmatch.ransac_homography(_t(p1), _t(p2), _t(valid), draws)
    assert int(n[0]) == 0 and int(n[1]) == 40
    np.testing.assert_allclose(h[1].numpy(), hom, rtol=1e-3, atol=1e-3)


if __name__ == "__main__":
    # the comparison at any size, e.g. the 5-view MSOP world at full size:
    #   PYTHONPATH=. python tests/test_torch_msop.py --views 5 --shape 864 1152 \
    #       --overlap 0.5 --seed 13
    import argparse
    import json
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=registration_parity.__doc__)
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--shape", type=int, nargs=2, default=(864, 1152))
    ap.add_argument("--overlap", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--shrink", type=float, default=1)
    ap.add_argument("--draw-seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    ns = ap.parse_args()
    torch.set_num_threads(ns.threads)
    print(json.dumps(registration_parity(
        ns.views, tuple(ns.shape), ns.overlap, ns.seed, ns.shrink,
        ns.draw_seed)))
