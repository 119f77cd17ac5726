"""The port's extras held against the JAX package (CPU): the
experimental blenders (``blend_extra``), the drawing helpers (``viz``)
and the feature CLI (``features_cli``).

Same inputs, made from a numpy seed, through both packages. Tolerances:
``warp`` and ``laplacian_blending`` within 1 grey level (uint8 results
of float pipelines that round alike except in the last bit);
``graph_cut`` masks equal; the native seam flood equal to the JAX
package's, and its Python fallback within 5 % of the pixels (a pixel that
both sources reach at one cost goes to the first push in the C++ and to
the left source in the Python, in both packages);
``poisson_blend`` >= 50 dB (two conjugate-gradient runs of 400
iterations whose sums add in different orders); ``viz`` equal (numpy in
both).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pano360_tpu import blend_extra as jblend
from pano360_tpu import geometry as jgeo
from pano360_tpu import synth
from pano360_tpu import viz as jviz

from pano360_tpu_torch import blend_extra as tblend
from pano360_tpu_torch import features_cli as tfcli
from pano360_tpu_torch import geometry as tgeo
from pano360_tpu_torch import native
from pano360_tpu_torch import viz as tviz
from pano360_tpu_torch.features.msop import DSIZE

torch.set_num_threads(1)


def _psnr(a, b):
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float(np.mean(d * d))
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def pair():
    """Two overlapping 160x200 views, their intrinsics, both warped by
    the JAX package, and the overlap strips."""
    imgs, _, focal = synth.make_views(n_views=2, shape=(160, 200),
                                      overlap=0.55, seed=0)
    u8 = [(im * 255).astype(np.uint8) for im in imgs]
    kint = np.asarray(jgeo.intrinsics(jnp.float32(focal), (100.0, 80.0)))
    w1, w2 = jblend.warp(u8[0], kint), jblend.warp(u8[1], kint)
    delta = 108
    return dict(u8=u8, kint=kint, w1=w1, w2=w2, left=w1[:, -delta:],
                right=w2[:, :delta])


@pytest.mark.parametrize("proj", ["SphProj", "CylProj"])
@pytest.mark.parametrize("with_hom", [False, True], ids=["eye", "hom"])
def test_warp_matches_jax(pair, proj, with_hom):
    hom = np.array([[1.0, 0.02, 3.0], [-0.01, 1.0, -2.0],
                    [1e-5, 0.0, 1.0]]) if with_hom else None
    ref = jblend.warp(pair["u8"][0], pair["kint"], hom,
                      getattr(jgeo, proj))
    out = tblend.warp(pair["u8"][0], pair["kint"], hom,
                      getattr(tgeo, proj), device="cpu")
    assert out.dtype == np.uint8 and out.shape == (160, 200, 4)
    assert (out[..., 3] == 0).any() and (out[..., 3] == 255).any()
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_alpha_blend_matches_jax(pair):
    a, b = pair["left"][..., :3], pair["right"][..., :3]
    np.testing.assert_array_equal(tblend.alpha_blend(a, b),
                                  jblend.alpha_blend(a, b))


@pytest.mark.parametrize("shrink", [1, 5])
@pytest.mark.parametrize("rgba", [True, False], ids=["rgba", "rgb"])
def test_graph_cut_masks_equal(pair, shrink, rgba):
    a, b = pair["left"], pair["right"]
    if not rgba:
        a, b = a[..., :3], b[..., :3]
    ref = jblend.graph_cut(a, b, shrink=shrink)
    out = tblend.graph_cut(a, b, shrink=shrink, device="cpu")
    assert out.dtype == np.uint8 and out.shape == a.shape[:2] + (1,)
    np.testing.assert_array_equal(out, ref)
    assert (out == 255).any() and (out == 0).any()


def test_seam_flood_native_and_fallback():
    from pano360_tpu import native as jnative
    assert native.loaded()
    rng = np.random.default_rng(3)
    diff = rng.random((40, 60)).astype(np.float32) * 50
    out = native.seam_flood(diff, 3)
    np.testing.assert_array_equal(out, jnative.seam_flood(diff, 3))
    py = native._seam_flood_py(diff, 3)
    np.testing.assert_array_equal(py, jnative._seam_flood_py(diff, 3))
    assert out.dtype == py.dtype == np.int8
    assert set(np.unique(out)) == set(np.unique(py)) == {-1, 1}
    assert (out == py).mean() >= 0.95


@pytest.mark.parametrize("mask", ["default", "seam"])
def test_laplacian_blending_matches_jax(pair, mask):
    a, b = pair["left"][..., :3], pair["right"][..., :3]
    m = None
    if mask == "seam":
        m = jblend.graph_cut(pair["left"], pair["right"]).astype(
            np.float32) / 255
    ref = jblend.laplacian_blending(a, b, m)
    out = tblend.laplacian_blending(a, b, m, device="cpu")
    assert out.dtype == np.uint8 and out.shape == a.shape
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_poisson_blend_matches_jax(pair):
    src, tgt = pair["left"][..., :3], pair["right"][..., :3].copy()
    mask = jblend.graph_cut(pair["left"], pair["right"]) > 127
    ref = jblend.poisson_blend(src, tgt, mask)
    stats = {}
    out = tblend.poisson_blend(src, tgt, mask, device="cpu", stats=stats)
    assert out.dtype == np.uint8 and out.shape == tgt.shape
    assert _psnr(out, ref) >= 50.0
    assert (stats["residual"] < 1e-3 * stats["residual0"]).all()
    # outside the mask the target is untouched
    keep = ~mask[..., 0]
    np.testing.assert_array_equal(out[keep], tgt[keep])


def test_poisson_cg_channels_are_independent():
    """All channels share one loop but each keeps its own step sizes: a
    channel solved alone gives the same solution."""
    rng = np.random.default_rng(9)
    tgt = torch.tensor(rng.random((3, 24, 30)) * 255, dtype=torch.float32)
    lap = torch.tensor(rng.random((3, 24, 30)), dtype=torch.float32)
    interior = torch.zeros(24, 30, dtype=torch.bool)
    interior[4:20, 5:25] = True
    x, _, _ = tblend.poisson_cg(lap, tgt, interior, iters=60)
    x1, _, _ = tblend.poisson_cg(lap[1:2], tgt[1:2], interior, iters=60)
    assert torch.allclose(x[1], x1[0], atol=1e-3)


def test_demo_and_main(tmp_path):
    stats = {}
    res = tblend.demo(shape=(120, 160), device="cpu", stats=stats)
    delta = 160 * 13 // 24
    assert res["mask"].shape == (120, delta, 1)
    for key in ("laplacian", "poisson"):
        assert res[key].dtype == np.uint8
        assert res[key].shape == (120, delta, 3)
    assert res["blended"].shape == (120, 2 * 160 - delta, 3)
    assert all(w.shape == (120, 160, 4) for w in res["warped"])
    assert (stats["residual"] < stats["residual0"]).all()
    assert {"warp_seconds", "graph_cut_seconds", "laplacian_seconds",
            "poisson_seconds"} <= set(stats)
    out = tmp_path / "demo.png"
    tblend.main(["--device", "cpu", "-o", str(out)])
    from pano360_tpu_torch.imageio import imread
    assert imread(str(out)).shape == (360, 2 * 480 - 260, 3)


# ---------------------------------------------------------------------------
# viz
# ---------------------------------------------------------------------------

def test_viz_equals_jax(pair):
    assert DSIZE == 8
    rng = np.random.default_rng(2)
    img = pair["u8"][0]
    pts = [(50.0, 40.0, 0.3, 1.0), (120.0, 90.0, -1.2, 2.0),
           (198.0, 2.0, 2.0, 4.0)]
    np.testing.assert_array_equal(tviz.plot_points(img, pts),
                                  jviz.plot_points(img, pts))
    descs = rng.standard_normal((30, 64)).astype(np.float32)
    np.testing.assert_array_equal(tviz.plot_descs(descs, 5),
                                  jviz.plot_descs(descs, 5))
    p1 = rng.random((20, 2)) * [200, 160]
    p2 = rng.random((20, 2)) * [200, 160]
    inl = rng.random(20) > 0.3
    np.testing.assert_array_equal(
        tviz.match_images(img, pair["u8"][1], p1, p2, inl),
        jviz.match_images(img, pair["u8"][1], p1, p2, inl))


# ---------------------------------------------------------------------------
# features_cli
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("detector", ["sift", "msop"])
def test_features_cli_writes_cache_and_overlay(tmp_path, monkeypatch,
                                               detector):
    imgs, _, _ = synth.make_views(n_views=2, shape=(240, 320), overlap=0.6,
                                  seed=13)
    ds = tmp_path / "pair"
    synth.write_dataset(str(ds), imgs)
    monkeypatch.chdir(tmp_path)
    tfcli.main(["--path", str(ds), "--detector", detector, "--device",
                "cpu", "--visualize", "0", "1"])
    arr = np.load(tmp_path / "matches_pair.npz", allow_pickle=True)
    kpts, md = arr["kpts"], arr["matches"].item()
    assert len(kpts) == 2 and kpts[0].dtype == np.float32
    # half resolution: centre-relative keypoints of 120x160 images
    assert np.abs(kpts[0][:, 0]).max() <= 80
    idx, hom = md[0][1]
    assert len(idx) >= 10 and hom.shape == (3, 3)
    from pano360_tpu_torch.imageio import imread
    assert imread(str(tmp_path / "matches_pair_0_1.png")).shape == \
        (120, 320, 3)


def test_features_cli_missing_edge_exits(tmp_path, monkeypatch):
    a, _, _ = synth.make_views(n_views=1, shape=(180, 240), seed=31)
    b, _, _ = synth.make_views(n_views=1, shape=(180, 240), seed=77)
    ds = tmp_path / "unrelated"
    synth.write_dataset(str(ds), a + b)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="no match edge"):
        tfcli.main(["--path", str(ds), "--device", "cpu", "--visualize",
                    "0", "1"])
