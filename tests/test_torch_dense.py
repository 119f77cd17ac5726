"""SIFT's ``descr_mode='dense'`` and ``upscale=False`` in the port, held
against the JAX package on the CPU.

The dense descriptor (cv2's integer window) on the same numpy-seeded
gradient patches, positions, scales and angles as the JAX function,
``jax.vmap``'d as ``sift_extract`` calls it: within 1e-5. The whole
extraction with ``descr_mode='dense'``, and with ``upscale=False``, on
the same small images: the keypoint sets equal (to f32 rounding) and the
descriptors of the same keypoints within 1e-5 for 80 % of them and 1e-4
for 99 % (``_hold``). ``PANO_SIFT_DESCR=dense`` reaches the
port's default configuration, as it reaches the JAX package's.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pano360_tpu import synth
from pano360_tpu.features import sift as jsift

from pano360_tpu_torch.features import sift as tsift

from jax_grid_turn import port_grid

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _port_grid():
    """The JAX package's grid descriptor turned as the port's
    (``jax_grid_turn``) for every JAX run of this module."""
    with port_grid():
        yield


TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _patch_inputs(seed, k=8, n_ori=2, psg=80):
    rng = np.random.default_rng(seed)
    gx = (rng.standard_normal((k, psg, psg)) * 0.05).astype(np.float32)
    gy = (rng.standard_normal((k, psg, psg)) * 0.05).astype(np.float32)
    yf = rng.uniform(30, 110, k).astype(np.float32)
    xf = rng.uniform(30, 110, k).astype(np.float32)
    cy = (np.round(yf) - 41 + rng.integers(-3, 4, k)).astype(np.int32)
    cx = (np.round(xf) - 41 + rng.integers(-3, 4, k)).astype(np.int32)
    sig = rng.uniform(1.6, 3.6, k).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, (k, n_ori)).astype(np.float32)
    # some keypoints near the border: the in-image mask cuts the window
    oh = rng.choice([90, 140], k).astype(np.int32)
    ow = rng.choice([100, 150], k).astype(np.int32)
    return gx, gy, yf, xf, cy, cx, sig, ang, oh, ow


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_descriptor_matches_jax(seed):
    args = _patch_inputs(seed)
    cfg = jsift.SiftConfig(descr_mode="dense")
    one = jax.vmap(
        lambda *a: jsift._descriptor_from_patch_dense(*a, cfg),
        in_axes=(None,) * 7 + (0, None, None))
    ref = np.asarray(jax.vmap(one, in_axes=(0,) * 10)(
        *[jnp.asarray(a) for a in args]))
    gx, gy, yf, xf, cy, cx, sig, ang, oh, ow = (_t(a) for a in args)
    out = tsift._descriptors_dense(
        gx, gy, yf, xf, cy.long(), cx.long(), sig, ang, oh.long(),
        ow.long(), tsift.SiftConfig(descr_mode="dense")).numpy()
    assert out.shape == ref.shape == (8, 2, 128)
    np.testing.assert_allclose(out, ref, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0,
                               rtol=1e-5)


def _gray(n, shape, seed):
    imgs, _, _ = synth.make_views(n_views=n, shape=shape, overlap=0.5,
                                  seed=seed)
    return np.stack([im.mean(-1) for im in imgs]).astype(np.float32)


KP = 128


def _extract_both(gray, **kw):
    jf = jsift.sift_extract(jnp.asarray(gray), jsift.SiftConfig(
        max_kpts=KP, gauss_mode="incremental", cand_topk="exact", **kw))
    tf = tsift.sift_extract(_t(gray), tsift.SiftConfig(max_kpts=KP, **kw))
    return jf, tf


def _hold(jf, tf):
    """Keypoint sets equal per image (as many, and each of either set has
    its counterpart in the other): positions within 3e-3 px and angles
    within 1e-3 rad (the scale spaces agree to f32
    rounding, and an orientation peak's interpolation magnifies it: the
    largest gaps measured are 2.1e-3 px and 4.8e-4 rad, one keypoint in
    about 200). The descriptors of the same keypoints: 99 % within 1e-4
    (the grid test's bar, ``test_torch_pipeline.py``) and 80 % within
    1e-5 (measured 84-93 %, for the grid descriptor as for the dense one;
    given the same gradient patches the dense descriptor is within 1e-5,
    ``test_dense_descriptor_matches_jax``). -> the number of keypoints."""
    errs = []
    for i in range(np.asarray(jf.valid).shape[0]):
        jv, tv = np.asarray(jf.valid[i]), tf.valid[i].numpy()
        jxy, txy = np.asarray(jf.xy[i])[jv], tf.xy[i].numpy()[tv]
        jang, tang = np.asarray(jf.angle[i])[jv], tf.angle[i].numpy()[tv]
        assert len(jxy) == len(txy) > 20
        d2 = ((jxy[:, None] - txy[None]) ** 2).sum(-1)
        dang = np.abs(np.angle(np.exp(1j * (jang[:, None] - tang[None]))))
        cost = np.where(d2 < 9e-6, dang, np.inf)
        best = cost.argmin(axis=1)
        assert (cost[np.arange(len(jxy)), best] < 1e-3).all()
        assert (cost.min(axis=0) < 1e-3).all()          # and the other way
        errs.append(np.abs(np.asarray(jf.desc[i])[jv]
                           - tf.desc[i].numpy()[tv][best]).max(axis=1))
    errs = np.concatenate(errs)
    assert (errs <= 1e-4).mean() >= 0.99, (errs <= 1e-4).mean()
    assert (errs <= TOL).mean() >= 0.80, (errs <= TOL).mean()
    return len(errs)


@pytest.fixture(scope="module", params=[3, 7], ids=["seed3", "seed7"])
def dense_pair(request):
    gray = _gray(2, (64, 96), request.param)
    return gray, _extract_both(gray, descr_mode="dense")


def test_dense_extraction_matches_jax(dense_pair):
    _, (jf, tf) = dense_pair
    assert _hold(jf, tf) > 2 * 40


def test_dense_keypoints_equal_grid_keypoints(dense_pair):
    """The descriptor mode does not change detection."""
    gray, (_, dense) = dense_pair
    grid = tsift.sift_extract(_t(gray), tsift.SiftConfig(max_kpts=KP))
    torch.testing.assert_close(dense.valid, grid.valid, rtol=0, atol=0)
    torch.testing.assert_close(dense.xy, grid.xy, rtol=0, atol=0)
    # the orientation histogram sums a wider patch: f32 rounding apart
    torch.testing.assert_close(dense.angle, grid.angle, rtol=0, atol=1e-4)
    assert not torch.equal(dense.desc, grid.desc)


@pytest.mark.parametrize("descr_mode", ["grid", "dense"])
def test_upscale_false_matches_jax(descr_mode):
    gray = _gray(2, (96, 128), 5)
    jf, tf = _extract_both(gray, upscale=False, descr_mode=descr_mode)
    assert _hold(jf, tf) > 40
    assert tsift.n_octaves_for((96, 128), False) == \
        jsift.n_octaves_for((96, 128), False) == 5


def test_env_reaches_default_config(monkeypatch):
    monkeypatch.setenv("PANO_SIFT_DESCR", "dense")
    cfg = tsift.SiftConfig()
    assert cfg.descr_mode == "dense" and cfg.patch_half == 40
    monkeypatch.delenv("PANO_SIFT_DESCR")
    assert tsift.SiftConfig().descr_mode == "grid"
    assert tsift.SiftConfig().patch_half == 32
