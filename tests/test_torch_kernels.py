"""The port's CUDA kernels and their wrappers, and the registration's
replayed CUDA graphs (no jax in this file).

On a CPU tensor each wrapper must take its plain PyTorch version and
launch nothing; on another device it must raise. The ``gpu`` tests hold
each CUDA kernel to its plain version on the card and skip without one;
they run on a GPU machine (which has no jax) with
``python -m pytest --noconftest tests/test_torch_kernels.py``.

Tolerances on the card: Gaussian and DoG layers 1e-5 (separate
multiply and add in both versions; the kernel is built with
-fmad=false), score flips <= 0.1% of candidates; both warps (exact and
mip-sampled) bit for bit, patches and masks (the same products summed
in the same order, -fmad=false, IEEE divisions, the accurate sinf, cosf
and tanf); SIFT's front end (the base image, the small octaves) bit for
bit, every output plane; the multiband blend's blur bit for bit, and the
blend with it bit for bit the blend with the plain blur.
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pano360_tpu_torch import _kernels, render
from pano360_tpu_torch import synth
from pano360_tpu_torch._kernels import LAUNCHES
from pano360_tpu_torch.features import sift as S
from pano360_tpu_torch.measure import knn2_inputs, knn2_misses
from pano360_tpu_torch.ops import gauss_octave as G
from pano360_tpu_torch.ops import sift_front as F
from pano360_tpu_torch.ops import sift_tail as T
from pano360_tpu_torch.ops import warp_kernel as W
from pano360_tpu_torch.ops import warp_mip as M
from pano360_tpu_torch.ops.color import bgr2gray
from torch_warp_scenes import (mip_call, mip_scene, mixed_scene,  # noqa: F401
                               regions, warp_scene, warp_setup)

torch.set_num_threads(1)

TAPS = G.chain_taps(1.6, 3)
SCORE_CFG = (0.5 * 0.04 / 3, 10.0, 5)


def _cuda():
    """The card, decided inside the test (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version)")
    return torch.device("cuda")


def _base(shape, n=2, seed=5):
    imgs, _, _ = synth.make_views(n_views=n, shape=shape, seed=seed)
    gray = bgr2gray(torch.as_tensor(np.stack(imgs)))
    return S._base_image(gray, S.SiftConfig()).contiguous()


@pytest.fixture(scope="module")
def octave_base():
    """A 2x256x256 SIFT base image of a synthetic view."""
    return _base((128, 128))


def _on(dev, args):
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args)


# ---------------------------------------------------------------------------
# Wrappers on the CPU
# ---------------------------------------------------------------------------

def test_launch_counts_under_its_name_and_raises_on_an_error(monkeypatch):
    """``_kernels.launch`` calls the library's entry point with its
    arguments: a launch that returns 0 counts once under the entry's name
    without ``p360_``, and a CUDA error code raises and counts nothing."""
    codes, seen = iter([0, 1]), []

    def entry(*args):
        seen.append(args)
        return next(codes)
    monkeypatch.setattr(_kernels, "_LIB",
                        SimpleNamespace(p360_ransac_score=entry))
    monkeypatch.setitem(LAUNCHES, "ransac_score", 0)
    before = dict(LAUNCHES)
    _kernels.launch("p360_ransac_score", 7, 2.0, None)
    assert seen == [(7, 2.0, None)]
    assert LAUNCHES == dict(before, ransac_score=1)
    with pytest.raises(RuntimeError, match="p360_ransac_score: CUDA error 1"):
        _kernels.launch("p360_ransac_score")
    assert len(seen) == 2 and LAUNCHES == dict(before, ransac_score=1)


def test_octave_stack_cpu_tensor_takes_plain_version(octave_base):
    before = LAUNCHES["octave_stack"]
    outs = G.octave_stack(octave_base, TAPS, SCORE_CFG)
    refs = G.octave_stack_ref(octave_base, TAPS, SCORE_CFG)
    for a, b in zip(outs, refs):
        assert torch.equal(a, b)
    assert LAUNCHES["octave_stack"] == before


def test_octave_stack_rejects_unknown_device():
    base = torch.empty((1, 64, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        G.octave_stack(base, TAPS)


def test_octave_stack_ref_refuses_illegal_pad():
    with pytest.raises(ValueError, match="too small"):
        G.octave_stack_ref(torch.zeros((1, 40, 80)), TAPS)


def test_backward_warp_cpu_tensor_takes_plain_version(warp_scene):
    args, wins, period, cyl = warp_scene
    before = LAUNCHES["backward_warp"]
    a = W.backward_warp(*args, wins=wins, period=period, cylindrical=cyl)
    b = W.backward_warp_ref(*args, wins=wins, period=period,
                            cylindrical=cyl)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert LAUNCHES["backward_warp"] == before
    assert (~a[1]).sum() > 1000


def test_backward_warp_mixed_cpu_takes_plain_version(mixed_scene):
    """Per-image true sizes through the wrapper on CPU tensors: the plain
    version's result, no launch; the true sizes change the result."""
    args, kw = mixed_scene
    before = LAUNCHES["backward_warp"]
    out, bad = W.backward_warp(*args, **kw)
    assert LAUNCHES["backward_warp"] == before
    ref, ref_bad = W.backward_warp_ref(*args, **kw)
    assert torch.equal(out, ref) and torch.equal(bad, ref_bad)
    padded, _ = W.backward_warp_ref(*args, **dict(kw, shapes=None))
    assert not torch.equal(padded, ref)
    # the zero padding is never sampled as valid content: alpha is zero
    # wherever the padded stack's alpha is
    assert int((~bad).sum()) > 1000


def test_backward_warp_mip_cpu_tensor_takes_plain_version(mip_scene):
    before = LAUNCHES["backward_warp_mip"]
    a = mip_call(M.backward_warp_mip, mip_scene)
    b = mip_call(M.backward_warp_mip_ref, mip_scene)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert LAUNCHES["backward_warp_mip"] == before
    assert (~a[1]).sum() > 500


def test_backward_warp_mip_rejects_bad_origins(mip_scene):
    """On every device: an origin naming a missing level, or putting its
    window outside its level's buffer, or of the wrong shape."""
    org = mip_scene["origins"]
    bad_level = org.copy()
    bad_level[0, 0, 0, 2] = len(mip_scene["mips"])
    bad_row = org.copy()
    bad_row[0, 0, 0, :] = (mip_scene["mips"][0].shape[1], 0, 0)
    for origins, match in ((bad_level, "level"), (bad_row, "leaves"),
                           (org[..., :2], "origins must be"),
                           (org.astype(np.float32), "integer")):
        with pytest.raises(ValueError, match=match):
            mip_call(M.backward_warp_mip, mip_scene, origins=origins)
    with pytest.raises(ValueError, match="unsupported device"):
        mip_call(M.backward_warp_mip, mip_scene, dev="meta")


def test_warp_ref_handles_rays_near_horizon():
    """z ~ 0 rays: huge or NaN image coordinates are masked invalid and
    never reach an undefined float-to-int conversion."""
    img = torch.rand((1, 8, 8, 4), generator=torch.Generator().manual_seed(0))
    proj = torch.zeros((1, 3, 3))
    proj[0, 0, 0] = 1.0      # u = sin(theta), v = 0, z = 0
    p, inv = W.backward_warp_ref(img, proj, torch.zeros((1, 2)),
                                 torch.tensor([0.1, 0.1]),
                                 torch.tensor([-math.pi / 2, -0.3]), 4, 6)
    assert torch.isfinite(p).all()
    assert inv.all()


# ---------------------------------------------------------------------------
# Kernels on the card
# ---------------------------------------------------------------------------

def _check_octave(base, score_cfg, taps=TAPS, exact=False):
    """The kernel against its plain version: within 1e-5 and 0.1 % score
    flips, or (``exact``) every output plane bit for bit."""
    before = LAUNCHES["octave_stack"]
    outs = G.octave_stack(base, taps, score_cfg)
    refs = G.octave_stack_ref(base, taps, score_cfg)
    torch.cuda.synchronize()
    assert LAUNCHES["octave_stack"] == before + 1
    if exact:
        assert len(outs) == len(refs)
        for a, b in zip(outs, refs):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) == 0.0
        return
    for a, b in zip(outs[:2], refs[:2]):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5
    if score_cfg is not None:
        flips = int(((outs[2] > 0) != (refs[2] > 0)).sum())
        assert flips <= 1e-3 * max(int((refs[2] > 0).sum()), 1)


def _gray(shape, n=2, seed=7):
    """(n, H, W) gray synthetic views at exactly ``shape`` (no upscale)."""
    imgs, _, _ = synth.make_views(n_views=n, shape=shape, seed=seed)
    return bgr2gray(torch.as_tensor(np.stack(imgs))).contiguous()


@pytest.mark.gpu
def test_octave_stack_kernel_matches_plain_on_card(octave_base):
    _check_octave(octave_base.to(_cuda()), SCORE_CFG)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,n", [((50, 70), 1), ((97, 161), 3)])
def test_octave_stack_kernel_ragged_tiles(shape, n):
    """Bases whose sides are not tile multiples (and a batch of 3)."""
    _check_octave(_base(shape, n=n).to(_cuda()), SCORE_CFG)


@pytest.mark.gpu
def test_octave_stack_kernel_without_score(octave_base):
    _check_octave(octave_base.to(_cuda()), None)


@pytest.mark.gpu
@pytest.mark.parametrize("n_layers", [4, 5])
def test_octave_stack_kernel_other_chains_exact(n_layers):
    """sigma 2.0 with 4 or 5 layers: other tap counts (K 11-25) and a
    6- or 7-layer chain through the kernel's K dispatch, bit for bit."""
    taps = G.chain_taps(2.0, n_layers)
    score_cfg = (0.5 * 0.04 / n_layers, 10.0, 5)
    _check_octave(_gray((180, 300)).to(_cuda()), score_cfg, taps,
                  exact=True)


@pytest.mark.gpu
@pytest.mark.parametrize("n,shape", [(4, (479, 385)), (4, (801, 287))])
def test_octave_stack_kernel_tile_edges_exact(n, shape):
    """Bases one pixel below and above multiples of the 80x96 tile the
    kernel picks for them (6 x 4 tiles -1/+1 px, 10 x 3 tiles +1/-1 px)."""
    assert G.kernel_tile(TAPS, n, *shape)[:2] == (80, 96)
    assert (shape[0] % 80, shape[1] % 96) in ((79, 1), (1, 95))
    _check_octave(_gray(shape, n=n).to(_cuda()), SCORE_CFG, exact=True)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,n", [((43, 43), 2), ((100, 150), 1)])
def test_octave_stack_kernel_small_and_single_exact(shape, n):
    """The smallest legal octave (halo 42 + 1) and a batch of one."""
    _check_octave(_gray(shape, n=n).to(_cuda()), SCORE_CFG, exact=True)


@pytest.mark.gpu
def test_octave_stack_kernel_rejects_bad_input(octave_base):
    dev = _cuda()
    with pytest.raises(ValueError, match="float32"):
        G.octave_stack(octave_base.to(dev, torch.float64), TAPS)
    with pytest.raises(ValueError, match="contiguous"):
        G.octave_stack(octave_base.to(dev).transpose(1, 2), TAPS)
    with pytest.raises(ValueError, match="halo"):
        G.octave_stack(torch.zeros((1, 40, 80), device=dev), TAPS)


def _equal_warps(kernel, plain, min_valid):
    """The kernel's (patches, invalid) equal the plain version's bit for
    bit, the mask a bool tensor from the kernel, no flip."""
    (kp, ki), (rp, ri) = kernel, plain
    torch.cuda.synchronize()
    assert ki.dtype == torch.bool and ki.shape == ri.shape
    assert int((ki != ri).sum()) == 0
    assert torch.equal(kp, rp)
    assert int((~ki).sum()) > min_valid


def _exact_case(warp_scene, case):
    """(imgs on the card, host small args, keywords) of one exact-warp
    case built from a warp scene."""
    (rgba, projs, bottoms, res, rmin, ph, pw), wins, period, cyl = warp_scene
    if case == "ragged":          # neither side a multiple of the tile
        ph, pw = ph - 3, pw - 5
    elif case == "single":        # N = 1
        rgba, projs, bottoms, wins = rgba[1:2], projs[1:2], bottoms[1:2], \
            wins[1:2]
    elif case == "narrow":        # pw < 32: one partial tile column
        pw = 20
        bottoms = bottoms + torch.tensor([30.0, 0.0])
    elif case == "many":          # N = 64 regions
        k = torch.arange(64) % len(projs)
        rgba, projs, wins = rgba[k].contiguous(), projs[k], wins[k]
        bottoms = bottoms[k] + torch.stack(
            [torch.arange(64.0) % 7, torch.zeros(64)], 1)
    elif case == "periodic":      # a seam-crossing window
        period = pw // 3 + 7
    return ((rgba.to(_cuda()), projs, bottoms, res, rmin, ph, pw),
            dict(wins=wins, period=period, cylindrical=cyl))


@pytest.mark.gpu
@pytest.mark.parametrize("periodic", [False, True])
def test_backward_warp_kernel_matches_plain_on_card(warp_scene, periodic):
    args, kw = _exact_case(warp_scene, "periodic" if periodic else "")
    before = LAUNCHES["backward_warp"]
    kernel = W.backward_warp(*args, **kw)
    assert LAUNCHES["backward_warp"] == before + 1
    _equal_warps(kernel, W.backward_warp_ref(*args, **kw), 1000)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ragged", "single", "narrow", "many"])
def test_backward_warp_kernel_shapes_exact(warp_scene, case):
    """Patches whose sides are not tile multiples, one region, a patch
    narrower than a tile, 64 regions; spherical and cylindrical."""
    args, kw = _exact_case(warp_scene, case)
    _equal_warps(W.backward_warp(*args, **kw),
                 W.backward_warp_ref(*args, **kw), 100)


@pytest.mark.gpu
@pytest.mark.parametrize("periodic", [False, True])
def test_backward_warp_kernel_per_image_dims_exact(mixed_scene, periodic):
    """Views of mixed sizes zero-padded into one stack, each region's
    true (h, w) in its parameter row: bit for bit the plain version."""
    (rgba, *small), kw = mixed_scene
    if periodic:
        kw = dict(kw, period=small[-1] // 3 + 7)
    args = (rgba.to(_cuda()), *small)
    before = LAUNCHES["backward_warp"]
    kernel = W.backward_warp(*args, **kw)
    assert LAUNCHES["backward_warp"] == before + 1
    _equal_warps(kernel, W.backward_warp_ref(*args, **kw), 1000)
    padded = W.backward_warp(*args, **dict(kw, shapes=None))
    assert not torch.equal(padded[0], kernel[0])


@pytest.mark.gpu
def test_backward_warp_kernel_stack_dims_equal_none(warp_scene):
    """A uniform stack: true sizes equal to the stack's give the bits of
    a plan without sizes (zeros in the parameter rows)."""
    args, kw = _exact_case(warp_scene, "ragged")
    n, h, w, _ = args[0].shape
    a = W.backward_warp(*args, **kw)
    b = W.backward_warp(*args, shapes=np.array([[h, w]] * n), **kw)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
def test_backward_warp_plan_reused_same_bits(warp_scene):
    (imgs, *small, ph, pw), kw = _exact_case(warp_scene, "periodic")
    plan = W.prepare_warp(small[0], small[1], kw["wins"], *small[2:], ph, pw,
                          kw["period"], kw["cylindrical"])
    first = W.launch_warp(imgs, plan)
    other = W.launch_warp(imgs.flip(0).contiguous(), plan)
    again = W.launch_warp(imgs, plan)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1],
                                                           again[1])
    assert not torch.equal(first[0], other[0])


@pytest.mark.gpu
def test_backward_warp_mip_kernel_matches_plain_on_card(mip_scene):
    dev = _cuda()
    before = LAUNCHES["backward_warp_mip"]
    kernel = mip_call(M.backward_warp_mip, mip_scene, dev)
    assert LAUNCHES["backward_warp_mip"] == before + 1
    _equal_warps(kernel, mip_call(M.backward_warp_mip_ref, mip_scene, dev),
                 500)


def _mip_case(sc, case):
    """A mip scene cut to one case: N = 1, pw < 32, or 64 regions."""
    sc = dict(sc)
    projs, bottoms, res, rmin = sc["args"]
    if case == "single":
        sc["mips"] = [m[1:2] for m in sc["mips"]]
        sc["args"] = [projs[1:2], bottoms[1:2], res, rmin]
        sc["origins"], sc["wins"] = sc["origins"][1:2], sc["wins"][1:2]
    elif case == "narrow":
        sc["pw"] = 20
        sc["origins"] = np.ascontiguousarray(sc["origins"][:, :, :1])
    elif case == "many":
        k = np.arange(64) % len(projs)
        sc["mips"] = [m[k].contiguous() for m in sc["mips"]]
        sc["args"] = [projs[k], bottoms[k], res, rmin]
        sc["origins"], sc["wins"] = sc["origins"][k], sc["wins"][k]
    return sc


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["single", "narrow", "many"])
def test_backward_warp_mip_kernel_shapes_exact(mip_scene, case):
    """One region, a patch narrower than a tile, 64 regions (every scene
    has ragged patch sides; the periodic scene folds at its seam)."""
    dev = _cuda()
    sc = _mip_case(mip_scene, case)
    _equal_warps(mip_call(M.backward_warp_mip, sc, dev),
                 mip_call(M.backward_warp_mip_ref, sc, dev), 100)


@pytest.mark.gpu
def test_backward_warp_mip_plan_reused_same_bits(mip_scene):
    dev = _cuda()
    sc = mip_scene
    mips = [m.to(dev) for m in sc["mips"]]
    projs, bottoms, res, rmin = sc["args"]
    plan = M.prepare_mip_warp(projs, bottoms, sc["wins"], res, rmin,
                              sc["origins"], sc["ph"], sc["pw"], *sc["win"],
                              sc["hw"], [m.shape[1:3] for m in mips],
                              sc["period"])
    first = M.launch_mip_warp(mips, plan)
    again = M.launch_mip_warp(mips, plan)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1],
                                                           again[1])


# CUDA runtime calls that make the host wait for the card
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cudaMemset", "cudaFreeHost")


@pytest.mark.gpu
@pytest.mark.parametrize("warp", ["auto", "pallas"])
def test_warp_patches_makes_no_host_sync(warp):
    """From host inputs to the returned patches, under both policies: no
    synchronisation of the host with the card that PyTorch's sync-debug
    mode detects (a prototype that does not see every kind), and no
    synchronising CUDA runtime call in a profiler trace of the call."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from pano360_tpu_torch import geometry
    dev = _cuda()
    regs = regions(2, (300, 700), 0.5)
    (rgba, *_), lay, projs = warp_setup(regs, 120)
    imgs = rgba.to(dev)
    assert M.plan_windows(projs, lay.bottoms, lay.resolution,
                          lay.im_range[0], tuple(rgba.shape[1:3]), lay.ph,
                          lay.pw)[1], "the scene must plan mip levels"
    render.warp_patches(imgs, projs, lay, geometry.SphProj, warp)  # warm-up
    torch.cuda.synchronize()
    before = (LAUNCHES["backward_warp"], LAUNCHES["backward_warp_mip"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            with record_function("p360_warp_patches"):
                patches, invalid = render.warp_patches(imgs, projs, lay,
                                                       geometry.SphProj,
                                                       warp)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the runtime calls made inside the call (the profiler's own start
    # and stop synchronise the device outside it)
    span = next(e.time_range for e in prof.events()
                if e.name == "p360_warp_patches")
    calls = {e.name for e in prof.events() if e.name.startswith("cuda")
             and span.start <= e.time_range.start <= span.end}
    assert "cudaMemcpyAsync" in calls, calls     # the runtime is traced
    assert not calls & set(SYNC_CALLS), calls
    counts = (LAUNCHES["backward_warp"] - before[0],
              LAUNCHES["backward_warp_mip"] - before[1])
    assert counts == ((1, 0) if warp == "auto" else (0, 1))
    small = (projs, lay.bottoms, lay.resolution, lay.im_range[0])
    kw = dict(wins=lay.wins, period=lay.period)
    if warp == "auto":
        ref = W.backward_warp_ref(imgs, *small, lay.ph, lay.pw, **kw)
    else:
        hw = tuple(imgs.shape[1:3])
        origins, _, wy, wx, nl = M.plan_windows(
            projs, lay.bottoms, lay.resolution, lay.im_range[0], hw, lay.ph,
            lay.pw, period=lay.period)
        ref = M.backward_warp_mip_ref(M.build_mips(imgs, nl, wy, wx), *small,
                                      origins, lay.ph, lay.pw, wy, wx, hw,
                                      **kw)
    _equal_warps((patches, invalid), ref, 1000)


@pytest.mark.gpu
def test_backward_warp_mip_kernel_rejects_bad_input(mip_scene):
    dev = _cuda()
    with pytest.raises(ValueError, match="float32"):
        mip_call(M.backward_warp_mip, mip_scene, dev,
                 mips=[m.double() for m in mip_scene["mips"]])
    with pytest.raises(ValueError, match="projs"):
        mip_call(M.backward_warp_mip, mip_scene, dev,
                 args=[mip_scene["args"][0][:1]] + mip_scene["args"][1:])
    org = mip_scene["origins"].copy()
    org[-1, -1, -1, 1] = 1 << 20
    with pytest.raises(ValueError, match="leaves"):
        mip_call(M.backward_warp_mip, mip_scene, dev, origins=org)
    with pytest.raises(ValueError, match="resolution"):
        mip_call(M.backward_warp_mip, mip_scene, dev,
                 args=mip_scene["args"][:2]
                 + [mip_scene["args"][2].to(dev), mip_scene["args"][3]])


@pytest.mark.gpu
def test_backward_warp_kernel_rejects_bad_input(warp_scene):
    dev = _cuda()
    args, _, _, _ = warp_scene
    args = (args[0].to(dev),) + args[1:]
    with pytest.raises(ValueError, match="float32"):
        W.backward_warp(args[0][..., :3].contiguous(), *args[1:])
    with pytest.raises(ValueError, match="projs"):
        W.backward_warp(args[0], args[1][:1], *args[2:])
    with pytest.raises(ValueError, match="range_min"):
        W.backward_warp(*args[:4], args[4].to(dev), *args[5:])


@pytest.mark.gpu
def test_refit_homography_pair_without_inliers_on_card():
    """On the card a singular or non-finite system makes
    ``torch.linalg.solve`` raise for the whole batch: a pair without
    inliers must come out non-finite and leave the others refitted."""
    from pano360_tpu_torch import match
    rng = np.random.default_rng(8)
    p1 = torch.tensor(rng.random((2, 40, 2)) * 200 - 100,
                      dtype=torch.float32, device=_cuda())
    p2 = p1 * 1.01 + 3.0
    w = torch.ones((2, 40), device=_cuda())
    w[0] = 0.0
    hom = match.refit_homography(p1, p2, w)
    torch.cuda.synchronize()
    assert not torch.isfinite(hom[0]).all() and torch.isfinite(hom[1]).all()
    assert abs(float(hom[1, 0, 0]) - 1.01) < 1e-3


def _world_of_bucket(dev, seeds, key=None, shape=None):
    """-> (seed, uint8 views, rehydrated match graph, registration
    bucket, compact keypoint buffer's shape: the match graph's key) of
    the first world of five 192x256 views from ``seeds`` in the bucket
    ``key`` and of the buffer ``shape`` (any, where None), found with
    every step run eagerly."""
    from pano360_tpu_torch import register
    from pano360_tpu_torch.pipeline import (idx_to_keypoints, matching,
                                            sift_buffers, upload_extract)
    for seed in seeds:
        imgs, _, _ = synth.make_views(n_views=5, shape=(192, 256),
                                      overlap=0.45, seed=seed)
        u8 = [(im * 255).astype(np.uint8) for im in imgs]
        _, feats = upload_extract(u8, dev, capture=False)
        got = tuple(sift_buffers(u8, feats)[1].shape)
        kpts, matches = matching(u8, dev, feats=feats, capture=False)
        graph = idx_to_keypoints(matches, kpts)
        plan = register._plan(5, graph)
        if plan is not None and key in (None, plan.key) \
                and shape in (None, got):
            return seed, u8, graph, plan.key, got
    pytest.fail(f"no world in bucket {key} with buffers {shape}")


@pytest.mark.gpu
@pytest.mark.parametrize("badjust", ["incr", "last"])
def test_traverse_replayed_equals_eager_on_card(badjust, monkeypatch):
    """``register.traverse`` with its add, LM and polish steps replayed
    from CUDA graphs against the same steps run eagerly on the card, on
    a 5-view world (captured, eager, replayed) and on a second world of
    the same bucket (replayed, eager): the same cameras bit for bit and
    the same LM counts; a replay-only traverse captures nothing and
    takes its bucket's program (``graphs.programs_hit`` + 1); at most
    one host sync per read of the counters, two per add (the SVDs) and a
    few per traverse."""
    from pano360_tpu_torch import graphs, profiling, register
    from pano360_tpu_torch.measure import host_syncs
    dev = _cuda()
    monkeypatch.setattr(graphs, "PROGRAMS", graphs.Programs())
    _, u8, graph, key, _ = _world_of_bucket(dev, [3])
    _, u8_b, graph_b, _, _ = _world_of_bucket(dev, range(4, 60), key)

    def run(u8, graph, capture):
        stats = {}
        before = profiling.snapshot()["counters"]
        regs = register.traverse(u8, graph, badjust=badjust, stats=stats,
                                 capture=capture)
        after = profiling.snapshot()["counters"]
        made = {k: after.get(k, 0) - before.get(k, 0)
                for k in ("graphs.captures", "graphs.programs_hit")}
        return regs, stats, made

    def same(a, b):
        (ra, sa, _), (rb, sb, _) = a, b
        assert len(ra) == len(rb) == 5
        assert all(np.array_equal(x.rot, y.rot)
                   and np.array_equal(x.intr, y.intr) for x, y in zip(ra, rb))
        assert sa["lm_iterations"] == sb["lm_iterations"]
        assert sa["polish_iterations"] == sb["polish_iterations"]

    first = run(u8, graph, True)
    assert first[2]["graphs.captures"] == 3
    same(first, run(u8, graph, False))
    for u8_w, graph_w in ((u8, graph), (u8_b, graph_b)):
        replayed = run(u8_w, graph_w, True)
        assert replayed[2] == {"graphs.captures": 0,
                               "graphs.programs_hit": 1}
        same(replayed, run(u8_w, graph_w, False))
    sg = first[1]
    _, sites = host_syncs(lambda: register.traverse(u8, graph,
                                                    badjust=badjust))
    iters = sum(sg["lm_iterations"]) + sg["polish_iterations"]
    assert sum(sites.values()) <= 2 * 4 + iters + 8, sites


@pytest.mark.gpu
def test_reserved_memory_flat_over_worlds_of_one_bucket_on_card(
        monkeypatch):
    """Five different 5-view worlds of one bucket (the registration's and
    the match graph's), each stitched in turn on the card through the
    replayed path: the first captures, the others replay what it made,
    and ``torch.cuda.memory_reserved()`` is the same after the second
    panorama and after the fifth."""
    from pano360_tpu_torch import graphs, profiling, register
    from pano360_tpu_torch.pipeline import (idx_to_keypoints, matching,
                                            upload_extract)
    dev = _cuda()
    monkeypatch.setattr(graphs, "PROGRAMS", graphs.Programs())
    seed, *_, key, shape = _world_of_bucket(dev, [3])
    seeds = [seed]
    while len(seeds) < 5:
        seeds.append(_world_of_bucket(dev, range(seeds[-1] + 1, 200), key,
                                      shape)[0])
    reserved, captures = [], []
    for s in seeds:
        imgs, _, _ = synth.make_views(n_views=5, shape=(192, 256),
                                      overlap=0.45, seed=s)
        u8 = [(im * 255).astype(np.uint8) for im in imgs]
        stack, feats = upload_extract(u8, dev)
        kpts, matches = matching(u8, dev, feats=feats)
        regs = register.traverse(u8, idx_to_keypoints(matches, kpts),
                                 device=dev)
        render.stitch(regs, dev_images=stack, device=dev)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
        captures.append(profiling.snapshot()["counters"]["graphs.captures"])
    assert captures[1:] == [captures[0]] * 4, captures
    assert reserved[1] == reserved[4], reserved


@pytest.mark.gpu
def test_features_replayed_equal_eager_on_card():
    """SIFT's extraction and the match graph replayed from CUDA graphs
    against the same steps run eagerly on the card (five views: a batch
    of 4 and a short one; ten pairs in chunks of 4 and a short one):
    features, stack and match rows bit for bit; the launches of the
    octave kernel, of SIFT's front end (the base, the small octaves) and
    of its tail in a replayed extraction those of an eager one; no host
    sync
    in a replayed extraction, one per chunk (``eigh``) and one for the
    rows in a replayed match graph."""
    from pano360_tpu_torch import match as pm
    from pano360_tpu_torch import pipeline
    from pano360_tpu_torch.measure import host_syncs
    dev = _cuda()
    imgs, _, _ = synth.make_views(n_views=5, shape=(192, 256), overlap=0.45,
                                  seed=3)
    u8 = [(im * 255).astype(np.uint8) for im in imgs]
    pairs = [(a, b) for a in range(5) for b in range(a + 1, 5)]
    out, launches = {}, {}
    counts = ("octave_stack", "sift_base", "sift_small_octave",
              "sift_refine", "sift_orient", "sift_descr")
    for capture in (True, False, True):     # capture, eager, replay only
        LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
        stack, feats = pipeline.upload_extract(u8, dev, capture=capture)
        launches[capture] = [LAUNCHES[k] for k in counts]
        _, kp, ds, va, _ = pipeline.sift_buffers(u8, feats)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        res = pm.match_all_pairs(kp, ds, va, pairs, 4, generator=gen,
                                 capture=capture)
        out[capture] = (stack, feats, res)
    (sr, fr, rr), (se, fe, re) = out[True], out[False]
    assert torch.equal(sr, se)
    assert all(torch.equal(a, b) for a, b in zip(fr, fe))
    # the bits: a pair without a homography has NaNs
    assert all(a.dtype == b.dtype and a.shape == b.shape
               and a.tobytes() == b.tobytes() for a, b in zip(rr, re))
    assert rr.ok.sum() >= 4
    # two batches of 7 octaves: the base once, the octave kernel on the 4
    # legal ones, the small-octave kernel on the other 3, the refinement
    # on all, the keypoint stage once
    assert launches[True] == launches[False] == [8, 2, 6, 14, 2, 2]
    _, sites = host_syncs(lambda: pipeline.upload_extract(u8, dev))
    assert not sites, sites
    _, sites = host_syncs(lambda: pm.match_all_pairs(kp, ds, va, pairs, 4,
                                                     generator=gen))
    assert sum(sites.values()) == 3 + 1, sites


# ---------------------------------------------------------------------------
# SIFT's tail on the card
# ---------------------------------------------------------------------------

TAIL = ("refine", "orientation", "descriptors")


def _plain_refine(dog, l0, y0, x0, cfg):
    return S._refine(dog, S._newton_step_field(dog), l0, y0, x0, cfg)


def _tail_plain(name):
    return dict(refine=_plain_refine,
                orientation=lambda *a, cfg: S._peak_angles(
                    S._orientation_hist(*a, cfg), cfg),
                descriptors=S._descriptors)[name]


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _bits(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def _tail_calls(shape, n, dev, descr_mode="grid"):
    """The three wrappers' arguments in one extraction on the card of n
    synthetic views of ``shape``."""
    from pano360_tpu_torch.measure import recording
    imgs, _, _ = synth.make_views(n_views=n, shape=shape, seed=4)
    gray = bgr2gray(torch.as_tensor(np.stack(imgs), device=dev))
    with recording(T, TAIL) as calls:
        S.sift_extract(gray, S.SiftConfig(descr_mode=descr_mode))
    return calls


def _hold_to_plain(name, args, kw):
    """A kernel's call, then the same call again, against its plain
    version, bit for bit."""
    got = _tuple(getattr(T, name)(*args, **kw))
    again = _tuple(getattr(T, name)(*args, **kw))
    want = _tuple(_tail_plain(name)(*args, **kw))
    torch.cuda.synchronize()
    assert all(_bits(a, b) and _bits(a, c)
               for a, b, c in zip(got, want, again)), name


@pytest.mark.gpu
@pytest.mark.parametrize("shape,n,mode", [((864, 1152), 4, "grid"),
                                          ((54, 72), 1, "grid"),
                                          ((54, 72), 3, "grid"),
                                          ((54, 72), 2, "dense")])
def test_sift_tail_kernels_match_plain_on_card(shape, n, mode):
    """Every call of the three kernels in an extraction against its plain
    version bit for bit (the refinement against the plain steps on the
    dense Newton field), and a second launch the same bits: the bench's
    views (octave 0 of 4 x 1728x2304), ragged small octaves (27x36 and
    below) with 1 and 3 views, and the dense mode's 80x80 patches (the
    orientation kernel only)."""
    dev = _cuda()
    calls = _tail_calls(shape, n, dev, mode)
    assert [len(calls[k]) > 0 for k in TAIL] == [True] * 2 + [mode == "grid"]
    for name in TAIL:
        for args, kw in calls[name]:
            _hold_to_plain(name, args, kw)


def _border_candidates(n, s, h, w, seed):
    """(N, C) candidates on every image edge (x = 0, x = w - 1, y = 0,
    y = h - 1, the four corners) at layers 1 and S, then random ones."""
    rng = np.random.default_rng(seed)
    pts = []
    for lay in (1, s):
        for x in (0, w - 1):
            pts += [(lay, y, x) for y in rng.integers(0, h, 4)] + \
                [(lay, 0, x), (lay, h - 1, x)]
        for y in (0, h - 1):
            pts += [(lay, y, x) for x in rng.integers(0, w, 4)]
    pts = np.array(pts)
    extra = np.stack([rng.integers(1, s + 1, 64), rng.integers(0, h, 64),
                      rng.integers(0, w, 64)], -1)
    pts = np.concatenate([pts, extra])
    cand = np.stack([np.roll(pts, 7 * i, 0) for i in range(n)])
    return (torch.from_numpy(cand[..., k].copy()) for k in range(3))


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [S.SiftConfig(), S.SiftConfig(img_border=0),
                                 S.SiftConfig(refine_iters=1),
                                 S.SiftConfig(n_layers=4, refine_iters=9)])
@pytest.mark.parametrize("n,shape", [(1, (27, 36)), (3, (54, 72))])
def test_sift_refine_kernel_on_the_wrap_border(cfg, n, shape):
    """The fused refinement's first step (and, at ``img_border=0``, every
    step) can stand on an image edge, where the Newton step's stencil
    wraps as ``torch.roll`` wraps: candidates on x = 0, x = w - 1, y = 0,
    y = h - 1 and the corners at layers 1 and S of a numpy-seeded DoG
    stack, bit for bit the plain steps on the dense field."""
    dev = _cuda()
    s = cfg.n_layers
    rng = np.random.default_rng(11)
    dog = torch.from_numpy((rng.standard_normal((n, s + 2) + shape) * 0.02)
                           .astype(np.float32)).to(dev)
    l0, y0, x0 = (t.to(dev) for t in _border_candidates(n, s, *shape, 3))
    _hold_to_plain("refine", (dog, l0, y0, x0, cfg), {})
    ok = _plain_refine(dog, l0, y0, x0, cfg)[5]
    assert 0 < int(ok.sum()) < ok.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 257])
def test_sift_descr_kernel_windows_leave_the_patch(k):
    """Keypoints whose rotated windows leave the gradient patch and the
    image (numpy-seeded patches and positions near both edges, sigmas up
    to 8), at one and at two orientations: the grid descriptor kernel
    bit for bit its plain version, twice in a row."""
    dev = _cuda()
    rng = np.random.default_rng(k)
    psg = 64
    gx, gy = (torch.from_numpy((rng.standard_normal((k, psg, psg)) * 0.05)
                               .astype(np.float32)) for _ in range(2))
    oh = torch.from_numpy(rng.choice([70, 125, 160], k))
    ow = torch.from_numpy(rng.choice([72, 145, 170], k))
    yf = torch.from_numpy(rng.uniform(0.0, oh.numpy() - 1.0)
                          .astype(np.float32))
    xf = torch.from_numpy(rng.uniform(0.0, ow.numpy() - 1.0)
                          .astype(np.float32))
    pcy = torch.clamp(yf.long() - psg // 2 - 1 + torch.from_numpy(
        rng.integers(-6, 7, k)), min=0)
    pcx = torch.clamp(xf.long() - psg // 2 - 1 + torch.from_numpy(
        rng.integers(-6, 7, k)), min=0)
    sig = torch.from_numpy(rng.uniform(1.6, 8.0, k).astype(np.float32))
    for no in (1, 2):
        angle = torch.from_numpy(rng.uniform(0, 2 * math.pi, (k, no))
                                 .astype(np.float32))
        args = _on(dev, (gx, gy, yf, xf, pcy, pcx, sig, angle, oh, ow))
        _hold_to_plain("descriptors", args, dict(cfg=S.SiftConfig()))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 257])
def test_sift_orient_kernel_windows_on_every_patch_edge(k):
    """Keypoints whose orientation windows lie anywhere in the 64x64
    gradient patch (numpy-seeded): corners clamped to 0 and to h - 66 as
    ``_extract_patches`` clamps them, positions on and near the image's
    edges, sigmas from 1.6 to 7.2 (a window of the whole patch), small
    octaves (h, w < 66) whose patches are zero-padded, two equal peaks
    (the lower bin first, keypoint 0) and an all-zero window (both
    orientations invalid, keypoint 1): the grid orientation kernel bit
    for bit its plain version, twice in a row."""
    dev = _cuda()
    rng = np.random.default_rng(k)
    psg = 64
    gx, gy = ((rng.standard_normal((k, psg, psg)) * 0.05).astype(np.float32)
              for _ in range(2))
    oh = rng.choice([20, 41, 65, 66, 125, 160], k)
    ow = rng.choice([24, 50, 64, 67, 145, 170], k)

    def near_edges(size, mod):
        pos = rng.integers(0, size)
        return np.select([mod == 0, mod == 1, mod == 2],
                         [np.minimum(rng.integers(0, 3, k), size - 1),
                          size - 1 - np.minimum(rng.integers(0, 3, k),
                                                size - 1),
                          np.minimum(33 + rng.integers(-2, 3, k), size - 1)],
                         pos)
    i = np.arange(k)
    y, x = near_edges(oh, i % 4), near_edges(ow, (i // 4) % 4)
    sig = rng.uniform(1.6, 7.2, k).astype(np.float32)
    sig[i % 5 == 0], sig[i % 5 == 1] = 1.6, 7.2
    # keypoint 0: gradients (0.5, 0) and (-0.5, 0) one pixel left and right
    # of it (bins 0 and 18, the same weight), nothing else
    oh[0] = ow[0] = 125
    y[0], x[0], sig[0] = 60, 60, 2.0
    gx[0], gy[0] = 0.0, 0.0
    gx[0, 32, 31], gx[0, 32, 33] = 0.5, -0.5
    if k > 1:
        gx[1], gy[1] = 0.0, 0.0
    pcy = np.clip(y - psg // 2 - 1, 0, np.maximum(oh - psg - 2, 0))
    pcx = np.clip(x - psg // 2 - 1, 0, np.maximum(ow - psg - 2, 0))
    # a small octave's patch: its gradients end at row (column) h - 3, and
    # the rest is zero padding
    for j in range(k):
        gx[j, oh[j] - 2:], gy[j, oh[j] - 2:] = 0.0, 0.0
        gx[j, :, ow[j] - 2:], gy[j, :, ow[j] - 2:] = 0.0, 0.0
    ints = (torch.from_numpy(a.astype(np.int64)) for a in (y, x, pcy, pcx))
    args = _on(dev, (torch.from_numpy(gx), torch.from_numpy(gy), *ints,
                     torch.from_numpy(sig), torch.from_numpy(oh),
                     torch.from_numpy(ow)))
    _hold_to_plain("orientation", args, dict(cfg=S.SiftConfig()))
    angle, valid = T.orientation(*args, cfg=S.SiftConfig())
    assert valid[0].tolist() == [True, True]
    assert angle[0, 0].item() == 0.0 and angle[0, 1].item() > 3.0
    if k > 1:
        assert valid[1].tolist() == [False, False]
    if k > 3:
        assert 0.5 < valid[:, 0].float().mean().item() < 1.0


@pytest.mark.gpu
def test_sift_tail_kernels_reject_bad_input():
    dev = _cuda()
    calls = _tail_calls((54, 72), 1, dev)
    dog, l0, y0, x0, cfg = calls["refine"][0][0]
    with pytest.raises(ValueError, match="dog must be"):
        T.refine(dog.double(), l0, y0, x0, cfg)
    with pytest.raises(ValueError, match="l0 must be"):
        T.refine(dog, l0.int(), y0, x0, cfg)
    args, kw = calls["orientation"][0]
    with pytest.raises(ValueError, match="36 bins"):
        T.orientation(*args, cfg=S.SiftConfig(ori_bins=24))
    with pytest.raises(ValueError, match="gx must be"):
        T.orientation(args[0][:, :, :-1], *args[1:], **kw)
    args, kw = calls["descriptors"][0]
    with pytest.raises(ValueError, match="4x4 bins"):
        T.descriptors(*args, cfg=S.SiftConfig(descr_width=3))


# ---------------------------------------------------------------------------
# SIFT's front end on the card
# ---------------------------------------------------------------------------

def _front_bits(name, arg, cfg):
    """A front-end kernel's call, then the same call again, against its
    plain version on the card, bit for bit; -> its outputs."""
    fn = getattr(F, name)
    plain = getattr(F, f"{name}_ref")
    count = "sift_base" if name == "base_image" else "sift_small_octave"
    before = LAUNCHES[count]
    got = _tuple(fn(arg, cfg))
    again = _tuple(fn(arg, cfg))
    want = _tuple(plain(arg, cfg))
    torch.cuda.synchronize()
    assert LAUNCHES[count] == before + 2
    assert all(_bits(a, b) and _bits(a, c)
               for a, b, c in zip(got, want, again)), name
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 4])
def test_sift_base_kernel_bench_shape(n):
    """The bench's upload batches (4, 4, 4 and 3 views of 864x1152) and
    one view."""
    dev = _cuda()
    _front_bits("base_image", _gray((864, 1152), n=n).to(dev),
                S.SiftConfig())


@pytest.mark.gpu
@pytest.mark.parametrize("upscale", [True, False])
@pytest.mark.parametrize("shape,n", [((33, 65), 2), ((129, 257), 1),
                                     ((97, 161), 3), ((3, 4), 2), ((1, 7), 1),
                                     ((5, 2), 1)])
def test_sift_base_kernel_odd_and_tiny(upscale, shape, n):
    """Sides that are not tile multiples, and images narrower than the
    blur's halo (5 px on the 2x grid, 6 without): reflect101 folds more
    than once. ``upscale=False`` takes the 13-tap blur alone."""
    dev = _cuda()
    gray = torch.as_tensor(np.random.default_rng(1).random(
        (n,) + shape, dtype=np.float32), device=dev)
    out = _front_bits("base_image", gray, S.SiftConfig(upscale=upscale))
    up = 2 if upscale else 1
    assert out[0].shape == (n, up * shape[0], up * shape[1])


def _small_bases(n, shapes, seed=6):
    """Bases of the small octaves as SIFT makes them: layer S of the
    octave before, halved, from one view of each shape."""
    out = []
    for shape in shapes:
        base = _base(shape, n=n, seed=seed)
        while G.reflect_legal(*base.shape[1:], TAPS):
            base = G.octave_stack_ref(base, TAPS)[0][:, 3, ::2, ::2]
        out.append(base.contiguous())
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4])
def test_sift_small_octave_kernel_bench_octaves(n):
    """The bench's octaves 6-8 (27x36, 14x18, 7x9 from 864x1152 views,
    here from 216x288 ones: the same sizes), each on the next's base as
    the extraction chains them, all in shared memory; candidates found."""
    dev = _cuda()
    cfg = S.SiftConfig()
    base = _small_bases(n, [(216, 288)])[0].to(dev)
    sizes, found = [], 0
    while min(base.shape[1:]) >= 4:
        assert F.small_octave_in_shared(*base.shape[1:])
        gauss, _, score = _front_bits("small_octave", base, cfg)
        sizes.append(tuple(base.shape[1:]))
        found += int((score > 0).sum())
        base = gauss[:, cfg.n_layers, ::2, ::2].contiguous()
    assert sizes[:3] == [(27, 36), (14, 18), (7, 9)]
    assert found > 0


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("shape", [(40, 300), (12, 1100), (300, 41)])
def test_sift_small_octave_kernel_strips(n, shape):
    """Octaves whose min side is <= 42 and whose other side is long: six
    planes do not fit a block's shared memory, so the passes go through
    device memory."""
    dev = _cuda()
    assert not F.small_octave_in_shared(*shape)
    base = torch.as_tensor(np.random.default_rng(2).random(
        (n,) + shape, dtype=np.float32), device=dev)
    _front_bits("small_octave", base, S.SiftConfig())


@pytest.mark.gpu
@pytest.mark.parametrize("n_layers", [2, 4])
@pytest.mark.parametrize("shape", [(27, 36), (40, 300)])
def test_sift_small_octave_kernel_other_chains(n_layers, shape):
    """S = 2 and 4: 4 and 6 blurred layers of other tap counts, in shared
    and in device memory; the score with other thresholds."""
    dev = _cuda()
    base = torch.as_tensor(np.random.default_rng(4).random(
        (2,) + shape, dtype=np.float32), device=dev)
    cfg = S.SiftConfig(n_layers=n_layers)
    gauss, dog, score = _front_bits("small_octave", base, cfg)
    assert gauss.shape[1] == n_layers + 3 and score.shape[1] == n_layers


@pytest.mark.gpu
def test_sift_front_kernels_score_border_zero():
    """``img_border=0``: the score's extrema on the image's edge rows
    and columns, where the plain version's max and min leave the outside
    out and its derivatives are zero-padded."""
    dev = _cuda()
    base = torch.as_tensor(np.random.default_rng(8).random(
        (3, 20, 30), dtype=np.float32), device=dev) * 4
    _front_bits("small_octave", base, S.SiftConfig(img_border=0,
                                                   contrast_thresh=0.0))


@pytest.mark.gpu
def test_sift_front_kernels_reject_bad_input():
    dev = _cuda()
    gray = torch.zeros((2, 20, 24), device=dev)
    with pytest.raises(ValueError, match="float32"):
        F.base_image(gray.double(), S.SiftConfig())
    with pytest.raises(ValueError, match="contiguous"):
        F.base_image(gray.transpose(1, 2), S.SiftConfig())
    with pytest.raises(ValueError, match="taps"):
        F.base_image(gray, S.SiftConfig(sigma=5.0))
    with pytest.raises(ValueError, match="contiguous"):
        F.small_octave(gray[:, ::2], S.SiftConfig())
    with pytest.raises(ValueError, match="float32"):
        F.small_octave(gray[0], S.SiftConfig())


# ---------------------------------------------------------------------------
# RANSAC's scoring: the wrapper on the CPU, the plain rules, the kernel
# ---------------------------------------------------------------------------

def _ransac_inputs(b, k, m, seed=0, outliers=0.4, degenerate=8):
    """A chunk's scoring inputs on the CPU: per pair a homography near a
    turn about the optical axis, p2 its image of p1 with 1-px noise and a
    share of outliers, 80 % of the points valid, and K hypotheses from
    4-point samples (``match.hom_from_4pts``), the first ``degenerate``
    of each pair from samples with a repeated point (non-finite)."""
    from pano360_tpu_torch import match as pm
    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g)
    p1 = (rand(b, m, 2) - 0.5) * 1200
    th = (rand(b) - 0.5) * 0.4
    hom = torch.zeros((b, 3, 3))
    hom[:, 0, 0], hom[:, 0, 1] = torch.cos(th), -torch.sin(th)
    hom[:, 1, 0], hom[:, 1, 1] = torch.sin(th), torch.cos(th)
    hom[:, :2, 2] = (rand(b, 2) - 0.5) * 400
    hom[:, 2, :2] = (rand(b, 2) - 0.5) * 2e-4
    hom[:, 2, 2] = 1.0
    ph = torch.cat([p1, torch.ones((b, m, 1))], -1) @ hom.transpose(-1, -2)
    p2 = ph[..., :2] / ph[..., 2:] + torch.randn((b, m, 2), generator=g)
    out = rand(b, m) < outliers
    p2 = torch.where(out[..., None], (rand(b, m, 2) - 0.5) * 1200, p2)
    valid = rand(b, m) < 0.8
    draws = torch.randint(0, m, (b, k, 4), generator=g)
    draws[:, :degenerate, 1] = draws[:, :degenerate, 0]
    pick = draws.reshape(b, -1)[..., None].expand(-1, -1, 2)
    s1 = torch.gather(p1, 1, pick).reshape(b, k, 4, 2)
    s2 = torch.gather(p2, 1, pick).reshape(b, k, 4, 2)
    return (pm.hom_from_4pts(s1, s2).contiguous(), p1.contiguous(),
            p2.contiguous(), valid.contiguous())


def test_ransac_score_cpu_takes_plain_version():
    from pano360_tpu_torch.ops import ransac as R
    homs, p1, p2, valid = _ransac_inputs(3, 64, 100)
    before = LAUNCHES["ransac_score"]
    best, mask = R.score(homs, p1, p2, valid, 3.0)
    ref = R.score_ref(homs, p1, p2, valid, 3.0)
    assert torch.equal(best, ref[0]) and torch.equal(mask, ref[1])
    assert LAUNCHES["ransac_score"] == before
    assert int(ref[2].max()) > 20 and int(mask.sum()) > 60


@pytest.mark.parametrize("case", ["device", "dtype", "contiguity", "p2 shape",
                                  "valid dtype", "hom shape", "no points"])
def test_ransac_score_rejects_bad_input(case):
    from pano360_tpu_torch.ops import ransac as R
    homs, p1, p2, valid = _ransac_inputs(2, 16, 40)
    args = dict(homs=homs, p1=p1, p2=p2, valid=valid)
    if case == "device":
        args = {k: v.to("meta") for k, v in args.items()}
    elif case == "dtype":
        args["homs"] = homs.double()
    elif case == "contiguity":
        args["p1"] = torch.cat([p1, p1], -1)[..., ::2]
    elif case == "p2 shape":
        args["p2"] = p2[:, :-1].contiguous()
    elif case == "valid dtype":
        args["valid"] = valid.to(torch.uint8)
    elif case == "hom shape":
        args["homs"] = homs.reshape(2, 16, 9)
    else:
        args.update(p1=p1[:, :0], p2=p2[:, :0], valid=valid[:, :0])
    want = {"device": "unsupported device", "no points": "at least one"}
    with pytest.raises(ValueError, match=want.get(case, "must be")):
        R.score(args["homs"], args["p1"], args["p2"], args["valid"], 3.0)


def _scored_rule_case(case):
    """Hypotheses of one pair whose winner a rule of the plain scorer
    decides: -> (homs, p1, p2, valid, the winning index, its count)."""
    m = 50
    p1 = torch.arange(2 * m, dtype=torch.float32).reshape(1, m, 2)
    p2 = p1 + 1.0                      # the translation by (1, 1)
    valid = torch.ones((1, m), dtype=torch.bool)
    shift = torch.eye(3).repeat(1, 6, 1, 1)
    shift[..., :2, 2] = 1.0
    homs = torch.eye(3).repeat(1, 6, 1, 1)    # identity: error 2 < 9
    homs[0, :, 0, 2] = torch.tensor([9.0, 9.0, 9.0, 9.0, 9.0, 9.0])
    if case == "ties":                 # 2 and 4 score every point
        homs[0, 2], homs[0, 4] = shift[0, 0], shift[0, 0]
        return homs, p1, p2, valid, 2, m
    if case == "non-finite":           # 1 would score every point
        homs[0, 1] = shift[0, 0]
        homs[0, 1, 2, 0] = torch.inf
        homs[0, 3] = shift[0, 0]
        homs[0, 3, 0, 2] = 1.5         # error 0.25: every point
        homs[0, 5] = shift[0, 0]
        homs[0, 5, 2, 2] = torch.nan
        return homs, p1, p2, valid, 3, m
    valid[:] = False                   # nothing scores: index 0
    homs[0, 3] = shift[0, 0]
    return homs, p1, p2, valid, 0, 0


@pytest.mark.parametrize("case", ["ties", "non-finite", "nothing"])
def test_ransac_score_plain_rules(case):
    """The rules the kernel reproduces: the first index of the largest
    count wins, a hypothesis with a non-finite entry counts 0, and index
    0 wins when nothing scores."""
    from pano360_tpu_torch.ops import ransac as R
    homs, p1, p2, valid, win, n = _scored_rule_case(case)
    best, mask, counts = R.score_counts(homs, p1, p2, valid, 3.0)
    assert int(torch.argmax(counts[0])) == win and int(counts[0, win]) == n
    assert torch.equal(best[0], homs[0, win]) and int(mask.sum()) == n
    if case == "non-finite":
        assert int(counts[0, 1]) == 0 and int(counts[0, 5]) == 0
    if case == "nothing":
        assert not counts.any()


def _hold_ransac(homs, p1, p2, valid, thresh=3.0):
    """The kernel against the plain scorer on the card: every count, the
    winner's homography (bits) and its mask."""
    from pano360_tpu_torch.ops import ransac as R
    dev = _cuda()
    args = [t.to(dev) for t in (homs, p1, p2, valid)]
    before = LAUNCHES["ransac_score"]
    got = R.score_counts(*args, thresh)
    want = R.score_ref(*args, thresh)
    assert LAUNCHES["ransac_score"] == before + 1
    assert torch.equal(got[2], want[2])
    assert _bits(got[0], want[0]) and torch.equal(got[1], want[1])
    best, mask = R.score(*args, thresh)
    assert _bits(best, want[0]) and torch.equal(mask, want[1])
    return want[2]


@pytest.mark.gpu
@pytest.mark.parametrize("b,k,m", [(16, 2048, 2048), (4, 2048, 4096),
                                   (3, 2048, 64), (2, 2048, 1000),
                                   (5, 300, 1000), (1, 1, 1)])
def test_ransac_score_kernel_matches_plain_on_card(b, k, m):
    counts = _hold_ransac(*_ransac_inputs(b, k, m, seed=b * k + m,
                                          degenerate=min(8, k - 1)))
    assert m < 8 or int(counts.max()) > 0.2 * m


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ties", "non-finite", "nothing"])
def test_ransac_score_kernel_rules_on_card(case):
    homs, p1, p2, valid, win, n = _scored_rule_case(case)
    counts = _hold_ransac(homs, p1, p2, valid)
    assert int(torch.argmax(counts[0])) == win and int(counts[0, win]) == n


@pytest.mark.gpu
def test_ransac_score_kernel_ties_and_invalid_pair_on_card():
    """Copies of each pair's hypotheses at later indices (ties at every
    count), one pair with no valid point, non-finite hypotheses spread
    over the tiles."""
    homs, p1, p2, valid = _ransac_inputs(4, 1024, 700, seed=11)
    homs = torch.cat([homs, homs.flip(1)], 1).contiguous()
    valid[2] = False
    homs[:, 300:2048:97, 1, 1] = torch.nan
    homs[:, 5:2048:131, 2, 0] = -torch.inf
    counts = _hold_ransac(homs, p1, p2, valid)
    assert not counts[2].any() and int(counts.max()) > 100


@pytest.mark.gpu
def test_ransac_score_kernel_at_the_w_guard_on_card():
    """|w| at the guard, the float nearest 1e-12 (not above it: no point
    counts) and the next float up (every point an inlier), either sign,
    with p2 where the hypothesis sends p1."""
    dev = _cuda()
    c0 = np.float32(1e-12)
    ws = [c0, np.nextafter(c0, np.float32(1)), -c0,
          -np.nextafter(c0, np.float32(1)), np.nextafter(c0, np.float32(0))]
    m = 300
    p1 = (torch.rand((1, m, 2), generator=torch.Generator().manual_seed(2))
          - 0.5) * 100
    for w in ws:
        homs = torch.eye(3).repeat(1, 4, 1, 1)
        homs[0, 1, 2, 2] = float(w)
        p2 = (p1.to(dev) * (1.0 / torch.tensor(float(w), device=dev)))
        valid = torch.ones((1, m), dtype=torch.bool)
        counts = _hold_ransac(homs, p1, p2.cpu(), valid)
        above = abs(float(w)) > float(c0)
        assert int(counts[0, 1]) == (m if above else 0), (w, counts)


@pytest.mark.gpu
def test_match_graph_kernel_equals_plain_eager_on_card(monkeypatch):
    """A world of ``cmu2_15x1mp``'s shape (15 views of 864x1152, overlap
    0.45) through ``match_all_pairs`` replayed (the kernel) against the
    same steps run eagerly with the plain scorer, on the same uniforms:
    every row bit for bit (``idx``, ``inlier``, ``hom``, ``n_inliers``,
    ``ok``); one kernel call a chunk in a replay."""
    from pano360_tpu_torch import pipeline
    from pano360_tpu_torch.ops import ransac as R
    dev = _cuda()
    imgs, _, _ = synth.make_views(n_views=15, shape=(864, 1152),
                                  overlap=0.45, seed=42)
    u8 = [(im * 255).astype(np.uint8) for im in imgs]
    _, feats = pipeline.upload_extract(u8, dev)
    _, kp, ds, va, _ = pipeline.sift_buffers(u8, feats)
    cap = kp.shape[1]
    chunks = -(-105 // max(1, min(16, (1 << 28) // (cap * cap * 4))))
    kernel = pipeline.match_graph(kp, ds, va, seed=5)
    before = LAUNCHES["ransac_score"]
    again = pipeline.match_graph(kp, ds, va, seed=5)
    assert LAUNCHES["ransac_score"] - before == chunks
    monkeypatch.setattr(R, "score",
                        lambda *a: R.score_ref(*a)[:2])
    plain = pipeline.match_graph(kp, ds, va, seed=5, capture=False)
    assert LAUNCHES["ransac_score"] - before == chunks
    for a, b, c in zip(kernel, again, plain):
        assert a.dtype == c.dtype and a.shape == c.shape
        assert a.tobytes() == b.tobytes() == c.tobytes()
    assert int(kernel.ok.sum()) >= 14


# ---------------------------------------------------------------------------
# The multiband blend's blur: the wrapper on the CPU, the kernel, the blend
# ---------------------------------------------------------------------------

# the blend's four blurred levels: sigma sqrt(2 l + 1) 4 (33, 57, 73, 87 taps)
BAND_SIGMAS = tuple(float(np.sqrt(2 * lvl + 1.0) * 4) for lvl in range(4))
RIG_STACK = (33, 352, 1408)     # nsh_rig_33x1mp's patch stack (N, ph, pw)


def _stack(n, h, w, seed=0, dev="cpu"):
    """An (n, h, w, 4) float32 patch stack in [0, 1] whose last channel is
    a 0/1 mask, with each patch's invalid corner zeroed as the warp
    leaves it."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, h, w, 4), generator=g)
    x[..., 3] = (x[..., 3] > 0.3).to(torch.float32)
    for i in range(n):
        x[i, :(i * 7) % h + 1, :(i * 13) % w + 1] = 0.0
    return x.to(dev)


@pytest.mark.parametrize("sigma", BAND_SIGMAS)
def test_band_blur_cpu_takes_plain_version(sigma):
    from pano360_tpu_torch.ops import band_blur as B
    from pano360_tpu_torch.ops.filters import gaussian_blur
    x = _stack(2, 20, 24)
    before = LAUNCHES["band_blur"]
    got = B.band_blur(x, sigma)
    assert _bits(got, gaussian_blur(x, sigma))
    assert LAUNCHES["band_blur"] == before


@pytest.mark.parametrize("case", ["device", "dtype", "channels", "rank",
                                  "contiguity", "taps", "sigma", "empty"])
def test_band_blur_rejects_bad_input(case):
    """Each refusal raises and says what it got."""
    from pano360_tpu_torch.ops import band_blur as B
    x, sigma = _stack(2, 20, 24), 4.0
    want = {"device": "unsupported device meta",
            "dtype": r"got \(2, 20, 24, 4\) torch.float64",
            "channels": r"got \(2, 20, 24, 3\)",
            "rank": r"got \(20, 24, 4\)",
            "contiguity": "must be a contiguous",
            "taps": r"takes 1..127 taps, got 129 \(sigma 15.9\)",
            "sigma": r"got 161 \(sigma 20.0\)",
            "empty": "got N=0, H=20, W=24"}[case]
    if case == "device":
        x = x.to("meta")
    elif case == "dtype":
        x = x.double()
    elif case == "channels":
        x = x[..., :3].contiguous()
    elif case == "rank":
        x = x[0]
    elif case == "contiguity":
        x = x.transpose(1, 2)
    elif case == "taps":               # the first sigma past 127 taps
        sigma = 15.9
    elif case == "sigma":
        sigma = 20.0
    else:
        x = x[:0]
    with pytest.raises(ValueError, match=want):
        B.band_blur(x, sigma)


def test_band_blur_cost_on_the_rig_stack():
    """2 x 16 bytes a pixel and 2 (2k - 1) operations a value: the rig's
    first level is bound by its bytes, the other three by operations, and
    the four together by 0.998 ms."""
    from pano360_tpu_torch.ops import band_blur as B
    from pano360_tpu_torch.ops.filters import auto_ksize
    px = int(np.prod(RIG_STACK))
    ks = [auto_ksize(s) for s in BAND_SIGMAS]
    assert ks == [33, 57, 73, 87]
    costs = [B.band_blur_cost(*RIG_STACK, k) for k in ks]
    for k, c in zip(ks, costs):
        assert c["bytes"] == 32 * px == 523370496
        assert c["flops"] == 2 * (2 * k - 1) * 4 * px
        assert c["bound_ms"] == pytest.approx(
            max(c["bytes"] / 3.35e9, c["flops"] / 67e9), rel=1e-12)
    assert [c["bound_by"] for c in costs] == ["bytes"] + ["operations"] * 3
    assert sum(c["flops"] for c in costs) == 8 * px * 496 == 64_897_941_504
    assert abs(sum(c["bound_ms"] for c in costs) - 0.99792) < 1e-5


def test_band_blur_entry_is_registered():
    assert _kernels._SIGNATURES["band_blur"]["p360_band_blur"]
    assert "band_blur" in LAUNCHES


def test_blend_multiband_blurs_each_level_through_band_blur(monkeypatch):
    """On a CPU sweep the blend calls ``band_blur`` once a blurred level,
    at the level's sigma, on the (N, ph, pw, 4) stack."""
    from torch_warp_scenes import regions as sweep
    calls = []

    def recorded(x, sigma):
        calls.append((tuple(x.shape), sigma))
        return band_blur(x, sigma)
    band_blur = render.band_blur
    monkeypatch.setattr(render, "band_blur", recorded)
    render.stitch(sweep(3, (60, 80), 0.5), device="cpu")
    assert [s for _, s in calls] == list(BAND_SIGMAS)
    assert len({shape for shape, _ in calls}) == 1
    assert calls[0][0][0] == 3 and calls[0][0][3] == 4


def _hold_band_blur(x, sigma):
    """The kernel against the plain blur on the card, bit for bit: one
    launch counted a call."""
    from pano360_tpu_torch.ops import band_blur as B
    from pano360_tpu_torch.ops.filters import gaussian_blur
    before = LAUNCHES["band_blur"]
    got = B.band_blur(x, sigma)
    assert LAUNCHES["band_blur"] == before + 1
    assert got.is_contiguous() and got.shape == x.shape
    want = gaussian_blur(x, sigma)
    assert _bits(got, want), float((got - want).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("sigma", BAND_SIGMAS)
def test_band_blur_kernel_matches_plain_on_the_rig_stack(sigma):
    _hold_band_blur(_stack(*RIG_STACK, seed=3, dev=_cuda()), sigma)


@pytest.mark.gpu
@pytest.mark.parametrize("sigma", [BAND_SIGMAS[0], BAND_SIGMAS[3]])
@pytest.mark.parametrize("n,h,w", [(3, 97, 300), (2, 20, 24), (1, 352, 1408),
                                   (4, 65, 257), (2, 1, 5), (1, 130, 1),
                                   (1, 1, 1)])
def test_band_blur_kernel_ragged_shapes(n, h, w, sigma):
    """ph and pw off the tiles (64 rows, 32 and 256 columns), pads wider
    than the axis (a 20 x 24 patch at 87 taps), N = 1, axes of one."""
    _hold_band_blur(_stack(n, h, w, seed=n + h + w, dev=_cuda()), sigma)


@pytest.mark.gpu
@pytest.mark.parametrize("sigma,ksize", [(0.01, 1), (0.1, 3), (0.5, 5),
                                         (0.8, 7), (1.0, 9), (15.8, 127)])
def test_band_blur_kernel_other_tap_counts(sigma, ksize):
    """Fewer taps than a thread's 8 outputs, and the capacity."""
    from pano360_tpu_torch.ops.filters import auto_ksize
    assert auto_ksize(sigma) == ksize
    _hold_band_blur(_stack(2, 70, 300, seed=9, dev=_cuda()), sigma)


def _rig_regions():
    """``tests/test_torch_rig.py``'s 7-view rig at its true cameras."""
    from portbench.world import make_world
    from pano360_tpu_torch.register import PanoImage
    from test_torch_rig import TRAFFIC
    world = make_world(TRAFFIC, 20261017, 0, torch.device("cpu"))
    intr = np.diag([world.focal, world.focal, 1.0])
    return [PanoImage(v, r, intr.copy())
            for v, r in zip(world.views, world.rots)]


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["sweep", "periodic", "rig"])
def test_blend_with_the_kernel_equals_the_plain_blur_on_card(scene,
                                                             monkeypatch):
    """``render.stitch`` on the card with the kernel, then with the plain
    blur in its place: each level's blurred stack bit for bit, the same
    mosaic, 4 launches a blend."""
    from torch_warp_scenes import regions as sweep
    from pano360_tpu_torch.ops.filters import gaussian_blur
    dev = _cuda()
    regs, max_res = {"sweep": lambda: (sweep(3, (120, 160), 0.5), 1400),
                     "periodic": lambda: (sweep(8, (120, 320), 0.1), 400),
                     "rig": lambda: (_rig_regions(), 1400)}[scene]()
    runs = []
    for blur in (render.band_blur, gaussian_blur):
        levels = []

        def recorded(x, sigma, blur=blur):
            levels.append(blur(x, sigma))
            return levels[-1]
        monkeypatch.setattr(render, "band_blur", recorded)
        before = LAUNCHES["band_blur"]
        mosaic = render.stitch(regs, max_resolution=max_res, device=dev)
        runs.append((mosaic, levels, LAUNCHES["band_blur"] - before))
    (kern, k_levels, k_count), (plain, p_levels, p_count) = runs
    assert (k_count, p_count) == (4, 0)
    assert len(k_levels) == len(p_levels) == 4
    for a, b in zip(k_levels, p_levels):
        assert _bits(a, b)
    assert kern.shape == plain.shape and np.array_equal(kern, plain)
    assert kern.any()


# ---------------------------------------------------------------------------
# The match's top-2 search: the wrapper on the CPU, the plain rules, the
# kernel against float64 and against the plain chain
# ---------------------------------------------------------------------------


def test_knn2_cpu_takes_plain_version():
    from pano360_tpu_torch import match as pm
    from pano360_tpu_torch.ops import knn2 as K
    args = knn2_inputs(3, 100, 90, 64, seed=4)
    before = LAUNCHES["knn2"]
    got = K.knn2(*args, 0.7)
    want = K.knn2_ref(*args, 0.7)
    via = pm.knn2_matches(*args)
    assert LAUNCHES["knn2"] == before
    for a, b in ((got, want), (via, want)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.bool
    assert 30 < int(got[1].sum()) < 300


@pytest.mark.parametrize("case", ["device", "width", "wide", "rank",
                                  "valid dtype", "valid shape", "pairs",
                                  "no columns", "int descriptors"])
def test_knn2_refuses_what_the_kernel_cannot_take(case):
    """The checks a CUDA tensor meets before a launch (``_checked``, run
    here on CPU tensors), and an unknown device."""
    from pano360_tpu_torch.ops import knn2 as K
    d1, d2, v1, v2 = knn2_inputs(2, 20, 30, 64)
    want = "must be"
    if case == "device":
        with pytest.raises(ValueError, match="unsupported device"):
            K.knn2(*(t.to("meta") for t in (d1, d2, v1, v2)), 0.7)
        return
    if case == "width":
        d1, d2, want = d1[..., :40], d2[..., :40], "multiple of 32"
    elif case == "wide":
        d1, d2, want = d1.repeat(1, 1, 3), d2.repeat(1, 1, 3), "up to 128"
    elif case == "rank":
        d1 = d1[0]
    elif case == "valid dtype":
        v2 = v2.to(torch.uint8)
    elif case == "valid shape":
        v1 = v1[:, :-1]
    elif case == "pairs":
        d2, v2 = d2[:1], v2[:1]
    elif case == "no columns":
        d2, v2, want = d2[:, :0], v2[:, :0], "at least one"
    else:
        d1 = d1.to(torch.int32)
    with pytest.raises(ValueError, match=want):
        K._checked(d1, d2, v1, v2)


@pytest.mark.parametrize("b,m1,m2,sms,want", [
    (1, 8192, 8192, 132, 4),      # MSOP: 64 row tiles, 64 column tiles
    (16, 2048, 2048, 132, 1),     # the rig's chunk: 256 blocks
    (16, 1024, 1024, 132, 2),     # the bench world's chunk
    (9, 2048, 2048, 132, 3),      # a last, short chunk: 432 blocks
    (1, 64, 64, 132, 1), (1, 1000, 64, 132, 1)])
def test_knn2_slices(b, m1, m2, sms, want):
    """The column slices fill the card's two blocks a multiprocessor in
    as few waves of as few tiles as the shapes allow, the fewest slices
    among equals, never more than the column tiles."""
    from pano360_tpu_torch.ops import knn2 as K
    s = K.slices(b, m1, m2, sms)
    assert s == want
    tiles = -(-m2 // K.COLS)
    assert 1 <= s <= tiles


def test_knn2_cost_at_the_chunks_of_the_main_path():
    """MSOP's chunk (6,500 of 8,192 columns valid) and the rig's (1,950 of
    2,048 a pair), bound by operations over the valid columns: the cross
    term's 2 D a (row, valid column) and the distance's two, 0.103 and
    0.246 ms at 67 TFLOP/s; with every column valid, 0.130 ms."""
    from pano360_tpu_torch.ops import knn2 as K
    msop = K.knn2_cost(1, 8192, 8192, 64, cols=6500)
    assert msop["bound_by"] == "operations"
    assert msop["flops"] == (2 * 8192 * 6500 * 64 + 2 * (8192 + 6500) * 64
                             + 2 * 8192 * 6500 + 3 * 8192)
    assert msop["bytes"] == 4 * (8192 + 6500) * 64 + 16384 + 9 * 8192
    assert 0.1030 < msop["bound_ms"] < 0.1037
    rig = K.knn2_cost(16, 2048, 2048, 128, cols=16 * 1950)
    assert rig["bound_by"] == "operations"
    assert 0.2460 < rig["bound_ms"] < 0.2466
    full = K.knn2_cost(1, 8192, 8192, 64)
    assert full == K.knn2_cost(1, 8192, 8192, 64, cols=8192)
    assert 0.128 < full["bound_ms"] < 0.132


def test_knn2_entry_is_registered():
    assert _kernels._SIGNATURES["knn2"]["p360_knn2"]
    assert "knn2" in LAUNCHES


def _knn2_rule_case(case):
    """One pair whose answer a rule of the plain chain decides, on
    integer descriptors (every distance exact in float32): -> (inputs,
    the index and test of row 0)."""
    d = 64
    desc2 = torch.zeros((1, 6, d))
    for j in range(6):
        desc2[0, j, j] = 4.0 + j
    desc1 = torch.zeros((1, 2, d))
    desc1[0, 0, 3] = 7.0               # nearest to column 3
    valid1 = torch.ones((1, 2), dtype=torch.bool)
    valid2 = torch.ones((1, 6), dtype=torch.bool)
    if case == "duplicates":           # columns 3 and 5 the same row
        desc2[0, 5] = desc2[0, 3]
        return (desc1, desc2, valid1, valid2), 3, False
    if case == "one valid column":
        valid2[:] = False
        valid2[0, 4] = True
        return (desc1, desc2, valid1, valid2), 4, False
    if case == "no valid column":
        valid2[:] = False
        return (desc1, desc2, valid1, valid2), 0, False
    if case == "invalid row":
        valid1[0, 0] = False
        return (desc1, desc2, valid1, valid2), 3, False
    return (desc1, desc2, valid1, valid2), 3, True     # "clear"


KNN2_RULES = ["clear", "duplicates", "one valid column", "no valid column",
              "invalid row"]


@pytest.mark.parametrize("case", KNN2_RULES)
def test_knn2_plain_rules(case):
    """The rules the kernel reproduces: the first index of the smallest
    distance; a second column at the nearest's distance fails the test;
    a row with one valid column fails it; a row with none takes index 0
    and fails; an invalid row fails."""
    from pano360_tpu_torch.ops import knn2 as K
    args, idx, good = _knn2_rule_case(case)
    bi, g = K.knn2_ref(*args, 0.7)
    assert int(bi[0, 0]) == idx and bool(g[0, 0]) == good


@pytest.mark.parametrize("d", [64, 128])
def test_knn2_rounding_margin_bounds_the_plain_distances(d):
    """The stated margin holds the plain chain's float32 squared distances
    to float64's on every valid (row, column), with room: the largest
    gap stays under a tenth of it."""
    from pano360_tpu_torch.ops import knn2 as K
    d1, d2, v1, v2 = knn2_inputs(2, 300, 400, d, seed=d, ragged=False)
    a, c = d1.double(), d2.double()
    exact = ((a[:, :, None] - c[:, None]) ** 2).sum(-1)
    s1, s2 = (d1 * d1).sum(-1), (d2 * d2).sum(-1)
    f32 = torch.clamp(s1[..., None] + s2[:, None] - 2.0 * (d1 @ d2.mT),
                      min=0.0)
    margin = K.rounding_margin(s1.double()[..., None],
                               s2.double()[:, None], d)
    gap = (f32.double() - exact).abs()
    assert (gap <= 0.1 * margin).all(), float((gap / margin).max())


def _hold_knn2(args, ratio=0.7):
    """The kernel on the card against float64 and against the plain chain
    run there: one launch; no row a float32 search may not give, for
    either; -> (the kernel's rows that differ from float64, the chain's,
    the rows where the two differ, the kernel's result)."""
    from pano360_tpu_torch.ops import knn2 as K
    dev = _cuda()
    args = [t.to(dev) for t in args]
    before = LAUNCHES["knn2"]
    got = K.knn2(*args, ratio)
    assert LAUNCHES["knn2"] == before + 1
    plain = K.knn2_ref(*args, ratio)
    (k_wrong, k_differ), (p_wrong, p_differ) = knn2_misses(
        [got, plain], *args, ratio)
    assert (k_wrong, p_wrong) == (0, 0), (k_wrong, p_wrong)
    between = int((args[2] & ((got[0] != plain[0])
                              | (got[1] != plain[1]))).sum())
    return k_differ, p_differ, between, got


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,m", [(1, 64), (16, 64), (1, 1000), (16, 1000),
                                 (1, 2048), (16, 2048), (1, 8192),
                                 (16, 8192)])
def test_knn2_kernel_against_float64_and_plain_on_card(b, m, d):
    """Ragged masks, M a tile multiple or not, one pair or sixteen: every
    valid row's index an exact nearest within the margin and its test the
    exact one off the ratio's line; no more rows differing from float64
    at all than the chain's, and few differing from the chain."""
    args = knn2_inputs(b, m, m, d, seed=b * m + d)
    k_differ, p_differ, between, got = _hold_knn2(args)
    rows = int(args[2].sum())
    assert k_differ <= p_differ, (k_differ, p_differ, rows)
    assert between <= max(2, rows // 1000), between
    assert int(got[1].sum()) > 0.1 * rows


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_knn2_kernel_ranks_near_ties_as_float64_on_card(d):
    """desc2's second half a copy of its first moved by ~1e-6, desc1 noisy
    copies of the first half: each row's two nearest lie within float32
    rounding of each other, so the plain chain's rounding picks either;
    the kernel ranks the two on their float64 distances and gives
    float64's index and test on every row."""
    from pano360_tpu_torch.ops import knn2 as K
    dev = _cuda()
    b, m = 4, 1024
    d1, d2, v1, v2 = knn2_inputs(b, m, m, d, seed=d, ragged=False)
    g = torch.Generator().manual_seed(d + 1)
    half = m // 2
    d2[:, half:] = d2[:, :half] + 1e-6 * torch.randn((b, half, d),
                                                      generator=g)
    pick = torch.randint(0, half, (b, m), generator=g)
    d1 = torch.gather(d2, 1, pick[..., None].expand(-1, -1, d))
    d1 = d1 + 0.05 * torch.randn((b, m, d), generator=g) * d1.abs().mean()
    args = [t.to(dev) for t in (d1, d2, v1, v2)]
    got = K.knn2(*args, 0.7)
    plain = K.knn2_ref(*args, 0.7)
    (k_wrong, k_differ), (p_wrong, p_differ) = knn2_misses(
        [got, plain], *args)
    assert (k_wrong, k_differ) == (0, 0), (k_wrong, k_differ, p_differ)
    assert p_wrong == 0 and p_differ > 0, p_differ


@pytest.mark.gpu
@pytest.mark.parametrize("b,m1,m2,d", [(1, 64, 64, 64), (3, 300, 1000, 64),
                                       (16, 1024, 777, 128),
                                       (2, 8192, 4100, 64), (1, 5, 3, 32)])
def test_knn2_kernel_equals_plain_on_exact_integers_on_card(b, m1, m2, d):
    """Small integer descriptors make every norm, dot product and distance
    exact in float32 in both versions, and ties frequent: the kernel must
    give the plain chain's indices and tests bit for bit (the first
    index of a tie; a second column at the nearest's distance fails the
    test), with ragged masks and M1 != M2."""
    from pano360_tpu_torch.ops import knn2 as K
    dev = _cuda()
    g = torch.Generator().manual_seed(b + m1 + m2 + d)
    desc1 = torch.randint(-3, 4, (b, m1, d), generator=g).float()
    desc2 = torch.randint(-3, 4, (b, m2, d), generator=g).float()
    desc1[:, ::7] = desc2[:, :1].expand(-1, len(range(0, m1, 7)), -1)
    desc2[:, -1] = desc2[:, 0]                  # a duplicate column
    valid1 = torch.rand((b, m1), generator=g) < 0.9
    valid2 = torch.rand((b, m2), generator=g) < 0.8
    valid2[:, 0] = True
    args = [t.to(dev) for t in (desc1, desc2, valid1, valid2)]
    got = K.knn2(*args, 0.7)
    want = K.knn2_ref(*args, 0.7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", KNN2_RULES)
def test_knn2_kernel_rules_on_card(case):
    from pano360_tpu_torch.ops import knn2 as K
    dev = _cuda()
    args, idx, good = _knn2_rule_case(case)
    args = [t.to(dev) for t in args]
    bi, g = K.knn2(*args, 0.7)
    want = K.knn2_ref(*args, 0.7)
    assert torch.equal(bi, want[0]) and torch.equal(g, want[1])
    assert int(bi[0, 0]) == idx and bool(g[0, 0]) == good


@pytest.mark.gpu
def test_knn2_kernel_rows_and_columns_without_a_valid_partner_on_card():
    """Pairs whose desc2 is all invalid (every index 0, no test passed),
    valid only in an inner tile, or valid only at its last column; every
    desc1 row invalid."""
    from pano360_tpu_torch.ops import knn2 as K
    dev = _cuda()
    d1, d2, v1, v2 = knn2_inputs(4, 700, 900, 128, seed=5, ragged=False)
    v2[0] = False
    v2[1] = False
    v2[1, 300:420] = True
    v2[2] = False
    v2[2, -1] = True
    v1[3] = False
    args = [t.to(dev) for t in (d1, d2, v1, v2)]
    bi, g = K.knn2(*args, 0.7)
    assert not bi[0].any() and not g[0].any() and not g[3].any()
    assert bool(((bi[1] >= 300) & (bi[1] < 420)).all())
    assert bool((bi[2] == 899).all()) and not g[2].any()
    k_differ, p_differ, _, _ = _hold_knn2([t.cpu() for t in args])
    assert k_differ <= p_differ, (k_differ, p_differ)


@pytest.mark.gpu
def test_knn2_kernel_slices_change_no_bit_on_card(monkeypatch):
    """One slice, the chosen count and many: the same indices and tests."""
    from pano360_tpu_torch.ops import knn2 as K
    dev = _cuda()
    args = [t.to(dev) for t in knn2_inputs(2, 3000, 8192, 64, seed=8)]
    runs = []
    for s in (None, 1, 7, 64):
        if s is not None:
            monkeypatch.setattr(K, "slices", lambda *a, s=s: s)
        runs.append(K.knn2(*args, 0.7))
    for bi, g in runs[1:]:
        assert torch.equal(bi, runs[0][0]) and torch.equal(g, runs[0][1])


@pytest.mark.gpu
def test_knn2_kernel_replayed_equals_eager_on_card():
    """A chunk's search captured in a CUDA graph (``graphs.Replayed``)
    and replayed on new inputs copied into its static buffers: equal to
    the eager call on them; one launch counted a replay."""
    from pano360_tpu_torch import graphs
    from pano360_tpu_torch.ops import knn2 as K
    dev = _cuda()

    def step(state):
        state["best"], state["good"] = K.knn2(
            state["d1"], state["d2"], state["v1"], state["v2"], 0.7)
    first = [t.to(dev) for t in knn2_inputs(16, 2048, 2048, 128, seed=1)]
    state = dict(zip(("d1", "d2", "v1", "v2"), first))
    replay = graphs.Replayed(step, state)
    replay()
    for seed in (2, 3):
        new = [t.to(dev) for t in knn2_inputs(16, 2048, 2048, 128,
                                               seed=seed)]
        for k, t in zip(("d1", "d2", "v1", "v2"), new):
            state[k].copy_(t)
        before = LAUNCHES["knn2"]
        replay()
        assert LAUNCHES["knn2"] == before + 1
        eager = K.knn2(*new, 0.7)
        assert torch.equal(state["best"], eager[0])
        assert torch.equal(state["good"], eager[1])


def _cell_world_features(cell):
    """World 0 of a benchmark cell (its fixed seed) on the card and the
    match graph's buffers of its detector: -> (kp, desc, valid)."""
    import json
    import os
    from pano360_tpu_torch import pipeline
    from portbench.run import FIXED_SEED
    from portbench.world import make_world
    dev = _cuda()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec = next(w for w in bench["workloads"] if w["name"] == cell)
    conf = next(c for c in bench["configs"] if c["name"] == spec["config"])
    traffic = json.load(open(os.path.join(root, "portbench", "workloads",
                                          spec["traffic"] + ".json")))
    flags = json.load(open(os.path.join(root, conf["file"])))["flags"]
    views = make_world(traffic, FIXED_SEED, 0, dev).views
    if "msop" in flags:
        feats = pipeline.msop_extract(views, dev)
        return feats.kp, feats.desc, feats.valid
    _, feats = pipeline.upload_extract(views, dev, capture=False)
    _, kp, ds, va, _ = pipeline.sift_buffers(views, feats)
    return kp, ds, va


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["cmu1_msop_15x1mp", "nsh_rig_33x1mp",
                                  "cmu2_15x1mp", "uav_12x1mp",
                                  "lunchroom_10x1.5mp"])
def test_knn2_kernel_on_the_cells_world_0_on_card(cell):
    """Every pair of a cell's world 0 in the match graph's chunks: the
    kernel differs from float64 on no more rows than the cuBLAS chain
    does, and on no row beyond a float32 search's margin; the replayed
    match graph launches it once a chunk."""
    from pano360_tpu_torch import pipeline
    kp, ds, va = _cell_world_features(cell)
    n, cap = kp.shape[:2]
    pairs = torch.tensor([(a, b) for a in range(n) for b in range(a + 1, n)],
                         device=kp.device)
    batch = max(1, min(16, (1 << 28) // (cap * cap * 4)))
    k_all = p_all = rows = 0
    for lo in range(0, len(pairs), batch):
        pa, pb = pairs[lo:lo + batch, 0], pairs[lo:lo + batch, 1]
        args = [ds[pa], ds[pb], va[pa], va[pb]]
        k_differ, p_differ, _, _ = _hold_knn2([t.cpu() for t in args])
        k_all, p_all = k_all + k_differ, p_all + p_differ
        rows += int(va[pa].sum())
    print(f"{cell}: rows differing from float64: kernel {k_all}, chain "
          f"{p_all}, of {rows} valid rows")
    assert k_all <= p_all, (cell, k_all, p_all)
    pipeline.match_graph(kp, ds, va, seed=3)
    before = LAUNCHES["knn2"]
    pipeline.match_graph(kp, ds, va, seed=3)
    assert LAUNCHES["knn2"] - before == -(-len(pairs) // batch)
