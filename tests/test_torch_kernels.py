"""The port's CUDA kernels and their wrappers (no jax in this file).

On a CPU tensor each wrapper must take its plain PyTorch version and
launch nothing; on another device it must raise. The ``gpu`` tests hold
each CUDA kernel to its plain version on the card and skip without one;
they run on a GPU machine (which has no jax) with
``python -m pytest --noconftest tests/test_torch_kernels.py``.

Tolerances on the card: Gaussian and DoG layers 1e-5 (separate
multiply and add in both versions; the kernel is built with
-fmad=false), score flips <= 0.1% of candidates, warp masks (exact and
mip-sampled) equal on >= 99.99% of pixels and patches within 1e-4 where
both are valid (the mip warp's RGB also where both are invalid: the
multiband blender blurs it into valid pixels).
"""
import math

import numpy as np
import pytest
import torch

from pano360_tpu_torch import render
from pano360_tpu_torch import synth
from pano360_tpu_torch.features import sift as S
from pano360_tpu_torch.ops import gauss_octave as G
from pano360_tpu_torch.ops import warp_kernel as W
from pano360_tpu_torch.ops import warp_mip as M
from pano360_tpu_torch.ops.color import bgr2gray
from pano360_tpu_torch.register import PanoImage

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


def _regions(n_views, shape, overlap, seed=5):
    imgs, rots, focal = synth.make_views(n_views=n_views, shape=shape,
                                         overlap=overlap, seed=seed)
    intr = np.diag([focal, focal, 1.0])
    return [PanoImage((im * 255).astype(np.uint8), r, intr.copy())
            for im, r in zip(imgs, rots)]


def _warp_setup(regions, max_resolution, projection=None):
    """(rgba, projs, bottoms, resolution, range_min), layout, numpy projs
    of a render of ``regions`` (CPU tensors)."""
    from pano360_tpu_torch import geometry
    proj = geometry.PROJECTIONS[projection or "spherical"]
    rgba, lay = render.prepare(regions, "multiband", max_resolution, "cpu",
                               projection=proj)
    projs = np.stack([r.proj() for r in regions])
    t = dict(dtype=torch.float32)
    args = (rgba, torch.as_tensor(projs, **t),
            torch.as_tensor(lay.bottoms, **t),
            torch.as_tensor(lay.resolution, **t),
            torch.as_tensor(lay.im_range[0], **t))
    return args, lay, projs


@pytest.fixture(scope="module", params=["spherical", "cylindrical"])
def warp_scene(request):
    """Ground-truth cameras of a 3-view sweep and their render layout."""
    args, lay, _ = _warp_setup(_regions(3, (120, 160), 0.5), 1400,
                               request.param)
    wins = torch.as_tensor(lay.wins, dtype=torch.float32)
    return args + (lay.ph, lay.pw), wins, lay.period, \
        request.param == "cylindrical"


# two views of 300x700 under a 120-px cap (aperiodic), and a 401-degree
# sweep of eight 120x320 views on a periodic 400-px canvas
MIP_SCENES = {"aperiodic": ((2, (300, 700), 0.5), 120),
              "periodic": ((8, (120, 320), 0.1), 400)}


@pytest.fixture(scope="module", params=sorted(MIP_SCENES))
def mip_scene(request):
    """A mip plan whose tiles are spread over levels 0-3 (the plan's own
    levels replaced by (k + i + j) % 4, origins clamped into each level),
    on patches cut to ragged sizes (not multiples of the 32x128 tile)."""
    view_args, max_res = MIP_SCENES[request.param]
    (rgba, *args), lay, projs = _warp_setup(_regions(*view_args), max_res)
    ph, pw = lay.ph - 3, lay.pw - 5
    origins, ok, wy, wx, nl = M.plan_windows(
        projs, lay.bottoms, lay.resolution, lay.im_range[0], rgba.shape[1:3],
        ph, pw, period=lay.period)
    assert ok and nl >= 2
    mips = M.build_mips(rgba, 4, wy, wx)
    k, i, j = np.meshgrid(*(np.arange(s) for s in origins.shape[:3]),
                          indexing="ij")
    lvl = (k + i + j) % 4
    hp = np.array([m.shape[1] for m in mips])[lvl]
    wp = np.array([m.shape[2] for m in mips])[lvl]
    origins[..., 0] = np.minimum(origins[..., 0], hp - wy) // 8 * 8
    origins[..., 1] = np.minimum(origins[..., 1], wp - wx) // 128 * 128
    origins[..., 2] = lvl
    wins = torch.as_tensor(lay.wins, dtype=torch.float32)
    return dict(mips=mips, args=args, origins=origins, ph=ph, pw=pw,
                win=(wy, wx), hw=tuple(rgba.shape[1:3]), wins=wins,
                period=lay.period)


def _mip_call(fn, sc, dev="cpu", **over):
    kw = dict(sc, **over)
    return fn([m.to(dev) for m in kw["mips"]],
              *[a.to(dev) for a in kw["args"]], kw["origins"], kw["ph"],
              kw["pw"], *kw["win"], kw["hw"], wins=kw["wins"].to(dev),
              period=kw["period"])


def _on(dev, args):
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args)


# ---------------------------------------------------------------------------
# Wrappers on the CPU
# ---------------------------------------------------------------------------

def test_octave_stack_cpu_tensor_takes_plain_version(octave_base):
    before = G.launches
    outs = G.octave_stack(octave_base, TAPS, SCORE_CFG)
    refs = G.octave_stack_ref(octave_base, TAPS, SCORE_CFG)
    for a, b in zip(outs, refs):
        assert torch.equal(a, b)
    assert G.launches == before


def test_octave_stack_rejects_unknown_device():
    base = torch.empty((1, 64, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        G.octave_stack(base, TAPS)


def test_octave_stack_ref_refuses_illegal_pad():
    with pytest.raises(ValueError, match="too small"):
        G.octave_stack_ref(torch.zeros((1, 40, 80)), TAPS)


def test_backward_warp_cpu_tensor_takes_plain_version(warp_scene):
    args, wins, period, cyl = warp_scene
    before = W.launches
    a = W.backward_warp(*args, wins=wins, period=period, cylindrical=cyl)
    b = W.backward_warp_ref(*args, wins=wins, period=period,
                            cylindrical=cyl)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert W.launches == before
    assert (~a[1]).sum() > 1000


def test_backward_warp_mip_cpu_tensor_takes_plain_version(mip_scene):
    before = M.launches
    a = _mip_call(M.backward_warp_mip, mip_scene)
    b = _mip_call(M.backward_warp_mip_ref, mip_scene)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert M.launches == before
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
            _mip_call(M.backward_warp_mip, mip_scene, origins=origins)
    with pytest.raises(ValueError, match="unsupported device"):
        _mip_call(M.backward_warp_mip, mip_scene, dev="meta")


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
    before = G.launches
    outs = G.octave_stack(base, taps, score_cfg)
    refs = G.octave_stack_ref(base, taps, score_cfg)
    torch.cuda.synchronize()
    assert G.launches == before + 1
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


@pytest.mark.gpu
@pytest.mark.parametrize("periodic", [False, True])
def test_backward_warp_kernel_matches_plain_on_card(warp_scene, periodic):
    dev = _cuda()
    args, wins, period, cyl = warp_scene
    args = _on(dev, args)
    kw = dict(wins=wins.to(dev), period=period, cylindrical=cyl)
    if periodic:      # a seam-crossing window: fold columns past 1/3 turn
        kw["period"] = args[-1] // 3 + 7
    kp, ki = W.backward_warp(*args, **kw)
    rp, ri = W.backward_warp_ref(*args, **kw)
    torch.cuda.synchronize()
    assert float((ki != ri).float().mean()) <= 1e-4
    both = ~ki & ~ri
    assert int(both.sum()) > 1000
    assert float((kp - rp)[both].abs().max()) <= 1e-4
    assert float(kp[ki][:, 3].abs().max()) == 0.0


@pytest.mark.gpu
def test_backward_warp_mip_kernel_matches_plain_on_card(mip_scene):
    dev = _cuda()
    before = M.launches
    kp, ki = _mip_call(M.backward_warp_mip, mip_scene, dev)
    rp, ri = _mip_call(M.backward_warp_mip_ref, mip_scene, dev)
    torch.cuda.synchronize()
    assert M.launches == before + 1
    assert float((ki != ri).float().mean()) <= 1e-4
    both = ~ki & ~ri
    assert int(both.sum()) > 500
    assert float((kp - rp)[both].abs().max()) <= 1e-4
    neither = ki & ri
    assert float((kp - rp)[neither][:, :3].abs().max()) <= 1e-4
    assert float(kp[ki][:, 3].abs().max()) == 0.0


@pytest.mark.gpu
def test_backward_warp_mip_kernel_rejects_bad_input(mip_scene):
    dev = _cuda()
    with pytest.raises(ValueError, match="float32"):
        _mip_call(M.backward_warp_mip, mip_scene, dev,
                  mips=[m.double() for m in mip_scene["mips"]])
    with pytest.raises(ValueError, match="projs"):
        _mip_call(M.backward_warp_mip, mip_scene, dev,
                  args=[mip_scene["args"][0][:1]] + mip_scene["args"][1:])
    org = mip_scene["origins"].copy()
    org[-1, -1, -1, 1] = 1 << 20
    with pytest.raises(ValueError, match="leaves"):
        _mip_call(M.backward_warp_mip, mip_scene, dev, origins=org)


@pytest.mark.gpu
def test_backward_warp_kernel_rejects_bad_input(warp_scene):
    dev = _cuda()
    args, _, _, _ = warp_scene
    args = _on(dev, args)
    with pytest.raises(ValueError, match="float32"):
        W.backward_warp(args[0][..., :3].contiguous(), *args[1:])
    with pytest.raises(ValueError, match="projs"):
        W.backward_warp(args[0], args[1][:1], *args[2:])
