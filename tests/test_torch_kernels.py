"""The port's two CUDA kernels and their wrappers (no jax in this file).

On a CPU tensor each wrapper must take its plain PyTorch version and
launch nothing; on another device it must raise. The ``gpu`` tests hold
each CUDA kernel to its plain version on the card and skip without one;
they run on a GPU machine (which has no jax) with
``python -m pytest --noconftest tests/test_torch_kernels.py``.

Tolerances on the card: Gaussian and DoG layers 1e-5 (separate
multiply and add in both versions; the kernel is built with
-fmad=false), score flips <= 0.1% of candidates, warp masks equal on
>= 99.99% of pixels and patches within 1e-4 where both are valid.
"""
import math

import numpy as np
import pytest
import torch

from pano360_tpu_torch import render
from pano360_tpu_torch._host import synth
from pano360_tpu_torch.features import sift as S
from pano360_tpu_torch.ops import gauss_octave as G
from pano360_tpu_torch.ops import warp_kernel as W
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


@pytest.fixture(scope="module")
def warp_scene():
    """Ground-truth cameras of a 3-view sweep and their render layout."""
    imgs, rots, focal = synth.make_views(n_views=3, shape=(120, 160),
                                         overlap=0.5, seed=5)
    intr = np.diag([focal, focal, 1.0])
    regions = [PanoImage((im * 255).astype(np.uint8), r, intr.copy())
               for im, r in zip(imgs, rots)]
    rgba, lay = render.prepare(regions, "multiband", 1400, "cpu")
    projs = torch.as_tensor(np.stack([r.proj() for r in regions]),
                            dtype=torch.float32)
    args = (rgba, projs, torch.as_tensor(lay.bottoms, dtype=torch.float32),
            torch.as_tensor(lay.resolution, dtype=torch.float32),
            torch.as_tensor(lay.im_range[0], dtype=torch.float32),
            lay.ph, lay.pw)
    wins = torch.as_tensor(lay.wins, dtype=torch.float32)
    return args, wins, lay.period


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
    args, wins, period = warp_scene
    before = W.launches
    a = W.backward_warp(*args, wins=wins, period=period)
    b = W.backward_warp_ref(*args, wins=wins, period=period)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert W.launches == before
    assert (~a[1]).sum() > 1000


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

def _check_octave(base, score_cfg):
    before = G.launches
    outs = G.octave_stack(base, TAPS, score_cfg)
    refs = G.octave_stack_ref(base, TAPS, score_cfg)
    torch.cuda.synchronize()
    assert G.launches == before + 1
    for a, b in zip(outs[:2], refs[:2]):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5
    if score_cfg is not None:
        flips = int(((outs[2] > 0) != (refs[2] > 0)).sum())
        assert flips <= 1e-3 * max(int((refs[2] > 0).sum()), 1)


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
    args, wins, period = warp_scene
    args = _on(dev, args)
    kw = dict(wins=wins.to(dev), period=period)
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
def test_backward_warp_kernel_rejects_bad_input(warp_scene):
    dev = _cuda()
    args, _, _ = warp_scene
    args = _on(dev, args)
    with pytest.raises(ValueError, match="float32"):
        W.backward_warp(args[0][..., :3].contiguous(), *args[1:])
    with pytest.raises(ValueError, match="projs"):
        W.backward_warp(args[0], args[1][:1], *args[2:])
