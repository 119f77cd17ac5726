"""Warp scenes shared by the port's kernel and warp-plan tests (no jax):
synthetic sweeps with their ground-truth cameras and render layouts, as
CPU tensors. Test modules import the fixtures by name."""
import numpy as np
import pytest
import torch

from pano360_tpu_torch import geometry, render, synth
from pano360_tpu_torch.ops import warp_mip as M
from pano360_tpu_torch.register import PanoImage


def regions(n_views, shape, overlap, seed=5):
    imgs, rots, focal = synth.make_views(n_views=n_views, shape=shape,
                                         overlap=overlap, seed=seed)
    intr = np.diag([focal, focal, 1.0])
    return [PanoImage((im * 255).astype(np.uint8), r, intr.copy())
            for im, r in zip(imgs, rots)]


def warp_setup(regs, max_resolution, projection=None):
    """(rgba, projs, bottoms, resolution, range_min), layout, numpy projs
    of a render of ``regs`` (CPU tensors)."""
    proj = geometry.PROJECTIONS[projection or "spherical"]
    rgba, lay = render.prepare(regs, "multiband", max_resolution, "cpu",
                               projection=proj)
    projs = np.stack([r.proj() for r in regs])
    t = dict(dtype=torch.float32)
    args = (rgba, torch.as_tensor(projs, **t),
            torch.as_tensor(lay.bottoms, **t),
            torch.as_tensor(lay.resolution, **t),
            torch.as_tensor(lay.im_range[0], **t))
    return args, lay, projs


@pytest.fixture(scope="module", params=["spherical", "cylindrical"])
def warp_scene(request):
    """Ground-truth cameras of a 3-view sweep and their render layout:
    -> ((rgba, projs, bottoms, resolution, range_min, ph, pw), wins,
    period, cylindrical)."""
    args, lay, _ = warp_setup(regions(3, (120, 160), 0.5), 1400,
                              request.param)
    wins = torch.as_tensor(lay.wins, dtype=torch.float32)
    return args + (lay.ph, lay.pw), wins, lay.period, \
        request.param == "cylindrical"


def mixed_regions(shapes=((120, 160), (96, 140), (120, 160), (110, 128))):
    """A sweep whose views have mixed sizes (same focal and texture),
    with its true cameras."""
    big = max(s[1] for s in shapes)
    _, rots, focal = synth.make_views(n_views=len(shapes), shape=(120, big),
                                      overlap=0.5, seed=5)
    tex = synth.world_texture(seed=5)
    intr = np.diag([focal, focal, 1.0])
    return [PanoImage((synth.render_view(tex, r, focal, shp) * 255
                       ).astype(np.uint8), r, intr.copy())
            for r, shp in zip(rots, shapes)]


@pytest.fixture(scope="module", params=["spherical", "cylindrical"])
def mixed_scene(request):
    """Four views of mixed sizes zero-padded into one stack: ->
    ((rgba, projs, bottoms, resolution, range_min, ph, pw), keywords of
    the exact warp with the views' true ``shapes``)."""
    args, lay, _ = warp_setup(mixed_regions(), 1400, request.param)
    assert lay.shapes is not None and args[0].shape[1:3] == (120, 160)
    return args + (lay.ph, lay.pw), dict(
        wins=torch.as_tensor(lay.wins, dtype=torch.float32),
        period=lay.period, cylindrical=request.param == "cylindrical",
        shapes=lay.shapes)


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
    (rgba, *args), lay, projs = warp_setup(regions(*view_args), max_res)
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


def mip_call(fn, sc, dev="cpu", **over):
    """``fn`` (the mip warp or its plain version) on a scene: the levels
    on ``dev``, the small arguments from the host."""
    kw = dict(sc, **over)
    return fn([m.to(dev) for m in kw["mips"]], *kw["args"], kw["origins"],
              kw["ph"], kw["pw"], *kw["win"], kw["hw"], wins=kw["wins"],
              period=kw["period"])
