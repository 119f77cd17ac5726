"""The warps' plans and the kernels' index logic, on the CPU (no jax in
this file).

- An emulation in PyTorch of the two CUDA kernels' index logic
  (``csrc/backward_warp.cu``, ``csrc/backward_warp_mip.cu``): the tile ->
  block -> thread mapping with its ragged edges (the exact kernel's
  blocks are one row of THREADS pixels), the per-column azimuth, seam
  fold, sin and cos and the per-row tan or height (in the mip kernel's
  tables), each pixel's sums of those products, and the mip tile's
  block-uniform origin, read from the plan's packed buffer. It
  reproduces the plain versions' sample points and outputs bit for
  bit.
- The prepare steps: the packed buffer round-trips every input, and bad
  inputs raise there.
- ``plan_windows`` against its loop form (the JAX package's), kept here
  as the oracle, on a random sweep; the sync-free edge pad against the
  index gather it replaced.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pano360_tpu_torch._kernels import LAUNCHES
from pano360_tpu_torch.ops import warp_kernel as W
from pano360_tpu_torch.ops import warp_mip as M
from pano360_tpu_torch.ops.warp import reflect_index
from torch_warp_scenes import mip_call, mip_scene, warp_scene  # noqa: F401

torch.set_num_threads(1)

CSRC = Path(W.__file__).resolve().parent.parent / "csrc"


def _tiling(stem, names):
    """The kernel's tile constants, read from its source."""
    src = (CSRC / f"{stem}.cu").read_text()
    return [int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in names]


# ---------------------------------------------------------------------------
# The kernels' index logic, emulated
# ---------------------------------------------------------------------------

def _col_terms(prm, cols, res_x, rmin_x, period):
    """warp_common.cuh col_terms: -> the six products with sin/cos of
    each column's azimuth and its window test."""
    px = cols.to(torch.float32) + prm[9]
    px_s = px if period is None else torch.where(px >= period, px - period,
                                                 px)
    xs = px_s * res_x + rmin_x
    sx, cx = torch.sin(xs), torch.cos(xs)
    return dict(ux=prm[0] * sx, uz=prm[2] * cx, vx=prm[3] * sx,
                vz=prm[5] * cx, zx=prm[6] * sx, zz=prm[8] * cx,
                out=(px < prm[11]) | (px >= prm[13]))


def _row_terms(prm, rows, res_y, rmin_y, cylindrical):
    py = rows.to(torch.float32) + prm[10]
    ys = py * res_y + rmin_y
    ty = ys if cylindrical else torch.tan(ys)
    return dict(uy=prm[1] * ty, vy=prm[4] * ty, zy=prm[7] * ty,
                out=(py < prm[12]) | (py >= prm[14]))


def _thread_rows(tx, ty, ry):
    """Which tile pixel each (thread x, thread y, row step) handles, in
    the kernels' order: the thread owns column x and walks rows y + ry k.
    -> (ly, lx) index tensors (ry, tx, ty // ry); each tile pixel exactly
    once."""
    k = torch.arange(ty // ry)
    ly = torch.arange(ry)[:, None, None] + ry * k[None, None, :]
    lx = torch.arange(tx)[None, :, None]
    ly, lx = torch.broadcast_tensors(ly, lx)
    seen = torch.zeros((ty, tx), dtype=torch.int64)
    seen.index_put_((ly.reshape(-1), lx.reshape(-1)),
                    torch.ones(ly.numel(), dtype=torch.int64),
                    accumulate=True)
    assert bool((seen == 1).all())
    return ly, lx


def _emulate(plan, tile, ry, pixel):
    """Run ``pixel`` (one tile's per-pixel stage) over every block of a
    plan's launch in the kernels' grid order and write each output where
    its thread writes it: -> one (N, ph, pw) tensor per output of
    ``pixel``. Rows and columns past the patch are masked, as in the
    kernels; every output pixel is written exactly once."""
    tyy, txx = tile
    prm_all = plan.host[:plan.n * W.PARAM_FLOATS].view(plan.n,
                                                       W.PARAM_FLOATS)
    res = torch.tensor(plan.res, dtype=torch.float32)
    rmin = torch.tensor(plan.rmin, dtype=torch.float32)
    ntx, nty = -(-plan.pw // txx), -(-plan.ph // tyy)
    ly, lx = _thread_rows(txx, tyy, ry)
    outs = None
    writes = torch.zeros((plan.n, plan.ph, plan.pw), dtype=torch.int64)
    for r in range(plan.n):                       # blockIdx.y
        prm = prm_all[r]
        for b in range(nty * ntx):                # blockIdx.x
            x0, y0 = (b % ntx) * txx, (b // ntx) * tyy
            col = _col_terms(prm, x0 + torch.arange(txx), res[0], rmin[0],
                             plan.period)
            row = _row_terms(prm, y0 + torch.arange(tyy), res[1], rmin[1],
                             plan.cylindrical)
            # each thread reads its column's and its rows' terms
            c = {k: v[lx] for k, v in col.items()}
            w = {k: v[ly] for k, v in row.items()}
            vals = pixel(r, b, c, w)
            live = (y0 + ly < plan.ph) & (x0 + lx < plan.pw)
            yy, xx = (y0 + ly)[live], (x0 + lx)[live]
            if outs is None:
                outs = [torch.zeros((plan.n, plan.ph, plan.pw) + v.shape[3:],
                                    dtype=v.dtype) for v in vals]
            for o, v in zip(outs, vals):
                o[r, yy, xx] = v[live]
            writes[r, yy, xx] += 1
    assert bool((writes == 1).all())
    return outs


def _ray(c, w):
    """warp_common.cuh pixel_ray: the same rounded products, summed in
    the plain version's order."""
    return ((c["ux"] + w["uy"]) + c["uz"], (c["vx"] + w["vy"]) + c["vz"],
            (c["zx"] + w["zy"]) + c["zz"])


def _clamp(v, lim):
    return torch.where(torch.isnan(v), torch.zeros_like(v),
                       v.clamp(-lim, lim))


def _blend(t00, t01, t10, t11, fx, fy, bad):
    fx, fy = fx[..., None], fy[..., None]
    top = t00 * (1 - fx) + t01 * fx
    bot = t10 * (1 - fx) + t11 * fx
    out = top * (1 - fy) + bot * fy
    out[..., 3] = torch.where(bad, torch.zeros_like(out[..., 3]),
                              out[..., 3])
    return out


def _emulate_exact(imgs, plan):
    """csrc/backward_warp.cu on the CPU: -> (x_pr, y_pr, invalid,
    patches)."""
    (threads,) = _tiling("backward_warp", ("THREADS",))
    _, h, w, _ = imgs.shape

    def reflect(i, n):             # reflect_idx: in range first
        return torch.where((i >= 0) & (i < n), i, reflect_index(i, n))

    def pixel(r, _, c, rw):
        u, v, z = _ray(c, rw)
        x_pr = u / z + w / 2
        y_pr = v / z + h / 2
        bad = (z < 0) | (x_pr < 0) | (x_pr > w - 1) | (y_pr < 0) | \
            (y_pr > h - 1) | c["out"] | rw["out"]
        xc, yc = _clamp(x_pr, 4.0 * w), _clamp(y_pr, 4.0 * h)
        x0f, y0f = torch.floor(xc), torch.floor(yc)
        ix, iy = x0f.long(), y0f.long()
        ix0, ix1 = reflect(ix, w), reflect(ix + 1, w)
        iy0, iy1 = reflect(iy, h), reflect(iy + 1, h)
        img = imgs[r]
        out = _blend(img[iy0, ix0], img[iy0, ix1], img[iy1, ix0],
                     img[iy1, ix1], xc - x0f, yc - y0f, bad)
        return x_pr, y_pr, bad, out

    return _emulate(plan, (1, threads), 1, pixel)


def _emulate_mip(mips, plan):
    """csrc/backward_warp_mip.cu on the CPU: -> (level x, level y, level,
    oy, ox, invalid, patches); the level coordinates before the window,
    as mip_sample_points gives them."""
    tx, ty, ry = _tiling("backward_warp_mip", ("TILE_X", "TILE_Y", "RY"))
    assert (ty, tx) == (M.TILE_Y, M.TILE_X)
    h, w = plan.img_shape
    wy, wx = plan.win
    org = plan.host[plan.n * W.PARAM_FLOATS:].view(torch.int32).view(
        plan.n, -1, 4)

    def pixel(r, b, c, rw):
        oy, ox, lvl, _ = (int(v) for v in org[r, b])   # block-uniform
        scale = torch.tensor(1.0 / (1 << lvl), dtype=torch.float32)
        u, v, z = _ray(c, rw)
        zs = torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))
        x_pr = u / zs + w / 2
        y_pr = v / zs + h / 2
        bad = (z < 0) | (x_pr < 0) | (x_pr > w - 1) | (y_pr < 0) | \
            (y_pr > h - 1) | c["out"] | rw["out"]
        cx = (x_pr + 0.5) * scale - 0.5
        cy = (y_pr + 0.5) * scale - 0.5
        lx, ly = _clamp(cx - ox, 2.0 ** 24), _clamp(cy - oy, 2.0 ** 24)
        x0f, y0f = torch.floor(lx), torch.floor(ly)
        ix = x0f.long().clamp(0, wx - 2) + ox
        iy = y0f.long().clamp(0, wy - 2) + oy
        img = mips[lvl][r]
        out = _blend(img[iy, ix], img[iy, ix + 1], img[iy + 1, ix],
                     img[iy + 1, ix + 1], lx - x0f, ly - y0f, bad)
        full = torch.full_like(ix, 0)
        return (cx, cy, full + lvl, full + oy, full + ox, bad, out)

    return _emulate(plan, (ty, tx), ry, pixel)


@pytest.mark.parametrize("periodic", [False, True])
def test_exact_kernel_emulation_is_bit_identical(warp_scene, periodic):
    """Spherical and cylindrical, with and without a seam fold."""
    (rgba, projs, bottoms, res, rmin, ph, pw), wins, period, cyl = warp_scene
    if periodic:
        period = pw // 3 + 7
    ph, pw = ph - 3, pw - 5                 # ragged tiles
    kw = dict(wins=wins, period=period, cylindrical=cyl)
    plan = W.prepare_warp(projs, bottoms, wins, res, rmin, ph, pw, period,
                          cyl, "cpu")
    x_pr, y_pr, bad, out = _emulate_exact(rgba, plan)
    rx, ry, rbad = W.sample_points(tuple(rgba.shape[1:3]), projs, bottoms,
                                   res, rmin, ph, pw, **kw)
    assert torch.equal(x_pr, rx) and torch.equal(y_pr, ry)
    assert torch.equal(bad, rbad)
    patches, invalid = W.backward_warp_ref(rgba, projs, bottoms, res, rmin,
                                           ph, pw, **kw)
    assert torch.equal(out, patches) and torch.equal(bad, invalid)
    assert int((~invalid).sum()) > 1000


def test_mip_kernel_emulation_is_bit_identical(mip_scene):
    """Both mip scenes: levels 0-3 spread over the tiles, ragged patch
    sides, one periodic."""
    sc = mip_scene
    projs, bottoms, res, rmin = sc["args"]
    plan = M.prepare_mip_warp(projs, bottoms, sc["wins"], res, rmin,
                              sc["origins"], sc["ph"], sc["pw"], *sc["win"],
                              sc["hw"], [m.shape[1:3] for m in sc["mips"]],
                              sc["period"], device="cpu")
    *points, out = _emulate_mip(sc["mips"], plan)
    ref_points = M.mip_sample_points(
        sc["mips"], projs, bottoms, res, rmin, sc["origins"], sc["ph"],
        sc["pw"], sc["hw"], sc["wins"], sc["period"])
    for a, b in zip(points, ref_points):
        assert torch.equal(a, b.to(a.dtype))
    patches, invalid = mip_call(M.backward_warp_mip_ref, sc)
    assert torch.equal(out, patches) and torch.equal(points[-1], invalid)
    assert int((~invalid).sum()) > 500


# ---------------------------------------------------------------------------
# The prepare steps
# ---------------------------------------------------------------------------

def _exact_inputs(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return dict(projs=rng.normal(size=(n, 3, 3)),
                bottoms=rng.integers(0, 500, (n, 2)),
                wins=np.concatenate([rng.uniform(0, 50, (n, 2)),
                                     rng.uniform(300, 900, (n, 2))], 1),
                resolution=np.array([0.0031, 0.0029]),
                range_min=np.array([-math.pi, -0.7]))


def test_prepare_warp_packs_every_input():
    inp = _exact_inputs()
    plan = W.prepare_warp(**inp, ph=40, pw=70, period=900, cylindrical=True,
                          device="cpu")
    f32 = {k: np.asarray(v, np.float32) for k, v in inp.items()}
    assert plan.params.shape == (3, W.PARAM_FLOATS)
    np.testing.assert_array_equal(plan.projs.numpy(), f32["projs"])
    np.testing.assert_array_equal(plan.bottoms.numpy(), f32["bottoms"])
    np.testing.assert_array_equal(plan.wins.numpy(), f32["wins"])
    assert plan.res == tuple(f32["resolution"].tolist())
    assert plan.rmin == tuple(f32["range_min"].tolist())
    assert (plan.ph, plan.pw, plan.period, plan.cylindrical) == \
        (40, 70, 900, True)
    c = plan.c_launch
    assert (c.n, c.ph, c.pw, c.period, c.cylindrical) == (3, 40, 70, 900, 1)
    assert (c.res_x, c.res_y, c.rmin_x, c.rmin_y) == plan.res + plan.rmin
    default = W.prepare_warp(inp["projs"], inp["bottoms"], None,
                             inp["resolution"], inp["range_min"], 4, 4,
                             device="cpu")
    assert default.wins.tolist() == [[-1.0, -1.0, math.inf, math.inf]] * 3
    assert default.period is None


def test_prepare_warp_rejects_bad_inputs():
    inp = _exact_inputs()
    for key, bad, match in (("projs", np.eye(3), "projs must be"),
                            ("bottoms", np.zeros((3, 3)), "bottoms must be"),
                            ("wins", np.zeros((2, 4)), "wins must be"),
                            ("resolution", torch.zeros(2, device="meta"),
                             "resolution is a meta tensor"),
                            ("range_min", torch.zeros(2, device="meta"),
                             "range_min is a meta tensor")):
        with pytest.raises(ValueError, match=match):
            W.prepare_warp(**dict(inp, **{key: bad}), ph=8, pw=8,
                           device="cpu")
    with pytest.raises(ValueError, match="non-empty patch"):
        W.prepare_warp(**inp, ph=0, pw=8, device="cpu")


def test_launch_warp_cpu_plan_takes_plain_version(warp_scene):
    (rgba, projs, bottoms, res, rmin, ph, pw), wins, period, cyl = warp_scene
    plan = W.prepare_warp(projs.numpy(), bottoms.numpy(), wins.numpy(),
                          res.numpy(), rmin.numpy(), ph, pw, period, cyl,
                          "cpu")
    before = LAUNCHES["backward_warp"]
    a = W.launch_warp(rgba, plan)
    b = W.backward_warp_ref(rgba, projs, bottoms, res, rmin, ph, pw,
                            wins=wins, period=period, cylindrical=cyl)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert LAUNCHES["backward_warp"] == before


def _mip_plan(sc, **over):
    kw = dict(sc, **over)
    projs, bottoms, res, rmin = kw["args"]
    return M.prepare_mip_warp(projs, bottoms, kw["wins"], res, rmin,
                              kw["origins"], kw["ph"], kw["pw"], *kw["win"],
                              kw["hw"], [m.shape[1:3] for m in kw["mips"]],
                              kw["period"], device="cpu")


def test_prepare_mip_warp_packs_every_input(mip_scene):
    sc = mip_scene
    plan = _mip_plan(sc)
    n = len(sc["args"][0])
    np.testing.assert_array_equal(plan.projs.numpy(), sc["args"][0].numpy())
    np.testing.assert_array_equal(plan.bottoms.numpy(),
                                  sc["args"][1].numpy())
    np.testing.assert_array_equal(plan.wins.numpy(), sc["wins"].numpy())
    assert plan.res == tuple(sc["args"][2].tolist())
    packed = plan.host[n * W.PARAM_FLOATS:].view(torch.int32).view(
        *sc["origins"].shape[:3], 4)
    np.testing.assert_array_equal(packed[..., :3].numpy(), sc["origins"])
    assert int(packed[..., 3].abs().max()) == 0
    assert torch.equal(plan.origins_dev, plan.host[n * W.PARAM_FLOATS:].view(
        torch.int32))
    assert plan.dims == tuple(tuple(m.shape[1:3]) for m in sc["mips"])
    c = plan.c_launch
    nl = len(plan.dims)
    assert c.n_levels == nl and (c.win_y, c.win_x) == sc["win"]
    assert (c.h, c.w) == sc["hw"] and (c.vw.ph, c.vw.pw) == (sc["ph"],
                                                             sc["pw"])
    assert list(zip(c.hp[:nl], c.wp[:nl])) == list(plan.dims)
    assert c.vw.period == (sc["period"] or -1) and c.vw.n == n
    assert (plan.win, plan.img_shape, plan.period) == (sc["win"], sc["hw"],
                                                       sc["period"])


def test_prepare_mip_warp_rejects_bad_plans(mip_scene):
    """At prepare time: non-integer origins, a bad shape, a level out of
    range, a window leaving its level, too many levels."""
    sc = mip_scene
    org = sc["origins"]
    bad_level = org.copy()
    bad_level[0, -1, 0, 2] = len(sc["mips"])
    bad_col = org.copy()
    bad_col[-1, 0, -1, 1] = sc["mips"][0].shape[2]
    for origins, match in ((org.astype(np.float64), "integer"),
                           (org[:-1], "origins must be"),
                           (bad_level, "level outside"),
                           (bad_col, "leaves")):
        with pytest.raises(ValueError, match=match):
            _mip_plan(sc, origins=origins)
    with pytest.raises(ValueError, match="levels"):
        _mip_plan(sc, mips=sc["mips"] * 5)
    with pytest.raises(ValueError, match="resolution is a meta tensor"):
        _mip_plan(sc, args=sc["args"][:2] + [torch.zeros(2, device="meta"),
                                             sc["args"][3]])


def test_launch_mip_warp_checks_levels_against_plan(mip_scene):
    sc = mip_scene
    plan = _mip_plan(sc)
    a = M.launch_mip_warp(sc["mips"], plan)
    b = mip_call(M.backward_warp_mip_ref, sc)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="levels"):
        M.launch_mip_warp(sc["mips"][:-1], plan)
    with pytest.raises(ValueError, match="plan's dims"):
        M.launch_mip_warp([m[:, 8:].contiguous() for m in sc["mips"]], plan)


# ---------------------------------------------------------------------------
# plan_windows and the pyramid
# ---------------------------------------------------------------------------

def plan_windows_loop(projs, bottoms, resolution, range_min, img_shape, ph,
                      pw, period=None, cylindrical=False):
    """The loop form of ``plan_windows`` (the JAX package's), the oracle
    of the vectorised one."""
    h, w = img_shape
    n = projs.shape[0]
    nty = -(-ph // M.TILE_Y)
    ntx = -(-pw // M.TILE_X)
    budget_y = M.MAX_WIN_Y - 2 * 8
    budget_x = M.MAX_WIN_X - 2 * 128
    ys = np.arange(nty + 1) * M.TILE_Y
    xs = np.arange(ntx + 1) * M.TILE_X
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    origins = np.zeros((n, nty, ntx, 3), np.int32)
    exts = []
    max_lvl = 0
    need = {}
    for k in range(n):
        gxa = gx + bottoms[k, 0]
        if period is not None:
            gxa = gxa - period * (gxa >= period)
        mx = gxa * resolution[0] + range_min[0]
        my = (gy + bottoms[k, 1]) * resolution[1] + range_min[1]
        sxv, cxv = np.sin(mx), np.cos(mx)
        txv = my if cylindrical else np.tan(my)
        p = projs[k]
        u = p[0, 0] * sxv + p[0, 1] * txv + p[0, 2] * cxv
        v = p[1, 0] * sxv + p[1, 1] * txv + p[1, 2] * cxv
        z = p[2, 0] * sxv + p[2, 1] * txv + p[2, 2] * cxv
        zs = np.where(np.abs(z) > 1e-12, z, 1e-12)
        px = np.clip(u / zs + w / 2, -1, w)
        py = np.clip(v / zs + h / 2, -1, h)
        valid = z > 0
        for i in range(nty):
            for j in range(ntx):
                cpx = px[i:i + 2, j:j + 2]
                cpy = py[i:i + 2, j:j + 2]
                cval = valid[i:i + 2, j:j + 2]
                if not cval.any():
                    continue
                x0 = float(np.floor(cpx[cval].min()))
                x1 = float(np.ceil(cpx[cval].max()))
                y0 = float(np.floor(cpy[cval].min()))
                y1 = float(np.ceil(cpy[cval].max()))
                lvl = 0
                while ((y1 - y0) / (1 << lvl) + 2 * M.MARGIN > budget_y
                       or (x1 - x0) / (1 << lvl) + 2 * M.MARGIN > budget_x):
                    lvl += 1
                max_lvl = max(max_lvl, lvl)
                sy0 = np.floor((y0 + 0.5) / (1 << lvl) - 0.5) - M.MARGIN
                sx0 = np.floor((x0 + 0.5) / (1 << lvl) - 0.5) - M.MARGIN
                sy1 = np.ceil((y1 + 0.5) / (1 << lvl) - 0.5) + M.MARGIN
                sx1 = np.ceil((x1 + 0.5) / (1 << lvl) - 0.5) + M.MARGIN
                ny, nx = need.get(lvl, (1, 1))
                need[lvl] = (max(ny, int(sy1 - sy0)),
                             max(nx, int(sx1 - sx0)))
                exts.append((k, i, j, sy0, sx0, lvl))

    def round_up(v, m):
        return -(-v // m) * m

    need_y = max((v[0] for v in need.values()), default=1)
    need_x = max((v[1] for v in need.values()), default=1)
    _, (hp0, wp0) = M._level_dims((h, w), 0)
    win_y = min(round_up(need_y, 8) + 8, hp0)
    win_x = min(round_up(need_x, 128) + 128, wp0)
    ok = win_y <= M.MAX_WIN_Y and win_x <= M.MAX_WIN_X
    for k, i, j, y0, x0, lvl in exts:
        _, (hpl, wpl) = M._level_dims((h, w), lvl)
        max_oy = max(hpl - win_y, 0)
        max_ox = max(wpl - win_x, 0)
        oy = (int(np.clip(y0, 0, max_oy)) // 8) * 8
        ox = (int(np.clip(x0, 0, max_ox)) // 128) * 128
        origins[k, i, j] = (oy, ox, lvl)
    return origins, ok, int(win_y), int(win_x), max_lvl + 1


def _random_rig(rng):
    """A random rig: N cameras yawed around a sweep with some pitch and
    roll, one focal, a canvas of random resolution (so tiles span from
    a few to hundreds of source pixels), periodic or not."""
    n = int(rng.integers(1, 7))
    h, w = int(rng.integers(60, 900)), int(rng.integers(60, 1300))
    f = rng.uniform(0.4, 2.5) * max(h, w)
    projs = []
    for k in range(n):
        a, b, c = rng.uniform(0, 2 * np.pi), rng.normal(0, 0.3), \
            rng.normal(0, 0.1)
        ry = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0],
                       [np.sin(a), 0, np.cos(a)]])
        rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                       [0, np.sin(b), np.cos(b)]])
        rz = np.array([[np.cos(c), -np.sin(c), 0],
                       [np.sin(c), np.cos(c), 0], [0, 0, 1]])
        projs.append(np.diag([f, f, 1.0]) @ rz @ rx @ ry)
    res = rng.uniform(0.4, 12.0) / f
    resolution = np.array([res, res * rng.uniform(0.8, 1.2)])
    range_min = np.array([-np.pi, -rng.uniform(0.3, 1.2)])
    ph, pw = int(rng.integers(1, 300)), int(rng.integers(1, 700))
    bottoms = np.stack([rng.integers(0, 2000, n), rng.integers(0, 300, n)],
                       1)
    period = int(rng.integers(200, 2500)) if rng.random() < 0.5 else None
    return (np.stack(projs), bottoms, resolution, range_min, (h, w), ph,
            pw, period, bool(rng.random() < 0.3))


@pytest.mark.parametrize("seed", range(6))
def test_plan_windows_matches_loop_oracle(seed):
    """A sweep of 8 random rigs per seed: origins, ok, window and level
    count identical; across the sweep, plans at several levels, some not
    ok."""
    rng = np.random.default_rng(1000 + seed)
    levels, oks = set(), set()
    for _ in range(8):
        projs, bottoms, res, rmin, hw, ph, pw, period, cyl = _random_rig(rng)
        ours = M.plan_windows(projs, bottoms, res, rmin, hw, ph, pw,
                              period=period, cylindrical=cyl)
        theirs = plan_windows_loop(projs, bottoms, res, rmin, hw, ph, pw,
                                   period=period, cylindrical=cyl)
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[0].dtype == theirs[0].dtype
        assert ours[1:] == theirs[1:]
        assert all(type(a) is type(b) for a, b in zip(ours[1:], theirs[1:]))
        levels.add(ours[4])
        oks.add(ours[1])
    assert len(levels) >= 2


def _edge_pad_gather(imgs, ht, wt):
    """The index-gather edge pad that ``_edge_pad`` replaced."""
    n, h, w, c = imgs.shape
    iy = torch.arange(ht).clamp(max=h - 1)
    ix = torch.arange(wt).clamp(max=w - 1)
    return imgs[:, iy][:, :, ix]


@pytest.mark.parametrize("shape,target", [((2, 5, 7, 4), (8, 128)),
                                          ((1, 8, 128, 4), (8, 128)),
                                          ((3, 9, 3, 4), (16, 3))])
def test_edge_pad_equals_index_gather(shape, target):
    imgs = torch.rand(shape, generator=torch.Generator().manual_seed(3))
    assert torch.equal(M._edge_pad(imgs, *target),
                       _edge_pad_gather(imgs, *target))
