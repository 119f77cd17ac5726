"""SIFT's tail (``pano360_tpu_torch.ops.sift_tail``): the plain versions
of its kernels held against the JAX package on the CPU, and the
wrappers' dispatch.

Inputs come from the port's own extraction of two numpy-seeded 48x64
views (upscaled octaves of 96x128 down to 6x8), recorded at the three
wrappers (the refinement's DoG stacks feed the Newton field's tests),
plus numpy-seeded DoG stacks, candidates on the image's edges and
gradient patches. The JAX side runs as its own tests run it on the CPU;
the Newton field op by op (``jax.disable_jit()``: eager operations
contract no a*b+c).

Tolerances (measured on these inputs in brackets): the Newton field
equal on every pixel; the refinement's positions and ``ok`` equal,
offsets and contrast within 1e-6 (JAX solves with a matrix product;
9.5e-7 and 0); the orientation histograms within 1e-5 of each
histogram's largest bin (JAX sums each bin by a one-hot dot, the port in
the halving tree's order; 2.2e-7), the valid flags equal on >= 99 %
(all) and the angles within 1e-5 rad where both are valid (9.6e-7), on
grid (64x64) and dense (80x80) patches; descriptors within 1e-5 on >=
99 % of them (all within 2e-7), the bar of ``test_sift_matches_jax``
being 1e-4.
With the fixed summation order the keypoint stage gives every keypoint
the same bits in any chunk (2048 or 256 keypoints).
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pano360_tpu import synth
from pano360_tpu.features import sift as jsift

from pano360_tpu_torch import pipeline as tpipe
from pano360_tpu_torch._kernels import LAUNCHES
from pano360_tpu_torch.features import sift as tsift
from pano360_tpu_torch.measure import recording
from pano360_tpu_torch.ops import sift_tail as T

from jax_grid_turn import turned

torch.set_num_threads(1)

WRAPPERS = ("refine", "orientation", "descriptors")
CFG = tsift.SiftConfig(max_kpts=1024, descr_mode="grid")
JCFG = jsift.SiftConfig(max_kpts=1024)


@pytest.fixture(scope="module")
def calls():
    """The three wrappers' arguments in one CPU extraction of two views."""
    imgs, _, _ = synth.make_views(n_views=2, shape=(48, 64), seed=3)
    u8 = np.stack([(im * 255).astype(np.uint8) for im in imgs])
    with recording(T, WRAPPERS) as rec:
        tpipe.gray_extract(torch.as_tensor(u8), CFG)
    return rec


def _flat(calls, name, n):
    """The first ``n`` keypoints of the keypoint stage's recorded
    chunks, every argument concatenated."""
    parts = [args for args, _ in calls[name]]
    return tuple(torch.cat(xs)[:n] for xs in zip(*parts))


def _np(*ts):
    return [jnp.asarray(t.numpy()) for t in ts]


def _patches(seed, k, psg):
    """Numpy-seeded gradient patches and keypoints in and near them (some
    at the image's border): gx, gy, y, x, pcy, pcx, sig, oh, ow."""
    rng = np.random.default_rng(seed)
    gx = (rng.standard_normal((k, psg, psg)) * 0.05).astype(np.float32)
    gy = (rng.standard_normal((k, psg, psg)) * 0.05).astype(np.float32)
    y = rng.integers(5, 120, k)
    x = rng.integers(5, 140, k)
    pcy = np.clip(y - psg // 2 - 1 + rng.integers(-3, 4, k), 0, None)
    pcx = np.clip(x - psg // 2 - 1 + rng.integers(-3, 4, k), 0, None)
    sig = rng.uniform(1.6, 3.6, k).astype(np.float32)
    oh = rng.choice([125, 160], k)
    ow = rng.choice([145, 170], k)
    ints = [torch.from_numpy(a.astype(np.int64)) for a in (y, x, pcy, pcx)]
    return (torch.from_numpy(gx), torch.from_numpy(gy), *ints,
            torch.from_numpy(sig), torch.from_numpy(oh.astype(np.int64)),
            torch.from_numpy(ow.astype(np.int64)))


def test_recorded_extraction_reaches_every_wrapper(calls):
    """Five octaves, the keypoint stage in chunks of 2048 on the CPU."""
    assert [len(calls[k]) for k in WRAPPERS] == [5, 2, 2]
    assert calls["orientation"][0][0][0].shape[1:] == (64, 64)


@pytest.mark.parametrize("which", ["octave 0", "octave 2", "random 33x41"])
def test_newton_field_plain_matches_jax(calls, which):
    if which.startswith("octave"):
        dog = calls["refine"][int(which[-1])][0][0]
    else:
        rng = np.random.default_rng(7)
        dog = torch.from_numpy(
            (rng.standard_normal((2, 5, 33, 41)) * 0.02).astype(np.float32))
    ours = tsift._newton_step_field(dog).numpy()
    with jax.disable_jit():
        theirs = np.asarray(jsift._newton_step_field(*_np(dog)))
    assert ours.dtype == theirs.dtype == np.int32
    np.testing.assert_array_equal(ours, theirs)
    # both tails of the step distribution and convergence occur
    assert (ours & 1).any() and (((ours >> 1) & 3) == 0).any()


@pytest.mark.parametrize("octave", [0, 2])
def test_refine_plain_matches_jax(calls, octave):
    dog, l0, y0, x0, cfg = calls["refine"][octave][0]
    field = tsift._newton_step_field(dog)
    l, y, x, offs, contrast, ok = tsift._refine(dog, field, l0, y0, x0, cfg)
    for i in range(dog.shape[0]):
        d, f = _np(dog[i], field[i])
        one = jax.vmap(lambda a, b, c: jsift._refine_one(d, f, a, b, c, JCFG))
        jl, jy, jx, joffs, jcon, jok = (np.asarray(t) for t in one(
            *_np(l0[i], y0[i], x0[i])))
        for a, b in ((l, jl), (y, jy), (x, jx), (ok, jok)):
            np.testing.assert_array_equal(a[i].numpy(), b)
        np.testing.assert_allclose(offs[i].numpy(), joffs, rtol=0, atol=1e-6)
        np.testing.assert_allclose(contrast[i].numpy(), jcon, rtol=0,
                                   atol=1e-6)
    assert ok.sum() > 10


def _plain_refine(dog, l0, y0, x0, cfg):
    return tsift._refine(dog, tsift._newton_step_field(dog), l0, y0, x0, cfg)


@pytest.mark.parametrize("octave", [0, 1, 2, 3, 4])
def test_refine_takes_no_field(calls, octave):
    """``refine`` without a field (the kernel computes each step where a
    candidate visits it) equals the plain steps on the dense field, bit
    for bit, at every recorded octave, and launches nothing here."""
    args, kw = calls["refine"][octave]
    before = dict(LAUNCHES)
    outs = T.refine(*args, **kw)
    assert LAUNCHES == before
    assert all(torch.equal(a, b)
               for a, b in zip(outs, _plain_refine(*args, **kw)))


def _edge_candidates(n, s, h, w, seed):
    """(N, C) candidates on every image edge (x = 0, x = w - 1, y = 0,
    y = h - 1, the corners) at layers 1 and S, then random ones."""
    rng = np.random.default_rng(seed)
    pts = []
    for lay in (1, s):
        for x in (0, w - 1):
            pts += [(lay, y, x) for y in rng.integers(0, h, 4)] + \
                [(lay, 0, x), (lay, h - 1, x)]
        for y in (0, h - 1):
            pts += [(lay, y, x) for x in rng.integers(0, w, 4)]
    pts = np.concatenate([np.array(pts), np.stack(
        [rng.integers(1, s + 1, 32), rng.integers(0, h, 32),
         rng.integers(0, w, 32)], -1)])
    cand = np.stack([np.roll(pts, 5 * i, 0) for i in range(n)])
    return tuple(torch.from_numpy(cand[..., k].copy()) for k in range(3))


@pytest.mark.parametrize("border", [5, 0])
def test_refine_on_the_wrap_border_matches_jax(border):
    """Candidates on the image's edges at layers 1 and S, where the
    Newton step's stencil wraps as ``torch.roll`` wraps (at ``img_border
    = 0`` also after the first step): ``refine`` without a field equals
    the plain steps on the dense field bit for bit; the field is JAX's
    and the final positions are ``_refine_one``'s. ``ok`` is held to
    JAX's where the final cube lies inside the image: at an edge the
    packages read the cube past the plane differently (the port clamps
    the flat index, JAX's gather each axis), which only invalid slots
    reach."""
    cfg = tsift.SiftConfig(img_border=border)
    s = cfg.n_layers
    rng = np.random.default_rng(21)
    dog = torch.from_numpy((rng.standard_normal((2, s + 2, 27, 36)) * 0.02)
                           .astype(np.float32))
    l0, y0, x0 = _edge_candidates(2, s, 27, 36, 4)
    outs = T.refine(dog, l0, y0, x0, cfg)
    assert all(torch.equal(a, b)
               for a, b in zip(outs, _plain_refine(dog, l0, y0, x0, cfg)))
    with jax.disable_jit():
        field = torch.from_numpy(np.array(
            jsift._newton_step_field(*_np(dog))))
    assert torch.equal(field, tsift._newton_step_field(dog))
    jcfg = jsift.SiftConfig(max_kpts=1024, img_border=border)
    for i in range(dog.shape[0]):
        d, f = _np(dog[i], field[i])
        one = jax.vmap(lambda a, b, c: jsift._refine_one(d, f, a, b, c, jcfg))
        jl, jy, jx, _, _, jok = (np.asarray(t) for t in one(
            *_np(l0[i], y0[i], x0[i])))
        for a, b in ((outs[0], jl), (outs[1], jy), (outs[2], jx)):
            np.testing.assert_array_equal(a[i].numpy(), b)
        y, x = outs[1][i].numpy(), outs[2][i].numpy()
        inside = (y >= 1) & (y <= 25) & (x >= 1) & (x <= 34)
        assert inside.sum() >= 16 and (~inside).sum() >= 8
        np.testing.assert_array_equal(outs[5][i].numpy()[inside],
                                      jok[inside])


def _jax_orientation(args, cfg):
    gx, gy, y, x, pcy, pcx, sig, oh, ow = _np(*args)
    hist = jax.vmap(lambda *a: jsift._orientation_from_patch(*a, cfg))(
        gx, gy, y, x, pcy, pcx, sig, oh, ow)
    ang, valid = jax.vmap(lambda h: jsift._peak_angles(h, cfg))(hist)
    return np.asarray(hist), np.asarray(ang), np.asarray(valid)


@pytest.mark.parametrize("case", ["recorded", "grid 64", "dense 80"])
def test_orientation_plain_matches_jax(calls, case):
    if case == "recorded":
        args = _flat(calls, "orientation", 256)
    else:
        args = _patches(11, 64, int(case.split()[1]))
    hist = tsift._orientation_hist(*args, CFG)
    ang, valid = (t.numpy() for t in tsift._peak_angles(hist, CFG))
    hist = hist.numpy()
    jhist, jang, jvalid = _jax_orientation(args, JCFG)
    scale = np.abs(jhist).max(axis=1, keepdims=True)
    assert (np.abs(hist - jhist) <= 1e-5 * scale).all()
    assert (valid == jvalid).mean() >= 0.99
    both = valid & jvalid
    assert both[:, 0].mean() > 0.9
    dang = np.abs(np.angle(np.exp(1j * (ang[both] - jang[both]))))
    assert dang.max() <= 1e-5


def _row_node(leaves, d, r):
    """The grid orientation kernel's depth-first node over the leaves q =
    r (mod d) of dim -2: node(d, r) = node(2d, r) + node(2d, r + d)."""
    if d == leaves.shape[-2]:
        return leaves[..., r, :]
    return _row_node(leaves, 2 * d, r) + _row_node(leaves, 2 * d, r + d)


def _kernel_window(y, x, pcy, pcx, sig, oh, ow, psg=64):
    """The patch rows and columns (rlo, rhi, clo, chi) that the grid
    kernel visits: the window of radius round(4.5 sigma) cut by the patch
    and the image's interior."""
    r = torch.round(4.5 * sig).to(torch.int64)
    oy, ox = pcy + 1, pcx + 1
    one = torch.ones_like(y)
    rlo = torch.maximum(torch.maximum(0 * one, 1 - oy), y - r - oy)
    rhi = torch.minimum(torch.minimum(one * (psg - 1), oh - 2 - oy),
                        y + r - oy)
    clo = torch.maximum(torch.maximum(0 * one, 1 - ox), x - r - ox)
    chi = torch.minimum(torch.minimum(one * (psg - 1), ow - 2 - ox),
                        x + r - ox)
    return rlo, rhi, clo, chi


def _kernel_order_hist(val, bins, rlo, rhi, clo, chi, nb=36):
    """The grid kernel's (``csrc/sift_orient.cu``) raw histograms of (M,
    64, 64) samples in its order, with the +0 leaves it leaves out left
    out: per column of the window, the row tree over the window's rows
    folded to nl = 32 residues (64 above 32 rows), the
    leaves of other bins +0, added only for the bins present in the
    column to a +0 partial of column l and l + 32; then the halving tree
    over the 32 partials. Nothing outside the window is read. (At nl =
    64 the kernel takes the root's two subtrees, the even and the odd
    rows, in turn: ``_row_node(leaves, 1, 0)`` is their sum.)"""
    out = []
    b_all = torch.arange(nb)[:, None, None]
    for k in range(val.shape[0]):
        lo, hi = int(rlo[k]), int(rhi[k])
        rows = hi - lo + 1
        nl = 32 if rows <= 32 else 64
        iy = lo + (torch.arange(nl) - lo) % nl
        has = (iy <= hi)[:, None]
        iy = iy.clamp(0, 63)
        leaf_v = torch.where(has, val[k, iy], 0.0)           # (nl, 64)
        leaf_b = torch.where(has, bins[k, iy], -1)
        present = (leaf_b[None] == b_all).any(1)             # (nb, 64)
        sums = _row_node(torch.where(leaf_b[None] == b_all, leaf_v[None],
                                     0.0), 1, 0)             # (nb, 64)
        cols = torch.arange(64)
        keep = present & (cols >= int(clo[k])) & (cols <= int(chi[k]))
        part = torch.zeros((nb, 32))
        for h in (0, 1):
            c = slice(32 * h, 32 * h + 32)
            part = torch.where(keep[:, c], part + sums[:, c], part)
        out.append(_row_node(part.T[None], 1, 0)[0])
    return torch.stack(out)


def _smooth(hist):
    hm2, hm1 = torch.roll(hist, 2, -1), torch.roll(hist, 1, -1)
    hp1, hp2 = torch.roll(hist, -1, -1), torch.roll(hist, -2, -1)
    return (hm2 + hp2) * (1 / 16) + (hm1 + hp1) * (4 / 16) + hist * (6 / 16)


def _order_windows(seed):
    """Numpy-seeded (M, 64, 64) weighted magnitudes and bins, zero outside
    each keypoint's window: windows centred, against each patch edge and
    corner, cut short by zero-padded rows and columns (a small octave),
    of heights 1-32 and 33-64, one all +0."""
    rng = np.random.default_rng(seed)
    spans = []
    for height in (9, 15, 16, 17, 23, 31, 32, 33, 37, 64):
        width = int(rng.integers(1, 65))
        for rlo in (0, (64 - height) // 2, 64 - height):
            for clo in (0, (64 - width) // 2, 64 - width):
                spans.append((rlo, rlo + height - 1, clo, clo + width - 1))
    # zero-padded rows and columns: the window ends at the image's last
    # interior row or column inside the patch
    for pad in (5, 20, 40):
        spans.append((0, 63 - pad, 10, 63 - pad // 2))
        spans.append((30 - pad // 2, 63 - pad, 0, 63 - pad))
    m = len(spans)
    val = (rng.lognormal(-3.0, 1.5, (m, 64, 64))
           * (rng.random((m, 64, 64)) > 0.05)).astype(np.float32)
    bins = rng.integers(0, 36, (m, 64, 64))
    rlo, rhi, clo, chi = (torch.tensor(v) for v in zip(*spans))
    ar = np.arange(64)
    inside = ((ar[None, :, None] >= rlo.numpy()[:, None, None])
              & (ar[None, :, None] <= rhi.numpy()[:, None, None])
              & (ar[None, None, :] >= clo.numpy()[:, None, None])
              & (ar[None, None, :] <= chi.numpy()[:, None, None]))
    val = np.where(inside, val, np.float32(0.0))
    val[-1] = 0.0
    return (torch.from_numpy(val), torch.from_numpy(bins), rlo, rhi, clo,
            chi)


@pytest.mark.parametrize("case", ["windows", "recorded"])
def test_orientation_kernel_order_equals_tree_sum(calls, case, monkeypatch):
    """The grid orientation kernel's order (a row tree inside a column
    tree, its +0 leaves left out, written here in torch) gives every bin
    the bits of ``_orientation_hist``'s ``tree_sum`` over the 4096
    flattened samples; the smoothed histograms and ``_peak_angles`` then
    agree. Numpy-seeded windows anywhere in the patch, and the recorded
    extraction's samples with the windows the kernel computes."""
    if case == "windows":
        val, bins, *window = _order_windows(5)
        m = val.shape[0]
    else:
        args = _flat(calls, "orientation", 512)
        flat_v, flat_b = tsift._orientation_samples(*args, CFG)
        m = flat_v.shape[0]
        val, bins = flat_v.reshape(m, 64, 64), flat_b.reshape(m, 64, 64)
        window = _kernel_window(*args[2:])
    ours = _kernel_order_hist(val, bins, *window)
    flat_v, flat_b = val.reshape(m, -1), bins.reshape(m, -1)
    raw = torch.stack([tsift.tree_sum(torch.where(flat_b == i, flat_v, 0.0),
                                      1) for i in range(36)], dim=1)
    assert torch.equal(ours.view(torch.int32), raw.view(torch.int32))
    assert (ours > 0).sum() > m
    monkeypatch.setattr(tsift, "_orientation_samples",
                        lambda *a: (flat_v, flat_b))
    plain = tsift._orientation_hist(*([None] * 9), CFG)
    smooth = _smooth(ours)
    assert torch.equal(smooth.view(torch.int32), plain.view(torch.int32))
    for a, b in zip(tsift._peak_angles(smooth, CFG),
                    tsift._peak_angles(plain, CFG)):
        assert torch.equal(a, b)


def _jax_descriptors(args, cfg):
    """The JAX package's grid descriptors through the exact transform to
    the port's turn of the grid: mirror(JAX(gx, -gy, ..., -theta))
    (``jax_grid_turn``)."""
    one = jax.vmap(lambda *a: turned(*a, cfg),
                   in_axes=(None,) * 7 + (0, None, None))
    return np.asarray(jax.vmap(one)(*_np(*args)))


def test_descriptors_plain_matches_jax(calls):
    """The port's descriptors against the JAX package's turned as the
    port turns its grid (``jax_grid_turn``), at the recorded keypoints
    and orientations."""
    args = _flat(calls, "descriptors", 256)
    ours = tsift._descriptors(*args, CFG).numpy()
    theirs = _jax_descriptors(args, JCFG)
    err = np.abs(ours - theirs).max(axis=-1)
    assert (err <= 1e-5).mean() >= 0.99, np.quantile(err, 0.99)
    assert err.max() <= 1e-4
    norms = np.linalg.norm(ours, axis=-1)
    assert np.abs(norms[norms > 0] - 1).max() <= 1e-5


@pytest.mark.parametrize("chunk", [2048, 256])
@pytest.mark.parametrize("name", ["orientation", "descriptors"])
def test_keypoint_stage_chunks_change_no_bit(calls, name, chunk):
    """2304 keypoints in one call and in chunks, bit for bit."""
    args = _flat(calls, name, 2304)
    fn = getattr(T, name)
    whole = fn(*args, cfg=CFG)
    parts = tsift._chunked(lambda *a: fn(*a, cfg=CFG), chunk, *args)
    whole = whole if isinstance(whole, tuple) else (whole,)
    parts = parts if isinstance(parts, tuple) else (parts,)
    assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(whole, parts))


def test_peak_angles_ties_take_the_lower_bin():
    """Equal peaks: the lower bin first; one peak: the second slot the
    lowest other bin, invalid."""
    hist = torch.zeros((2, 36))
    hist[0, [4, 20]] = 1.0
    hist[1, 7] = 1.0
    ang, valid = tsift._peak_angles(hist, CFG)
    step = 2 * math.pi / 36
    np.testing.assert_allclose(ang[0].numpy(), [4 * step, 20 * step],
                               rtol=1e-6)
    assert valid[0].tolist() == [True, True]
    np.testing.assert_allclose(ang[1, 0].item(), 7 * step, rtol=1e-6)
    assert valid[1].tolist() == [True, False]
    assert ang[1, 1].item() == 0.0


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_cpu_takes_plain_version(calls, name):
    args, kw = calls[name][0]
    before = dict(LAUNCHES)
    out = getattr(T, name)(*args, **kw)
    plain = dict(refine=_plain_refine,
                 orientation=lambda *a, cfg: tsift._peak_angles(
                     tsift._orientation_hist(*a, cfg), cfg),
                 descriptors=tsift._descriptors)[name](*args, **kw)
    assert LAUNCHES == before
    out = out if isinstance(out, tuple) else (out,)
    plain = plain if isinstance(plain, tuple) else (plain,)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_rejects_unknown_device(calls, name):
    args, kw = calls[name][0]
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(T, name)(*meta, **kw)


def test_orientation_cost_counts_the_window(calls):
    """The samples ``orientation_cost`` counts are those whose weight
    the window and the image leave on: counted here one by one."""
    gx, gy, y, x, pcy, pcx, sig, oh, ow = _flat(calls, "orientation", 512)
    psg = gx.shape[1]
    ar = torch.arange(psg)
    ay = pcy[:, None, None] + 1 + ar[None, :, None]
    ax = pcx[:, None, None] + 1 + ar[None, None, :]
    r = torch.round(4.5 * sig)[:, None, None]
    inside = (((ay - y[:, None, None]).abs() <= r)
              & ((ax - x[:, None, None]).abs() <= r)
              & (ay >= 1) & (ay <= oh[:, None, None] - 2)
              & (ax >= 1) & (ax <= ow[:, None, None] - 2))
    cost = T.orientation_cost(y, x, pcy, pcx, sig, oh, ow, psg)
    m = y.numel()
    assert cost["bytes"] == 8 * int(inside.sum()) + m * 52 + m * 10
    assert cost["bound_by"] == "bytes"


def test_refine_cost_counts_distinct_words(calls):
    """The bytes: 65 a candidate (its position, its six outputs) and the
    19 DoG values of each distinct position its steps visit (the final
    cube's included); the operations: the cube's per candidate and a
    Newton step per distinct position stepped from."""
    dog, l0, y0, x0, cfg = calls["refine"][0][0]
    cost = T.refine_cost(dog, l0, y0, x0, cfg)
    cands = l0.numel()
    positions, rest = divmod(cost["bytes"] - cands * 65, 76)
    assert rest == 0
    assert cands < positions <= cands * (cfg.refine_iters + 1)
    steps, rest = divmod(cost["flops"] - cands * T.REFINE_OPS, T.NEWTON_OPS)
    assert rest == 0
    assert cands <= steps <= min(positions, cands * cfg.refine_iters)
