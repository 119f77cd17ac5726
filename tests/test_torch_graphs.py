"""The port's "Matched features" stage as steps on static buffers, the
form that a card replays from CUDA graphs (``graphs``), run eagerly on
the CPU and held against the chunk loop and the JAX package.

World: five 120x160 views (overlap 0.5, seed 13): SIFT runs a batch of
4 and a short batch of 1, and ten pairs in chunks of 4 leave a short
last chunk of 2.

Tolerances: the steps equal the loops they replace bit for bit (the same
arithmetic: the extraction step against ``sift_extract``, the match
graph's three steps, split around ``eigh``, against a loop of
``match_pairs`` over the same chunks and draws). Against JAX, SIFT's
keypoints and descriptors under ``test_torch_pipeline``'s tolerances
(keypoints within 0.01 px for >= 99 % of JAX's set, matched descriptors
within 1e-4 for >= 99 %), and the match graph on JAX's draws edge for
edge: indices, inlier masks and ``ok`` equal, homographies within 1e-4
relative (``test_match_graph_matches_jax``'s).
"""
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode

from pano360_tpu import match as jmatch
from pano360_tpu import pipeline as jpipe
from pano360_tpu import synth
from pano360_tpu.features import sift as jsift

from pano360_tpu_torch import _kernels, graphs
from pano360_tpu_torch import match as tmatch
from pano360_tpu_torch import pipeline as tpipe
from pano360_tpu_torch.features import sift as tsift
from pano360_tpu_torch.ops.color import bgr2gray

from jax_grid_turn import port_grid

torch.set_num_threads(1)

BATCH = 4                       # pairs per chunk: 10 pairs -> 4, 4, 2


@pytest.fixture(scope="module", autouse=True)
def _port_grid():
    """The JAX package's grid descriptor turned as the port's
    (``jax_grid_turn``) for every JAX run of this module."""
    with port_grid():
        yield


@pytest.fixture(scope="module")
def world():
    imgs, _, _ = synth.make_views(n_views=5, shape=(120, 160), overlap=0.5,
                                  seed=13)
    u8 = [(im * 255).astype(np.uint8) for im in imgs]
    stack, feats = tpipe.upload_extract(u8, torch.device("cpu"),
                                        capture=False)
    kh, kp, ds, va, remap = tpipe.sift_buffers(u8, feats)
    pairs = [(a, b) for a in range(5) for b in range(a + 1, 5)]
    return dict(u8=u8, stack=stack, feats=feats, kp=kp, ds=ds, va=va,
                pairs=pairs)


@pytest.fixture(scope="module")
def jax_feats(world):
    f = jpipe._gray_extract(jnp.asarray(np.stack(world["u8"])),
                            jsift.SiftConfig(max_kpts=4096))
    return jsift.SiftFeatures(*[np.asarray(a) for a in f])


def test_launches_counted_per_replay(monkeypatch):
    """A kernel's wrapper counts its launch, a replay calls no wrapper:
    what the wrappers counted inside the capture is taken back and added
    at each replay."""
    monkeypatch.setattr(_kernels, "_LIB",
                        SimpleNamespace(p360_sift_base=lambda: 0))
    monkeypatch.setitem(_kernels.LAUNCHES, "sift_base", 0)

    def step():                 # a step whose wrappers count 3 launches
        for _ in range(3):
            _kernels.launch("p360_sift_base")
    step()                      # the eager run before the capture
    launches = graphs.Launches()
    with launches.capturing():
        step()
    assert _kernels.LAUNCHES["sift_base"] == 3
    assert launches.per_replay == {"sift_base": 3}
    for _ in range(4):
        launches.replayed()
    assert _kernels.LAUNCHES["sift_base"] == 3 + 4 * 3


@pytest.mark.parametrize("batch", [0, 1])
def test_extract_step_equals_sift_extract(world, batch):
    """The extraction step, run eagerly by ``upload_extract`` in batches
    of 4 and 1, against ``sift_extract`` of the same batch, and the
    uploaded stack against the images."""
    lo, hi = (0, 4) if batch == 0 else (4, 5)
    u8 = torch.as_tensor(np.stack(world["u8"][lo:hi]))
    want = tsift.sift_extract(bgr2gray(u8.float() / 255.0),
                              tsift.SiftConfig())
    for f, w in zip(tsift.SiftFeatures._fields, want):
        assert torch.equal(getattr(world["feats"], f)[lo:hi], w), f
    assert torch.equal(world["stack"][lo:hi], u8)


def _kp_sets(feats, i):
    v = np.asarray(feats.valid)[i]
    return (np.asarray(feats.xy)[i][v], np.asarray(feats.angle)[i][v],
            np.asarray(feats.desc)[i][v])


@pytest.mark.parametrize("img", range(5))
def test_extract_step_within_jax_tolerances(world, jax_feats, img):
    jxy, jang, jdesc = _kp_sets(jax_feats, img)
    txy, tang, tdesc = _kp_sets(world["feats"], img)
    assert len(jxy) > 50
    d2 = ((jxy[:, None] - txy[None]) ** 2).sum(-1)
    dang = np.abs(np.angle(np.exp(1j * (jang[:, None] - tang[None]))))
    cost = np.where(d2 < 1e-4, dang, np.inf)
    best = cost.argmin(axis=1)
    matched = cost[np.arange(len(jxy)), best] < 1e-3
    assert matched.mean() >= 0.99, matched.mean()
    err = np.abs(jdesc[matched] - tdesc[best[matched]]).max(axis=1)
    assert (err <= 1e-4).mean() >= 0.99, (err <= 1e-4).mean()


def _chunk_loop(w, batch, seed=None, draw_fn=None):
    """The match graph as a loop of ``match_pairs`` over the chunks, the
    uniforms drawn chunk by chunk: -> PairMatch of numpy arrays."""
    gen = None
    if draw_fn is None:
        gen = torch.Generator()
        gen.manual_seed(seed)
    pairs, out = w["pairs"], []
    for lo in range(0, len(pairs), batch):
        chunk = pairs[lo:lo + batch]
        u = None if gen is None else torch.rand(
            (len(chunk), tmatch.RANSAC_ITERS, 4), generator=gen)
        out.append(tmatch.match_pairs(
            w["kp"], w["ds"], w["va"], torch.tensor([p[0] for p in chunk]),
            torch.tensor([p[1] for p in chunk]), first_pair=lo,
            draw_fn=draw_fn, uniforms=u))
    return tmatch.PairMatch(*[torch.cat(ts).numpy() for ts in zip(*out)])


def _jax_draws(n_pairs, seed=0):
    """JAX's keys of ``n_pairs`` pairs and a ``draw_fn`` of their draws
    (``jax.random.randint`` of pair k's key, as JAX's ``match_pair``)."""
    keys = jax.random.split(jax.random.key(seed), n_pairs)

    def fn(k, n_valid):
        return torch.from_numpy(np.array(jax.random.randint(
            keys[k], (jmatch.RANSAC_ITERS, 4), 0, n_valid)))
    return keys, fn


@pytest.mark.parametrize("draws", ["generator", "draw_fn"])
def test_match_steps_equal_chunk_loop(world, draws):
    """``match_all_pairs`` (three steps on one state, split around
    ``eigh``; eager here) against the chunk loop, bit for bit, with a
    short last chunk: on a generator's uniforms, and on injected draws."""
    w = world
    if draws == "generator":
        gen = torch.Generator()
        gen.manual_seed(7)
        kw = dict(generator=gen)
        want = _chunk_loop(w, BATCH, seed=7)
    else:
        kw = dict(draw_fn=_jax_draws(len(w["pairs"]))[1])
        want = _chunk_loop(w, BATCH, draw_fn=_jax_draws(len(w["pairs"]))[1])
    got = tmatch.match_all_pairs(w["kp"], w["ds"], w["va"], w["pairs"], BATCH,
                                 **kw)
    assert want.ok.sum() >= 4
    for f, a, b in zip(tmatch.PairMatch._fields, got, want):
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_match_steps_equal_jax_on_its_draws(world):
    """The match graph against JAX's ``match_all_pairs`` (``lax.map`` in
    chunks of 4) on JAX's draws, edge for edge."""
    w = world
    keys, fn = _jax_draws(len(w["pairs"]))
    got = tmatch.match_all_pairs(w["kp"], w["ds"], w["va"], w["pairs"], BATCH,
                                 draw_fn=fn)
    pa = jnp.asarray([p[0] for p in w["pairs"]])
    pb = jnp.asarray([p[1] for p in w["pairs"]])
    j = jmatch.match_all_pairs(*(jnp.asarray(t.numpy()) for t in
                                 (w["kp"], w["ds"], w["va"])), pa, pb, keys,
                               batch_size=BATCH)
    np.testing.assert_array_equal(got.ok, np.asarray(j.ok))
    assert got.ok.sum() >= 4
    for k in np.flatnonzero(got.ok):
        np.testing.assert_array_equal(got.idx[k], np.asarray(j.idx[k]))
        np.testing.assert_array_equal(got.inlier[k], np.asarray(j.inlier[k]))
        h_j = np.asarray(j.hom[k])
        assert np.abs(got.hom[k] - h_j).max() / np.abs(h_j).max() <= 1e-4


class _HostRoundTrips(TorchDispatchMode):
    """Records the operations that a captured step may not make: a read
    of a device value on the host, an upload of host data, and the
    operations whose output size depends on the data."""

    BAD = ("aten._local_scalar_dense.", "aten.lift_fresh.", "aten.nonzero.",
           "aten.masked_select.", "aten.unique")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        bool_index = name.startswith("aten.index") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for a in args if isinstance(a, (list, tuple)) for i in a)
        if bool_index or name.startswith(self.BAD):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def test_captured_steps_make_no_host_round_trip(world):
    """The steps a card captures (the extraction of a batch, the match
    graph before and after ``eigh``), each after a run that made the
    process's constants (the fixture's extraction; one run of the match
    graph's steps): no host read, no upload of host data."""
    w = world
    chunks = [(0, 4), (4, 8), (8, 10)]
    state = tmatch._graph_state(w["kp"], w["ds"], w["va"], w["pairs"],
                                chunks)
    state["u"].uniform_(generator=torch.Generator().manual_seed(0))
    hyp, eig, rows = (partial(f, state) for f in tmatch._graph_steps(
        chunks, tmatch._uniform_draws))
    for step in (hyp, eig, rows):
        step()
    extract = partial(tpipe._extract_step, tsift.SiftConfig(),
                      {"u8": torch.as_tensor(w["u8"][4][None])})
    for step in (extract, hyp, rows):
        with _HostRoundTrips() as seen:
            step()
        assert not seen.seen, seen.seen
