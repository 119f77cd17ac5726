"""The port's bundle adjustment held against the JAX package's on small
synthetic problems (CPU): the chunked LM loops against a literal host loop,
``lm_core``/``lm_polish`` against ``_lm_optimize``/``_lm_polish``,
``BundleAdjuster`` and ``jacobian_numeric`` against theirs, and
``traverse``'s padded problem against the JAX package's bucket and
``traverse``.

Problems: 3-5 cameras on a yaw arc, 40-60 matches per adjacent pair made
from the true geometry with pixel noise (numpy, seeded), as in the JAX
package's own register tests.

Tolerances: the chunked loops equal the host loop bit for bit (the same
arithmetic). Against JAX (Jacobians analytic here, forward-mode AD
there): the LM loops in f64, params within 1e-5 and rotations within
1e-5 rad; ``BundleAdjuster`` cameras in f64 within 1e-9, in f32 on
relative rotations and focals within 1e-4 (these problems are
ill-conditioned along a global rotation and the principal points, and
f32 rounding moves both packages apart along them); the numeric
Jacobian within rtol 1e-5 of the analytic one and of JAX's (symmetric
differences of step 1e-6 in f64).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pano360_tpu import register as jreg

from pano360_tpu_torch import register as treg

torch.set_num_threads(1)


def synthetic_problem(n_cams=4, n_pts=60, focal=900.0, noise=0.3, seed=3,
                      skips=0):
    """Cameras on a yaw arc and the matches of adjacent pairs (and of the
    first ``skips`` pairs two apart), made from the true geometry: ->
    (cameras, matches, focal)."""
    rng = np.random.default_rng(seed)
    rots = [treg._np_exp_so3(np.array([0.02 * rng.standard_normal(),
                                       0.35 * i, 0.0]))
            for i in range(n_cams)]
    intr = np.diag([focal, focal, 1.0])
    cams = [treg.PanoImage(None, r, intr.copy()) for r in rots]
    matches = {i: {} for i in range(n_cams)}
    pairs = ([(i, i + 1) for i in range(n_cams - 1)]
             + [(i, i + 2) for i in range(skips)])
    for i, j in pairs:
        p1 = rng.uniform(-300, 300, (n_pts, 2))
        hom = cams[j].intr @ cams[j].rot @ cams[i].rot.T @ \
            np.linalg.inv(cams[i].intr)
        ph = np.concatenate([p1, np.ones((n_pts, 1))], 1) @ hom.T
        p2 = ph[:, :2] / ph[:, 2:] + rng.normal(0, noise, (n_pts, 2))
        m_ij = np.concatenate([p1, np.ones((n_pts, 1)),
                               p2, np.ones((n_pts, 1))], axis=1)
        m_ji = np.concatenate([m_ij[:, 3:], m_ij[:, :3]], axis=1)
        matches[i][j] = (m_ij, hom, n_pts)
        matches[j][i] = (m_ji, np.linalg.inv(hom), n_pts)
    return cams, matches, focal


def perturbed(cams, scale, seed=5):
    """The cameras with rotations perturbed by ~``scale`` rad."""
    rng = np.random.default_rng(seed)
    return [treg.PanoImage(None, treg._np_exp_so3(
        scale * rng.standard_normal(3)) @ c.rot, c.intr.copy()) for c in cams]


def problem_arrays(n_cams=4, n_pts=60, scale=0.01, dtype=np.float32,
                   seed=3):
    """A JAX ``BundleAdjuster``-style padded problem (edges of adjacent
    pairs) from perturbed cameras: -> (params, cam1, cam2, pts, mask)."""
    cams, matches, _ = synthetic_problem(n_cams, n_pts, seed=seed)
    start = perturbed(cams, scale)
    params = np.stack([treg._np_params_from_camera(c)
                       for c in start]).astype(dtype)
    edges = [(i + 1, i, matches[i + 1][i][0]) for i in range(n_cams - 1)]
    m = max(len(e[2]) for e in edges)
    pts = np.zeros((len(edges), m, 6), dtype)
    pts[..., 2] = pts[..., 5] = 1.0
    mask = np.zeros((len(edges), m), dtype)
    cam1 = np.array([e[1] for e in edges])
    cam2 = np.array([e[0] for e in edges])
    for e, (_, _, mm) in enumerate(edges):
        pts[e, :len(mm)] = mm
        mask[e, :len(mm)] = 1.0
    return params, cam1, cam2, pts, mask


def port_problem(params, cam1, cam2, pts, mask):
    prob = treg.Problem(torch.as_tensor(cam1), torch.as_tensor(cam2),
                        torch.as_tensor(pts), torch.as_tensor(mask),
                        params.shape[0])
    return torch.as_tensor(params), prob


def host_lm_core(params, prob, mask, max_iter=treg.LM_MAX_ITER):
    """The fixed-lambda LM stepped from the host, read after every
    trial."""
    best = params
    best_err = np.float32(prob.loss(params, mask).item())
    n_iter = 0
    for _ in range(max_iter):
        n_iter += 1
        jtj, jtr = prob.normal_equations(best, mask)
        trial = best - treg._damped_step(jtj, jtr, treg.LM_LAMBDA, best.shape)
        err = np.float32(prob.loss(trial, mask).item())
        if not err < best_err - np.float32(treg.LM_MIN_IMPROVE):
            break
        best, best_err = trial, err
    return best, n_iter


def host_lm_polish(params, prob, mask):
    """The adaptive-damping polish stepped from the host."""
    best = params
    best_err = np.float32(prob.loss(params, mask).item())
    lam, rejects, n_iter = np.float32(treg.LM_LAMBDA), 0, 0
    for _ in range(treg.POLISH_MAX_ITER):
        if rejects >= treg.POLISH_MAX_REJECTS:
            break
        n_iter += 1
        jtj, jtr = prob.normal_equations(best, mask)
        trial = best - treg._damped_step(jtj, jtr, float(lam), best.shape)
        err = np.float32(prob.loss(trial, mask).item())
        if err < best_err:
            best, best_err = trial, err
            lam, rejects = lam * np.float32(0.5), 0
        else:
            lam, rejects = lam * np.float32(4.0), rejects + 1
        lam = np.float32(np.clip(lam, np.float32(1e-5), np.float32(1e6)))
    return best, n_iter


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("loop,scale,max_iter", [
    ("lm_core", 0.02, treg.LM_MAX_ITER), ("lm_core", 0.05, 2),
    ("lm_polish", 0.02, None), ("lm_polish", 0.05, None)])
def test_chunked_loop_equals_host_loop(k, loop, scale, max_iter):
    """Chunks of k steps with the stop flag on the device give the host
    loop's params bit for bit and its iteration count (a stop inside a
    chunk, and at the iteration cap, leaves the state as it was)."""
    params, prob = port_problem(*problem_arrays(5, 50, scale))
    if loop == "lm_core":
        want, n_want = host_lm_core(params, prob, prob.mask, max_iter)
        got, n_got = treg.lm_core(params, prob, prob.mask, max_iter, k=k)
    else:
        want, n_want = host_lm_polish(params, prob, prob.mask)
        got, n_got = treg.lm_polish(params, prob, prob.mask, k=k)
    assert n_got == n_want and n_want >= 2
    assert torch.equal(got, want)


def test_a_stopped_step_changes_nothing():
    params, prob = port_problem(*problem_arrays(4, 40, 0.02))
    for step in (treg.lm_step, treg.polish_step):
        state = treg._lm_state(params, prob, prob.mask)
        state["ctr"][2] = 1
        before = {k: v.clone() for k, v in state.items()}
        step(prob, state)
        assert all(torch.equal(state[k], v) for k, v in before.items())


def rot_err(a, b):
    c = np.clip((np.trace(a @ b.T) - 1) / 2, -1, 1)
    return float(np.arccos(c))


def assert_params_close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    for g, w in zip(got, want):
        assert rot_err(treg._np_exp_so3(g[3:]), treg._np_exp_so3(w[3:])) \
            <= tol


@pytest.mark.parametrize("n_cams,n_pts", [(3, 40), (5, 60)])
def test_lm_core_and_polish_match_jax(n_cams, n_pts):
    """From a good start (rotations within ~0.01 rad), in f64: in f32
    the step's components along the near-flat directions (a global
    rotation, each camera's principal point against its rotation) are
    rounding, and the two packages' LM walks end apart there."""
    arrays = problem_arrays(n_cams, n_pts, 0.01, np.float64)
    params, prob = port_problem(*arrays)
    jargs = [jnp.asarray(a) for a in arrays]
    best, _ = treg.lm_core(params, prob, prob.mask)
    jbest = np.asarray(jreg._lm_optimize(*jargs)[0])
    assert_params_close(best.numpy(), jbest, 1e-5)
    pol, _ = treg.lm_polish(best, prob, prob.mask)
    jpol = np.asarray(jax.jit(jreg._lm_polish)(jnp.asarray(best.numpy()),
                                                *jargs[1:]))
    assert_params_close(pol.numpy(), jpol, 1e-5)


def adjusters(mode, dtype):
    """The same cameras added to both packages' adjusters: the port's
    and JAX's ``BundleAdjuster`` after every add."""
    cams, matches, _ = synthetic_problem(n_cams=4, noise=0.5)
    start = perturbed(cams, 0.01, seed=9)
    port = treg.BundleAdjuster(4, mode=mode, dtype=dtype, device="cpu")
    ref = jreg.BundleAdjuster(4, mode=mode, dtype=dtype)
    for i, cam in enumerate(start):
        port.add(i, cam, matches)
        ref.add(i, jreg.PanoImage(None, cam.rot, cam.intr), matches)
    return port, ref


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", ["none", "incr"])
def test_bundle_adjuster_matches_jax(mode, dtype):
    """Equal assembled problems (the params too before any optimisation);
    after ``optimize()`` f64 cameras within
    1e-9. In f32 both packages' cameras differ by a global rotation (up
    to 9 deg here: the gauge direction's step is rounding), so f32 is
    held on what the residuals see: relative rotations of adjacent
    cameras within 1e-4 rad and focals within 1e-4 relative."""
    port, ref = adjusters(mode, dtype)
    assert [m[:2] for m in port.matches] == [m[:2] for m in ref.matches]
    (idx, params, *rest), (jidx, jparams, *jrest) = (port._assemble(),
                                                     ref._assemble())
    assert idx == jidx
    for a, b in zip(rest, jrest):
        np.testing.assert_array_equal(a, b)
    if mode == "none":                 # "incr" has optimised the cameras
        np.testing.assert_array_equal(params, jparams)
    port.optimize()
    ref.optimize()
    cams = list(zip(port.cameras, ref.cameras))
    if dtype == np.float64:
        for a, b in cams:
            np.testing.assert_allclose(a.rot, b.rot, atol=1e-9)
            np.testing.assert_allclose(a.intr, b.intr, rtol=1e-9, atol=1e-9)
        return
    for (a0, b0), (a1, b1) in zip(cams, cams[1:]):
        assert rot_err(a1.rot @ a0.rot.T, b1.rot @ b0.rot.T) <= 1e-4
    for a, b in cams:
        assert abs(a.intr[0, 0] / b.intr[0, 0] - 1) <= 1e-4


def test_bundle_adjuster_grows_its_device_buffers():
    """Without caps the point buffers double as edges and points arrive;
    each optimize() sees every edge."""
    cams, matches, _ = synthetic_problem(n_cams=5, n_pts=70)
    port = treg.BundleAdjuster(5, mode="none", device="cpu")
    for i, cam in enumerate(perturbed(cams, 0.005)):
        port.add(i, cam, matches)
        port.optimize()
    assert port._pts.shape == (4, 128, 6) and port._n_dev == 4
    assert float(port._mask.sum()) == 4 * 70
    ref = treg.BundleAdjuster(5, mode="none", device="cpu", edge_cap=4,
                              match_cap=70)
    for i, cam in enumerate(perturbed(cams, 0.005)):
        ref.add(i, cam, matches)
        ref.optimize()
    assert torch.equal(ref._pts, port._pts)


def test_bundle_adjuster_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        treg.BundleAdjuster(3)


@pytest.mark.parametrize("n_cams,n_pts", [(3, 20), (4, 40)])
def test_jacobian_numeric_matches_analytic_and_jax(n_cams, n_pts):
    params, cam1, cam2, pts, mask = problem_arrays(n_cams, n_pts, 0.02,
                                                   np.float64)
    jtj_n, jtr_n = treg.jacobian_numeric(params, cam1, cam2, pts, mask)
    p, prob = port_problem(params, cam1, cam2, pts, mask)
    jtj, jtr = (a.numpy() for a in prob.normal_equations(p, prob.mask))
    np.testing.assert_allclose(jtj_n, jtj, rtol=1e-5,
                               atol=1e-5 * np.abs(jtj).max())
    np.testing.assert_allclose(jtr_n, jtr, rtol=1e-5,
                               atol=1e-5 * np.abs(jtr).max())
    jjtj, jjtr = jreg.jacobian_numeric(params, cam1, cam2, pts, mask)
    np.testing.assert_allclose(jtj_n, jjtj, rtol=1e-5,
                               atol=1e-5 * np.abs(jjtj).max())
    np.testing.assert_allclose(jtr_n, jjtr, rtol=1e-5,
                               atol=1e-5 * np.abs(jjtr).max())


def test_params_per_camera_matches_jax():
    """The public parameter count of a camera, in both modules and their
    ``__all__``, as the JAX package has it."""
    from pano360_tpu import geometry as jgeo
    from pano360_tpu_torch import geometry as tgeo
    assert (tgeo.PARAMS_PER_CAMERA == treg.PARAMS_PER_CAMERA
            == jgeo.PARAMS_PER_CAMERA == jreg.PARAMS_PER_CAMERA == 6)
    assert "PARAMS_PER_CAMERA" in tgeo.__all__
    assert "PARAMS_PER_CAMERA" in treg.__all__
    params = torch.zeros(tgeo.PARAMS_PER_CAMERA, dtype=torch.float64)
    params[0] = 800.0
    assert tgeo.camera_to_params(tgeo.params_to_camera(params)).shape == (
        tgeo.PARAMS_PER_CAMERA,)


# two worlds of five views in one bucket (5 views, 16 edges, 64 points):
# 4 edges of 60 points, and 7 edges of 40
BUCKET_WORLDS = [dict(n_pts=60, seed=3), dict(n_pts=40, seed=8, skips=3)]


def _jax_bucket(matches, n):
    """The padded edges and match points of the JAX package's
    ``traverse`` for ``matches``: the shape of the points it hands to its
    traverse program."""
    got = {}

    class _Stop(Exception):
        pass

    def kernel(*ops, **kw):
        got["shape"] = tuple(ops[9].shape[:2])
        raise _Stop
    orig = jreg._traverse_kernel
    jreg._traverse_kernel = kernel
    try:
        jreg.traverse([np.zeros((8, 8, 3))] * n, matches)
    except _Stop:
        pass
    finally:
        jreg._traverse_kernel = orig
    return got["shape"]


@pytest.mark.parametrize("world", BUCKET_WORLDS, ids=["edges4", "edges7"])
def test_traverse_pads_to_the_jax_bucket(world, monkeypatch):
    """The padded problem takes the JAX package's bucket for the same
    graph; a padded edge joins camera 0 to itself, masked whole, brought
    by no add, and is never enabled; ``stats`` reports the real edges
    and the real longest edge."""
    _, matches, _ = synthetic_problem(n_cams=5, **world)
    plan = treg._plan(5, matches)
    n_edges = len(plan.edges)
    assert n_edges == 4 + world.get("skips", 0)
    assert plan.key == (5, 16, 64)
    assert plan.key[1:] == _jax_bucket(matches, 5)
    cam1, cam2, pts, mask, edge_add, place = plan.arrays()
    assert pts.shape == (16, 64, 6) and mask.shape == (16, 64)
    assert not cam1[n_edges:].any() and not cam2[n_edges:].any()
    assert (edge_add[n_edges:] == -1).all() and not mask[n_edges:].any()
    assert (pts[n_edges:, :, [2, 5]] == 1).all()
    assert not pts[n_edges:, :, [0, 1, 3, 4]].any()
    assert place.shape == (2, 4)
    states = []
    program = treg._program

    def keep(*a, **k):
        out = program(*a, **k)
        states.append(out[2])
        return out
    monkeypatch.setattr(treg, "_program", keep)
    stats = {}
    regs = treg.traverse([np.zeros((8, 8, 3))] * 5, matches, device="cpu",
                         stats=stats)
    assert len(regs) == 5
    enabled = states[0]["enabled"]
    assert enabled.shape == (16,) and not enabled[n_edges:].any()
    assert stats["ba_edges"] == n_edges
    assert stats["ba_edges_enabled"] == int(enabled.sum()) == n_edges
    assert stats["ba_edge_points"] == world["n_pts"]


@pytest.mark.parametrize("world", BUCKET_WORLDS, ids=["edges4", "edges7"])
def test_padded_traverse_matches_jax(world):
    """On two worlds of one bucket with 4 and 7 edges, the padded
    traverse's cameras match the JAX package's ``traverse`` (rotations
    within 1e-3 rad, focals within 1e-3 relative, as the pipeline's
    parity test) and the truth."""
    cams, matches, focal = synthetic_problem(n_cams=5, **world)
    imgs = [np.zeros((8, 8, 3))] * 5
    regs = treg.traverse(imgs, matches, device="cpu")
    jregs = jreg.traverse(imgs, matches)
    assert len(regs) == len(jregs) == 5
    for a, b in zip(regs, jregs):
        assert rot_err(a.rot, b.rot) <= 1e-3
        assert abs(a.intr[0, 0] / b.intr[0, 0] - 1) <= 1e-3
        assert abs(a.intr[0, 0] / focal - 1) <= 0.05
    for (a0, t0), (a1, t1) in zip(zip(regs, cams), zip(regs[1:], cams[1:])):
        assert rot_err(a1.rot @ a0.rot.T, t1.rot @ t0.rot.T) <= 1e-2
