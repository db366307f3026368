"""Port parity: the per-object factors, the vmapped object LM and the
box-fit helpers against the JAX package's, on the same numpy inputs
(CPU, float64).

The object problem is tests/test_object_solver.py's moving box (F = 6
frames, 32 landmarks, 512 observation rows, 64 extra points a frame).
Residuals agree within 1e-10; `solve_one` and `solve_all` (O = 4, one
object inactive) within 1e-8 in every state and landmark, the cost to
rtol 1e-6, with the same accept pattern: the two sides' costs after 1,
2, ... iterations fall at the same iterations. The box-fit functions
agree exactly on their masks and counts and within 1e-12 on the centers,
including inputs where the argmax over integer counts ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.estimator import box_fit as jbox
from dynamic_vins_tpu.factors import object_factors as jof
from dynamic_vins_tpu.geometry import lie as jlie
from dynamic_vins_tpu.solver import object_solver as jos
from dynamic_vins_tpu_torch import convert
from dynamic_vins_tpu_torch.estimator import box_fit as tbox
from dynamic_vins_tpu_torch.factors import object_factors as tof
from dynamic_vins_tpu_torch.solver import object_solver as tos
from test_object_solver import _make_moving_object

torch.set_num_threads(1)   # the xdist workers share the cores

RES_ATOL = 1e-10
STATE_ATOL = 1e-8
COST_RTOL = 1e-6


def _t(tree):
    """A JAX ObjectWindow / ObjectProblem -> the port's (convert.py)."""
    d = {k: np.asarray(v) for k, v in tree._asdict().items()}
    return (convert.object_window(d) if isinstance(tree, jof.ObjectWindow)
            else convert.object_problem(d))


def _problem(rng, O=None):
    gt, pts_obj, prob = _make_moving_object(pixel_noise=0.5)
    d = rng.normal(scale=0.05, size=(6, 6))
    p0, q0 = jlie.pose_boxplus(gt.p, gt.q, jnp.asarray(d))
    state = gt._replace(
        p=p0, q=q0, v=gt.v + jnp.asarray(rng.normal(scale=0.2, size=3)),
        w=gt.w + jnp.asarray(rng.normal(scale=0.05, size=3)),
        dims=gt.dims * 1.15)
    lm = pts_obj + jnp.asarray(rng.normal(scale=0.03, size=pts_obj.shape))
    # some invalid rows, frames and landmarks
    prob = prob._replace(
        obs_valid=prob.obs_valid.at[::7].set(False),
        extra_valid=prob.extra_valid.at[2, 40:].set(False),
        det_valid=prob.det_valid.at[1].set(False),
        lm_valid=prob.lm_valid.at[5].set(False))
    if O is None:
        return state, lm, prob
    stack = lambda x: jnp.stack([x] * O)
    states = jax.tree.map(stack, state)
    d = jnp.asarray(rng.normal(scale=0.03, size=(O, 6, 6)))
    p0, q0 = jlie.pose_boxplus(states.p, states.q, d)
    return (states._replace(p=p0, q=q0), stack(lm),
            jax.tree.map(stack, prob))


def test_object_residuals_match(rng):
    state, lm, prob = _problem(rng)
    ts, tp = _t(state), _t(prob)
    tl = torch.tensor(np.asarray(lm))
    cfg = jos.ObjectSolverConfig()
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), b.numpy(), rtol=0, atol=RES_ATOL)
    close(jos._residuals(state, lm, prob, cfg),
          tos._residuals(ts, tl, tp, tos.ObjectSolverConfig()))
    close(jof.box_dims_residual(state.dims, prob.dims_det, 5.0),
          tof.box_dims_residual(ts.dims, tp.dims_det, 5.0))
    close(jax.vmap(jof.box_orientation_residual)(state.q, prob.q_det),
          tof.box_orientation_residual(ts.q, tp.q_det))
    for k in range(6):
        close(jof.box_enclose_residual(state.p[k], state.q[k], state.dims,
                                       prob.extra_pts[k],
                                       prob.extra_valid[k]),
              tof.box_enclose_residual(ts.p[k], ts.q[k], ts.dims,
                                       tp.extra_pts[k], tp.extra_valid[k]))
    j = prob.obs_frame[:40]
    close(jof.object_point_reprojection_residual(
        state.p[2], state.q[2], lm[prob.obs_lm[:40]],
        prob.p_cw[2, 0], prob.q_cw[2, 0], prob.obs_norm[:40],
        prob.obs_valid[:40] & (j == 2)),
        tof.object_point_reprojection_residual(
            ts.p[2], ts.q[2], tl[tp.obs_lm[:40]], tp.p_cw[2, 0],
            tp.q_cw[2, 0], tp.obs_norm[:40],
            tp.obs_valid[:40] & (tp.obs_frame[:40] == 2)))
    close(jof.const_twist_residual(state.p, state.q, state.v, state.w,
                                   prob.times, prob.frame_valid),
          tof.const_twist_residual(ts.p, ts.q, ts.v, ts.w, tp.times,
                                   tp.frame_valid))


def _close_solution(jres, tres):
    (jst, jlm, jcost), (tst, tlm, tcost) = jres, tres
    for a, b in zip(jst, tst):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=STATE_ATOL)
    np.testing.assert_allclose(tlm.numpy(), np.asarray(jlm), rtol=0,
                               atol=STATE_ATOL)
    np.testing.assert_allclose(tcost.numpy(), np.asarray(jcost),
                               rtol=COST_RTOL)


@pytest.mark.parametrize("batched", [False, True])
def test_solver_matches(rng, batched):
    """After 1..ITERS iterations: the same states, landmarks and costs;
    the iterations where the cost falls (the accepted steps) agree."""
    iters = 4
    if batched:
        states, lms, probs = _problem(rng, O=4)
        active = np.array([True, True, False, True])
        run_j = lambda c: jos.solve_all(states, lms, probs, c,
                                        jnp.asarray(active))
        tst, tlm, tpr = _t(states), torch.tensor(np.asarray(lms)), \
            _t(probs)
        run_t = lambda c: tos.solve_all(tst, tlm, tpr, c,
                                        torch.tensor(active))
    else:
        state, lm, prob = _problem(rng)
        run_j = lambda c: jos.solve_one(state, lm, prob, c,
                                        jnp.asarray(True))
        ts, tl, tp = _t(state), torch.tensor(np.asarray(lm)), _t(prob)
        run_t = lambda c: tos.solve_one(ts, tl, tp, c, torch.tensor(True))
    costs_j, costs_t = [], []
    for k in range(1, iters + 1):
        jres = run_j(jos.ObjectSolverConfig(max_iters=k))
        tres = run_t(tos.ObjectSolverConfig(max_iters=k))
        _close_solution(jres, tres)
        costs_j.append(np.asarray(jres[2]))
        costs_t.append(tres[2].numpy())
    acc_j = np.diff(np.stack(costs_j), axis=0) < 0
    acc_t = np.diff(np.stack(costs_t), axis=0) < 0
    np.testing.assert_array_equal(acc_t, acc_j)
    assert acc_t.any()
    if batched:       # the inactive object keeps its state
        np.testing.assert_array_equal(tres[0].p[2].numpy(),
                                      tst.p[2].numpy())


def _cloud(rng, n=40, ties=False):
    pts = rng.normal(scale=0.6, size=(n, 3))
    pts[n // 2:] += [6.0, 0.0, 0.0]
    if ties:     # two equal clusters: equal counts and equal degrees
        pts[n // 2:] = pts[:n // 2] + [6.0, 0.0, 0.0]
    valid = np.ones(n, bool)
    valid[[3, n // 2 + 3]] = False
    return pts, valid


@pytest.mark.parametrize("ties", [False, True])
def test_box_fit_matches(rng, ties):
    pts, valid = _cloud(rng, ties=ties)
    q = np.array([np.cos(0.2), 0.0, 0.0, np.sin(0.2)])
    dims = np.array([2.0, 1.5, 1.2])
    J, T = jnp.asarray, torch.tensor
    cj, nj, mj = jbox.fit_box_center(J(pts), J(valid), J(q), J(dims))
    ct, nt, mt = tbox.fit_box_center(T(pts), T(valid), T(q), T(dims))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert int(nt) == int(nj)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                               atol=1e-12)
    # batched over objects: the same as one at a time
    cb, nb, mb = tbox.fit_box_center(T(np.stack([pts, pts[::-1]])),
                                     T(np.stack([valid, valid[::-1]])),
                                     T(np.stack([q, q])),
                                     T(np.stack([dims, dims])))
    np.testing.assert_array_equal(mb[0].numpy(), mt.numpy())
    c1, _, m1 = jbox.fit_box_center(J(pts[::-1]), J(valid[::-1]), J(q),
                                    J(dims))
    np.testing.assert_array_equal(mb[1].numpy(), np.asarray(m1))
    np.testing.assert_allclose(cb[1].numpy(), np.asarray(c1), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(
        tbox.centroid(T(pts), T(valid)).numpy(),
        np.asarray(jbox.centroid(J(pts), J(valid))), rtol=0, atol=1e-12)
    for radius in (0.5, 1.0):
        np.testing.assert_array_equal(
            tbox.radius_filter(T(pts), T(valid), radius=radius).numpy(),
            np.asarray(jbox.radius_filter(J(pts), J(valid),
                                          radius=radius)))
        kt = tbox.largest_cluster(T(pts), T(valid), radius=radius)
        kj = jbox.largest_cluster(J(pts), J(valid), radius=radius)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    if ties:
        # the tie goes to the first maximum on both sides
        assert np.asarray(kj)[:20].sum() > 0 and not np.asarray(kj)[20:].any()
