"""Port parity (float64, CPU) of the LinePoint math: line geometry, the
line factor, the line-only refinement, the LM with line blocks, and the
line manager's bookkeeping.

Same numpy inputs from a seed go to the JAX functions and the port's.
Tolerances: geometry and residuals 1e-10 (the same float64 formulas),
Jacobians rtol 1e-6 (JAX's jacrev against torch's jacfwd), the
refinement 1e-8 (LU against the port's 4x4 Cholesky), the joint solve
1e-8 in state and orth with the same accepted pattern (as
tests/test_torch_solver.py holds the points-only LM), the manager's
orth 1e-10 (the same numpy code). Each JAX function is compiled once
per module (the solve dominates the file's time).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.estimator import line_manager as jlm
from dynamic_vins_tpu.factors import line_factor as jlf
from dynamic_vins_tpu.geometry import lie as jlie
from dynamic_vins_tpu.geometry import lines as jlines
from dynamic_vins_tpu.sim import ba_problems
from dynamic_vins_tpu.sim import synthetic as jsim
from dynamic_vins_tpu.solver import gauss_newton as jgn
from dynamic_vins_tpu_torch import convert
from dynamic_vins_tpu_torch.estimator import line_manager as tlm
from dynamic_vins_tpu_torch.factors import line_factor as tlf
from dynamic_vins_tpu_torch.geometry import lie_np
from dynamic_vins_tpu_torch.geometry import lines as tlines
from dynamic_vins_tpu_torch.solver import gauss_newton as tgn

torch.set_num_threads(1)   # the xdist workers share the cores

F, LC, NOBS, NSEG = 4, 64, 256, 80


def _np(t):
    if t is None:
        return None
    if hasattr(t, "_asdict"):
        return {k: _np(v) for k, v in t._asdict().items()}
    return np.asarray(t)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(a, b, rtol=1e-10, atol=1e-10):
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(b, np.asarray(a), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def world():
    """Segments around tests/test_lines.py's trajectory, their left
    observations, the ground-truth orth, the BA problem."""
    rng = np.random.default_rng(0)
    seq = jsim.generate_sequence(num_frames=F, num_landmarks=4, seed=1)
    rig = seq.rig
    centers = np.asarray(jsim.make_landmarks(NSEG, seed=7))
    dirs = rng.normal(size=(NSEG, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    s_w, e_w = centers - dirs, centers + dirs
    rows, orth_gt = [], []
    for l in range(NSEG):
        seen = []
        for k in range(F):
            p_cw, q_cw = jlie.pose_inverse(*jlie.pose_compose(
                seq.gt_p[k], seq.gt_q[k], rig.p_bc, rig.q_bc))
            sc = np.asarray(jlie.pose_transform_point(p_cw, q_cw, s_w[l]))
            ec = np.asarray(jlie.pose_transform_point(p_cw, q_cw, e_w[l]))
            if sc[2] < 0.5 or ec[2] < 0.5:
                continue
            sn, en = sc / sc[2], ec / ec[2]
            if abs(sn[0]) > 0.8 or abs(sn[1]) > 0.55:
                continue
            seen.append((k, sn, en))
        if len(seen) >= 2:
            slot = len(orth_gt)
            rows += [(k, 0, slot, sn, en) for k, sn, en in seen]
            orth_gt.append(np.asarray(jlines.plucker_to_orth(
                *jlines.plucker_from_two_points(jnp.asarray(s_w[l]),
                                                jnp.asarray(e_w[l])))))
    n_lines = len(orth_gt)
    obs = {"frame_j": np.zeros(NOBS, np.int32),
           "cam_j": np.zeros(NOBS, np.int32),
           "line": np.zeros(NOBS, np.int32),
           "s": np.tile([0.0, 0.0, 1.0], (NOBS, 1)),
           "e": np.tile([0.0, 0.0, 1.0], (NOBS, 1)),
           "valid": np.zeros(NOBS, bool)}
    for i, (k, c, sl, sn, en) in enumerate(rows):
        obs["frame_j"][i], obs["cam_j"][i], obs["line"][i] = k, c, sl
        obs["s"][i], obs["e"][i], obs["valid"][i] = sn, en, True
    orth_true = np.zeros((LC, 4))
    orth_true[:n_lines] = orth_gt
    orth0 = np.asarray(jlines.orth_boxplus(
        jnp.asarray(orth_true), jnp.asarray(rng.normal(scale=0.01,
                                                       size=(LC, 4)))))
    line_valid = np.arange(LC) < n_lines
    ba = ba_problems.build(num_frames=F, num_landmarks=60)
    state0 = ba_problems.perturb_state(ba.gt_state, pos_sigma=0.03,
                                       rot_sigma=0.01, seed=3)
    jobs = jlf.LineObs(**{k: jnp.asarray(v) for k, v in obs.items()})
    return dict(n_lines=n_lines, obs=obs, jobs=jobs, orth0=orth0,
                orth_true=orth_true,
                line_valid=line_valid, ba=ba, state0=state0,
                tobs=convert.line_obs(obs), rng=rng)


def test_line_geometry_matches(world):
    rng = np.random.default_rng(3)
    p1, p2 = rng.normal(size=(2, 16, 3))
    n, d = jlines.plucker_from_two_points(jnp.asarray(p1), jnp.asarray(p2))
    nt, dt = tlines.plucker_from_two_points(_t(p1), _t(p2))
    _close(n, nt)
    _close(d, dt)
    orth = jlines.plucker_to_orth(n, d)
    _close(orth, tlines.plucker_to_orth(nt, dt))
    for a, b in zip(jlines.orth_to_plucker(orth),
                    tlines.orth_to_plucker(_t(orth))):
        _close(a, b)
    delta = rng.normal(scale=0.1, size=(16, 4))
    _close(jlines.orth_boxplus(orth, jnp.asarray(delta)),
           tlines.orth_boxplus(_t(orth), _t(delta)))
    pi1, pi2 = rng.normal(size=(2, 16, 4))
    for a, b in zip(jlines.plucker_from_two_planes(pi1, pi2),
                    tlines.plucker_from_two_planes(_t(pi1), _t(pi2))):
        _close(a, b)
    pts = rng.normal(size=(3, 16, 3))
    _close(jlines.plane_from_point_line(*pts),
           tlines.plane_from_point_line(*map(_t, pts)))
    p = rng.normal(size=(16, 3))
    q = rng.normal(size=(16, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    for a, b in zip(jlines.transform_line(n, d, jnp.asarray(p),
                                          jnp.asarray(q)),
                    tlines.transform_line(nt, dt, _t(p), _t(q))):
        _close(a, b)
    pt = np.concatenate([rng.normal(size=(16, 2)), np.ones((16, 1))], 1)
    _close(jlines.line_point_distance(n, jnp.asarray(pt)),
           tlines.line_point_distance(nt, _t(pt)))
    _close(jlines.endpoint_trim(n, d, None, None, None, None),
           tlines.endpoint_trim(nt, dt, None, None, None, None))
    # two-view and multiview triangulation of the world's line 0
    ba = world["ba"]
    st = ba.gt_state
    o = world["obs"]
    rows = np.flatnonzero(o["valid"] & (o["line"] == 0))
    cams = []
    for k in o["frame_j"][rows]:
        cams.append(jlie.pose_inverse(*jlie.pose_compose(
            st.p[k], st.q[k], st.p_bc[0], st.q_bc[0])))
    p_cw = np.stack([np.asarray(c[0]) for c in cams])
    q_cw = np.stack([np.asarray(c[1]) for c in cams])
    s, e = o["s"][rows], o["e"][rows]
    two = (p_cw[0], q_cw[0], p_cw[1], q_cw[1], s[0], e[0], s[1], e[1])
    for a, b in zip(jlines.triangulate_line_two_view(*map(jnp.asarray, two)),
                    tlines.triangulate_line_two_view(*map(_t, two))):
        _close(a, b)
    valid = np.ones(len(rows))
    mj = jlines.triangulate_line_multiview(*map(jnp.asarray,
                                                (p_cw, q_cw, s, e, valid)))
    mt = tlines.triangulate_line_multiview(*map(_t, (p_cw, q_cw, s, e,
                                                     valid)))
    sign = np.sign(float(mj[1] @ np.asarray(mj[1])) *
                   float(np.asarray(mj[1]) @ mt[1].numpy()))
    _close(mj[0], mt[0] * sign, atol=1e-9)
    _close(mj[1], mt[1] * sign, atol=1e-9)
    _close(mj[2], mt[2], atol=1e-9)
    # the manager's host copy gives the same line
    nh, dh = tlm._triangulate_line_multiview_np(p_cw, q_cw, s, e)
    _close(tlm.plucker_to_orth_np(nh, dh), tlines.plucker_to_orth(
        mt[0], mt[1]), atol=1e-9)


def test_line_factor_matches(world):
    st = world["state0"]
    orth = world["orth0"]
    rj, jcj, jgj, cj = jax.jit(jlf.evaluate)(st, jnp.asarray(orth),
                                             world["jobs"])
    st_t = convert.window_state(_np(st))
    rt, jct, jgt, ct = tlf.evaluate(st_t, _t(orth), world["tobs"])
    _close(rj, rt)
    _close(jcj, jct, rtol=1e-6, atol=1e-8)
    _close(jgj, jgt, rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    _close(jax.jit(lambda *a: jlf.residual_only(*a, sqrt_info=1.0))(
        st, jnp.asarray(orth), world["jobs"]),
           tlf.residual_only(st_t, _t(orth), world["tobs"], sqrt_info=1.0))
    # zero at the ground truth
    assert world["n_lines"] >= 10
    r = tlf.residual_only(convert.window_state(_np(world["ba"].gt_state)),
                          _t(world["orth_true"]), world["tobs"])
    assert float(r.abs().max()) < 1e-6


def test_refine_orth_matches(world):
    st = world["ba"].gt_state
    orth_j = jax.jit(lambda o: jlf.refine_orth(
        st, o, world["jobs"], jnp.asarray(world["line_valid"])))(
            jnp.asarray(world["orth0"]))
    orth_t = tlf.refine_orth(convert.window_state(_np(st)),
                             _t(world["orth0"]), world["tobs"],
                             _t(world["line_valid"]))
    _close(orth_j, orth_t, rtol=0, atol=1e-8)
    n = world["n_lines"]
    np.testing.assert_array_equal(orth_t[n:].numpy(), world["orth0"][n:])
    # the residuals dropped
    r0 = tlf.residual_only(convert.window_state(_np(st)),
                           _t(world["orth0"]), world["tobs"])
    r1 = tlf.residual_only(convert.window_state(_np(st)), orth_t,
                           world["tobs"])
    assert float(r1.abs().mean()) < 0.1 * float(r0.abs().mean())


def test_spd_solve_matches_linalg():
    rng = np.random.default_rng(4)
    M = rng.normal(size=(32, 4, 4))
    A = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(4)
    b = rng.normal(size=(32, 4, 3))
    _close(np.linalg.solve(A, b), tlf.spd_solve(_t(A), _t(b)), rtol=1e-10,
           atol=1e-12)


@pytest.fixture(scope="module")
def line_solve(world):
    ba = world["ba"]
    problem = ba.problem._replace(line_obs=world["jobs"],
                                  line_valid=jnp.asarray(world["line_valid"]))
    cfg = jgn.SolverConfig(use_imu=True, max_iters=6)
    out = jax.jit(lambda s, d, o: jgn.solve(s, d, problem, cfg,
                                            line_orth=o))(
        world["state0"], ba.gt_inv_depth, jnp.asarray(world["orth0"]))
    return problem, cfg, out


def test_lm_solve_with_lines_matches(world, line_solve):
    """The same accepted pattern; state and orth within 1e-8."""
    problem, cfg, (stj, depj, orthj, infoj) = line_solve
    tproblem = convert.ba_problem(_np(problem))
    assert tproblem.line_obs is not None
    tcfg = tgn.SolverConfig(use_imu=True, max_iters=6)
    stt, dept, ortht, infot = tgn.solve(
        convert.window_state(_np(world["state0"])),
        _t(world["ba"].gt_inv_depth), tproblem, tcfg,
        line_orth=_t(world["orth0"]))
    np.testing.assert_array_equal(infot.accepted.numpy(),
                                  np.asarray(infoj.accepted))
    assert bool(infot.accepted.any())
    np.testing.assert_allclose(float(infot.initial_cost),
                               float(infoj.initial_cost), rtol=1e-9)
    np.testing.assert_allclose(float(infot.final_cost),
                               float(infoj.final_cost), rtol=1e-6)
    for a, b in zip(stj, stt):
        _close(a, b, rtol=0, atol=1e-8)
    _close(depj, dept, rtol=1e-6, atol=1e-8)
    _close(orthj, ortht, rtol=0, atol=1e-8)
    assert float(infot.final_cost) < float(infot.initial_cost) * 1e-2
    # total_cost with lines, at the solution
    np.testing.assert_allclose(
        float(tgn.total_cost(stt, dept, tproblem, tcfg, line_orth=ortht)),
        float(jgn.total_cost(stj, depj, problem, cfg, line_orth=orthj)),
        rtol=1e-6)


def test_points_only_solve_unchanged(world):
    """Without lines the solve returns (state, depth, info) and ignores
    a line table given without orth."""
    ba = world["ba"]
    tproblem = convert.ba_problem(_np(ba.problem))
    assert tproblem.line_obs is None
    tcfg = tgn.SolverConfig(use_imu=True, max_iters=3)
    st0 = convert.window_state(_np(world["state0"]))
    dep0 = _t(ba.gt_inv_depth)
    a = tgn.solve(st0, dep0, tproblem, tcfg)
    b = tgn.solve(st0, dep0, tproblem._replace(
        line_obs=world["tobs"], line_valid=_t(world["line_valid"])), tcfg)
    assert len(a) == 3 and len(b) == 3
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    eq = tgn.build_normal_equations(st0, dep0, tproblem, tcfg)
    assert eq.H_gg is None
    dc, dl, dg = tgn.solve_damped(eq, tproblem.lm_valid, tproblem.fixed_cols,
                                  torch.tensor(1e-4, dtype=torch.float64),
                                  1e-8)
    assert dg is None and torch.isfinite(dc).all()


def _window_state(rng, F_):
    from types import SimpleNamespace

    q = rng.normal(size=(F_, 4)) * 0.05 + np.array([1.0, 0, 0, 0])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = np.cumsum(rng.normal(scale=0.2, size=(F_, 3)), axis=0)
    return SimpleNamespace(p=p, q=q, p_bc=np.array([[0.0, 0, 0],
                                                    [0.1, 0, 0]]),
                           q_bc=np.tile([1.0, 0, 0, 0], (2, 1)))


def _frame_lines(rng, st, k, s_w, e_w, noise):
    out = {}
    for l in range(len(s_w)):
        obs = []
        for c in (0, 1):
            R = lie_np.quat_to_matrix(st.q[k])
            p_wc = st.p[k] + R @ st.p_bc[c]
            sc = R.T @ (s_w[l] - p_wc)
            ec = R.T @ (e_w[l] - p_wc)
            if sc[2] < 0.5 or ec[2] < 0.5:
                obs.append(None)
                continue
            obs.append((np.append(sc[:2] / sc[2] + rng.normal(
                scale=noise, size=2), 1.0), np.append(
                ec[:2] / ec[2] + rng.normal(scale=noise, size=2), 1.0)))
        if obs[0] is not None and rng.random() > 0.1:
            sr, er = obs[1] if obs[1] is not None else (None, None)
            out[l + 100] = (obs[0][0], obs[0][1], sr, er)
    return out


def test_line_manager_matches():
    """Both managers over a window with both slides, the triangulation,
    the outlier removal and a full slot table: equal bookkeeping, orth
    within 1e-10, the same observation tables."""
    rng = np.random.default_rng(11)
    F_ = 6
    st = _window_state(rng, F_ + 4)
    centers = rng.normal(size=(30, 3)) * [2.0, 1.0, 1.0] + [0, 0, 6.0]
    d = rng.normal(size=(30, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    s_w, e_w = centers - d, centers + d
    jm = jlm.LineManager(num_frames=F_, capacity=24, obs_capacity=96)
    tm = tlm.LineManager(num_frames=F_, capacity=24, obs_capacity=96)
    names = ("active", "line_id", "has_obs", "has_right", "s", "e", "s_r",
             "e_r", "orth_valid")

    def same():
        for n in names:
            np.testing.assert_array_equal(getattr(tm, n), getattr(jm, n),
                                          err_msg=n)
        _close(jm.orth, tm.orth)
        assert tm._id_to_slot == jm._id_to_slot

    k = 0
    for t in range(F_ + 4):
        win = SimpleWindow(st, t - k, F_)
        lines = _frame_lines(rng, win, k, s_w, e_w, 0.3 / 460)
        jm.add_lines(k, lines)
        tm.add_lines(k, lines)
        jm.triangulate(win, k)
        tm.triangulate(win, k)
        same()
        if k == F_ - 1:
            errs = rng.random(24) * 0.02
            jm.remove_outliers(errs)
            tm.remove_outliers(errs)
            if t % 2:
                jm.slide_old()
                tm.slide_old()
            else:
                jm.slide_new()
                tm.slide_new()
            same()
        else:
            k += 1
    assert tm.orth_valid.any() and tm.active.any()
    li, lf, lv, mask = tm.build_obs_packed()
    for a, b in zip(jm.build_obs_packed(), (li, lf, lv, mask)):
        np.testing.assert_array_equal(b, a)
    jobs, jmask = jm.build_obs_table(jnp.float64)
    tobs, tmask = tm.build_obs_table(torch.float64, "cpu")
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    for name in ("frame_j", "cam_j", "line", "valid"):
        np.testing.assert_array_equal(getattr(tobs, name).numpy(),
                                      np.asarray(getattr(jobs, name)))
    _close(jobs.s, tobs.s)
    _close(jobs.e, tobs.e)
    orth = rng.normal(size=(24, 4))
    jm.set_orth(orth, mask)
    tm.set_orth(orth, mask)
    same()


class SimpleWindow:
    """Window poses of frames [t0, t0 + F) of a trajectory."""

    def __init__(self, st, t0, F_):
        t0 = max(t0, 0)
        self.p = st.p[t0:t0 + F_]
        self.q = st.q[t0:t0 + F_]
        self.p_bc, self.q_bc = st.p_bc, st.q_bc
