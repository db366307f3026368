"""Port parity: factor residuals/Jacobians and the LM solve (float64)
on sim/ba_problems problems."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.factors import imu_factor as jimu
from dynamic_vins_tpu.factors import prior as jprior
from dynamic_vins_tpu.factors import projection as jproj
from dynamic_vins_tpu.sim import ba_problems
from dynamic_vins_tpu.solver import gauss_newton as jgn
from dynamic_vins_tpu.solver import layout as jlayout
from dynamic_vins_tpu.solver import marginalization as jmarg
from dynamic_vins_tpu_torch import convert
from dynamic_vins_tpu_torch.factors import imu_factor as timu
from dynamic_vins_tpu_torch.factors import prior as tprior
from dynamic_vins_tpu_torch.factors import projection as tproj
from dynamic_vins_tpu_torch.solver import gauss_newton as tgn
from dynamic_vins_tpu_torch.solver import layout as tlayout

torch.set_num_threads(1)   # the xdist workers share the cores


def _np(t):
    if hasattr(t, "_asdict"):
        return {k: _np(v) for k, v in t._asdict().items()}
    return np.asarray(t)


@pytest.fixture(scope="module")
def problem():
    ba = ba_problems.build(num_frames=5, num_landmarks=60,
                           obs_capacity=1024, lm_capacity=96,
                           pixel_noise=0.5, seed=2)
    st0 = ba_problems.perturb_state(ba.gt_state, pos_sigma=0.05,
                                    rot_sigma=0.02, vel_sigma=0.1, seed=7)
    dep0 = np.asarray(ba.gt_inv_depth) * (1.0 + 0.05 * np.random.default_rng(
        8).normal(size=ba.gt_inv_depth.shape))
    return ba, st0, jnp.asarray(dep0)


def _close(a, b, rtol=1e-9, atol=1e-9):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                               atol=atol)


def test_projection_factor_matches(problem):
    ba, st0, dep0 = problem
    rj, jcj, jdj, cj = jproj.evaluate(st0, dep0, ba.problem.obs)
    st_t = convert.window_state(_np(st0))
    obs_t = convert.proj_obs(_np(ba.problem.obs))
    rt, jct, jdt, ct = tproj.evaluate(st_t, torch.tensor(np.asarray(dep0)),
                                      obs_t)
    _close(rj, rt)
    _close(jcj, jct, rtol=1e-8, atol=1e-8)
    _close(jdj, jdt, rtol=1e-8, atol=1e-8)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_imu_factor_matches(problem):
    ba, st0, _ = problem
    rj, Jj, cj = jimu.evaluate(st0, ba.problem.pres, ba.problem.imu_valid)
    rt, Jt, ct = timu.evaluate(convert.window_state(_np(st0)),
                               convert.preintegration(_np(ba.problem.pres)),
                               torch.tensor(np.asarray(ba.problem.imu_valid)))
    _close(rj, rt, rtol=1e-8, atol=1e-8)
    _close(Jj, Jt, rtol=1e-7, atol=1e-6)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_prior_factor_matches(problem):
    ba, st0, _ = problem
    drop = np.zeros(ba.problem.lm_valid.shape[0], bool)
    drop[np.asarray(ba.problem.obs.lm)[np.asarray(ba.problem.obs.valid)
                                       & (np.asarray(
                                           ba.problem.obs.frame_i) == 0)]] \
        = True
    prior = jmarg.marginalize_old(ba.gt_state, ba.gt_inv_depth, ba.problem,
                                  jnp.asarray(drop), jgn.SolverConfig())
    rj, Jj = jprior.evaluate(st0, prior)
    rt, Jt = tprior.evaluate(convert.window_state(_np(st0)),
                             convert.marginal_prior(_np(prior)))
    _close(rj, rt, rtol=1e-8, atol=1e-8)
    _close(Jj, Jt, rtol=0, atol=0)


@pytest.mark.parametrize("use_imu", [True, False])
def test_lm_solve_matches(problem, use_imu):
    """Same accepted pattern, final cost within rtol 1e-6."""
    ba, st0, dep0 = problem
    cfg = jgn.SolverConfig(use_imu=use_imu, max_iters=8)
    stj, depj, infoj = jgn.solve(st0, dep0, ba.problem, cfg)
    tcfg = tgn.SolverConfig(use_imu=use_imu, max_iters=8)
    stt, dept, infot = tgn.solve(convert.window_state(_np(st0)),
                                 torch.tensor(np.asarray(dep0)),
                                 convert.ba_problem(_np(ba.problem)), tcfg)
    np.testing.assert_array_equal(infot.accepted.numpy(),
                                  np.asarray(infoj.accepted))
    np.testing.assert_allclose(float(infot.initial_cost),
                               float(infoj.initial_cost), rtol=1e-9)
    np.testing.assert_allclose(float(infot.final_cost),
                               float(infoj.final_cost), rtol=1e-6)
    _close(stj.p, stt.p, rtol=0, atol=1e-7)
    _close(depj, dept, rtol=1e-6, atol=1e-8)
    tc = tgn.total_cost(stt, dept, convert.ba_problem(_np(ba.problem)), tcfg)
    np.testing.assert_allclose(float(tc), float(jgn.total_cost(
        stj, depj, ba.problem, cfg)), rtol=1e-6)


def test_assembled_rows_match_scatter(problem):
    ba, st0, dep0 = problem
    st_t = convert.window_state(_np(st0))
    obs_t = convert.proj_obs(_np(ba.problem.obs))
    _, j_cam, _, cols = tproj.evaluate(st_t, torch.tensor(np.asarray(dep0)),
                                       obs_t)
    D = 15 * 5 + 13
    a = tgn._scatter_rows(j_cam, cols, D)
    b = tgn._assemble_proj_rows(j_cam, obs_t, 5, D)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("F", [5, 11])
def test_window_layout_matches(problem, F):
    assert tlayout.cam_dim(F) == jlayout.cam_dim(F)
    for k in range(F):
        assert tlayout.pose_col(k) == jlayout.pose_col(k)
        assert tlayout.speedbias_col(k, F) == jlayout.speedbias_col(k, F)
    for cam in (0, 1):
        assert tlayout.extrinsic_col(cam, F) == jlayout.extrinsic_col(cam, F)
    assert tlayout.td_col(F) == jlayout.td_col(F)
    np.testing.assert_array_equal(tlayout.plane_constraint_cols(F),
                                  jlayout.plane_constraint_cols(F))
    if F != 5:
        return
    _, st0, _ = problem
    st_t = convert.window_state(_np(st0))
    delta = np.random.default_rng(7).normal(
        scale=0.05, size=jlayout.cam_dim(F))
    plus_j = st0.boxplus(jnp.asarray(delta))
    plus_t = st_t.boxplus(torch.tensor(delta))
    _close(plus_j.pack(), plus_t.pack(), rtol=0, atol=1e-12)
    _close(plus_j.boxminus(st0), plus_t.boxminus(st_t), rtol=0, atol=1e-10)
    flat = st_t.pack()
    back = tlayout.WindowState.unpack(flat, F)
    for a, b in zip(back, st_t):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    host = tlayout.WindowState.unpack(st_t.to_numpy().pack(), F)
    np.testing.assert_array_equal(host.q, st_t.q.numpy())
