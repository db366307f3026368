"""Port parity: marginalization priors (float64).

eigh's eigenvector signs (and the basis of repeated eigenvalues) differ
between LAPACK builds, so J0 and r0 are compared through their
invariants J0ᵀJ0 and J0ᵀr0, plus the kept rank."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.sim import ba_problems
from dynamic_vins_tpu.solver import gauss_newton as jgn
from dynamic_vins_tpu.solver import marginalization as jmarg
from dynamic_vins_tpu_torch import convert
from dynamic_vins_tpu_torch.solver import gauss_newton as tgn
from dynamic_vins_tpu_torch.solver import marginalization as tmarg

torch.set_num_threads(1)   # the xdist workers share the cores


def _np(t):
    if hasattr(t, "_asdict"):
        return {k: _np(v) for k, v in t._asdict().items()}
    return np.asarray(t)


def _rank(J):
    return int((np.abs(np.asarray(J)).sum(axis=1) > 0).sum())


def _same_prior(pj, pt):
    Jj, rj = np.asarray(pj.jacobian), np.asarray(pj.residual)
    Jt, rt = pt.jacobian.numpy(), pt.residual.numpy()
    H = Jj.T @ Jj
    scale = np.abs(H).max()
    np.testing.assert_allclose(Jt.T @ Jt, H, rtol=0, atol=1e-9 * scale)
    g = Jj.T @ rj
    np.testing.assert_allclose(Jt.T @ rt, g, rtol=0,
                               atol=1e-9 * max(np.abs(g).max(), 1.0))
    np.testing.assert_allclose(rt @ rt, rj @ rj, rtol=1e-8, atol=1e-12)
    assert _rank(Jt) == _rank(Jj) == tmarg.kept_rank(pt)
    for a, b in zip(pj.lin_state, pt.lin_state):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.fixture(scope="module")
def marg_case():
    ba = ba_problems.build(num_frames=5, num_landmarks=60,
                           obs_capacity=1024, lm_capacity=96, seed=1)
    st = ba_problems.perturb_state(ba.gt_state, seed=3)
    obs = ba.problem.obs
    drop = np.zeros(ba.problem.lm_valid.shape[0], bool)
    drop[np.asarray(obs.lm)[np.asarray(obs.valid)
                            & (np.asarray(obs.frame_i) == 0)]] = True
    pj = jmarg.marginalize_old(st, ba.gt_inv_depth, ba.problem,
                               jnp.asarray(drop), jgn.SolverConfig())
    pt = tmarg.marginalize_old(
        convert.window_state(_np(st)),
        torch.tensor(np.asarray(ba.gt_inv_depth)),
        convert.ba_problem(_np(ba.problem)), torch.tensor(drop),
        tgn.SolverConfig())
    return ba, st, pj, pt


def test_marginalize_old_matches(marg_case):
    _, _, pj, pt = marg_case
    _same_prior(pj, pt)
    assert bool(pt.valid)


def test_marginalize_second_new_matches(marg_case):
    _, _, pj, pt = marg_case
    _same_prior(jmarg.marginalize_second_new(pj, num_frames=5),
                tmarg.marginalize_second_new(pt, 5))


def test_slide_shifts_match(marg_case):
    _, st, pj, pt = marg_case
    _same_prior(jmarg.shift_prior_after_slide_old(pj, st),
                tmarg.shift_prior_after_slide_old(
                    pt, convert.window_state(_np(st))))
    _same_prior(jmarg.shift_prior_after_slide_new(pj),
                tmarg.shift_prior_after_slide_new(pt))


def test_f32_kept_rank_matches_f64():
    """cuSOLVER and LAPACK have other eigh backward errors; the
    equilibrated relative floor must keep the same rank in float32."""
    ba = ba_problems.build(num_frames=5, num_landmarks=60,
                           obs_capacity=1024, lm_capacity=96, seed=4)
    obs = ba.problem.obs
    drop = np.zeros(ba.problem.lm_valid.shape[0], bool)
    drop[np.asarray(obs.lm)[np.asarray(obs.valid)
                            & (np.asarray(obs.frame_i) == 0)]] = True
    ranks = []
    for dt in (torch.float64, torch.float32):
        p = tmarg.marginalize_old(
            convert.window_state(_np(ba.gt_state), dt),
            torch.tensor(np.asarray(ba.gt_inv_depth), dtype=dt),
            convert.ba_problem(_np(ba.problem), dt), torch.tensor(drop),
            tgn.SolverConfig())
        assert torch.isfinite(p.jacobian).all()
        ranks.append(tmarg.kept_rank(p))
    assert ranks[0] == ranks[1]
