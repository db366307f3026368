"""Port parity: the single-card scaling tool
(`tools/singlechip_scaling`): the psum model equal to the JAX tool's
formula at its constant (the JAX tool's `run` driven with stand-in
timings), and one 2048-row solve of the tool's problem within rtol 1e-5
of JAX's final cost, in float64 (in float32 the two lie 2.8e-5 apart,
each 3e-5 and 6e-5 from the float64 solve of the same inputs:
PERF.md)."""

import types

import jax.numpy as jnp
import numpy as np
import torch

from dynamic_vins_tpu.sim import ba_problems as jba
from dynamic_vins_tpu.solver import gauss_newton as jgn
from dynamic_vins_tpu.tools import singlechip_scaling as jsc
from dynamic_vins_tpu.utils import precision as jprec
from dynamic_vins_tpu_torch.solver import gauss_newton as tgn
from dynamic_vins_tpu_torch.tools import singlechip_scaling as tsc

torch.set_num_threads(1)   # the xdist workers share the cores


def test_psum_model_is_the_jax_formula(monkeypatch):
    """JAX's `run(fast=True)` with stand-ins for the problem, the
    compiled solve and the timer, so its psum model runs on known
    timings; the port's `psum_model` on the same rows at JAX's link
    constant (4.5e10 B/s) gives the same numbers."""
    def fake_build(num_landmarks, obs_capacity, lm_capacity, **k):
        return types.SimpleNamespace(
            problem=jnp.asarray([obs_capacity, lm_capacity]),
            gt_state=jnp.zeros(1), gt_inv_depth=jnp.zeros(1))

    def fake_solve(s, d, p):
        return (types.SimpleNamespace(p=jnp.zeros(1)), d,
                types.SimpleNamespace(final_cost=jnp.zeros(())))

    def fake_ms(solve, args, R=6, M=3):
        obs, lm = np.asarray(args[2]).reshape(-1, 2)[0]
        return 4.0 + 2.5e-4 * obs + 1e-4 * lm

    monkeypatch.setattr(jba, "build", fake_build)
    monkeypatch.setattr(jba, "perturb_state", lambda s, **k: s)
    monkeypatch.setattr(jprec, "precise_jit", lambda f: fake_solve)
    monkeypatch.setattr(jsc, "_queued_ms", fake_ms)
    ref = jsc.run(fast=True)
    assert [r["ms_10iter"] for r in ref["obs_sweep"]] == [4.61, 6.15, 12.29]
    got = tsc.psum_model(ref["obs_sweep"], link_bytes_s=4.5e10)
    jm = ref["psum_model"]
    for k in ("state_cols", "psum_bytes_per_iter", "compute_ms_per_iter_1chip",
              "serial_frac_measured", "projection"):
        assert got[k] == jm[k], k
    assert got["comm_ms_per_iter_link"] == jm["comm_ms_per_iter_ici"]
    # the port's own figure: the H100's published NVLink rate
    assert tsc.psum_model(ref["obs_sweep"])["link_bytes_per_s"] == 4.5e11


def test_solve_matches():
    obs, lm, n = 2048, 1024, min(900, 2048 // 5)
    ba = jba.build(num_frames=11, num_landmarks=n, obs_capacity=obs,
                   lm_capacity=lm, pixel_noise=0.5, seed=0)
    state0 = jba.perturb_state(ba.gt_state, pos_sigma=0.05, rot_sigma=0.02,
                               seed=1)
    cfg = jgn.SolverConfig(use_imu=True, max_iters=tsc.ITERS)
    solve = jprec.precise_jit(lambda s, d, p: jgn.solve(s, d, p, cfg))
    _, _, info = solve(state0, ba.gt_inv_depth, ba.problem)
    jc = float(info.final_cost)

    args = tsc.build(obs, lm, n, "cpu", dtype=torch.float64)
    _, _, tinfo = tgn.solve(*args, tgn.SolverConfig(use_imu=True,
                                                    max_iters=tsc.ITERS))
    assert np.isfinite(jc) and float(tinfo.initial_cost) > 10 * jc
    np.testing.assert_allclose(float(tinfo.final_cost), jc, rtol=1e-5)
    np.testing.assert_array_equal(tinfo.accepted.numpy(),
                                  np.asarray(info.accepted))
