"""Port parity of LinePoint mode (points + lines) in the estimator's
multi-dispatch path, on tests/test_line_e2e.py's protocol shortened to
10 frames with a window of 6 (tests/linepoint_scene.py): per-frame
positions within 1e-6 m, the same line ids, active and orth_valid sets
every frame and orth within 1e-6 (float64; the line-only refinement
and the joint LM of both packages from the same inputs). Also the loop
correction with lines from the same line table and window (1e-10: the
same host formulas).

tests/test_torch_linepoint_mega.py and _pipelined.py hold the
megastep and the pipelined paths; _system.py the System and the CLI.
"""

import numpy as np
import pytest
import torch

import linepoint_scene as scene

torch.set_num_threads(1)   # the xdist workers share the cores

FRAMES = 10


@pytest.fixture(scope="module")
def runs():
    sc = scene.scene(FRAMES)
    return {name: scene.run(sc, port, use_megastep=False)
            for name, port in (("jax", False), ("torch", True))}


def test_multi_dispatch_matches_jax(runs):
    ej, oj, sj = runs["jax"]
    et, ot, st = runs["torch"]
    assert not et.failed and et.initialized
    assert et._mega.replays == {}
    assert [o.timestamp for o in ot] == [o.timestamp for o in oj]
    np.testing.assert_allclose(np.stack([o.p for o in ot]),
                               np.stack([o.p for o in oj]), rtol=0,
                               atol=1e-6)
    scene.assert_lines_match(st, sj, atol=1e-6)
    # lines took part: triangulated and refined in the solves
    assert et.lines.orth_valid.sum() >= 5


def test_loop_correction_moves_lines(runs):
    ej, _, _ = runs["jax"]
    et, _, _ = runs["torch"]
    lm = et.lines
    valid = lm.active & lm.orth_valid
    assert valid.sum() >= 5
    # from the same line table and window (they agree to 1e-8 here)
    lm.orth[:] = ej.lines.orth
    for name in ("p", "q", "v"):
        getattr(et.state, name)[:] = np.asarray(getattr(ej.state, name))
    before = lm.orth.copy()
    p_vio = et.state.p[2].copy()
    q_vio = et.state.q[2].copy()
    yaw = 0.3
    q_corr = np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])
    from dynamic_vins_tpu_torch.geometry import lie_np

    q_corr = lie_np.quat_multiply(q_corr, q_vio)
    p_corr = p_vio + np.array([0.5, -0.2, 0.1])
    assert ej.apply_loop_correction(p_vio, q_vio, p_corr, q_corr) == []
    assert et.apply_loop_correction(p_vio, q_vio, p_corr, q_corr) == []
    np.testing.assert_allclose(lm.orth[valid], ej.lines.orth[valid],
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(et.state.p, np.asarray(ej.state.p), rtol=0,
                               atol=1e-10)
    assert np.abs(lm.orth[valid] - before[valid]).max() > 1e-3
    np.testing.assert_array_equal(lm.orth[~valid], before[~valid])
