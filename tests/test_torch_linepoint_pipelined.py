"""Port parity of LinePoint mode on the pipelined steady state (the
line orth table and alive mask resident on the device, lifecycle deltas
and the device's line outlier gate) against JAX's pipelined estimator,
on tests/linepoint_scene.py's protocol (11 frames, window 6): the same
outputs in order once drained, positions within 1e-6 m, the same line
ids, active and orth_valid sets every frame, orth within 1e-6
(float64)."""

import numpy as np
import pytest
import torch

import linepoint_scene as scene

torch.set_num_threads(1)   # the xdist workers share the cores

FRAMES = 11


@pytest.fixture(scope="module")
def runs():
    sc = scene.scene(FRAMES)
    out = {}
    for name, port in (("jax", False), ("torch", True)):
        est, outs, snaps = scene.run(sc, port, pipelined=True)
        out[name] = (est, outs + est.flush(), snaps)
    out["times"] = [float(t) for t in sc["seq"].frame_times]
    return out


def test_pipelined_matches_jax(runs):
    ej, oj, sj = runs["jax"]
    et, ot, st = runs["torch"]
    assert not et.failed and et.cfg.pipelined
    assert [o.timestamp for o in ot] == runs["times"]
    assert [o.timestamp for o in oj] == runs["times"]
    np.testing.assert_allclose(np.stack([o.p for o in ot]),
                               np.stack([o.p for o in oj]), rtol=0,
                               atol=1e-6)
    scene.assert_lines_match(st, sj, atol=1e-6)
    assert et.lines.orth_valid.sum() >= 5
    # the device residents hold the lines
    orth, alive = et._pipe_res.lines
    assert orth.shape == (48, 4) and alive.dtype == torch.bool
