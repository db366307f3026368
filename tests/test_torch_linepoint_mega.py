"""Port parity of LinePoint mode on the estimator's megastep (the
steady state as one step a frame, the line sections in the step's
buffers) against JAX's megastep, on tests/linepoint_scene.py's protocol
(11 frames, window 6: 5 steady frames, both branches): per-frame
positions within 1e-6 m, the same line ids, active and orth_valid sets
every frame, orth within 1e-6 (float64)."""

import numpy as np
import pytest
import torch

import linepoint_scene as scene

torch.set_num_threads(1)   # the xdist workers share the cores

FRAMES = 11


@pytest.fixture(scope="module")
def runs():
    sc = scene.scene(FRAMES)
    return {name: scene.run(sc, port)
            for name, port in (("jax", False), ("torch", True))}


def test_megastep_matches_jax(runs):
    ej, oj, sj = runs["jax"]
    et, ot, st = runs["torch"]
    assert not et.failed and et.cfg.use_megastep
    # every steady frame was one megastep (eager on the CPU: the
    # StepGraph counts no replays, so count the steps' branches)
    assert et._mega_io is not None and et._mega_io.n == FRAMES - 6
    assert [o.timestamp for o in ot] == [o.timestamp for o in oj]
    np.testing.assert_allclose(np.stack([o.p for o in ot]),
                               np.stack([o.p for o in oj]), rtol=0,
                               atol=1e-6)
    scene.assert_lines_match(st, sj, atol=1e-6)
    assert et.lines.orth_valid.sum() >= 5
