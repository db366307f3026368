"""Port parity: the pipelined System with loop closure and live
correction against the JAX pipelined System, on the lap of
tests/test_torch_loop_system.py (its helpers and gates). A correction
drains the pipelined estimator's frames in flight; they are written to
the trajectory in order, and every frame's output appears once. The
run is 34 frames, 3 more than the megastep's: the pipelined output lags
its input by 4 frames.
"""

import pytest
import torch

from test_torch_loop_system import LAP, check_pair, run_pair

torch.set_num_threads(1)   # the xdist workers share the cores

# the pipelined System outputs frame k on call k + 4 once steady: frame
# 28's correction lands on call 32, one more frame follows, the drain
# finishes the last 4
FRAMES = LAP + 6


@pytest.mark.parametrize("path", ["pipelined"])
def test_loop_system_matches_jax(tmp_path, path):
    res, frames = run_pair(tmp_path, FRAMES, pipelined=True)
    check_pair(tmp_path, res, frames)
