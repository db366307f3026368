"""Port parity for the whole slice on its other paths, on the scenario
and with the helpers of tests/test_torch_system.py (376x240, window of
4, 8 frames, 10 Hz, RANSAC-F off), against the JAX System:

  * both on the multi-dispatch estimator path (`use_megastep = False`);
  * both pipelined (`VioConfig.pipelined`): the frontend runs two frames
    ahead and the estimator keeps its steady state on the device, so a
    call returns an earlier frame's output (with that frame's
    timestamp) or None, and `drain` returns the rest.

Per-frame positions within 1e-3 m, equal tracked slot sets, the same
calls return the same timestamps.
"""

import pytest
import torch
from test_torch_system import _check_outputs, _run_pair

torch.set_num_threads(1)   # the xdist workers share the cores


@pytest.mark.parametrize("path", ["multi_dispatch", "pipelined"])
def test_raw_system_paths_match_jax(tmp_path, path):
    """The multi-dispatch path on both sides; both Systems pipelined,
    whose calls return the frame of 2 (frontend) + 2 (estimator) calls
    back once the window is full."""
    pipelined = path == "pipelined"
    oj, ot, _, seq = _run_pair(tmp_path, use_megastep=pipelined,
                               pipelined=pipelined)
    if pipelined:
        assert sum(o is None for o in ot[0]) > 2 and len(ot[1]) >= 2
    else:
        assert all(o is not None for o in ot[0])
    _check_outputs(tmp_path, oj, ot, seq)
