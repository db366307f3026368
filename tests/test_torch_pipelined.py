"""Port parity: the pipelined, device-resident steady state
(`EstimatorConfig.pipelined`) against the JAX package's, in float64, at
a small size (window of 6, 12 frames) on two scenes of
tests/test_pipelined.py: the default trajectory, where every steady
frame is a keyframe, and a low-parallax one that forces non-keyframe
slides through the step's merged-edge branch. Both sides return the
same output timestamps in the same order, each 2 frames after its own
frame was given, and positions within 1e-6 m.

Also the fixed-size compaction that builds the obs rows on the device
(`compact_nonzero`) against `jnp.nonzero(size=, fill_value=0)`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.estimator.estimator import Estimator as JEstimator
from dynamic_vins_tpu.estimator.estimator import \
    EstimatorConfig as JEstimatorConfig
from dynamic_vins_tpu.sim import frontend_sim as jfs
from dynamic_vins_tpu.sim import synthetic as jsim
from dynamic_vins_tpu_torch.estimator.estimator import Estimator as TEstimator
from dynamic_vins_tpu_torch.estimator.estimator import \
    EstimatorConfig as TEstimatorConfig
from dynamic_vins_tpu_torch.estimator.estimator import compact_nonzero

torch.set_num_threads(1)   # the xdist workers share the cores

FRAMES = 12
WINDOW = 6
POS_ATOL = 1e-6       # m
KW = dict(num_frames=WINDOW, lm_capacity=256, obs_capacity=2048,
          pipelined=True)
SCENES = {
    # tests/test_pipelined.py:_run
    "keyframes": dict(params=None, landmarks=180, seed=0, noise=0.4),
    # tests/test_pipelined.py:test_pipelined_nonkeyframe_path
    "low_parallax": dict(params=dict(omega=0.08, z_amp=0.05, roll_amp=0.02,
                                     pitch_amp=0.02),
                         landmarks=150, seed=6, noise=0.3),
}


def _drive(est, frames):
    """Per process_frame call: the output's timestamp or None; the
    outputs in order (flush included); the branch of each dispatched
    steady frame (True: keyframe)."""
    returned, outs, branches = [], [], []
    for frame, imu in frames:
        o = est.process_frame(frame, imu)
        returned.append(None if o is None else o.timestamp)
        if o is not None:
            outs.append(o)
        q = getattr(est, "_pipe_q", None)
        if q and q[-1][1] == frame.timestamp:
            branches.append(bool(q[-1][2]))
    outs += est.flush()
    assert est.initialized and not est.failed
    return returned, outs, branches


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_runs(request):
    sc = SCENES[request.param]
    params = jsim.TrajectoryParams(**sc["params"]) if sc["params"] \
        else jsim.TrajectoryParams()
    seq = jsim.generate_sequence(num_frames=FRAMES, imu_hz=100.0,
                                 num_landmarks=sc["landmarks"],
                                 seed=sc["seed"], params=params)
    frames = jfs.make_frames(seq, pixel_noise=sc["noise"])
    rig = seq.rig
    p_bc = np.stack([np.asarray(rig.p_bc),
                     np.asarray(rig.right_extrinsics()[0])])
    q_bc = np.stack([np.asarray(rig.q_bc),
                     np.asarray(rig.right_extrinsics()[1])])
    v0 = np.asarray(jsim.state_at(seq.frame_times[0], params)[2])
    runs = {}
    for name, est in (
            ("jax", JEstimator(JEstimatorConfig(**KW), p_bc, q_bc)),
            ("torch", TEstimator(TEstimatorConfig(dtype=torch.float64, **KW),
                                 p_bc, q_bc, device="cpu"))):
        est.set_initial_pose(np.asarray(seq.gt_p[0]),
                             np.asarray(seq.gt_q[0]), v0)
        runs[name] = _drive(est, frames)
    return request.param, frames, runs


def test_pipelined_outputs_match_jax(scene_runs):
    scene, frames, runs = scene_runs
    rj, oj, bj = runs["jax"]
    rt, ot, bt = runs["torch"]
    ts = [f.timestamp for f, _ in frames]
    # the same calls return, with the same timestamps, in order
    assert rt == rj
    assert [o.timestamp for o in ot] == [o.timestamp for o in oj] == ts
    # the steady frames (from WINDOW on: frame WINDOW - 1 initializes)
    # return the output of 2 frames back
    steady = range(WINDOW, FRAMES)
    assert [rt[k] for k in steady] == [None, None] + ts[WINDOW:-2]
    assert bt == bj and len(bt) == FRAMES - WINDOW
    if scene == "low_parallax":
        assert not all(bt), "no non-keyframe slide exercised"
    else:
        assert all(bt)
    np.testing.assert_allclose(np.stack([o.p for o in ot]),
                               np.stack([o.p for o in oj]), rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(np.stack([o.q for o in ot]),
                               np.stack([o.q for o in oj]), rtol=0,
                               atol=POS_ATOL)


@pytest.mark.parametrize("density", [0.0, 0.05, 0.3, 0.7, 1.0])
def test_compact_nonzero_matches_jnp(density):
    rng = np.random.default_rng(int(100 * density))
    for n, size in ((1, 4), (97, 40), (600, 512), (2 * 160 * 5, 1024)):
        mask = rng.random(n) < density
        idx, count = compact_nonzero(torch.from_numpy(mask), size)
        ref = np.asarray(jnp.nonzero(jnp.asarray(mask), size=size,
                                     fill_value=0)[0])
        np.testing.assert_array_equal(idx.numpy(), ref)
        assert int(count) == int(mask.sum())
