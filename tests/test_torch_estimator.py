"""Port parity: the sliding-window estimator on the feature-domain
protocol of tests/test_estimator_e2e.py, at a small size (window of 6,
12 frames: filling, stereo+IMU initialization, then six steady frames
of LM, outlier rejection, marginalization and slides), both sides on
their default path (the steady state as one megastep a frame), in
float64. Per-frame positions agree within 1e-6 m, and the landmark
pools keep the same valid and outlier sets on every frame.
tests/test_torch_megastep.py holds the multi-dispatch path."""

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

torch.set_num_threads(1)   # the xdist workers share the cores

POS_ATOL = 1e-6       # m


def _run(est, frames, use_imu):
    """Per-frame outputs, (active, depth_valid) masks and removed
    outliers."""
    removed = []
    remove = est.fm.remove_outliers
    est.fm.remove_outliers = lambda bad: (
        removed.append(np.asarray(bad) & est.fm.active), remove(bad))
    outs, masks, bad = [], [], []
    for frame, imu in frames:
        removed.clear()
        outs.append(est.process_frame(frame, imu if use_imu else None))
        fm = est.fm
        masks.append(np.stack([np.asarray(fm.active),
                               np.asarray(fm.depth_valid)]))
        bad.append(np.any(removed, axis=0) if removed else None)
    return outs, masks, bad


@pytest.mark.parametrize("use_imu", [True, False])
def test_feature_domain_positions_match(use_imu):
    noise = 1.0 if use_imu else 0.0
    seq = jsim.generate_sequence(num_frames=12, imu_hz=200.0,
                                 acc_noise=0.05 * noise,
                                 gyr_noise=0.005 * noise,
                                 num_landmarks=250, seed=0)
    frames = jfs.make_frames(seq, pixel_noise=0.5)
    rig = seq.rig
    p_bc = np.stack([np.asarray(rig.p_bc),
                     np.asarray(rig.right_extrinsics()[0])])
    q_bc = np.stack([np.asarray(rig.q_bc),
                     np.asarray(rig.right_extrinsics()[1])])
    kw = dict(num_frames=6, lm_capacity=384, obs_capacity=2048,
              use_imu=use_imu)
    jest = JEstimator(JEstimatorConfig(**kw), p_bc, q_bc)
    test = TEstimator(TEstimatorConfig(dtype=torch.float64, **kw), p_bc,
                      q_bc, device="cpu")
    v0 = np.asarray(jsim.state_at(seq.frame_times[0])[2])
    for est in (jest, test):
        est.set_initial_pose(np.asarray(seq.gt_p[0]),
                             np.asarray(seq.gt_q[0]), v0)
    oj, mj, bj = _run(jest, frames, use_imu)
    ot, mt, bt = _run(test, frames, use_imu)
    assert jest.cfg.use_megastep and test.cfg.use_megastep
    assert test.initialized and jest.initialized
    assert not test.failed and not jest.failed
    pj = np.stack([o.p for o in oj])
    pt = np.stack([o.p for o in ot])
    np.testing.assert_allclose(pt, pj, rtol=0, atol=POS_ATOL)
    for k, (a, b) in enumerate(zip(mj, mt)):
        np.testing.assert_array_equal(b, a, err_msg=f"frame {k}")
    for k, (a, b) in enumerate(zip(bj, bt)):
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=f"frame {k}")
    for o_j, o_t in zip(oj, ot):
        assert o_t.timestamp == o_j.timestamp
        np.testing.assert_allclose(o_t.q, o_j.q, rtol=0, atol=1e-6)
    # the window the next frame would build on
    np.testing.assert_allclose(test.state.p, np.asarray(jest.state.p),
                               rtol=0, atol=POS_ATOL)
    np.testing.assert_array_equal(test.fm.active, np.asarray(jest.fm.active))
    gt = np.asarray(seq.gt_p)
    assert jfs.ate_rmse(pt, gt) < (0.06 if use_imu else 0.15)
