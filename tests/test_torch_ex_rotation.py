"""Port parity: the camera-IMU extrinsic rotation self-calibration
(hand-eye) against the JAX package's, in float64: `calibrate_rotation`
within 1e-9 (its sign fixed to w >= 0) with the same convergence
verdict, the pair accumulator converging on the same push with the same
q_bc, and the estimator with `calibrate_extrinsic_rotation=True` (the
per-frame hook on the essential matrix's relative rotation and the gyro
delta) giving the same pairs, the same calibrated q_bc and positions
within 1e-6 m. The relative rotations come from the JAX side's
`cv2.findEssentialMat`, hence `cv2`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.estimator import ex_rotation as jexr
from dynamic_vins_tpu.estimator.estimator import Estimator as JEstimator
from dynamic_vins_tpu.estimator.estimator import \
    EstimatorConfig as JEstimatorConfig
from dynamic_vins_tpu.geometry import lie_np
from dynamic_vins_tpu.sim import frontend_sim as jfs
from dynamic_vins_tpu.sim import synthetic as jsim
from dynamic_vins_tpu_torch.estimator import ex_rotation as texr
from dynamic_vins_tpu_torch.estimator.estimator import Estimator as TEstimator
from dynamic_vins_tpu_torch.estimator.estimator import \
    EstimatorConfig as TEstimatorConfig

torch.set_num_threads(1)   # the xdist workers share the cores

ATOL = 1e-9


def _rand_quat(rng, max_angle):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(0.3 * max_angle, max_angle)
    return np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * axis])


def _pairs(seed, n, noise=0.0, outliers=0, single_axis=False):
    """(q_b, q_c, q_bc): n hand-eye pairs of a random q_bc, as
    tests/test_ex_rotation.py draws them."""
    rng = np.random.default_rng(seed)
    q_bc = _rand_quat(rng, 1.0)
    q_cb = lie_np.quat_conjugate(q_bc)
    if single_axis:
        q_b = np.stack([np.array([np.cos(a / 2), 0, 0, np.sin(a / 2)])
                        for a in rng.uniform(0.05, 0.3, n)])
    else:
        q_b = np.stack([_rand_quat(rng, 0.3) for _ in range(n)])
    q_c = np.stack([lie_np.quat_multiply(lie_np.quat_multiply(q_cb, qb),
                                         q_bc) for qb in q_b])
    if noise:
        for i in range(n):
            q_c[i] = lie_np.quat_multiply(q_c[i], _rand_quat(rng, noise))
    for i in (rng.choice(n, size=outliers, replace=False) if outliers
              else []):
        q_c[i] = _rand_quat(rng, 1.0)
    return q_b, q_c, q_bc


@pytest.mark.parametrize("case", [dict(seed=0, n=40),
                                  dict(seed=1, n=48, noise=0.01, outliers=6),
                                  dict(seed=2, n=30, single_axis=True),
                                  dict(seed=3, n=8)])
def test_calibrate_rotation_matches(case):
    q_b, q_c, _ = _pairs(**case)
    valid = np.arange(len(q_b)) < len(q_b) - 2      # two masked pairs
    qj, sj, cj = jexr.calibrate_rotation(jnp.asarray(q_b), jnp.asarray(q_c),
                                         jnp.asarray(valid))
    qt, st, ct = texr.calibrate_rotation(torch.tensor(q_b),
                                         torch.tensor(q_c),
                                         torch.tensor(valid))
    assert ct == bool(cj)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=ATOL)
    if not case.get("single_axis"):
        # one rotation about a fixed axis leaves a 2-D null space, in
        # which each SVD returns a vector of its own
        np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(texr.quat_left(torch.tensor(q_b)).numpy(),
                               np.asarray(jexr.quat_left(jnp.asarray(q_b))),
                               rtol=0, atol=0)
    np.testing.assert_allclose(texr.quat_right(torch.tensor(q_c)).numpy(),
                               np.asarray(jexr.quat_right(jnp.asarray(q_c))),
                               rtol=0, atol=0)


def test_calibrator_converges_on_the_same_push():
    q_b, q_c, q_bc = _pairs(seed=3, n=25, noise=0.005)
    cj = jexr.ExRotationCalibrator(dtype=jnp.float64)
    ct = texr.ExRotationCalibrator()
    conv_j, conv_t = [], []
    for i in range(25):
        cj.push(q_b[i], q_c[i])
        ct.push(q_b[i], q_c[i])
        qj, a = cj.solve()
        qt, b = ct.solve()
        conv_j.append(a)
        conv_t.append(b)
        if a:        # with fewer pairs the null space may be 2-D
            np.testing.assert_allclose(qt, qj, rtol=0, atol=ATOL)
    assert conv_t == conv_j and any(conv_t)
    np.testing.assert_allclose(ct.result, cj.result, rtol=0, atol=ATOL)


def test_estimator_calibration_matches():
    pytest.importorskip("cv2")
    seq = jsim.generate_sequence(num_frames=12, imu_hz=100.0,
                                 num_landmarks=120, seed=0)
    frames = jfs.make_frames(seq, pixel_noise=0.3)
    rig = seq.rig
    p_bc = np.stack([np.asarray(rig.p_bc),
                     np.asarray(rig.right_extrinsics()[0])])
    q_bc = np.stack([np.asarray(rig.q_bc),
                     np.asarray(rig.right_extrinsics()[1])])
    kw = dict(num_frames=6, lm_capacity=256, obs_capacity=1024,
              calibrate_extrinsic_rotation=True)
    jest = JEstimator(JEstimatorConfig(**kw), p_bc, q_bc)
    test = TEstimator(TEstimatorConfig(dtype=torch.float64, **kw), p_bc,
                      q_bc, device="cpu")
    v0 = np.asarray(jsim.state_at(seq.frame_times[0])[2])
    for est in (jest, test):
        est.set_initial_pose(np.asarray(seq.gt_p[0]),
                             np.asarray(seq.gt_q[0]), v0)
    for k, (frame, imu) in enumerate(frames):
        oj = jest.process_frame(frame, imu)
        ot = test.process_frame(frame, imu)
        assert test.ex_calib.n == jest.ex_calib.n, k
        np.testing.assert_allclose(test.ex_calib.q_b, jest.ex_calib.q_b,
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(test.ex_calib.q_c, jest.ex_calib.q_c,
                                   rtol=0, atol=1e-8)
        assert (test.ex_calib.result is None) == \
            (jest.ex_calib.result is None), k
        np.testing.assert_allclose(test.state.q_bc,
                                   np.asarray(jest.state.q_bc), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(ot.p, oj.p, rtol=0, atol=1e-6)
    assert test.ex_calib.n > 5
    assert not test.failed and test.initialized
