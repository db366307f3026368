"""Port parity: the estimator's entry points beside `process_frame`,
against the JAX package's, in float64 on the stereo+IMU feature-domain
protocol (window of 6):
  * `fast_predict` from the same anchor gives the same IMU-rate
    sequence within 1e-10 (a sample not newer than the last gives
    None), and between frames, interleaved with `process_frame` (whose
    re-anchoring replays the newer samples), within 1e-6 m;
  * `reset` gives a fresh estimator with the same calibration;
  * `change_sensor_type` in the sequence of
    tests/test_estimator_e2e.py::test_change_sensor_type: positions
    within 1e-6 m, the prior dropped with the IMU, a restart with it.
The checkpoints and the loop correction are in
tests/test_torch_checkpoint.py."""

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
from dynamic_vins_tpu_torch.utils.precision import default_dtype

torch.set_num_threads(1)   # the xdist workers share the cores

POS_ATOL = 1e-6
KW = dict(num_frames=6, lm_capacity=256, obs_capacity=1024)


def _world(frames, seed=1, noise=0.4, imu_hz=200.0):
    seq = jsim.generate_sequence(num_frames=frames, imu_hz=imu_hz,
                                 acc_noise=0.02, gyr_noise=0.002,
                                 num_landmarks=150, seed=seed)
    fr = jfs.make_frames(seq, pixel_noise=noise, seed=seed)
    rig = seq.rig
    p_bc = np.stack([np.asarray(rig.p_bc),
                     np.asarray(rig.right_extrinsics()[0])])
    q_bc = np.stack([np.asarray(rig.q_bc),
                     np.asarray(rig.right_extrinsics()[1])])
    return seq, fr, p_bc, q_bc


def make(side, seq, p_bc, q_bc, **kw):
    """A JAX ("jax") or port ("torch") estimator anchored at the truth."""
    kw = dict(KW, **kw)
    est = JEstimator(JEstimatorConfig(**kw), p_bc, q_bc) if side == "jax" \
        else TEstimator(TEstimatorConfig(dtype=torch.float64, **kw), p_bc,
                        q_bc, device="cpu")
    est.set_initial_pose(np.asarray(seq.gt_p[0]), np.asarray(seq.gt_q[0]),
                         np.asarray(jsim.state_at(seq.frame_times[0])[2]))
    return est


def _pair(seq, p_bc, q_bc, **kw):
    return (make("jax", seq, p_bc, q_bc, **kw),
            make("torch", seq, p_bc, q_bc, **kw))


def _close(a, b, atol=POS_ATOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0,
                               atol=atol)


def test_default_dtype_follows_device():
    assert default_dtype("cuda") == torch.float32
    assert default_dtype(torch.device("cuda", 0)) == torch.float32
    assert default_dtype("cpu") == torch.float64
    est = TEstimator(TEstimatorConfig(num_frames=4), p_bc := np.zeros((2, 3)),
                     np.tile([1.0, 0, 0, 0], (2, 1)), device="cpu")
    assert est.dtype == torch.float64 and est.state.p.dtype == np.float64
    est = TEstimator(TEstimatorConfig(num_frames=4, dtype=torch.float32),
                     p_bc, np.tile([1.0, 0, 0, 0], (2, 1)), device="cpu")
    assert est.dtype == torch.float32 and est.state.p.dtype == np.float32
    assert est.prior.jacobian.dtype == torch.float32


def test_fast_predict_matches():
    seq, frames, p_bc, q_bc = _world(10, seed=2, imu_hz=100.0)
    jest, test = _pair(seq, p_bc, q_bc)
    # before any frame: no anchor
    assert jest.fast_predict(0.01, np.zeros(3), np.zeros(3)) is None
    assert test.fast_predict(0.01, np.zeros(3), np.zeros(3)) is None
    n_fast, fed = 0, -np.inf
    for k, (frame, imu) in enumerate(frames):
        oj = jest.process_frame(frame, imu)
        ot = test.process_frame(frame, imu)
        _close(oj.p, ot.p)
        assert (jest._latest is None) == (test._latest is None)
        if jest._latest is None or k + 1 >= len(frames):
            continue
        for key in ("p", "q", "v"):
            _close(jest._latest[key], test._latest[key])
        # the IMU stream up to two samples past the next frame arrives
        # before that frame: its re-anchoring replays those two
        samples = []
        t = float(seq.frame_times[k])
        for acc, gyr, dts in [frames[j][1] for j in (k + 1, k + 2)
                              if j < len(frames)]:
            for i in range(len(dts)):
                t += float(dts[i])
                samples.append((t, acc[i + 1], gyr[i + 1]))
        for t_i, a, g in samples[:len(frames[k + 1][1][2]) + 2]:
            if t_i <= fed:
                continue
            fed = t_i
            fj = jest.fast_predict(t_i, a, g)
            ft = test.fast_predict(t_i, a, g)
            assert fj is not None and ft is not None
            n_fast += 1
            _close(fj.p, ft.p)
            _close(fj.q, ft.q)
            assert ft.timestamp == fj.timestamp
        # an out-of-order sample changes nothing
        t_k = float(seq.frame_times[k])
        assert jest.fast_predict(t_k, a, g) is None
        assert test.fast_predict(t_k, a, g) is None
        assert [s[0] for s in test._fast_buf] == \
            [s[0] for s in jest._fast_buf]
    assert n_fast > 20

    # from the same anchor the sequences agree to rounding
    L = {k: np.array(v) if isinstance(v, np.ndarray) else v
         for k, v in jest._latest.items()}
    test._latest = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                    for k, v in L.items()}
    acc, gyr, dts = frames[-1][1]
    t = L["t"]
    for i in range(len(dts)):
        t += float(dts[i])
        fj = jest.fast_predict(t, acc[i + 1], gyr[i + 1])
        ft = test.fast_predict(t, acc[i + 1], gyr[i + 1])
        for a, b in ((fj.p, ft.p), (fj.q, ft.q), (fj.v, ft.v)):
            _close(a, b, atol=1e-10)


def test_reset_restarts():
    seq, frames, p_bc, q_bc = _world(8)
    test = make("torch", seq, p_bc, q_bc)
    first = [test.process_frame(f, imu).p for f, imu in frames[:3]]
    for f, imu in frames[3:]:
        test.process_frame(f, imu)
    timer = test.timer = object()
    assert test.initialized
    test.reset()
    assert not test.initialized and test.frame_count == 0
    assert test.timer is timer and not bool(test.prior.valid)
    assert not test.fm.active.any() and test._latest is None
    np.testing.assert_array_equal(test.state.p_bc, p_bc)
    np.testing.assert_array_equal(test.state.q_bc, q_bc)
    test.set_initial_pose(np.asarray(seq.gt_p[0]), np.asarray(seq.gt_q[0]),
                          np.asarray(jsim.state_at(seq.frame_times[0])[2]))
    again = [test.process_frame(f, imu).p for f, imu in frames[:3]]
    _close(first, again, atol=0)


def test_change_sensor_type_matches():
    seq, frames, p_bc, q_bc = _world(14, seed=0, noise=0.3)
    jest, test = _pair(seq, p_bc, q_bc)
    for est in (jest, test):
        # both off refused
        assert not est.change_sensor_type(False, False)
        assert est.cfg.use_imu and est.cfg.stereo
    for i, (frame, imu) in enumerate(frames[:11]):
        if i == 8:
            # stereo -> mono mid-run: right obs stop being ingested
            assert jest.change_sensor_type(True, False)
            assert test.change_sensor_type(True, False)
        oj, ot = jest.process_frame(frame, imu), test.process_frame(frame,
                                                                   imu)
        _close(oj.p, ot.p)
        if i >= 8:
            k = min(test.frame_count, KW["num_frames"] - 1)
            assert not test.fm.has_right[:, k].any()
            np.testing.assert_array_equal(test.fm.has_right,
                                          np.asarray(jest.fm.has_right))
    assert test.initialized and not test.failed
    # IMU off: prior dropped, visual-only from the next frame
    graph = test._mega
    assert jest.change_sensor_type(False, True)
    assert test.change_sensor_type(False, True)
    assert not bool(test.prior.valid) and test._mega is not graph
    for frame, imu in frames[11:13]:
        _close(jest.process_frame(frame, None).p,
               test.process_frame(frame, None).p)
    # IMU back on: a restart
    assert jest.change_sensor_type(True, True)
    assert test.change_sensor_type(True, True)
    assert test.frame_count == 0 and not test.initialized
    assert test.cfg.use_imu and test.cfg.stereo
