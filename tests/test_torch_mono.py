"""Port parity: the mono+IMU estimator (initialization by the
essential matrix's relative pose, SfM over the window, the gyro bias
from the SfM rotations and the linear gravity / velocity / scale
alignment; then the steady state) against the JAX package's, on
`frontend_sim` mono frames with 0.5 px of pixel noise and IMU noise, in
float64 (window of 6, 13 frames). Both initialize on the same frame,
per-frame positions agree within 1e-6 m and the landmark pools keep the
same valid and outlier sets every frame, on the megastep and on the
multi-dispatch path. The essential matrix is the JAX side's
`cv2.findEssentialMat`, hence `cv2`."""

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

pytest.importorskip("cv2")
torch.set_num_threads(1)   # the xdist workers share the cores

POS_ATOL = 1e-6       # m
FRAMES = 13
KW = dict(num_frames=6, lm_capacity=256, obs_capacity=1024, stereo=False)


def mono_world(frames=FRAMES):
    """(sequence, mono frames, p_bc, q_bc) of the JAX simulator."""
    seq = jsim.generate_sequence(num_frames=frames, imu_hz=200.0,
                                 acc_noise=0.02, gyr_noise=0.002,
                                 num_landmarks=250, seed=0)
    fr = jfs.make_frames(seq, pixel_noise=0.5, stereo=False, seed=0)
    rig = seq.rig
    p_bc = np.stack([np.asarray(rig.p_bc),
                     np.asarray(rig.right_extrinsics()[0])])
    q_bc = np.stack([np.asarray(rig.q_bc),
                     np.asarray(rig.right_extrinsics()[1])])
    return seq, fr, p_bc, q_bc


def run(est, frames):
    """Per-frame (outputs, initialized, (active, depth_valid) masks,
    removed outliers)."""
    removed = []
    remove = est.fm.remove_outliers
    est.fm.remove_outliers = lambda bad: (
        removed.append(np.asarray(bad) & est.fm.active), remove(bad))
    outs, inits, masks, bad = [], [], [], []
    for frame, imu in frames:
        removed.clear()
        outs.append(est.process_frame(frame, imu))
        inits.append(est.initialized)
        masks.append(np.stack([np.asarray(est.fm.active),
                               np.asarray(est.fm.depth_valid)]))
        bad.append(np.any(removed, axis=0) if removed else None)
    return outs, inits, masks, bad


def assert_same_runs(rj, rt):
    (oj, ij, mj, bj), (ot, it, mt, bt) = rj, rt
    assert it == ij
    assert any(it)
    for k, (a, b) in enumerate(zip(mj, mt)):
        np.testing.assert_array_equal(b, a, err_msg=f"frame {k}")
    for k, (a, b) in enumerate(zip(bj, bt)):
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=f"frame {k}")
    pj = np.stack([o.p for o in oj])
    pt = np.stack([o.p for o in ot])
    np.testing.assert_allclose(pt, pj, rtol=0, atol=POS_ATOL)
    for o_j, o_t in zip(oj, ot):
        assert o_t.timestamp == o_j.timestamp
        np.testing.assert_allclose(o_t.q, o_j.q, rtol=0, atol=1e-6)
        np.testing.assert_allclose(o_t.v, o_j.v, rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_megastep", [True, False])
def test_mono_estimator_matches_jax(use_megastep):
    seq, frames, p_bc, q_bc = mono_world()
    kw = dict(KW, use_megastep=use_megastep)
    jest = JEstimator(JEstimatorConfig(**kw), p_bc, q_bc)
    test = TEstimator(TEstimatorConfig(dtype=torch.float64, **kw), p_bc,
                      q_bc, device="cpu")
    rj, rt = run(jest, frames), run(test, frames)
    assert not test.failed and not jest.failed
    init = rt[1].index(True)
    assert 4 <= init < FRAMES - 5, init
    assert_same_runs(rj, rt)
    # the window the next frame builds on
    np.testing.assert_allclose(test.state.p, np.asarray(jest.state.p),
                               rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(test.state.bg, np.asarray(jest.state.bg),
                               rtol=0, atol=1e-8)
