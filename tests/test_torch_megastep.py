"""Port parity: the estimator's multi-dispatch path, and the megastep
against it, on the feature-domain protocol of tests/test_estimator_e2e.py
at a small size (window of 8, 14 frames: 6 steady).

  * the port's multi-dispatch path (`use_megastep = False`) against
    JAX's: per-frame positions within 1e-6 m (float64);
  * the port's megastep against the port's multi-dispatch path: the
    same math in one step, positions within 5e-4 m
    (`test_megastep_matches_multidispatch`'s bound).

tests/test_torch_estimator.py holds the megastep against JAX's.
"""

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

FRAMES = 14
KW = dict(num_frames=8, lm_capacity=256, obs_capacity=2048)


@pytest.fixture(scope="module")
def runs():
    """Per-frame positions of JAX's multi-dispatch path and of the
    port's multi-dispatch and megastep paths on one scenario."""
    seq = jsim.generate_sequence(num_frames=FRAMES, imu_hz=200.0,
                                 acc_noise=0.05, gyr_noise=0.005,
                                 num_landmarks=200, seed=3)
    frames = jfs.make_frames(seq, pixel_noise=0.5, max_feats=100)
    rig = seq.rig
    p_bc = np.stack([np.asarray(rig.p_bc),
                     np.asarray(rig.right_extrinsics()[0])])
    q_bc = np.stack([np.asarray(rig.q_bc),
                     np.asarray(rig.right_extrinsics()[1])])
    v0 = np.asarray(jsim.state_at(seq.frame_times[0])[2])
    ests = {
        "jax_multi": JEstimator(JEstimatorConfig(use_megastep=False, **KW),
                                p_bc, q_bc),
        "multi": TEstimator(TEstimatorConfig(use_megastep=False, **KW),
                            p_bc, q_bc, device="cpu"),
        "mega": TEstimator(TEstimatorConfig(**KW), p_bc, q_bc,
                           device="cpu"),
    }
    out = {}
    for name, est in ests.items():
        est.set_initial_pose(np.asarray(seq.gt_p[0]),
                             np.asarray(seq.gt_q[0]), v0)
        outs = [est.process_frame(f, imu) for f, imu in frames]
        assert est.initialized and not est.failed, name
        out[name] = (np.stack([o.p for o in outs]),
                     [o.timestamp for o in outs], est)
    out["gt"] = np.asarray(seq.gt_p)
    return out


def test_multi_dispatch_matches_jax(runs):
    pj, tj, _ = runs["jax_multi"]
    pt, tt, est = runs["multi"]
    assert not est.cfg.use_megastep and est._mega.replays == {}
    assert tt == tj
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)


def test_megastep_matches_multidispatch(runs):
    pm, tm, est = runs["mega"]
    pr, tr, _ = runs["multi"]
    assert tm == tr
    np.testing.assert_allclose(pm, pr, rtol=0, atol=5e-4)
    ate = lambda p: np.sqrt(np.mean(np.sum((p - runs["gt"]) ** 2, -1)))
    assert abs(ate(pm) - ate(pr)) < 5e-4
    assert ate(pm) < 0.15     # the reference's visual-only e2e gate
