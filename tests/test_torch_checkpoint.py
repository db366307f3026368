"""Port parity: estimator checkpoints and the loop correction, against
the JAX package, in float64 on the stereo+IMU feature-domain protocol of
tests/test_checkpoint.py (window of 6, 12 frames):
  * a checkpoint crosses between the packages in both directions (the
    same `.npz` keys): the loaded estimator continues within 1e-6 m of
    the package that wrote it;
  * `apply_loop_correction` on the same state moves the window, the
    marginal prior's linearization point and the fast-prediction anchor
    equally (1e-10), and the next frames agree within 1e-6 m."""

import numpy as np
import pytest
import torch

from dynamic_vins_tpu_torch.geometry import lie_np
from test_torch_estimator_extras import KW, _close, _pair, _world, make

torch.set_num_threads(1)   # the xdist workers share the cores


@pytest.fixture(scope="module")
def ckpt_world(tmp_path_factory):
    """12 frames; both packages run uninterrupted, each also saves a
    checkpoint after frame 7 (index)."""
    seq, frames, p_bc, q_bc = _world(12)
    jest, test = _pair(seq, p_bc, q_bc)
    d = tmp_path_factory.mktemp("ckpt")
    outs = {"jax": [], "torch": []}
    for k, (frame, imu) in enumerate(frames):
        outs["jax"].append(jest.process_frame(frame, imu))
        outs["torch"].append(test.process_frame(frame, imu))
        if k == 7:
            jest.save_checkpoint(str(d / "jax.npz"))
            test.save_checkpoint(str(d / "torch.npz"))
    return seq, frames, p_bc, q_bc, outs, d


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_packages(ckpt_world, writer):
    seq, frames, p_bc, q_bc, outs, d = ckpt_world
    reader = make("torch" if writer == "jax" else "jax", seq, p_bc, q_bc)
    reader.load_checkpoint(str(d / f"{writer}.npz"))
    assert reader.initialized and reader.frame_count == KW["num_frames"] - 1
    resumed = [reader.process_frame(f, imu) for f, imu in frames[8:]]
    for a, b in zip(outs[writer][8:], resumed):
        assert a.timestamp == b.timestamp
        _close(a.p, b.p)
        _close(a.v, b.v)
    # the keys are the same on both sides
    assert sorted(np.load(str(d / "jax.npz")).files) == \
        sorted(np.load(str(d / "torch.npz")).files)


def test_loop_correction_matches(ckpt_world):
    seq, frames, p_bc, q_bc, _, d = ckpt_world
    jest, test = _pair(seq, p_bc, q_bc)
    for est in (jest, test):
        est.load_checkpoint(str(d / "jax.npz"))
    anchor = dict(t=float(seq.frame_times[7]), p=np.array(jest.state.p[-1]),
                  q=np.array(jest.state.q[-1]), v=np.array(jest.state.v[-1]),
                  ba=np.zeros(3), bg=np.zeros(3), acc=np.array([0, 0, 9.81]),
                  gyr=np.zeros(3))
    jest._latest = {k: np.copy(v) for k, v in anchor.items()}
    test._latest = {k: np.copy(v) for k, v in anchor.items()}
    p_vio, q_vio = np.array(jest.state.p[2]), np.array(jest.state.q[2])
    yaw = 0.05
    q_yaw = np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])
    p_corr = p_vio + np.array([0.3, -0.2, 0.05])
    q_corr = lie_np.quat_multiply(q_yaw, q_vio)
    assert jest.apply_loop_correction(p_vio, q_vio, p_corr, q_corr) == []
    assert test.apply_loop_correction(p_vio, q_vio, p_corr, q_corr) == []
    for k in ("p", "q", "v"):
        _close(getattr(jest.state, k), getattr(test.state, k), atol=1e-10)
        _close(getattr(jest.prior.lin_state, k),
               getattr(test.prior.lin_state, k).numpy(), atol=1e-10)
        _close(jest._latest[k], test._latest[k], atol=1e-10)
    # pitch and roll stay; the corrected instant lands on p_corr
    _close(test.state.p[2], p_corr, atol=1e-10)
    for (f, imu) in frames[8:11]:
        _close(jest.process_frame(f, imu).p, test.process_frame(f, imu).p)
