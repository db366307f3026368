"""Port parity for the whole slice: the RAW stereo+IMU System on the
rendered scenario of tests/test_system.py (376x240, window of 4, 8
frames), images -> fused tracker -> estimator -> TUM file, against the
JAX System on the same frames.

Cameras at 10 Hz. Both sides run their default path (the estimator's
steady state as one megastep a frame) with RANSAC-F off and with it on
(the port's sampler reproduces OpenCV's FM_RANSAC, which the JAX side
calls; that case skips without `cv2`). Per-frame positions agree
within 1e-3 m and the tracked slot sets are equal: the trackers' float32
LK sums in other orders move points by ~1e-4 px, which the solves carry
into the poses. tests/test_torch_system_paths.py runs the other paths
through the helpers here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.geometry import lie as jlie
from dynamic_vins_tpu.sim import frontend_sim as jfs
from dynamic_vins_tpu.sim import render, synthetic as sim
from dynamic_vins_tpu.system import FrameInput as JFrameInput
from dynamic_vins_tpu.system import System as JSystem
from dynamic_vins_tpu.utils.config import VioConfig as JVioConfig
from dynamic_vins_tpu_torch.io.writers import read_tum
from dynamic_vins_tpu_torch.system import FrameInput as TFrameInput
from dynamic_vins_tpu_torch.system import System as TSystem
from dynamic_vins_tpu_torch.utils.config import VioConfig as TVioConfig

torch.set_num_threads(1)   # the xdist workers share the cores

POS_ATOL = 1e-3      # m
FRAMES = 8


def _configs(rig):
    T0, T1 = np.eye(4), np.eye(4)
    T0[:3, :3] = np.asarray(jlie.quat_to_matrix(rig.q_bc))
    T0[:3, 3] = np.asarray(rig.p_bc)
    pr, qr = rig.right_extrinsics()
    T1[:3, :3] = np.asarray(jlie.quat_to_matrix(qr))
    T1[:3, 3] = np.asarray(pr)
    out = []
    for cfg in (JVioConfig(), TVioConfig()):
        cfg.window_size = 4
        cfg.max_cnt = 80
        cfg.min_dist = 10
        cfg.image_width, cfg.image_height = rig.width, rig.height
        cfg.intrinsics_left = [float(rig.intr.fx), float(rig.intr.fy),
                               float(rig.intr.cx), float(rig.intr.cy)]
        cfg.body_T_cam0 = T0.reshape(-1).tolist()
        cfg.body_T_cam1 = T1.reshape(-1).tolist()
        out.append(cfg)
    return out


def _run_pair(tmp_path, ransac_f=False, use_megastep=True,
              pipelined=False):
    """Both Systems over the rendered frames: per-frame outputs (None
    where a pipelined call returns none) and the drained ones, each
    side's stage means, and the two TUM files' paths."""
    rig = render.small_rig(0.5, jnp.float64)
    seq = sim.generate_sequence(num_frames=FRAMES, imu_hz=200.0,
                                num_landmarks=200, seed=4)._replace(rig=rig)
    inten = render.make_intensities(200, seed=4)
    frames_imu = jfs.make_frames(seq)
    jcfg, tcfg = _configs(rig)
    jcfg.pipelined = tcfg.pipelined = pipelined
    js = JSystem(jcfg, output_prefix=str(tmp_path / "jax"))
    ts = TSystem(tcfg, output_prefix=str(tmp_path / "torch"), device="cpu")
    assert js.estimator.cfg.use_megastep and ts.estimator.cfg.use_megastep
    js.estimator.cfg.use_megastep = ts.estimator.cfg.use_megastep = \
        use_megastep
    assert ts.estimator.cfg.pipelined == pipelined
    js.tracker.cfg.use_ransac_f = ransac_f
    ts.tracker.cfg.use_ransac_f = ransac_f
    v0 = np.asarray(sim.state_at(seq.frame_times[0])[2])
    for s in (js, ts):
        s.estimator.set_initial_pose(np.asarray(seq.gt_p[0]),
                                     np.asarray(seq.gt_q[0]), v0)
    draw = jax.jit(lambda p, q, c: render.render_frame(
        rig, p, q, seq.landmarks, inten, cam=c), static_argnums=2)
    oj, ot = [], []
    for k in range(FRAMES):
        il = np.asarray(draw(seq.gt_p[k], seq.gt_q[k], 0))
        ir = np.asarray(draw(seq.gt_p[k], seq.gt_q[k], 1))
        t = float(seq.frame_times[k])
        _, imu = frames_imu[k]
        oj.append(js.process(JFrameInput(t, il, ir, imu=imu)))
        ot.append(ts.process(TFrameInput(t, il, ir, imu=imu)))
        np.testing.assert_array_equal(ts.tracker.valid, js.tracker.valid)
        if ot[-1] is not None:
            assert ts.tracker.valid.sum() > 20
    assert ts.estimator.initialized and not ts.estimator.failed
    dj, dt = js.drain(), ts.drain()
    stages = ts.close()
    js.close()
    return (oj, dj), (ot, dt), stages, seq


def _check_outputs(tmp_path, jax_outs, torch_outs, seq):
    """Same calls return, same timestamps, positions within POS_ATOL;
    the TUM files agree; the ATE gate."""
    (oj, dj), (ot, dt) = jax_outs, torch_outs
    assert [o is None for o in ot] == [o is None for o in oj]
    oj = [o for o in oj if o is not None] + dj
    ot = [o for o in ot if o is not None] + dt
    assert [o.timestamp for o in ot] == [o.timestamp for o in oj]
    assert [o.timestamp for o in ot] == [float(t) for t in seq.frame_times]
    pj = np.stack([o.p for o in oj])
    pt = np.stack([o.p for o in ot])
    np.testing.assert_allclose(pt, pj, rtol=0, atol=POS_ATOL)
    t, p, q = read_tum(str(tmp_path / "torch_ego_tum.txt"))
    ref = np.loadtxt(str(tmp_path / "jax_ego_tum.txt"))  # t xyz q_xyzw
    assert ref.shape == (FRAMES, 8) and p.shape == (FRAMES, 3)
    np.testing.assert_allclose(t, ref[:, 0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(p, ref[:, 1:4], rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(q, ref[:, [7, 4, 5, 6]], rtol=0, atol=1e-3)
    assert jfs.ate_rmse(pt, np.asarray(seq.gt_p)) < 0.20


@pytest.mark.parametrize("ransac_f", [False, True])
def test_raw_system_matches_jax_on_rendered_frames(tmp_path, ransac_f):
    if ransac_f:
        pytest.importorskip("cv2")
    oj, ot, stages, seq = _run_pair(tmp_path, ransac_f=ransac_f)
    assert all(o is not None for o in ot[0]) and ot[1] == []
    assert {"frontend", "backend", "output"} <= set(stages)
    _check_outputs(tmp_path, oj, ot, seq)
