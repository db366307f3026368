"""Port parity: the whole System with loop closure (`use_loop_closure`,
live correction on) against the JAX System, on tests/test_loop_live.py's
scene: a circular lap around a textured landmark cloud, rendered stereo
at 376x240 with disparity from the renderer's depth, analytic IMU with
noise, keyframes on every 2nd frame, `loop_min_gap` 12, `max_cnt` 120,
`min_dist` 12, window 7.

The lap is 28 frames, not test_loop_live.py's 36 (12.9 degrees a frame
instead of 10): 31 frames of both Systems on one path take about 3.5 min
here, and a 36-frame lap would add a minute a path. 28 is close to the
shortest lap that can close: the stride and the gap put the first
keyframe allowed to query keyframe 0 on frame 26. Frame 28 revisits
frame 0 and frame 30 frame 2; both Systems accept these edges there,
solve the pose graph, re-anchor the window and rebase the keyframes.
Both Systems' feature trackers are rebuilt in float64: in float32 they
sum their LK patches in other orders and part by ~1e-4 px, which this
lap's larger motion carries to 1.04e-3 m before the loop closes (CPU
run; tests/test_torch_dynamic_system.py does the same).

Held equal: the keyframe count and the edge count after every frame
(so the frame on which each correction lands), the edges (i, j,
inliers); positions of every output (also the ones a pipelined
correction drains) within 1e-3 m, as tests/test_torch_system.py holds
the System; the rows of `_ego_tum_loop.txt` within 1e-3 m. The
megastep path here; tests/test_torch_loop_system_pipelined.py runs the
pipelined one through these helpers. Also tests/test_system.py's
loop-closure wiring test, on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.frontend import tracker as jtr
from dynamic_vins_tpu.geometry import lie as jlie
from dynamic_vins_tpu.sim import render, synthetic as sim
from dynamic_vins_tpu.sim import frontend_sim as jfs
from dynamic_vins_tpu.system import FrameInput as JFrameInput
from dynamic_vins_tpu.system import System as JSystem
from dynamic_vins_tpu.utils.config import VioConfig as JVioConfig
from dynamic_vins_tpu_torch.frontend import tracker as ttr
from dynamic_vins_tpu_torch.io.writers import read_tum
from dynamic_vins_tpu_torch.system import FrameInput as TFrameInput
from dynamic_vins_tpu_torch.system import System as TSystem
from dynamic_vins_tpu_torch.utils.config import VioConfig as TVioConfig
from test_loop_live import _circle_states, _imu_between
from test_torch_system import _configs

torch.set_num_threads(1)   # the xdist workers share the cores

POS_ATOL = 1e-3            # m
LAP = 28                   # frames a lap (test_loop_live.py: 36)
FRAMES = LAP + 3           # the megastep outputs frame k on call k
RADIUS, PERIOD, HEIGHT = 6.0, 14.0, 0.3


def _frames(n, seed=3):
    """The lap's rendered stereo frames with disparity and IMU, the rig
    and the initial state (test_loop_live.py's scene)."""
    rng = np.random.default_rng(seed)
    rig = render.small_rig(0.5, jnp.float64)
    landmarks = jnp.asarray(rng.uniform(-2.5, 2.5, size=(220, 3))
                            * np.array([1.0, 1.0, 0.8]))
    inten = render.make_intensities(220, seed=seed)
    ts, poses, _, _ = _circle_states(n, RADIUS, PERIOD, HEIGHT,
                                     frames_per_lap=LAP)
    draw = jax.jit(lambda p, q, c: render.render_frame(
        rig, p, q, landmarks, inten, cam=c), static_argnums=2)
    depth = jax.jit(lambda p, q: render.render_depth(rig, p, q, landmarks,
                                                     cam=0))
    pr, _ = rig.right_extrinsics()
    fx = float(rig.intr.fx)
    baseline = float(np.linalg.norm(np.asarray(pr) - np.asarray(rig.p_bc)))
    w = 2 * np.pi / PERIOD
    frames = []
    for k in range(n):
        p, R_wb, _ = poses[k]
        q = jnp.asarray(jlie.matrix_to_quat(jnp.asarray(R_wb)))
        dep = np.asarray(depth(jnp.asarray(p), q))
        disp = np.where(np.isfinite(dep) & (dep > 0.1),
                        fx * baseline / np.maximum(dep, 0.1), 0.0)
        imu = _imu_between(ts[k - 1], ts[k], w, RADIUS, HEIGHT, rng) \
            if k else None
        frames.append((float(ts[k]), np.asarray(draw(jnp.asarray(p), q, 0)),
                       np.asarray(draw(jnp.asarray(p), q, 1)), imu, disp))
    p0, R0, v0 = poses[0]
    q0 = np.asarray(jlie.matrix_to_quat(jnp.asarray(R0)))
    return rig, frames, (p0, q0, v0)


def _float64_trackers(js, ts):
    """Both Systems' feature trackers rebuilt in float64 (see the
    module docstring)."""
    cfg = ts.cfg
    js.tracker = jtr.FeatureTracker(jtr.TrackerConfig(
        max_cnt=cfg.max_cnt, min_dist=cfg.min_dist, stereo=True,
        dtype=jnp.float64), js.intr, js.intr_r)
    ts.tracker = ttr.FeatureTracker(ttr.TrackerConfig(
        max_cnt=cfg.max_cnt, min_dist=cfg.min_dist, stereo=True,
        dtype=torch.float64), ts.intr, ts.intr_r, device="cpu")
    ts.tracker.timer = ts.timer


def run_pair(tmp_path, n=FRAMES, pipelined=False):
    """Both Systems over the lap's first n frames: for each, the outputs
    (returned and drained), the (keyframes, edges) count after every
    frame, the keyframe count after the drain, the edges and the stage
    means."""
    rig, frames, init = _frames(n)
    jcfg, tcfg = _configs(rig)
    for cfg in (jcfg, tcfg):
        cfg.window_size = 7
        cfg.max_cnt, cfg.min_dist = 120, 12
        cfg.use_loop_closure = cfg.loop_live_correction = True
        cfg.loop_keyframe_stride, cfg.loop_min_gap = 2, 12
        cfg.pipelined = pipelined
    sides = {"jax": (JSystem(jcfg, output_prefix=str(tmp_path / "jax")),
                     JFrameInput),
             "torch": (TSystem(tcfg, output_prefix=str(tmp_path / "torch"),
                               device="cpu"), TFrameInput)}
    _float64_trackers(sides["jax"][0], sides["torch"][0])
    res = {}
    for name, (s, FI) in sides.items():
        s.estimator.set_initial_pose(*init)
        outs, counts = [], []
        for t, il, ir, imu, disp in frames:
            outs.append(s.process(FI(t, il, ir, imu=imu, disparity=disp)))
            counts.append((len(s.loop_closer.db),
                           len(s.loop_closer.edges)))
        outs += s.drain()
        res[name] = dict(outs=outs, counts=counts,
                         n_kf=len(s.loop_closer.db),
                         edges=list(s.loop_closer.edges),
                         stages=s.close(), failed=s.estimator.failed)
    return res, frames


def check_pair(tmp_path, res, frames):
    j, t = res["jax"], res["torch"]
    assert not j["failed"] and not t["failed"]
    assert t["counts"] == j["counts"] and t["n_kf"] == j["n_kf"]
    # a correction landed while the frames came in
    assert t["counts"][-1][1] >= 1
    assert len(t["edges"]) == len(j["edges"])
    for ej, et in zip(j["edges"], t["edges"]):
        assert (et.i, et.j, et.n_inliers) == (ej.i, ej.j, ej.n_inliers)
        assert et.j - et.i >= 12
    assert "loop" in t["stages"]
    # every frame's output once, in order, in the returned values and
    # in the TUM file (the frames a pipelined correction drains are
    # written, not returned)
    ref = np.loadtxt(str(tmp_path / "jax_ego_tum.txt"))
    tt, pt, _ = read_tum(str(tmp_path / "torch_ego_tum.txt"))
    np.testing.assert_array_equal(tt, ref[:, 0])
    np.testing.assert_array_equal(tt, [f[0] for f in frames])
    np.testing.assert_allclose(pt, ref[:, 1:4], rtol=0, atol=POS_ATOL)
    oj = [o for o in j["outs"] if o is not None]
    ot = [o for o in t["outs"] if o is not None]
    assert [o.timestamp for o in ot] == [o.timestamp for o in oj]
    np.testing.assert_allclose(np.stack([o.p for o in ot]),
                               np.stack([o.p for o in oj]), rtol=0,
                               atol=POS_ATOL)
    # the corrected keyframe trajectory
    loop_j = np.loadtxt(str(tmp_path / "jax_ego_tum_loop.txt"))
    lt, lp, _ = read_tum(str(tmp_path / "torch_ego_tum_loop.txt"))
    assert len(lt) == len(loop_j) == t["n_kf"]
    np.testing.assert_array_equal(lt, loop_j[:, 0])
    np.testing.assert_allclose(lp, loop_j[:, 1:4], rtol=0, atol=POS_ATOL)


@pytest.mark.parametrize("path", ["megastep"])
def test_loop_system_matches_jax(tmp_path, path):
    res, frames = run_pair(tmp_path)
    check_pair(tmp_path, res, frames)


def test_system_loop_closure_wiring(tmp_path):
    """tests/test_system.py:227 on the port: strided keyframes feed the
    ORB database through the System; close() with no edge solves
    nothing and writes no loop file."""
    rig = render.small_rig(0.5, jnp.float64)
    _, cfg = _configs(rig)
    cfg.use_loop_closure = True
    cfg.loop_keyframe_stride = 2
    seq = sim.generate_sequence(num_frames=6, imu_hz=200.0,
                                num_landmarks=200, seed=4)._replace(rig=rig)
    inten = render.make_intensities(200, seed=4)
    frames_imu = jfs.make_frames(seq)
    system = TSystem(cfg, output_prefix=str(tmp_path / "run"), device="cpu")
    assert system.loop_closer is not None
    system.estimator.set_initial_pose(
        np.asarray(seq.gt_p[0]), np.asarray(seq.gt_q[0]),
        np.asarray(sim.state_at(seq.frame_times[0])[2]))
    draw = jax.jit(lambda p, q: render.render_frame(
        rig, p, q, seq.landmarks, inten, cam=0))
    for k in range(6):
        img = np.asarray(draw(seq.gt_p[k], seq.gt_q[k]))
        system.process(TFrameInput(float(seq.frame_times[k]), img, None,
                                   imu=frames_imu[k][1]))
    assert len(system.loop_closer.db) == 3      # stride-2 keyframes
    system.close()
    assert not (tmp_path / "run_ego_tum_loop.txt").exists()
