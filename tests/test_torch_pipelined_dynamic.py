"""Port parity for pipelined NAIVE and DYNAMIC (`VioConfig.pipelined` with
the mask-gated and the per-object paths).

  * The estimator alone, `dynamic=True, pipelined=True`, against the JAX
    package's on the inputs of tests/test_pipelined.py:97 (feature-domain
    frames and two simulated moving objects), at a small size (window of
    6, 14 frames). The per-object pipeline runs while the step is in
    flight, with window poses matched by timestamp against the lagged
    host mirror and the frames in flight IMU-predicted. Same returns
    and lag, ego positions within 1e-6 m, equal object bookkeeping
    every frame, instance states within 1e-6 after the flush.
  * The pipelined NAIVE System (left half of the image dynamic, the
    8 rendered frames of tests/test_torch_naive.py) and the pipelined
    DYNAMIC System (one moving box, 10 frames of the scene of
    tests/test_torch_dynamic_system.py, both trackers in float64)
    against the JAX Systems: the same calls return the same frames
    (2 frontend + 2 estimator frames of lag), positions within 1e-3 m,
    equal tracked slots and ids every call; DYNAMIC: equal object
    bookkeeping, MOT rows and instance states (1e-3).

The JAX package applies an object solve when its fetch thread has
finished (`AsyncFetch.ready`); inside these tests it joins the thread
and returns True, so both sides apply each solve at the same read (the
port applies it at the first read after its dispatch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.estimator.estimator import Estimator as JEstimator
from dynamic_vins_tpu.estimator.estimator import \
    EstimatorConfig as JEstimatorConfig
from dynamic_vins_tpu.sim import dynamic_scene as jdyn
from dynamic_vins_tpu.sim import frontend_sim as jfs
from dynamic_vins_tpu.sim import objects as jobjsim
from dynamic_vins_tpu.sim import render, synthetic as jsim
from dynamic_vins_tpu.system import FrameInput as JFrameInput
from dynamic_vins_tpu.system import System as JSystem
from dynamic_vins_tpu.utils import prefetch
from dynamic_vins_tpu.utils.config import SlamMode as JSlamMode
from dynamic_vins_tpu_torch.estimator.estimator import Estimator as TEstimator
from dynamic_vins_tpu_torch.estimator.estimator import \
    EstimatorConfig as TEstimatorConfig
from dynamic_vins_tpu_torch.io.writers import read_mot
from dynamic_vins_tpu_torch.system import FrameInput as TFrameInput
from dynamic_vins_tpu_torch.system import System as TSystem
from dynamic_vins_tpu_torch.utils.config import SlamMode as TSlamMode
from test_torch_dynamic_system import _float64_trackers
from test_torch_system import _configs

torch.set_num_threads(1)   # the xdist workers share the cores

EST_ATOL = 1e-6       # m, and the instance states
POS_ATOL = 1e-3       # m, the Systems
BOOK = ("active", "initialized", "is_static", "lost", "frame_valid",
        "lm_valid")


def _landed(self):
    """AsyncFetch.ready for the parity runs: wait for the fetch."""
    self._thread.join()
    return True


def _same_objects(tm, jm):
    for name in BOOK:
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                      err_msg=name)


def _same_states(st, sj, atol):
    assert sj and set(st) == set(sj)
    for tid in sj:
        for key in ("p", "q", "v", "w", "dims"):
            np.testing.assert_allclose(st[tid][key], sj[tid][key], rtol=0,
                                       atol=atol, err_msg=key)
        assert st[tid]["is_static"] == sj[tid]["is_static"]


def test_pipelined_dynamic_estimator_matches_jax(monkeypatch):
    monkeypatch.setattr(prefetch.AsyncFetch, "ready", _landed)
    n_frames, F = 14, 6
    seq = jsim.generate_sequence(num_frames=n_frames, imu_hz=100.0,
                                 acc_noise=0.03, gyr_noise=0.003,
                                 num_landmarks=200, seed=0)
    frames = jfs.make_frames(seq, pixel_noise=0.4)
    inst_frames, truths = jobjsim.make_object_frames(seq, num_objects=2,
                                                     seed=0)
    rig = seq.rig
    p_bc = np.stack([np.asarray(rig.p_bc),
                     np.asarray(rig.right_extrinsics()[0])])
    q_bc = np.stack([np.asarray(rig.q_bc),
                     np.asarray(rig.right_extrinsics()[1])])
    kw = dict(num_frames=F, lm_capacity=256, obs_capacity=2048,
              dynamic=True, pipelined=True)
    je = JEstimator(JEstimatorConfig(**kw), p_bc, q_bc)
    te = TEstimator(TEstimatorConfig(dtype=torch.float64, **kw), p_bc, q_bc,
                    device="cpu")
    v0 = np.asarray(jsim.state_at(seq.frame_times[0])[2])
    for est in (je, te):
        est.set_initial_pose(np.asarray(seq.gt_p[0]),
                             np.asarray(seq.gt_q[0]), v0)
    oj, ot, aligned = [], [], 0
    for (frame, imu), inst in zip(frames, inst_frames):
        rj = je.process_frame(frame, imu, instances=inst)
        rt = te.process_frame(frame, imu, instances=inst)
        assert (rt is None) == (rj is None)
        if rt is not None:
            assert rt.timestamp == rj.timestamp
            oj.append(rj)
            ot.append(rt)
        _same_objects(te.im, je.im)
        if te._pipe_q:
            # the host mirror lags: its slots hold earlier timestamps
            np.testing.assert_array_equal(te._pipe_state_ts,
                                          je._pipe_state_ts)
            aligned += not np.array_equal(te._pipe_state_ts, te.timestamps)
    oj += je.flush()
    ot += te.flush()
    assert te.initialized and not te.failed and not je.failed
    assert aligned, "the mirror never lagged the host window"
    assert [o.timestamp for o in ot] == [o.timestamp for o in oj] == \
        [float(t) for t in seq.frame_times]
    np.testing.assert_allclose(np.stack([o.p for o in ot]),
                               np.stack([o.p for o in oj]), rtol=0,
                               atol=EST_ATOL)
    _same_objects(te.im, je.im)
    st, sj = te.get_instance_states(), je.get_instance_states(sync=True)
    assert te.im.initialized.any()
    _same_states(st, sj, EST_ATOL)
    assert set(st) <= {t.track_id for t in truths}


@pytest.fixture(scope="module")
def naive_scene():
    """The rendered frames of tests/test_torch_naive.py (10 Hz)."""
    rig = render.small_rig(0.5, jnp.float64)
    seq = jsim.generate_sequence(num_frames=8, imu_hz=200.0,
                                 num_landmarks=200, seed=4)._replace(rig=rig)
    inten = render.make_intensities(200, seed=4)
    draw = jax.jit(lambda p, q, c: render.render_frame(
        rig, p, q, seq.landmarks, inten, cam=c), static_argnums=2)
    imgs = [(np.asarray(draw(seq.gt_p[k], seq.gt_q[k], 0)),
             np.asarray(draw(seq.gt_p[k], seq.gt_q[k], 1)))
            for k in range(8)]
    return rig, seq, imgs


def _drive_pair(js, ts, seq, inputs):
    """Both Systems over `inputs` (FrameInput kwargs per frame); returns
    the per-call outputs (None where a call returns none) and the
    drained ones, checking equal tracked slots and ids every call."""
    v0 = np.asarray(jsim.state_at(seq.frame_times[0])[2])
    for s in (js, ts):
        s.estimator.set_initial_pose(np.asarray(seq.gt_p[0]),
                                     np.asarray(seq.gt_q[0]), v0)
    frames_imu = jfs.make_frames(seq)
    oj, ot = [], []
    for k, kw in enumerate(inputs):
        t = float(seq.frame_times[k])
        imu = frames_imu[k][1]
        oj.append(js.process(JFrameInput(t, imu=imu, **kw)))
        ot.append(ts.process(TFrameInput(t, imu=imu, **kw)))
        np.testing.assert_array_equal(ts.tracker.valid, js.tracker.valid)
        np.testing.assert_array_equal(ts.tracker.ids[ts.tracker.valid],
                                      js.tracker.ids[js.tracker.valid])
        if ts.inst_tracker is not None:
            np.testing.assert_array_equal(ts.inst_tracker.valid,
                                          js.inst_tracker.valid)
            np.testing.assert_array_equal(ts.inst_tracker.ids,
                                          js.inst_tracker.ids)
            _same_objects(ts.estimator.im, js.estimator.im)
    dj, dt = js.drain(), ts.drain()
    assert ts.estimator.initialized and not ts.estimator.failed
    # the same lag: 2 frontend frames, then 2 estimator frames in
    # flight once the window is full
    assert [o is None for o in ot] == [o is None for o in oj]
    assert sum(o is None for o in ot) > 2 and len(dt) == len(dj) > 2
    oj = [o for o in oj if o is not None] + dj
    ot = [o for o in ot if o is not None] + dt
    assert [o.timestamp for o in ot] == [o.timestamp for o in oj] == \
        [float(t) for t in seq.frame_times[:len(inputs)]]
    np.testing.assert_allclose(np.stack([o.p for o in ot]),
                               np.stack([o.p for o in oj]), rtol=0,
                               atol=POS_ATOL)
    return ot


def test_pipelined_naive_system_matches_jax(tmp_path, naive_scene):
    rig, seq, imgs = naive_scene
    jcfg, tcfg = _configs(rig)
    for cfg, mode in ((jcfg, JSlamMode.NAIVE), (tcfg, TSlamMode.NAIVE)):
        cfg.slam = mode
        cfg.pipelined = True
    js = JSystem(jcfg, output_prefix=str(tmp_path / "jax"))
    ts = TSystem(tcfg, output_prefix=str(tmp_path / "torch"), device="cpu")
    js.tracker.cfg.use_ransac_f = ts.tracker.cfg.use_ransac_f = False
    dyn = np.zeros((rig.height, rig.width), bool)
    dyn[:, : rig.width // 2] = True
    # the mask on every other frame: the all-true mask in between
    inputs = [dict(img_left=il, img_right=ir,
                   dynamic_mask=dyn if k % 2 == 0 else None)
              for k, (il, ir) in enumerate(imgs)]
    _drive_pair(js, ts, seq, inputs)
    js.close()
    ts.close()


def test_pipelined_dynamic_system_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(prefetch.AsyncFetch, "ready", _landed)
    n_frames = 10
    rig = render.small_rig(0.5, jnp.float64)
    seq = jsim.generate_sequence(num_frames=n_frames, imu_hz=200.0,
                                 acc_noise=0.02, gyr_noise=0.002,
                                 num_landmarks=220,
                                 seed=5)._replace(rig=rig)
    frames, _ = jdyn.make_dynamic_scene(seq, num_objects=1, seed=5)
    jcfg, tcfg = _configs(rig)
    for cfg, mode in ((jcfg, JSlamMode.DYNAMIC), (tcfg, TSlamMode.DYNAMIC)):
        cfg.slam = mode
        cfg.pipelined = True
        cfg.window_size = 5
        cfg.max_cnt = 100
        cfg.mot_n_init = 2
    js = JSystem(jcfg, output_prefix=str(tmp_path / "jax"))
    ts = TSystem(tcfg, output_prefix=str(tmp_path / "torch"), device="cpu")
    _float64_trackers(js, ts)
    js.tracker.cfg.use_ransac_f = ts.tracker.cfg.use_ransac_f = False
    inputs = [dict(img_left=df.img_left, img_right=df.img_right,
                   seg=df.seg, boxes3d=df.boxes3d, disparity=df.disparity)
              for df in frames]
    inputs[3]["seg"] = None          # a frame without instances
    _drive_pair(js, ts, seq, inputs)
    assert ts.estimator.im.initialized.any()
    _same_states(ts.estimator.get_instance_states(),
                 js.estimator.get_instance_states(sync=True), POS_ATOL)
    js.close()
    ts.close()
    rj = read_mot(str(tmp_path / "jax_mot.txt"))
    rt = read_mot(str(tmp_path / "torch_mot.txt"))
    assert rj and len(rt) == len(rj)
    for a, b in zip(rt, rj):
        assert (a["frame"], a["tid"], a["cls"]) == \
            (b["frame"], b["tid"], b["cls"])
        for key in ("bbox", "hwl", "xyz"):
            np.testing.assert_allclose(a[key], b[key], rtol=0,
                                       atol=POS_ATOL, err_msg=key)
        assert abs(a["ry"] - b["ry"]) <= POS_ATOL
