"""Port parity for the DYNAMIC slice: the System in `slam=dynamic` on a
rendered dynamic scene (376x240, one moving textured box over the
static landmarks, its instance mask, disparity and 3D detection),
against the JAX System on the same frames, on the megastep path and on
the multi-dispatch path.

Window of 5 (6 frames), 9 frames at 10 Hz, RANSAC-F off, both sides'
trackers (background and instance) in float64. In float32 the trackers
sum their LK patches in other orders and part by ~1e-4 px; the object
LM amplifies that: on this scene its 6th iteration of frame 8 turns an
input difference of 9e-5 into 4e-2 m/s of velocity, on the port's own
solver fed the JAX side's inputs and its own (the solver alone agrees
with JAX's to 1e-8 on equal inputs, tests/test_torch_object_solver.py).
The object solves of the JAX package land when their fetch thread has
finished
(`InstanceManager._drain_ready` polls `AsyncFetch.ready`), so its
object states depend on thread timing; the port applies each solve at
the first read after its dispatch. Inside this test, `AsyncFetch.ready`
joins the fetch thread and returns True, which gives the JAX side the
same schedule; no file of the JAX package changes.

Per-frame ego positions within 1e-3 m; equal tracked slots, ids and
object bookkeeping every frame; equal MOT rows (frame, track id,
class), their numbers within 1e-3; the instance states after
`get_instance_states` within 1e-3 (JAX's with `sync=True`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.frontend import instance_tracker as jit_
from dynamic_vins_tpu.frontend import tracker as jtr
from dynamic_vins_tpu.sim import dynamic_scene as jdyn
from dynamic_vins_tpu.sim import frontend_sim as jfs
from dynamic_vins_tpu.sim import render, synthetic as sim
from dynamic_vins_tpu.system import FrameInput as JFrameInput
from dynamic_vins_tpu.system import System as JSystem
from dynamic_vins_tpu.utils import prefetch
from dynamic_vins_tpu.utils.config import SlamMode as JSlamMode
from dynamic_vins_tpu_torch.frontend import instance_tracker as tit
from dynamic_vins_tpu_torch.frontend import tracker as ttr
from dynamic_vins_tpu_torch.io.writers import read_mot
from dynamic_vins_tpu_torch.system import FrameInput as TFrameInput
from dynamic_vins_tpu_torch.system import System as TSystem
from dynamic_vins_tpu_torch.utils.config import SlamMode as TSlamMode
from test_torch_system import _configs

torch.set_num_threads(1)   # the xdist workers share the cores

POS_ATOL = 1e-3      # m
MOT_ATOL = 1e-3
FRAMES = 9


def _landed(self):
    """AsyncFetch.ready for the parity runs: wait for the fetch."""
    self._thread.join()
    return True


def _float64_trackers(js, ts):
    """Rebuild both Systems' trackers in float64 (see the docstring)."""
    cfg = ts.cfg
    js.tracker = jtr.FeatureTracker(jtr.TrackerConfig(
        max_cnt=cfg.max_cnt, min_dist=cfg.min_dist, stereo=True,
        dtype=jnp.float64), js.intr, js.intr_r)
    ts.tracker = ttr.FeatureTracker(ttr.TrackerConfig(
        max_cnt=cfg.max_cnt, min_dist=cfg.min_dist, stereo=True,
        dtype=torch.float64), ts.intr, ts.intr_r, device="cpu")
    p_bc, q_bc = cfg.extrinsics()
    js.inst_tracker = jit_.InstanceTracker(jit_.InstanceTrackerConfig(
        max_dynamic_cnt=cfg.max_dynamic_cnt,
        min_dynamic_dist=cfg.min_dynamic_dist, dtype=jnp.float64),
        js.intr, js.baseline, p_bc[0], q_bc[0])
    ts.inst_tracker = tit.InstanceTracker(tit.InstanceTrackerConfig(
        max_dynamic_cnt=cfg.max_dynamic_cnt,
        min_dynamic_dist=cfg.min_dynamic_dist, dtype=torch.float64),
        ts.intr, ts.baseline, p_bc[0], q_bc[0], device="cpu")


@pytest.fixture(scope="module")
def scene():
    rig = render.small_rig(0.5, jnp.float64)
    seq = sim.generate_sequence(num_frames=FRAMES, imu_hz=200.0,
                                acc_noise=0.02, gyr_noise=0.002,
                                num_landmarks=220, seed=5)._replace(rig=rig)
    frames, objs = jdyn.make_dynamic_scene(seq, num_objects=1, seed=5)
    assert all(len(df.seg.masks) == 1 for df in frames)
    return rig, seq, frames, objs


@pytest.mark.parametrize("path", ["megastep", "multi_dispatch"])
def test_dynamic_system_matches_jax(tmp_path, monkeypatch, scene, path):
    monkeypatch.setattr(prefetch.AsyncFetch, "ready", _landed)
    rig, seq, frames, objs = scene
    jcfg, tcfg = _configs(rig)
    for cfg, mode in ((jcfg, JSlamMode.DYNAMIC), (tcfg, TSlamMode.DYNAMIC)):
        cfg.slam = mode
        cfg.window_size = 5
        cfg.max_cnt = 100
        cfg.mot_n_init = 2
    js = JSystem(jcfg, output_prefix=str(tmp_path / "jax"))
    ts = TSystem(tcfg, output_prefix=str(tmp_path / "torch"), device="cpu")
    _float64_trackers(js, ts)
    mega = path == "megastep"
    js.estimator.cfg.use_megastep = ts.estimator.cfg.use_megastep = mega
    js.tracker.cfg.use_ransac_f = ts.tracker.cfg.use_ransac_f = False
    v0 = np.asarray(sim.state_at(seq.frame_times[0])[2])
    for s in (js, ts):
        s.estimator.set_initial_pose(np.asarray(seq.gt_p[0]),
                                     np.asarray(seq.gt_q[0]), v0)
    frames_imu = jfs.make_frames(seq)
    pj, pt = [], []
    for k, df in enumerate(frames):
        t = float(seq.frame_times[k])
        _, imu = frames_imu[k]
        kw = dict(imu=imu, seg=df.seg, boxes3d=df.boxes3d,
                  disparity=df.disparity)
        pj.append(js.process(JFrameInput(t, df.img_left, df.img_right,
                                         **kw)).p)
        pt.append(ts.process(TFrameInput(t, df.img_left, df.img_right,
                                         **kw)).p)
        np.testing.assert_array_equal(ts.tracker.valid, js.tracker.valid)
        np.testing.assert_array_equal(ts.inst_tracker.valid,
                                      js.inst_tracker.valid)
        np.testing.assert_array_equal(ts.inst_tracker.ids,
                                      js.inst_tracker.ids)
        for name in ("active", "initialized", "is_static", "lost",
                     "frame_valid", "lm_valid"):
            np.testing.assert_array_equal(getattr(ts.estimator.im, name),
                                          getattr(js.estimator.im, name),
                                          err_msg=name)
    assert ts.estimator.initialized and not ts.estimator.failed
    assert ts.estimator.im.initialized.any()
    if mega:
        assert sum(ts.estimator._mega.replays.values()) == 0  # CPU: eager
    np.testing.assert_allclose(np.stack(pt), np.stack(pj), rtol=0,
                               atol=POS_ATOL)
    sj = js.estimator.get_instance_states(sync=True)
    st = ts.estimator.get_instance_states()
    assert sj and set(st) == set(sj)
    for tid in sj:
        for key in ("p", "q", "v", "w", "dims"):
            np.testing.assert_allclose(st[tid][key], sj[tid][key], rtol=0,
                                       atol=POS_ATOL, err_msg=key)
        assert st[tid]["is_static"] == sj[tid]["is_static"]
        assert st[tid]["cls"] == sj[tid]["cls"]
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
                                       atol=MOT_ATOL, err_msg=key)
        assert abs(a["ry"] - b["ry"]) <= MOT_ATOL
    # the ego trajectory holds with the object in view
    gt = np.asarray(seq.gt_p)
    assert jfs.ate_rmse(np.stack(pt), gt) < 0.25
