"""Port parity: the batched instance tracker and the instance manager.

  * The instance tracker (K = 8 rows of N features, one fused step a
    frame: temporal and stereo LK at radius 8 over all rows, the masked
    corner top-up, the disparity extra points lifted to the world and
    clustered) against the JAX package's on the scenes of
    tests/test_instance_tracker.py: one textured object over two
    frames, and four objects at once with disparity: equal valid sets
    and ids, points within 1e-3 px (float32 LK sums in other orders),
    the same features per instance, extra points within 1e-4 m.
  * The instance manager over the moving-box scenario of
    tests/test_instance_manager.py:90, run per frame as the estimator
    runs it (push, propagate, initialize, triangulate, velocity,
    static test, outlier rejection, the object BA, lifecycle) in a
    window of 6 over 9 frames, so that both slides move a pending
    solve. The port starts from the JAX manager's state after frame 1
    (convert.load_instance_state). The JAX package applies a solve once
    its fetch thread has finished (`AsyncFetch.ready`); the port at the
    first read after the dispatch. Here `AsyncFetch.ready` joins the
    thread and returns True, so both apply each solve at the same read;
    no file of the JAX package changes. Object p, v and dims within
    1e-6 every frame; equal slot, static and lost bookkeeping.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.estimator.instance_manager import (
    InstanceConfig as JConfig, InstanceManager as JManager)
from dynamic_vins_tpu.frontend.instance_tracker import (
    InstanceTracker as JTracker, InstanceTrackerConfig as JTConfig)
from dynamic_vins_tpu.geometry import lie as jlie
from dynamic_vins_tpu.geometry.camera import PinholeIntrinsics as JIntr
from dynamic_vins_tpu.utils import prefetch
from dynamic_vins_tpu_torch import convert
from dynamic_vins_tpu_torch.estimator.instance_manager import (
    InstanceConfig as TConfig, InstanceManager as TManager)
from dynamic_vins_tpu_torch.frontend.instance_tracker import (
    InstanceTracker as TTracker, InstanceTrackerConfig as TTConfig)
from dynamic_vins_tpu_torch.geometry.camera import PinholeIntrinsics as TIntr
from test_instance_manager import _simulate_object_sequence
from test_instance_tracker import _object_scene

torch.set_num_threads(1)   # the xdist workers share the cores

PX_ATOL = 1e-3
STATE_ATOL = 1e-6


def _trackers(**kw):
    intr = (230.0, 230.0, 160.0, 120.0)
    jt = JTracker(JTConfig(**kw), JIntr.make(*intr, dtype=jnp.float32),
                  baseline=0.11, p_bc=np.zeros(3), q_bc=[1.0, 0, 0, 0])
    tt = TTracker(TTConfig(**kw), TIntr.make(*intr), baseline=0.11,
                  p_bc=np.zeros(3), q_bc=[1.0, 0, 0, 0], device="cpu")
    return jt, tt


def _same(jt, tt, oj, ot):
    np.testing.assert_array_equal(tt.valid, jt.valid)
    np.testing.assert_array_equal(tt.ids, jt.ids)
    np.testing.assert_allclose(tt.pts[tt.valid], jt.pts[jt.valid], rtol=0,
                               atol=PX_ATOL)
    assert tt._row_of == jt._row_of
    assert set(ot) == set(oj)
    for tid in oj:
        fj, ft = oj[tid]["features"], ot[tid]["features"]
        assert sorted(ft) == sorted(fj)
        for fid, (pl, pr) in fj.items():
            tl, tr = ft[fid]
            np.testing.assert_allclose(tl, pl, rtol=0, atol=PX_ATOL / 230)
            assert (tr is None) == (pr is None)
            if pr is not None:
                np.testing.assert_allclose(tr, pr, rtol=0,
                                           atol=PX_ATOL / 230)
        ej, et = oj[tid]["extra_pts_world"], ot[tid]["extra_pts_world"]
        assert (et is None) == (ej is None)
        if ej is not None:
            np.testing.assert_allclose(et, ej, rtol=0, atol=1e-4)


def test_instance_tracker_one_object_matches():
    jt, tt = _trackers(max_dynamic_cnt=40)
    for shift in (0, 6, 11):
        img, mask = _object_scene(shift)
        oj = jt.track(img, {3: mask}, img_right=img)
        ot = tt.track(img, {3: mask}, img_right=img)
        _same(jt, tt, oj, ot)
    assert len(ot[3]["features"]) >= 10
    # an instance that leaves: its row is freed on both sides
    jt.track(img, {}), tt.track(img, {})
    assert tt._row_of == jt._row_of == {}


def test_instance_tracker_batched_matches():
    """Four instances in one step, with disparity and an ego pose (the
    extra points), then a frame without disparity."""
    rng = np.random.default_rng(1)
    H, W = 240, 320
    jt, tt = _trackers(max_dynamic_cnt=30)

    def scene(shift):
        img = np.full((H, W), 30.0, np.float32)
        masks = {}
        for tid, (x0, y0) in enumerate([(20 + shift, 30), (150 + shift, 40),
                                        (40 + shift, 150),
                                        (200 + shift, 140)]):
            img[y0:y0 + 60, x0:x0 + 70] = rng.uniform(60, 255, (60, 70))
            m = np.zeros((H, W), bool)
            m[y0:y0 + 60, x0:x0 + 70] = True
            masks[tid] = m
        return img, masks

    disp = np.full((H, W), 5.0, np.float32)
    disp[100:, :] = 9.0              # two depths: the cluster filter
    ego = (np.array([0.3, -0.2, 0.1]),
           np.array([np.cos(0.1), 0.0, np.sin(0.1), 0.0]))
    for k, shift in enumerate((0, 5, 9)):
        img, masks = scene(shift)
        kw = dict(disparity=disp, ego_pose=ego) if k < 2 else {}
        oj = jt.track(img, masks, img_right=img, **kw)
        ot = tt.track(img, masks, img_right=img, **kw)
        _same(jt, tt, oj, ot)
        assert set(ot) == {0, 1, 2, 3}
        if k < 2:
            assert all(ot[t]["extra_pts_world"] is not None for t in ot)


def _landed(self):
    """AsyncFetch.ready for the parity runs: wait for the fetch."""
    self._thread.join()
    return True


def test_instance_manager_matches(monkeypatch):
    monkeypatch.setattr(prefetch.AsyncFetch, "ready", _landed)
    n_frames, F = 9, 6
    seq, frames, gt_p, v_obj, dims, extr, times = \
        _simulate_object_sequence(F=n_frames)
    jm = JManager(JConfig(num_frames=F, max_objects=4))
    tm = TManager(TConfig(num_frames=F, max_objects=4), device="cpu")
    cams = []
    for k in range(n_frames):
        p_cw, q_cw = np.zeros((2, 3)), np.zeros((2, 4))
        for c in range(2):
            p_wc, q_wc = jlie.pose_compose(
                seq.gt_p[k], seq.gt_q[k], jnp.asarray(extr[c][0]),
                jnp.asarray(extr[c][1]))
            pc, qc = jlie.pose_inverse(p_wc, q_wc)
            p_cw[c], q_cw[c] = np.asarray(pc), np.asarray(qc)
        cams.append((p_cw, q_cw))

    win = []                    # frame index held by each window slot
    for k in range(n_frames):
        slot = len(win)
        win.append(k)
        wt = times[win]
        pw = np.stack([cams[j][0] for j in win])
        qw = np.stack([cams[j][1] for j in win])
        if len(win) < F:        # the window is not full: pad it
            pad = F - len(win)
            wt = np.concatenate([wt, np.full(pad, wt[-1])])
            pw = np.concatenate([pw, np.repeat(pw[-1:], pad, 0)])
            qw = np.concatenate([qw, np.repeat(qw[-1:], pad, 0)])
        ego = (np.asarray(seq.gt_p[k]), np.asarray(seq.gt_q[k]))
        for im in ((jm,) if k < 2 else (jm, tm)):
            im.push_frame(slot, frames[k], *ego, extr[0][0], extr[0][1])
            im.propagate_pose(slot, wt)
            im.initialize_instances(slot)
            im.triangulate(slot, *ego, extr[0][0], extr[0][1], extr[1])
            im.init_velocity(slot, wt)
            im.classify_motion(slot, wt)
            im.reject_outliers(p_cw=pw, q_cw=qw)
            im.optimize(wt, pw, qw)
            im.manage()
        if k == 1:              # the port starts from JAX's state
            jm._sync_pending()
            d = {n: getattr(jm, n) for n in convert.INSTANCE_STATE}
            d["tid_to_slot"] = jm._tid_to_slot
            convert.load_instance_state(tm, d)
        if k >= 2:
            sj, st = jm.output(sync=True), tm.output()
            assert set(st) == set(sj) == {7}
            for key in ("p", "v", "dims", "q", "w"):
                np.testing.assert_allclose(st[7][key], sj[7][key], rtol=0,
                                           atol=STATE_ATOL, err_msg=key)
            for name in ("active", "initialized", "is_static", "static_cnt",
                         "lost", "age", "frame_valid", "lm_valid"):
                np.testing.assert_array_equal(getattr(tm, name),
                                              getattr(jm, name),
                                              err_msg=name)
            np.testing.assert_allclose(tm.p, jm.p, rtol=0, atol=STATE_ATOL)
            np.testing.assert_allclose(tm.lm, jm.lm, rtol=0,
                                       atol=STATE_ATOL)
        if len(win) == F:       # slide, keyframe and non-keyframe in turn
            # dispatch the frame's solve again, then slide with it
            # pending (the first slide comes at frame 5)
            for im in (jm, tm):
                im.optimize(wt, pw, qw)
            if k % 2:
                win.pop(0)
                for im in (jm, tm):
                    im.slide_window()
            else:
                win.pop(F - 2)
                for im in (jm, tm):
                    im.slide_window_new()
    out = tm.output()
    assert not out[7]["is_static"]
    np.testing.assert_allclose(out[7]["v"], v_obj, atol=0.3)
