"""Port parity: the simulator. The same arguments give the JAX package's
sequence (trajectory, exact IMU plus noise, landmarks), its rendered
images and depth, its feature-domain frames, to float64 rounding, and
its dynamic scene: the same objects, masks, 3D boxes and disparity, and
uint8 images that differ by at most one grey level (the float64 images
truncate on either side of an integer)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.sim import dynamic_scene as jdyn
from dynamic_vins_tpu.sim import frontend_sim as jfs
from dynamic_vins_tpu.sim import render as jrender
from dynamic_vins_tpu.sim import synthetic as jsim
from dynamic_vins_tpu_torch.sim import dynamic_scene as tdyn
from dynamic_vins_tpu_torch.sim import frontend_sim as tfs
from dynamic_vins_tpu_torch.sim import render as trender
from dynamic_vins_tpu_torch.sim import synthetic as tsim

torch.set_num_threads(1)   # the xdist workers share the cores

TOL = 1e-10


def _seqs(**kw):
    return jsim.generate_sequence(**kw), tsim.generate_sequence(**kw)


@pytest.mark.parametrize("kw", [
    dict(num_frames=6, imu_hz=200.0, num_landmarks=50, seed=4),
    dict(num_frames=5, imu_hz=200.0, acc_noise=0.05, gyr_noise=0.005,
         acc_bias=(0.1, -0.05, 0.02), num_landmarks=40, seed=0),
])
def test_sequence_matches(kw):
    sj, st = _seqs(**kw)
    for name in ("frame_times", "gt_p", "gt_q", "gt_v", "imu_times", "acc",
                 "gyr", "landmarks"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)), rtol=0,
                                   atol=TOL, err_msg=name)
    np.testing.assert_allclose([float(v) for v in st.rig.intr[:4]],
                               [float(v) for v in sj.rig.intr[:4]], rtol=0,
                               atol=TOL)
    assert (st.rig.width, st.rig.height) == (sj.rig.width, sj.rig.height)
    pj, qj = sj.rig.right_extrinsics()
    pt, qt = st.rig.right_extrinsics()
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=TOL)


def test_rendered_images_match():
    sj, st = _seqs(num_frames=3, imu_hz=200.0, num_landmarks=120, seed=4)
    rj, rt = jrender.small_rig(0.5, jnp.float64), trender.small_rig(0.5)
    ij = jrender.make_intensities(120, seed=4)
    it = trender.make_intensities(120, seed=4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    for k in (0, 2):
        for cam in (0, 1):
            a = jrender.render_frame(rj, sj.gt_p[k], sj.gt_q[k],
                                     sj.landmarks, ij, cam=cam)
            b = trender.render_frame(rt, st.gt_p[k], st.gt_q[k],
                                     st.landmarks, it, cam=cam)
            assert b.shape == (rt.height, rt.width)
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-9)


def test_feature_frames_and_imu_intervals_match():
    sj, st = _seqs(num_frames=4, imu_hz=200.0, num_landmarks=60, seed=2)
    fj = jfs.make_frames(sj, pixel_noise=0.5, seed=3)
    ft = tfs.make_frames(st, pixel_noise=0.5, seed=3)
    intervals = tfs.imu_intervals(st)
    for (a, imu_a), (b, imu_b), imu_c in zip(fj, ft, intervals):
        assert a.timestamp == b.timestamp
        assert sorted(a.features) == sorted(b.features)
        for fid, obs in a.features.items():
            for x, y in zip(obs, b.features[fid]):
                if x is None:
                    assert y is None
                else:
                    np.testing.assert_allclose(y, x, rtol=0, atol=TOL)
        for x, y, z in zip(imu_a, imu_b, imu_c):
            np.testing.assert_allclose(y, x, rtol=0, atol=TOL)
            np.testing.assert_array_equal(z, y)
    est = np.stack([np.asarray(sj.gt_p[k]) + 0.01 for k in range(4)])
    assert tfs.ate_rmse(est, st.gt_p.numpy()) == pytest.approx(
        jfs.ate_rmse(est, np.asarray(sj.gt_p)), rel=1e-12)


def test_rendered_depth_matches():
    sj, st = _seqs(num_frames=2, imu_hz=200.0, num_landmarks=80, seed=6)
    rj, rt = jrender.small_rig(0.5, jnp.float64), trender.small_rig(0.5)
    for cam in (0, 1):
        a = np.asarray(jrender.render_depth(rj, sj.gt_p[1], sj.gt_q[1],
                                            sj.landmarks, cam=cam))
        b = trender.render_depth(rt, st.gt_p[1], st.gt_q[1], st.landmarks,
                                 cam=cam).numpy()
        np.testing.assert_array_equal(np.isfinite(b), np.isfinite(a))
        assert np.isfinite(a).sum() > 100
        np.testing.assert_allclose(b[np.isfinite(b)], a[np.isfinite(a)],
                                   rtol=0, atol=TOL)


def test_dynamic_scene_matches():
    sj, st = _seqs(num_frames=3, imu_hz=200.0, num_landmarks=100, seed=5)
    sj = sj._replace(rig=jrender.small_rig(0.5, jnp.float64))
    st = st._replace(rig=trender.small_rig(0.5))
    fj, oj = jdyn.make_dynamic_scene(sj, num_objects=2, seed=5)
    ft, ot = tdyn.make_dynamic_scene(st, num_objects=2, seed=5)
    for a, b in zip(oj, ot):
        assert a.track_id == b.track_id
        for name in ("dims_xyz", "q_wo", "gt_p", "tex_pts", "tex_inten"):
            np.testing.assert_allclose(getattr(b, name), getattr(a, name),
                                       rtol=0, atol=TOL, err_msg=name)
    for a, b in zip(fj, ft):
        assert len(a.seg.masks) == len(b.seg.masks) == 2
        np.testing.assert_array_equal(b.seg.masks, a.seg.masks)
        np.testing.assert_array_equal(b.seg.labels, a.seg.labels)
        np.testing.assert_allclose(b.disparity, a.disparity, rtol=0,
                                   atol=1e-5)
        for ba, bb in zip(a.boxes3d, b.boxes3d):
            assert bb.class_name == ba.class_name
            np.testing.assert_allclose(bb.bottom_center, ba.bottom_center,
                                       rtol=0, atol=TOL)
            np.testing.assert_allclose(bb.dims, ba.dims, rtol=0, atol=TOL)
            assert abs(bb.yaw - ba.yaw) < TOL
        for x, y in ((a.img_left, b.img_left), (a.img_right, b.img_right)):
            assert y.dtype == np.uint8
            assert np.abs(y.astype(int) - x.astype(int)).max() <= 1
