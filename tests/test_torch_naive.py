"""Port parity for NAIVE mode: the mask-gated background tracker.

  * `corners.detect` with `allow_mask` (candidates only inside the
    mask): the same corners, scores and found flags as the JAX
    package's, on a rendered frame;
  * the tracker's mask variant: tracked points that land on masked-out
    pixels are dropped and new corners come only from allowed pixels;
    the same slots and ids every frame, points within 1e-3 px (float32
    LK sums in other orders), no point on a masked-out pixel;
  * the NAIVE System on the scenario of tests/test_system.py:75 (the
    left half of the image marked dynamic), driven over the rendered
    frames of tests/test_torch_system.py (376x240, window 4, 8 frames):
    positions within 1e-3 m, equal valid sets every frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.frontend import corners as jcorners
from dynamic_vins_tpu.frontend.tracker import FeatureTracker as JTracker
from dynamic_vins_tpu.frontend.tracker import TrackerConfig as JConfig
from dynamic_vins_tpu.geometry.camera import PinholeIntrinsics as JIntr
from dynamic_vins_tpu.sim import frontend_sim as jfs
from dynamic_vins_tpu.sim import render, synthetic as sim
from dynamic_vins_tpu.system import FrameInput as JFrameInput
from dynamic_vins_tpu.system import System as JSystem
from dynamic_vins_tpu.utils.config import SlamMode as JSlamMode
from dynamic_vins_tpu_torch.frontend import corners as tcorners
from dynamic_vins_tpu_torch.frontend.tracker import FeatureTracker as TTracker
from dynamic_vins_tpu_torch.frontend.tracker import TrackerConfig as TConfig
from dynamic_vins_tpu_torch.geometry.camera import PinholeIntrinsics as TIntr
from dynamic_vins_tpu_torch.system import FrameInput as TFrameInput
from dynamic_vins_tpu_torch.system import System as TSystem
from dynamic_vins_tpu_torch.utils.config import SlamMode as TSlamMode
from test_torch_system import _configs

torch.set_num_threads(1)   # the xdist workers share the cores

PX_ATOL = 1e-3
POS_ATOL = 1e-3      # m
FRAMES = 8


@pytest.fixture(scope="module")
def scene():
    """The rendered frames of tests/test_torch_system.py (10 Hz)."""
    rig = render.small_rig(0.5, jnp.float64)
    seq = sim.generate_sequence(num_frames=FRAMES, imu_hz=200.0,
                                num_landmarks=200, seed=4)._replace(rig=rig)
    inten = render.make_intensities(200, seed=4)
    draw = jax.jit(lambda p, q, c: render.render_frame(
        rig, p, q, seq.landmarks, inten, cam=c), static_argnums=2)
    imgs = [(np.asarray(draw(seq.gt_p[k], seq.gt_q[k], 0)),
             np.asarray(draw(seq.gt_p[k], seq.gt_q[k], 1)))
            for k in range(FRAMES)]
    return rig, seq, imgs


def _left_half_dynamic(rig):
    dyn = np.zeros((rig.height, rig.width), bool)
    dyn[:, : rig.width // 2] = True
    return dyn


def test_corners_allow_mask_match(scene):
    rig, _, imgs = scene
    img = imgs[0][0].astype(np.float32)
    allow = np.zeros(img.shape, bool)
    allow[30:150, 60:200] = True
    allow[180:230, 250:370] = True
    rng = np.random.default_rng(3)
    ex = rng.uniform([0, 0], [rig.width, rig.height], (20, 2))
    ex_valid = rng.uniform(size=20) < 0.7
    J, T = jnp.asarray, torch.tensor
    kw = dict(max_corners=60, min_dist=8, border=2)
    pj, sj, fj = jcorners.detect(J(img), exclude_pts=J(ex, jnp.float32),
                                 exclude_valid=J(ex_valid),
                                 allow_mask=J(allow), **kw)
    pt, st, ft = tcorners.detect(T(img), exclude_pts=T(ex).float(),
                                 exclude_valid=T(ex_valid),
                                 allow_mask=T(allow), **kw)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    found = np.asarray(fj)
    assert 10 < found.sum() < 60
    np.testing.assert_array_equal(pt.numpy()[found], np.asarray(pj)[found])
    np.testing.assert_allclose(st.numpy()[found], np.asarray(sj)[found],
                               rtol=1e-5)
    xy = pt.numpy()[found].astype(int)
    assert allow[xy[:, 1], xy[:, 0]].all()


def test_tracker_mask_variant_matches(scene):
    rig, seq, imgs = scene
    intr = [float(v) for v in (rig.intr.fx, rig.intr.fy, rig.intr.cx,
                               rig.intr.cy)]
    jt = JTracker(JConfig(max_cnt=80, min_dist=10, stereo=True),
                  JIntr.make(*intr, dtype=jnp.float32))
    tt = TTracker(TConfig(max_cnt=80, min_dist=10, stereo=True),
                  TIntr.make(*intr), device="cpu")
    jt.cfg.use_ransac_f = tt.cfg.use_ransac_f = False
    H, W = rig.height, rig.width
    for k, (il, ir) in enumerate(imgs[:5]):
        # a moving masked-out band: tracked points that enter it drop
        mask = np.ones((H, W), bool)
        mask[:, 40 + 25 * k: 140 + 25 * k] = False
        t = float(seq.frame_times[k])
        fj = jt.track(il, t, mask=mask, img_right=ir)
        ft = tt.track(il, t, mask=mask, img_right=ir)
        np.testing.assert_array_equal(tt.valid, jt.valid)
        np.testing.assert_array_equal(tt.ids[tt.valid], jt.ids[jt.valid])
        np.testing.assert_allclose(tt.pts[tt.valid], jt.pts[jt.valid],
                                   rtol=0, atol=PX_ATOL)
        assert sorted(ft.features) == sorted(fj.features)
        xy = tt.pts[tt.valid].astype(int)
        assert mask[xy[:, 1], xy[:, 0]].all()
        assert tt.valid.sum() > 10


def test_naive_system_matches_jax(tmp_path, scene):
    rig, seq, imgs = scene
    jcfg, tcfg = _configs(rig)
    jcfg.slam, tcfg.slam = JSlamMode.NAIVE, TSlamMode.NAIVE
    js = JSystem(jcfg, output_prefix=str(tmp_path / "jax"))
    ts = TSystem(tcfg, output_prefix=str(tmp_path / "torch"), device="cpu")
    js.tracker.cfg.use_ransac_f = ts.tracker.cfg.use_ransac_f = False
    v0 = np.asarray(sim.state_at(seq.frame_times[0])[2])
    for s in (js, ts):
        s.estimator.set_initial_pose(np.asarray(seq.gt_p[0]),
                                     np.asarray(seq.gt_q[0]), v0)
    dyn = _left_half_dynamic(rig)
    frames_imu = jfs.make_frames(seq)
    pj, pt = [], []
    for k, (il, ir) in enumerate(imgs):
        t = float(seq.frame_times[k])
        _, imu = frames_imu[k]
        pj.append(js.process(JFrameInput(t, il, ir, imu=imu,
                                         dynamic_mask=dyn)).p)
        pt.append(ts.process(TFrameInput(t, il, ir, imu=imu,
                                         dynamic_mask=dyn)).p)
        np.testing.assert_array_equal(ts.tracker.valid, js.tracker.valid)
        pts = ts.tracker.pts[ts.tracker.valid]
        assert (pts[:, 0] >= rig.width // 2 - 1).all()
    assert ts.estimator.initialized and not ts.estimator.failed
    np.testing.assert_allclose(np.stack(pt), np.stack(pj), rtol=0,
                               atol=POS_ATOL)
    js.close()
    ts.close()
