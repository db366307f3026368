"""Port parity: the RAW feature tracker on rendered stereo frames, and the
port's RANSAC-F against OpenCV's.

Both trackers run their CPU LK form (the Scharr/gather level) with
RANSAC-F off, so the slots are decided by the image math alone: the
same valid slots and ids on every frame, points within 1e-3 px (float32
LK sums in other orders). The port's RANSAC-F reproduces OpenCV's
FM_RANSAC (its RNG, 7-point samples and iteration count): its inlier
mask must equal that of `cv2.findFundamentalMat(FM_RANSAC, 1 px, 0.99)`
exactly, on sets of 15-150 pairs with 0-40% outliers and on
near-degenerate sets (cv2 is a test-only dependency; those tests skip
without it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.frontend.tracker import FeatureTracker as JTracker
from dynamic_vins_tpu.frontend.tracker import TrackerConfig as JConfig
from dynamic_vins_tpu.geometry.camera import PinholeIntrinsics as JIntr
from dynamic_vins_tpu.sim import render, synthetic as sim
from dynamic_vins_tpu_torch.frontend import fundamental
from dynamic_vins_tpu_torch.frontend.tracker import FeatureTracker as TTracker
from dynamic_vins_tpu_torch.frontend.tracker import TrackerConfig as TConfig
from dynamic_vins_tpu_torch.geometry.camera import PinholeIntrinsics as TIntr

torch.set_num_threads(1)   # the xdist workers share the cores

PX_ATOL = 1e-3


def _frames(n=4):
    rig = render.small_rig(0.5, jnp.float64)
    seq = sim.generate_sequence(num_frames=n, imu_hz=200.0,
                                num_landmarks=200, seed=4)
    inten = render.make_intensities(200, seed=4)
    draw = jax.jit(lambda p, q, c: render.render_frame(
        rig, p, q, seq.landmarks, inten, cam=c), static_argnums=2)
    return rig, seq, [(np.asarray(draw(seq.gt_p[k], seq.gt_q[k], 0)),
                       np.asarray(draw(seq.gt_p[k], seq.gt_q[k], 1)))
                      for k in range(n)]


def test_tracker_matches_jax_on_rendered_frames():
    rig, seq, frames = _frames()
    intr = [float(v) for v in (rig.intr.fx, rig.intr.fy, rig.intr.cx,
                               rig.intr.cy)]
    jt = JTracker(JConfig(max_cnt=80, min_dist=10, stereo=True),
                  JIntr.make(*intr, dtype=jnp.float32))
    tt = TTracker(TConfig(max_cnt=80, min_dist=10, stereo=True),
                  TIntr.make(*intr), device="cpu")
    jt.cfg.use_ransac_f = False
    tt.cfg.use_ransac_f = False
    assert tt._tracker.backend == "xla"
    for k, (il, ir) in enumerate(frames):
        t = float(seq.frame_times[k])
        fj = jt.track(il, t, img_right=ir)
        ft = tt.track(il, t, img_right=ir)
        np.testing.assert_array_equal(tt.valid, jt.valid)
        np.testing.assert_array_equal(tt.ids[tt.valid], jt.ids[jt.valid])
        np.testing.assert_array_equal(tt.track_cnt, jt.track_cnt)
        np.testing.assert_allclose(tt.pts[tt.valid], jt.pts[jt.valid],
                                   rtol=0, atol=PX_ATOL)
        assert sorted(ft.features) == sorted(fj.features)
        for fid, (pl, vl, pr, _) in fj.features.items():
            tl, tv, tr, _ = ft.features[fid]
            f = float(rig.intr.fx)
            np.testing.assert_allclose(tl, pl, rtol=0, atol=PX_ATOL / f)
            # velocities divide by the 0.1 s frame interval
            np.testing.assert_allclose(tv, vl, rtol=0, atol=20 * PX_ATOL / f)
            assert (tr is None) == (pr is None)
            if pr is not None:
                np.testing.assert_allclose(tr, pr, rtol=0, atol=PX_ATOL / f)
    assert tt.valid.sum() > 30


def _epipolar_pairs(seed, n=120, outliers=0.15, noise=0.1):
    """Two views of random points (pixels at f = 460) with `noise` px
    noise and a fraction of gross outliers."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                  rng.uniform(4, 15, n)], -1)
    a = rng.normal(scale=0.05, size=3)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R = np.eye(3) + np.sin(0.1) * K + (1 - np.cos(0.1)) * K @ K
    t = np.array([0.3, 0.05, 0.1])
    X2 = X @ R.T + t
    p1 = 460.0 * X[:, :2] / X[:, 2:] + rng.normal(scale=noise, size=(n, 2))
    p2 = 460.0 * X2[:, :2] / X2[:, 2:] + rng.normal(scale=noise,
                                                     size=(n, 2))
    bad = rng.uniform(size=n) < outliers
    p2[bad] += rng.uniform(5, 25, size=(bad.sum(), 2)) * rng.choice(
        [-1, 1], size=(bad.sum(), 2))
    return p1, p2


def _degenerate_pairs(seed, kind, n=60):
    """Near-degenerate views: a planar scene (kind 0), a baseline of
    0.1 mm (1), half the points of view 1 on one line (2), every third
    pair a copy of the first (3)."""
    rng = np.random.default_rng(seed)
    z = np.full(n, 8.0) if kind == 0 else rng.uniform(4, 15, n)
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), z], -1)
    X2 = X + (np.array([1e-4, 0, 0]) if kind == 1
              else np.array([0.3, 0.05, 0.1]))
    p1 = 460.0 * X[:, :2] / X[:, 2:] + rng.normal(scale=0.1, size=(n, 2))
    p2 = 460.0 * X2[:, :2] / X2[:, 2:] + rng.normal(scale=0.1, size=(n, 2))
    if kind == 2:
        p1[: n // 2, 1] = 3.0 + 0.5 * p1[: n // 2, 0]
    if kind == 3:
        p1[::3], p2[::3] = p1[0], p2[0]
    return p1, p2


# (seed, n, outlier share) and the near-degenerate kinds
_RANSAC_CASES = [(0, 15, 0.0), (1, 20, 0.1), (2, 30, 0.0), (3, 40, 0.2),
                 (4, 60, 0.15), (5, 80, 0.3), (6, 100, 0.4), (7, 120, 0.15),
                 (8, 150, 0.25), (9, 150, 0.0), (10, 50, 0.4),
                 (11, 16, 0.25)] + [("degenerate", k) for k in range(4)]


@pytest.mark.parametrize("case", _RANSAC_CASES, ids=str)
def test_ransac_f_agrees_with_opencv(case):
    cv2 = pytest.importorskip("cv2")
    p1, p2 = _degenerate_pairs(17, case[1]) if case[0] == "degenerate" \
        else _epipolar_pairs(case[0], n=case[1], outliers=case[2])
    _, mask = cv2.findFundamentalMat(p1.astype(np.float32),
                                     p2.astype(np.float32), cv2.FM_RANSAC,
                                     1.0, 0.99)
    ours = fundamental.ransac_fundamental(p1, p2, 1.0, 0.99)
    np.testing.assert_array_equal(ours, mask.ravel().astype(bool))
    # the sampler starts afresh on every call, as OpenCV's
    np.testing.assert_array_equal(fundamental.ransac_fundamental(p1, p2),
                                  ours)


def test_ransac_f_small_sets_and_exact_data():
    rng = np.random.default_rng(0)
    for n in (7, 14):     # OpenCV runs LMeDS below 15 pairs
        assert fundamental.ransac_fundamental(rng.uniform(size=(n, 2)),
                                              rng.uniform(size=(n, 2))) is None
    # 7-pair samples of noiseless views: one of each sample's 1-3 models
    # is the true F, which all other pairs satisfy too
    p1, p2 = _epipolar_pairs(5, n=60, outliers=0.0, noise=0.0)
    idx = np.arange(56).reshape(8, 7)
    for models in fundamental.seven_point(p1[idx], p2[idx]):
        assert 1 <= len(models) <= 3
        err = fundamental.epipolar_error(np.stack(models), p1, p2)
        assert np.sqrt(err.max(axis=1)).min() < 1e-3
    assert fundamental.ransac_fundamental(p1, p2).all()
