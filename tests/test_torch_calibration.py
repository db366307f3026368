"""Port parity: planar calibration (Zhang's method + the batched
Gauss-Newton refinement) against the JAX package's on
tests/test_calibration.py's synthetic views, clean and noisy, float64:
fx, fy, cx, cy, dist, rms and every rvec and tvec within 1e-8; the
homography and closed-form stages exact; and that test's own gates."""

import numpy as np
import pytest
import torch

from dynamic_vins_tpu.geometry import calibration as jcal
from dynamic_vins_tpu_torch.geometry import calibration as tcal
from test_calibration import _synth_views

torch.set_num_threads(1)   # the xdist workers share the cores

ATOL = 1e-8


def _views(noisy: bool):
    if not noisy:
        return _synth_views()[0]
    views, _ = _synth_views(seed=3)
    rng = np.random.default_rng(4)
    return [(o, i + rng.normal(scale=0.1, size=i.shape)) for o, i in views]


@pytest.mark.parametrize("noisy", [False, True])
def test_calibrate_planar_matches(noisy):
    views = _views(noisy)
    j = jcal.calibrate_planar(views)
    t = tcal.calibrate_planar(views, device="cpu")
    for k in ("fx", "fy", "cx", "cy", "rms"):
        assert abs(getattr(t, k) - getattr(j, k)) < ATOL, k
    for k in ("dist", "rvecs", "tvecs"):
        np.testing.assert_allclose(getattr(t, k), np.asarray(getattr(j, k)),
                                   rtol=0, atol=ATOL, err_msg=k)
    # tests/test_calibration.py's gates
    if noisy:
        assert t.rms < 0.25
        assert abs(t.fx - 480.0) < 5.0
        assert abs(t.cy - 240.0) < 5.0
    else:
        assert t.rms < 0.05, t.rms
        for k, v in (("fx", 480.0), ("fy", 470.0), ("cx", 320.0),
                     ("cy", 240.0)):
            assert abs(getattr(t, k) - v) < 1.0, k
        np.testing.assert_allclose(t.dist, [0.05, -0.02, 0.001, -0.0005],
                                   atol=2e-3)


def test_closed_form_stages_match():
    views = _views(False)
    Hj = [jcal.homography_dlt(o, i) for o, i in views]
    Ht = [tcal.homography_dlt(o, i) for o, i in views]
    for a, b in zip(Hj, Ht):
        np.testing.assert_array_equal(b, a)
    kj = jcal.intrinsics_from_homographies(Hj)
    assert tcal.intrinsics_from_homographies(Ht) == kj
    K = np.array([[kj[0], 0, kj[2]], [0, kj[1], kj[3]], [0, 0, 1.0]])
    for H in Hj:
        Rj, tj = jcal.extrinsics_from_homography(H, K)
        Rt, tt = tcal.extrinsics_from_homography(H, K)
        np.testing.assert_array_equal(Rt, Rj)
        np.testing.assert_array_equal(tt, tj)


def test_homography_dlt_exact():
    """tests/test_calibration.py's exact-homography gate, on the port."""
    rng = np.random.default_rng(1)
    H_gt = np.array([[1.2, 0.1, 30.0], [-0.05, 0.9, 20.0],
                     [1e-4, -2e-4, 1.0]])
    obj = rng.uniform(-1, 1, (20, 2))
    ph = np.concatenate([obj, np.ones((20, 1))], axis=1)
    proj = (H_gt @ ph.T).T
    img = proj[:, :2] / proj[:, 2:3]
    np.testing.assert_allclose(tcal.homography_dlt(obj, img),
                               H_gt / H_gt[2, 2], atol=1e-8)
