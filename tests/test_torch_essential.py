"""Port parity: the essential matrix's five-point RANSAC and
`recoverPose` of `estimator/essential.py` against OpenCV, and
`solve_relative_pose` against the JAX package's (which calls OpenCV).

On 20 two-view cases (15 to 300 pairs, 0 to 1 px of noise, 0 to 30%
outliers, the threshold the initializer uses, 0.3 px at a focal length
of 460) the inlier mask equals `cv2.findEssentialMat`'s exactly.
`recover_pose` on OpenCV's E equals `cv2.recoverPose` (count and mask
exact, R and t within 1e-9). The whole relative pose agrees in its count
exactly and in R and t within 1e-6: OpenCV's E itself satisfies the
essential constraints only to ~1e-11 (the port's to ~1e-16), which an
ill-conditioned sample amplifies to ~1e-8 in R and t. The None cases
(fewer than 15 pairs, fewer than 12 pairs in front) equal JAX's."""

import numpy as np
import pytest
import torch

from dynamic_vins_tpu.estimator import initializer as jini
from dynamic_vins_tpu_torch.estimator import essential as tes

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)   # the xdist workers share the cores

THRESH = 0.3 / 460.0
CASES = 20


def two_view(seed):
    """Normalized pairs [n,2] of a random scene seen from two poses, with
    the case's pixel noise and outliers (drawn from the seed)."""
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(15, 301))
    noise = float(rng.choice([0.0, 0.3, 0.5, 1.0]))
    outl = float(rng.choice([0.0, 0.1, 0.2, 0.3]))
    rng = np.random.default_rng(seed)
    X = np.c_[rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
              rng.uniform(4, 20, n)]
    ang = rng.normal(scale=0.1, size=3)
    th = np.linalg.norm(ang)
    k = ang / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    t = rng.normal(size=3) * np.array([1, 0.3, 0.5]) * rng.uniform(0.2, 1)
    Xc = X @ R.T + t
    x1 = X[:, :2] / X[:, 2:] + rng.normal(scale=noise / 460, size=(n, 2))
    x2 = Xc[:, :2] / Xc[:, 2:] + rng.normal(scale=noise / 460, size=(n, 2))
    m = int(outl * n)
    if m:
        idx = rng.choice(n, m, replace=False)
        x2[idx] += rng.normal(scale=0.05, size=(m, 2))
    return x1, x2


def _cv_essential(p1, p2):
    return cv2.findEssentialMat(p1, p2, focal=1.0, pp=(0.0, 0.0),
                                method=cv2.RANSAC, prob=0.999,
                                threshold=THRESH)


@pytest.mark.parametrize("seed", range(CASES))
def test_mask_and_pose_equal_opencv(seed):
    p1, p2 = two_view(seed)
    E_cv, m_cv = _cv_essential(p1, p2)
    E, mask = tes.find_essential(p1, p2, THRESH)
    assert E_cv is not None and E is not None
    np.testing.assert_array_equal(mask, m_cv.ravel().astype(bool))
    # recoverPose alone, on OpenCV's E and mask
    n_cv, R_cv, t_cv, pm_cv = cv2.recoverPose(
        E_cv, p1, p2, focal=1.0, pp=(0.0, 0.0), mask=m_cv.copy())
    n, R, t, pm = tes.recover_pose(E_cv, p1, p2, mask=m_cv.ravel())
    assert n == n_cv
    np.testing.assert_array_equal(pm, pm_cv.ravel().astype(bool))
    np.testing.assert_allclose(R, R_cv, rtol=0, atol=1e-9)
    np.testing.assert_allclose(t, t_cv.ravel(), rtol=0, atol=1e-9)
    # the whole chain, each side on its own E
    n2, R2, t2, _ = tes.recover_pose(E, p1, p2, mask=mask)
    assert n2 == n_cv
    if n_cv >= 12:           # the poses solve_relative_pose returns
        np.testing.assert_allclose(R2, R_cv, rtol=0, atol=1e-6)
        np.testing.assert_allclose(t2, t_cv.ravel(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", range(0, CASES, 4))
def test_relative_pose_equals_jax(seed):
    p1, p2 = two_view(seed)
    rj = jini.solve_relative_pose(p1, p2)
    rt = tes.solve_relative_pose(p1, p2)
    assert (rj is None) == (rt is None)
    if rj is not None:
        assert rt[2] == rj[2]
        np.testing.assert_allclose(rt[0], rj[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(rt[1], rj[1], rtol=0, atol=1e-6)


def test_none_cases_equal_jax():
    p1, p2 = two_view(3)
    # fewer than 15 pairs
    assert jini.solve_relative_pose(p1[:14], p2[:14]) is None
    assert tes.solve_relative_pose(p1[:14], p2[:14]) is None
    # no geometry: a model fits a handful of pairs, fewer than 12 in front
    rng = np.random.default_rng(5)
    q1, q2 = rng.uniform(-0.5, 0.5, (40, 2)), rng.uniform(-0.5, 0.5, (40, 2))
    assert jini.solve_relative_pose(q1, q2) is None
    assert tes.solve_relative_pose(q1, q2) is None
    assert tes.find_essential(q1[:4], q2[:4], THRESH) == (None, None)
