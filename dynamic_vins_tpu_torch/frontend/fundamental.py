"""Epipolar outlier rejection: OpenCV's FM_RANSAC, step by step, in numpy.

Reproduces `cv2.findFundamentalMat(p_prev, p_cur, FM_RANSAC, threshold,
confidence)` (the classic `RANSACPointSetRegistrator` with the FM
callback, n >= 15), which the JAX tracker calls, so that the same points
give the same inlier mask. The registrator's loop (cv::RNG, getSubset,
the walk, RANSACUpdateNumIters) is `frontend/ransac.py`; the FM
callback is here:
  * the points are rounded to float32, as OpenCV converts them;
  * `checkSubset` (`haveCollinearPoints`): a subset whose 7th point of
    either set is collinear with two earlier ones is drawn anew;
  * `run7Point`: Hartley-normalized 7x9 system, its 2-D null space, the
    cubic det(a F1 + (1 - a) F2) = 0 (`solveCubic`), 1-3 models, each
    de-normalized and scaled to F[2,2] = 1;
  * each model scored by OpenCV's per-point error (the larger squared
    point-to-epipolar-line distance, rounded to float32).
"""

from __future__ import annotations

import math

import numpy as np

from dynamic_vins_tpu_torch.frontend import ransac

_FLT_EPS = float(np.finfo(np.float32).eps)
_DBL_EPS = float(np.finfo(np.float64).eps)
MODEL_POINTS = 7
MIN_POINTS = 15       # below this OpenCV runs LMeDS, not RANSAC


def _collinear(p) -> bool:
    """`haveCollinearPoints` on a [7,2] float32 sample: is the last point
    on a line through two earlier ones (or too close to them)?"""
    i = len(p) - 1
    for j in range(i):
        dx1 = float(p[j, 0] - p[i, 0])       # float32 differences
        dy1 = float(p[j, 1] - p[i, 1])
        for k in range(j):
            dx2 = float(p[k, 0] - p[i, 0])
            dy2 = float(p[k, 1] - p[i, 1])
            if abs(dx2 * dy1 - dy2 * dx1) <= _FLT_EPS * (
                    abs(dx1) + abs(dy1) + abs(dx2) + abs(dy2)):
                return True
    return False


def _solve_cubic(c0, c1, c2, c3):
    """`cv::solveCubic` on c0 x^3 + c1 x^2 + c2 x + c3 -> list of roots
    (none also for the zero polynomial), with C's IEEE semantics: NaN
    or inf where the formulas leave their domain."""
    with np.errstate(all="ignore"):
        return _cubic_roots(*map(np.float64, (c0, c1, c2, c3)))


def _cubic_roots(a0, a1, a2, a3):
    if a0 == 0:
        if a1 == 0:
            return [-a3 / a2] if a2 != 0 else []
        d = a2 * a2 - 4 * a1 * a3
        if not d >= 0:
            return []
        d = np.sqrt(d)
        q1 = (-a2 + d) * 0.5
        q2 = (a2 + d) * -0.5
        x0, x1 = (q1 / a1, a3 / q1) if abs(q1) > abs(q2) else \
            (q2 / a1, a3 / q2)
        return [x0, x1] if d > 0 else [x0]
    a0 = 1.0 / a0
    a1 *= a0
    a2 *= a0
    a3 *= a0
    Q = (a1 * a1 - 3 * a2) * (1.0 / 9)
    R = (a1 * (2 * a1 * a1 - 9 * a2) + 27 * a3) * (1.0 / 54)
    Qcubed = Q * Q * Q
    d = (a1 * a1 * (a2 * a2 - 4 * a1 * a3) + 2 * a2 * (
        9 * a1 * a3 - 2 * a2 * a2) - 27 * a3 * a3) * (1.0 / 108)
    if d > 0:
        theta = np.arccos(R / np.sqrt(Qcubed))
        t0 = -2 * np.sqrt(Q)
        t1 = theta * (1.0 / 3)
        t2 = a1 * (1.0 / 3)
        return [t0 * np.cos(t1) - t2,
                t0 * np.cos(t1 + (2.0 * np.pi / 3)) - t2,
                t0 * np.cos(t1 + (4.0 * np.pi / 3)) - t2]
    if d == 0:
        if R >= 0:
            x0 = -2 * np.power(R, 1.0 / 3) - a1 / 3
            x1 = np.power(R, 1.0 / 3) - a1 / 3
        else:
            x0 = 2 * np.power(-R, 1.0 / 3) - a1 / 3
            x1 = -np.power(-R, 1.0 / 3) - a1 / 3
        return [x0] if x0 == x1 else [x0, x1]
    d = np.sqrt(-d)
    e = np.power(d + abs(R), 1.0 / 3)
    if R > 0:
        e = -e
    return [(e + Q / e) - a1 * (1.0 / 3)]


def _normalize7(m):
    """run7Point's centroid and scale of [K,7,2] float64 points, summed
    in OpenCV's order -> (c [K,2], s [K]) or s = 0 where degenerate."""
    t = 1.0 / MODEL_POINTS
    c = m[:, 0]
    for i in range(1, MODEL_POINTS):
        c = c + m[:, i]
    c = c * t
    d = m - c[:, None]
    r = np.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    s = r[:, 0]
    for i in range(1, MODEL_POINTS):
        s = s + r[:, i]
    s = s * t
    ok = s >= _FLT_EPS
    return c, np.where(ok, math.sqrt(2.0) / np.where(ok, s, 1.0), 0.0)


def seven_point(m1, m2):
    """`run7Point` for [K,7,2] samples -> list of K lists of 3x3 models."""
    m1 = np.asarray(m1, np.float64)
    m2 = np.asarray(m2, np.float64)
    m1c, s1 = _normalize7(m1)
    m2c, s2 = _normalize7(m2)
    x0 = (m1[..., 0] - m1c[:, None, 0]) * s1[:, None]
    y0 = (m1[..., 1] - m1c[:, None, 1]) * s1[:, None]
    x1 = (m2[..., 0] - m2c[:, None, 0]) * s2[:, None]
    y1 = (m2[..., 1] - m2c[:, None, 1]) * s2[:, None]
    A = np.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                  np.ones_like(x0)], axis=-1)
    Vt = np.linalg.svd(A, full_matrices=True)[2]
    out = []
    for k in range(m1.shape[0]):
        if s1[k] == 0.0 or s2[k] == 0.0:
            out.append([])
            continue
        f2 = Vt[k, 8].tolist()
        f1 = [a - b for a, b in zip(Vt[k, 7].tolist(), f2)]
        t0 = f2[4] * f2[8] - f2[5] * f2[7]
        t1 = f2[3] * f2[8] - f2[5] * f2[6]
        t2 = f2[3] * f2[7] - f2[4] * f2[6]
        c3 = f2[0] * t0 - f2[1] * t1 + f2[2] * t2
        c2 = (f1[0] * t0 - f1[1] * t1 + f1[2] * t2
              - f1[3] * (f2[1] * f2[8] - f2[2] * f2[7])
              + f1[4] * (f2[0] * f2[8] - f2[2] * f2[6])
              - f1[5] * (f2[0] * f2[7] - f2[1] * f2[6])
              + f1[6] * (f2[1] * f2[5] - f2[2] * f2[4])
              - f1[7] * (f2[0] * f2[5] - f2[2] * f2[3])
              + f1[8] * (f2[0] * f2[4] - f2[1] * f2[3]))
        t0 = f1[4] * f1[8] - f1[5] * f1[7]
        t1 = f1[3] * f1[8] - f1[5] * f1[6]
        t2 = f1[3] * f1[7] - f1[4] * f1[6]
        c1 = (f2[0] * t0 - f2[1] * t1 + f2[2] * t2
              - f2[3] * (f1[1] * f1[8] - f1[2] * f1[7])
              + f2[4] * (f1[0] * f1[8] - f1[2] * f1[6])
              - f2[5] * (f1[0] * f1[7] - f1[1] * f1[6])
              + f2[6] * (f1[1] * f1[5] - f1[2] * f1[4])
              - f2[7] * (f1[0] * f1[5] - f1[2] * f1[3])
              + f2[8] * (f1[0] * f1[4] - f1[1] * f1[3]))
        c0 = f1[0] * t0 - f1[1] * t1 + f1[2] * t2
        T1 = np.array([[s1[k], 0.0, -s1[k] * m1c[k, 0]],
                       [0.0, s1[k], -s1[k] * m1c[k, 1]], [0.0, 0.0, 1.0]])
        T2 = np.array([[s2[k], 0.0, -s2[k] * m2c[k, 0]],
                       [0.0, s2[k], -s2[k] * m2c[k, 1]], [0.0, 0.0, 1.0]])
        models = []
        for r in _solve_cubic(c0, c1, c2, c3):
            r = float(r)
            lam, mu = r, 1.0
            s = f1[8] * r + f2[8]
            f = np.empty(9)
            if abs(s) > _DBL_EPS:
                mu = 1.0 / s
                lam *= mu
                f[8] = 1.0
            else:
                f[8] = 0.0
            f[:8] = np.array(f1[:8]) * lam + np.array(f2[:8]) * mu
            F = (T2.T @ f.reshape(3, 3)) @ T1
            if abs(F[2, 2]) > _FLT_EPS:
                F = F * (1.0 / F[2, 2])
            models.append(F)
        out.append(models)
    return out


def epipolar_error(F, p1, p2):
    """OpenCV's FM error for models F [K,3,3] on pairs [n,2] -> [K,n]
    float32 (computed in float64, rounded once)."""
    f = F.reshape(-1, 9)[:, :, None]
    x1, y1 = p1[None, :, 0], p1[None, :, 1]
    x2, y2 = p2[None, :, 0], p2[None, :, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        a = f[:, 0] * x1 + f[:, 1] * y1 + f[:, 2]
        b = f[:, 3] * x1 + f[:, 4] * y1 + f[:, 5]
        c = f[:, 6] * x1 + f[:, 7] * y1 + f[:, 8]
        s2 = 1.0 / (a * a + b * b)
        d2 = x2 * a + y2 * b + c
        a = f[:, 0] * x2 + f[:, 3] * y2 + f[:, 6]
        b = f[:, 1] * x2 + f[:, 4] * y2 + f[:, 7]
        c = f[:, 2] * x2 + f[:, 5] * y2 + f[:, 8]
        s1 = 1.0 / (a * a + b * b)
        d1 = x1 * a + y1 * b + c
        return np.maximum(d1 * d1 * s1, d2 * d2 * s2).astype(np.float32)


def ransac_fundamental(p1, p2, threshold: float = 1.0,
                       confidence: float = 0.99, max_iters: int = 1000):
    """Inlier mask [n] bool of OpenCV's FM_RANSAC on these pairs, or None
    when n < 15 (OpenCV then runs LMeDS) or no model was found."""
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)
    n = p1.shape[0]
    if n < MIN_POINTS:
        return None
    q1, q2 = p1.astype(np.float64), p2.astype(np.float64)
    mask, _ = ransac.ransac(
        n, MODEL_POINTS, lambda idx: seven_point(q1[idx], q2[idx]),
        lambda F: epipolar_error(F, q1, q2), threshold, confidence,
        max_iters,
        check=lambda idx: not (_collinear(p1[idx]) or _collinear(p2[idx])))
    return mask
