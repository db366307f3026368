"""numpy twins of the Lie ops for host-side bookkeeping.

The estimator's per-frame host logic (slot gathering, re-anchoring,
PnP setup) works on a handful of values; these keep it on the host.
Semantics identical to geometry/lie.py.
"""

from __future__ import annotations

import numpy as np


def quat_conjugate(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def quat_multiply(q1, q2):
    w1, x1, y1, z1 = np.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q2, -1, 0)
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def quat_rotate(q, v):
    w = q[..., :1]
    xyz = q[..., 1:]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def quat_to_matrix(q):
    w, x, y, z = np.moveaxis(q, -1, 0)
    tx, ty, tz = 2 * x, 2 * y, 2 * z
    m = np.stack([
        1 - (ty * y + tz * z), tx * y - tz * w, tx * z + ty * w,
        tx * y + tz * w, 1 - (tx * x + tz * z), ty * z - tx * w,
        tx * z - ty * w, ty * z + tx * w, 1 - (tx * x + ty * y),
    ], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def pose_compose(p1, q1, p2, q2):
    return p1 + quat_rotate(q1, p2), quat_multiply(q1, q2)


def pose_inverse(p, q):
    qi = quat_conjugate(q)
    return -quat_rotate(qi, p), qi


def pose_transform_point(p, q, x):
    return quat_rotate(q, x) + p


def matrix_to_quat(R):
    """Rotation matrix -> quaternion wxyz (Shepperd's method)."""
    R = np.asarray(R, float)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def so3_log(R):
    """Rotation matrix -> axis-angle vector."""
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    if theta < 1e-8:
        return 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                               R[1, 0] - R[0, 1]])
    if abs(np.pi - theta) < 1e-6:
        A = (R + np.eye(3)) / 2.0
        i = int(np.argmax(np.diag(A)))
        axis = A[:, i] / max(np.sqrt(max(A[i, i], 1e-12)), 1e-12)
        axis /= max(np.linalg.norm(axis), 1e-12)
        return theta * axis
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                  R[1, 0] - R[0, 1]]) / (2.0 * np.sin(theta))
    return theta * w


def quat_log(q):
    """Quaternion -> rotation vector, small-angle safe (lie.quat_log)."""
    q = np.asarray(q, float)
    q = q / max(np.linalg.norm(q), 1e-8)
    if q[0] < 0.0:
        q = -q                                  # shortest arc
    w, xyz = q[0], q[1:]
    n = np.linalg.norm(xyz)
    wc = min(max(w, -1.0), 1.0)
    if n * n < 1e-12:
        k = 2.0 / max(wc, 1e-8) * (1.0 - n * n / (3.0 * max(wc * wc, 1e-8)))
    else:
        k = 2.0 * np.arctan2(n, wc) / max(n, 1e-8)
    return k * xyz
