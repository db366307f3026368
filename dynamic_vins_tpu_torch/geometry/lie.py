"""Lie-group math on torch tensors.

Quaternion convention: Hamilton, stored as [w, x, y, z] (scalar first).
Rotations act as R(q) v = q * v * q^-1 (body -> world when q = q_wb).

Every function is shape-polymorphic over leading batch dimensions and
safe under `torch.func.vmap`/`jacfwd`: no in-place updates, no host
reads, small-angle branches as `torch.where` with Taylor fallbacks.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _norm(x, keepdim=False):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


# ---------------------------------------------------------------------------
# Quaternion primitives ([w, x, y, z])
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, device=None):
    # made on the device (no host copy), so a CUDA graph can capture it
    return torch.eye(4, dtype=dtype, device=device)[0]


def quat_normalize(q):
    return q / torch.clamp_min(_norm(q, keepdim=True), _EPS)


def quat_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_multiply(q1, q2):
    """Hamilton product q1 ⊗ q2."""
    w1, x1, y1, z1 = torch.unbind(q1, dim=-1)
    w2, x2, y2, z2 = torch.unbind(q2, dim=-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v."""
    w = q[..., :1]
    xyz = q[..., 1:]
    t = 2.0 * _cross(xyz, v)
    return v + w * t + _cross(xyz, t)


def quat_to_matrix(q):
    w, x, y, z = torch.unbind(q, dim=-1)
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    r = torch.stack([
        1.0 - (tyy + tzz), txy - twz, txz + twy,
        txy + twz, 1.0 - (txx + tzz), tyz - twx,
        txz - twy, tyz + twx, 1.0 - (txx + tyy),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R):
    """Rotation matrix -> quaternion [w,x,y,z], branch-free (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = torch.sqrt(torch.clamp_min(1.0 + tr, _EPS)) * 0.5
    q0 = torch.stack([qw0, (m21 - m12) / (4.0 * qw0),
                      (m02 - m20) / (4.0 * qw0),
                      (m10 - m01) / (4.0 * qw0)], dim=-1)
    qx1 = torch.sqrt(torch.clamp_min(1.0 + m00 - m11 - m22, _EPS)) * 0.5
    q1 = torch.stack([(m21 - m12) / (4.0 * qx1), qx1,
                      (m01 + m10) / (4.0 * qx1),
                      (m02 + m20) / (4.0 * qx1)], dim=-1)
    qy2 = torch.sqrt(torch.clamp_min(1.0 - m00 + m11 - m22, _EPS)) * 0.5
    q2 = torch.stack([(m02 - m20) / (4.0 * qy2),
                      (m01 + m10) / (4.0 * qy2), qy2,
                      (m12 + m21) / (4.0 * qy2)], dim=-1)
    qz3 = torch.sqrt(torch.clamp_min(1.0 - m00 - m11 + m22, _EPS)) * 0.5
    q3 = torch.stack([(m10 - m01) / (4.0 * qz3),
                      (m02 + m20) / (4.0 * qz3),
                      (m12 + m21) / (4.0 * qz3), qz3], dim=-1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0,
                    torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    sign = torch.where(q[..., :1] < 0.0, -1.0, 1.0)
    return quat_normalize(q * sign)


def quat_from_small_angle(theta):
    """First-order quaternion for a small rotation vector (deltaQ)."""
    w = torch.ones_like(theta[..., :1])
    return quat_normalize(torch.cat([w, 0.5 * theta], dim=-1))


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(v):
    """so(3) hat operator: v -> skew-symmetric matrix."""
    x, y, z = torch.unbind(v, dim=-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def vee(M):
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def so3_exp_quat(theta):
    """Exponential map: rotation vector -> quaternion, small-angle safe."""
    angle2 = torch.sum(theta * theta, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp_min(angle2, _EPS * _EPS))
    small = angle2 < 1e-12
    half = 0.5 * angle
    k = torch.where(small, 0.5 - angle2 / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle2 / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([w, k * theta], dim=-1))


def so3_exp(theta):
    return quat_to_matrix(so3_exp_quat(theta))


def quat_log(q):
    """Logarithm map: quaternion -> rotation vector, small-angle safe."""
    q = quat_normalize(q)
    q = q * torch.where(q[..., :1] < 0.0, -1.0, 1.0)
    w = q[..., :1]
    xyz = q[..., 1:]
    n = _norm(xyz, keepdim=True)
    n2 = n * n
    small = n2 < 1e-12
    wc = torch.clamp(w, -1.0, 1.0)
    angle = 2.0 * torch.atan2(n, wc)
    k_small = 2.0 / torch.clamp_min(wc, _EPS) * (
        1.0 - n2 / (3.0 * torch.clamp_min(wc * wc, _EPS)))
    k = torch.where(small, k_small, angle / torch.clamp_min(n, _EPS))
    return k * xyz


def so3_log(R):
    return quat_log(matrix_to_quat(R))


def _taylor_coeffs(angle2):
    """(A, B, C) = sin x/x, (1-cos x)/x^2, (x - sin x)/x^3, small-safe."""
    angle = torch.sqrt(torch.clamp_min(angle2, _EPS * _EPS))
    small = angle2 < 1e-10
    A = torch.where(small, 1.0 - angle2 / 6.0, torch.sin(angle) / angle)
    B = torch.where(small, 0.5 - angle2 / 24.0,
                    (1.0 - torch.cos(angle)) / angle2)
    C = torch.where(small, 1.0 / 6.0 - angle2 / 120.0, (1.0 - A) / angle2)
    return A, B, C


def _eye3_like(K):
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_left_jacobian(theta):
    angle2 = torch.sum(theta * theta, dim=-1)[..., None, None]
    _, B, C = _taylor_coeffs(angle2)
    K = hat(theta)
    return _eye3_like(K) + B * K + C * (K @ K)


def so3_right_jacobian(theta):
    return so3_left_jacobian(theta).transpose(-1, -2)


def so3_left_jacobian_inv(theta):
    angle2 = torch.sum(theta * theta, dim=-1)[..., None, None]
    angle = torch.sqrt(torch.clamp_min(angle2, _EPS * _EPS))
    small = angle2 < 1e-10
    half = 0.5 * angle
    cot_term = torch.where(
        small, 1.0 / 12.0 + angle2 / 720.0,
        (1.0 - half * torch.cos(half)
         / torch.clamp_min(torch.sin(half), _EPS)) / angle2)
    K = hat(theta)
    return _eye3_like(K) - 0.5 * K + cot_term * (K @ K)


def so3_right_jacobian_inv(theta):
    return so3_left_jacobian_inv(theta).transpose(-1, -2)


# ---------------------------------------------------------------------------
# SE(3) as (p: [...,3], q: [...,4])
# ---------------------------------------------------------------------------

def pose_identity(dtype=torch.float32, device=None):
    return (torch.zeros(3, dtype=dtype, device=device),
            quat_identity(dtype, device))


def pose_compose(p1, q1, p2, q2):
    """T1 * T2: first apply T2, then T1."""
    return p1 + quat_rotate(q1, p2), quat_multiply(q1, q2)


def pose_inverse(p, q):
    qi = quat_conjugate(q)
    return -quat_rotate(qi, p), qi


def pose_transform_point(p, q, x):
    return quat_rotate(q, x) + p


def pose_boxplus(p, q, dx):
    """p += dp, q = q ⊗ exp(dtheta); dx: [..., 6] = [dp, dtheta]."""
    dq = so3_exp_quat(dx[..., 3:6])
    return p + dx[..., :3], quat_normalize(quat_multiply(q, dq))


def pose_boxminus(p1, q1, p0, q0):
    """Inverse of boxplus: dx with (p0,q0) ⊞ dx = (p1,q1)."""
    dtheta = quat_log(quat_multiply(quat_conjugate(q0), q1))
    return torch.cat([p1 - p0, dtheta], dim=-1)


def yaw_from_quat(q):
    R = quat_to_matrix(q)
    return torch.atan2(R[..., 1, 0], R[..., 0, 0])


def quat_from_yaw(yaw):
    half = 0.5 * yaw
    zero = torch.zeros_like(half)
    return torch.stack([torch.cos(half), zero, zero, torch.sin(half)],
                       dim=-1)


def g2R(g):
    """Rotation aligning measured gravity to +Z, yaw removed (g2R)."""
    ng1 = g / _norm(g, keepdim=True)
    ng2 = torch.eye(3, dtype=g.dtype, device=g.device)[2]
    axis = _cross(ng1, ng2)
    s = _norm(axis)
    c = torch.sum(ng1 * ng2, dim=-1)
    angle = torch.atan2(s, c)
    axis = axis / torch.clamp_min(s, _EPS)[..., None]
    R0 = so3_exp(axis * angle[..., None])
    yaw = yaw_from_quat(matrix_to_quat(R0))
    return quat_to_matrix(quat_from_yaw(-yaw)) @ R0
