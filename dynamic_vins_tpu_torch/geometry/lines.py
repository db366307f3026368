"""3D line geometry: Plücker coordinates and the orthonormal form.

A 3D line is (n, d): n the normal of the plane through the line and the
origin (n = p x d for a point p on it), d its direction. The
orthonormal parameterization has 4 dof: psi [3], the SO(3) log of the
frame [n/|n|, d/|d|, n x d/|nd|], and phi = atan2(|d|, |n|), which
encodes the distance. Batched over leading dimensions and safe under
`torch.func` transforms (no in-place updates, no host reads).
"""

from __future__ import annotations

import torch

from dynamic_vins_tpu_torch.geometry import lie

_cross = lie._cross


def _norm(x, keepdim=True):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def plucker_from_two_points(p1, p2):
    """Line through two 3D points -> (n [.,3], d [.,3])."""
    return _cross(p1, p2), p2 - p1


def plucker_from_two_planes(pi1, pi2):
    """Line = intersection of two planes pi = (a, b, c, e)."""
    n1, e1 = pi1[..., :3], pi1[..., 3:4]
    n2, e2 = pi2[..., :3], pi2[..., 3:4]
    return e2 * n1 - e1 * n2, _cross(n1, n2)


def plane_from_point_line(p, s, e):
    """Plane through the 3 points (p, s, e) as (a, b, c, e)."""
    n = _cross(s - p, e - p)
    w = -torch.sum(n * p, dim=-1, keepdim=True)
    return torch.cat([n, w], dim=-1)


def plucker_to_orth(n, d):
    """(n, d) -> orth [.,4]."""
    nn = _norm(n)
    nd = _norm(d)
    u1 = n / torch.clamp_min(nn, 1e-12)
    u2 = d / torch.clamp_min(nd, 1e-12)
    u3 = _cross(u1, u2)
    R = torch.stack([u1, u2, u3], dim=-1)   # columns
    psi = lie.so3_log(R)
    phi = torch.atan2(nd[..., 0], nn[..., 0])
    return torch.cat([psi, phi[..., None]], dim=-1)


def orth_to_plucker(orth):
    """orth [.,4] -> (n, d) with |n| = cos(phi), |d| = sin(phi)."""
    R = lie.so3_exp(orth[..., :3])
    phi = orth[..., 3]
    return (torch.cos(phi)[..., None] * R[..., :, 0],
            torch.sin(phi)[..., None] * R[..., :, 1])


def orth_boxplus(orth, delta):
    """4-dof update: rotate the frame by delta[:3], advance phi by
    delta[3]."""
    R_new = lie.so3_exp(orth[..., :3]) @ lie.so3_exp(delta[..., :3])
    return torch.cat([lie.so3_log(R_new),
                      (orth[..., 3] + delta[..., 3])[..., None]], dim=-1)


def transform_line(n, d, p_ab, q_ab):
    """A line from frame b to frame a, T_ab = (p, q):
    n_a = R n_b + [p]x R d_b; d_a = R d_b."""
    R = lie.quat_to_matrix(q_ab)
    d_a = (R @ d[..., None])[..., 0]
    return (R @ n[..., None])[..., 0] + _cross(p_ab, d_a), d_a


def project_line(n_c):
    """Camera-frame Plücker -> normalized image line: the plane normal
    through the camera centre."""
    return n_c


def line_point_distance(l, pt):
    """Signed distance of a normalized image point [.,3] to the line l
    [.,3], normalized by sqrt(l1^2 + l2^2)."""
    denom = torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2)
    return torch.sum(l * pt, dim=-1) / torch.clamp_min(denom, 1e-12)


def triangulate_line_two_view(p_cw0, q_cw0, p_cw1, q_cw1, s0, e0, s1, e1):
    """A world line from endpoint observations in two views, through
    the two viewing planes. (p_cw, q_cw): world -> camera; s/e:
    normalized endpoints [.,3] (z = 1). Returns world (n, d)."""
    p_wc0, q_wc0 = lie.pose_inverse(p_cw0, q_cw0)
    p_wc1, q_wc1 = lie.pose_inverse(p_cw1, q_cw1)
    w = lambda p, q, x: lie.pose_transform_point(p, q, x)
    pi0 = plane_from_point_line(p_wc0, w(p_wc0, q_wc0, s0),
                                w(p_wc0, q_wc0, e0))
    pi1 = plane_from_point_line(p_wc1, w(p_wc1, q_wc1, s1),
                                w(p_wc1, q_wc1, e1))
    return plucker_from_two_planes(pi0, pi1)


def triangulate_line_multiview(p_cw, q_cw, s_obs, e_obs, valid):
    """Multi-view line fit. Each view back-projects its image line to a
    world plane through its camera centre, normal m_k = R_cw^T l_obs:
    the direction is the null vector of the stacked normals (an SVD),
    a point on the line the least-squares solution in the plane
    orthogonal to it. p_cw/q_cw [K,3]/[K,4] world -> camera, s/e [K,3],
    valid [K]. Returns (n_w [3], d_w [3], residual ratio). The
    estimator's line manager uses its host numpy copy."""
    R = lie.quat_to_matrix(q_cw)
    l_obs = _cross(s_obs, e_obs)
    l_obs = l_obs / torch.clamp_min(_norm(l_obs), 1e-12)
    m = torch.einsum("kij,ki->kj", R, l_obs) * valid[:, None]
    centers = -torch.einsum("kij,ki->kj", R, p_cw)
    _, sv, vt = torch.linalg.svd(m, full_matrices=False)
    d = vt[-1]
    ratio = sv[-1] / torch.clamp_min(sv[0], 1e-12)
    z = torch.zeros((), dtype=d.dtype, device=d.device)
    o = torch.ones((), dtype=d.dtype, device=d.device)
    tmp = torch.where(torch.abs(d[2]) < 0.9, torch.stack([z, z, o]),
                      torch.stack([o, z, z]))
    b1 = _cross(d, tmp)
    b1 = b1 / torch.clamp_min(_norm(b1, keepdim=False), 1e-12)
    b2 = _cross(d, b1)
    B = torch.stack([b1, b2], dim=1)
    A2 = m @ B
    rhs = torch.sum(m * centers, dim=-1)
    AtA = A2.T @ A2 + 1e-12 * torch.eye(2, dtype=d.dtype, device=d.device)
    y = torch.linalg.solve(AtA, A2.T @ rhs)
    return _cross(B @ y, d), d, ratio


def endpoint_trim(n_w, d_w, p_cw, q_cw, s_obs, e_obs):
    """The point of the infinite line closest to the origin,
    d x n / |d|^2 (line-length bookkeeping)."""
    d2 = torch.sum(d_w * d_w, dim=-1, keepdim=True)
    return _cross(d_w, n_w) / torch.clamp_min(d2, 1e-12)
