"""Triangulation, PnP and gyro-bias primitives (batched torch).

DLT triangulation (SVD of the 4x4 design matrix), fixed-iteration robust
Gauss-Newton PnP instead of OpenCV's solvePnP, and the linear gyro-bias
solve of VINS' initial alignment.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from dynamic_vins_tpu_torch.geometry import lie
from dynamic_vins_tpu_torch.utils.step_graph import host_synced


def triangulate_dlt(p_cw0, q_cw0, p_cw1, q_cw1, pt0, pt1):
    """Two-view DLT, batched over leading axes.

    (p_cw, q_cw) are world->camera transforms; pt are normalized image
    coords [...,3] with z=1. Returns world points [...,3] and the depth
    in camera 0 [...]."""
    R0 = lie.quat_to_matrix(q_cw0)
    R1 = lie.quat_to_matrix(q_cw1)
    P0 = torch.cat([R0, p_cw0[..., :, None]], dim=-1)   # [...,3,4]
    P1 = torch.cat([R1, p_cw1[..., :, None]], dim=-1)
    shape = torch.broadcast_shapes(P0.shape[:-2], P1.shape[:-2],
                                   pt0.shape[:-1], pt1.shape[:-1])
    P0 = P0.expand(shape + (3, 4))
    P1 = P1.expand(shape + (3, 4))
    pt0 = pt0.expand(shape + (3,))
    pt1 = pt1.expand(shape + (3,))
    A = torch.stack([
        pt0[..., 0:1] * P0[..., 2, :] - P0[..., 0, :],
        pt0[..., 1:2] * P0[..., 2, :] - P0[..., 1, :],
        pt1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        pt1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
    ], dim=-2)
    # the SVD checks its convergence on the host: a graph segment ends
    X = host_synced(torch.linalg.svd, A)[2][..., -1, :]
    pw = X[..., :3] / X[..., 3:4]
    depth0 = torch.sum(R0[..., 2, :] * pw, dim=-1) + p_cw0[..., 2]
    return pw, depth0


def pnp_gauss_newton(pts_w, pts_norm, valid, p_cw0, q_cw0,
                     num_iters: int = 10, huber: float = 0.01):
    """Camera pose from 3D-2D correspondences by robust Gauss-Newton.

    pts_w [N,3] world points; pts_norm [N,3] normalized obs (z=1); valid
    [N] bool; initial world->camera guess. Returns (p_cw, q_cw,
    mean reprojection error on valid rows)."""
    dtype, device = pts_w.dtype, pts_w.device

    def residual(delta, p_cw, q_cw):
        p2, q2 = lie.pose_boxplus(p_cw, q_cw, delta)
        pc = lie.quat_rotate(q2[None, :], pts_w) + p2[None, :]
        z = torch.clamp_min(pc[:, 2:3], 1e-6)
        return pc[:, :2] / z - pts_norm[:, :2]

    zero = torch.zeros(6, dtype=dtype, device=device)
    eye6 = torch.eye(6, dtype=dtype, device=device)
    p_cw, q_cw = p_cw0, q_cw0
    for _ in range(num_iters):
        r = residual(zero, p_cw, q_cw)
        J = jacfwd(residual)(zero, p_cw, q_cw)            # [N,2,6]
        rn = torch.linalg.vector_norm(r, dim=-1)
        w = torch.where(rn > huber, huber / torch.clamp_min(rn, 1e-12),
                        1.0)
        w = torch.where(valid, w, 0.0)[:, None]
        rw = (r * w).reshape(-1)
        Jw = (J * w[..., None]).reshape(-1, 6)
        # solve_ex: the same LU solve, without solve's host-side check
        delta = -torch.linalg.solve_ex(Jw.T @ Jw + 1e-8 * eye6,
                                       Jw.T @ rw)[0]
        p_cw, q_cw = lie.pose_boxplus(p_cw, q_cw, delta)
    err = torch.linalg.vector_norm(residual(zero, p_cw, q_cw), dim=-1)
    nv = torch.clamp_min(valid.sum(), 1)
    return p_cw, q_cw, torch.where(valid, err, 0.0).sum() / nv


def solve_gyro_bias(dq_dbg, q_meas, q_est):
    """Linear gyroscope-bias estimate.

    dq_dbg [E,3,3]; q_meas [E,4] preintegrated rotations; q_est [E,4]
    visual relative rotations q_i^-1 q_j. Returns delta_bg [3]."""
    dq = lie.quat_multiply(lie.quat_conjugate(q_meas), q_est)
    b_rows = 2.0 * dq[:, 1:]
    A = torch.einsum("eij,eik->jk", dq_dbg, dq_dbg)
    b = torch.einsum("eij,ei->j", dq_dbg, b_rows)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    return torch.linalg.solve(A + 1e-8 * eye, b)
