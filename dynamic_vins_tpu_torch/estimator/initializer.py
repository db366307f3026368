"""Monocular visual-inertial initialization, on the host.

The relative pose of two frames from the essential matrix (the five-point
RANSAC and `recoverPose` of `estimator/essential.py`, equal to OpenCV's),
an incremental SfM over the filled window (PnP and DLT triangulation of
`estimator/triangulation.py`), and the linear gravity / velocity / scale
alignment with its refinement on the gravity sphere (VINS-Mono's
LinearAlignment and RefineGravity). Everything runs once, when a mono
window first fills: float64 torch on the CPU and numpy, whatever device
the estimator runs on.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dynamic_vins_tpu_torch.estimator import triangulation
from dynamic_vins_tpu_torch.estimator.essential import solve_relative_pose
from dynamic_vins_tpu_torch.geometry import lie

GRAVITY_NORM = 9.81

__all__ = ["solve_relative_pose", "sfm_construct",
           "solve_gravity_velocity_scale", "refine_gravity"]


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _pose_cw(R, p):
    """world(ref) -> camera as (p_cw, q_cw) tensors from camera -> world."""
    Rcw = R.T
    return _t(-Rcw @ p), lie.matrix_to_quat(_t(Rcw))


def sfm_construct(num_frames: int, obs: Dict[int, Dict[int, np.ndarray]],
                  ref_frame: int, R_rel, t_rel, min_obs_pnp: int = 12):
    """Incremental SfM over the window (GlobalSFM::construct's role).

    obs: {feature_id: {frame: normalized pt [2|3]}}. Frame `ref_frame` is
    the identity; the newest frame F-1 gets (R_rel, t_rel) (mono gauge).
    Returns (ok, R [F], p [F] camera-to-ref rotations and positions,
    points {fid: xyz})."""
    F = num_frames
    R = [None] * F
    p = [None] * F
    R[ref_frame] = np.eye(3)
    p[ref_frame] = np.zeros(3)
    R[F - 1] = np.asarray(R_rel)
    p[F - 1] = np.asarray(t_rel)
    points: Dict[int, np.ndarray] = {}

    def tri(pairs):
        """DLT of [(k0, k1, fid)] at once -> keeps the plausible points."""
        if not pairs:
            return
        ones = np.ones((len(pairs), 1))
        c0 = [_pose_cw(R[k0], p[k0]) for k0, _, _ in pairs]
        c1 = [_pose_cw(R[k1], p[k1]) for _, k1, _ in pairs]
        pt0 = np.concatenate([np.stack([obs[f][k0][:2]
                                        for k0, _, f in pairs]), ones], 1)
        pt1 = np.concatenate([np.stack([obs[f][k1][:2]
                                        for _, k1, f in pairs]), ones], 1)
        pw, d0 = triangulation.triangulate_dlt(
            torch.stack([a for a, _ in c0]), torch.stack([b for _, b in c0]),
            torch.stack([a for a, _ in c1]), torch.stack([b for _, b in c1]),
            _t(pt0), _t(pt1))
        pw, d0 = pw.numpy(), d0.numpy()
        for i, (_, _, fid) in enumerate(pairs):
            if 0.1 < d0[i] < 200.0 and np.all(np.isfinite(pw[i])):
                points[fid] = pw[i]

    def triangulate_between(k0, k1):
        tri([(k0, k1, fid) for fid, fo in obs.items()
             if fid not in points and k0 in fo and k1 in fo])

    def pnp(k, guess_from):
        pts_w, pts_n = [], []
        for fid, fo in obs.items():
            if fid in points and k in fo:
                pts_w.append(points[fid])
                pts_n.append(np.append(fo[k][:2], 1.0))
        if len(pts_w) < min_obs_pnp:
            return False
        cap = max(64, len(pts_w))
        pw = np.zeros((cap, 3))
        pw[:len(pts_w)] = pts_w
        pn = np.zeros((cap, 3))
        pn[:len(pts_n)] = pts_n
        valid = np.zeros(cap, bool)
        valid[:len(pts_w)] = True
        p_cw, q_cw, err = triangulation.pnp_gauss_newton(
            _t(pw), _t(pn), torch.as_tensor(valid),
            *_pose_cw(R[guess_from], p[guess_from]))
        if not np.isfinite(float(err)) or float(err) > 0.05:
            return False
        Rcw = lie.quat_to_matrix(q_cw).numpy()
        R[k] = Rcw.T
        p[k] = -Rcw.T @ p_cw.numpy()
        return True

    # seed structure between ref and newest
    triangulate_between(ref_frame, F - 1)
    # forward: ref+1 .. F-2 by PnP then triangulate against the newest
    for k in range(ref_frame + 1, F - 1):
        if not pnp(k, k - 1 if R[k - 1] is not None else ref_frame):
            return False, R, p, points
        triangulate_between(k, F - 1)
        triangulate_between(ref_frame, k)
    # backward: ref-1 .. 0
    for k in range(ref_frame - 1, -1, -1):
        if not pnp(k, k + 1):
            return False, R, p, points
        triangulate_between(k, ref_frame)
    # anything left, from its first and last posed observations
    rest = []
    for fid, fo in obs.items():
        if fid in points or len(fo) < 2:
            continue
        ks = [k for k in fo if R[k] is not None]
        if len(ks) >= 2:
            rest.append((ks[0], ks[-1], fid))
    tri(rest)
    return True, R, p, points


def _edge_terms(pres_i, Ri, Rj, p_bc):
    """One edge's (Ri^T, position target, velocity target)."""
    RiT = Ri.T
    z_p = pres_i["delta_p"] + RiT @ Rj @ p_bc - p_bc
    return RiT, z_p, pres_i["delta_v"]


def solve_gravity_velocity_scale(pres, R_c0b, p_c0b, p_bc, dt_edges):
    """LinearAlignment: unknowns x = [v_0..v_{F-1} (body frame), g_c0 (3),
    s (1)] from the preintegrated deltas and the SfM poses in the c0
    frame. pres: per-edge dicts with delta_p, delta_v [3]; R_c0b [F]
    body -> c0 rotations; p_c0b [F] unscaled SfM positions; p_bc [3];
    dt_edges [F-1]. Returns (ok, velocities [F,3], g_c0 [3], scale)."""
    F = len(R_c0b)
    n = 3 * F + 3 + 1
    A = np.zeros((n, n))
    b = np.zeros(n)
    for i in range(F - 1):
        dt = dt_edges[i]
        RiT, z_p, z_v = _edge_terms(pres[i], R_c0b[i], R_c0b[i + 1], p_bc)
        Ai = np.zeros((6, n))
        Ai[0:3, 3 * i:3 * i + 3] = -dt * np.eye(3)
        Ai[0:3, 3 * F:3 * F + 3] = 0.5 * RiT * dt * dt
        Ai[0:3, 3 * F + 3] = RiT @ (p_c0b[i + 1] - p_c0b[i])
        Ai[3:6, 3 * i:3 * i + 3] = -np.eye(3)
        Ai[3:6, 3 * i + 3:3 * i + 6] = RiT @ R_c0b[i + 1]
        Ai[3:6, 3 * F:3 * F + 3] = RiT * dt
        z = np.concatenate([z_p, z_v])
        A += Ai.T @ Ai * 1000.0
        b += Ai.T @ z * 1000.0
    try:
        x = np.linalg.solve(A, b)
    except np.linalg.LinAlgError:
        return False, None, None, None
    s = x[-1]
    g = x[3 * F:3 * F + 3]
    if abs(np.linalg.norm(g) - GRAVITY_NORM) > 1.5 or s < 1e-4:
        return False, None, None, None
    return True, x[:3 * F].reshape(F, 3), g, float(s)


def refine_gravity(pres, R_c0b, p_c0b, p_bc, dt_edges, g0):
    """RefineGravity: the alignment again with g held on the gravity
    sphere (a 2-dof tangent step, 4 rounds). Returns (v, g, s)."""
    F = len(R_c0b)
    g = g0 / np.linalg.norm(g0) * GRAVITY_NORM
    v = s = None
    for _ in range(4):
        a = g / np.linalg.norm(g)
        tmp = np.array([0.0, 0.0, 1.0])
        if abs(a @ tmp) > 0.9:
            tmp = np.array([1.0, 0.0, 0.0])
        b1 = np.cross(a, tmp)
        b1 /= np.linalg.norm(b1)
        b2 = np.cross(a, b1)
        bb = np.stack([b1, b2], axis=1)               # [3,2]
        n = 3 * F + 2 + 1
        A = np.zeros((n, n))
        rhs = np.zeros(n)
        for i in range(F - 1):
            dt = dt_edges[i]
            RiT, z_p, z_v = _edge_terms(pres[i], R_c0b[i], R_c0b[i + 1],
                                        p_bc)
            Ai = np.zeros((6, n))
            Ai[0:3, 3 * i:3 * i + 3] = -dt * np.eye(3)
            Ai[0:3, 3 * F:3 * F + 2] = 0.5 * dt * dt * (RiT @ bb)
            Ai[0:3, 3 * F + 2] = RiT @ (p_c0b[i + 1] - p_c0b[i])
            Ai[3:6, 3 * i:3 * i + 3] = -np.eye(3)
            Ai[3:6, 3 * i + 3:3 * i + 6] = RiT @ R_c0b[i + 1]
            Ai[3:6, 3 * F:3 * F + 2] = dt * (RiT @ bb)
            z = np.concatenate([z_p - 0.5 * dt * dt * (RiT @ g),
                                z_v - dt * (RiT @ g)])
            A += Ai.T @ Ai * 1000.0
            rhs += Ai.T @ z * 1000.0
        x = np.linalg.solve(A, rhs)
        g = g + bb @ x[3 * F:3 * F + 2]
        g = g / np.linalg.norm(g) * GRAVITY_NORM
        v = x[:3 * F].reshape(F, 3)
        s = float(x[-1])
    return v, g, s
