"""Trajectory evaluation: ATE / RPE with SE(3)/Sim(3) alignment.

Replaces the reference's external dependency on evo
(`scripts/eval_*_odometry.sh` call evo_ape/evo_rpe) and the TUM scripts
(`scripts/tum_tools/evaluate_ate.py`) with an in-repo implementation:
timestamp association, Umeyama alignment, ATE RMSE, and RPE over fixed
deltas. The same functions as the JAX package's, on numpy and the
port's `geometry/lie_np`.
"""

from __future__ import annotations

import numpy as np

from dynamic_vins_tpu_torch.geometry import lie_np


def associate(t_est, t_gt, max_dt: float = 0.02):
    """Match estimate timestamps to ground truth (nearest neighbor)."""
    j = np.searchsorted(t_gt, t_est)
    j = np.clip(j, 1, len(t_gt) - 1)
    left = np.abs(t_gt[j - 1] - t_est)
    right = np.abs(t_gt[j] - t_est)
    idx_gt = np.where(left < right, j - 1, j)
    dt = np.abs(t_gt[idx_gt] - t_est)
    ok = dt <= max_dt
    return np.flatnonzero(ok), idx_gt[ok]


def umeyama_alignment(x, y, with_scale: bool = False):
    """Least-squares similarity transform mapping x -> y. [N,3] each.

    Returns (s, R, t) with y ≈ s R x + t.
    """
    mu_x = x.mean(axis=0)
    mu_y = y.mean(axis=0)
    xc = x - mu_x
    yc = y - mu_y
    cov = yc.T @ xc / len(x)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_x = (xc * xc).sum() / len(x)
        s = float(np.trace(np.diag(d) @ S) / var_x)
    else:
        s = 1.0
    t = mu_y - s * R @ mu_x
    return s, R, t


def ate_rmse(t_est, p_est, t_gt, p_gt, align: bool = True,
             with_scale: bool = False, max_dt: float = 0.02):
    """Absolute trajectory error RMSE (meters), evo_ape semantics."""
    ie, ig = associate(np.asarray(t_est), np.asarray(t_gt), max_dt)
    if len(ie) < 3:
        return float("nan")
    x = np.asarray(p_est)[ie]
    y = np.asarray(p_gt)[ig]
    if align:
        s, R, t = umeyama_alignment(x, y, with_scale)
        x = (s * (R @ x.T)).T + t
    d = x - y
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))


def rpe(t_est, p_est, q_est, t_gt, p_gt, q_gt, delta: int = 1,
        max_dt: float = 0.02):
    """Relative pose error over `delta`-frame steps.

    Returns (trans_rmse [m], rot_rmse [rad])."""
    ie, ig = associate(np.asarray(t_est), np.asarray(t_gt), max_dt)
    pe, qe = np.asarray(p_est, float)[ie], np.asarray(q_est, float)[ie]
    pg, qg = np.asarray(p_gt, float)[ig], np.asarray(q_gt, float)[ig]
    n = len(pe) - delta
    if n < 1:
        return float("nan"), float("nan")
    te, re_ = [], []
    for i in range(n):
        # relative transforms
        dpe, dqe = lie_np.pose_compose(*lie_np.pose_inverse(pe[i], qe[i]),
                                       pe[i + delta], qe[i + delta])
        dpg, dqg = lie_np.pose_compose(*lie_np.pose_inverse(pg[i], qg[i]),
                                       pg[i + delta], qg[i + delta])
        ep, eq = lie_np.pose_compose(*lie_np.pose_inverse(dpg, dqg), dpe,
                                     dqe)
        te.append(float(np.linalg.norm(ep)))
        re_.append(float(np.linalg.norm(lie_np.quat_log(eq))))
    return (float(np.sqrt(np.mean(np.square(te)))),
            float(np.sqrt(np.mean(np.square(re_)))))
