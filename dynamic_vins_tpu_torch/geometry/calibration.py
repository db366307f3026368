"""Camera intrinsic calibration from planar targets (Zhang's method).

The counterpart of camodocal's calibration tool (`camera_models/src/
calib/CameraCalibration.cc`, `intrinsic_calib.cc`): detected board
corners -> a homography per view by normalized DLT -> the closed-form
intrinsics -> per-view extrinsics -> one batched Gauss-Newton refinement
of (fx, fy, cx, cy, k1, k2, p1, p2) and every view's pose, whose
reprojection Jacobian is one `torch.func.jacfwd` over a `vmap` of the
views. The closed-form stages are numpy; the refinement runs in float64
on the given device.

Input: a list of views, each (object_pts [N,2] board-plane coordinates,
image_pts [N,2] detected pixel corners).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from dynamic_vins_tpu_torch.geometry import camera as cam
from dynamic_vins_tpu_torch.geometry import lie
from dynamic_vins_tpu_torch.utils.precision import resolve_device


class CalibrationResult(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    dist: np.ndarray          # [4] k1 k2 p1 p2
    rms: float                # reprojection RMS (px)
    rvecs: np.ndarray         # [V,3] per-view rotations (axis-angle)
    tvecs: np.ndarray         # [V,3]


def _normalize_pts(pts):
    """Hartley normalization: zero mean, mean distance sqrt(2)."""
    c = pts.mean(axis=0)
    d = np.sqrt(((pts - c) ** 2).sum(axis=1)).mean()
    s = np.sqrt(2.0) / max(d, 1e-12)
    T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
    ph = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    return (T @ ph.T).T[:, :2], T


def homography_dlt(obj_pts, img_pts):
    """Planar homography by normalized DLT (8 dof, SVD)."""
    op, To = _normalize_pts(np.asarray(obj_pts, float))
    ip, Ti = _normalize_pts(np.asarray(img_pts, float))
    n = len(op)
    A = np.zeros((2 * n, 9))
    for i in range(n):
        X, Y = op[i]
        u, v = ip[i]
        A[2 * i] = [-X, -Y, -1, 0, 0, 0, u * X, u * Y, u]
        A[2 * i + 1] = [0, 0, 0, -X, -Y, -1, v * X, v * Y, v]
    _, _, Vt = np.linalg.svd(A)
    Hn = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Ti) @ Hn @ To
    return H / H[2, 2]


def _v_ij(H, i, j):
    return np.array([
        H[0, i] * H[0, j],
        H[0, i] * H[1, j] + H[1, i] * H[0, j],
        H[1, i] * H[1, j],
        H[2, i] * H[0, j] + H[0, i] * H[2, j],
        H[2, i] * H[1, j] + H[1, i] * H[2, j],
        H[2, i] * H[2, j]])


def intrinsics_from_homographies(Hs: List[np.ndarray]):
    """Zhang's closed form: B = K^-T K^-1 from the v_ij constraints."""
    V = []
    for H in Hs:
        V.append(_v_ij(H, 0, 1))
        V.append(_v_ij(H, 0, 0) - _v_ij(H, 1, 1))
    V = np.stack(V)
    _, _, Vt = np.linalg.svd(V)
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    cx = -b13 * fx * fx / lam
    return fx, fy, cx, cy


def extrinsics_from_homography(H, K):
    """A view's [R|t] from K^-1 H, R orthonormalized."""
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / max(np.linalg.norm(Kinv @ h1), 1e-12)
    r1 = lam * (Kinv @ h1)
    r2 = lam * (Kinv @ h2)
    t = lam * (Kinv @ h3)
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    # the closest rotation (SVD polar factor)
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = -R
    if t[2] < 0:                         # the board lies in front
        R[:, 0] *= -1
        R[:, 1] *= -1
        t = -t
    return R, t


def calibrate_planar(views: List[Tuple[np.ndarray, np.ndarray]],
                     refine_iters: int = 12,
                     device=None) -> CalibrationResult:
    """DLT homographies -> Zhang intrinsics -> per-view extrinsics -> the
    batched Gauss-Newton refinement of (K, dist, every pose) on `device`
    (the card unless asked otherwise), in float64."""
    device = resolve_device(device)
    Hs = [homography_dlt(o, i) for o, i in views]
    fx, fy, cx, cy = intrinsics_from_homographies(Hs)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    rvecs, tvecs = [], []
    for H in Hs:
        R, t = extrinsics_from_homography(H, K)
        R = torch.from_numpy(np.ascontiguousarray(R))
        rvecs.append(lie.quat_log(lie.matrix_to_quat(R)).numpy())
        tvecs.append(t)
    rvecs = np.stack(rvecs)
    tvecs = np.stack(tvecs)

    # views padded to a common N for one static-shape batched refinement
    N = max(len(o) for o, _ in views)
    Vn = len(views)
    obj = np.zeros((Vn, N, 2))
    img = np.zeros((Vn, N, 2))
    msk = np.zeros((Vn, N), bool)
    for k, (o, i) in enumerate(views):
        n = len(o)
        obj[k, :n] = o
        img[k, :n] = i
        msk[k, :n] = True

    theta, rms = _refine(np.array([fx, fy, cx, cy]), rvecs, tvecs, obj,
                         img, msk, refine_iters, device)
    fx, fy, cx, cy = theta[:4]
    dist = theta[4:8]
    rv = theta[8:8 + 3 * Vn].reshape(Vn, 3)
    tv = theta[8 + 3 * Vn:].reshape(Vn, 3)
    return CalibrationResult(float(fx), float(fy), float(cx), float(cy),
                             np.asarray(dist), float(rms), rv, tv)


def _refine(k4, rvecs, tvecs, obj, img, msk, iters, device):
    """Batched Gauss-Newton over (fx fy cx cy k1 k2 p1 p2, poses)."""
    f64 = dict(dtype=torch.float64, device=device)
    Vn = rvecs.shape[0]
    theta = torch.tensor(np.concatenate(
        [k4, np.zeros(4), rvecs.reshape(-1), tvecs.reshape(-1)]), **f64)
    obj = torch.tensor(obj, **f64)
    img = torch.tensor(img, **f64)
    mskf = torch.tensor(msk, **f64)

    def residuals(theta):
        intr = cam.PinholeIntrinsics(*theta[:8].unbind())
        rv = theta[8:8 + 3 * Vn].reshape(Vn, 3)
        tv = theta[8 + 3 * Vn:].reshape(Vn, 3)

        def one(rv_k, tv_k, obj_k, img_k, m_k):
            q = lie.so3_exp_quat(rv_k)
            p3 = torch.cat([obj_k, torch.zeros_like(obj_k[:, :1])], dim=1)
            pc = lie.quat_rotate(q[None, :], p3) + tv_k[None, :]
            uv = cam.project(intr, pc)
            return (uv - img_k) * m_k[:, None]

        r = torch.func.vmap(one)(rv, tv, obj, img, mskf)
        return r.reshape(-1)

    eye = torch.eye(theta.shape[0], **f64)
    for _ in range(iters):
        J = torch.func.jacfwd(residuals)(theta)
        r = residuals(theta)
        H = J.T @ J + 1e-9 * eye
        theta = theta - torch.linalg.solve(H, J.T @ r)
    r = residuals(theta)
    n_obs = float(msk.sum())
    rms = float(np.sqrt(float(r @ r) / max(2 * n_obs, 1.0) * 2.0))
    return theta.cpu().numpy(), rms
