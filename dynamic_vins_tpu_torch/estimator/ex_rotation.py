"""Camera-IMU extrinsic rotation self-calibration (hand-eye), on the host.

Given per-interval relative camera rotations q_c (from the essential
matrix of tracked correspondences) and relative body rotations q_b (gyro
deltas) over the same intervals, recover the camera-to-body rotation
q_bc from the hand-eye constraint

    q_b ⊗ q_bc = q_bc ⊗ q_c        (R_b = R_bc R_c R_bcᵀ).

All K pairs form one stacked [4K, 4] system A q = 0 with A_k = L(q_b_k)
- R(q_c_k); Huber weights on the angular disagreement under the current
estimate are re-applied for a fixed number of IRLS rounds, each solved
by the smallest right singular vector of the weighted stack (its sign
fixed to w >= 0). Converged: the second-smallest singular value above
0.25 (the reference's gap test), at least 10 pairs, and a mean weighted
residual below 2 degrees. A few 4x4-column SVDs a frame during start-up:
plain torch on the CPU, in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamic_vins_tpu_torch.geometry import lie

PAIR_CAPACITY = 64


def _rows(*e):
    return torch.stack(e, dim=-1)


def quat_left(q):
    """L(q) with q w-first: L(q1) @ q2 == q1 ⊗ q2."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([_rows(w, -x, -y, -z), _rows(x, w, -z, y),
                        _rows(y, z, w, -x), _rows(z, -y, x, w)], dim=-2)


def quat_right(q):
    """R(q) with q w-first: R(q2) @ q1 == q1 ⊗ q2."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([_rows(w, -x, -y, -z), _rows(x, w, z, -y),
                        _rows(y, -z, w, x), _rows(z, y, -x, w)], dim=-2)


def _angular_deg(q_b, q_c, q_est):
    """Angle (deg) between q_c and the q_est-predicted camera rotation."""
    q_pred = lie.quat_multiply(
        lie.quat_multiply(lie.quat_conjugate(q_est)[None, :], q_b),
        q_est[None, :])
    q_rel = lie.quat_multiply(lie.quat_conjugate(q_pred), q_c)
    ang = 2.0 * torch.atan2(torch.linalg.vector_norm(q_rel[..., 1:], dim=-1),
                            torch.abs(q_rel[..., 0]))
    return ang * (180.0 / np.pi)


def _huber(ang):
    """The reference's weights: 1 below 5 degrees, 5/angle above."""
    return torch.where(ang > 5.0, 5.0 / torch.clamp_min(ang, 5.0), 1.0)


def calibrate_rotation(q_b, q_c, valid, rounds: int = 4):
    """Solve the hand-eye rotation from K masked pairs.

    q_b, q_c: [K,4] w-first unit quaternions; valid: [K] bool.
    Returns (q_bc [4], singular values [4] descending, converged)."""
    A0 = quat_left(q_b) - quat_right(q_c)              # [K,4,4]
    vmask = valid.to(q_b.dtype)
    q_bc = lie.quat_identity(q_b.dtype)
    s = None
    for _ in range(rounds):
        w = _huber(_angular_deg(q_b, q_c, q_bc))
        A = (A0 * (w * vmask)[:, None, None]).reshape(-1, 4)
        _, s, vh = torch.linalg.svd(A, full_matrices=False)
        q = vh[-1]
        q = torch.where(q[0] < 0, -q, q)
        q_bc = lie.quat_normalize(q)
    ang = _angular_deg(q_b, q_c, q_bc)
    w = _huber(ang) * vmask
    mean_resid = torch.sum(w * ang) / torch.clamp_min(torch.sum(vmask), 1.0)
    converged = bool((s[2] > 0.25) & (torch.sum(vmask) >= 10)
                     & (mean_resid < 2.0))
    return q_bc, s, converged


class ExRotationCalibrator:
    """Host pair accumulator and converged-rotation cache: one (q_b, q_c)
    pair pushed per new frame during start-up; the calibration is solved
    again after each push until it converges."""

    def __init__(self, capacity: int = PAIR_CAPACITY):
        self.capacity = capacity
        self.q_b = np.zeros((capacity, 4))
        self.q_c = np.zeros((capacity, 4))
        self.q_b[:, 0] = 1.0
        self.q_c[:, 0] = 1.0
        self.n = 0
        self.result = None            # [4] once converged

    def push(self, q_b, q_c) -> None:
        i = self.n % self.capacity
        self.q_b[i] = np.asarray(q_b)
        self.q_c[i] = np.asarray(q_c)
        self.n += 1

    def solve(self):
        """(q_bc, converged) from all pairs seen so far."""
        q_bc, _, conv = calibrate_rotation(
            torch.as_tensor(self.q_b), torch.as_tensor(self.q_c),
            torch.as_tensor(np.arange(self.capacity) < self.n))
        q_bc = q_bc.numpy()
        if conv:
            self.result = q_bc
        return q_bc, conv
