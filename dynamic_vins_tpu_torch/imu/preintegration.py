"""IMU preintegration on the delta manifold.

Midpoint integration of (delta_p, delta_q, delta_v) with the 15x15
Jacobian and covariance recursions of VINS' IntegrationBase.
State/error ordering: [P 0:3, theta 3:6, V 6:9, Ba 9:12, Bg 12:15];
noise ordering [na0, ng0, na1, ng1, nba, nbg] (18).

`preintegrate` has no sequential loop over samples. The quaternion
recursion is a prefix product, delta_v/delta_p are cumulative sums once
the rotations are known, and the Jacobian/covariance recursion
X' = F X Fᵀ + G is associative over pairs
(A1, C1) ∘ (A2, C2) = (A2 A1, A2 C1 A2ᵀ + C2).
Both prefix scans run as a log-depth doubling scan (Hillis-Steele) over
the padded sample axis, batched over any leading (edge) axes: log2(256)
= 8 levels of batched 15x15 products instead of 256 dependent steps.
`preintegrate_sequential` is the one-step-at-a-time loop it is tested
against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynamic_vins_tpu_torch.geometry import lie


class ImuNoise(NamedTuple):
    """IMU noise densities (reference defaults: acc_n 0.1, gyr_n 0.01,
    acc_w 1e-3, gyr_w 1e-4)."""

    acc_n: float = 0.1
    gyr_n: float = 0.01
    acc_w: float = 1.0e-3
    gyr_w: float = 1.0e-4


GRAVITY_Z = 9.81


def gravity(dtype, device=None):
    # made on the device (no host copy), so a CUDA graph can capture it
    return GRAVITY_Z * torch.eye(3, dtype=dtype, device=device)[2]


class Preintegration(NamedTuple):
    """Result of integrating one IMU interval at linearization biases
    (fields may carry leading batch axes, e.g. one per window edge)."""

    delta_p: torch.Tensor      # [...,3]
    delta_q: torch.Tensor      # [...,4] wxyz
    delta_v: torch.Tensor      # [...,3]
    jacobian: torch.Tensor     # [...,15,15]
    covariance: torch.Tensor   # [...,15,15]
    sum_dt: torch.Tensor       # [...]
    linearized_ba: torch.Tensor  # [...,3]
    linearized_bg: torch.Tensor  # [...,3]

    @property
    def dp_dba(self):
        return self.jacobian[..., 0:3, 9:12]

    @property
    def dp_dbg(self):
        return self.jacobian[..., 0:3, 12:15]

    @property
    def dq_dbg(self):
        return self.jacobian[..., 3:6, 12:15]

    @property
    def dv_dba(self):
        return self.jacobian[..., 6:9, 9:12]

    @property
    def dv_dbg(self):
        return self.jacobian[..., 6:9, 12:15]

    def sqrt_info(self):
        """U with UᵀU = covariance⁻¹, as L⁻¹ with L Lᵀ = cov.

        A non-positive-definite covariance (an empty, masked edge) gives
        non-finite values instead of raising; callers mask those edges.
        """
        cov = 0.5 * (self.covariance + self.covariance.transpose(-1, -2))
        L, _ = torch.linalg.cholesky_ex(cov)
        eye = torch.eye(15, dtype=cov.dtype, device=cov.device).expand(
            cov.shape)
        return torch.linalg.solve_triangular(L, eye, upper=False)

    def map(self, fn):
        return Preintegration(*(fn(f) for f in self))


def _noise_diag(noise: ImuNoise, dtype, device):
    vals = [noise.acc_n ** 2, noise.gyr_n ** 2, noise.acc_n ** 2,
            noise.gyr_n ** 2, noise.acc_w ** 2, noise.gyr_w ** 2]
    return torch.cat([torch.full((3,), v, dtype=dtype, device=device)
                      for v in vals])


def _step_matrices(R0, R1, un_gyr, a0, a1, dt):
    """Batched (F, V) transition/noise matrices of midpoint steps.

    dt == 0 yields F = I, V = 0 (the masked-step no-op)."""
    I3 = torch.eye(3, dtype=R0.dtype, device=R0.device).expand(R0.shape)
    Z3 = torch.zeros_like(I3)
    w_x = lie.hat(un_gyr)
    a0_x = lie.hat(a0)
    a1_x = lie.hat(a1)
    dt_ = dt[..., None, None]
    dt2 = dt_ * dt_
    ImW = I3 - w_x * dt_
    R0a0 = R0 @ a0_x
    R1a1 = R1 @ a1_x

    def rows(blocks):
        return torch.cat([torch.cat(r, dim=-1) for r in blocks], dim=-2)

    F = rows([
        [I3, -0.25 * R0a0 * dt2 - 0.25 * (R1a1 @ ImW) * dt2, I3 * dt_,
         -0.25 * (R0 + R1) * dt2, 0.25 * R1a1 * dt2 * dt_],
        [Z3, ImW, Z3, Z3, -I3 * dt_],
        [Z3, -0.5 * R0a0 * dt_ - 0.5 * (R1a1 @ ImW) * dt_, I3,
         -0.5 * (R0 + R1) * dt_, 0.5 * R1a1 * dt2],
        [Z3, Z3, Z3, I3, Z3],
        [Z3, Z3, Z3, Z3, I3],
    ])
    V = rows([
        [0.25 * R0 * dt2, -0.125 * R1a1 * dt2 * dt_, 0.25 * R1 * dt2,
         -0.125 * R1a1 * dt2 * dt_, Z3, Z3],
        [Z3, 0.5 * I3 * dt_, Z3, 0.5 * I3 * dt_, Z3, Z3],
        [0.5 * R0 * dt_, -0.25 * R1a1 * dt2, 0.5 * R1 * dt_,
         -0.25 * R1a1 * dt2, Z3, Z3],
        [Z3, Z3, Z3, Z3, I3 * dt_, Z3],
        [Z3, Z3, Z3, Z3, Z3, I3 * dt_],
    ])
    return F, V


def _doubling_scan(op, xs, dim):
    """Inclusive prefix scan of the associative `op(earlier, later)`.

    xs: tuple of tensors sharing the scanned axis `dims[i]` (negative,
    counted per tensor). log2(n) levels; each level combines every
    element with the one `d` steps before it."""
    n = xs[0].shape[dim[0]]
    d = 1
    while d < n:
        earlier = tuple(x.narrow(a, 0, n - d) for x, a in zip(xs, dim))
        later = tuple(x.narrow(a, d, n - d) for x, a in zip(xs, dim))
        comb = op(earlier, later)
        xs = tuple(torch.cat([x.narrow(a, 0, d), c], dim=a)
                   for x, c, a in zip(xs, comb, dim))
        d *= 2
    return xs


def preintegrate(acc, gyr, dt, linearized_ba, linearized_bg,
                 noise: ImuNoise = ImuNoise(),
                 valid_mask=None) -> Preintegration:
    """Integrate IMU samples into one Preintegration per leading index.

    acc, gyr: [..., N+1, 3] samples (i and i+1 bracket step i); dt:
    [..., N]; linearized_ba/bg: [..., 3]; valid_mask: optional [..., N]
    bool — masked steps are exact no-ops (dt and samples zeroed)."""
    dtype, device = acc.dtype, acc.device
    batch = dt.shape[:-1]
    n_steps = dt.shape[-1]
    if n_steps == 0:
        eye = torch.eye(15, dtype=dtype, device=device).expand(
            batch + (15, 15))
        z3 = torch.zeros(batch + (3,), dtype=dtype, device=device)
        return Preintegration(
            z3, lie.quat_identity(dtype, device).expand(batch + (4,)), z3,
            eye.clone(), torch.zeros_like(eye),
            torch.zeros(batch, dtype=dtype, device=device),
            linearized_ba, linearized_bg)
    ba = linearized_ba[..., None, :]
    a0 = acc[..., :-1, :] - ba
    a1 = acc[..., 1:, :] - ba
    un_gyr = 0.5 * (gyr[..., :-1, :] + gyr[..., 1:, :]) \
        - linearized_bg[..., None, :]
    if valid_mask is not None:
        dt = torch.where(valid_mask, dt, 0.0)
        vm = valid_mask[..., None]
        a0 = torch.where(vm, a0, 0.0)
        a1 = torch.where(vm, a1, 0.0)
        un_gyr = torch.where(vm, un_gyr, 0.0)

    e = lie.so3_exp_quat(un_gyr * dt[..., None])
    (q_after,) = _doubling_scan(
        lambda x, y: (lie.quat_multiply(x[0], y[0]),), (e,), (-2,))
    q_after = lie.quat_normalize(q_after)
    q_id = lie.quat_identity(dtype, device).expand(batch + (1, 4))
    q_before = torch.cat([q_id, q_after[..., :-1, :]], dim=-2)

    un_acc = 0.5 * (lie.quat_rotate(q_before, a0)
                    + lie.quat_rotate(q_after, a1))
    dv_inc = un_acc * dt[..., None]
    v_after = torch.cumsum(dv_inc, dim=-2)
    v_before = v_after - dv_inc
    dp_inc = v_before * dt[..., None] + 0.5 * un_acc * (dt * dt)[..., None]

    R0 = lie.quat_to_matrix(q_before)
    R1 = lie.quat_to_matrix(q_after)
    F, V = _step_matrices(R0, R1, un_gyr, a0, a1, dt)
    G = (V * _noise_diag(noise, dtype, device)) @ V.transpose(-1, -2)

    def comb(x, y):
        A1, C1 = x
        A2, C2 = y
        return A2 @ A1, A2 @ C1 @ A2.transpose(-1, -2) + C2

    A_pre, C_pre = _doubling_scan(comb, (F, G), (-3, -3))
    return Preintegration(
        dp_inc.sum(dim=-2), q_after[..., -1, :], v_after[..., -1, :],
        A_pre[..., -1, :, :], C_pre[..., -1, :, :], dt.sum(dim=-1),
        linearized_ba, linearized_bg)


def midpoint_step(delta_p, delta_q, delta_v, ba, bg, acc0, gyr0, acc1,
                  gyr1, dt):
    """One midpoint step; new deltas + the step's (F, V) matrices."""
    un_acc_0 = lie.quat_rotate(delta_q, acc0 - ba)
    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    new_delta_q = lie.quat_normalize(
        lie.quat_multiply(delta_q, lie.so3_exp_quat(un_gyr * dt)))
    un_acc_1 = lie.quat_rotate(new_delta_q, acc1 - ba)
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    new_delta_p = delta_p + delta_v * dt + 0.5 * un_acc * dt * dt
    new_delta_v = delta_v + un_acc * dt
    F, V = _step_matrices(lie.quat_to_matrix(delta_q),
                          lie.quat_to_matrix(new_delta_q), un_gyr,
                          acc0 - ba, acc1 - ba, dt)
    return new_delta_p, new_delta_q, new_delta_v, F, V


def preintegrate_sequential(acc, gyr, dt, linearized_ba, linearized_bg,
                            noise: ImuNoise = ImuNoise(),
                            valid_mask=None) -> Preintegration:
    """One midpoint step per sample (single interval, unbatched): the
    ground truth `preintegrate` is tested against."""
    dtype, device = acc.dtype, acc.device
    n_steps = dt.shape[0]
    if valid_mask is None:
        valid_mask = torch.ones(n_steps, dtype=torch.bool, device=device)
    dt = torch.where(valid_mask, dt, 0.0)
    Q = torch.diag(_noise_diag(noise, dtype, device))
    dp = torch.zeros(3, dtype=dtype, device=device)
    dq = lie.quat_identity(dtype, device)
    dv = torch.zeros(3, dtype=dtype, device=device)
    jac = torch.eye(15, dtype=dtype, device=device)
    cov = torch.zeros((15, 15), dtype=dtype, device=device)
    for i in range(n_steps):
        ndp, ndq, ndv, F, V = midpoint_step(
            dp, dq, dv, linearized_ba, linearized_bg, acc[i], gyr[i],
            acc[i + 1], gyr[i + 1], dt[i])
        m = valid_mask[i]
        dp = torch.where(m, ndp, dp)
        dq = torch.where(m, ndq, dq)
        dv = torch.where(m, ndv, dv)
        jac = torch.where(m, F @ jac, jac)
        cov = torch.where(m, F @ cov @ F.T + V @ Q @ V.T, cov)
    return Preintegration(dp, dq, dv, jac, cov, dt.sum(), linearized_ba,
                          linearized_bg)


def evaluate(pre: Preintegration, p_i, q_i, v_i, ba_i, bg_i,
             p_j, q_j, v_j, ba_j, bg_j, g=None):
    """Bias-corrected 15-dim preintegration residual (IntegrationBase::
    evaluate). Differentiable in every input."""
    if g is None:
        g = gravity(p_i.dtype, p_i.device)
    dba = ba_i - pre.linearized_ba
    dbg = bg_i - pre.linearized_bg
    mv = lambda M, x: (M @ x[..., None])[..., 0]
    corrected_q = lie.quat_multiply(
        pre.delta_q, lie.so3_exp_quat(mv(pre.dq_dbg, dbg)))
    corrected_v = pre.delta_v + mv(pre.dv_dba, dba) + mv(pre.dv_dbg, dbg)
    corrected_p = pre.delta_p + mv(pre.dp_dba, dba) + mv(pre.dp_dbg, dbg)
    q_i_inv = lie.quat_conjugate(q_i)
    sum_dt = pre.sum_dt[..., None]
    r_p = lie.quat_rotate(
        q_i_inv, 0.5 * g * sum_dt * sum_dt + p_j - p_i - v_i * sum_dt
    ) - corrected_p
    r_q = 2.0 * lie.quat_multiply(
        lie.quat_conjugate(corrected_q),
        lie.quat_multiply(q_i_inv, q_j))[..., 1:]
    r_v = lie.quat_rotate(q_i_inv, g * sum_dt + v_j - v_i) - corrected_v
    return torch.cat([r_p, r_q, r_v, ba_j - ba_i, bg_j - bg_i], dim=-1)


def propagate_with(pre: Preintegration, p, q, v, g=None):
    """World-frame midpoint propagation across a whole interval.

    Same result as applying `propagate_state` once per sample with the
    biases `pre` was linearized at: every step's world acceleration is
    R(q) times the step's delta-frame acceleration minus g, so the sums
    factor through the interval's deltas. Costs no sequential loop."""
    if g is None:
        g = gravity(p.dtype, p.device)
    T = pre.sum_dt[..., None]
    p_new = p + v * T - 0.5 * g * T * T + lie.quat_rotate(q, pre.delta_p)
    v_new = v - g * T + lie.quat_rotate(q, pre.delta_v)
    q_new = lie.quat_normalize(lie.quat_multiply(q, pre.delta_q))
    return p_new, q_new, v_new


def propagate_state(p, q, v, ba, bg, acc0, gyr0, acc1, gyr1, dt, g=None):
    """World-frame midpoint state propagation for one IMU step."""
    if g is None:
        g = gravity(p.dtype, p.device)
    un_acc_0 = lie.quat_rotate(q, acc0 - ba) - g
    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    q_new = lie.quat_normalize(
        lie.quat_multiply(q, lie.so3_exp_quat(un_gyr * dt)))
    un_acc_1 = lie.quat_rotate(q_new, acc1 - ba) - g
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    return p + v * dt + 0.5 * un_acc * dt * dt, q_new, v + un_acc * dt
