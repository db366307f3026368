"""Marginalization: compress dropped window states into a linear prior.

Evaluate the factors touching the dropped states at the current
estimate, assemble their Gauss-Newton system, Schur-complement the
dropped dimensions (eigendecomposition pseudo-inverse with a floor) and
recover a square-root prior (J0, r0) via eigh; a window slide is then a
column permutation of J0.
"""

from __future__ import annotations

import torch

from dynamic_vins_tpu_torch.factors import prior as prior_factor
from dynamic_vins_tpu_torch.solver import gauss_newton as gn
from dynamic_vins_tpu_torch.solver import layout
from dynamic_vins_tpu_torch.utils.step_graph import host_synced

_EIG_EPS = 1e-8

# Relative eigenvalue floor: an accuracy parameter, not only a numerical
# guard. Eigenvalues far below the (whitened, see _equilibrate) spectral
# norm carry gauge / weakly observable directions whose linearization
# error outweighs their information; keeping them over-pins the prior.
# The JAX package's sweep on its 42-frame noisy protocol chose 1e-6
# (1e-5 and 1e-7 both gave a worse median ATE).
_EIG_REL = 1e-6


def _eig_threshold(w):
    """Keep eigenvalues above max(abs_floor, rel_floor * max_eig)."""
    w_max = torch.clamp_min(torch.max(torch.abs(w)), _EIG_EPS)
    return torch.clamp_min(_EIG_REL * w_max, _EIG_EPS)


def _equilibrate(A):
    """Jacobi scale s with (s A s) having a unit-ish diagonal.

    The window Hessian's diagonal spans ~1e12 (IMU bias vs visual
    information); an f32 eigh of the raw matrix has a backward error
    larger than the small eigenvalues. Whitening by D^-1/2 compresses
    the range; results map back exactly (D is diagonal)."""
    d = torch.abs(torch.diagonal(A))
    return torch.where(d > _EIG_EPS,
                       1.0 / torch.sqrt(torch.clamp_min(d, _EIG_EPS)), 1.0)


def _eig_pinv(A):
    """Symmetric pseudo-inverse with eigenvalue floor, on the
    equilibrated matrix."""
    A = 0.5 * (A + A.T)
    s = _equilibrate(A)
    # eigh checks its result on the host: a graph segment ends here
    w, V = host_synced(torch.linalg.eigh, A * s[:, None] * s[None, :])
    thr = _eig_threshold(w)
    inv_w = torch.where(w > thr, 1.0 / torch.maximum(w, thr), 0.0)
    return (s[:, None] * V * inv_w[None, :]) @ (V.T * s[None, :])


def _schur_eliminate(H, b, drop_idx):
    """Eliminate the (static) indices from (H, b); zero them out."""
    Hdd = H[drop_idx][:, drop_idx]
    Hkd = H[:, drop_idx]
    inv = _eig_pinv(Hdd)
    S = H - Hkd @ inv @ Hkd.T
    bk = b - Hkd @ (inv @ b[drop_idx])
    keep = torch.ones(H.shape[0], dtype=H.dtype, device=H.device)
    keep.index_fill_(0, drop_idx, 0.0)
    return S * keep[:, None] * keep[None, :], bk * keep


def _sqrt_factorize(S, b):
    """(J0, r0) with J0ᵀJ0 = S and J0ᵀr0 = b, via eigh of the
    equilibrated system (S = D^1/2 Ss D^1/2, J0 = sqrt(w) Vᵀ D^1/2)."""
    S = 0.5 * (S + S.T)
    s = _equilibrate(S)
    w, V = host_synced(torch.linalg.eigh, S * s[:, None] * s[None, :])
    thr = _eig_threshold(w)
    pos = w > thr
    sqrt_w = torch.where(pos, torch.sqrt(torch.maximum(w, thr)), 0.0)
    inv_sqrt_w = torch.where(
        pos, 1.0 / torch.clamp_min(sqrt_w, _EIG_EPS), 0.0)
    J0 = sqrt_w[:, None] * (V.T / s[None, :])
    r0 = inv_sqrt_w * (V.T @ (s * b))
    return J0, r0


def kept_rank(prior: prior_factor.MarginalPrior):
    """Number of non-zero rows of J0 (eigenvalues above the floor)."""
    return int((prior.jacobian.abs().sum(dim=1) > 0).sum())


def _drop_indices_old(F: int, device):
    return torch.cat([torch.arange(6, device=device) + layout.pose_col(0),
                      torch.arange(9, device=device)
                      + layout.speedbias_col(0, F)])


def marginalize_old(state: layout.WindowState, inv_depth,
                    problem: gn.BAProblem, drop_lm_mask,
                    config: gn.SolverConfig) -> prior_factor.MarginalPrior:
    """Marginalize frame 0 (+ its anchored landmarks) into a new prior.

    The factor subset: the existing prior, IMU edge 0, and every
    projection row of a dropped landmark anchored at frame 0."""
    F = state.num_frames
    obs = problem.obs
    sub_obs = obs._replace(valid=obs.valid & (obs.frame_i == 0)
                           & drop_lm_mask[obs.lm])
    E = problem.imu_valid.shape[0]
    sub = problem._replace(
        obs=sub_obs,
        imu_valid=problem.imu_valid
        & (torch.arange(E, device=state.p.device) == 0),
        lm_valid=problem.lm_valid & drop_lm_mask)
    eq = gn.build_normal_equations(state, inv_depth, sub, config)

    H_ll_safe = torch.where(sub.lm_valid & (eq.H_ll > 0.0), eq.H_ll, 1.0)
    b_l = torch.where(sub.lm_valid, eq.b_l, 0.0)
    H_lc = torch.where(sub.lm_valid[:, None], eq.H_lc, 0.0)
    inv_Hll = 1.0 / H_ll_safe
    H1 = eq.H_cc - H_lc.T @ (H_lc * inv_Hll[:, None])
    b1 = eq.b_c - H_lc.T @ (b_l * inv_Hll)

    S, bk = _schur_eliminate(H1, b1, _drop_indices_old(F, H1.device))
    J0, r0 = _sqrt_factorize(S, bk)
    lin_state = layout.WindowState(*(a.clone() for a in state))
    return prior_factor.MarginalPrior(
        lin_state, J0, r0,
        torch.ones((), dtype=torch.bool, device=state.p.device))


def marginalize_second_new(prior: prior_factor.MarginalPrior,
                           num_frames: int) -> prior_factor.MarginalPrior:
    """Drop pose[F-2] from the existing prior (kMarginSecondNew)."""
    J = prior.jacobian
    H = J.T @ J
    b = J.T @ prior.residual
    drop = torch.arange(6, device=J.device) + layout.pose_col(
        num_frames - 2)
    S, bk = _schur_eliminate(H, b, drop)
    J0, r0 = _sqrt_factorize(S, bk)
    return prior._replace(jacobian=J0, residual=r0)


def _shift_perm_old(F: int, device):
    """Column gather indices (new tangent dim -> old) and keep mask."""
    D = layout.cam_dim(F)
    src = torch.arange(D, device=device)
    keep = torch.ones(D, dtype=torch.bool, device=device)
    for j in range(F - 1):
        src[layout.pose_col(j):layout.pose_col(j) + 6] = \
            layout.pose_col(j + 1) + torch.arange(6, device=device)
        c = layout.speedbias_col(j, F)
        src[c:c + 9] = layout.speedbias_col(j + 1, F) + torch.arange(
            9, device=device)
    # fill_, not `= False`: a Python value assigned into a device
    # tensor is copied from the host
    keep[layout.pose_col(F - 1):layout.pose_col(F - 1) + 6].fill_(False)
    c = layout.speedbias_col(F - 1, F)
    keep[c:c + 9].fill_(False)
    return src, keep


def shift_prior_after_slide_old(prior: prior_factor.MarginalPrior,
                                slid_state: layout.WindowState
                                ) -> prior_factor.MarginalPrior:
    """Re-index prior columns after the window slid out frame 0."""
    F = slid_state.num_frames
    src, keep = _shift_perm_old(F, prior.jacobian.device)
    J_new = prior.jacobian[:, src] * keep[None, :].to(prior.jacobian.dtype)
    ls = prior.lin_state
    roll = lambda a: torch.cat([a[1:], a[-1:]], dim=0)
    lin_new = ls._replace(p=roll(ls.p), q=roll(ls.q), v=roll(ls.v),
                          ba=roll(ls.ba), bg=roll(ls.bg))
    return prior_factor.MarginalPrior(lin_new, J_new, prior.residual,
                                      prior.valid)


def shift_prior_after_slide_new(prior: prior_factor.MarginalPrior
                                ) -> prior_factor.MarginalPrior:
    """After a kMarginSecondNew slide: only the lin_state of slot F-2
    moves (new frames never enter the prior)."""
    ls = prior.lin_state

    def rep(a):
        a = a.clone()
        a[-2] = a[-1]
        return a

    lin_new = ls._replace(p=rep(ls.p), q=rep(ls.q), v=rep(ls.v),
                          ba=rep(ls.ba), bg=rep(ls.bg))
    return prior._replace(lin_state=lin_new)
