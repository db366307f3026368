"""Levenberg–Marquardt window BA with a dense camera block and an
implicit landmark Schur complement (point factors).

  * factor residuals/Jacobians from vmapped jacfwd,
  * the dense camera-side Jacobian [M, Dc] assembled from one-hot outer
    products, so H_cc = JᵀJ is one matmul,
  * landmark columns kept implicit: H_ll is an `index_add_` diagonal,
    H_lc an `index_add_` of weighted J rows, and the Schur complement
    S = H_cc − H_lcᵀ D⁻¹ H_lc is again one matmul,
  * lines (LinePoint mode, optional): 4-dof orth blocks eliminated by
    a damped 4x4 block-diagonal Schur step before the camera solve,
  * a fixed-count LM loop whose accept/reject is `torch.where` on
    device tensors: no host read per iteration.

On the card `index_add_` accumulates with atomics, so sums land in a
run-dependent order (float32 results vary in the last bits).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynamic_vins_tpu_torch.factors import imu_factor, line_factor, projection
from dynamic_vins_tpu_torch.factors import prior as prior_factor
from dynamic_vins_tpu_torch.imu import preintegration as pre
from dynamic_vins_tpu_torch.solver import layout


class BAProblem(NamedTuple):
    """All factor data for one window solve."""

    obs: projection.ProjObs
    pres: pre.Preintegration          # batched [E = F-1]
    imu_valid: torch.Tensor           # [E] bool
    prior: prior_factor.MarginalPrior
    lm_valid: torch.Tensor            # [L] bool
    fixed_cols: torch.Tensor          # [Dc] bool — tangent dims held fixed
    # optional line system (LinePoint mode; None = points only)
    line_obs: object = None           # line_factor.LineObs | None
    line_valid: object = None         # [Lc] bool | None


class SolverConfig(NamedTuple):
    max_iters: int = 10
    init_lambda: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    min_lambda: float = 1e-10
    max_lambda: float = 1e8
    huber_delta: float = 1.0          # on whitened projection residuals
    use_imu: bool = True
    ridge: float = 1e-8
    # weight of the line factors against the points (scales
    # LINE_SQRT_INFO)
    line_weight: float = 1.0


def _huber_weight(r2, delta):
    """Per-row IRLS weight sqrt(rho'(s)) for Ceres-style Huber."""
    s = torch.sqrt(torch.clamp_min(r2, 1e-20))
    return torch.where(r2 <= delta * delta, 1.0, torch.sqrt(delta / s))


def _huber_cost(r2, delta):
    d2 = delta * delta
    return torch.where(
        r2 <= d2, r2, 2.0 * delta * torch.sqrt(torch.clamp_min(r2, 1e-20))
        - d2)


def _segment_sum(vals, seg, n):
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    # out of place: `torch.func.vmap` batches it (singlechip_scaling's
    # batched windows); in place it cannot add batched rows to `out`
    return out.index_add(0, seg, vals)


def _scatter_rows(jacs, cols, D):
    """Scatter per-item block Jacobians [n,rows,k] into dense [n*rows,D]."""
    n, rows, k = jacs.shape
    out = torch.zeros((n * rows, D), dtype=jacs.dtype, device=jacs.device)
    row_idx = (torch.arange(n, device=jacs.device)[:, None, None] * rows
               + torch.arange(rows, device=jacs.device)[None, :, None])
    row_idx = row_idx.expand(n, rows, k)
    col_idx = cols[:, None, :].expand(n, rows, k)
    return out.index_put((row_idx.reshape(-1), col_idx.reshape(-1)),
                         jacs.reshape(-1), accumulate=True)


def _assemble_proj_rows(j_cam, obs, F, D):
    """Dense projection Jacobian [2N, D] from one-hot outer products.

    j_cam: [N,2,25] blocks [0:6) dpose_i, [6:12) dpose_j, [12:18) dex_i
    (always cam 0), [18:24) dex_j (cam_j), [24] dtd."""
    n = j_cam.shape[0]
    dt = j_cam.dtype
    # one_hot by comparison: F.one_hot checks its range on the host
    oh = lambda idx, k: (idx[:, None] == torch.arange(
        k, device=idx.device)).to(dt)
    oh_i = oh(obs.frame_i, F)
    oh_j = oh(obs.frame_j, F)
    pose = (j_cam[:, :, None, 0:6] * oh_i[:, None, :, None]
            + j_cam[:, :, None, 6:12] * oh_j[:, None, :, None])
    pose = pose.reshape(n, 2, 6 * F)
    sb = torch.zeros((n, 2, 9 * F), dtype=dt, device=j_cam.device)
    oh_c = oh(obs.cam_j, 2)
    ex0 = j_cam[:, :, 12:18] + oh_c[:, None, 0:1] * j_cam[:, :, 18:24]
    ex1 = oh_c[:, None, 1:2] * j_cam[:, :, 18:24]
    J = torch.cat([pose, sb, ex0, ex1, j_cam[:, :, 24:25]], dim=-1)
    return J.reshape(2 * n, D)


class NormalEquations(NamedTuple):
    H_cc: torch.Tensor    # [Dc, Dc]
    b_c: torch.Tensor     # [Dc]
    H_ll: torch.Tensor    # [L] diagonal
    H_lc: torch.Tensor    # [L, Dc]
    b_l: torch.Tensor     # [L]
    cost: torch.Tensor    # [] robustified total cost
    # line blocks (4-dof orth params, block-diagonal Schur)
    H_gg: object = None   # [Lc,4,4] | None
    H_gc: object = None   # [Lc,4,Dc] | None
    b_g: object = None    # [Lc,4] | None


def _has_lines(problem: BAProblem, line_orth) -> bool:
    return problem.line_obs is not None and line_orth is not None


def _line_valid_rows(problem: BAProblem):
    return problem.line_obs.valid & problem.line_valid[problem.line_obs.line]


def _line_normal_equations(state, line_orth, problem, config, D):
    """The line factors' camera rows and their 4x4 line blocks."""
    Lc = line_orth.shape[0]
    obs = problem.line_obs
    r_l, j_cam, j_orth, cols = line_factor.evaluate(
        state, line_orth, obs,
        sqrt_info=line_factor.LINE_SQRT_INFO * config.line_weight)
    valid = _line_valid_rows(problem)
    r_l = torch.where(valid[:, None], r_l, 0.0)
    j_cam = torch.where(valid[:, None, None], j_cam, 0.0)
    j_orth = torch.where(valid[:, None, None], j_orth, 0.0)

    r2 = torch.sum(r_l * r_l, dim=-1)
    w = _huber_weight(r2, config.huber_delta)[:, None]
    cost = 0.5 * torch.sum(
        torch.where(valid, _huber_cost(r2, config.huber_delta), 0.0))
    r_l = r_l * w
    j_cam = j_cam * w[..., None]
    j_orth = j_orth * w[..., None]

    N = r_l.shape[0]
    J_line = _scatter_rows(j_cam, cols, D)
    r_line = r_l.reshape(2 * N)
    jg = j_orth.reshape(2 * N, 4)
    line_flat = obs.line[:, None].expand(-1, 2).reshape(-1)
    H_gg = _segment_sum(jg[:, :, None] * jg[:, None, :], line_flat, Lc)
    H_gc = _segment_sum(jg[:, :, None] * J_line[:, None, :], line_flat, Lc)
    b_g = _segment_sum(jg * r_line[:, None], line_flat, Lc)
    return J_line, r_line, H_gg, H_gc, b_g, cost


def build_normal_equations(state: layout.WindowState, inv_depth,
                           problem: BAProblem, config: SolverConfig,
                           line_orth=None) -> NormalEquations:
    """Assemble the Gauss-Newton system for one window (with the line
    blocks where the problem has lines and `line_orth` is given)."""
    F = state.num_frames
    D = layout.cam_dim(F)
    L = inv_depth.shape[0]
    dtype, device = state.p.dtype, state.p.device

    r_p, j_cam, j_dep, _ = projection.evaluate(state, inv_depth,
                                               problem.obs)
    obs_valid = problem.obs.valid & problem.lm_valid[problem.obs.lm]
    r_p = torch.where(obs_valid[:, None], r_p, 0.0)
    j_cam = torch.where(obs_valid[:, None, None], j_cam, 0.0)
    j_dep = torch.where(obs_valid[:, None], j_dep, 0.0)

    r2 = torch.sum(r_p * r_p, dim=-1)
    w = _huber_weight(r2, config.huber_delta)[:, None]
    cost_proj = 0.5 * torch.sum(
        torch.where(obs_valid, _huber_cost(r2, config.huber_delta), 0.0))
    r_p = r_p * w
    j_cam = j_cam * w[..., None]
    j_dep = j_dep * w

    N = r_p.shape[0]
    J_proj = _assemble_proj_rows(j_cam, problem.obs, F, D)
    r_proj = r_p.reshape(2 * N)
    jl = j_dep.reshape(2 * N)
    # repeat_interleave would read its output size on the host
    lm_flat = problem.obs.lm[:, None].expand(-1, 2).reshape(-1)
    H_ll = _segment_sum(jl * jl, lm_flat, L)
    H_lc = _segment_sum(jl[:, None] * J_proj, lm_flat, L)
    b_l = _segment_sum(jl * r_proj, lm_flat, L)

    if config.use_imu:
        r_i, J_i, cols_i = imu_factor.evaluate(state, problem.pres,
                                               problem.imu_valid)
        E = r_i.shape[0]
        J_imu = _scatter_rows(J_i, cols_i, D)
        r_imu = r_i.reshape(15 * E)
        cost_imu = 0.5 * torch.sum(r_imu * r_imu)
    else:
        J_imu = torch.zeros((0, D), dtype=dtype, device=device)
        r_imu = torch.zeros((0,), dtype=dtype, device=device)
        cost_imu = torch.zeros((), dtype=dtype, device=device)

    r_pr, J_pr = prior_factor.evaluate(state, problem.prior)
    cost_prior = 0.5 * torch.sum(r_pr * r_pr)

    blocks = ()
    cost = cost_proj + cost_imu + cost_prior
    if _has_lines(problem, line_orth):
        (J_line, r_line, H_gg, H_gc, b_g,
         cost_line) = _line_normal_equations(state, line_orth, problem,
                                             config, D)
        J_pr = torch.cat([J_pr, J_line], dim=0)
        r_pr = torch.cat([r_pr, r_line], dim=0)
        cost = cost + cost_line
        blocks = (H_gg, H_gc, b_g)

    J_all = torch.cat([J_proj, J_imu, J_pr], dim=0)
    r_all = torch.cat([r_proj, r_imu, r_pr], dim=0)
    free = (~problem.fixed_cols).to(dtype)
    J_all = J_all * free[None, :]
    H_lc = H_lc * free[None, :]
    if blocks:
        blocks = (blocks[0], blocks[1] * free[None, None, :], blocks[2])
    return NormalEquations(J_all.T @ J_all, J_all.T @ r_all, H_ll, H_lc,
                           b_l, cost, *blocks)


def total_cost(state: layout.WindowState, inv_depth, problem: BAProblem,
               config: SolverConfig, line_orth=None):
    r_p = projection.residual_only(state, inv_depth, problem.obs)
    obs_valid = problem.obs.valid & problem.lm_valid[problem.obs.lm]
    r2 = torch.sum(r_p * r_p, dim=-1)
    cost = 0.5 * torch.sum(
        torch.where(obs_valid, _huber_cost(r2, config.huber_delta), 0.0))
    if config.use_imu:
        r_i = imu_factor.residual_only(state, problem.pres,
                                       problem.imu_valid)
        cost = cost + 0.5 * torch.sum(r_i * r_i)
    r_pr = prior_factor.residual_only(state, problem.prior)
    cost = cost + 0.5 * torch.sum(r_pr * r_pr)
    if _has_lines(problem, line_orth):
        r_l = line_factor.residual_only(
            state, line_orth, problem.line_obs,
            sqrt_info=line_factor.LINE_SQRT_INFO * config.line_weight)
        lr2 = torch.sum(r_l * r_l, dim=-1)
        cost = cost + 0.5 * torch.sum(torch.where(
            _line_valid_rows(problem),
            _huber_cost(lr2, config.huber_delta), 0.0))
    return cost


def solve_damped(eq: NormalEquations, lm_valid, fixed_cols, lam, ridge,
                 line_valid=None):
    """One damped Schur solve -> (delta_c [Dc], delta_l [L], delta_g
    [Lc,4] or None). The line blocks (of the lines `line_valid` [Lc]
    marks) are damped, inverted (a capture-safe batched 4x4 Cholesky)
    and eliminated before the camera solve.

    A Cholesky that fails (a non positive definite system) yields a NaN
    step, which the LM loop rejects, as the JAX solver does."""
    diag_cc = torch.diagonal(eq.H_cc)
    damped_diag = diag_cc * (1.0 + lam) + ridge
    damped_diag = torch.where(fixed_cols | (diag_cc <= 0.0),
                              torch.clamp_min(damped_diag, 1.0),
                              damped_diag)
    H_cc = eq.H_cc + torch.diag(damped_diag - diag_cc)

    H_ll = torch.where(lm_valid & (eq.H_ll > 0.0), eq.H_ll * (1.0 + lam),
                       1.0)
    b_l = torch.where(lm_valid, eq.b_l, 0.0)
    H_lc = torch.where(lm_valid[:, None], eq.H_lc, 0.0)
    inv_Hll = 1.0 / H_ll
    S = H_cc - H_lc.T @ (H_lc * inv_Hll[:, None])
    rhs = eq.b_c - H_lc.T @ (b_l * inv_Hll)

    inv_Hgg = None
    if eq.H_gg is not None:
        Lc = eq.H_gg.shape[0]
        eye4 = torch.eye(4, dtype=eq.H_gg.dtype, device=eq.H_gg.device)
        dg = torch.diagonal(eq.H_gg, dim1=-2, dim2=-1)
        Hgg = eq.H_gg + (lam * dg + ridge + 1e-6)[..., None] * eye4
        Hgg = torch.where(line_valid[:, None, None], Hgg, eye4)
        H_gc = torch.where(line_valid[:, None, None], eq.H_gc, 0.0)
        b_g = torch.where(line_valid[:, None], eq.b_g, 0.0)
        inv_Hgg = line_factor.spd_solve(Hgg, eye4.expand(Lc, 4, 4))
        tmp = torch.einsum("gij,gjD->giD", inv_Hgg, H_gc)
        S = S - torch.einsum("giD,giE->DE", H_gc, tmp)
        rhs = rhs - torch.einsum("giD,gi->D", H_gc,
                                 torch.einsum("gij,gj->gi", inv_Hgg, b_g))

    # Jacobi scaling + one refinement step keep the f32 Cholesky stable
    # over the wide IMU-bias vs visual dynamic range
    scale = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(S), 1e-12))
    S_s = S * scale[:, None] * scale[None, :]
    cho, info = torch.linalg.cholesky_ex(S_s)
    b_s = (scale * rhs)[:, None]
    x = torch.cholesky_solve(b_s, cho)
    x = x + torch.cholesky_solve(b_s - S_s @ x, cho)
    x = torch.where(info == 0, x[:, 0], torch.nan)
    delta_c = torch.where(fixed_cols, 0.0, -scale * x)
    delta_l = torch.where(lm_valid, -(b_l + H_lc @ delta_c) * inv_Hll, 0.0)
    delta_g = None
    if inv_Hgg is not None:
        resid_g = b_g + torch.einsum("giD,D->gi", H_gc, delta_c)
        delta_g = -torch.einsum("gij,gj->gi", inv_Hgg, resid_g)
    return delta_c, delta_l, delta_g


class SolveInfo(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    final_lambda: torch.Tensor
    accepted: torch.Tensor     # [iters] bool


def _select(accept, a, b):
    if a is None:
        return None
    if isinstance(a, tuple):
        return type(a)(*(_select(accept, x, y) for x, y in zip(a, b)))
    return torch.where(accept, a, b)


def solve(state: layout.WindowState, inv_depth, problem: BAProblem,
          config: SolverConfig = SolverConfig(), line_orth=None):
    """Run LM for config.max_iters -> (state, inv_depth, SolveInfo), or,
    when the problem has lines and `line_orth` [Lc,4] is given, (state,
    inv_depth, line_orth, SolveInfo).

    The normal equations and the cost come from one evaluation per
    iteration; on reject the previous equations are reused at a larger
    lambda."""
    from dynamic_vins_tpu_torch.geometry import lines as line_geom

    dtype, device = state.p.dtype, state.p.device
    has_lines = _has_lines(problem, line_orth)
    orth = line_orth if has_lines else None
    eq = build_normal_equations(state, inv_depth, problem, config, orth)
    init_cost = cost = eq.cost
    lam = torch.full((), config.init_lambda, dtype=dtype, device=device)
    st, dep = state, inv_depth
    accepted = []
    for _ in range(config.max_iters):
        dc, dl, dg = solve_damped(eq, problem.lm_valid, problem.fixed_cols,
                                  lam, config.ridge, problem.line_valid)
        new_st = st.boxplus(dc)
        new_dep = dep + dl
        new_orth = line_geom.orth_boxplus(orth, dg) if has_lines else None
        new_eq = build_normal_equations(new_st, new_dep, problem, config,
                                        new_orth)
        new_cost = new_eq.cost
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        lam = torch.clamp(
            torch.where(accept, lam * config.lambda_down,
                        lam * config.lambda_up),
            config.min_lambda, config.max_lambda)
        st = _select(accept, new_st, st)
        dep = torch.where(accept, new_dep, dep)
        if has_lines:
            orth = torch.where(accept, new_orth, orth)
        cost = torch.where(accept, new_cost, cost)
        eq = _select(accept, new_eq, eq)
        accepted.append(accept)
    acc = torch.stack(accepted) if accepted else torch.zeros(
        0, dtype=torch.bool, device=device)
    info = SolveInfo(init_cost, cost, lam, acc)
    if has_lines:
        return st, dep, orth, info
    return st, dep, info
