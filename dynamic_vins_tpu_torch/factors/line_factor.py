"""Line reprojection factor in the 4-dof orthonormal parameterization.

The residual is the distance of the two observed normalized endpoints
to the projected infinite line; Jacobians w.r.t. the 16-dim local
tangent [dpose_j 6, dex 6, dorth 4] come from `torch.func.jacfwd` at the
zero tangent, vmapped over the observation rows. Lines live in the
world frame (no anchor); their 4 orth columns are appended after the
camera block by the solver (`solver/gauss_newton.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from dynamic_vins_tpu_torch.geometry import lie, lines
from dynamic_vins_tpu_torch.solver import layout

LINE_SQRT_INFO = 460.0 / 1.5


class LineObs(NamedTuple):
    """Fixed-capacity line observation table."""

    frame_j: torch.Tensor   # [N] observing frame
    cam_j: torch.Tensor     # [N] 0 left / 1 right
    line: torch.Tensor      # [N] line slot
    s: torch.Tensor         # [N,3] observed start point (normalized, z=1)
    e: torch.Tensor         # [N,3] observed end point
    valid: torch.Tensor     # [N] bool


def unpack_obs(l_oi, l_of, valid):
    """LineObs from the packed arrays: l_oi [C,3] ints (frame, cam,
    slot), l_of [C,4] (start xy, end xy)."""
    one = torch.ones((l_of.shape[0], 1), dtype=l_of.dtype,
                     device=l_of.device)
    oi = l_oi.long()
    return LineObs(frame_j=oi[:, 0], cam_j=oi[:, 1], line=oi[:, 2],
                   s=torch.cat([l_of[:, 0:2], one], dim=1),
                   e=torch.cat([l_of[:, 2:4], one], dim=1), valid=valid)


def _residual_row(delta, p_j, q_j, p_bc, q_bc, orth, s, e, sqrt_info):
    """One row's residual [2] at the tangent delta [16] = [dpose_j 6,
    dex 6, dorth 4]."""
    p_j, q_j = lie.pose_boxplus(p_j, q_j, delta[0:6])
    p_bc, q_bc = lie.pose_boxplus(p_bc, q_bc, delta[6:12])
    n_w, d_w = lines.orth_to_plucker(lines.orth_boxplus(orth, delta[12:16]))
    # world -> body -> camera
    n_b, d_b = lines.transform_line(n_w, d_w, *lie.pose_inverse(p_j, q_j))
    n_c, _ = lines.transform_line(n_b, d_b, *lie.pose_inverse(p_bc, q_bc))
    l = lines.project_line(n_c)
    return sqrt_info * torch.stack([lines.line_point_distance(l, s),
                                    lines.line_point_distance(l, e)])


def _rows(state: layout.WindowState, line_orth, obs: LineObs):
    return (state.p[obs.frame_j], state.q[obs.frame_j],
            state.p_bc[obs.cam_j], state.q_bc[obs.cam_j],
            line_orth[obs.line], obs.s, obs.e)


def _zero(obs: LineObs, n: int, like):
    return torch.zeros((obs.frame_j.shape[0], n), dtype=like.dtype,
                       device=like.device)


def evaluate(state: layout.WindowState, line_orth, obs: LineObs,
             sqrt_info: float = LINE_SQRT_INFO):
    """Residuals [N,2], camera Jacobians [N,2,12], orth Jacobians
    [N,2,4] and camera column indices [N,12]; invalid rows are zeroed.
    The orth columns are block `obs.line` of the line column space."""
    F = state.num_frames
    rows = _rows(state, line_orth, obs)
    zero = _zero(obs, 16, state.p)
    f = lambda d, *a: _residual_row(d, *a, sqrt_info=sqrt_info)
    r = vmap(f)(zero, *rows)
    J = _jacobian(f, zero, rows)
    r = torch.where(obs.valid[:, None], r, 0.0)
    J = torch.where(obs.valid[:, None, None], J, 0.0)
    base = torch.arange(6, device=obs.frame_j.device)
    cols = torch.cat([layout.pose_col(obs.frame_j)[:, None] + base,
                      layout.extrinsic_col(obs.cam_j, F)[:, None] + base],
                     dim=1)
    return r, J[:, :, :12], J[:, :, 12:16], cols


def residual_only(state: layout.WindowState, line_orth, obs: LineObs,
                  sqrt_info: float = LINE_SQRT_INFO):
    r = vmap(lambda d, *a: _residual_row(d, *a, sqrt_info=sqrt_info))(
        _zero(obs, 16, state.p), *_rows(state, line_orth, obs))
    return torch.where(obs.valid[:, None], r, 0.0)


def _jacobian(f, zero, rows):
    """vmap(jacfwd(f)) at the zero tangent, evaluated in float64 and
    returned in the rows' type: under forward mode a float32 row's 0-d
    steps (the components of a quaternion against Python constants)
    carry float64 tangents, which a matmul refuses to mix."""
    dt = zero.dtype
    if dt == torch.float64:
        return vmap(jacfwd(f))(zero, *rows)
    up = lambda t: t.double() if t.is_floating_point() else t
    return vmap(jacfwd(f))(zero.double(), *map(up, rows)).to(dt)


def _residual_orth(dorth, p_j, q_j, p_bc, q_bc, orth, s, e, sqrt_info):
    """The residual as a function of the 4-dof orth update only."""
    delta = torch.cat([torch.zeros(12, dtype=dorth.dtype,
                                   device=dorth.device), dorth])
    return _residual_row(delta, p_j, q_j, p_bc, q_bc, orth, s, e,
                         sqrt_info)


def spd_cholesky(A):
    """Lower Cholesky factor of a batch of small SPD matrices [...,n,n],
    unrolled in elementwise torch ops: no host synchronization, no
    library workspace, so a CUDA graph captures it (the batched
    `torch.linalg` solvers check their info on the host). Pivots are
    floored at 1e-30, so a singular block gives huge values, not NaN."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp_min(s, 1e-30))
        L[j][j] = d
        for i in range(j + 1, n):
            t = A[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t / d
    zero = torch.zeros_like(A[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero
                                     for j in range(n)], dim=-1)
                        for i in range(n)], dim=-2)


def spd_solve(A, b):
    """x = A^-1 b for a batch of small SPD matrices A [...,n,n] and
    right-hand sides b [...,n,m], through `spd_cholesky` and two
    triangular substitutions in elementwise ops."""
    L = spd_cholesky(A)
    n = A.shape[-1]
    y = []
    for i in range(n):
        t = b[..., i, :]
        for k in range(i):
            t = t - L[..., i, k, None] * y[k]
        y.append(t / L[..., i, i, None])
    x = [None] * n
    for i in reversed(range(n)):
        t = y[i]
        for k in range(i + 1, n):
            t = t - L[..., k, i, None] * x[k]
        x[i] = t / L[..., i, i, None]
    return torch.stack(x, dim=-2)


def refine_orth(state: layout.WindowState, line_orth, obs: LineObs,
                line_valid, iters: int = 5, huber_delta: float = 1.0,
                damping: float = 1e-4, sqrt_info: float = LINE_SQRT_INFO):
    """Line-only optimization with the window poses held fixed (the
    reference's OptimizationWithOnlyLine): fresh triangulations reach
    the joint solve at a good linearization point. With the poses fixed
    every line is independent: a damped Gauss-Newton over [Lc,4,4]
    blocks, one batched 4x4 solve an iteration, a step kept per line
    only where it lowers that line's cost. Invalid slots pass through."""
    from dynamic_vins_tpu_torch.solver import gauss_newton as gn

    Lc = line_orth.shape[0]
    dtype, device = line_orth.dtype, line_orth.device
    valid = obs.valid & line_valid[obs.line]
    wv = valid.to(dtype)
    eye4 = torch.eye(4, dtype=dtype, device=device)
    fixed = (state.p[obs.frame_j], state.q[obs.frame_j],
             state.p_bc[obs.cam_j], state.q_bc[obs.cam_j])
    zero4 = _zero(obs, 4, line_orth)
    f = lambda d, p, q, pb, qb, o, s, e: _residual_orth(
        d, p, q, pb, qb, o, s, e, sqrt_info)

    def per_line_cost(orth):
        r = vmap(f)(zero4, *fixed, orth[obs.line], obs.s, obs.e)
        c = gn._huber_cost(torch.sum(r * r, dim=-1), huber_delta) * wv
        return gn._segment_sum(c, obs.line, Lc)

    ok = (gn._segment_sum(wv, obs.line, Lc) > 0) & line_valid
    orth, cost = line_orth, per_line_cost(line_orth)
    for _ in range(iters):
        rows = (*fixed, orth[obs.line], obs.s, obs.e)
        r = torch.where(valid[:, None], vmap(f)(zero4, *rows), 0.0)
        J = torch.where(valid[:, None, None], _jacobian(f, zero4, rows),
                        0.0)
        w = gn._huber_weight(torch.sum(r * r, dim=-1), huber_delta)
        r = r * w[:, None]
        J = J * w[:, None, None]
        H = gn._segment_sum(torch.einsum("nri,nrj->nij", J, J), obs.line, Lc)
        g = gn._segment_sum(torch.einsum("nri,nr->ni", J, r), obs.line, Lc)
        dg = torch.diagonal(H, dim1=-2, dim2=-1)
        H = H + (damping * dg + 1e-8)[..., None] * eye4
        # lines with no observations get identity blocks (delta = 0)
        H = torch.where(ok[:, None, None], H, eye4)
        g = torch.where(ok[:, None], g, 0.0)
        cand = lines.orth_boxplus(orth, -spd_solve(H, g[..., None])[..., 0])
        new_cost = per_line_cost(cand)
        better = ok & (new_cost < cost) & torch.isfinite(new_cost)
        orth = torch.where(better[:, None], cand, orth)
        cost = torch.where(better, new_cost, cost)
    return orth


def line_scores(state: layout.WindowState, line_orth, obs: LineObs,
                line_valid=None):
    """Per-line mean endpoint-to-line distance on the normalized plane
    [Lc] over the valid rows (of valid lines, where given)."""
    from dynamic_vins_tpu_torch.solver import gauss_newton as gn

    err = torch.mean(torch.abs(residual_only(state, line_orth, obs,
                                             sqrt_info=1.0)), dim=-1)
    Lc = line_orth.shape[0]
    v = obs.valid if line_valid is None else \
        obs.valid & line_valid[obs.line]
    w = v.to(err.dtype)
    return gn._segment_sum(err * w, obs.line, Lc) / torch.clamp_min(
        gn._segment_sum(w, obs.line, Lc), 1.0)
