"""Reprojection factors, unified over the reference's three variants.

A landmark is anchored by inverse depth at its first observation (frame
i, left cam) and reprojected into any observing (frame j, cam c) with td
compensation; frame_j == frame_i with cam_j == 1 is the one-frame
two-camera (stereo) factor. Jacobians w.r.t. the 26-dim local tangent
come from `torch.func.jacfwd` at the zero tangent, vmapped over rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from dynamic_vins_tpu_torch.geometry import lie
from dynamic_vins_tpu_torch.solver import layout

FOCAL_LENGTH = 460.0
DEFAULT_SQRT_INFO = FOCAL_LENGTH / 1.5


class ProjObs(NamedTuple):
    """Flat observation table; fixed capacity with a validity mask."""

    frame_i: torch.Tensor   # [N] int64 anchor frame
    frame_j: torch.Tensor   # [N] int64 observing frame
    cam_j: torch.Tensor     # [N] int64 observing camera (0 left, 1 right)
    lm: torch.Tensor        # [N] int64 landmark slot index
    pt_i: torch.Tensor      # [N,3]
    pt_j: torch.Tensor      # [N,3]
    vel_i: torch.Tensor     # [N,3]
    vel_j: torch.Tensor     # [N,3]
    td_ref: torch.Tensor    # [N]
    valid: torch.Tensor     # [N] bool


def _residual_row(delta, p_i, q_i, p_j, q_j, p_bci, q_bci, p_bcj, q_bcj,
                  td, inv_dep, pt_i, pt_j, vel_i, vel_j, td_ref,
                  sqrt_info: float):
    """One row's residual at a local tangent perturbation delta [26] =
    [dpose_i 6, dpose_j 6, dex_i 6, dex_j 6, dtd 1, ddep 1]."""
    p_i, q_i = lie.pose_boxplus(p_i, q_i, delta[0:6])
    p_j, q_j = lie.pose_boxplus(p_j, q_j, delta[6:12])
    p_bci, q_bci = lie.pose_boxplus(p_bci, q_bci, delta[12:18])
    p_bcj, q_bcj = lie.pose_boxplus(p_bcj, q_bcj, delta[18:24])
    td = td + delta[24]
    inv_dep = inv_dep + delta[25]
    pts_i_td = pt_i - (td - td_ref) * vel_i
    pts_j_td = pt_j - (td - td_ref) * vel_j
    pts_cam_i = pts_i_td / torch.clamp_min(inv_dep, 1e-4)
    pts_b_i = lie.quat_rotate(q_bci, pts_cam_i) + p_bci
    pts_w = lie.quat_rotate(q_i, pts_b_i) + p_i
    pts_b_j = lie.quat_rotate(lie.quat_conjugate(q_j), pts_w - p_j)
    pts_cam_j = lie.quat_rotate(lie.quat_conjugate(q_bcj),
                                pts_b_j - p_bcj)
    z = pts_cam_j[2]
    z_safe = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    return sqrt_info * (pts_cam_j[:2] / z_safe - pts_j_td[:2])


def _row_inputs(state: layout.WindowState, inv_depth, obs: ProjObs):
    zeros = torch.zeros_like(obs.cam_j)
    n = obs.frame_i.shape[0]
    return (state.p[obs.frame_i], state.q[obs.frame_i],
            state.p[obs.frame_j], state.q[obs.frame_j],
            state.p_bc[zeros], state.q_bc[zeros],
            state.p_bc[obs.cam_j], state.q_bc[obs.cam_j],
            state.td.expand(n), inv_depth[obs.lm], obs.pt_i, obs.pt_j,
            obs.vel_i, obs.vel_j, obs.td_ref)


def evaluate(state: layout.WindowState, inv_depth, obs: ProjObs,
             sqrt_info: float = DEFAULT_SQRT_INFO):
    """Residuals [N,2], camera Jacobians [N,2,25], depth Jacobians
    [N,2], camera column indices [N,25]. Invalid rows are zeroed."""
    F = state.num_frames
    rows = _row_inputs(state, inv_depth, obs)
    zero = torch.zeros((obs.frame_i.shape[0], 26), dtype=state.p.dtype,
                       device=state.p.device)
    f = lambda d, *a: _residual_row(d, *a, sqrt_info=sqrt_info)
    r = vmap(f)(zero, *rows)
    J = vmap(jacfwd(f))(zero, *rows)
    valid = obs.valid[:, None]
    r = torch.where(valid, r, 0.0)
    J = torch.where(valid[..., None], J, 0.0)

    base = torch.arange(6, device=obs.frame_i.device)
    cols = torch.cat([
        layout.pose_col(obs.frame_i)[:, None] + base,
        layout.pose_col(obs.frame_j)[:, None] + base,
        layout.extrinsic_col(torch.zeros_like(obs.cam_j), F)[:, None]
        + base,
        layout.extrinsic_col(obs.cam_j, F)[:, None] + base,
        torch.full_like(obs.frame_i, layout.td_col(F))[:, None],
    ], dim=1)
    return r, J[:, :, 0:25], J[:, :, 25], cols


def residual_only(state: layout.WindowState, inv_depth, obs: ProjObs,
                  sqrt_info: float = DEFAULT_SQRT_INFO):
    rows = _row_inputs(state, inv_depth, obs)
    zero = torch.zeros((obs.frame_i.shape[0], 26), dtype=state.p.dtype,
                       device=state.p.device)
    r = vmap(lambda d, *a: _residual_row(d, *a, sqrt_info=sqrt_info))(
        zero, *rows)
    return torch.where(obs.valid[:, None], r, 0.0)


def unpack_obs(obs_i, obs_f, valid):
    """ProjObs from the packed arrays: obs_i [C,4] ints (frame_i,
    frame_j, cam_j, lm); obs_f [C,9] (pt_i xy, pt_j xy, vel_i xy, vel_j
    xy, td_ref)."""
    C = obs_i.shape[0]
    one = torch.ones((C, 1), dtype=obs_f.dtype, device=obs_f.device)
    zero = torch.zeros_like(one)
    oi = obs_i.long()
    return ProjObs(
        frame_i=oi[:, 0], frame_j=oi[:, 1], cam_j=oi[:, 2], lm=oi[:, 3],
        pt_i=torch.cat([obs_f[:, 0:2], one], dim=1),
        pt_j=torch.cat([obs_f[:, 2:4], one], dim=1),
        vel_i=torch.cat([obs_f[:, 4:6], zero], dim=1),
        vel_j=torch.cat([obs_f[:, 6:8], zero], dim=1),
        td_ref=obs_f[:, 8], valid=valid)
