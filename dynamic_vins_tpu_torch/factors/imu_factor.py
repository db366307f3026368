"""IMU preintegration factor rows for the window solver.

A whitened 15-dim residual between consecutive window frames; the
Jacobian over the 30-dim local tangent [dpose_i 6, dspeedbias_i 9,
dpose_j 6, dspeedbias_j 9] comes from jacfwd at the zero tangent.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from dynamic_vins_tpu_torch.geometry import lie
from dynamic_vins_tpu_torch.imu import preintegration as pre
from dynamic_vins_tpu_torch.solver import layout


def _residual_edge(delta, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j,
                   bg_j, pre_k: pre.Preintegration, sqrt_info_k, g):
    p_i, q_i = lie.pose_boxplus(p_i, q_i, delta[0:6])
    p_j, q_j = lie.pose_boxplus(p_j, q_j, delta[15:21])
    r = pre.evaluate(pre_k, p_i, q_i, v_i + delta[6:9], ba_i + delta[9:12],
                     bg_i + delta[12:15], p_j, q_j, v_j + delta[21:24],
                     ba_j + delta[24:27], bg_j + delta[27:30], g)
    return sqrt_info_k @ r


def _edge_inputs(state: layout.WindowState):
    a, b = slice(0, -1), slice(1, None)
    return (state.p[a], state.q[a], state.v[a], state.ba[a], state.bg[a],
            state.p[b], state.q[b], state.v[b], state.ba[b], state.bg[b])


def evaluate(state: layout.WindowState, pres: pre.Preintegration, valid):
    """Residuals [E,15], Jacobians [E,15,30], columns [E,30] for the
    E = num_frames-1 edges; edges with valid False are zeroed."""
    F = state.num_frames
    E = F - 1
    dtype, device = state.p.dtype, state.p.device
    g = pre.gravity(dtype, device)
    si = pres.sqrt_info()
    zero = torch.zeros((E, 30), dtype=dtype, device=device)
    f = lambda d, *a: _residual_edge(d, *a, g)
    args = _edge_inputs(state) + (pres, si)
    r = vmap(f)(zero, *args)
    J = vmap(jacfwd(f))(zero, *args)
    r = torch.where(valid[:, None], r, 0.0)
    J = torch.where(valid[:, None, None], J, 0.0)

    ks = torch.arange(E, device=device)
    b6 = torch.arange(6, device=device)
    b9 = torch.arange(9, device=device)
    cols = torch.cat([
        layout.pose_col(ks)[:, None] + b6,
        layout.speedbias_col(ks, F)[:, None] + b9,
        layout.pose_col(ks + 1)[:, None] + b6,
        layout.speedbias_col(ks + 1, F)[:, None] + b9,
    ], dim=1)
    return r, J, cols


def residual_only(state: layout.WindowState, pres: pre.Preintegration,
                  valid):
    E = state.num_frames - 1
    dtype, device = state.p.dtype, state.p.device
    g = pre.gravity(dtype, device)
    zero = torch.zeros((E, 30), dtype=dtype, device=device)
    r = vmap(lambda d, *a: _residual_edge(d, *a, g))(
        zero, *_edge_inputs(state), pres, pres.sqrt_info())
    return torch.where(valid[:, None], r, 0.0)
