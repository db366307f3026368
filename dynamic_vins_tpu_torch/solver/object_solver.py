"""Per-object bundle adjustment, vmapped across all tracked objects.

The reference's InstanceManager::Optimization
(`estimator/estimator_insts.cpp:772`: one Ceres problem per object per
frame, loosely coupled, the camera states fixed). Every object's window
problem has the same static shape, so all objects solve at once: one
LM over each object's tangent, `torch.func.vmap`ped over the objects,
with the Jacobian from `torch.func.jacfwd` at the zero tangent. The
`max_iters` iterations are unrolled and accept or reject with
`torch.where`; the Jacobi-scaled normal equations go through
`torch.linalg.cholesky_ex` (no host check; a failed factorization
rejects the step) and two triangular solves. Nothing reads the device
on the host, so the solve can be captured as one CUDA graph.

Object tangent: [dpose 6 x F, dv 3, dw 3, ddims 3, dc_off 3,
dlm 3 x Lo].
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from dynamic_vins_tpu_torch.factors import object_factors as of
from dynamic_vins_tpu_torch.geometry import lie


class ObjectProblem(NamedTuple):
    """Factor data for ONE object (vmap adds the leading object axis)."""

    # stereo observations of object landmarks (normalized)
    obs_frame: torch.Tensor    # [No] int64
    obs_cam: torch.Tensor      # [No] int64 (0 left, 1 right)
    obs_lm: torch.Tensor       # [No] int64
    obs_norm: torch.Tensor     # [No,2]
    obs_valid: torch.Tensor    # [No] bool
    # per-frame "extra point" clouds (world frame) for the enclose hinge
    extra_pts: torch.Tensor    # [F,Ne,3]
    extra_valid: torch.Tensor  # [F,Ne]
    # detections
    dims_det: torch.Tensor     # [3]
    dims_det_valid: torch.Tensor   # []
    q_det: torch.Tensor        # [F,4] detected orientation per frame
    det_valid: torch.Tensor    # [F]
    # bookkeeping
    frame_valid: torch.Tensor  # [F] object tracked in frame
    lm_valid: torch.Tensor     # [Lo]
    lm_prior: torch.Tensor     # [Lo,3] triangulated object-frame points
    times: torch.Tensor        # [F]
    # ego camera poses (world->camera) per frame and camera, fixed
    p_cw: torch.Tensor         # [F,2,3]
    q_cw: torch.Tensor         # [F,2,4]


class ObjectSolverConfig(NamedTuple):
    max_iters: int = 6
    init_lambda: float = 1e-3
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    huber_delta: float = 2.0
    use_motion_model: bool = True
    use_reprojection: bool = True
    dims_weight: float = 5.0
    orient_weight: float = 1.0
    centroid_weight: float = 50.0
    extra_centroid_weight: float = 20.0
    landmark_prior_weight: float = 5.0
    ridge: float = 1e-6


def _tangent_dim(F: int, Lo: int):
    return 6 * F + 12 + 3 * Lo


def _apply_delta(state: of.ObjectWindow, pts_obj, delta, F, Lo):
    dpose = delta[: 6 * F].reshape(F, 6)
    p, q = lie.pose_boxplus(state.p, state.q, dpose)
    v = state.v + delta[6 * F: 6 * F + 3]
    w = state.w + delta[6 * F + 3: 6 * F + 6]
    dims = state.dims + delta[6 * F + 6: 6 * F + 9]
    c_off = state.c_off + delta[6 * F + 9: 6 * F + 12]
    lm = pts_obj + delta[6 * F + 12:].reshape(Lo, 3)
    return of.ObjectWindow(p, q, v, w, dims, c_off), lm


def _residuals(state: of.ObjectWindow, pts_obj, prob: ObjectProblem,
               cfg: ObjectSolverConfig):
    parts = []
    if cfg.use_reprojection:
        p_wo_j = state.p[prob.obs_frame]
        q_wo_j = state.q[prob.obs_frame]
        p_cw_j = prob.p_cw[prob.obs_frame, prob.obs_cam]
        q_cw_j = prob.q_cw[prob.obs_frame, prob.obs_cam]
        lm = pts_obj[prob.obs_lm]
        valid = (prob.obs_valid & prob.lm_valid[prob.obs_lm]
                 & prob.frame_valid[prob.obs_frame])
        pts_w = lie.quat_rotate(q_wo_j, lm) + p_wo_j
        pts_c = lie.quat_rotate(q_cw_j, pts_w) + p_cw_j
        z = torch.clamp_min(pts_c[:, 2:3], 1e-3)
        r = (460.0 / 1.5) * (pts_c[:, :2] / z - prob.obs_norm)
        r = torch.where(valid[:, None], r, 0.0)
        rn2 = torch.sum(r * r, -1, keepdim=True)        # Huber
        hw = torch.where(rn2 <= cfg.huber_delta ** 2, 1.0, torch.sqrt(
            cfg.huber_delta / torch.sqrt(torch.clamp_min(rn2, 1e-12))))
        parts.append((r * hw).reshape(-1))

    # the enclose hinge of every frame, frame-major
    p_ow, q_ow = lie.pose_inverse(state.p, state.q)       # [F,3], [F,4]
    p_obj = lie.quat_rotate(q_ow[:, None, :], prob.extra_pts) \
        + p_ow[:, None, :]
    hinge = torch.clamp_min(torch.abs(p_obj) - state.dims / 2.0, 0.0)
    enc_valid = prob.extra_valid & prob.frame_valid[:, None]
    parts.append((of.ENCLOSE_WEIGHT
                  * torch.where(enc_valid[..., None], hinge, 0.0))
                 .reshape(-1))

    r_dims = of.box_dims_residual(state.dims, prob.dims_det,
                                  cfg.dims_weight)
    parts.append(torch.where(prob.dims_det_valid, r_dims, 0.0))

    r_orient = of.box_orientation_residual(state.q, prob.q_det,
                                           cfg.orient_weight)
    r_orient = torch.where((prob.det_valid & prob.frame_valid)[:, None],
                           r_orient, 0.0)
    parts.append(r_orient.reshape(-1))

    if cfg.use_motion_model:
        parts.append(of.const_twist_residual(
            state.p, state.q, state.v, state.w, prob.times,
            prob.frame_valid).reshape(-1))

    # stereo-cloud anchor: each frame's extra-point centroid is the
    # body-fixed point c_off of the object (breaks the mono depth x
    # landmark-scale near-gauge with the world-anchored stereo clouds)
    n_extra = torch.sum(prob.extra_valid, dim=1)
    ne = torch.clamp_min(n_extra, 1)[:, None]
    cent_w = torch.sum(torch.where(prob.extra_valid[..., None],
                                   prob.extra_pts, 0.0), dim=1) / ne
    cent_pred = lie.quat_rotate(state.q, state.c_off[None, :]) + state.p
    has_extra = (n_extra > 3) & prob.frame_valid
    r_cent = cfg.extra_centroid_weight * (cent_w - cent_pred)
    parts.append(torch.where(has_extra[:, None], r_cent, 0.0).reshape(-1))

    # landmarks stay near their triangulated init (sigma ~ 20 cm)
    r_lm = cfg.landmark_prior_weight * (pts_obj - prob.lm_prior)
    parts.append(torch.where(prob.lm_valid[:, None], r_lm, 0.0)
                 .reshape(-1))

    # gauge: the object-frame origin at the landmark centroid
    nlm = torch.clamp_min(torch.sum(prob.lm_valid), 1)
    centroid = torch.sum(torch.where(prob.lm_valid[:, None], pts_obj, 0.0),
                         dim=0) / nlm
    parts.append(cfg.centroid_weight * centroid)
    return torch.cat(parts)


def solve_one(state: of.ObjectWindow, pts_obj, prob: ObjectProblem,
              cfg: ObjectSolverConfig, active):
    """LM for one object -> (state, landmarks, cost). `active`: [] bool;
    an inactive object keeps its state."""
    F = state.p.shape[0]
    Lo = pts_obj.shape[0]
    D = _tangent_dim(F, Lo)
    dtype, dev = state.p.dtype, state.p.device

    def cost_of(st, lm):
        r = _residuals(st, lm, prob, cfg)
        return 0.5 * torch.sum(r * r)

    st, lm = state, pts_obj
    lam = torch.full((), cfg.init_lambda, dtype=dtype, device=dev)
    cost = cost_of(st, lm)
    zero = torch.zeros((D,), dtype=dtype, device=dev)
    for _ in range(cfg.max_iters):
        def res_local(delta, st=st, lm=lm):
            st2, lm2 = _apply_delta(st, lm, delta, F, Lo)
            return _residuals(st2, lm2, prob, cfg)

        r = res_local(zero)
        J = jacfwd(res_local)(zero)
        H = J.T @ J
        g = J.T @ r
        diag = torch.diagonal(H)
        damped = diag * (1.0 + lam) + cfg.ridge
        damped = torch.where(diag <= 0.0, 1.0, damped)
        H = H + torch.diag_embed(damped - diag)
        scale = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(H), 1e-12))
        Hs = H * scale[:, None] * scale[None, :]
        L, info = torch.linalg.cholesky_ex(Hs)
        # two triangular solves (cuBLAS trsm on the card): the batched
        # cholesky_solve allocates device memory inside, which stream
        # capture refuses
        y = torch.linalg.solve_triangular(L, (scale * g)[:, None],
                                          upper=False)
        delta = -scale * torch.linalg.solve_triangular(L.mT, y,
                                                       upper=True)[:, 0]
        st2, lm2 = _apply_delta(st, lm, delta, F, Lo)
        new_cost = cost_of(st2, lm2)
        accept = (new_cost < cost) & torch.isfinite(new_cost) \
            & (info == 0) & active
        lam = torch.clamp(torch.where(accept, lam * cfg.lambda_down,
                                      lam * cfg.lambda_up), 1e-10, 1e8)
        st = of.ObjectWindow(*(torch.where(accept, a, b)
                               for a, b in zip(st2, st)))
        lm = torch.where(accept, lm2, lm)
        cost = torch.where(accept, new_cost, cost)
    return st, lm, cost


def solve_all(states: of.ObjectWindow, pts_obj, probs: ObjectProblem,
              cfg: ObjectSolverConfig, active):
    """solve_one vmapped over the leading object axis of every argument."""
    return vmap(lambda s, l, p, a: solve_one(s, l, p, cfg, a))(
        states, pts_obj, probs, active)
