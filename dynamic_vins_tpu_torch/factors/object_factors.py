"""Per-object (instance) factors for dynamic-object state estimation.

The active factor set of the reference's loosely-coupled object
optimizer (`estimator/estimator_insts.cpp:1018`
AddResidualBlockForInstOpt): BoxDimsFactor (`factor/box_factor.h:221`),
BoxOrientationFactor (`:237`), BoxEncloseStereoPointFactor (`:155`, the
hinge max(0, |p_obj| - dims/2) * 10, box_factor.cpp:523-560), plus an
object-point reprojection factor and a constant-twist motion factor
(the reference's dormant ProjInst* and speed factors).

All residuals are plain differentiable torch functions of one object;
the object solver (solver/object_solver.py) takes their Jacobians with
`torch.func.jacfwd` over the object tangent and vmaps them over objects.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynamic_vins_tpu_torch.geometry import lie

ENCLOSE_WEIGHT = 10.0


class ObjectWindow(NamedTuple):
    """State of one object across the window (leading axes batch)."""

    p: torch.Tensor      # [F,3] object position (world)
    q: torch.Tensor      # [F,4] object orientation (world)
    v: torch.Tensor      # [3] linear velocity (world)
    w: torch.Tensor      # [3] angular velocity (world, axis*rate)
    dims: torch.Tensor   # [3] box dims (full extents x,y,z)
    c_off: torch.Tensor  # [3] body-fixed offset of the extra-point cloud
                         # centroid (anchors the depth/scale gauge)

    @classmethod
    def make(cls, p, q, v, w, dims, c_off=None):
        if c_off is None:
            c_off = torch.zeros(3, dtype=p.dtype, device=p.device)
        return cls(p, q, v, w, dims, c_off)


def box_dims_residual(dims, dims_det, weight: float = 1.0):
    """Prior pulling dims toward the 3D detection (BoxDimsFactor)."""
    return weight * (dims - dims_det)


def box_orientation_residual(q_wo, q_wo_det, weight: float = 1.0):
    """Rotation residual against the detected box orientation
    (BoxOrientationFactor)."""
    dq = lie.quat_multiply(lie.quat_conjugate(q_wo_det), q_wo)
    return weight * lie.quat_log(dq)


def box_enclose_residual(p_wo, q_wo, dims, pts_w, valid,
                         weight: float = ENCLOSE_WEIGHT):
    """Hinge: object-frame points must lie inside the box
    (BoxEncloseStereoPointFactor). pts_w [N,3] world points of one
    frame -> [N,3]."""
    p_ow, q_ow = lie.pose_inverse(p_wo, q_wo)
    p_obj = lie.quat_rotate(q_ow[None, :], pts_w) + p_ow[None, :]
    r = torch.clamp_min(torch.abs(p_obj) - dims[None, :] / 2.0, 0.0)
    return weight * torch.where(valid[:, None], r, 0.0)


def object_point_reprojection_residual(p_wo_j, q_wo_j, pts_obj,
                                       p_cw_j, q_cw_j, obs_norm, valid,
                                       sqrt_info: float = 460.0 / 1.5):
    """Rigid object-frame points pts_obj [N,3] reprojected into camera j
    against normalized observations obs_norm [N,2] -> [N,2]."""
    pts_w = lie.quat_rotate(q_wo_j[None, :], pts_obj) + p_wo_j[None, :]
    pts_c = lie.quat_rotate(q_cw_j[None, :], pts_w) + p_cw_j[None, :]
    z = torch.clamp_min(pts_c[:, 2:3], 1e-3)
    r = sqrt_info * (pts_c[:, :2] / z - obs_norm)
    return torch.where(valid[:, None], r, 0.0)


def const_twist_residual(p_wo, q_wo, v, w, times, valid,
                         weight_p: float = 5.0, weight_q: float = 2.0):
    """Constant-twist motion across the window (T_j = [exp(w dt), v dt]
    o T_i, basic/velocity.h:33-40): one [6] residual per consecutive
    pair of frames, zero unless both are valid -> [F-1,6]."""
    dt = (times[1:] - times[:-1])[:, None]
    dq = lie.so3_exp_quat(w[None, :] * dt)
    p_pred = p_wo[:-1] + v[None, :] * dt
    q_pred = lie.quat_multiply(dq, q_wo[:-1])
    r_p = weight_p * (p_wo[1:] - p_pred)
    r_q = weight_q * lie.quat_log(
        lie.quat_multiply(lie.quat_conjugate(q_pred), q_wo[1:]))
    pair_valid = (valid[1:] & valid[:-1])[:, None]
    return torch.where(pair_valid, torch.cat([r_p, r_q], -1), 0.0)
