"""Synthetic sliding-window BA problems from the simulator.

Ground-truth `WindowState` + observation tables in the solver's
fixed-capacity format, as the frontend feeds the estimator (a landmark
anchored at its first observation; mono two-frame, stereo one-frame and
stereo two-frame rows: the three projection-factor variants). The noise
comes from numpy's `default_rng(seed + 1)` and the perturbation from
`default_rng(seed)` in the JAX package's call order, so a problem equals
the JAX one for the same arguments.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dynamic_vins_tpu_torch.factors import prior as prior_factor
from dynamic_vins_tpu_torch.factors.projection import ProjObs
from dynamic_vins_tpu_torch.geometry import lie
from dynamic_vins_tpu_torch.imu import preintegration as pre
from dynamic_vins_tpu_torch.sim import synthetic as sim
from dynamic_vins_tpu_torch.solver import gauss_newton as gn
from dynamic_vins_tpu_torch.solver import layout


class SyntheticBA(NamedTuple):
    gt_state: layout.WindowState
    gt_inv_depth: torch.Tensor
    problem: gn.BAProblem
    seq: sim.SyntheticSequence


def build(num_frames: int = 6, num_landmarks: int = 120,
          obs_capacity: int = 4096, lm_capacity: int = 256,
          pixel_noise: float = 0.0, seed: int = 0,
          imu_hz: float = 200.0, frame_hz: float = 10.0,
          stereo: bool = True, fix_first_pose: bool = True,
          dtype=torch.float64, device="cpu") -> SyntheticBA:
    """The problem's tensors on `device` in `dtype` (the sequence stays
    the simulator's float64 on the CPU)."""
    seq = sim.generate_sequence(num_frames=num_frames, frame_hz=frame_hz,
                                imu_hz=imu_hz, num_landmarks=num_landmarks,
                                seed=seed)
    rig = seq.rig
    F = num_frames
    rng = np.random.default_rng(seed + 1)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    _, vis_l, ptc_l = sim.observe(rig, seq.gt_p, seq.gt_q, seq.landmarks, 0)
    _, vis_r, ptc_r = sim.observe(rig, seq.gt_p, seq.gt_q, seq.landmarks, 1)
    vis_l, vis_r = vis_l.numpy(), vis_r.numpy()
    ptc_l, ptc_r = ptc_l.numpy(), ptc_r.numpy()

    def norm_pt(ptc, noise):
        xy = ptc[..., :2] / ptc[..., 2:3]
        if pixel_noise > 0:
            xy = xy + noise / 460.0
        return np.concatenate([xy, np.ones_like(xy[..., :1])], axis=-1)

    noise_l = rng.normal(scale=pixel_noise, size=ptc_l[..., :2].shape)
    noise_r = rng.normal(scale=pixel_noise, size=ptc_r[..., :2].shape)
    pts_l = norm_pt(ptc_l, noise_l)
    pts_r = norm_pt(ptc_r, noise_r)

    rows = []          # (frame_i, frame_j, cam_j, slot, pt_i, pt_j)
    gt_inv_depth = np.zeros(lm_capacity)
    lm_valid = np.zeros(lm_capacity, bool)
    next_slot = 0
    for l in range(num_landmarks):
        frames_seen = [k for k in range(F) if vis_l[k, l]]
        if len(frames_seen) < 2:
            continue
        if next_slot >= lm_capacity:
            break
        anchor, slot = frames_seen[0], next_slot
        next_slot += 1
        gt_inv_depth[slot] = 1.0 / ptc_l[anchor, l, 2]
        lm_valid[slot] = True
        pi = pts_l[anchor, l]
        for k in frames_seen[1:]:
            rows.append((anchor, k, 0, slot, pi, pts_l[k, l]))
            if stereo and vis_r[k, l]:
                rows.append((anchor, k, 1, slot, pi, pts_r[k, l]))
        if stereo and vis_r[anchor, l]:
            rows.append((anchor, anchor, 1, slot, pi, pts_r[anchor, l]))

    n = len(rows)
    assert n <= obs_capacity, f"{n} rows exceed capacity {obs_capacity}"
    C = obs_capacity
    ints = np.zeros((4, C), np.int64)
    pt_i, pt_j = np.zeros((C, 3)), np.zeros((C, 3))
    pt_i[:, 2] = pt_j[:, 2] = 1.0          # empty rows: z = 1
    if n:
        ints[:, :n] = np.array([r[:4] for r in rows]).T
        pt_i[:n] = [r[4] for r in rows]
        pt_j[:n] = [r[5] for r in rows]
    i = lambda a: torch.as_tensor(a, device=device)
    obs = ProjObs(frame_i=i(ints[0]), frame_j=i(ints[1]), cam_j=i(ints[2]),
                  lm=i(ints[3]), pt_i=f(pt_i), pt_j=f(pt_j),
                  vel_i=f(np.zeros((C, 3))), vel_j=f(np.zeros((C, 3))),
                  td_ref=f(np.zeros(C)), valid=i(np.arange(C) < n))

    # IMU preintegrations per window edge
    ipf = int(round(imu_hz / frame_hz))
    zeros = torch.zeros(3, dtype=torch.float64)
    edges = [pre.preintegrate(seq.acc[a:a + ipf + 1], seq.gyr[a:a + ipf + 1],
                              torch.diff(seq.imu_times[a:a + ipf + 1]),
                              zeros, zeros)
             for a in range(0, (F - 1) * ipf, ipf)]
    pres = pre.Preintegration(*(f(torch.stack(xs))
                                for xs in zip(*edges)))

    pr, qr = rig.right_extrinsics()
    gt_state = layout.WindowState(
        p=f(seq.gt_p), q=f(seq.gt_q), v=f(seq.gt_v),
        ba=f(np.zeros((F, 3))), bg=f(np.zeros((F, 3))),
        p_bc=f(torch.stack([rig.p_bc, pr])),
        q_bc=f(torch.stack([rig.q_bc, qr])), td=f(0.0))

    fixed = np.zeros(layout.cam_dim(F), bool)
    # never estimate extrinsics/td in synthetic problems
    fixed[layout.extrinsic_col(0, F):layout.td_col(F) + 1] = True
    if fix_first_pose:
        fixed[layout.pose_col(0):layout.pose_col(0) + 6] = True

    problem = gn.BAProblem(
        obs=obs, pres=pres,
        imu_valid=torch.ones(F - 1, dtype=torch.bool, device=device),
        prior=prior_factor.MarginalPrior.empty(F, dtype, device),
        lm_valid=i(lm_valid), fixed_cols=i(fixed))
    return SyntheticBA(gt_state, f(gt_inv_depth), problem, seq)


def perturb_state(state: layout.WindowState, pos_sigma=0.05,
                  rot_sigma=0.02, vel_sigma=0.05, seed=0,
                  skip_first: bool = True):
    rng = np.random.default_rng(seed)
    F = state.num_frames
    dp = rng.normal(scale=pos_sigma, size=(F, 3))
    dth = rng.normal(scale=rot_sigma, size=(F, 3))
    dv = rng.normal(scale=vel_sigma, size=(F, 3))
    if skip_first:
        dp[0] = dth[0] = dv[0] = 0.0
    t = lambda a: torch.as_tensor(a, dtype=state.p.dtype,
                                  device=state.p.device)
    p, q = lie.pose_boxplus(state.p, state.q,
                            t(np.concatenate([dp, dth], -1)))
    return state._replace(p=p, q=q, v=state.v + t(dv))
