"""Simulated frontend: per-frame estimator inputs from a sequence.

A deterministic, image-free source of features (feature-domain runs)
and of the per-frame IMU intervals every run needs.
"""

from __future__ import annotations

import numpy as np

from dynamic_vins_tpu_torch.estimator.estimator import FrameFeatures
from dynamic_vins_tpu_torch.sim import synthetic as sim


def imu_intervals(seq: sim.SyntheticSequence):
    """(acc [M+1,3], gyr [M+1,3], dt [M]) per frame: the samples since
    the previous frame (frame 0 gets a 1-sample interval for gravity)."""
    F = seq.frame_times.shape[0]
    ipf = round(float((seq.imu_times.shape[0] - 1) / (F - 1)))
    acc, gyr, t = (seq.acc.numpy(), seq.gyr.numpy(),
                   seq.imu_times.numpy())
    out = []
    for k in range(F):
        a, b = (0, 1) if k == 0 else ((k - 1) * ipf, k * ipf)
        out.append((acc[a:b + 1], gyr[a:b + 1], np.diff(t[a:b + 1])))
    return out


def make_frames(seq: sim.SyntheticSequence, max_feats: int = 150,
                pixel_noise: float = 0.0, stereo: bool = True, seed=0):
    """[(FrameFeatures, imu_interval)] per frame from exact projections
    (+ optional pixel noise, same draws as the JAX package's)."""
    rng = np.random.default_rng(seed)
    _, vis_l, ptc_l = sim.observe(seq.rig, seq.gt_p, seq.gt_q,
                                  seq.landmarks, cam=0)
    _, vis_r, ptc_r = sim.observe(seq.rig, seq.gt_p, seq.gt_q,
                                  seq.landmarks, cam=1)
    vis_l, vis_r = vis_l.numpy(), vis_r.numpy()
    ptc_l, ptc_r = ptc_l.numpy(), ptc_r.numpy()

    def norm_pt(ptc):
        xy = ptc[:2] / ptc[2]
        if pixel_noise > 0:
            xy = xy + rng.normal(scale=pixel_noise / 460.0, size=2)
        return np.array([xy[0], xy[1], 1.0])

    out = []
    for k, imu in enumerate(imu_intervals(seq)):
        feats = {}
        for l in np.flatnonzero(vis_l[k])[:max_feats]:
            pl = norm_pt(ptc_l[k, l])
            if stereo and vis_r[k, l]:
                feats[int(l)] = (pl, np.zeros(3), norm_pt(ptc_r[k, l]),
                                 np.zeros(3))
            else:
                feats[int(l)] = (pl, np.zeros(3), None, None)
        out.append((FrameFeatures(float(seq.frame_times[k]), feats), imu))
    return out


def make_line_segments(num: int = 40, seed: int = 9):
    """World segments (s_w, e_w [num,3]) 2 m long, centred on landmarks
    around the trajectory (the JAX package's draws)."""
    rng = np.random.default_rng(seed)
    centers = sim.make_landmarks(num, seed=seed).numpy()
    dirs = rng.normal(size=(num, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return centers - dirs, centers + dirs


def line_obs_for_frame(seq: sim.SyntheticSequence, k: int, s_w, e_w, rng,
                       noise: float = 0.3):
    """Frame k's line observations {line id: (s_l, e_l, s_r|None,
    e_r|None)}: the world segments projected into the left and right
    cameras with `noise` px of endpoint noise (the estimator's line
    format; segments behind 0.5 m or leaving the image are dropped)."""
    from dynamic_vins_tpu_torch.geometry import lie_np

    rig = seq.rig
    pr, qr = rig.right_extrinsics()
    extr = [(rig.p_bc.numpy(), rig.q_bc.numpy()), (pr.numpy(), qr.numpy())]
    p, q = seq.gt_p[k].numpy(), seq.gt_q[k].numpy()
    out = {}
    for l in range(len(s_w)):
        obs = []
        for p_bc, q_bc in extr:
            p_cw, q_cw = lie_np.pose_inverse(*lie_np.pose_compose(p, q, p_bc,
                                                                  q_bc))
            sc = lie_np.pose_transform_point(p_cw, q_cw, s_w[l])
            ec = lie_np.pose_transform_point(p_cw, q_cw, e_w[l])
            if sc[2] < 0.5 or ec[2] < 0.5:
                obs.append(None)
                continue
            sn = sc[:2] / sc[2] + rng.normal(scale=noise / 460, size=2)
            en = ec[:2] / ec[2] + rng.normal(scale=noise / 460, size=2)
            if np.abs(sn).max() > 0.9:
                obs.append(None)
                continue
            obs.append((np.append(sn, 1.0), np.append(en, 1.0)))
        if obs[0] is not None:
            sr, er = obs[1] if obs[1] is not None else (None, None)
            out[l] = (obs[0][0], obs[0][1], sr, er)
    return out


def ate_rmse(est_p, gt_p):
    """Unaligned ATE RMSE (trajectories share their origin)."""
    d = np.asarray(est_p) - np.asarray(gt_p)
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))
