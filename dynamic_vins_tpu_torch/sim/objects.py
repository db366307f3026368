"""Synthetic moving-object frontend output for DYNAMIC-mode protocols.

Per frame, the `InstanceManager.push_frame` instance dicts for rigid
boxes moving at constant velocity through a `sim.synthetic` sequence's
scene: the exact-ground-truth stand-in for an object pipeline (instance
masks, LK points, disparity extra points). The randomness is numpy's
`default_rng(seed)` in the JAX package's call order, so the frames
equal the JAX ones for the same sequence and seed.
"""

from __future__ import annotations

import numpy as np

from dynamic_vins_tpu_torch.geometry import lie_np


class ObjectTruth:
    def __init__(self, track_id, dims, v_obj, p0, q0, gt_p):
        self.track_id = track_id
        self.dims = dims
        self.v_obj = v_obj
        self.p0 = p0
        self.q0 = q0
        self.gt_p = gt_p      # [F,3] object center per frame


def make_object_frames(seq, num_objects: int = 1, n_pts: int = 24,
                       pixel_noise: float = 0.5, seed: int = 0,
                       focal: float = 460.0):
    """Returns (frames, truths): frames[k] is the instances dict for
    frame k; truths is a list of ObjectTruth."""
    rng = np.random.default_rng(seed)
    rig = seq.rig
    times = np.asarray(seq.frame_times)
    gt_p = np.asarray(seq.gt_p)
    gt_q = np.asarray(seq.gt_q)
    F = times.shape[0]
    extr = [(np.asarray(rig.p_bc), np.asarray(rig.q_bc)),
            tuple(np.asarray(x) for x in rig.right_extrinsics())]

    # objects roughly pace the ego (road traffic) so they stay in view
    # across the whole sequence
    ego_v = (gt_p[-1] - gt_p[0]) / max(times[-1] - times[0], 1e-6)

    truths = []
    for o in range(num_objects):
        dims = np.array([4.0, 2.0, 1.5]) * rng.uniform(0.8, 1.2)
        v_obj = ego_v + rng.uniform(-1.0, 1.0, 3) * np.array(
            [0.5, 1.0, 0.1])
        offset = np.array([8.0 + 3.0 * o, rng.uniform(-2.0, 2.0), -0.5])
        p0 = gt_p[0] + lie_np.quat_rotate(gt_q[0], offset)
        q0 = gt_q[0].copy()
        obj_p = np.stack([p0 + v_obj * (times[k] - times[0])
                          for k in range(F)])
        truths.append(ObjectTruth(9 + o, dims, v_obj, p0, q0, obj_p))

    pts_obj = []
    for t in truths:
        p = rng.uniform(-0.5, 0.5, size=(n_pts, 3)) * t.dims[None, :]
        p -= p.mean(0, keepdims=True)
        pts_obj.append(p)

    frames = []
    for k in range(F):
        cams = [lie_np.pose_inverse(*lie_np.pose_compose(
            gt_p[k], gt_q[k], *extr[c])) for c in range(2)]
        inst = {}
        for t, pobj in zip(truths, pts_obj):
            feats = {}
            extra = []
            for l in range(n_pts):
                pw_l = lie_np.quat_rotate(t.q0, pobj[l]) + t.gt_p[k]
                obs = []
                for p_cw, q_cw in cams:
                    pc = lie_np.pose_transform_point(p_cw, q_cw, pw_l)
                    obs.append(pc[:2] / pc[2] if pc[2] > 0.5 else None)
                if obs[0] is None:
                    continue
                pl = np.append(obs[0] + rng.normal(
                    scale=pixel_noise / focal, size=2), 1.0)
                pr = None
                if obs[1] is not None:
                    pr = np.append(obs[1] + rng.normal(
                        scale=pixel_noise / focal, size=2), 1.0)
                feats[l] = (pl, pr)
                extra.append(pw_l + rng.normal(scale=0.03, size=3))
            if feats:
                inst[t.track_id] = dict(
                    cls=1, features=feats,
                    extra_pts_world=np.asarray(extra),
                    dims_det=t.dims, q_det=t.q0)
        frames.append(inst)
    return frames, truths
