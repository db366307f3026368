"""Rendered dynamic stereo scene: moving textured boxes over the static
landmark world, with exact instance masks, disparity and 3D detections.

The inputs the reference's perception stack gives a frame (SOLOv2
instance masks, LEAStereo disparity, FCOS3D camera-frame boxes;
`image_process.cpp:105-238`), made exactly consistent with the ground
truth ego trajectory and constant-velocity objects, so that the DYNAMIC
System (masks -> MOT -> instance tracker -> instance manager -> object
BA) runs without a dataset on disk. The JAX package's
`sim/dynamic_scene.py` in torch: the same seed gives the same objects
and masks.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from dynamic_vins_tpu_torch.geometry import lie
from dynamic_vins_tpu_torch.io import perception
from dynamic_vins_tpu_torch.sim import render
from dynamic_vins_tpu_torch.sim.synthetic import SyntheticSequence


class DynamicFrame(NamedTuple):
    """One frame's perception artifacts for System.process (DYNAMIC)."""

    img_left: np.ndarray            # [H,W] uint8
    img_right: np.ndarray           # [H,W] uint8
    seg: perception.SegResult       # instance masks (left cam)
    boxes3d: List[perception.Box3D]
    disparity: np.ndarray           # [H,W] float32 (0 where unknown)


class SceneObject(NamedTuple):
    track_id: int
    dims_xyz: np.ndarray            # object-frame x(len) y(wid) z(hgt)
    q_wo: np.ndarray                # world<-object (constant: rigid CV)
    gt_p: np.ndarray                # [F,3] center per frame
    tex_pts: np.ndarray             # [T,3] object-frame texture points
    tex_inten: np.ndarray           # [T]


def _np(t):
    return t.detach().cpu().numpy()


def _make_objects(seq: SyntheticSequence, num_objects: int,
                  tex_pts: int, seed: int) -> List[SceneObject]:
    rng = np.random.default_rng(seed)
    times = _np(seq.frame_times)
    F = times.shape[0]
    gt_p0, gt_q0 = seq.gt_p[0].cpu(), seq.gt_q[0].cpu()
    # objects roughly pace the ego so they stay in view (KITTI traffic)
    ego_v = (_np(seq.gt_p[-1]) - _np(gt_p0)) \
        / max(float(times[-1] - times[0]), 1e-6)
    objs = []
    for o in range(num_objects):
        dims = np.array([4.0, 2.0, 1.5]) * rng.uniform(0.85, 1.15)
        v_obj = ego_v + rng.uniform(-0.6, 0.6, 3) * np.array(
            [0.5, 1.0, 0.05])
        offset = np.array([8.0 + 3.5 * o, rng.uniform(-1.5, 1.5), -0.3])
        p0 = _np(gt_p0) + _np(lie.quat_rotate(gt_q0, torch.tensor(offset)))
        q_wo = _np(gt_q0)
        gt_p = np.stack([p0 + v_obj * (times[k] - times[0])
                         for k in range(F)])
        # texture points on the box surface (biased to the faces the
        # camera sees) + a few interior fill points
        t = rng.uniform(-0.5, 0.5, size=(tex_pts, 3))
        face = rng.integers(0, 3, tex_pts)
        sign = rng.choice([-0.5, 0.5], tex_pts)
        t[np.arange(tex_pts), face] = sign
        objs.append(SceneObject(
            9 + o, dims, q_wo, gt_p, t * dims[None, :],
            rng.uniform(140.0, 255.0, tex_pts)))
    return objs


def _box_corners_cam(center_cam, dims_lhw, R_co):
    """8 corners of a camera-frame box: dims in KITTI (l,h,w) camera
    x,y,z extents at yaw=0 (io/perception.Box3D convention)."""
    l, h, w = [float(v) for v in dims_lhw]
    sx = np.array([-1, -1, -1, -1, 1, 1, 1, 1]) * l / 2
    sy = np.array([-1, -1, 1, 1, -1, -1, 1, 1]) * h / 2
    sz = np.array([-1, 1, -1, 1, -1, 1, -1, 1]) * w / 2
    return center_cam[None, :] + (R_co @ np.stack([sx, sy, sz])).T


def make_dynamic_scene(seq: SyntheticSequence, num_objects: int = 2,
                       intensities=None, tex_pts: int = 40, seed: int = 0,
                       sigma: float = 1.6, device=None):
    """Render every frame of `seq` with its perception artifacts ->
    (frames [DynamicFrame], objects [SceneObject]).

    `seq.rig` sets the resolution (render.small_rig). Masks are the
    projected box rectangles (SOLO-like amodal blobs); disparity is
    fx*baseline/z of the nearest object inside a mask, 0 elsewhere.
    Images render on `device` (default the CPU) with blobs of `sigma`
    px."""
    dev = torch.device(device or "cpu")
    rig = seq.rig
    H, W = rig.height, rig.width
    F = int(seq.frame_times.shape[0])
    L = int(seq.landmarks.shape[0])
    inten = intensities if intensities is not None \
        else render.make_intensities(L, seed=seed)
    objs = _make_objects(seq, num_objects, tex_pts, seed)
    fx, fy = float(rig.intr.fx), float(rig.intr.fy)
    cx, cy = float(rig.intr.cx), float(rig.intr.cy)
    baseline = float(rig.baseline)
    all_inten = torch.cat([torch.as_tensor(inten)]
                          + [torch.tensor(o.tex_inten) for o in objs])
    rig_dev = rig.to(dev)
    lms = seq.landmarks.to(dev)
    # camera pose of the left camera (world -> camera) per frame
    p_cw_all, q_cw_all = lie.pose_inverse(*lie.pose_compose(
        seq.gt_p.cpu(), seq.gt_q.cpu(), rig.p_bc.cpu()[None, :],
        rig.q_bc.cpu()[None, :]))

    frames = []
    for k in range(F):
        obj_pts_w = [_np(lie.quat_rotate(torch.tensor(o.q_wo)[None, :],
                                         torch.tensor(o.tex_pts)))
                     + o.gt_p[k][None, :] for o in objs]
        pts_w = torch.cat([lms] + [torch.tensor(p, device=dev)
                                   for p in obj_pts_w])
        p, q = seq.gt_p[k].to(dev), seq.gt_q[k].to(dev)
        img_l, img_r = (
            _np(render.render_frame(rig_dev, p, q, pts_w, all_inten, cam=c,
                                    sigma=sigma)).astype(np.uint8)
            for c in (0, 1))

        # masks + boxes + disparity from the exact geometry (left cam)
        p_cw, q_cw = p_cw_all[k], q_cw_all[k]
        R_cw = _np(lie.quat_to_matrix(q_cw))
        masks, labels, scores, boxes3d = [], [], [], []
        depth = np.full((H, W), np.inf, np.float32)
        for o in objs:
            c_cam = _np(lie.pose_transform_point(
                p_cw, q_cw, torch.tensor(o.gt_p[k])))
            if c_cam[2] < 1.0:
                continue
            R_co = R_cw @ _np(lie.quat_to_matrix(torch.tensor(o.q_wo)))
            # KITTI camera-frame box: x-extent=len, y=height, z=width
            # at yaw=0; the object frame is x=len, y=wid, z=hgt(up)
            R_co_kitti = np.stack([R_co[:, 0], -R_co[:, 2], R_co[:, 1]],
                                  axis=1)
            dims_lhw = np.array([o.dims_xyz[0], o.dims_xyz[2],
                                 o.dims_xyz[1]])
            corners = _box_corners_cam(c_cam, dims_lhw, R_co_kitti)
            z = corners[:, 2]
            if (z <= 0.5).any():
                continue
            u = fx * corners[:, 0] / z + cx
            v = fy * corners[:, 1] / z + cy
            x0, x1 = int(np.floor(u.min())), int(np.ceil(u.max()))
            y0, y1 = int(np.floor(v.min())), int(np.ceil(v.max()))
            x0, y0 = max(x0, 0), max(y0, 0)
            x1, y1 = min(x1, W), min(y1, H)
            if x1 - x0 < 8 or y1 - y0 < 8:
                continue
            m = np.zeros((H, W), bool)
            m[y0:y1, x0:x1] = True
            masks.append(m)
            labels.append(2)             # COCO car
            scores.append(0.9)
            depth[y0:y1, x0:x1] = np.minimum(depth[y0:y1, x0:x1],
                                             float(c_cam[2]))
            yaw = float(np.arctan2(-R_co_kitti[2, 0], R_co_kitti[0, 0]))
            bottom = c_cam.copy()
            bottom[1] += dims_lhw[1] / 2.0
            boxes3d.append(perception.Box3D("Car", 0.9, bottom, dims_lhw,
                                            yaw))

        disp = np.where(np.isfinite(depth),
                        fx * baseline / np.maximum(depth, 1e-3),
                        0.0).astype(np.float32)
        seg = perception.SegResult(
            masks=np.stack(masks) if masks else np.zeros((0, H, W), bool),
            scores=np.asarray(scores, np.float32),
            labels=np.asarray(labels, np.int64))
        frames.append(DynamicFrame(img_l, img_r, seg, boxes3d, disp))
    return frames, objs
