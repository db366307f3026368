"""System orchestration: perception results -> feature tracker (and, in
DYNAMIC mode, MOT and the instance tracker) -> sliding-window estimator
(and the per-object backend) -> TUM trajectory and KITTI-MOT file.

Built from one `VioConfig` like the JAX package's System, in three
modes: RAW (stereo+IMU, or mono+IMU with `is_stereo` off), NAIVE (the
background tracker gated by a dynamic mask: the frame's `dynamic_mask`,
else the union of its instance masks) and DYNAMIC (instances segmented,
associated by MOT, tracked and estimated as moving objects). With
`use_line` (LinePoint) a host line tracker (OpenCV's LSD reproduced,
`frontend/line_tracker.py`) adds line segments, gated by the same mask,
whose normalized endpoints the estimator keeps as line landmarks. With
`VioConfig.pipelined` the frontend runs two frames ahead of the backend
(the instance tracker one frame behind its dispatch) and the estimator
keeps its steady state on the device, so `process` returns the output of
an earlier frame, or None; `close` drains every frame in flight.

The online perception nets (`models/`) run in the `perception` stage
where the config switches them on and the frame brings no offline
artifact: SOLOv2 (`det2d_online`, not in RAW), FCOS3D (`det3d_online`,
DYNAMIC only), the stereo net (`stereo_online`, stereo rigs), RAFT
(`use_dense_flow`: the background tracker follows the field instead of
its temporal LK track from the second frame on; an offline
`FrameInput.flow` takes precedence) and ReID (`use_reid`, MOT's
appearance embeddings). Segmentations, boxes and disparities come back
to the host, where the perception stage reads them; the flow field
stays on the device for the tracker.

With `use_loop_closure` every `loop_keyframe_stride`-th output frame
becomes an ORB keyframe of the `loop.LoopCloser` (stage `loop`); on an
accepted loop edge with `loop_live_correction` the pose graph is solved
and the estimator's window re-anchored on it (live relocalization), and
`close` writes the corrected keyframe trajectory beside the VIO one
(`<prefix>_ego_tum_loop.txt`). The multi-device engine is not ported
yet and raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from dynamic_vins_tpu_torch import models
from dynamic_vins_tpu_torch.estimator.estimator import (Estimator,
                                                        EstimatorConfig)
from dynamic_vins_tpu_torch.frontend.instance_tracker import (
    InstanceTracker, InstanceTrackerConfig)
from dynamic_vins_tpu_torch.frontend.line_tracker import (LineTracker,
                                                          LineTrackerConfig)
from dynamic_vins_tpu_torch.frontend.tracker import (FeatureTracker,
                                                     TrackerConfig,
                                                     upload_stack)
from dynamic_vins_tpu_torch.geometry import camera, lie_np
from dynamic_vins_tpu_torch.geometry.camera import PinholeIntrinsics
from dynamic_vins_tpu_torch.io import perception
from dynamic_vins_tpu_torch.io.writers import KittiMotWriter, TumWriter
from dynamic_vins_tpu_torch.loop import LoopCloser, LoopClosureConfig
from dynamic_vins_tpu_torch.mot.tracker import (MotConfig,
                                                MultiObjectTracker, iou)
from dynamic_vins_tpu_torch.utils.config import SlamMode, VioConfig
from dynamic_vins_tpu_torch.utils.precision import resolve_device
from dynamic_vins_tpu_torch.utils.timing import StageTimer


def obs_capacity(cfg: VioConfig) -> int:
    """The estimator's obs rows for a config: kMaxCnt x window x stereo,
    rounded up to a power of two (at least 1024); the step graphs are
    captured at this size."""
    cap = 1024
    while cap < cfg.max_cnt * cfg.num_frames * 2:
        cap *= 2
    return cap


@dataclass
class FrameInput:
    """What the system consumes for one frame."""

    timestamp: float
    img_left: np.ndarray
    img_right: Optional[np.ndarray] = None
    imu: Optional[tuple] = None            # (acc [M+1,3], gyr, dt [M])
    seg: Optional[perception.SegResult] = None
    boxes3d: Optional[list] = None         # List[perception.Box3D]
    disparity: Optional[np.ndarray] = None
    dynamic_mask: Optional[np.ndarray] = None  # True = dynamic pixel
    flow: Optional[np.ndarray] = None          # [H,W,2] prev->cur flow


class System:
    def __init__(self, cfg: VioConfig, output_prefix: str = "output/run",
                 device=None, dtype: Optional[torch.dtype] = None):
        """device: CUDA unless "cpu" is asked for; dtype: the
        estimator's float type, by default the device's (float32 on the
        card, float64 on the CPU); the tracker works in float32."""
        if cfg.devices and cfg.devices > 1:
            raise NotImplementedError(
                "devices > 1 is not ported yet: ROADMAP queue 1 item 18")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.timer = StageTimer()

        intr_vals = cfg.intrinsics_left or [460.0, 460.0,
                                            cfg.image_width / 2,
                                            cfg.image_height / 2]
        intr = PinholeIntrinsics.make(*intr_vals[:4],
                                      *(intr_vals[4:8] or []))
        intr_r_vals = cfg.intrinsics_right or intr_vals
        intr_r = PinholeIntrinsics.make(*intr_r_vals[:4],
                                        *(intr_r_vals[4:8] or []))
        self.intr, self.intr_r = intr, intr_r
        # fx, fy, cx, cy as the float32 intrinsics hold them
        self._pinhole = tuple(float(np.float32(v)) for v in intr_vals[:4])
        p_bc, q_bc = cfg.extrinsics()
        self.baseline = float(np.linalg.norm(p_bc[1] - p_bc[0])) or 0.1

        self.tracker = FeatureTracker(
            TrackerConfig(max_cnt=cfg.max_cnt, min_dist=cfg.min_dist,
                          stereo=cfg.is_stereo), intr, intr_r,
            device=self.device)
        self.tracker.timer = self.timer
        # LinePoint: segments on the host, their endpoints ride
        # FrameFeatures.lines
        self.line_tracker = LineTracker(LineTrackerConfig()) \
            if cfg.use_line else None

        self.estimator = Estimator(
            EstimatorConfig(num_frames=cfg.num_frames,
                            obs_capacity=obs_capacity(cfg),
                            stereo=cfg.is_stereo,
                            use_imu=cfg.use_imu, pipelined=cfg.pipelined,
                            max_iters=cfg.max_solver_iterations,
                            estimate_extrinsic=cfg.estimate_extrinsic,
                            estimate_td=cfg.estimate_td,
                            use_plane_constraint=cfg.use_plane_constraint,
                            dynamic=cfg.slam == SlamMode.DYNAMIC,
                            use_line=cfg.use_line,
                            line_weight=cfg.line_weight, dtype=dtype),
            p_bc, q_bc, device=self.device)
        self.estimator.timer = self.timer

        # loop closure: keyframe database -> loop edges -> pose graph
        self.loop_closer = None
        if cfg.use_loop_closure:
            self.loop_closer = LoopCloser(
                LoopClosureConfig(min_gap=cfg.loop_min_gap,
                                  prox_radius=cfg.loop_prox_radius),
                intr, p_bc[0], q_bc[0], baseline=self.baseline,
                device=self.device)
        # frames buffered for loop keyframing, by timestamp: the
        # pipelined output lags its input by up to 2 frames, and the
        # keyframe's image must be that of the output's frame
        self._loop_fi_buf: Dict[float, tuple] = {}

        self._build_nets(cfg, intr_vals)
        self.mot = None
        self.inst_tracker = None
        if cfg.slam == SlamMode.DYNAMIC:
            self.mot = MultiObjectTracker(
                MotConfig(n_init=cfg.mot_n_init, max_age=cfg.mot_max_age),
                embed_fn=self._embed if self._reid is not None else None)
            self.inst_tracker = InstanceTracker(
                InstanceTrackerConfig(
                    max_dynamic_cnt=cfg.max_dynamic_cnt,
                    min_dynamic_dist=cfg.min_dynamic_dist),
                intr, self.baseline, p_bc[0], q_bc[0], device=self.device)

        os.makedirs(os.path.dirname(output_prefix) or ".", exist_ok=True)
        self.tum_writer = TumWriter(output_prefix + "_ego_tum.txt")
        self.mot_writer = KittiMotWriter(output_prefix + "_mot.txt") \
            if cfg.slam == SlamMode.DYNAMIC else None
        self.frame_idx = 0
        self._last_dets = {}
        self._ones_mask = None
        # pipelined frontend: frames dispatched to the tracker and not
        # collected yet, at most `_fe_lag` after a call to process (the
        # instance tracker is collected one frame after its dispatch)
        self._fe_pending: List[dict] = []
        self._fe_lag = 2

    def _build_nets(self, cfg: VioConfig, intr_vals):
        """The online perception nets the config asks for, under the
        JAX System's conditions (image_process.cpp:149-162)."""
        hw = (cfg.image_height, cfg.image_width)
        dev = self.device
        self.det2d = self.det3d = self.stereo_net = self.flow_net = None
        self._reid = None
        if cfg.det2d_online and cfg.slam != SlamMode.RAW:
            self.det2d = models.OnlineDetector2D(
                hw, score_thresh=cfg.det2d_score_thresh,
                params_path=cfg.det2d_weights, device=dev)
        if cfg.det3d_online and cfg.slam == SlamMode.DYNAMIC:
            self.det3d = models.OnlineDetector3D(
                hw, intr_vals[:4], params_path=cfg.det3d_weights,
                device=dev)
        if cfg.stereo_online and cfg.is_stereo:
            self.stereo_net = models.OnlineStereoMatcher(
                hw, params_path=cfg.stereo_weights, device=dev)
        if cfg.use_dense_flow:
            self.flow_net = models.OnlineFlowEstimator(
                hw, params_path=cfg.flow_weights, device=dev)
        if cfg.use_reid:
            self._reid = models.ReidExtractor(
                params_path=cfg.reid_weights, device=dev)
        self._prev_img = None
        self.last_flow = None

    def _run_perception_nets(self, fi: FrameInput):
        """The online nets, where the frame brings no offline artifact;
        no flow on the first frame (and none without a net or a field)."""
        t = self.timer
        if self.det2d is not None and fi.seg is None:
            with t.stage("pe.det2d"):
                fi.seg = self.det2d(fi.img_left)
        if self.det3d is not None and not fi.boxes3d:
            with t.stage("pe.det3d"):
                fi.boxes3d = self.det3d(fi.img_left)
        if (self.stereo_net is not None and fi.disparity is None
                and fi.img_right is not None):
            with t.stage("pe.stereo"):
                fi.disparity = self.stereo_net(fi.img_left, fi.img_right)
        if fi.flow is not None:
            self.last_flow = fi.flow              # offline artifact
        elif self.flow_net is not None:
            with t.stage("pe.flow"):
                self.last_flow = self.flow_net(self._prev_img,
                                               fi.img_left) \
                    if self._prev_img is not None else None
            self._prev_img = fi.img_left
        else:
            self.last_flow = None

    def _embed(self, img, boxes):
        """MOT's appearance embeddings (the ReID net), timed."""
        with self.timer.stage("pe.reid"):
            return self._reid(img, boxes)

    def process(self, fi: FrameInput):
        """Track one frame, run the backend, write its pose. Pipelined:
        dispatch this frame's tracker step, then finish the oldest frame
        in flight; returns that frame's output or None."""
        t = self.timer
        if self.cfg.pipelined:
            return self._process_pipelined(fi)
        with t.stage("perception"):
            self._run_perception_nets(fi)
            masks_by_tid, background_mask = self._perception(fi)
        with t.stage("frontend"):
            imgs_dev = self._upload(fi)
            feats = self.tracker.track(fi.img_left, fi.timestamp,
                                       mask=background_mask,
                                       img_right=fi.img_right,
                                       flow=self.last_flow,
                                       imgs_dev=imgs_dev)
            lines = self._track_lines(fi, background_mask)
            if lines is not None:
                feats = feats._replace(lines=lines)
        instances = None
        if self.inst_tracker is not None and masks_by_tid:
            with t.stage("instances"):
                h_inst = self.inst_tracker.track_begin(
                    fi.img_left, {tid: m for tid, (m, _)
                                  in masks_by_tid.items()},
                    img_right=fi.img_right, disparity=fi.disparity,
                    ego_pose=self._ego_estimate(), imgs_dev=imgs_dev)
                instances = self._collect_instances(h_inst, masks_by_tid)
        return self._finish_frame(fi, feats, instances)

    def _upload(self, fi: FrameInput):
        """DYNAMIC: the frame's image stack on the device, uploaded once
        and shared by both trackers; else None (the tracker uploads)."""
        if self.inst_tracker is None:
            return None
        use_right = self.cfg.is_stereo and fi.img_right is not None
        return upload_stack(fi.img_left,
                            fi.img_right if use_right else None,
                            self.device)

    def _process_pipelined(self, fi: FrameInput):
        """Dispatch frame k's tracker step; finish the oldest frame in
        flight; collect the instance tracker's frame k-1, then dispatch
        its frame k (its host slot state feeds the next dispatch, so it
        runs one frame behind whatever the frontend's depth)."""
        t = self.timer
        with t.stage("perception"):
            self._run_perception_nets(fi)
            masks_by_tid, background_mask = self._perception(fi)
        # masked modes give the tracker a mask on every frame
        if self.cfg.slam != SlamMode.RAW and background_mask is None:
            background_mask = self._all_true_mask(fi.img_left.shape)
        with t.stage("frontend"):
            imgs_dev = self._upload(fi)
            h = self.tracker.track_begin(
                fi.img_left, fi.timestamp, mask=background_mask,
                img_right=fi.img_right, flow=self.last_flow,
                imgs_dev=imgs_dev)
            # the host LSD runs while the tracker's step is on the card
            lines = self._track_lines(fi, background_mask)
        out = None
        if len(self._fe_pending) >= self._fe_lag:
            out = self._finish_oldest_pending()
        h_inst = None
        if self.inst_tracker is not None:
            with t.stage("instances"):
                if self._fe_pending and \
                        self._fe_pending[-1]["h_inst"] is not None:
                    last = self._fe_pending[-1]
                    last["instances"] = self._collect_instances(
                        last["h_inst"], last["masks"])
                    last["h_inst"] = None
                if masks_by_tid:
                    h_inst = self.inst_tracker.track_begin(
                        fi.img_left, {tid: m for tid, (m, _)
                                      in masks_by_tid.items()},
                        img_right=fi.img_right, disparity=fi.disparity,
                        ego_pose=self._ego_estimate(), imgs_dev=imgs_dev)
        self._fe_pending.append(dict(h=h, fi=fi, lines=lines, h_inst=h_inst,
                                     masks=masks_by_tid, instances=None))
        return out

    def _track_lines(self, fi: FrameInput, mask):
        """LinePoint: the frame's tracked segments as the estimator's
        line observations, or None without a line tracker."""
        if self.line_tracker is None:
            return None
        with self.timer.stage("fe.lsd"):
            segs, right = self.line_tracker.track(
                np.asarray(fi.img_left), mask=mask,
                img_right=(np.asarray(fi.img_right)
                           if fi.img_right is not None else None))
            return self._lines_to_obs(segs, right)

    def _lines_to_obs(self, segs, right):
        """Pixel segments -> {id: (s_l, e_l, s_r|None, e_r|None)} with
        normalized z = 1 endpoints, lifted in float32 on the host (the
        intrinsics' type, as the JAX package lifts them)."""
        if not segs:
            return {}

        def lift(intr, seg_list):
            uv = np.array([[[g.sx, g.sy], [g.ex, g.ey]] for g in seg_list],
                          np.float32).reshape(-1, 2)
            n = camera.normalized_from_pixel(intr.to("cpu"),
                                             torch.from_numpy(uv))
            return n.numpy().reshape(len(seg_list), 2, 2)

        n = lift(self.intr, segs)
        n_r = {}
        if right:
            r_ids = list(right.keys())
            nr = lift(self.intr_r, [right[i] for i in r_ids])
            n_r = {i: nr[k] for k, i in enumerate(r_ids)}
        one = lambda xy: np.append(xy, 1.0)
        obs = {}
        for k, seg in enumerate(segs):
            r = n_r.get(seg.id)
            obs[seg.id] = (one(n[k, 0]), one(n[k, 1]),
                           None if r is None else one(r[0]),
                           None if r is None else one(r[1]))
        return obs

    def _all_true_mask(self, shape):
        if self._ones_mask is None or self._ones_mask.shape != shape:
            self._ones_mask = np.ones(shape, bool)
        return self._ones_mask

    def _finish_frame(self, fi: FrameInput, feats, instances=None):
        t = self.timer
        with t.stage("backend"):
            out = self.estimator.process_frame(feats, fi.imu,
                                               instances=instances)
        drained = self._loop_keyframe(fi, out)
        with t.stage("output"):
            if out is not None:
                self.tum_writer.write(out.timestamp, out.p, out.q)
            # pipelined frames the loop correction drained, in order
            for o in drained:
                self.tum_writer.write(o.timestamp, o.p, o.q)
            if self.mot_writer is not None:
                self._write_mot(fi)
        self.frame_idx += 1
        return out

    def _loop_keyframe(self, fi: FrameInput, out):
        """Loop closure for a finished frame: buffer its image, and if
        the output's frame is on the keyframe stride, add it to the
        database; on an accepted edge with live correction, solve the
        pose graph and re-anchor the window and the stored keyframes.
        Returns the pipelined outputs the correction drained."""
        if self.loop_closer is None:
            return []
        cfg = self.cfg
        self._loop_fi_buf[fi.timestamp] = (fi.img_left, fi.disparity,
                                           self.frame_idx)
        while len(self._loop_fi_buf) > 8:
            self._loop_fi_buf.pop(next(iter(self._loop_fi_buf)))
        kf = self._loop_fi_buf.pop(out.timestamp, None) \
            if out is not None else None
        if kf is None or kf[2] % cfg.loop_keyframe_stride:
            return []
        kf_img, kf_disp, kf_idx = kf
        drained = []
        with self.timer.stage("loop"):
            edge = self.loop_closer.add_keyframe(
                kf_img, out.timestamp, out.p, out.q, disparity=kf_disp,
                frame_idx=kf_idx)
            if edge is not None and cfg.loop_live_correction:
                res = self.loop_closer.optimize()
                if res is not None:
                    p_g, q_g, _ = res
                    kf = self.loop_closer.db.keyframes[edge.j]
                    drained = self.estimator.apply_loop_correction(
                        kf.p, kf.q, p_g[edge.j], q_g[edge.j])
                    self.loop_closer.rebase(p_g, q_g)
        return drained

    # ------------------------------------------------------------------
    def _perception(self, fi: FrameInput):
        """Instance masks and the background mask (ImageProcessor::Run +
        SemanticImage::SetMaskAndRoi): ({tid: (mask, det)}, mask or
        None), the background mask True where tracking is allowed."""
        cfg = self.cfg
        H, W = fi.img_left.shape
        if cfg.slam == SlamMode.RAW:
            return {}, None
        if cfg.slam == SlamMode.NAIVE:
            # mask-gated rejection only: dynamic pixels excluded
            if fi.dynamic_mask is not None:
                return {}, ~fi.dynamic_mask
            if fi.seg is not None and len(fi.seg.masks):
                return {}, ~perception.merge_masks(fi.seg.masks, (H, W))
            return {}, None

        # DYNAMIC: dynamic-class instances, MOT association
        masks_by_tid = {}
        merged = np.zeros((H, W), bool)
        if fi.seg is not None and len(fi.seg.masks):
            keep = [i for i, l in enumerate(fi.seg.labels)
                    if int(l) in perception.COCO_DYNAMIC_IDS]
            masks = fi.seg.masks[keep]
            labels = fi.seg.labels[keep]
            boxes2d = perception.masks_to_boxes2d(masks)
            assign = self.mot.update(boxes2d, classes=labels,
                                     img=fi.img_left) \
                if len(boxes2d) else {}
            used3d: set = set()         # BoxAssociate2Dto3D
            for det_i, tid in assign.items():
                det = dict(cls=int(labels[det_i]), bbox=boxes2d[det_i])
                if fi.boxes3d:
                    b3 = self._match_box3d(boxes2d[det_i], fi.boxes3d,
                                           cls=int(labels[det_i]),
                                           used=used3d)
                    if b3 is not None:
                        det["dims_det"] = b3.dims
                        det["q_det"] = self._qdet_world(b3)
                        det["box3d"] = b3
                masks_by_tid[tid] = (masks[det_i], det)
                merged |= masks[det_i]
        background = ~merged if masks_by_tid else None
        self._last_dets = {tid: det for tid, (_, det)
                           in masks_by_tid.items()}
        return masks_by_tid, background

    def _ego_estimate(self):
        """The newest estimated ego pose on the host (the instance
        tracker lifts the extra points with it): the frame before the
        current one; pipelined, the lagged host mirror's."""
        fc = self.estimator.frame_count
        if fc:
            return (self.estimator.state.p[fc - 1],
                    self.estimator.state.q[fc - 1])
        return np.zeros(3), np.array([1.0, 0, 0, 0])

    def _collect_instances(self, h_inst, masks_by_tid):
        """Fetch an instance-tracker frame and merge the frame's
        detections (cls, dims_det, q_det) into the push_frame dicts."""
        tracked = self.inst_tracker.track_collect(h_inst)
        instances = {}
        for tid, data in tracked.items():
            _, det = masks_by_tid[tid]
            data = dict(data)
            data["cls"] = det.get("cls", 0)
            if det.get("dims_det") is not None:
                data["dims_det"] = det["dims_det"]
            if det.get("q_det") is not None:
                data["q_det"] = det["q_det"]
            instances[tid] = data
        return instances

    def _project_box3d_bbox(self, bottom_center, dims, R_co):
        """The 8 corners of a camera-frame 3D box in pixels -> (x1, y1,
        x2, y2), or None if the box is behind the camera."""
        dx, dy, dz = [float(v) for v in dims]
        sx = np.array([-1, -1, -1, -1, 1, 1, 1, 1]) * dx / 2
        sy = np.array([0, 0, -1, -1, 0, 0, -1, -1]) * dy  # bottom->top
        sz = np.array([-1, 1, -1, 1, -1, 1, -1, 1]) * dz / 2
        corners = np.asarray(bottom_center)[None, :] + \
            (np.asarray(R_co) @ np.stack([sx, sy, sz]).astype(float)).T
        z = corners[:, 2]
        if (z <= 0.1).any():
            return None
        fx, fy, cx0, cy0 = self._pinhole
        u = fx * corners[:, 0] / z + cx0
        v = fy * corners[:, 1] / z + cy0
        return (float(u.min()), float(v.min()),
                float(u.max()), float(v.max()))

    def _match_box3d(self, bbox2d, boxes3d, cls=None,
                     iou_thresh: float = 0.1, used=None):
        """The 3D detection whose projected box overlaps the 2D one most
        (IoU > 0.1), of the same class, each 3D box used at most once
        (BoxAssociate2Dto3D, image_process.cpp:28-61)."""
        want = perception.COCO_TO_KITTI.get(cls) if cls is not None \
            else None
        best, best_i, best_iou = None, None, iou_thresh
        for bi, b in enumerate(boxes3d):
            if used is not None and bi in used:
                continue
            if want is not None and b.class_name != want:
                continue
            proj = self._project_box3d_bbox(b.bottom_center, b.dims,
                                            b.rotation_matrix())
            if proj is None:
                continue
            i = iou(np.asarray(bbox2d, float), np.asarray(proj))
            if i > best_iou:
                best, best_i, best_iou = b, bi, i
        if best is not None and used is not None:
            used.add(best_i)
        return best

    def _qdet_world(self, box3d):
        """A camera-frame detected orientation in the world, with the
        current ego estimate (host numpy)."""
        st = self.estimator.state
        k = max(self.estimator.frame_count - 1, 0)
        q_co = lie_np.matrix_to_quat(np.asarray(box3d.rotation_matrix()))
        p_wc, q_wc = lie_np.pose_compose(
            np.asarray(st.p[k], float), np.asarray(st.q[k], float),
            np.asarray(st.p_bc[0], float), np.asarray(st.q_bc[0], float))
        return lie_np.quat_multiply(q_wc, q_co)

    def _write_mot(self, fi: FrameInput):
        """One KITTI-tracking line per instance: the frontend's 2D box
        (output.cpp:426,448), or, for an instance without a detection
        this frame, its projected estimated 3D box."""
        states = self.estimator.get_instance_states()
        st = self.estimator.state
        k = max(self.estimator.frame_count - 1, 0)
        p_wc, q_wc = lie_np.pose_compose(
            np.asarray(st.p[k], float), np.asarray(st.q[k], float),
            np.asarray(st.p_bc[0], float), np.asarray(st.q_bc[0], float))
        p_cw, q_cw = lie_np.pose_inverse(p_wc, q_wc)
        H, W = fi.img_left.shape

        for tid in sorted(set(states) | set(self._last_dets)):
            s = states.get(tid)
            det = self._last_dets.get(tid)
            cls_coco = s["cls"] if s is not None else det["cls"]
            kitti_cls = perception.COCO_TO_KITTI.get(cls_coco, "Car")

            if s is not None:
                p_cam = lie_np.pose_transform_point(
                    p_cw, q_cw, np.asarray(s["p"], float))
                # camera-frame yaw of the object (about -y)
                q_obj_cam = lie_np.quat_multiply(
                    q_cw, np.asarray(s["q"], float))
                R_co = lie_np.quat_to_matrix(q_obj_cam)
                yaw = float(np.arctan2(-R_co[2, 0], R_co[0, 0]))
                dims = np.asarray(s["dims"], float)
                bottom = p_cam.copy()
                bottom[1] += dims[2] / 2.0
                hwl = (dims[2], dims[1], dims[0])
            elif det is not None and det.get("box3d") is not None:
                b3 = det["box3d"]
                bottom = np.asarray(b3.bottom_center, float)
                # Box3D.dims is (l, h, w) camera x,y,z extents
                hwl = (float(b3.dims[1]), float(b3.dims[2]),
                       float(b3.dims[0]))
                yaw = float(b3.yaw)
                R_co = b3.rotation_matrix()
                dims = None
            else:
                bottom = np.zeros(3)
                hwl = (1.5, 1.8, 4.0)     # reference default dims
                yaw = 0.0
                R_co = dims = None

            if det is not None:
                bbox = tuple(float(v) for v in det["bbox"])
            elif dims is not None:
                # the estimated box (object-frame x/y/z extents) seen
                # from the camera
                bbox = self._project_box3d_bbox(
                    bottom, (dims[0], dims[2], dims[1]), R_co)
                if bbox is None:
                    continue          # behind the camera: unevaluable
                bbox = (max(bbox[0], 0.0), max(bbox[1], 0.0),
                        min(bbox[2], W - 1.0), min(bbox[3], H - 1.0))
                if bbox[2] <= bbox[0] or bbox[3] <= bbox[1]:
                    continue
            else:
                continue

            self.mot_writer.write(
                self.frame_idx, tid, kitti_cls, bbox, hwl,
                bottom, yaw, score=1.0)

    def _finish_oldest_pending(self):
        """Collect + finish the oldest frame in flight."""
        e = self._fe_pending.pop(0)
        if e["h_inst"] is not None:
            # collected at lag 1 in process; here when draining
            e["instances"] = self._collect_instances(e["h_inst"],
                                                     e["masks"])
            e["h_inst"] = None
        with self.timer.stage("frontend"):
            feats = self.tracker.track_collect(e["h"])
        if e["lines"] is not None:
            feats = feats._replace(lines=e["lines"])
        # the lagged frame's MOT rows use its own detections
        self._last_dets = {tid: det for tid, (_, det)
                           in e["masks"].items()}
        return self._finish_frame(e["fi"], feats, e["instances"])

    def drain(self):
        """Finish every frame in flight, the frontend's and then the
        pipelined estimator's; returns their outputs in order (also
        written to the TUM file)."""
        outs = []
        while self._fe_pending:
            out = self._finish_oldest_pending()
            if out is not None:
                outs.append(out)
        for out in self.estimator.flush():
            self.tum_writer.write(out.timestamp, out.p, out.q)
            outs.append(out)
        return outs

    def reset_timers(self):
        """Fresh StageTimer shared by System, tracker and estimator
        (steady-state stage means)."""
        self.timer = StageTimer()
        self.tracker.timer = self.estimator.timer = self.timer
        return self.timer

    def close(self):
        """Drain, close the trajectory files (with loop edges, solve the
        pose graph and write the corrected keyframe trajectory), return
        the stage means."""
        self.drain()
        self.tum_writer.close()
        if self.mot_writer is not None:
            self.mot_writer.close()
        if self.loop_closer is not None and self.loop_closer.edges:
            res = self.loop_closer.optimize()
            if res is not None:
                p, q, _ = res
                path = self.tum_writer._f.name.replace(
                    "_ego_tum.txt", "_ego_tum_loop.txt")
                with TumWriter(path) as w:
                    for k, kf in enumerate(self.loop_closer.db.keyframes):
                        w.write(kf.timestamp, p[k], q[k])
        return self.timer.summary()
