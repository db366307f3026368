"""Per-object (instance) backend manager.

The reference's InstanceManager (`estimator/estimator_insts.cpp`):
object lifecycle (PushBack / create / extend, delete after lost
frames), pose propagation (static hold / constant twist / box fit on
the extra points), stereo triangulation of object features,
InitialInstance (dims from the 3D detection or the class default,
center from the box fit, else the centroid), velocity init by finite
difference, the scene-flow static/dynamic decision with hysteresis
(SetDynamicOrStatic, kStaticInstThreshold), the vmapped object BA
(solver/object_solver.py in place of the per-object Ceres solves),
outlier rejection, landmark caps and both window slides.

The bookkeeping is host numpy. The object BA is one step over all
object slots: the host packs one float and one int buffer (layout in
`__init__`), the step runs (one CUDA graph replay on the card, eager on
the CPU, no host synchronization inside) and its output lands in a
pinned buffer. A solve is applied at the first read after its dispatch
(the next frame's `push_frame`, or `output`), so at most one is in
flight; the frame map of a pending solve follows the window slides in
between.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from dynamic_vins_tpu_torch.estimator import host_math
from dynamic_vins_tpu_torch.estimator.estimator import StepLayout, _HostSlots
from dynamic_vins_tpu_torch.factors.object_factors import ObjectWindow
from dynamic_vins_tpu_torch.geometry import lie_np
from dynamic_vins_tpu_torch.solver.object_solver import (ObjectProblem,
                                                         ObjectSolverConfig,
                                                         solve_all)
from dynamic_vins_tpu_torch.utils.precision import (default_dtype,
                                                    resolve_device)
from dynamic_vins_tpu_torch.utils.step_graph import StepGraph

DEFAULT_DIMS = np.array([4.0, 2.0, 1.5])   # reference default (2,4,1.5)
                                           # in (l,w,h) -> our (x,y,z)


@dataclass
class InstanceConfig:
    num_frames: int = 11
    max_objects: int = 8          # object slots (vmapped batch)
    lm_per_object: int = 32       # object landmark slots
    obs_per_object: int = 512
    extra_per_frame: int = 64
    max_lost: int = 3             # delete after N lost frames (ref: 3)
    static_thresh: float = 0.5    # kStaticInstThreshold (m/s scene flow)
    static_hysteresis: int = 3
    min_age_for_velocity: int = 3
    solver: ObjectSolverConfig = field(default_factory=ObjectSolverConfig)
    # None: the device's (float32 on the card, float64 on the CPU)
    dtype: Optional[torch.dtype] = None


def solve_layouts(cfg: InstanceConfig):
    """(float, int, output) layouts of the object solve's buffers."""
    O, F, Lo = cfg.max_objects, cfg.num_frames, cfg.lm_per_object
    No, K = cfg.obs_per_object, cfg.extra_per_frame
    fl = StepLayout([("obs_norm", O * No * 2), ("extra", O * F * K * 3),
                     ("dims_det", O * 3), ("q_det", O * F * 4),
                     ("lm", O * Lo * 3), ("times", F), ("p_cw", F * 2 * 3),
                     ("q_cw", F * 2 * 4), ("p", O * F * 3),
                     ("q", O * F * 4), ("v", O * 3), ("w", O * 3),
                     ("dims", O * 3), ("c_off", O * 3)])
    il = StepLayout([("obs_frame", O * No), ("obs_cam", O * No),
                     ("obs_lm", O * No), ("obs_ok", O * No),
                     ("extra_valid", O * F * K), ("ddv", O),
                     ("det_valid", O * F), ("frame_valid", O * F),
                     ("lm_valid", O * Lo), ("active", O)])
    ol = StepLayout([("p", O * F * 3), ("q", O * F * 4), ("v", O * 3),
                     ("w", O * 3), ("dims", O * 3), ("c_off", O * 3),
                     ("lm", O * Lo * 3), ("cost", O)])
    return fl, il, ol


def solve_step(cfg: InstanceConfig, key, inputs):
    """The object BA of every slot on the packed buffers (fblob [Sf] in
    the solver dtype, iblob [Si] int64) -> the packed output [So]. `key`
    is the StepGraph branch (one)."""
    fblob, iblob = inputs
    O, F, Lo = cfg.max_objects, cfg.num_frames, cfg.lm_per_object
    No, K = cfg.obs_per_object, cfg.extra_per_frame
    fl, il, _ = solve_layouts(cfg)
    fs = lambda n, *shape: fl.get(fblob, n, shape)
    is_ = lambda n, *shape: il.get(iblob, n, shape)
    b = lambda n, *shape: is_(n, *shape) != 0
    tile = lambda a: a.expand((O,) + a.shape)
    lm = fs("lm", O, Lo, 3)
    probs = ObjectProblem(
        obs_frame=is_("obs_frame", O, No), obs_cam=is_("obs_cam", O, No),
        obs_lm=is_("obs_lm", O, No), obs_norm=fs("obs_norm", O, No, 2),
        obs_valid=b("obs_ok", O, No), extra_pts=fs("extra", O, F, K, 3),
        extra_valid=b("extra_valid", O, F, K),
        dims_det=fs("dims_det", O, 3), dims_det_valid=b("ddv", O),
        q_det=fs("q_det", O, F, 4), det_valid=b("det_valid", O, F),
        frame_valid=b("frame_valid", O, F), lm_valid=b("lm_valid", O, Lo),
        lm_prior=lm, times=tile(fs("times", F)),
        p_cw=tile(fs("p_cw", F, 2, 3)), q_cw=tile(fs("q_cw", F, 2, 4)))
    states = ObjectWindow(p=fs("p", O, F, 3), q=fs("q", O, F, 4),
                          v=fs("v", O, 3), w=fs("w", O, 3),
                          dims=fs("dims", O, 3), c_off=fs("c_off", O, 3))
    st, lm2, cost = solve_all(states, lm, probs, cfg.solver,
                              b("active", O))
    return torch.cat([st.p.reshape(-1), st.q.reshape(-1),
                      st.v.reshape(-1), st.w.reshape(-1),
                      st.dims.reshape(-1), st.c_off.reshape(-1),
                      lm2.reshape(-1), cost.reshape(-1)])


class InstanceManager:
    def __init__(self, cfg: InstanceConfig, device=None):
        self.cfg = cfg
        O, F, Lo = cfg.max_objects, cfg.num_frames, cfg.lm_per_object
        self.active = np.zeros(O, bool)
        self.track_id = np.full(O, -1, np.int64)
        self.cls = np.zeros(O, np.int32)
        self.age = np.zeros(O, np.int32)
        self.lost = np.zeros(O, np.int32)
        self.is_static = np.zeros(O, bool)
        self.static_cnt = np.zeros(O, np.int32)
        self.initialized = np.zeros(O, bool)

        self.p = np.zeros((O, F, 3))
        self.q = np.tile(np.array([1.0, 0, 0, 0]), (O, F, 1))
        self.v = np.zeros((O, 3))
        self.w = np.zeros((O, 3))
        self.dims = np.tile(DEFAULT_DIMS, (O, 1))
        self.c_off = np.zeros((O, 3))
        self.frame_valid = np.zeros((O, F), bool)

        # object landmarks (object frame) + observations
        self.lm = np.zeros((O, Lo, 3))
        self.lm_valid = np.zeros((O, Lo), bool)
        self.lm_feat_id = np.full((O, Lo), -1, np.int64)
        # per-frame feature obs: normalized coords per cam
        self.obs = np.zeros((O, F, Lo, 2, 2))     # [O,F,Lo,cam,2]
        self.obs_valid = np.zeros((O, F, Lo, 2), bool)
        # per-frame extra point clouds (world)
        self.extra = np.zeros((O, F, cfg.extra_per_frame, 3))
        self.extra_valid = np.zeros((O, F, cfg.extra_per_frame), bool)
        # detections
        self.dims_det = np.tile(DEFAULT_DIMS, (O, 1))
        self.dims_det_valid = np.zeros(O, bool)
        self.q_det = np.tile(np.array([1.0, 0, 0, 0]), (O, F, 1))
        self.det_valid = np.zeros((O, F), bool)

        self._tid_to_slot: Dict[int, int] = {}
        # slot generation counter: bumped on alloc/free so a pending
        # solve never writes into a recycled slot
        self.gen = np.zeros(O, np.int64)
        self._pending = deque()       # dispatched, not yet applied solves
        self._p_cw = None             # ego cam poses of the last solve
        self._q_cw = None
        self.device = resolve_device(device)
        self.dtype = cfg.dtype or default_dtype(self.device)
        self._layouts = solve_layouts(cfg)
        self._io = None
        # the object BA: one branch, a CUDA graph on the card
        self.solve_graph = StepGraph(
            lambda key, inputs: solve_step(cfg, key, inputs),
            self.device, keys=(0,))

    # ------------------------------------------------------------------
    def slot_of(self, track_id: int) -> Optional[int]:
        return self._tid_to_slot.get(track_id)

    def _alloc(self, track_id: int, cls: int) -> Optional[int]:
        free = np.flatnonzero(~self.active)
        if not free.size:
            return None
        s = int(free[0])
        self.gen[s] += 1
        self.active[s] = True
        self.track_id[s] = track_id
        self.cls[s] = cls
        self.age[s] = 0
        self.lost[s] = 0
        self.is_static[s] = False
        self.static_cnt[s] = 0
        self.initialized[s] = False
        self.frame_valid[s] = False
        self.lm_valid[s] = False
        self.lm_feat_id[s] = -1
        self.obs_valid[s] = False
        self.extra_valid[s] = False
        self.dims[s] = DEFAULT_DIMS
        self.dims_det_valid[s] = False
        self.det_valid[s] = False
        self.v[s] = 0
        self.w[s] = 0
        self.c_off[s] = 0
        self._tid_to_slot[track_id] = s
        return s

    def _free(self, s: int):
        tid = self.track_id[s]
        self._tid_to_slot.pop(int(tid), None)
        self.gen[s] += 1
        self.active[s] = False
        self.track_id[s] = -1

    # ------------------------------------------------------------------
    def push_frame(self, frame: int, instances: dict, ego_p, ego_q,
                   p_bc, q_bc):
        """Ingest one frame of per-instance frontend output.

        instances: {track_id: dict(cls, features={fid: (pt_l, pt_r|None)},
        extra_pts_world [M,3]|None, dims_det [3]|None, q_det [4]|None)}.
        Mirrors InstanceManager::PushBack (estimator_insts.cpp:54).
        """
        self._sync_pending()
        cfg = self.cfg
        seen = set()
        for tid, data in instances.items():
            s = self.slot_of(tid)
            if s is None:
                s = self._alloc(tid, data.get("cls", 0))
                if s is None:
                    continue
            seen.add(s)
            self.lost[s] = 0
            self.age[s] += 1
            self.frame_valid[s, frame] = True

            # features -> landmark slots
            feats = data.get("features", {})
            for fid, (pt_l, pt_r) in feats.items():
                li = self._lm_slot(s, fid)
                if li is None:
                    continue
                self.obs[s, frame, li, 0] = pt_l[:2]
                self.obs_valid[s, frame, li, 0] = True
                if pt_r is not None:
                    self.obs[s, frame, li, 1] = pt_r[:2]
                    self.obs_valid[s, frame, li, 1] = True

            extra = data.get("extra_pts_world")
            if extra is not None and len(extra):
                m = min(len(extra), cfg.extra_per_frame)
                self.extra[s, frame, :m] = extra[:m]
                self.extra_valid[s, frame, :m] = True
                self.extra_valid[s, frame, m:] = False

            dims_det = data.get("dims_det")
            if dims_det is not None:
                self.dims_det[s] = dims_det
                self.dims_det_valid[s] = True
            q_det = data.get("q_det")
            if q_det is not None:
                self.q_det[s, frame] = q_det
                self.det_valid[s, frame] = True

        # mark lost instances
        for s in np.flatnonzero(self.active):
            if s not in seen:
                self.lost[s] += 1

    def _lm_slot(self, s: int, fid: int) -> Optional[int]:
        match = np.flatnonzero(self.lm_feat_id[s] == fid)
        if match.size:
            return int(match[0])
        free = np.flatnonzero(self.lm_feat_id[s] < 0)
        if not free.size:
            return None
        li = int(free[0])
        self.lm_feat_id[s, li] = fid
        return li

    # ------------------------------------------------------------------
    def propagate_pose(self, frame: int, times):
        """Initial pose for the new frame (PropagatePose,
        estimator_insts.cpp:210): static -> hold; else box-fit on extra
        points if present, else constant twist."""
        self._sync_pending()
        for s in np.flatnonzero(self.active & self.frame_valid[:, frame]):
            prev = np.flatnonzero(self.frame_valid[s, :frame])
            if not prev.size or not self.initialized[s]:
                continue
            k0 = int(prev[-1])
            if self.is_static[s]:
                self.p[s, frame] = self.p[s, k0]
                self.q[s, frame] = self.q[s, k0]
                continue
            dt = float(times[frame] - times[k0])
            ev = self.extra_valid[s, frame]
            if ev.sum() >= 8:
                center, cnt, _ = host_math.fit_box_center(
                    self.extra[s, frame], ev, self.q[s, k0],
                    self.dims[s])
                offset = lie_np.quat_rotate(self.q[s, k0],
                                            self.c_off[s])
                self.p[s, frame] = center - offset
                self.q[s, frame] = self.q[s, k0]
            else:
                dq = host_math.so3_exp_quat(self.w[s] * dt)
                self.p[s, frame] = self.p[s, k0] + self.v[s] * dt
                self.q[s, frame] = lie_np.quat_multiply(
                    dq, self.q[s, k0])

    def initialize_instances(self, frame: int):
        """InitialInstance (estimator_insts.cpp:495): first pose from
        box fit / centroid of extra points; dims from det3d or default."""
        self._sync_pending()
        for s in np.flatnonzero(self.active & ~self.initialized
                                & self.frame_valid[:, frame]):
            ev = self.extra_valid[s, frame]
            if ev.sum() < 8:
                continue
            if self.dims_det_valid[s]:
                self.dims[s] = self.dims_det[s]
            q0 = self.q_det[s, frame] if self.det_valid[s, frame] \
                else np.array([1.0, 0, 0, 0])
            c, cnt, mask = host_math.fit_box_center(
                self.extra[s, frame], ev, q0, self.dims[s])
            if int(cnt) < 5:
                c = host_math.centroid(self.extra[s, frame], ev)
            self.p[s, :] = np.asarray(c)[None, :]
            self.q[s, :] = q0[None, :]
            self.c_off[s] = 0.0
            self.initialized[s] = True

    def init_velocity(self, frame: int, times):
        """Finite-difference velocity init after age>=3
        (InitialInstanceVelocity, estimator_insts.cpp:582)."""
        self._sync_pending()
        for s in np.flatnonzero(self.active & self.initialized):
            if self.age[s] < self.cfg.min_age_for_velocity:
                continue
            if np.linalg.norm(self.v[s]) > 1e-6:
                continue
            frames = np.flatnonzero(self.frame_valid[s, :frame + 1])
            if frames.size < 2:
                continue
            k0, k1 = int(frames[0]), int(frames[-1])
            dt = float(times[k1] - times[k0])
            if dt <= 1e-6:
                continue
            self.v[s] = (self.p[s, k1] - self.p[s, k0]) / dt

    def classify_motion(self, frame: int, times):
        """Scene-flow static/dynamic decision with hysteresis
        (SetDynamicOrStatic, estimator_insts.cpp:610)."""
        self._sync_pending()
        cfg = self.cfg
        for s in np.flatnonzero(self.active & self.initialized):
            frames = np.flatnonzero(self.frame_valid[s, :frame + 1])
            if frames.size < 2:
                continue
            k0, k1 = int(frames[-2]), int(frames[-1])
            dt = max(float(times[k1] - times[k0]), 1e-3)
            flow = np.linalg.norm(self.p[s, k1] - self.p[s, k0]) / dt
            if flow < cfg.static_thresh:
                self.static_cnt[s] += 1
            else:
                self.static_cnt[s] = 0
            self.is_static[s] = self.static_cnt[s] >= \
                cfg.static_hysteresis

    # ------------------------------------------------------------------
    def triangulate(self, frame: int, ego_p, ego_q, p_bc, q_bc,
                    baseline_extr):
        """Stereo triangulation of object features into object-frame
        landmarks (Triangulate, estimator_insts.cpp:316 — stereo path).

        baseline_extr: (p_bc_right, q_bc_right)."""
        self._sync_pending()
        for s in np.flatnonzero(self.active & self.initialized
                                & self.frame_valid[:, frame]):
            li_new = np.flatnonzero(
                ~self.lm_valid[s] & (self.lm_feat_id[s] >= 0)
                & self.obs_valid[s, frame, :, 0]
                & self.obs_valid[s, frame, :, 1])
            if not li_new.size:
                continue
            p_wc0, q_wc0 = lie_np.pose_compose(
                np.asarray(ego_p), np.asarray(ego_q),
                np.asarray(p_bc), np.asarray(q_bc))
            p_wc1, q_wc1 = lie_np.pose_compose(
                np.asarray(ego_p), np.asarray(ego_q),
                np.asarray(baseline_extr[0]),
                np.asarray(baseline_extr[1]))
            p_cw0, q_cw0 = lie_np.pose_inverse(p_wc0, q_wc0)
            p_cw1, q_cw1 = lie_np.pose_inverse(p_wc1, q_wc1)
            for li in li_new:
                ptl = np.append(self.obs[s, frame, li, 0], 1.0)
                ptr = np.append(self.obs[s, frame, li, 1], 1.0)
                pw, d0 = host_math.triangulate_dlt(
                    p_cw0, q_cw0, p_cw1, q_cw1, ptl, ptr)
                if not np.isfinite(float(d0)) or float(d0) < 0.5 \
                        or float(d0) > 100.0:
                    continue
                # world -> object frame at this frame
                p_ow, q_ow = lie_np.pose_inverse(
                    self.p[s, frame], self.q[s, frame])
                po = lie_np.pose_transform_point(p_ow, q_ow, pw)
                if np.abs(po).max() > 2.0 * self.dims[s].max():
                    continue   # box-based outlier cull
                self.lm[s, li] = po
                self.lm_valid[s, li] = True

    # ------------------------------------------------------------------
    def optimize(self, times, ego_p_cw, ego_q_cw):
        """Vmapped BA over all active dynamic objects
        (InstanceManager::Optimization, estimator_insts.cpp:772): two
        packed input buffers, one step (a graph replay on the card).

        The solve is not waited for here: the next read (`output`, the
        next frame's `push_frame`) applies it."""
        self._sync_pending()
        if not (self.active & self.initialized).any():
            return
        cfg = self.cfg
        O, F, Lo = cfg.max_objects, cfg.num_frames, cfg.lm_per_object
        No = cfg.obs_per_object
        self._p_cw = np.asarray(ego_p_cw)
        self._q_cw = np.asarray(ego_q_cw)

        # obs row tables (vectorized per object; O is small)
        obs_frame = np.zeros((O, No), np.int32)
        obs_cam = np.zeros((O, No), np.int32)
        obs_lm = np.zeros((O, No), np.int32)
        obs_norm = np.zeros((O, No, 2))
        obs_ok = np.zeros((O, No), bool)
        sel = self.obs_valid & self.lm_valid[:, None, :, None]
        for s in np.flatnonzero(self.active & self.initialized):
            rows = np.argwhere(sel[s])
            n = min(len(rows), No)
            if not n:
                continue
            f, li, c = rows[:n, 0], rows[:n, 1], rows[:n, 2]
            obs_frame[s, :n] = f
            obs_cam[s, :n] = c
            obs_lm[s, :n] = li
            obs_norm[s, :n] = self.obs[s, f, li, c]
            obs_ok[s, :n] = True

        fl, il, _ = self._layouts
        if self._io is None:
            self._io = _HostSlots(self._layouts, self.dtype,
                                  self.solve_graph.on_card, depth=1)
        slot = self._io.next()
        fb, ib = slot.f.numpy(), slot.i.numpy()
        active = self.active & self.initialized & ~self.is_static
        for name, a in (("obs_norm", obs_norm), ("extra", self.extra),
                        ("dims_det", self.dims_det), ("q_det", self.q_det),
                        ("lm", self.lm), ("times", times),
                        ("p_cw", ego_p_cw), ("q_cw", ego_q_cw),
                        ("p", self.p), ("q", self.q), ("v", self.v),
                        ("w", self.w), ("dims", self.dims),
                        ("c_off", self.c_off)):
            fl.put(fb, name, a)
        for name, a in (("obs_frame", obs_frame), ("obs_cam", obs_cam),
                        ("obs_lm", obs_lm), ("obs_ok", obs_ok),
                        ("extra_valid", self.extra_valid),
                        ("ddv", self.dims_det_valid),
                        ("det_valid", self.det_valid),
                        ("frame_valid", self.frame_valid),
                        ("lm_valid", self.lm_valid), ("active", active)):
            il.put(ib, name, a)
        out = self.solve_graph(0, (slot.f, slot.i))
        self._io.send(slot, out)
        # fmap[i] = CURRENT host window slot holding the solve's frame i
        # (-1 = dropped); both slides update it
        self._pending.append(dict(
            slot=slot, active=active.copy(), gen=self.gen.copy(),
            fmap=np.arange(cfg.num_frames)))

    def _sync_pending(self):
        """Apply every dispatched object solve (waits for each; at most
        one is pending, since every read applies it)."""
        while self._pending:
            self._apply_pending(self._pending.popleft())

    def _apply_pending(self, pend):
        """Apply one solve's results through its frame map (accounts for
        any mix of old / second-new window slides since dispatch)."""
        cfg = self.cfg
        O, F, Lo = cfg.max_objects, cfg.num_frames, cfg.lm_per_object
        ol = self._layouts[2]
        out = self._io.result(pend["slot"])
        p, q, v, w, dims, c_off, lm, cost = (
            ol.get(out, n) for n in ("p", "q", "v", "w", "dims", "c_off",
                                     "lm", "cost"))
        ok = (pend["active"] & self.active & (self.gen == pend["gen"])
              & np.isfinite(cost))
        fmap = pend["fmap"]
        src = np.flatnonzero(fmap >= 0)
        if not src.size:
            return
        idx = np.flatnonzero(ok)
        if not idx.size:
            return
        dst = fmap[src]
        self.p[np.ix_(idx, dst)] = p.reshape(O, F, 3)[np.ix_(idx, src)]
        self.q[np.ix_(idx, dst)] = q.reshape(O, F, 4)[np.ix_(idx, src)]
        self.v[idx] = v.reshape(O, 3)[idx]
        self.w[idx] = w.reshape(O, 3)[idx]
        self.dims[idx] = dims.reshape(O, 3)[idx]
        self.c_off[idx] = c_off.reshape(O, 3)[idx]
        self.lm[idx] = lm.reshape(O, Lo, 3)[idx]

    # ------------------------------------------------------------------
    def reject_outliers(self, thresh: float = 5.0 / 460.0,
                        p_cw=None, q_cw=None):
        """Reprojection-based object landmark culling
        (Instance::OutlierRejection parity): drop landmarks whose mean
        reprojection error across their observations exceeds thresh.
        Fully vectorized over (frame, landmark, cam) per object.

        p_cw/q_cw: ego world→camera poses [F,2,3]/[F,2,4] indexed in
        the CURRENT window; defaults to the poses captured at the last
        `optimize` (only valid if the window has not slid since)."""
        self._sync_pending()
        if p_cw is None:
            p_cw, q_cw = self._p_cw, self._q_cw
        if p_cw is None:
            return
        p_cw = np.asarray(p_cw)              # [F, 2, 3]
        q_cw = np.asarray(q_cw)              # [F, 2, 4]
        for s in np.flatnonzero(self.active & self.initialized):
            if not self.lm_valid[s].any():
                continue
            # world points of all landmarks at all frames [F, Lo, 3]
            pw = lie_np.quat_rotate(self.q[s][:, None, :],
                                    self.lm[s][None, :, :]) \
                + self.p[s][:, None, :]
            # camera points [F, Lo, cam, 3]
            pc = lie_np.quat_rotate(q_cw[:, None, :, :],
                                    pw[:, :, None, :]) \
                + p_cw[:, None, :, :]
            z = pc[..., 2]
            uv = pc[..., :2] / np.maximum(z[..., None], 1e-2)
            err = np.where(z < 1e-2, 1.0,
                           np.linalg.norm(uv - self.obs[s], axis=-1))
            valid = (self.obs_valid[s]
                     & self.frame_valid[s][:, None, None]
                     & self.lm_valid[s][None, :, None])
            cnt = valid.sum(axis=(0, 2))
            mean = (err * valid).sum(axis=(0, 2)) / np.maximum(cnt, 1)
            bad = (cnt > 0) & (mean > thresh)
            if bad.any():
                self.lm_valid[s, bad] = False
                self.lm_feat_id[s, bad] = -1
                self.obs_valid[s, :, bad, :] = False

    def manage(self):
        """Delete lost instances (ManageInstances,
        dynamic_tracker.cpp:499: lost_num > 3)."""
        for s in np.flatnonzero(self.active):
            if self.lost[s] > self.cfg.max_lost:
                self._free(s)

    def slide_window_new(self):
        """Non-keyframe margin (kMarginSecondNew): drop the
        second-newest frame's per-frame object data and move the newest
        into its slot (Instance::SlideWindowNew parity,
        estimator_insts.cpp:910 dispatch / instance.cpp SlideWindowNew)
        so object obs stay aligned with the ego window, which replaces
        slot F-2 with the newest state on this margin."""
        # a pending solve: its frame F-2 is dropped and its frame F-1
        # now lives in host slot F-2
        F = self.cfg.num_frames
        for pend in self._pending:
            fmap = pend["fmap"]
            fmap[fmap == F - 2] = -1
            fmap[fmap == F - 1] = F - 2
        F2, F1 = -2, -1
        for a in (self.p, self.q, self.frame_valid, self.obs,
                  self.obs_valid, self.extra, self.extra_valid,
                  self.q_det, self.det_valid):
            a[:, F2] = a[:, F1]
        for a in (self.frame_valid, self.obs_valid, self.extra_valid,
                  self.det_valid):
            a[:, F1] = False
        # cull landmarks whose only observation was the dropped frame
        has_obs = self.obs_valid.any(axis=(1, 3))
        dead = self.lm_valid & ~has_obs
        self.lm_valid[dead] = False
        self.lm_feat_id[dead] = -1
        # ego poses captured at the last optimize are indexed in the
        # pre-slide window; invalidate so a stale no-arg
        # reject_outliers returns instead of mis-projecting
        self._p_cw = self._q_cw = None

    def slide_window(self):
        """Shift all per-frame object data down one slot (SlideWindow,
        estimator_insts.cpp:910 / instance.cpp:35)."""
        for pend in self._pending:
            pend["fmap"] -= 1
            np.maximum(pend["fmap"], -1, out=pend["fmap"])
        self.p[:, :-1] = self.p[:, 1:]
        self.q[:, :-1] = self.q[:, 1:]
        self.frame_valid[:, :-1] = self.frame_valid[:, 1:]
        self.frame_valid[:, -1] = False
        self.obs[:, :-1] = self.obs[:, 1:]
        self.obs_valid[:, :-1] = self.obs_valid[:, 1:]
        self.obs_valid[:, -1] = False
        self.extra[:, :-1] = self.extra[:, 1:]
        self.extra_valid[:, :-1] = self.extra_valid[:, 1:]
        self.extra_valid[:, -1] = False
        self.q_det[:, :-1] = self.q_det[:, 1:]
        self.det_valid[:, :-1] = self.det_valid[:, 1:]
        self.det_valid[:, -1] = False
        # cull landmarks with no remaining observations
        has_obs = self.obs_valid.any(axis=(1, 3))
        dead = self.lm_valid & ~has_obs
        self.lm_valid[dead] = False
        self.lm_feat_id[dead] = -1
        # see slide_window_new: captured ego poses are now stale
        self._p_cw = self._q_cw = None

    def output(self):
        """Per-object state snapshot {track_id: dict} (SetOutputInstInfo
        / Output, estimator_insts.cpp:967), after the dispatched solve
        is applied (as the JAX package's `output(sync=True)`)."""
        self._sync_pending()
        out = {}
        for s in np.flatnonzero(self.active & self.initialized):
            frames = np.flatnonzero(self.frame_valid[s])
            if not frames.size:
                continue
            k = int(frames[-1])
            out[int(self.track_id[s])] = dict(
                p=self.p[s, k].copy(), q=self.q[s, k].copy(),
                v=self.v[s].copy(), w=self.w[s].copy(),
                dims=self.dims[s].copy(),
                is_static=bool(self.is_static[s]),
                cls=int(self.cls[s]))
        return out
