"""Per-instance (dynamic object) feature tracking, batched.

The reference's InstsFeatManager (`front_end/dynamic_tracker.cpp:348`
InstsTrack): per-object LK tracking of masked features, per-object
corner top-up inside the eroded instance mask (kMaxDynamicCnt /
kMinDynamicDist), stereo left->right tracking, undistortion, and the
"extra points" grid-sampled from the disparity inside each mask
(`instance_feature.cpp:413` DetectExtraPoints: depth = fx*baseline/disp)
with a largest-cluster filter in place of PCL's radius and Euclidean
clustering.

All K instances ride one fused device step a frame: their K*N feature
rows are tracked together on the full-image pyramids (one LK track for
the temporal pair, one for the stereo pair: the radius-8 CUDA kernel on
the card), the corner candidates of every instance come from one masked
Shi-Tomasi pass, and the extra points of all K objects are lifted to
the world and clustered in one batched call. One packed fetch brings
the results back; the per-instance slot bookkeeping is host numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple

import numpy as np
import torch

from dynamic_vins_tpu_torch.estimator import box_fit
from dynamic_vins_tpu_torch.frontend import corners, lk
from dynamic_vins_tpu_torch.frontend.tracker import upload_stack
from dynamic_vins_tpu_torch.geometry import camera as cam
from dynamic_vins_tpu_torch.geometry import lie, lie_np
from dynamic_vins_tpu_torch.utils.precision import resolve_device


@dataclass
class InstanceTrackerConfig:
    max_dynamic_cnt: int = 50        # fe_para.kMaxDynamicCnt
    min_dynamic_dist: int = 8        # fe_para.kMinDynamicDist
    max_instances: int = 8           # batched instance capacity
    levels: int = 3
    radius: int = 8
    iters: int = 10
    fb_thresh: float = 1.0
    erode_iters: int = 2
    extra_grid: int = 6              # disparity sample stride (px)
    extra_max: int = 64
    cluster_radius: float = 1.5
    dtype: torch.dtype = torch.float32


class InstTrackHandle(NamedTuple):
    """A dispatched instance-tracker frame whose result is not fetched."""

    packed: torch.Tensor         # None when no instance was present
    present: tuple               # tids tracked this frame
    eroded: dict                 # tid -> eroded mask (host)
    use_right: bool
    use_extra: bool


def _erode3_np(m: np.ndarray, iters: int) -> np.ndarray:
    """3x3 binary erosion, host numpy."""
    for _ in range(iters):
        p = np.pad(m, 1, constant_values=False)
        m = (p[:-2, 1:-1] & p[2:, 1:-1] & p[1:-1, :-2] & p[1:-1, 2:]
             & p[1:-1, 1:-1] & p[:-2, :-2] & p[:-2, 2:] & p[2:, :-2]
             & p[2:, 2:])
    return m


class InstanceTracker:
    def __init__(self, config: InstanceTrackerConfig,
                 intr: cam.PinholeIntrinsics, baseline: float,
                 p_bc, q_bc, device=None):
        self.cfg = config
        self.device = resolve_device(device)
        self.intr = intr.to(self.device, config.dtype)
        self.baseline = baseline
        self._fx = float(intr.fx)      # host copy: no device read a frame
        self.p_bc = np.asarray(p_bc)
        self.q_bc = np.asarray(q_bc)
        K, N = config.max_instances, config.max_dynamic_cnt
        self.pts = np.zeros((K, N, 2), np.float32)
        self.ids = np.full((K, N), -1, np.int64)
        self.valid = np.zeros((K, N), bool)
        self._row_of: Dict[int, int] = {}       # tid -> row
        self.prev_img = None
        self._fid_base = 0
        self._cand = K * N // 2 if K * N >= 64 else K * N
        self._tracker = lk.make_tracker(config.levels, config.radius,
                                        config.iters, config.fb_thresh,
                                        device=self.device)

    # ------------------------------------------------------------------
    def _fused(self, prev_img, imgs, pts, valid, allow_mask, ex_uv,
               ex_depth, ex_valid, p_wc, q_wc, use_right, use_extra):
        """imgs [1|2,H,W] in their own dtype (the feature tracker's
        upload); pts [K*N,2], valid [K*N]; allow_mask [H,W] True inside
        the merged eroded instance masks; ex_* [K,E,...]. Returns the
        cast left image (the next prev_img) and the packed result."""
        cfg = self.cfg
        intr = self.intr
        img = imgs[0].to(cfg.dtype)
        img_r = imgs[1].to(cfg.dtype) if use_right else img
        p1, ok = self._tracker(prev_img, img, pts, valid)
        ok = ok & valid
        p1 = torch.where(ok[:, None], p1, pts)
        und = cam.normalized_from_pixel(intr, p1)
        if use_right:
            pr, okr = self._tracker(img, img_r, p1, ok)
            und_r = cam.normalized_from_pixel(intr, pr)
        else:
            okr = torch.zeros_like(ok)
            und_r = und

        cpts, _, cfound = corners.detect(
            img, max_corners=self._cand, min_dist=cfg.min_dynamic_dist,
            exclude_pts=p1, exclude_valid=ok, border=2,
            allow_mask=allow_mask)
        und_c = cam.normalized_from_pixel(intr, cpts)

        if use_extra:
            und_e = cam.normalized_from_pixel(
                intr, ex_uv.reshape(-1, 2)).reshape(ex_uv.shape)
            pc = torch.cat([und_e * ex_depth[..., None],
                            ex_depth[..., None]], dim=-1)     # [K,E,3]
            pw = lie.quat_rotate(q_wc, pc) + p_wc
            keep = box_fit.largest_cluster(pw, ex_valid,
                                           radius=cfg.cluster_radius)
        else:
            pw = torch.zeros(ex_uv.shape[:2] + (3,), dtype=cfg.dtype,
                             device=img.device)
            keep = torch.zeros(ex_uv.shape[:2], dtype=torch.bool,
                               device=img.device)
        f = lambda a: a.to(torch.float32).reshape(-1)
        return img, torch.cat([f(p1), f(und), f(und_r), f(ok), f(okr),
                               f(cpts), f(und_c), f(cfound), f(pw),
                               f(keep)])

    # ------------------------------------------------------------------
    def track(self, img, masks: Dict[int, np.ndarray], img_right=None,
              disparity=None, ego_pose=None):
        """Track all instances of one frame (one fused step).

        masks: {track_id: bool [H,W]} instance masks (associated by MOT);
        disparity: optional [H,W]; ego_pose: (p_wb, q_wb) to lift the
        extra points to the world. Returns {track_id: dict(features=
        {fid: (pt_l, pt_r|None)}, extra_pts_world)}, the
        InstanceManager.push_frame format."""
        return self.track_collect(self.track_begin(
            img, masks, img_right=img_right, disparity=disparity,
            ego_pose=ego_pose))

    def track_begin(self, img, masks: Dict[int, np.ndarray],
                    img_right=None, disparity=None, ego_pose=None,
                    imgs_dev=None) -> InstTrackHandle:
        """Host pre-work and the fused step; `track_collect` fetches it
        and must run before the next `track_begin` (the host slot state
        feeds the next step). imgs_dev: the frame's [1|2,H,W] stack the
        feature tracker already uploaded (no second upload)."""
        cfg = self.cfg
        K, N, E = cfg.max_instances, cfg.max_dynamic_cnt, cfg.extra_max

        # drop the rows of instances not present; assign rows
        for tid in [t for t in self._row_of if t not in masks]:
            r = self._row_of.pop(tid)
            self.valid[r] = False
            self.ids[r] = -1
        used = set(self._row_of.values())
        present = []
        for tid in list(masks.keys())[:K]:
            if tid not in self._row_of:
                free = next((r for r in range(K) if r not in used), None)
                if free is None:
                    continue              # over capacity: skip tid
                used.add(free)
                self._row_of[tid] = free
                self.valid[free] = False
                self.ids[free] = -1
            present.append(tid)
        if imgs_dev is None:
            imgs_dev = upload_stack(img, img_right, self.device)
        if not present:
            self.prev_img = imgs_dev[0].to(cfg.dtype)
            return InstTrackHandle(None, (), {}, False, False)

        H, W = imgs_dev.shape[1:]
        eroded = {tid: _erode3_np(np.asarray(masks[tid]), cfg.erode_iters)
                  for tid in present}
        allow = np.zeros((H, W), bool)
        for tid in present:
            allow |= eroded[tid]

        use_extra = disparity is not None and ego_pose is not None
        ex_uv = np.zeros((K, E, 2), np.float32)
        ex_depth = np.zeros((K, E), np.float32)
        ex_valid = np.zeros((K, E), bool)
        if use_extra:
            disp_np = np.asarray(disparity)
            fx = self._fx
            g = cfg.extra_grid
            for tid in present:
                r = self._row_of[tid]
                ys, xs = np.mgrid[g // 2:H:g, g // 2:W:g]
                ys, xs = ys.ravel(), xs.ravel()
                sel = eroded[tid][ys, xs]
                d = disp_np[ys, xs]
                sel &= d > 0.5
                ys, xs, d = ys[sel], xs[sel], d[sel]
                depth = fx * self.baseline / np.maximum(d, 1e-6)
                okd = (depth > 0.5) & (depth < 80.0)
                ys, xs, depth = ys[okd], xs[okd], depth[okd]
                if len(xs) < 4:
                    continue
                if len(xs) > E:
                    idx = np.linspace(0, len(xs) - 1, E).astype(int)
                    ys, xs, depth = ys[idx], xs[idx], depth[idx]
                n = len(xs)
                ex_uv[r, :n] = np.stack([xs, ys], -1)
                ex_depth[r, :n] = depth
                ex_valid[r, :n] = True

        if ego_pose is not None:
            p_wb, q_wb = ego_pose
            p_wc, q_wc = lie_np.pose_compose(
                np.asarray(p_wb, float), np.asarray(q_wb, float),
                self.p_bc, self.q_bc)
        else:
            p_wc, q_wc = np.zeros(3), np.array([1.0, 0, 0, 0])

        use_right = int(imgs_dev.shape[0]) >= 2
        first = self.prev_img is None
        prev = imgs_dev[0].to(cfg.dtype) if first else self.prev_img
        valid_in = np.zeros(K * N, bool) if first \
            else self.valid.reshape(-1)
        dev = self.device
        up = lambda a, dt=None: torch.from_numpy(
            np.ascontiguousarray(a)).to(dev, dt)
        img_res, packed = self._fused(
            prev, imgs_dev, up(self.pts.reshape(-1, 2), cfg.dtype),
            up(valid_in), up(allow), up(ex_uv, cfg.dtype),
            up(ex_depth, cfg.dtype), up(ex_valid),
            up(np.asarray(p_wc, np.float64), cfg.dtype),
            up(np.asarray(q_wc, np.float64), cfg.dtype),
            use_right, use_extra)
        self.prev_img = img_res
        return InstTrackHandle(packed, tuple(present), eroded, use_right,
                               use_extra)

    def track_collect(self, handle: InstTrackHandle):
        """Fetch + unpack a dispatched frame; host per-instance slot
        bookkeeping. Must run before the next `track_begin`."""
        cfg = self.cfg
        K, N, E = cfg.max_instances, cfg.max_dynamic_cnt, cfg.extra_max
        if handle is None or handle.packed is None:
            return {}
        present = list(handle.present)
        eroded = handle.eroded
        out = handle.packed.cpu().numpy()

        KN, CAND = K * N, self._cand
        sizes = [2 * KN, 2 * KN, 2 * KN, KN, KN, 2 * CAND, 2 * CAND,
                 CAND, 3 * K * E]
        p1, und, und_r, okf, okrf, cptsf, cundf, cfoundf, pwf, keepf \
            = np.split(out, np.cumsum(sizes))
        p1 = p1.reshape(K, N, 2)
        und = und.reshape(K, N, 2)
        und_r = und_r.reshape(K, N, 2)
        ok = (okf > 0.5).reshape(K, N)
        ok_r = (okrf > 0.5).reshape(K, N)
        cpts = cptsf.reshape(CAND, 2)
        cund = cundf.reshape(CAND, 2)
        cfound = cfoundf > 0.5
        pw = pwf.reshape(K, E, 3)
        keep = (keepf > 0.5).reshape(K, E)

        cand_used = np.zeros(CAND, bool)
        out_dict = {}
        for tid in present:
            r = self._row_of[tid]
            m_er = eroded[tid]
            okr_row = ok[r] & self._mask_ok(m_er, p1[r])
            self.pts[r] = np.where(okr_row[:, None], p1[r], self.pts[r])
            self.valid[r] = okr_row
            row_und = und[r]

            # top-up from the shared candidate pool, inside THIS mask
            need = N - int(okr_row.sum())
            if need > 0:
                avail = cfound & ~cand_used & self._mask_ok(m_er, cpts)
                cand_idx = np.flatnonzero(avail)[:need]
                free_slots = np.flatnonzero(~self.valid[r])[
                    :cand_idx.size]
                if cand_idx.size:
                    cand_used[cand_idx] = True
                    self.pts[r, free_slots] = cpts[cand_idx]
                    self.ids[r, free_slots] = self._fid_base + \
                        np.arange(cand_idx.size)
                    self._fid_base += cand_idx.size
                    self.valid[r, free_slots] = True
                    row_und = row_und.copy()
                    row_und[free_slots] = cund[cand_idx]

            feats = {}
            for i in np.flatnonzero(self.valid[r]):
                pl = np.array([row_und[i, 0], row_und[i, 1], 1.0])
                pr = np.array([und_r[r, i, 0], und_r[r, i, 1], 1.0]) \
                    if ok_r[r, i] else None
                feats[int(self.ids[r, i])] = (pl, pr)

            extra_world = None
            if handle.use_extra and keep[r].any():
                extra_world = pw[r][keep[r]]
            out_dict[tid] = dict(features=feats,
                                 extra_pts_world=extra_world)
        return out_dict

    @staticmethod
    def _mask_ok(mask, pts):
        H, W = mask.shape
        xi = np.clip(pts[:, 0].astype(int), 0, W - 1)
        yi = np.clip(pts[:, 1].astype(int), 0, H - 1)
        return mask[yi, xi]
