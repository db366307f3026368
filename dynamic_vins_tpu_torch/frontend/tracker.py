"""Background feature tracker: LK tracking + corner top-up + stereo,
then host id/velocity/RANSAC-F bookkeeping.

Per frame (the reference's FeatureTracker::TrackImage / TrackImageNaive):
  * LK-track the previous features into the current frame (forward-
    backward check, border check; with a mask, tracked points that land
    where it is False are dropped); given a dense flow field (previous
    -> current frame, `use_dense_flow`), sample it at the features
    instead (FeatureTrackByDenseFlow, no backward check), except on the
    first frame,
  * top up to `max_cnt` with Shi-Tomasi corners away from survivors
    (and, with a mask, only where it is True),
  * left -> right LK for the stereo observations,
  * undistort to normalized coords; on the host: ids, track counts,
    epipolar (RANSAC-F) outlier kills and pixel velocities.

The feature slots, their validity and the previous image stay on the
device between frames: `track_begin` uploads one stacked image pair and
runs the fused step, `track_collect` makes one device-to-host copy of a
packed result. RANSAC-F kills ride the next frame's step as a kill mask.
"""

from __future__ import annotations

import contextlib
import time as _time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from dynamic_vins_tpu_torch.estimator.estimator import FrameFeatures
from dynamic_vins_tpu_torch.frontend import corners, fundamental, lk
from dynamic_vins_tpu_torch.geometry import camera as cam
from dynamic_vins_tpu_torch.utils.precision import resolve_device


@dataclass
class TrackerConfig:
    max_cnt: int = 150            # fe_para.kMaxCnt
    min_dist: int = 16            # fe_para.kMinDist
    levels: int = 4
    radius: int = 10
    iters: int = 10
    fb_thresh: float = 0.5
    border: int = 8
    stereo: bool = True
    use_ransac_f: bool = True     # rejectWithF
    f_threshold_px: float = 1.0
    focal: float = 460.0
    dtype: torch.dtype = torch.float32


def mask_at(mask, pts):
    """mask [H,W] bool at the pixels of pts [N,2] (truncated, clamped
    inside the image) -> [N] bool."""
    H, W = mask.shape
    xi = torch.clamp(pts[:, 0].to(torch.int64), 0, W - 1)
    yi = torch.clamp(pts[:, 1].to(torch.int64), 0, H - 1)
    return mask[yi, xi]


def upload_stack(img, img_right, device):
    """One frame's images as a [1|2,H,W] stack on the device, in their
    own dtype (the trackers cast on the device)."""
    img_np = np.asarray(img)
    stack = img_np[None] if img_right is None else \
        np.stack([img_np, np.asarray(img_right, img_np.dtype)])
    return torch.from_numpy(stack).to(device)


class TrackHandle(NamedTuple):
    """A dispatched frame whose packed result is not collected yet."""

    timestamp: float
    packed: torch.Tensor
    use_right: bool
    killed: np.ndarray            # host kill mask this step consumed


class FeatureTracker:
    def __init__(self, config: TrackerConfig,
                 intr_left: cam.PinholeIntrinsics,
                 intr_right: Optional[cam.PinholeIntrinsics] = None,
                 device=None):
        self.cfg = config
        self.device = resolve_device(device)
        self.intr_left = intr_left.to(self.device, config.dtype)
        self.intr_right = (intr_right if intr_right is not None
                           else intr_left).to(self.device, config.dtype)
        N = config.max_cnt
        self.pts = np.zeros((N, 2), np.float32)
        self.ids = np.full(N, -1, np.int64)
        self.track_cnt = np.zeros(N, np.int32)
        self.valid = np.zeros(N, bool)
        self.prev_und = np.zeros((N, 2), np.float32)
        self.prev_time = None
        self._next_id = 0
        self._dev = None              # (prev image, pts, valid) on device
        self._kill = np.zeros(N, bool)
        # kills not yet consumed by a dispatched step
        self._pending_kill = np.zeros(N, bool)
        self.timer = None
        self._tracker = lk.make_tracker(
            config.levels, config.radius, config.iters, config.fb_thresh,
            config.border, device=self.device)

    # ------------------------------------------------------------------
    def _fused(self, prev_img, imgs, pts, valid, kill, use_right,
               mask=None, flow=None):
        cfg = self.cfg
        N = cfg.max_cnt
        img = imgs[0].to(cfg.dtype)
        img_r = imgs[1].to(cfg.dtype) if use_right else img
        valid = valid & ~kill
        if flow is not None:
            p1, ok = lk.track_by_dense_flow(flow, pts, valid,
                                            fb_thresh=cfg.fb_thresh,
                                            border=cfg.border)
        else:
            p1, ok = self._tracker(prev_img, img, pts, valid)
        ok = ok & valid
        if mask is not None:
            ok = ok & mask_at(mask, p1)
        pts_a = torch.where(ok[:, None], p1, pts)

        cpts, _, cfound = corners.detect(
            img, max_corners=N, min_dist=cfg.min_dist, exclude_pts=pts_a,
            exclude_valid=ok, border=cfg.border)
        if mask is not None:
            cfound = cfound & mask_at(mask, cpts)
        # greedy slot assignment: found corners are a score-sorted
        # prefix; free slots (invalid first) take them in order
        free = torch.argsort(ok.to(torch.uint8), stable=True)
        num_free = N - ok.sum()
        take = (torch.arange(N, device=img.device) < num_free) & cfound
        pts_b = pts_a.clone()
        pts_b[free] = torch.where(take[:, None], cpts, pts_a[free])
        newly = torch.zeros(N, dtype=torch.bool, device=img.device)
        newly[free] = take
        valid_b = ok | newly

        und = cam.normalized_from_pixel(self.intr_left, pts_b)
        if use_right:
            pr, okr = self._tracker(img, img_r, pts_b, valid_b)
            und_r = cam.normalized_from_pixel(self.intr_right, pr)
        else:
            okr = torch.zeros(N, dtype=torch.bool, device=img.device)
            und_r = und
        f = lambda a: a.to(torch.float32).reshape(-1)
        packed = torch.cat([f(pts_b), f(und), f(und_r), f(ok), f(newly),
                            f(okr)])
        return img, pts_b, valid_b, packed

    def _st(self, name: str):
        return self.timer.stage(name) if self.timer is not None \
            else contextlib.nullcontext()

    def track_begin(self, img, timestamp: float, mask=None,
                    img_right=None, flow=None,
                    imgs_dev=None) -> TrackHandle:
        """Upload + run the fused step for one frame.

        mask: optional [H,W] bool, True where tracking is allowed.
        flow: optional [H,W,2] dense flow from the previous frame (a
        tensor, left where it lies, or numpy); used from the second
        frame on in place of the temporal LK track.
        imgs_dev: the frame's [1|2,H,W] stack already on the device (the
        System uploads it once and shares it with the instance tracker);
        img / img_right are then not read."""
        cfg = self.cfg
        if imgs_dev is not None:
            use_right = bool(cfg.stereo and imgs_dev.shape[0] >= 2)
        else:
            use_right = bool(cfg.stereo and img_right is not None)
        with self._st("fe.upload"):
            imgs = imgs_dev if imgs_dev is not None else upload_stack(
                img, img_right if use_right else None, self.device)
            mask_dev = None if mask is None else \
                torch.from_numpy(np.asarray(mask, bool)).to(self.device)
        use_flow = flow is not None and self._dev is not None
        flow_dev = torch.as_tensor(flow).to(self.device, cfg.dtype) \
            if use_flow else None
        if self._dev is None:
            N = cfg.max_cnt
            prev = imgs[0].to(cfg.dtype)
            pts = torch.zeros((N, 2), dtype=cfg.dtype, device=self.device)
            valid = torch.zeros(N, dtype=torch.bool, device=self.device)
        else:
            prev, pts, valid = self._dev
        kill_np = self._kill
        self._kill = np.zeros(cfg.max_cnt, bool)
        with self._st("fe.dispatch"):
            img2, pts2, valid2, packed = self._fused(
                prev, imgs, pts, valid,
                torch.from_numpy(kill_np.copy()).to(self.device),
                use_right, mask_dev, flow_dev)
        self._dev = (img2, pts2, valid2)
        return TrackHandle(timestamp, packed, use_right, kill_np)

    def track_collect(self, handle: TrackHandle) -> FrameFeatures:
        """Fetch + unpack a dispatched frame; host id/velocity/RANSAC
        bookkeeping. Call in dispatch order."""
        cfg = self.cfg
        N = cfg.max_cnt
        timestamp = handle.timestamp
        with self._st("fe.fetch"):
            out = handle.packed.cpu().numpy()
        t_host0 = _time.perf_counter()
        pts_b, und, und_r, okf, newf, okrf = np.split(
            out, np.cumsum([2 * N, 2 * N, 2 * N, N, N]))
        self.pts = pts_b.reshape(N, 2).astype(np.float32)
        und = und.reshape(N, 2)
        und_r = und_r.reshape(N, 2)
        tracked = okf > 0.5
        newly = newf > 0.5
        ok_r = okrf > 0.5

        self._pending_kill &= ~handle.killed
        tracked &= ~self._pending_kill
        newly &= ~self._pending_kill

        self.track_cnt = np.where(tracked, self.track_cnt + 1, 0)
        slots = np.flatnonzero(newly)
        self.ids[slots] = np.arange(self._next_id,
                                    self._next_id + slots.size)
        self._next_id += slots.size
        self.track_cnt[slots] = 1
        self.valid = tracked | newly

        # epipolar outlier rejection; kills ride the NEXT step
        sel = np.flatnonzero(self.valid & (self.track_cnt > 1))
        inl = fundamental.ransac_fundamental(
            self.prev_und[sel] * cfg.focal, und[sel] * cfg.focal,
            cfg.f_threshold_px, 0.99) if cfg.use_ransac_f else None
        if inl is not None:
            bad = sel[~inl]
            self.valid[bad] = False
            self._kill[bad] = True
            self._pending_kill[bad] = True

        dt = (timestamp - self.prev_time) if self.prev_time else 1.0
        dt = max(dt, 1e-3)
        vel = np.zeros_like(und)
        cont = self.valid & (self.track_cnt > 1)
        vel[cont] = (und[cont] - self.prev_und[cont]) / dt

        feats = {}
        for i in np.flatnonzero(self.valid):
            pl = np.array([und[i, 0], und[i, 1], 1.0])
            vl = np.array([vel[i, 0], vel[i, 1], 0.0])
            if handle.use_right and ok_r[i]:
                pr = np.array([und_r[i, 0], und_r[i, 1], 1.0])
                feats[int(self.ids[i])] = (pl, vl, pr, np.zeros(3))
            else:
                feats[int(self.ids[i])] = (pl, vl, None, None)

        self.prev_und = und
        self.prev_time = timestamp
        if self.timer is not None:
            self.timer.totals["fe.host"] += _time.perf_counter() - t_host0
            self.timer.counts["fe.host"] += 1
        return FrameFeatures(timestamp, feats)

    def track(self, img, timestamp: float, mask=None,
              img_right=None, flow=None, imgs_dev=None) -> FrameFeatures:
        """Process one grayscale [H,W] frame (and its right image).

        mask: optional [H,W] bool, True where tracking is allowed (the
        reference's inv_merge_mask); flow: as `track_begin`."""
        return self.track_collect(self.track_begin(
            img, timestamp, mask=mask, img_right=img_right, flow=flow,
            imgs_dev=imgs_dev))
