"""Background landmark store for the sliding-window estimator.

Capability parity with `FeatureManager`
(`dynamic_vins/src/estimator/feature_manager.{h,cpp}`): landmark
lifecycle (add with parallax-based keyframe decision, triangulate,
outlier removal, window-shift re-anchoring) over a fixed-capacity pool.

Design split: this class is host-side numpy bookkeeping (dynamic
lifecycle, id matching, slot allocation) and it emits fixed-capacity
tables (observation rows, inverse-depth vectors, masks) consumed by the
device solver. Row order is slot-major, then frame, then left before
right: the solver's index_add_ accumulation order follows it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dynamic_vins_tpu_torch.factors.projection import unpack_obs

# Reference thresholds (parameters.h, feature_manager.cpp)
MIN_PARALLAX = 10.0 / 460.0      # keyframe parallax (normalized plane)
DEFAULT_DEPTH = 5.0


@dataclass
class FeatureManager:
    """Fixed-capacity background landmark pool."""

    num_frames: int = 11          # window slots
    capacity: int = 512           # landmark slots
    obs_capacity: int = 8192      # projection rows emitted per solve
    min_parallax: float = MIN_PARALLAX

    def __post_init__(self):
        L, F = self.capacity, self.num_frames
        self.active = np.zeros(L, bool)
        self.feature_id = np.full(L, -1, np.int64)
        self.start_frame = np.zeros(L, np.int32)
        self.has_obs = np.zeros((L, F), bool)
        self.has_right = np.zeros((L, F), bool)
        self.pt = np.zeros((L, F, 3))          # left normalized, z=1
        self.pt_right = np.zeros((L, F, 3))
        self.vel = np.zeros((L, F, 3))
        self.vel_right = np.zeros((L, F, 3))
        self.inv_depth = np.full(L, 1.0 / DEFAULT_DEPTH)
        self.depth_valid = np.zeros(L, bool)
        self._id_to_slot: dict = {}
        # per-frame lifecycle deltas for the pipelined estimator's
        # device-resident masks: slots allocated by the last
        # add_features, slots killed by the last slide
        self.last_new_slots = np.zeros(L, bool)
        self.last_slide_dead = np.zeros(L, bool)

    # ------------------------------------------------------------------
    # frame ingestion
    # ------------------------------------------------------------------
    def add_features(self, frame: int, feats: dict) -> bool:
        """Add one frame of features; return True if keyframe (margin old).

        feats: {feature_id: (pt_left[3], vel_left[3], pt_right[3]|None,
        vel_right[3]|None)}. Mirrors AddFeatureCheckParallax
        (feature_manager.cpp:61-171): keyframe iff the frame brings few
        continuing tracks or mean compensated parallax is large.
        """
        last_track_num = 0
        self.last_new_slots = np.zeros(self.capacity, bool)
        for fid, (pl, vl, pr, vr) in feats.items():
            slot = self._id_to_slot.get(fid)
            if slot is None:
                slot = self._alloc()
                if slot is None:
                    continue
                self._id_to_slot[fid] = slot
                self.active[slot] = True
                self.feature_id[slot] = fid
                self.start_frame[slot] = frame
                self.last_new_slots[slot] = True
            else:
                last_track_num += 1
            self.has_obs[slot, frame] = True
            self.pt[slot, frame] = pl
            self.vel[slot, frame] = vl
            if pr is not None:
                self.has_right[slot, frame] = True
                self.pt_right[slot, frame] = pr
                self.vel_right[slot, frame] = vr if vr is not None else 0.0

        if frame < 2 or last_track_num < 20:
            return True
        # mean parallax between frame-2 and frame-1 for landmarks seen in both
        f1, f2 = frame - 1, frame - 2
        mask = self.active & self.has_obs[:, f1] & self.has_obs[:, f2]
        if not mask.any():
            return True
        d = self.pt[mask, f1, :2] - self.pt[mask, f2, :2]
        parallax = float(np.mean(np.linalg.norm(d, axis=-1)))
        return parallax >= self.min_parallax

    def _alloc(self):
        free = np.flatnonzero(~self.active)
        return int(free[0]) if free.size else None

    # ------------------------------------------------------------------
    # solver tables
    # ------------------------------------------------------------------
    def solvable_mask(self, min_obs: int = 2):
        """Landmarks entering BA: enough obs and valid depth."""
        total_obs = self.has_obs.sum(axis=1) + self.has_right.sum(axis=1)
        return self.active & self.depth_valid & (total_obs >= min_obs)

    def build_obs_table(self, dtype, device):
        """Emit the fixed-capacity ProjObs table + landmark mask as torch
        tensors: the packed rows of `build_obs_packed`, unpacked."""
        oi, of, valid, mask = self.build_obs_packed()
        obs = unpack_obs(torch.tensor(oi, device=device),
                         torch.tensor(of, dtype=dtype, device=device),
                         torch.tensor(valid, device=device))
        return obs, torch.tensor(mask, device=device)

    def build_obs_packed(self, extra_mask=None):
        """Packed obs table for single-transfer upload: returns numpy
        (ints [C,4], floats [C,9], valid [C], lm_valid [L]).

        extra_mask: slots to emit rows for as well (the megastep's
        triangulation candidates, whose rows the step gates by the
        validity it computes)."""
        mask = self.solvable_mask()
        slots = np.flatnonzero(mask if extra_mask is None
                               else (mask | extra_mask))
        C = self.obs_capacity
        oi = np.zeros((C, 4), np.int32)
        of = np.zeros((C, 9))
        valid = np.zeros(C, bool)
        if not slots.size:
            return oi, of, valid, mask
        # vectorized row emission (the python loop version was ~40 ms
        # per frame at capacity — on the hot path of every frame)
        A = self.start_frame[slots]                         # [n]
        anchored = self.has_obs[slots, A]                   # [n]
        slots = slots[anchored]
        A = A[anchored]
        F = self.num_frames
        ff = np.arange(F)[None, :]
        sel_l = self.has_obs[slots] & (ff > A[:, None])     # [n,F]
        sel_r = self.has_right[slots] & (ff >= A[:, None])
        si_l, f_l = np.nonzero(sel_l)
        si_r, f_r = np.nonzero(sel_r)
        si = np.concatenate([si_l, si_r])
        f = np.concatenate([f_l, f_r])
        cam = np.concatenate([np.zeros_like(f_l),
                              np.ones_like(f_r)])
        # original emission order: per slot, per frame, left then right
        order = np.lexsort((cam, f, si))
        si, f, cam = si[order], f[order], cam[order]
        s = slots[si]
        a = A[si]
        n = min(s.size, C)
        sl = slice(0, n)
        si, f, cam, s, a = si[:n], f[:n], cam[:n], s[:n], a[:n]
        oi[sl, 0] = a
        oi[sl, 1] = f
        oi[sl, 2] = cam
        oi[sl, 3] = s
        of[sl, 0:2] = self.pt[s, a, :2]
        of[sl, 4:6] = self.vel[s, a, :2]
        left = cam == 0
        pt_j = np.where(left[:, None], self.pt[s, f, :2],
                        self.pt_right[s, f, :2])
        vel_j = np.where(left[:, None], self.vel[s, f, :2],
                         self.vel_right[s, f, :2])
        of[sl, 2:4] = pt_j
        of[sl, 6:8] = vel_j
        valid[sl] = True
        return oi, of, valid, mask

    def obs_emit_mask(self, extra_mask=None):
        """The slots `build_obs_packed(extra_mask)` emits rows for
        (solvable or extra, with an anchor observation), as one [L] mask:
        the pipelined step builds the rows on the device from it."""
        mask = self.solvable_mask()
        m = mask if extra_mask is None else (mask | extra_mask)
        A = np.minimum(self.start_frame, self.num_frames - 1)
        return m & self.has_obs[np.arange(self.capacity), A]

    # ------------------------------------------------------------------
    # depth management
    # ------------------------------------------------------------------
    def set_depths(self, inv_depth, valid_update=None):
        """Write back solved inverse depths of the solvable slots (or of
        `valid_update`); cull negative depths (reference removes
        landmarks that solve to negative depth)."""
        inv_depth = np.asarray(inv_depth)
        mask = self.solvable_mask() if valid_update is None \
            else np.asarray(valid_update)
        self.inv_depth[mask] = inv_depth[mask]
        bad = mask & (inv_depth < 1e-4)
        self._remove_slots(np.flatnonzero(bad))

    def _remove_slots(self, slots):
        for s in slots:
            fid = self.feature_id[s]
            self._id_to_slot.pop(fid, None)
        self.active[slots] = False
        self.feature_id[slots] = -1
        self.has_obs[slots] = False
        self.has_right[slots] = False
        self.depth_valid[slots] = False
        self.inv_depth[slots] = 1.0 / DEFAULT_DEPTH

    def remove_outliers(self, bad_mask):
        self._remove_slots(np.flatnonzero(np.asarray(bad_mask)
                                          & self.active))

    # ------------------------------------------------------------------
    # window slide
    # ------------------------------------------------------------------
    def slide_old(self, new_anchor_depth_fn=None):
        """Slide out frame 0 (kMarginOld). Landmarks anchored at frame 0
        are re-anchored to frame 1 (RemoveBackShiftDepth semantics):
        new_anchor_depth_fn(slots) -> new inverse depths in frame-1's
        left camera, or None to invalidate depth."""
        anchored0 = self.active & (self.start_frame == 0)
        # re-anchor depths before shifting obs
        if new_anchor_depth_fn is not None:
            slots = np.flatnonzero(anchored0 & self.has_obs[:, 1]
                                   & self.depth_valid)
            if slots.size:
                new_inv = new_anchor_depth_fn(slots)
                ok = np.isfinite(new_inv) & (new_inv > 1e-4)
                self.inv_depth[slots[ok]] = new_inv[ok]
                self.depth_valid[slots[~ok]] = False
        else:
            self.depth_valid[anchored0] = False

        # shift obs down one slot
        self.has_obs[:, :-1] = self.has_obs[:, 1:]
        self.has_obs[:, -1] = False
        self.has_right[:, :-1] = self.has_right[:, 1:]
        self.has_right[:, -1] = False
        for arr in (self.pt, self.pt_right, self.vel, self.vel_right):
            arr[:, :-1] = arr[:, 1:]
        self.start_frame = np.maximum(self.start_frame - 1, 0)

        # drop landmarks with no remaining obs
        dead = self.active & ~self.has_obs.any(axis=1)
        self.last_slide_dead = dead.copy()
        self._remove_slots(np.flatnonzero(dead))

    def slide_new(self):
        """Discard second-newest frame obs (kMarginSecondNew): obs of
        frame F-1 move into slot F-2 (newest keeps its data)."""
        F = self.num_frames
        f_new, f_second = F - 1, F - 2
        # landmarks anchored at the discarded frame are anchored at the
        # newest frame's data, which now sits in slot F-2
        self.has_obs[:, f_second] = self.has_obs[:, f_new]
        self.has_right[:, f_second] = self.has_right[:, f_new]
        for arr in (self.pt, self.pt_right, self.vel, self.vel_right):
            arr[:, f_second] = arr[:, f_new]
        self.has_obs[:, f_new] = False
        self.has_right[:, f_new] = False
        dead = self.active & ~self.has_obs.any(axis=1)
        self.last_slide_dead = dead.copy()
        self._remove_slots(np.flatnonzero(dead))
