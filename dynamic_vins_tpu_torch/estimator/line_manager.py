"""Line landmarks of the sliding-window estimator (LinePoint mode).

Slots with persistent ids, per-frame left/right endpoint observations
(normalized, z = 1), host triangulation by a multi-view plane fit gated
by the reprojection error, the solve's observation table, outlier
removal (mean endpoint-to-line distance above 5/460) and the window
slides. Lines live in the world frame (4-dof orth parameters), so a
slide moves no line. Host numpy; only `build_obs_table` makes tensors,
on the device it is given.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dynamic_vins_tpu_torch.factors.line_factor import unpack_obs
from dynamic_vins_tpu_torch.geometry import lie_np


@dataclass
class LineManager:
    num_frames: int = 11
    capacity: int = 64
    obs_capacity: int = 512

    def __post_init__(self):
        Lc, F = self.capacity, self.num_frames
        self.active = np.zeros(Lc, bool)
        self.line_id = np.full(Lc, -1, np.int64)
        self.has_obs = np.zeros((Lc, F), bool)
        self.has_right = np.zeros((Lc, F), bool)
        self.s = np.zeros((Lc, F, 3))
        self.e = np.zeros((Lc, F, 3))
        self.s_r = np.zeros((Lc, F, 3))
        self.e_r = np.zeros((Lc, F, 3))
        self.orth = np.zeros((Lc, 4))
        self.orth_valid = np.zeros(Lc, bool)
        self._id_to_slot: dict = {}

    def add_lines(self, frame: int, lines: dict):
        """lines: {line_id: (s_l[3], e_l[3], s_r[3]|None, e_r[3]|None)}."""
        for lid, (sl, el, sr, er) in lines.items():
            slot = self._id_to_slot.get(lid)
            if slot is None:
                free = np.flatnonzero(~self.active)
                if not free.size:
                    continue
                slot = int(free[0])
                self._id_to_slot[lid] = slot
                self.active[slot] = True
                self.line_id[slot] = lid
                self.orth_valid[slot] = False
            self.has_obs[slot, frame] = True
            self.s[slot, frame] = sl
            self.e[slot, frame] = el
            if sr is not None:
                self.has_right[slot, frame] = True
                self.s_r[slot, frame] = sr
                self.e_r[slot, frame] = er

    def _camera_poses(self, st, k, c):
        """World -> camera c of window frame k."""
        p_wc, q_wc = lie_np.pose_compose(
            np.asarray(st.p[k], float), np.asarray(st.q[k], float),
            np.asarray(st.p_bc[c], float), np.asarray(st.q_bc[c], float))
        return lie_np.pose_inverse(p_wc, q_wc)

    def triangulate(self, state, frame: int, min_base_frames: int = 3,
                    min_baseline: float = 0.15):
        """World lines of the untriangulated slots by the multi-view fit
        over all their left and right observations up to `frame`; needs
        `min_base_frames` views spanning `min_baseline` metres, and a
        mean reprojection error below 2/460. `state`: any object with
        p, q, p_bc, q_bc arrays."""
        st = state
        for slot in np.flatnonzero(self.active & ~self.orth_valid):
            frames = np.flatnonzero(self.has_obs[slot, :frame + 1])
            if frames.size < min_base_frames:
                continue
            k0, k1 = int(frames[0]), int(frames[-1])
            if np.linalg.norm(np.asarray(st.p[k1])
                              - np.asarray(st.p[k0])) < min_baseline:
                continue
            views = [(int(k), 0) for k in frames]
            views += [(int(k), 1) for k in frames if self.has_right[slot, k]]
            p_cw = np.zeros((len(views), 3))
            q_cw = np.zeros((len(views), 4))
            ss = np.zeros((len(views), 3))
            ee = np.zeros((len(views), 3))
            for i, (k, c) in enumerate(views):
                p_cw[i], q_cw[i] = self._camera_poses(st, k, c)
                src = (self.s, self.e) if c == 0 else (self.s_r, self.e_r)
                ss[i] = src[0][slot, k]
                ee[i] = src[1][slot, k]
            n_w, d_w = _triangulate_line_multiview_np(p_cw, q_cw, ss, ee)
            if not (np.all(np.isfinite(n_w)) and np.all(np.isfinite(d_w))
                    and np.linalg.norm(d_w) > 1e-8):
                continue
            orth = plucker_to_orth_np(n_w, d_w)
            if not np.all(np.isfinite(orth)):
                continue
            # near-parallel viewing planes give wildly wrong lines
            if self._reproj_error(st, slot, n_w, d_w, frame) > 2.0 / 460.0:
                continue
            self.orth[slot] = orth
            self.orth_valid[slot] = True

    def _reproj_error(self, st, slot, n_w, d_w, frame):
        """Mean endpoint-to-projected-line distance over the left
        observations up to `frame`."""
        errs = []
        for k in np.flatnonzero(self.has_obs[slot, :frame + 1]):
            p_cw, q_cw = self._camera_poses(st, k, 0)
            R = lie_np.quat_to_matrix(q_cw)
            d_c = R @ d_w
            n_c = R @ n_w + np.cross(p_cw, d_c)
            denom = max(np.hypot(n_c[0], n_c[1]), 1e-12)
            errs.append(abs(np.dot(n_c, self.s[slot, k])) / denom)
            errs.append(abs(np.dot(n_c, self.e[slot, k])) / denom)
        return float(np.mean(errs)) if errs else 1e9

    def build_obs_packed(self):
        """The solve's observation rows, slot-major, frame, left before
        right: (l_oi [C,3] int (frame, cam, slot), l_of [C,4] (start
        xy, end xy), valid [C] bool, line mask [Lc] bool)."""
        mask = self.active & self.orth_valid
        C = self.obs_capacity
        li = np.zeros((C, 3), np.int32)
        lf = np.zeros((C, 4))
        lvalid = np.zeros(C, bool)
        i = 0
        for slot in np.flatnonzero(mask):
            for f in np.flatnonzero(self.has_obs[slot]):
                if i >= C:
                    break
                li[i] = (f, 0, slot)
                lf[i, 0:2] = self.s[slot, f, :2]
                lf[i, 2:4] = self.e[slot, f, :2]
                lvalid[i] = True
                i += 1
                if self.has_right[slot, f] and i < C:
                    li[i] = (f, 1, slot)
                    lf[i, 0:2] = self.s_r[slot, f, :2]
                    lf[i, 2:4] = self.e_r[slot, f, :2]
                    lvalid[i] = True
                    i += 1
        return li, lf, lvalid, mask

    def build_obs_table(self, dtype, device):
        """(LineObs, line mask [Lc]) of `build_obs_packed`'s rows as
        tensors on `device`."""
        li, lf, lvalid, mask = self.build_obs_packed()
        obs = unpack_obs(torch.tensor(li, device=device),
                         torch.tensor(lf, dtype=dtype, device=device),
                         torch.tensor(lvalid, device=device))
        return obs, torch.tensor(mask, device=device)

    def set_orth(self, orth, updated_mask=None):
        m = self.active & self.orth_valid if updated_mask is None \
            else np.asarray(updated_mask)
        self.orth[m] = np.asarray(orth)[m]

    def remove_outliers(self, errors, thresh: float = 5.0 / 460.0):
        """Drop the lines whose mean endpoint-to-line distance is above
        thresh."""
        bad = self.active & self.orth_valid & (np.asarray(errors) > thresh)
        self._remove(np.flatnonzero(bad))

    def _remove(self, slots):
        for slot in slots:
            self._id_to_slot.pop(int(self.line_id[slot]), None)
        self.active[slots] = False
        self.line_id[slots] = -1
        self.has_obs[slots] = False
        self.has_right[slots] = False
        self.orth_valid[slots] = False

    def slide_old(self):
        for a in (self.has_obs, self.has_right, self.s, self.e, self.s_r,
                  self.e_r):
            a[:, :-1] = a[:, 1:].copy()
        self.has_obs[:, -1] = False
        self.has_right[:, -1] = False
        self._remove(np.flatnonzero(self.active & ~self.has_obs.any(axis=1)))

    def slide_new(self):
        F = self.num_frames
        for a in (self.has_obs, self.has_right, self.s, self.e, self.s_r,
                  self.e_r):
            a[:, F - 2] = a[:, F - 1]
        self.has_obs[:, F - 1] = False
        self.has_right[:, F - 1] = False
        self._remove(np.flatnonzero(self.active & ~self.has_obs.any(axis=1)))


def _triangulate_line_multiview_np(p_cw, q_cw, s_obs, e_obs):
    """Host numpy twin of `geometry.lines.triangulate_line_multiview`
    -> (n_w, d_w)."""
    R = np.stack([lie_np.quat_to_matrix(q) for q in q_cw])
    l_obs = np.cross(s_obs, e_obs)
    l_obs /= np.maximum(np.linalg.norm(l_obs, axis=-1, keepdims=True),
                        1e-12)
    m = np.einsum("kij,ki->kj", R, l_obs)
    centers = -np.einsum("kij,ki->kj", R, p_cw)
    _, _, vt = np.linalg.svd(m, full_matrices=False)
    d = vt[-1]
    tmp = np.array([0.0, 0.0, 1.0]) if abs(d[2]) < 0.9 \
        else np.array([1.0, 0.0, 0.0])
    b1 = np.cross(d, tmp)
    b1 /= max(np.linalg.norm(b1), 1e-12)
    b2 = np.cross(d, b1)
    B = np.stack([b1, b2], axis=1)
    A2 = m @ B
    rhs = np.sum(m * centers, axis=-1)
    y = np.linalg.solve(A2.T @ A2 + 1e-12 * np.eye(2), A2.T @ rhs)
    return np.cross(B @ y, d), d


def plucker_to_orth_np(n, d):
    """Host numpy twin of `geometry.lines.plucker_to_orth`."""
    nn = np.linalg.norm(n)
    nd = np.linalg.norm(d)
    u1 = n / max(nn, 1e-12)
    u2 = d / max(nd, 1e-12)
    R = np.stack([u1, u2, np.cross(u1, u2)], axis=-1)
    return np.concatenate([lie_np.so3_log(R), [np.arctan2(nd, nn)]])

