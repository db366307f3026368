"""Fixed-capacity sliding-window state layout for the BA solver.

Column layout of the camera-side tangent vector (W = window frames):
  [0,          6W)    pose blocks        (dp 3, dtheta 3) x W
  [6W,         15W)   speed/bias blocks  (dv 3, dba 3, dbg 3) x W
  [15W,        15W+12) extrinsic blocks  (dp 3, dtheta 3) x 2 cams
  [15W+12,     15W+13) time offset td
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dynamic_vins_tpu_torch.geometry import lie

WINDOW_SIZE = 10
NUM_FRAMES = WINDOW_SIZE + 1


def cam_dim(num_frames: int = NUM_FRAMES) -> int:
    return 15 * num_frames + 13


def pose_col(k):
    return 6 * k


def speedbias_col(k, num_frames: int = NUM_FRAMES):
    return 6 * num_frames + 9 * k


def extrinsic_col(cam, num_frames: int = NUM_FRAMES):
    return 15 * num_frames + 6 * cam


def td_col(num_frames: int = NUM_FRAMES):
    return 15 * num_frames + 12


def plane_constraint_cols(num_frames: int = NUM_FRAMES):
    """bool [cam_dim] mask of the dims fixed under planar motion (z,
    roll, pitch of each pose and the z speed)."""
    fixed = np.zeros(cam_dim(num_frames), bool)
    for k in range(num_frames):
        c = pose_col(k)
        fixed[c + 2] = fixed[c + 3] = fixed[c + 4] = True
        fixed[speedbias_col(k, num_frames) + 2] = True
    return fixed


_SIZES = lambda F: [3 * F, 4 * F, 3 * F, 3 * F, 3 * F, 6, 8, 1]


class WindowState(NamedTuple):
    """Camera-side state of the sliding window.

    Fields are torch tensors on the solver's device, or numpy arrays for
    the estimator's host mirror (`pack`/`unpack` take either)."""

    p: torch.Tensor      # [F,3] body positions (world)
    q: torch.Tensor      # [F,4] body orientations (wxyz, body->world)
    v: torch.Tensor      # [F,3] velocities (world)
    ba: torch.Tensor     # [F,3] accel biases
    bg: torch.Tensor     # [F,3] gyro biases
    p_bc: torch.Tensor   # [2,3] camera-to-body translations
    q_bc: torch.Tensor   # [2,4] camera-to-body rotations
    td: torch.Tensor     # [] camera-IMU time offset

    @property
    def num_frames(self):
        return self.p.shape[0]

    @classmethod
    def identity(cls, num_frames: int = NUM_FRAMES, dtype=torch.float64,
                 device=None):
        qid = lie.quat_identity(dtype, device).repeat(num_frames, 1)
        qbc = lie.quat_identity(dtype, device).repeat(2, 1)
        z3 = lambda n: torch.zeros((n, 3), dtype=dtype, device=device)
        return cls(z3(num_frames), qid, z3(num_frames), z3(num_frames),
                   z3(num_frames), z3(2), qbc,
                   torch.zeros((), dtype=dtype, device=device))

    def to_numpy(self):
        return WindowState(*(np.array(a.detach().cpu()) for a in self))

    @classmethod
    def from_numpy(cls, st, dtype, device):
        return cls(*(torch.tensor(np.asarray(a), dtype=dtype,
                                  device=device) for a in st))

    def boxplus(self, delta):
        """Apply a cam_dim tangent vector."""
        F = self.num_frames
        p_new, q_new = lie.pose_boxplus(self.p, self.q,
                                        delta[:6 * F].reshape(F, 6))
        dsb = delta[6 * F:15 * F].reshape(F, 9)
        pbc_new, qbc_new = lie.pose_boxplus(
            self.p_bc, self.q_bc, delta[15 * F:15 * F + 12].reshape(2, 6))
        return WindowState(p_new, q_new, self.v + dsb[:, 0:3],
                           self.ba + dsb[:, 3:6], self.bg + dsb[:, 6:9],
                           pbc_new, qbc_new, self.td + delta[15 * F + 12])

    def boxminus(self, other: "WindowState"):
        """Tangent vector with other ⊞ delta = self."""
        F = self.num_frames
        dpose = lie.pose_boxminus(self.p, self.q, other.p, other.q)
        dsb = torch.cat([self.v - other.v, self.ba - other.ba,
                         self.bg - other.bg], dim=-1)
        dex = lie.pose_boxminus(self.p_bc, self.q_bc, other.p_bc,
                                other.q_bc)
        return torch.cat([dpose.reshape(6 * F), dsb.reshape(9 * F),
                          dex.reshape(12), (self.td - other.td)[None]])

    def pack(self):
        """One flat array (one transfer per stage)."""
        if isinstance(self.p, np.ndarray):
            return np.concatenate([np.ravel(a) for a in self])
        return torch.cat([a.reshape(-1) for a in self])

    @classmethod
    def unpack(cls, flat, num_frames: int):
        F = num_frames
        offs = np.cumsum([0] + _SIZES(F))
        shapes = [(F, 3), (F, 4), (F, 3), (F, 3), (F, 3), (2, 3), (2, 4),
                  ()]
        return cls(*(flat[offs[i]:offs[i + 1]].reshape(shapes[i])
                     for i in range(8)))
