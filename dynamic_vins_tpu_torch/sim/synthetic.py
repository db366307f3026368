"""Synthetic VIO world: analytic trajectory, exact IMU, landmarks.

An analytic smooth trajectory gives exact velocity, acceleration and
angular rate through forward-mode derivatives (`torch.func.jvp`), so
preintegration and BA can be checked to numerical precision without a
dataset on disk. Landmarks and noise come from numpy's
`default_rng(seed)` in the JAX package's call order, so a sequence
equals the JAX one for the same arguments.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp

from dynamic_vins_tpu_torch.geometry import lie
from dynamic_vins_tpu_torch.geometry.camera import PinholeIntrinsics, project
from dynamic_vins_tpu_torch.imu.preintegration import gravity


class TrajectoryParams(NamedTuple):
    radius: float = 5.0
    omega: float = 0.6          # rad/s around the circle
    z_amp: float = 0.6
    z_omega: float = 1.1
    roll_amp: float = 0.12
    pitch_amp: float = 0.1
    rp_omega: float = 1.7


def position(t, p: TrajectoryParams = TrajectoryParams()):
    return torch.stack([p.radius * torch.cos(p.omega * t),
                        p.radius * torch.sin(p.omega * t),
                        p.z_amp * torch.sin(p.z_omega * t)], dim=-1)


def orientation(t, p: TrajectoryParams = TrajectoryParams()):
    """Body-to-world quaternion: yaw follows the tangent, small
    roll/pitch."""
    yaw = p.omega * t + math.pi / 2.0
    roll = p.roll_amp * torch.sin(p.rp_omega * t)
    pitch = p.pitch_amp * torch.cos(p.rp_omega * t)
    z = torch.zeros_like(t)
    qz = lie.quat_from_yaw(yaw)
    qy = lie.so3_exp_quat(torch.stack([z, pitch, z], dim=-1))
    qx = lie.so3_exp_quat(torch.stack([roll, z, z], dim=-1))
    return lie.quat_multiply(qz, lie.quat_multiply(qy, qx))


def _derivative(fn, t):
    return jvp(fn, (t,), (torch.ones_like(t),))


def state_at(t, p: TrajectoryParams = TrajectoryParams()):
    """(pos, quat, vel) at scalar or batched t (a tensor)."""
    pos, vel = _derivative(lambda s: position(s, p), t)
    return pos, orientation(t, p), vel


def imu_at(t, p: TrajectoryParams = TrajectoryParams()):
    """Exact body-frame IMU measurements (specific force, gyro)."""
    def vel(s):
        return _derivative(lambda u: position(u, p), s)[1]

    _, acc_w = _derivative(vel, t)
    q, qdot = _derivative(lambda s: orientation(s, p), t)
    omega_body = 2.0 * lie.quat_multiply(lie.quat_conjugate(q),
                                         qdot)[..., 1:]
    acc_body = lie.quat_rotate(lie.quat_conjugate(q),
                               acc_w + gravity(t.dtype, t.device))
    return acc_body, omega_body


def make_landmarks(n: int, seed: int = 0,
                   p: TrajectoryParams = TrajectoryParams()):
    """Random landmarks in a shell around the trajectory circle."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(p.radius + 2.0, p.radius + 12.0, size=n)
    th = rng.uniform(0, 2 * np.pi, size=n)
    z = rng.uniform(-3.0, 5.0, size=n)
    return torch.tensor(np.stack([r * np.cos(th), r * np.sin(th), z],
                                 axis=-1))


class StereoRig(NamedTuple):
    intr: PinholeIntrinsics
    p_bc: torch.Tensor          # left camera-to-body translation
    q_bc: torch.Tensor          # left camera-to-body rotation
    baseline: float = 0.11
    width: int = 752
    height: int = 480

    @classmethod
    def default(cls, dtype=torch.float64):
        intr = PinholeIntrinsics.make(458.65, 457.30, 367.2, 248.4,
                                      dtype=dtype)
        # camera looks forward along body +x
        R_bc = torch.tensor([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0],
                             [0.0, -1.0, 0.0]], dtype=dtype)
        return cls(intr, torch.zeros(3, dtype=dtype),
                   lie.matrix_to_quat(R_bc))

    def right_extrinsics(self):
        """Right camera: translated along cam x by +baseline."""
        dp = lie.quat_rotate(self.q_bc, torch.tensor(
            [self.baseline, 0.0, 0.0], dtype=self.p_bc.dtype,
            device=self.p_bc.device))
        return self.p_bc + dp, self.q_bc

    def to(self, device):
        return self._replace(intr=self.intr.to(device),
                             p_bc=self.p_bc.to(device),
                             q_bc=self.q_bc.to(device))


def observe(rig: StereoRig, p_wb, q_wb, landmarks, cam: int = 0):
    """Project landmarks into the (left|right) camera at body pose(s).

    Returns (uv [...,N,2], in_view [...,N], pts_cam [...,N,3])."""
    p_bc, q_bc = (rig.p_bc, rig.q_bc) if cam == 0 \
        else rig.right_extrinsics()
    p_cw, q_cw = lie.pose_inverse(*lie.pose_compose(p_wb, q_wb, p_bc,
                                                    q_bc))
    pts_cam = lie.pose_transform_point(p_cw[..., None, :],
                                       q_cw[..., None, :], landmarks)
    uv = project(rig.intr, pts_cam)
    in_view = ((pts_cam[..., 2] > 0.3) & (uv[..., 0] >= 0)
               & (uv[..., 0] < rig.width) & (uv[..., 1] >= 0)
               & (uv[..., 1] < rig.height))
    return uv, in_view, pts_cam


class SyntheticSequence(NamedTuple):
    """A generated VIO sequence with exact ground truth (float64, CPU)."""

    frame_times: torch.Tensor        # [F]
    gt_p: torch.Tensor               # [F,3]
    gt_q: torch.Tensor               # [F,4]
    gt_v: torch.Tensor               # [F,3]
    imu_times: torch.Tensor          # [M]
    acc: torch.Tensor                # [M,3] (noisy)
    gyr: torch.Tensor                # [M,3]
    landmarks: torch.Tensor          # [L,3]
    rig: StereoRig


def generate_sequence(num_frames: int = 40, frame_hz: float = 10.0,
                      imu_hz: float = 200.0, num_landmarks: int = 300,
                      acc_noise: float = 0.0, gyr_noise: float = 0.0,
                      acc_bias=(0.0, 0.0, 0.0), gyr_bias=(0.0, 0.0, 0.0),
                      seed: int = 0,
                      params: TrajectoryParams = TrajectoryParams()
                      ) -> SyntheticSequence:
    dtype = torch.float64
    rng = np.random.default_rng(seed)
    frame_times = torch.arange(num_frames, dtype=dtype) / frame_hz
    imu_per_frame = int(round(imu_hz / frame_hz))
    imu_times = torch.arange((num_frames - 1) * imu_per_frame + 1,
                             dtype=dtype) / imu_hz
    gt_p, gt_q, gt_v = state_at(frame_times, params)
    acc, gyr = imu_at(imu_times, params)
    acc = acc + torch.tensor(acc_bias, dtype=dtype)
    gyr = gyr + torch.tensor(gyr_bias, dtype=dtype)
    if acc_noise > 0:
        acc = acc + torch.tensor(rng.normal(scale=acc_noise,
                                            size=tuple(acc.shape)))
    if gyr_noise > 0:
        gyr = gyr + torch.tensor(rng.normal(scale=gyr_noise,
                                            size=tuple(gyr.shape)))
    return SyntheticSequence(frame_times, gt_p, gt_q, gt_v, imu_times, acc,
                             gyr, make_landmarks(num_landmarks, seed=seed),
                             StereoRig.default(dtype))
