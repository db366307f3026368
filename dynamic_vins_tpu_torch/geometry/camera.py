"""Pinhole camera model with radial-tangential distortion.

`project` is camodocal's spaceToPlane, `lift` its liftProjective with a
fixed number of undistortion fixed-point iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PinholeIntrinsics(NamedTuple):
    """fx, fy, cx, cy, k1, k2, p1, p2 as 0-d tensors of one dtype."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor

    @classmethod
    def make(cls, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
             dtype=torch.float32, device=None):
        return cls(*(torch.as_tensor(float(v), dtype=dtype, device=device)
                     for v in (fx, fy, cx, cy, k1, k2, p1, p2)))

    def to(self, device=None, dtype=None):
        return PinholeIntrinsics(*(v.to(device=device, dtype=dtype)
                                   for v in self))

    @property
    def has_distortion(self):
        return any(float(abs(v)) > 0.0
                   for v in (self.k1, self.k2, self.p1, self.p2))


def distort(intr: PinholeIntrinsics, xy):
    """Additive radial-tangential distortion term of normalized coords."""
    x, y = xy[..., 0], xy[..., 1]
    x2, y2, xy_ = x * x, y * y, x * y
    rho2 = x2 + y2
    rad = intr.k1 * rho2 + intr.k2 * rho2 * rho2
    dx = x * rad + 2.0 * intr.p1 * xy_ + intr.p2 * (rho2 + 2.0 * x2)
    dy = y * rad + 2.0 * intr.p2 * xy_ + intr.p1 * (rho2 + 2.0 * y2)
    return torch.stack([dx, dy], dim=-1)


def project(intr: PinholeIntrinsics, pts_cam):
    """3D camera-frame points [...,3] -> pixel coords [...,2]."""
    z = pts_cam[..., 2:3]
    xy = pts_cam[..., :2] / torch.where(torch.abs(z) < 1e-9,
                                        torch.sign(z) * 1e-9 + 1e-12, z)
    xy_d = xy + distort(intr, xy)
    return torch.stack([intr.fx * xy_d[..., 0] + intr.cx,
                        intr.fy * xy_d[..., 1] + intr.cy], dim=-1)


def lift(intr: PinholeIntrinsics, uv, num_iters: int = 8):
    """Pixel coords [...,2] -> normalized ray [...,3] (z = 1)."""
    mx_d = (uv[..., 0] - intr.cx) / intr.fx
    my_d = (uv[..., 1] - intr.cy) / intr.fy
    pd = torch.stack([mx_d, my_d], dim=-1)
    pu = pd
    for _ in range(num_iters):
        pu = pd - distort(intr, pu)
    return torch.cat([pu, torch.ones_like(pu[..., :1])], dim=-1)


def normalized_from_pixel(intr: PinholeIntrinsics, uv, num_iters: int = 8):
    """Pixel -> undistorted normalized image coords [...,2]."""
    return lift(intr, uv, num_iters)[..., :2]


def pixel_from_normalized(intr: PinholeIntrinsics, xy):
    """Undistorted normalized coords -> pixel coords (with distortion)."""
    xy_d = xy + distort(intr, xy)
    return torch.stack([intr.fx * xy_d[..., 0] + intr.cx,
                        intr.fy * xy_d[..., 1] + intr.cy], dim=-1)
