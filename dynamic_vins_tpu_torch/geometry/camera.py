"""Camera models: camodocal's pinhole (radial-tangential distortion),
equidistant (Kannala-Brandt), MEI catadioptric and Scaramuzza (OCamCalib)
cameras.

Each model's `project` is camodocal's spaceToPlane and its `lift` its
liftProjective, batched over leading axes, with fixed iteration counts
where the inverse is iterative.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


# ---------------------------------------------------------------------------
# Equidistant (Kannala-Brandt) fisheye model, camodocal EquidistantCamera:
# r(theta) = theta + k2 theta^3 + k3 theta^5 + k4 theta^7 + k5 theta^9
# ---------------------------------------------------------------------------

class EquidistantIntrinsics(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k2: torch.Tensor
    k3: torch.Tensor
    k4: torch.Tensor
    k5: torch.Tensor

    @classmethod
    def make(cls, fx, fy, cx, cy, k2=0.0, k3=0.0, k4=0.0, k5=0.0,
             dtype=torch.float32, device=None):
        return cls(*(torch.as_tensor(float(v), dtype=dtype, device=device)
                     for v in (fx, fy, cx, cy, k2, k3, k4, k5)))

    def to(self, device=None, dtype=None):
        return EquidistantIntrinsics(*(v.to(device=device, dtype=dtype)
                                       for v in self))


def _kb_r(intr: EquidistantIntrinsics, theta):
    t2 = theta * theta
    return theta * (1.0 + t2 * (intr.k2 + t2 * (intr.k3 + t2 * (
        intr.k4 + t2 * intr.k5))))


def equidistant_project(intr: EquidistantIntrinsics, pts_cam):
    """3D camera points [...,3] -> pixels [...,2] (spaceToPlane)."""
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    rho = torch.sqrt(x * x + y * y)
    theta = torch.atan2(rho, z)
    scale = _kb_r(intr, theta) / torch.clamp_min(rho, 1e-12)
    return torch.stack([intr.fx * scale * x + intr.cx,
                        intr.fy * scale * y + intr.cy], dim=-1)


def equidistant_lift(intr: EquidistantIntrinsics, uv, num_iters: int = 10):
    """Pixels [...,2] -> unit rays [...,3] (liftProjective): r(theta)
    inverted by a fixed number of Newton steps."""
    mx = (uv[..., 0] - intr.cx) / intr.fx
    my = (uv[..., 1] - intr.cy) / intr.fy
    r_d = torch.sqrt(mx * mx + my * my)
    theta = r_d
    for _ in range(num_iters):
        t2 = theta * theta
        f = _kb_r(intr, theta) - r_d
        df = 1.0 + t2 * (3 * intr.k2 + t2 * (5 * intr.k3 + t2 * (
            7 * intr.k4 + t2 * 9 * intr.k5)))
        theta = theta - f / torch.clamp_min(df, 1e-9)
    s = torch.sin(theta) / torch.clamp_min(r_d, 1e-12)
    return torch.stack([s * mx, s * my, torch.cos(theta)], dim=-1)


# ---------------------------------------------------------------------------
# MEI (unified catadioptric) model, camodocal CataCamera: projection
# through the unit sphere with mirror parameter xi, then radial-tangential
# distortion.
# ---------------------------------------------------------------------------

class CataIntrinsics(NamedTuple):
    xi: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    gamma1: torch.Tensor
    gamma2: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor

    @classmethod
    def make(cls, xi, gamma1, gamma2, u0, v0, k1=0.0, k2=0.0, p1=0.0,
             p2=0.0, dtype=torch.float32, device=None):
        return cls(*(torch.as_tensor(float(v), dtype=dtype, device=device)
                     for v in (xi, k1, k2, p1, p2, gamma1, gamma2, u0,
                               v0)))

    def to(self, device=None, dtype=None):
        return CataIntrinsics(*(v.to(device=device, dtype=dtype)
                                for v in self))

    def _pinhole_dist(self):
        """The radial-tangential terms (k1, k2, p1, p2) as a pinhole."""
        return PinholeIntrinsics(self.gamma1, self.gamma2, self.u0,
                                 self.v0, self.k1, self.k2, self.p1,
                                 self.p2)


def cata_project(intr: CataIntrinsics, pts_cam):
    """3D camera points [...,3] -> pixels [...,2] (spaceToPlane)."""
    norm = torch.linalg.norm(pts_cam, dim=-1)
    zs = pts_cam[..., 2] + intr.xi * norm
    m = pts_cam[..., :2] / torch.clamp_min(zs, 1e-9)[..., None]
    m_d = m + distort(intr._pinhole_dist(), m)
    return torch.stack([intr.gamma1 * m_d[..., 0] + intr.u0,
                        intr.gamma2 * m_d[..., 1] + intr.v0], dim=-1)


def cata_lift(intr: CataIntrinsics, uv, num_iters: int = 8):
    """Pixels [...,2] -> unit rays [...,3] (liftProjective): fixed-point
    undistortion, then the closed-form lift off the unit sphere."""
    mx_d = (uv[..., 0] - intr.u0) / intr.gamma1
    my_d = (uv[..., 1] - intr.v0) / intr.gamma2
    pd = torch.stack([mx_d, my_d], dim=-1)
    pu = pd
    dist = intr._pinhole_dist()
    for _ in range(num_iters):
        pu = pd - distort(dist, pu)
    rho2 = torch.sum(pu * pu, dim=-1)
    xi = intr.xi
    lam = (xi + torch.sqrt(1.0 + (1.0 - xi * xi) * rho2)) / (1.0 + rho2)
    ray = torch.cat([lam[..., None] * pu, (lam - xi)[..., None]], dim=-1)
    return ray / torch.clamp_min(
        torch.linalg.norm(ray, dim=-1, keepdim=True), 1e-12)


# ---------------------------------------------------------------------------
# Scaramuzza (OCamCalib) omnidirectional model, camodocal ScaramuzzaCamera:
# a cam2world polynomial in the image radius, a world2cam inverse
# polynomial in the incidence angle, a 2x2 affine (c, d, e) and a centre.
# ---------------------------------------------------------------------------

SCARAMUZZA_POLY_SIZE = 5
SCARAMUZZA_INV_POLY_SIZE = 12


class ScaramuzzaIntrinsics(NamedTuple):
    poly: torch.Tensor        # [5]  cam2world: z = sum_i poly[i] rho^i
    inv_poly: torch.Tensor    # [12] world2cam: rho = sum_i ip[i] theta^i
    c: torch.Tensor
    d: torch.Tensor
    e: torch.Tensor
    center_x: torch.Tensor
    center_y: torch.Tensor

    @classmethod
    def make(cls, poly, inv_poly, center_x, center_y, c=1.0, d=0.0,
             e=0.0, dtype=torch.float32, device=None):
        def padded(coeffs, n):
            out = torch.zeros(n, dtype=dtype, device=device)
            vals = torch.as_tensor(np.asarray(coeffs, np.float64),
                                   dtype=dtype, device=device)
            out[:len(vals)] = vals
            return out

        return cls(padded(poly, SCARAMUZZA_POLY_SIZE),
                   padded(inv_poly, SCARAMUZZA_INV_POLY_SIZE),
                   *(torch.as_tensor(float(v), dtype=dtype, device=device)
                     for v in (c, d, e, center_x, center_y)))

    def to(self, device=None, dtype=None):
        return ScaramuzzaIntrinsics(*(v.to(device=device, dtype=dtype)
                                      for v in self))


def _polyval(coeffs, x):
    """sum_i coeffs[i] x^i by Horner's rule, highest coefficient first."""
    out = torch.zeros_like(x)
    for i in range(coeffs.shape[0] - 1, -1, -1):
        out = out * x + coeffs[i]
    return out


def scaramuzza_lift(intr: ScaramuzzaIntrinsics, uv):
    """Pixels [...,2] -> unit rays [...,3] (liftProjective). OCamCalib's
    polynomial gives z' along an optical axis pointing to -z; the ray is
    flipped so z > 0 looks forward, as camodocal returns it."""
    du = uv[..., 0] - intr.center_x
    dv = uv[..., 1] - intr.center_y
    inv_det = 1.0 / (intr.c - intr.d * intr.e)
    xp = inv_det * (du - intr.d * dv)
    yp = inv_det * (-intr.e * du + intr.c * dv)
    rho = torch.sqrt(xp * xp + yp * yp)
    zp = -_polyval(intr.poly, rho)
    ray = torch.stack([xp, yp, zp], dim=-1)
    return ray / torch.clamp_min(
        torch.linalg.norm(ray, dim=-1, keepdim=True), 1e-12)


def scaramuzza_project(intr: ScaramuzzaIntrinsics, pts_cam):
    """3D camera points [...,3] -> pixels [...,2] (spaceToPlane)."""
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    norm_xy = torch.sqrt(x * x + y * y)
    theta = torch.atan2(-z, torch.clamp_min(norm_xy, 1e-12))
    rho = _polyval(intr.inv_poly, theta)
    inv_n = 1.0 / torch.clamp_min(norm_xy, 1e-12)
    xn = x * inv_n * rho
    yn = y * inv_n * rho
    return torch.stack([xn * intr.c + yn * intr.d + intr.center_x,
                        xn * intr.e + yn + intr.center_y], dim=-1)


def scaramuzza_fit_inverse(poly, max_rho: float, n: int = 256):
    """The world2cam inverse polynomial [12] fitted to the cam2world one
    by dense sampling and least squares (OCamCalib's `findinvpoly`, with
    which the reference's calibrations were made); numpy float64."""
    rho = np.linspace(1e-3, max_rho, n)
    z = -np.polyval(np.asarray(poly)[::-1], rho)
    theta = np.arctan2(-z, rho)
    A = np.stack([theta ** i for i in range(SCARAMUZZA_INV_POLY_SIZE)],
                 axis=-1)
    coef, *_ = np.linalg.lstsq(A, rho, rcond=None)
    return coef
