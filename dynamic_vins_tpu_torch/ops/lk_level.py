"""One pyramid level of iterative LK: the hand-written Hopper kernel
(csrc/lk_level.cu), its wrapper, and its plain torch version.

Semantics are those of the JAX package's Pallas kernel
(`dynamic_vins_tpu/ops/lk_pallas.py`): each feature reads img0/img1 only
through a WIN_H x WIN_W window whose origin is snapped to the (8, 128)
tiling and clamped inside the edge-padded image; reads outside the
window are zero; gradients are central differences of bilinear patches
shifted by +-1 px; the img1 patch origin is clamped inside its window.
Block sums accumulate in float64 and round once to float32, in the
kernel and here alike (the Pallas kernel sums in float32).
The padding, snapping and window origins (`prepare`) are shared by the
kernel and the plain version.

`lk_level` launches the kernel for CUDA tensors (raising if the build
or the launch fails; it never falls back) and runs `lk_level_plain` for
CPU tensors. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

WIN_H = 48
WIN_W = 256

launches = 0          # kernel launches since import (reset by callers)

_fn = None


def prepare(img0, img1, pts, guess):
    """Edge-pad both images to the window tiling and compute the window
    origins -> (img0p, img1p, meta [N,4] int32 = oy0, ox0, oy1, ox1)."""
    H0, W0 = img0.shape
    H = max((H0 + 7) // 8 * 8, WIN_H)
    W = max((W0 + 127) // 128 * 128, WIN_W)
    if (H, W) != (H0, W0):
        ri = torch.arange(H, device=img0.device).clamp_max(H0 - 1)
        ci = torch.arange(W, device=img0.device).clamp_max(W0 - 1)
        img0 = img0[ri][:, ci]
        img1 = img1[ri][:, ci]

    def snap(cy, cx):
        oy = torch.clamp(torch.floor((cy - WIN_H / 2) / 8.0).to(
            torch.int32) * 8, 0, H - WIN_H)
        ox = torch.clamp(torch.floor(cx / 128.0 - 0.5).to(
            torch.int32) * 128, 0, W - WIN_W)
        return oy, ox

    oy0, ox0 = snap(pts[:, 1], pts[:, 0])
    oy1, ox1 = snap(pts[:, 1] + guess[:, 1], pts[:, 0] + guess[:, 0])
    meta = torch.stack([oy0, ox0, oy1, ox1], dim=1).contiguous()
    return img0.contiguous(), img1.contiguous(), meta


def _window_patch(img, oy, ox, ly, lx, P):
    """Bilinear [N,P,P] patches at window-local top-left (ly, lx) of the
    windows at (oy, ox); zero outside the window. Rows first, then
    columns, as the Pallas R @ win @ C."""
    W = img.shape[1]
    flat = img.reshape(-1)
    iyf, ixf = torch.floor(ly), torch.floor(lx)
    fy = (ly - iyf)[:, None, None]
    fx = (lx - ixf)[:, None, None]
    ar = torch.arange(P, device=img.device)
    r0 = (iyf.long()[:, None] + ar)[:, :, None]
    c0 = (ixf.long()[:, None] + ar)[:, None, :]
    oy = oy.long()[:, None, None]
    ox = ox.long()[:, None, None]

    def at(r, c):
        inwin = (r >= 0) & (r < WIN_H) & (c >= 0) & (c < WIN_W)
        idx = (oy + r.clamp(0, WIN_H - 1)) * W + ox + c.clamp(0, WIN_W - 1)
        return torch.where(inwin, flat[idx], 0.0)

    t0 = (1.0 - fy) * at(r0, c0) + fy * at(r0 + 1, c0)
    t1 = (1.0 - fy) * at(r0, c0 + 1) + fy * at(r0 + 1, c0 + 1)
    return (1.0 - fx) * t0 + fx * t1


def lk_level_plain(img0, img1, pts, guess, radius: int = 10,
                   iters: int = 10):
    """The kernel's function in plain torch (gathers) -> (flow, ok)."""
    P = 2 * radius + 1
    img0p, img1p, meta = prepare(img0, img1, pts, guess)
    oy0, ox0, oy1, ox1 = meta.unbind(dim=1)
    x, y = pts[:, 0], pts[:, 1]
    tl_y = (y - oy0.to(y.dtype)) - radius
    tl_x = (x - ox0.to(x.dtype)) - radius
    patch = lambda ly, lx: _window_patch(img0p, oy0, ox0, ly, lx, P)
    patch0 = patch(tl_y, tl_x)
    gpx = 0.5 * (patch(tl_y, tl_x + 1.0) - patch(tl_y, tl_x - 1.0))
    gpy = 0.5 * (patch(tl_y + 1.0, tl_x) - patch(tl_y - 1.0, tl_x))
    # float32 products summed in float64, rounded once (as the kernel)
    s = lambda a: torch.sum(a, dim=(1, 2), dtype=torch.float64).to(a.dtype)
    a11, a12, a22 = s(gpx * gpx), s(gpx * gpy), s(gpy * gpy)
    det = a11 * a22 - a12 * a12
    good = det > 1e-6
    inv_det = torch.where(good, 1.0 / torch.clamp_min(det, 1e-6), 0.0)
    gu, gv = guess[:, 0], guess[:, 1]
    oy1f, ox1f = oy1.to(y.dtype), ox1.to(x.dtype)
    for _ in range(iters):
        l1y = torch.clamp(((y + gv) - oy1f) - radius, 0.0, WIN_H - P - 2.0)
        l1x = torch.clamp(((x + gu) - ox1f) - radius, 0.0, WIN_W - P - 2.0)
        diff = _window_patch(img1p, oy1, ox1, l1y, l1x, P) - patch0
        b1, b2 = s(diff * gpx), s(diff * gpy)
        gu = gu + -(a22 * b1 - a12 * b2) * inv_det
        gv = gv + -(-a12 * b1 + a11 * b2) * inv_det
    return torch.stack([gu, gv], dim=1), good


def _kernel():
    global _fn
    if _fn is None:
        from dynamic_vins_tpu_torch.ops import build

        fn = build.load("lk_level").lk_level_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, vp, vp, vp, ci, ci, ci, vp, vp, vp]
        fn.restype = ci
        _fn = fn
    return _fn


def _check(img0, img1, pts, guess, radius):
    if img0.dim() != 2 or img0.shape != img1.shape:
        raise ValueError(f"img0/img1 must be [H,W] of one shape, got "
                         f"{tuple(img0.shape)} and {tuple(img1.shape)}")
    n = pts.shape[0]
    if pts.shape != (n, 2) or guess.shape != (n, 2):
        raise ValueError("pts and guess must both be [N,2]")
    for name, t in (("img0", img0), ("img1", img1), ("pts", pts),
                    ("guess", guess)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != img0.device:
            raise ValueError(f"{name} is on {t.device}, img0 on "
                             f"{img0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (2 * radius + 1) ** 2 > 1024:
        raise ValueError(f"radius {radius} too large for one block")


def lk_level(img0, img1, pts, guess, radius: int = 10, iters: int = 10):
    """One LK level for all points -> (flow [N,2], ok [N] bool).

    img0/img1 [H,W] float32; pts [N,2] (x, y) in img0; guess [N,2]
    current flow. CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    _check(img0, img1, pts, guess, radius)
    if img0.device.type != "cuda":
        return lk_level_plain(img0, img1, pts, guess, radius, iters)
    img0p, img1p, meta = prepare(img0, img1, pts, guess)
    return launch(img0p, img1p, meta, pts, guess, radius, iters)


def launch(img0p, img1p, meta, pts, guess, radius: int = 10,
           iters: int = 10):
    """Launch the kernel on `prepare`d CUDA inputs (counts one launch)."""
    global launches
    n = pts.shape[0]
    flow = torch.empty((n, 2), dtype=torch.float32, device=pts.device)
    ok = torch.empty((n,), dtype=torch.bool, device=pts.device)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(img0p.data_ptr(), img1p.data_ptr(),
                       img0p.shape[1], pts.data_ptr(), guess.data_ptr(),
                       meta.data_ptr(), n, radius, iters, flow.data_ptr(),
                       ok.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"lk_level kernel launch failed: CUDA error {rc}")
    launches += 1
    return flow, ok
