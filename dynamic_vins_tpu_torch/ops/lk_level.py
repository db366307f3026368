"""Pyramidal LK: the hand-written Hopper kernels (csrc/lk_level.cu),
their wrappers, and their plain torch versions.

Semantics are those of the JAX package's Pallas kernel
(`dynamic_vins_tpu/ops/lk_pallas.py`) and of the JAX package's
`frontend/lk.track` around it: each feature reads img0/img1 only
through a WIN_H x WIN_W window whose origin is snapped to the (8, 128)
tiling and clamped inside the edge-padded image; reads outside the
window are zero; gradients are central differences of bilinear patches
shifted by +-1 px; the img1 patch origin is clamped inside its window.
Patch sums accumulate in float64 and round once to float32, in the
kernels and here alike (the Pallas kernel sums in float32).

Two kernels, one device function:
  * `lk_track`: a whole track (forward levels, seeded backward check,
    forward-backward and border tests) in one launch; `track_launches`
    counts its launches. CPU tensors run `lk_track_plain`, which is
    the track glue `pyramid_track` with `lk_level_plain` as its level
    (`frontend.lk.track` runs the same glue around the Scharr level).
  * `lk_level`: one level; `launches` counts its launches. CPU tensors
    run `lk_level_plain`.
The kernels pad and snap the windows themselves; `prepare` (padded
copies and window origins) serves the plain version only. A wrapper
given CUDA tensors launches its kernel or raises: it never falls back.
The CUDA path takes the radii in RADIUS only (10: the background
tracker; 8: the instance tracker); the C entries pick the instantiation.
"""

from __future__ import annotations

import ctypes

import torch

WIN_H = 48
WIN_W = 256
RADIUS = frozenset({8, 10})   # the kernels' compiled patch radii
MAX_LEVELS = 8

launches = 0          # lk_level kernel launches (reset by callers)
track_launches = 0    # lk_track kernel launches (reset by callers)
# lk_track kernel launches per patch radius (reset by callers)
track_launches_by_radius = dict.fromkeys(sorted(RADIUS), 0)
plain_levels = 0      # levels run by lk_level_plain (reset by callers)

_lib = None


def prepare(img0, img1, pts, guess):
    """Edge-pad both images to the window tiling and compute the window
    origins -> (img0p, img1p, meta [N,4] int32 = oy0, ox0, oy1, ox1).
    The plain version's; the kernels do the same in place."""
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
    global plain_levels
    plain_levels += 1
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


def pyramid_track(pyr0, pyr1, pts, valid, level_fn,
                  fb_thresh: float = 0.5, border: int = 3,
                  fb_levels: int | None = None):
    """Track pts from pyramid0 to pyramid1 with a forward-backward check,
    one pyramid level at a time through level_fn(img0, img1, pts, guess)
    -> (flow, ok).

    pts [N,2] full-resolution pixels; valid [N] bool. fb_levels: levels
    of the backward pass (None: all); fewer than all seeds the backward
    track with the forward flow. Returns (pts1, ok)."""
    levels = len(pyr0)
    g = torch.zeros_like(pts)
    ok = valid
    for lvl in range(levels - 1, -1, -1):
        s = 2.0 ** lvl
        if lvl < levels - 1:
            g = g * 2.0
        gi, oki = level_fn(pyr0[lvl], pyr1[lvl], pts / s, g)
        g = torch.where(oki[:, None], gi, g)
        ok = ok & oki
    pts1 = pts + g * 1.0

    n_fb = levels if fb_levels is None else max(1, min(fb_levels, levels))
    gb = -g / (2.0 ** (n_fb - 1)) if n_fb < levels \
        else torch.zeros_like(pts)
    for lvl in range(n_fb - 1, -1, -1):
        s = 2.0 ** lvl
        if lvl < n_fb - 1:
            gb = gb * 2.0
        gbi, okb = level_fn(pyr1[lvl], pyr0[lvl], pts1 / s, gb)
        gb = torch.where(okb[:, None], gbi, gb)
        ok = ok & okb
    fb_err = torch.linalg.vector_norm(pts1 + gb - pts, dim=-1)
    ok = ok & (fb_err < fb_thresh)

    H, W = pyr0[0].shape
    return pts1, ok & (pts1[:, 0] >= border) & (pts1[:, 0] < W - border) \
        & (pts1[:, 1] >= border) & (pts1[:, 1] < H - border)


def lk_track_plain(pyr0, pyr1, pts, valid, radius: int = 10,
                   iters: int = 10, fb_thresh: float = 0.5,
                   border: int = 3, fb_levels: int = 1):
    """The track kernel's function in plain torch -> (pts1, ok)."""
    return pyramid_track(pyr0, pyr1, pts, valid,
                         lambda a, b, p, g: lk_level_plain(
                             a, b, p.contiguous(), g, radius, iters),
                         fb_thresh=fb_thresh, border=border,
                         fb_levels=fb_levels)


class _Pyramids(ctypes.Structure):
    """`LkPyramids` of csrc/lk_level.cu."""

    _fields_ = [("img0", ctypes.c_void_p * MAX_LEVELS),
                ("img1", ctypes.c_void_p * MAX_LEVELS),
                ("H", ctypes.c_int * MAX_LEVELS),
                ("W", ctypes.c_int * MAX_LEVELS),
                ("levels", ctypes.c_int)]


def _kernels():
    global _lib
    if _lib is None:
        from dynamic_vins_tpu_torch.ops import build

        lib = build.load("lk_level")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lk_level_launch.argtypes = [vp, vp, ci, ci, vp, vp, ci, ci, ci,
                                        vp, vp, vp]
        lib.lk_level_launch.restype = ci
        lib.lk_track_launch.argtypes = [ctypes.POINTER(_Pyramids), vp, vp,
                                        ci, ci, ci, cf, ci, ci, vp, vp, vp]
        lib.lk_track_launch.restype = ci
        _lib = lib
    return _lib


def _check_image(name, t, device):
    if t.dim() != 2:
        raise ValueError(f"{name} must be [H,W], got {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, pts on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_points(pts, *others):
    n = pts.shape[0] if pts.dim() == 2 else -1
    if pts.shape != (n, 2):
        raise ValueError(f"pts must be [N,2], got {tuple(pts.shape)}")
    for name, t, shape, dtype in (("pts", pts, (n, 2), torch.float32),
                                  *others):
        if t.shape != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != pts.device:
            raise ValueError(f"{name} is on {t.device}, pts on "
                             f"{pts.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_cuda(radius, iters):
    if radius not in RADIUS:
        raise ValueError(f"the CUDA LK kernels are built for radii "
                         f"{sorted(RADIUS)}, got {radius}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


def lk_level(img0, img1, pts, guess, radius: int = 10, iters: int = 10):
    """One LK level for all points -> (flow [N,2], ok [N] bool).

    img0/img1 [H,W] float32; pts [N,2] (x, y) in img0; guess [N,2]
    current flow. CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    _check_points(pts, ("guess", guess, pts.shape, torch.float32))
    _check_image("img0", img0, pts.device)
    _check_image("img1", img1, pts.device)
    if img0.shape != img1.shape:
        raise ValueError(f"img0/img1 shapes differ: {tuple(img0.shape)} "
                         f"and {tuple(img1.shape)}")
    if pts.device.type != "cuda":
        return lk_level_plain(img0, img1, pts, guess, radius, iters)
    _check_cuda(radius, iters)
    n = pts.shape[0]
    flow = torch.empty((n, 2), dtype=torch.float32, device=pts.device)
    ok = torch.empty((n,), dtype=torch.bool, device=pts.device)
    launch_level(img0, img1, pts, guess, radius, iters, flow, ok)
    return flow, ok


def launch_level(img0, img1, pts, guess, radius, iters, flow, ok):
    """Launch the level kernel on checked CUDA inputs into flow / ok
    (counts one launch)."""
    global launches
    with torch.cuda.device(pts.device):
        rc = _kernels().lk_level_launch(
            img0.data_ptr(), img1.data_ptr(), img0.shape[0],
            img0.shape[1], pts.data_ptr(), guess.data_ptr(), pts.shape[0],
            radius, iters, flow.data_ptr(), ok.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lk_level kernel launch failed: CUDA error {rc}")
    launches += 1


def lk_track(pyr0, pyr1, pts, valid, radius: int = 10, iters: int = 10,
             fb_thresh: float = 0.5, border: int = 3, fb_levels: int = 1):
    """Track pts [N,2] (level-0 pixels) from pyramid 0 to pyramid 1 with
    the forward-backward check over `fb_levels` levels (seeded with the
    forward flow) and the border test -> (pts1 [N,2], ok [N] bool).

    pyr0/pyr1: equal-length lists of [H,W] float32 levels, level l of
    both of one shape; valid [N] bool. CUDA tensors launch the track
    kernel once; CPU tensors run the plain version."""
    _check_points(pts, ("valid", valid, (pts.shape[0],), torch.bool))
    if not 1 <= len(pyr0) <= MAX_LEVELS or len(pyr1) != len(pyr0):
        raise ValueError(f"pyramids must have 1..{MAX_LEVELS} levels "
                         f"each, got {len(pyr0)} and {len(pyr1)}")
    for lvl, (a, b) in enumerate(zip(pyr0, pyr1)):
        _check_image(f"pyr0[{lvl}]", a, pts.device)
        _check_image(f"pyr1[{lvl}]", b, pts.device)
        if a.shape != b.shape:
            raise ValueError(f"level {lvl} shapes differ: "
                             f"{tuple(a.shape)} and {tuple(b.shape)}")
    if pts.device.type != "cuda":
        return lk_track_plain(pyr0, pyr1, pts, valid, radius, iters,
                              fb_thresh, border, fb_levels)
    _check_cuda(radius, iters)
    n = pts.shape[0]
    pts1 = torch.empty((n, 2), dtype=torch.float32, device=pts.device)
    ok = torch.empty((n,), dtype=torch.bool, device=pts.device)
    launch_track(pyr0, pyr1, pts, valid, radius, iters, fb_thresh, border,
                 fb_levels, pts1, ok)
    return pts1, ok


def launch_track(pyr0, pyr1, pts, valid, radius, iters, fb_thresh, border,
                 fb_levels, pts1, ok):
    """Launch the track kernel on checked CUDA inputs into pts1 / ok
    (counts one launch)."""
    global track_launches
    L = len(pyr0)
    arg = _Pyramids()
    arg.levels = L
    for lvl in range(L):
        arg.img0[lvl] = pyr0[lvl].data_ptr()
        arg.img1[lvl] = pyr1[lvl].data_ptr()
        arg.H[lvl], arg.W[lvl] = pyr0[lvl].shape
    with torch.cuda.device(pts.device):
        rc = _kernels().lk_track_launch(
            ctypes.byref(arg), pts.data_ptr(), valid.data_ptr(),
            pts.shape[0], radius, iters, fb_thresh, border, fb_levels,
            pts1.data_ptr(), ok.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lk_track kernel launch failed: CUDA error {rc}")
    track_launches += 1
    track_launches_by_radius[radius] += 1
