"""Pyramidal Lucas-Kanade sparse optical flow (batched over features).

Pyramidal iterative LK with a forward-backward consistency check and
border rejection (the reference's FeatureTrackByLK). All features are
tracked at once: by the CUDA track kernel (`ops/lk_level.lk_track`, one
launch a track), by its plain torch version (`lk_track_plain`, the
glue `ops/lk_level.pyramid_track` around the windowed level), or by
`track`, the same glue around the Scharr/gather level `_lk_level` (the
JAX package's XLA path).
"""

from __future__ import annotations

from typing import Sequence

import torch

from dynamic_vins_tpu_torch.frontend import pyramid as pyr
from dynamic_vins_tpu_torch.ops import lk_level as K


def _lk_level(img0, img1, pts0, guess, radius: int, iters: int):
    """One pyramid level of iterative LK (Scharr gradients, gathers).

    pts0 [N,2] positions in img0 at this level; guess [N,2] current flow
    (img1 position = pts0 + guess). Returns (guess [N,2], ok [N])."""
    ix, iy = pyr.scharr_gradients(img0)
    patch0 = pyr.sample_patch(img0, pts0, radius)
    gx = pyr.sample_patch(ix, pts0, radius)
    gy = pyr.sample_patch(iy, pts0, radius)
    s = lambda a: torch.sum(a, dim=(-2, -1))
    a11, a12, a22 = s(gx * gx), s(gx * gy), s(gy * gy)
    det = a11 * a22 - a12 * a12
    ok = det > 1e-6
    inv_det = torch.where(ok, 1.0 / torch.clamp_min(det, 1e-6), 0.0)
    g = guess
    for _ in range(iters):
        diff = pyr.sample_patch(img1, pts0 + g, radius) - patch0
        b1, b2 = s(diff * gx), s(diff * gy)
        du = -(a22 * b1 - a12 * b2) * inv_det
        dv = -(-a12 * b1 + a11 * b2) * inv_det
        g = g + torch.stack([du, dv], dim=-1)
    return g, ok


def track(pyr0: Sequence[torch.Tensor], pyr1: Sequence[torch.Tensor],
          pts, valid, radius: int = 10, iters: int = 10,
          fb_thresh: float = 0.5, border: int = 3, level_fn=None,
          fb_levels: int | None = None):
    """Track pts from pyramid0 to pyramid1 with a forward-backward check.

    pts [N,2] full-resolution pixels; valid [N] bool. level_fn: one
    pyramid level (default the Scharr/gather `_lk_level`). fb_levels:
    levels of the backward pass (default all); fb_levels=1 seeds the
    level-0 backward track with the negated forward flow. Returns
    (pts1, ok)."""
    if level_fn is None:
        level_fn = lambda a, b, p, g: _lk_level(a, b, p, g, radius, iters)
    return K.pyramid_track(pyr0, pyr1, pts, valid, level_fn,
                           fb_thresh=fb_thresh, border=border,
                           fb_levels=fb_levels)


def make_tracker(levels: int = 4, radius: int = 10, iters: int = 10,
                 fb_thresh: float = 0.5, border: int = 3,
                 backend: str = "auto", fb_levels: int | None = None,
                 device=None):
    """(img0, img1, pts, valid) -> (pts1, ok), pyramids built inside.

    backend: "cuda" (the hand-written track kernel, one launch a
    track), "plain" (its plain torch version), "xla" (the Scharr/gather
    form), or "auto": "cuda" on a CUDA device, "xla" elsewhere.
    fb_levels defaults to 1 on "cuda"/"plain" (level-0 back-check seeded
    with the forward flow) and to all levels on "xla"."""
    if backend == "auto":
        backend = "cuda" if torch.device(device or "cpu").type == "cuda" \
            else "xla"
    if backend in ("cuda", "plain"):
        fn = K.lk_track if backend == "cuda" else K.lk_track_plain
        fbl = 1 if fb_levels is None else fb_levels
        tracker = lambda p0, p1, pts, valid: fn(
            p0, p1, pts.contiguous(), valid.contiguous(), radius=radius,
            iters=iters, fb_thresh=fb_thresh, border=border, fb_levels=fbl)
    elif backend == "xla":
        tracker = lambda p0, p1, pts, valid: track(
            p0, p1, pts, valid, radius=radius, iters=iters,
            fb_thresh=fb_thresh, border=border, fb_levels=fb_levels)
    else:
        raise ValueError(f"unknown LK backend {backend!r}")

    def run(img0, img1, pts, valid):
        return tracker(pyr.build_pyramid(img0, levels),
                       pyr.build_pyramid(img1, levels), pts, valid)

    run.backend = backend
    return run


def track_by_dense_flow(flow, pts, valid, flow_back=None,
                        fb_thresh: float = 1.5, border: int = 3):
    """Track features by sampling a dense optical-flow field instead of
    sparse LK (FeatureTrackByDenseFlow, front_end/feature_utils.cpp).

    flow: [H,W,2] forward flow (img0 -> img1), pixels; pts [N,2]
    positions in img0; valid [N] bool. flow_back: an optional [H,W,2]
    backward field for a forward-backward check within fb_thresh px.
    Points that land within `border` px of the image edge are dropped.
    Returns (pts1 [N,2], ok [N])."""
    sample = lambda f, p: torch.stack(
        [pyr.bilinear_sample(f[..., 0], p),
         pyr.bilinear_sample(f[..., 1], p)], dim=-1)
    pts1 = pts + sample(flow, pts)
    ok = valid
    if flow_back is not None:
        pts_back = pts1 + sample(flow_back, pts1)
        ok = ok & (torch.linalg.norm(pts_back - pts, dim=-1) < fb_thresh)
    H, W = flow.shape[:2]
    ok = ok & (pts1[:, 0] >= border) & (pts1[:, 0] < W - border) \
        & (pts1[:, 1] >= border) & (pts1[:, 1] < H - border)
    return pts1, ok
