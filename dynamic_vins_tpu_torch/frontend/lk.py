"""Pyramidal Lucas-Kanade sparse optical flow (batched over features).

Pyramidal iterative LK with a forward-backward consistency check and
border rejection (the reference's FeatureTrackByLK). All features are
tracked at once; a level is either the CUDA kernel (`ops/lk_level`),
its plain torch version, or the Scharr/gather form `_lk_level` (the
JAX package's XLA path).
"""

from __future__ import annotations

from typing import Sequence

import torch

from dynamic_vins_tpu_torch.frontend import pyramid as pyr


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

    pts [N,2] full-resolution pixels; valid [N] bool. fb_levels: levels
    of the backward pass (default all); fb_levels=1 seeds the level-0
    backward track with the negated forward flow. Returns (pts1, ok)."""
    levels = len(pyr0)
    if level_fn is None:
        level_fn = lambda a, b, p, g: _lk_level(a, b, p, g, radius, iters)
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


def make_tracker(levels: int = 4, radius: int = 10, iters: int = 10,
                 fb_thresh: float = 0.5, border: int = 3,
                 backend: str = "auto", fb_levels: int | None = None,
                 device=None):
    """(img0, img1, pts, valid) -> (pts1, ok), pyramids built inside.

    backend: "cuda" (the hand-written kernel), "plain" (its plain torch
    version), "xla" (the Scharr/gather form), or "auto": "cuda" on a
    CUDA device, "xla" elsewhere. fb_levels defaults to 1 on
    "cuda"/"plain" (seeded level-0 back-check: 4 + 1 level launches per
    track) and to all levels on "xla"."""
    if backend == "auto":
        backend = "cuda" if torch.device(device or "cpu").type == "cuda" \
            else "xla"
    if backend in ("cuda", "plain"):
        from dynamic_vins_tpu_torch.ops import lk_level as k

        fn = k.lk_level if backend == "cuda" else k.lk_level_plain
        level_fn = lambda a, b, p, g: fn(a, b, p.contiguous(), g,
                                         radius=radius, iters=iters)
        fbl = 1 if fb_levels is None else fb_levels
    elif backend == "xla":
        level_fn, fbl = None, fb_levels
    else:
        raise ValueError(f"unknown LK backend {backend!r}")

    def run(img0, img1, pts, valid):
        return track(pyr.build_pyramid(img0, levels),
                     pyr.build_pyramid(img1, levels), pts, valid,
                     radius=radius, iters=iters, fb_thresh=fb_thresh,
                     border=border, level_fn=level_fn, fb_levels=fbl)

    run.backend = backend
    return run
