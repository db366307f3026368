"""Shi-Tomasi corner detection with min-distance spacing (plain torch).

Min-eigenvalue response, 3x3 non-max suppression, an exclusion mask
around existing features, one winner per min-dist grid cell, then the
top-K cells by response — fixed shapes throughout, no host reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from dynamic_vins_tpu_torch.frontend import pyramid as pyr


def shi_tomasi_response(img, block: int = 3):
    """Min-eigenvalue corner response map [H,W]."""
    ix, iy = pyr.scharr_gradients(img)
    h, w = img.shape
    r = block // 2

    def box(a):
        p = pyr._edge_pad_cols(pyr._edge_pad_rows(a, r), r)
        out = torch.zeros_like(a)
        for i in range(block):
            for j in range(block):
                out = out + p[i:i + h, j:j + w]
        return out / (block * block)

    sxx, sxy, syy = box(ix * ix), box(ix * iy), box(iy * iy)
    det_term = torch.sqrt(torch.clamp_min((sxx - syy) ** 2
                                          + 4.0 * sxy * sxy, 0.0))
    return 0.5 * (sxx + syy - det_term)


def detect(img, max_corners: int, min_dist: int = 16,
           quality: float = 0.01, exclude_pts=None, exclude_valid=None,
           border: int = 8, allow_mask=None):
    """Detect up to max_corners corners.

    Returns (pts [K,2], score [K], found [K] bool), K = max_corners,
    found corners first in descending score (ties: lower cell first).
    exclude_pts [N,2] + exclude_valid [N]: corners within min_dist of
    them are suppressed. allow_mask [H,W] bool: candidates only where
    True (the instance tracker's merged eroded masks)."""
    H, W = img.shape
    dev = img.device
    resp = shi_tomasi_response(img)
    if allow_mask is not None:
        resp = torch.where(allow_mask, resp, -1.0)

    neigh = nnf.max_pool2d(
        nnf.pad(resp[None, None], (1, 1, 1, 1), value=-1.0), 3,
        stride=1)[0, 0]
    cand = (resp >= neigh) & (resp > quality * torch.max(resp))
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    cand = cand & (xx >= border) & (xx < W - border) \
        & (yy >= border) & (yy < H - border)

    if exclude_pts is not None:
        xi = torch.clamp(exclude_pts[:, 0].to(torch.int64), 0, W - 1)
        yi = torch.clamp(exclude_pts[:, 1].to(torch.int64), 0, H - 1)
        val = exclude_valid if exclude_valid is not None else \
            torch.ones(exclude_pts.shape[0], dtype=torch.bool, device=dev)
        excl = torch.zeros(H * W, dtype=torch.float32, device=dev)
        excl.index_put_((yi * W + xi,), val.to(torch.float32),
                        accumulate=True)
        excl = pyr.dilate3(excl.reshape(H, W) > 0,
                           iterations=max(1, min_dist // 2))
        cand = cand & ~excl

    score = torch.where(cand, resp, -1.0)
    gh = (H + min_dist - 1) // min_dist
    gw = (W + min_dist - 1) // min_dist
    sp = nnf.pad(score, (0, gw * min_dist - W, 0, gh * min_dist - H),
                 value=-1.0)
    cells = sp.reshape(gh, min_dist, gw, min_dist).permute(0, 2, 1, 3)
    cells = cells.reshape(gh, gw, min_dist * min_dist)
    best_val, best_in_cell = torch.max(cells, dim=-1)
    ys = (torch.arange(gh, device=dev)[:, None] * min_dist
          + best_in_cell // min_dist).reshape(-1)
    xs = (torch.arange(gw, device=dev)[None, :] * min_dist
          + best_in_cell % min_dist).reshape(-1)
    vals = best_val.reshape(-1)

    k = min(max_corners, vals.shape[0])
    top_val, top_idx = torch.sort(vals, descending=True, stable=True)
    top_val, top_idx = top_val[:k], top_idx[:k]
    pts = torch.stack([xs[top_idx].to(img.dtype),
                       ys[top_idx].to(img.dtype)], dim=-1)
    found = top_val > 0.0
    if k < max_corners:
        pad = max_corners - k
        pts = torch.cat([pts, torch.zeros((pad, 2), dtype=img.dtype,
                                          device=dev)])
        top_val = torch.cat([top_val, -torch.ones(pad, dtype=img.dtype,
                                                  device=dev)])
        found = torch.cat([found, torch.zeros(pad, dtype=torch.bool,
                                              device=dev)])
    return pts, top_val, found
