"""ORB feature extractor (oFAST + rBRIEF) in plain torch, counterpart of
the JAX package's `frontend/orb.py`.

Image pyramid, FAST-9 corners with one winner per grid cell,
intensity-centroid orientation and 256-bit steered-BRIEF descriptors
(the ORB-SLAM2 extractor's stages, `ORBextractor.{h,cc}`). Every stage
is a fixed-shape tensor op on the image's device in float32: FAST's
16-point circle test is a stack of rolls, the grid step a per-cell
argmax, orientation and descriptors one gather each. The ranking is a
stable descending sort, so equal scores (the empty cells' zeros) keep
the lower index first, as `jax.lax.top_k` does (`models.solov2.top_k`).
Each pyramid level resizes the original image (`models.layers.resize`,
`jax.image.resize`'s bilinear weights as two products). Matching is
host numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dynamic_vins_tpu_torch.models.layers import resize
from dynamic_vins_tpu_torch.models.solov2 import top_k

# FAST circle offsets (radius-3 Bresenham circle, OpenCV order)
_CIRCLE = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
    (-1, -3)], np.int32)

_PATCH_R = 15          # orientation patch radius (ORBextractor HALF_PATCH_SIZE)
_BORDER = 17           # the descriptor patch must fit


def _brief_pattern(n_bits: int = 256, seed: int = 7):
    """Gaussian test-pair pattern inside a 31x31 patch (rBRIEF)."""
    rng = np.random.RandomState(seed)
    pts = np.clip(rng.randn(n_bits, 2, 2) * 6.0, -14, 14)
    return pts.astype(np.float32)


_PATTERN = _brief_pattern()


def fast_score(img, thresh: float):
    """FAST-9 corner response of every pixel of an [H,W] float image:
    the sum of |sample - centre| over the circle samples brighter or
    darker than centre +- thresh where 9 contiguous ones are all
    brighter (or all darker), else 0. The samples wrap at the borders."""
    c = img
    samples = torch.stack([torch.roll(img, (-int(dy), -int(dx)), (0, 1))
                           for dx, dy in _CIRCLE])          # [16,H,W]
    brighter = samples > (c + thresh)[None]
    darker = samples < (c - thresh)[None]

    def max_run(flags):
        # longest circular run of True among the 16 flags, per pixel
        f2 = torch.cat([flags, flags], 0)                   # [32,H,W]
        run = f2[0].to(torch.int32)
        best = run
        for i in range(1, 32):
            run = torch.where(f2[i], run + 1, 0)
            best = torch.maximum(best, run)
        return best

    ok = (max_run(brighter) >= 9) | (max_run(darker) >= 9)
    score = torch.sum(torch.abs(samples - c[None]) * (brighter | darker),
                      dim=0)
    return torch.where(ok, score, 0.0)


def _orientation(img, xs, ys):
    """Intensity-centroid angle of each keypoint (IC_Angle)."""
    r = _PATCH_R
    dev = img.device
    offs = torch.arange(-r, r + 1, dtype=torch.int64, device=dev)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    circ = (dx * dx + dy * dy) <= r * r
    H, W = img.shape
    yy = torch.clamp(ys[:, None, None] + dy, 0, H - 1)
    xx = torch.clamp(xs[:, None, None] + dx, 0, W - 1)
    patch = img[yy, xx] * circ                              # [N,31,31]
    m10 = torch.sum(patch * dx, dim=(1, 2))
    m01 = torch.sum(patch * dy, dim=(1, 2))
    return torch.atan2(m01, m10)


def _descriptors(img, xs, ys, angles):
    """256-bit steered BRIEF, packed into [N,32] uint8 (bit j of a byte
    is test 8 * byte + j, numpy's little bit order)."""
    pat = torch.from_numpy(_PATTERN).to(img.device)         # [256,2,2]
    H, W = img.shape
    ca = torch.cos(angles)[:, None, None]
    sa = torch.sin(angles)[:, None, None]
    # pat @ R.T with R = [[ca, -sa], [sa, ca]]
    px = pat[None, ..., 0] * ca + pat[None, ..., 1] * -sa   # [N,256,2]
    py = pat[None, ..., 0] * sa + pat[None, ..., 1] * ca
    ix = torch.clamp(xs[:, None, None] + torch.round(px).to(torch.int64),
                     0, W - 1)
    iy = torch.clamp(ys[:, None, None] + torch.round(py).to(torch.int64),
                     0, H - 1)
    v = img[iy, ix]                                         # [N,256,2]
    bits = (v[..., 0] < v[..., 1]).to(torch.uint8).reshape(-1, 32, 8)
    weights = torch.tensor([1 << j for j in range(8)], dtype=torch.uint8,
                           device=img.device)
    return (bits * weights).sum(-1, dtype=torch.uint8)


class OrbResult(NamedTuple):
    xy: torch.Tensor         # [N,2] float32 (x, y) in level-0 pixels
    response: torch.Tensor   # [N] (0 => invalid slot)
    angle: torch.Tensor      # [N] radians
    level: torch.Tensor      # [N] int32
    desc: torch.Tensor       # [N,32] uint8


def _extract_level(img, thresh: float, max_kp: int, cell: int, lvl: int,
                   inv_scale: float) -> OrbResult:
    H, W = img.shape
    dev = img.device
    score = fast_score(img, thresh)
    b = _BORDER
    mask = torch.zeros((H, W), dtype=torch.bool, device=dev)
    mask[b:H - b, b:W - b] = True
    score = torch.where(mask, score, 0.0)
    # grid distribution: the best corner of each cell
    gh, gw = H // cell, W // cell
    cells = score[:gh * cell, :gw * cell].reshape(gh, cell, gw, cell) \
        .permute(0, 2, 1, 3).reshape(gh * gw, cell * cell)
    best = cells.argmax(-1)                  # the first maximum
    bscore = cells.amax(-1)
    n = torch.arange(gh * gw, device=dev)
    cy = (n // gw) * cell + best // cell
    cx = (n % gw) * cell + best % cell
    k = min(max_kp, gh * gw)
    top, idx = top_k(bscore, k)
    if k < max_kp:
        top = torch.nn.functional.pad(top, (0, max_kp - k))
        idx = torch.nn.functional.pad(idx, (0, max_kp - k))
    xs, ys = cx[idx], cy[idx]
    ang = _orientation(img, xs, ys)
    desc = _descriptors(img, xs, ys, ang)
    xy = torch.stack([xs, ys], -1).to(torch.float32) * inv_scale
    return OrbResult(xy, top, ang,
                     torch.full((max_kp,), lvl, dtype=torch.int32,
                                device=dev), desc)


class OrbExtractor:
    """Pyramidal ORB extraction (ORBextractor::operator())."""

    def __init__(self, n_features: int = 500, n_levels: int = 4,
                 scale_factor: float = 1.2, fast_thresh: float = 20.0,
                 cell: int = 16):
        self.n_features = n_features
        self.n_levels = n_levels
        self.scale = scale_factor
        self.thresh = fast_thresh
        self.cell = cell

    def __call__(self, img) -> OrbResult:
        """img: [H,W] tensor (its device is the extractor's) or array
        (put on the CPU); computed in float32."""
        img = torch.as_tensor(img).to(torch.float32)
        per_level = max(self.n_features // self.n_levels, 16)
        outs = []
        cur = img
        for lvl in range(self.n_levels):
            inv = float(self.scale ** lvl)
            outs.append(_extract_level(cur, self.thresh, per_level,
                                       self.cell, lvl, inv))
            if lvl + 1 < self.n_levels:
                nh = int(img.shape[0] / self.scale ** (lvl + 1))
                nw = int(img.shape[1] / self.scale ** (lvl + 1))
                cur = resize(img, (nh, nw))
        return OrbResult(*[torch.cat(x) for x in zip(*outs)])


def match_descriptors(d1, d2, max_dist: int = 64):
    """Brute-force Hamming matching with cross-check (host numpy);
    returns [M,2] index pairs."""
    a = np.unpackbits(np.asarray(d1), axis=1)
    b = np.unpackbits(np.asarray(d2), axis=1)
    dist = (a[:, None] != b[None, :]).sum(-1)             # [N1,N2]
    fwd = dist.argmin(1)
    bwd = dist.argmin(0)
    i = np.arange(len(a))
    ok = (bwd[fwd] == i) & (dist[i, fwd] <= max_dist)
    return np.stack([i[ok], fwd[ok]], -1)
