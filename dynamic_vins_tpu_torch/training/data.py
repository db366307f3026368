"""Synthetic labeled batches for the perception nets: the numpy
generators of the JAX package's `training/data.py` for stereo, optical
flow and ReID, copied (the same draws for the same `rng`). They have
exact ground truth; `chip_smoke.py` checks the shipped weights' accuracy
on fresh batches from them. The segmentation and 3D-detection
generators build their targets with the training losses and come with
the training port.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# texture primitives
# ---------------------------------------------------------------------------
def _smooth_noise(rng, h, w, octaves: int = 3):
    """Band-limited random texture in [0,1]."""
    img = np.zeros((h, w), np.float32)
    for o in range(octaves):
        s = 2 ** (o + 3)
        small = rng.uniform(-1, 1, (max(h // s, 2), max(w // s, 2)))
        ys = np.linspace(0, small.shape[0] - 1, h)
        xs = np.linspace(0, small.shape[1] - 1, w)
        yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
        yf, xf = ys - yi, xs - xi
        yi1 = np.minimum(yi + 1, small.shape[0] - 1)
        xi1 = np.minimum(xi + 1, small.shape[1] - 1)
        a = small[yi][:, xi] * (1 - yf)[:, None] + \
            small[yi1][:, xi] * yf[:, None]
        b = small[yi][:, xi1] * (1 - yf)[:, None] + \
            small[yi1][:, xi1] * yf[:, None]
        img += (a * (1 - xf)[None, :] + b * xf[None, :]) / (o + 1)
    img -= img.min()
    return img / max(img.max(), 1e-6)


def _warp_x(img, dx):
    """img sampled at (x + dx, y), bilinear, edge-clamped. [H,W(,C)]"""
    h, w = img.shape[:2]
    xs = np.clip(np.arange(w)[None, :] + dx, 0, w - 1.001)
    x0 = np.floor(xs).astype(int)
    f = (xs - x0).astype(np.float32)
    rows = np.arange(h)[:, None]
    if img.ndim == 3:
        f = f[..., None]
    return img[rows, x0] * (1 - f) + img[rows, np.minimum(x0 + 1, w - 1)] * f


def _warp_xy(img, flow):
    """img sampled at (x + u, y + v); flow [H,W,2]."""
    h, w = img.shape[:2]
    xs = np.clip(np.arange(w)[None, :] + flow[..., 0], 0, w - 1.001)
    ys = np.clip(np.arange(h)[:, None] + flow[..., 1], 0, h - 1.001)
    x0, y0 = np.floor(xs).astype(int), np.floor(ys).astype(int)
    fx, fy = (xs - x0).astype(np.float32), (ys - y0).astype(np.float32)
    x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
    if img.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    a = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    b = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return a * (1 - fy) + b * fy


def _rgb(gray):
    return np.repeat(gray[..., None], 3, axis=-1) * 255.0


# ---------------------------------------------------------------------------
# stereo
# ---------------------------------------------------------------------------
def stereo_batch(rng, batch: int, hw=(96, 128), max_disp: int = 24):
    """Textured scenes with piecewise-constant disparity.

    Returns (left [B,H,W,3], right [B,H,W,3], disp [B,H,W],
    valid [B,H,W]). right(u) = left(u + d) — exact for the constant
    patches; pixels near depth discontinuities are marked invalid.
    """
    h, w = hw
    left = np.zeros((batch, h, w, 3), np.float32)
    right = np.zeros_like(left)
    disp = np.zeros((batch, h, w), np.float32)
    valid = np.ones((batch, h, w), bool)
    for b in range(batch):
        tex = _smooth_noise(rng, h, w)
        d = np.full((h, w), rng.uniform(2.0, max_disp * 0.4), np.float32)
        for _ in range(rng.integers(1, 4)):
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            bh, bw = rng.integers(h // 5, h // 2), rng.integers(w // 5, w // 2)
            d[y0:y0 + bh, x0:x0 + bw] = rng.uniform(2.0, max_disp - 1.0)
        l = _rgb(tex)
        r = _rgb(_warp_x(tex, d))
        edge = np.abs(np.diff(d, axis=1, prepend=d[:, :1])) > 0.5
        v = ~edge
        v[:, :max_disp] = False          # left border: occluded in right
        left[b], right[b], disp[b], valid[b] = l, r, d, v
    return left, right, disp, valid


# ---------------------------------------------------------------------------
# optical flow
# ---------------------------------------------------------------------------
def flow_batch(rng, batch: int, hw=(96, 128), max_flow: float = 8.0):
    """Smooth random flow fields; img2(x) = img1(x + flow(x))."""
    h, w = hw
    img1 = np.zeros((batch, h, w, 3), np.float32)
    img2 = np.zeros_like(img1)
    flow = np.zeros((batch, h, w, 2), np.float32)
    valid = np.ones((batch, h, w), bool)
    for b in range(batch):
        tex = _smooth_noise(rng, h, w)
        fu = (_smooth_noise(rng, h, w) - 0.5) * 2 * max_flow
        fv = (_smooth_noise(rng, h, w) - 0.5) * 2 * max_flow
        # constant component (dominant camera motion)
        fu += rng.uniform(-max_flow, max_flow) * 0.5
        fv += rng.uniform(-max_flow, max_flow) * 0.5
        f = np.stack([fu, fv], -1).astype(np.float32)
        img1[b] = _rgb(tex)
        img2[b] = _rgb(_warp_xy(tex, f))
        flow[b] = f
        m = int(np.ceil(max_flow))
        v = np.zeros((h, w), bool)
        v[m:-m, m:-m] = True
        valid[b] = v
    return img1, img2, flow, valid


# ---------------------------------------------------------------------------
# ReID
# ---------------------------------------------------------------------------
def reid_batch(rng, num_ids: int, views: int, hw=(64, 32),
               id_bank=None):
    """Augmented crops of persistent identities.

    Each identity is a fixed random texture; views differ by shift,
    scale and brightness. Returns (imgs [num_ids*views,h,w,3], ids)."""
    h, w = hw
    if id_bank is None:
        id_bank = [_smooth_noise(np.random.default_rng(1000 + i),
                                 h * 2, w * 2) for i in range(num_ids)]
    imgs = np.zeros((num_ids * views, h, w, 3), np.float32)
    ids = np.zeros(num_ids * views, np.int32)
    k = 0
    for i in range(num_ids):
        base = id_bank[i]
        for _ in range(views):
            oy = rng.integers(0, h // 2)
            ox = rng.integers(0, w // 2)
            crop = base[oy:oy + h, ox:ox + w]
            gain = rng.uniform(0.7, 1.3)
            imgs[k] = _rgb(np.clip(crop * gain, 0, 1))
            ids[k] = i
            k += 1
    return imgs, ids
