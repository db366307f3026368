"""Synthetic labeled batches for training the perception nets: the
numpy generators of the JAX package's `training/data.py`, copied (the
same draws for the same `rng`, the same arrays). Each has exact ground
truth: stereo, optical flow, ReID, and the segmentation and 3D-detection
scenes, whose targets come from the target builders of
`training/losses.py`. `training/cli.py` trains on them; `chip_smoke.py`
checks the shipped weights on fresh batches from them.
"""

from __future__ import annotations

import numpy as np

from dynamic_vins_tpu_torch.training import losses


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
# instance segmentation (SOLOv2)
# ---------------------------------------------------------------------------
def seg_batch(rng, batch: int, hw=(96, 128), max_inst: int = 4,
              num_classes: int = 8, grid_sizes=(36, 24, 16, 12),
              mask_hw=None):
    """Scenes of textured ellipses over textured background.

    Returns (img [B,H,W,3], cate_target [B,G], inst_index [B,G],
    gt_masks_low [B,max_inst,h4,w4]) ready for `losses.solo_loss`."""
    h, w = hw
    h4, w4 = mask_hw if mask_hw is not None else (h // 4, w // 4)
    imgs = np.zeros((batch, h, w, 3), np.float32)
    G = sum(s * s for s in grid_sizes)
    cate_t = np.zeros((batch, G), np.int32)
    inst_t = np.zeros((batch, G), np.int32)
    masks_low = np.zeros((batch, max_inst, h4, w4), np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for b in range(batch):
        tex = _smooth_noise(rng, h, w) * 0.5
        n = int(rng.integers(1, max_inst + 1))
        masks = np.zeros((n, h, w), bool)
        labels = rng.integers(0, num_classes, n).astype(np.int32)
        for i in range(n):
            cy = rng.uniform(0.25 * h, 0.75 * h)
            cx = rng.uniform(0.25 * w, 0.75 * w)
            ry = rng.uniform(0.1 * h, 0.3 * h)
            rx = rng.uniform(0.1 * w, 0.3 * w)
            m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            masks[i] = m
            # distinct intensity per class for learnable appearance
            tex = np.where(m, 0.55 + 0.05 * labels[i] +
                           0.1 * _smooth_noise(rng, h, w), tex)
        imgs[b] = _rgb(np.clip(tex, 0, 1))
        valid = np.ones(n, bool)
        cate, idx = losses.solo_targets(masks, labels, valid,
                                        grid_sizes, num_classes)
        cate_t[b], inst_t[b] = cate, idx
        for i in range(n):
            ml = masks[i][::h // h4 if h // h4 else 1,
                          ::w // w4 if w // w4 else 1]
            masks_low[b, i, :ml.shape[0], :ml.shape[1]] = \
                ml[:h4, :w4].astype(np.float32)
    return imgs, cate_t, inst_t, masks_low


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


# ---------------------------------------------------------------------------
# monocular 3D detection (FCOS3D)
# ---------------------------------------------------------------------------
def det3d_batch(rng, batch: int, hw=(96, 128), max_boxes: int = 3,
                num_classes: int = 10, strides=(8, 16, 32, 64),
                focal: float = 460.0):
    """Cuboid silhouettes at known camera-frame poses.

    Returns (imgs [B,H,W,3], level_targets — a list per level of
    stacked dicts matching `losses.fcos3d_loss`)."""
    h, w = hw
    imgs = np.zeros((batch, h, w, 3), np.float32)
    per_level = None
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for b in range(batch):
        tex = _smooth_noise(rng, h, w) * 0.4
        n = int(rng.integers(1, max_boxes + 1))
        uvd = np.zeros((n, 3), np.float32)
        dims = np.zeros((n, 3), np.float32)
        yawv = np.zeros(n, np.float32)
        lab = rng.integers(0, num_classes, n).astype(np.int32)
        for i in range(n):
            d = rng.uniform(8.0, 30.0)
            u = rng.uniform(0.25 * w, 0.75 * w)
            v = rng.uniform(0.3 * h, 0.7 * h)
            dm = rng.uniform([1.2, 1.2, 3.0], [2.2, 2.0, 5.0])
            yaw = rng.uniform(-np.pi, np.pi)
            uvd[i] = [u, v, d]
            dims[i] = dm
            yawv[i] = yaw
            # silhouette: rectangle of the projected extent
            pw = focal * dm[2] / d / 2
            ph = focal * dm[1] / d / 2
            m = (np.abs(xx - u) < pw) & (np.abs(yy - v) < ph)
            tex = np.where(m, 0.6 + 0.04 * lab[i], tex)
        imgs[b] = _rgb(np.clip(tex, 0, 1))
        tgts = losses.fcos3d_targets(uvd, dims, yawv, lab,
                                     np.ones(n, bool), hw, strides,
                                     num_classes)
        if per_level is None:
            per_level = [{k: [] for k in t} for t in tgts]
        for li, t in enumerate(tgts):
            for k2, v2 in t.items():
                per_level[li][k2].append(v2)
    stacked = [{k: np.stack(v) for k, v in lvl.items()}
               for lvl in per_level]
    return imgs, stacked
