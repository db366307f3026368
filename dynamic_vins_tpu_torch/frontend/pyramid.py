"""Image pyramids and image-processing primitives (plain torch).

Gaussian pyramid, Scharr gradients, bilinear sampling and 3x3
morphology. Edge padding is an index clamp; sums run in the same term
order as the JAX package's so float32 results agree to rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

_GAUSS5 = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def _edge_pad_rows(img, r):
    H = img.shape[0]
    idx = torch.arange(-r, H + r, device=img.device).clamp(0, H - 1)
    return img[idx]


def _edge_pad_cols(img, r):
    W = img.shape[1]
    idx = torch.arange(-r, W + r, device=img.device).clamp(0, W - 1)
    return img[:, idx]


def _wsum(terms):
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def gaussian_blur5(img):
    """Separable 5-tap Gaussian blur, edge padding. img: [H,W]."""
    H, W = img.shape
    k = torch.tensor(_GAUSS5, dtype=img.dtype, device=img.device)
    pad = _edge_pad_rows(img, 2)
    img = _wsum([k[i] * pad[i:i + H, :] for i in range(5)])
    pad = _edge_pad_cols(img, 2)
    return _wsum([k[i] * pad[:, i:i + W] for i in range(5)])


def pyr_down(img):
    """Blur + 2x decimation (cv::pyrDown semantics), contiguous."""
    return gaussian_blur5(img)[::2, ::2].contiguous()


def build_pyramid(img, levels: int):
    """List of [H/2^l, W/2^l] images, level 0 = input."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def scharr_gradients(img):
    """Scharr x/y gradients (the 3x3 kernel OpenCV uses for LK)."""
    h, w = img.shape
    p = _edge_pad_cols(_edge_pad_rows(img, 1), 1)
    sm = torch.tensor([3.0 / 16, 10.0 / 16, 3.0 / 16], dtype=img.dtype,
                      device=img.device)
    df = torch.tensor([-0.5, 0.0, 0.5], dtype=img.dtype, device=img.device)

    def sep(kr, kc):
        t = _wsum([kr[i] * p[i:i + h, :] for i in range(3)])
        return _wsum([kc[j] * t[:, j:j + w] for j in range(3)])

    return sep(sm, df), sep(df, sm)


def bilinear_sample(img, xy):
    """Sample img [H,W] at float coords xy [...,2] (x, y order);
    out-of-bounds coords clamp to the border."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f).to(img.dtype)
    fy = (y - y0f).to(img.dtype)
    x0 = x0f.long()
    y0 = y0f.long()
    x1 = torch.clamp_max(x0 + 1, W - 1)
    y1 = torch.clamp_max(y0 + 1, H - 1)
    flat = img.reshape(-1)
    v = lambda yy, xx: flat[yy * W + xx]
    return ((1 - fy) * ((1 - fx) * v(y0, x0) + fx * v(y0, x1))
            + fy * ((1 - fx) * v(y1, x0) + fx * v(y1, x1)))


def sample_patch(img, center_xy, radius: int):
    """Bilinear patch [...,(2r+1),(2r+1)] around float centers [...,2]."""
    d = torch.arange(-radius, radius + 1, dtype=img.dtype,
                     device=img.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    offs = torch.stack([dx, dy], dim=-1)
    return bilinear_sample(img, center_xy[..., None, None, :] + offs)


def erode3(mask, iterations: int = 1):
    """3x3 binary erosion; out-of-image neighbours count as set."""
    m = mask.to(torch.float32)[None, None]
    for _ in range(iterations):
        m = -nnf.max_pool2d(-m, 3, stride=1, padding=1)
    return m[0, 0] > 0.5


def dilate3(mask, iterations: int = 1):
    """3x3 binary dilation; out-of-image neighbours count as clear."""
    m = mask.to(torch.float32)[None, None]
    for _ in range(iterations):
        m = nnf.max_pool2d(m, 3, stride=1, padding=1)
    return m[0, 0] > 0.5
