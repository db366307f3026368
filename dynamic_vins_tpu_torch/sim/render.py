"""Render synthetic camera images of the simulated landmark world.

Landmarks are splatted as Gaussian blobs whose image motion is exactly
consistent with the ground-truth trajectory, which closes the image ->
tracker -> estimator loop without a dataset on disk.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamic_vins_tpu_torch.geometry.camera import PinholeIntrinsics
from dynamic_vins_tpu_torch.sim.synthetic import StereoRig, observe


def small_rig(scale: float = 0.5, dtype=torch.float64) -> StereoRig:
    """Reduced-resolution rig for fast image-domain tests."""
    base = StereoRig.default(dtype=dtype)
    intr = PinholeIntrinsics.make(
        float(base.intr.fx) * scale, float(base.intr.fy) * scale,
        float(base.intr.cx) * scale, float(base.intr.cy) * scale,
        dtype=dtype)
    return base._replace(intr=intr, width=int(752 * scale),
                         height=int(480 * scale))


def render_frame(rig: StereoRig, p_wb, q_wb, landmarks, intensities,
                 cam: int = 0, sigma: float = 1.6):
    """One [H,W] image with Gaussian splats, on landmarks' device.

    Splats accumulate one landmark at a time, in landmark order (the
    JAX scan's summation order)."""
    uv, vis, _ = observe(rig, p_wb, q_wb, landmarks, cam=cam)
    H, W = rig.height, rig.width
    dev = uv.device
    yy, xx = torch.meshgrid(torch.arange(H, dtype=uv.dtype, device=dev),
                            torch.arange(W, dtype=uv.dtype, device=dev),
                            indexing="ij")
    img = torch.zeros((H, W), dtype=uv.dtype, device=dev)
    inten = intensities.to(device=dev, dtype=uv.dtype)
    for i in range(uv.shape[0]):
        d2 = (xx - uv[i, 0]) ** 2 + (yy - uv[i, 1]) ** 2
        blob = inten[i] * torch.exp(-d2 / (2.0 * sigma * sigma))
        img = img + torch.where(vis[i], blob, 0.0)
    return torch.clamp(img, 0.0, 255.0)


def make_intensities(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.uniform(120.0, 255.0, size=n))


def render_depth(rig: StereoRig, p_wb, q_wb, landmarks, cam: int = 0,
                 radius: float = 3.0):
    """Depth image consistent with `render_frame`'s splats: each pixel
    takes the nearest landmark depth whose splat center lies within
    `radius` px (inf where none does), on landmarks' device."""
    uv, vis, ptc = observe(rig, p_wb, q_wb, landmarks, cam=cam)
    H, W = rig.height, rig.width
    dev = uv.device
    yy, xx = torch.meshgrid(torch.arange(H, dtype=uv.dtype, device=dev),
                            torch.arange(W, dtype=uv.dtype, device=dev),
                            indexing="ij")
    depth = torch.full((H, W), float("inf"), dtype=uv.dtype, device=dev)
    for i in range(uv.shape[0]):
        d2 = (xx - uv[i, 0]) ** 2 + (yy - uv[i, 1]) ** 2
        cand = torch.where(vis[i] & (d2 <= radius * radius), ptc[i, 2],
                           float("inf"))
        depth = torch.minimum(depth, cand)
    return depth
