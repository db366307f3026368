"""Appearance (ReID) embeddings for MOT (the reference's DeepSORT
branch, `mot/extractor.cpp:31-52`), counterpart of the JAX package's
`models/reid.py`: L2-normalized embeddings of fixed-size box crops,
plugged into `MultiObjectTracker(embed_fn=...)`. The crops are cut,
clamped and resized (nearest) on the host as numpy, as the JAX package
cuts them; the net runs on the device. Parameters start from a seeded
`torch.Generator` unless weights are given (`layers`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dynamic_vins_tpu_torch.models import layers, pretrained
from dynamic_vins_tpu_torch.utils.precision import resolve_device

CROP_HW = (64, 32)      # h, w of the ReID input crop (DeepSORT: 128x64)


class Dense(nn.Module):
    """flax `nn.Dense`: weight [out, in] (the flax kernel transposed)."""

    def __init__(self, cin: int, cout: int, gen=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        layers.lecun_normal_(self.weight, cin, gen)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return x.to(self.weight.dtype) @ self.weight.t() + self.bias


class ReidNet(nn.Module):
    """Normalized crops [B,3,64,32] -> unit embeddings [B,embed_dim]."""

    def __init__(self, embed_dim: int = 128, gen=None):
        super().__init__()
        self.ConvGN_0 = layers.ConvGN(3, 32, 3, 1, gen=gen)
        self._blocks = layers.stage(self, "BasicBlock", [
            layers.BasicBlock(32, 32, gen=gen),
            layers.BasicBlock(32, 64, 2, gen=gen),
            layers.BasicBlock(64, 128, 2, gen=gen)])
        self.Dense_0 = Dense(128, embed_dim, gen=gen)

    def forward(self, x):
        x = layers.max_pool2(self.ConvGN_0(x))
        for b in self._blocks:
            x = b(x)
        x = self.Dense_0(x.mean(dim=(2, 3))).to(torch.float32)      # GAP
        return x / torch.clamp_min(torch.linalg.norm(x, dim=-1,
                                                     keepdim=True), 1e-6)


class ReidExtractor:
    """Crop + resize + embed at a fixed batch capacity."""

    def __init__(self, max_boxes: int = 16, params_path: str | None = None,
                 seed: int = 0, dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.max_boxes = max_boxes
        self.model = pretrained.prepare(
            ReidNet(gen=layers.seeded(seed)), params_path, dtype,
            self.device)

    def crops(self, img, boxes) -> np.ndarray:
        """img [H,W] (grey) / [H,W,3], boxes [N,4] tlbr -> the normalized
        crops [max_boxes, 64, 32, 3] (zero rows past N) on the host."""
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        n = min(len(boxes), self.max_boxes)
        out = np.zeros((self.max_boxes,) + CROP_HW + (3,), np.float32)
        for i in range(n):
            x0, y0, x1, y1 = [int(v) for v in boxes[i]]
            x0, y0 = max(x0, 0), max(y0, 0)
            x1 = min(max(x1, x0 + 1), img.shape[1])
            y1 = min(max(y1, y0 + 1), img.shape[0])
            out[i] = _resize_np(img[y0:y1, x0:x1].astype(np.float32),
                                CROP_HW)
        return (out / 255.0 - 0.45) / 0.225

    @torch.no_grad()
    def embed(self, crops) -> torch.Tensor:
        """Normalized crops [B,64,32,3] (numpy, NHWC) -> [B,embed]."""
        x = torch.from_numpy(np.ascontiguousarray(crops)).to(
            self.device, self.dtype).permute(0, 3, 1, 2)
        return self.model(x)

    def __call__(self, img, boxes) -> np.ndarray:
        """img [H,W] / [H,W,3]; boxes [N,4] tlbr -> [N,embed] (host)."""
        n = min(len(boxes), self.max_boxes)
        return self.embed(self.crops(img, boxes)).cpu().numpy()[:n]


def _resize_np(img, hw):
    """Nearest-neighbour host resize (crops are tiny)."""
    h, w = hw
    ys = (np.arange(h) * img.shape[0] / h).astype(int)
    xs = (np.arange(w) * img.shape[1] / w).astype(int)
    return img[ys][:, xs]
