"""End-to-end stereo disparity net (the reference's LEAStereo stage, run
online), counterpart of the JAX package's `models/stereo_net.py`.

A shared feature net at 1/4 resolution -> a group-wise correlation cost
volume over D/4 candidate disparities (entry d holds left[x] . right[x-d],
the shift a pad+slice) -> 3-D conv aggregation over [B, G, D/4, h, w] ->
soft-argmin -> bilinear x4 resize of the disparity, times 4. The output
is a full-resolution disparity in left-image pixels, the convention of
the offline PNGs (`io/perception.read_disparity_png`). Parameters start
from a seeded `torch.Generator` unless weights are given (`layers`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dynamic_vins_tpu_torch.models import layers, pretrained
from dynamic_vins_tpu_torch.utils.precision import resolve_device


class FeatureNet(nn.Module):
    """Shared siamese feature extractor at 1/4 resolution."""

    def __init__(self, width: int = 32, gen=None):
        super().__init__()
        self.ConvGN_0 = layers.ConvGN(3, width, 3, 2, gen=gen)          # /2
        self.ConvGN_1 = layers.ConvGN(width, width, 3, 1, gen=gen)
        self.ConvGN_2 = layers.ConvGN(width, width * 2, 3, 2, gen=gen)  # /4
        self._blocks = layers.stage(self, "BasicBlock", [
            layers.BasicBlock(width * 2, width * 2, gen=gen)
            for _ in range(3)])
        self.Conv_0 = layers.Conv(width * 2, width, 1, gen=gen)

    def forward(self, x):
        x = self.ConvGN_2(self.ConvGN_1(self.ConvGN_0(x)))
        for b in self._blocks:
            x = b(x)
        return self.Conv_0(x)


def correlation_volume(fl, fr, max_disp: int, groups: int = 8):
    """Group-wise correlation: fl, fr [B,C,H,W] -> [B,G,D,H,W], entry d
    the correlation of left[x] with right[x-d] (zero where x < d)."""
    b, c, h, w = fl.shape
    g = c // groups
    fl_g = fl.reshape(b, groups, g, h, w)

    def one(d):
        shifted = F.pad(fr, (d, 0))[..., :w]
        return (fl_g * shifted.reshape(b, groups, g, h, w)).sum(2) \
            / np.sqrt(g)

    return torch.stack([one(d) for d in range(max_disp)], dim=2)


class Aggregation(nn.Module):
    """3-D conv cost aggregation (LEAStereo's matching net role)."""

    def __init__(self, width: int = 16, groups: int = 8, gen=None):
        super().__init__()
        conv = lambda cin, cout: layers.Conv(cin, cout, 3, dims=3, gen=gen)
        self.c0 = conv(groups, width)
        self._res = []
        for i in range(3):
            a, b = conv(width, width), conv(width, width)
            self.add_module(f"c{i}a", a)
            self.add_module(f"c{i}b", b)
            self._res.append((a, b))
        self.out = conv(width, 1)

    def forward(self, vol):
        x = F.relu(self.c0(vol))
        for a, b in self._res:
            x = F.relu(x + b(F.relu(a(x))))
        return self.out(x)[:, 0]                                # [B,D,H,W]


class StereoNet(nn.Module):
    """(left, right) normalized [B,3,H,W] -> disparity [B,H,W]."""

    def __init__(self, max_disp: int = 192, gen=None):
        super().__init__()
        self.max_disp = max_disp
        self.FeatureNet_0 = FeatureNet(gen=gen)
        self.Aggregation_0 = Aggregation(gen=gen)

    def forward(self, left, right):
        fl, fr = self.FeatureNet_0(left), self.FeatureNet_0(right)
        d4 = self.max_disp // 4
        cost = self.Aggregation_0(correlation_volume(fl, fr, d4))
        prob = torch.softmax(-cost.to(torch.float32), dim=1)
        cand = torch.arange(d4, dtype=torch.float32, device=prob.device)
        disp = torch.einsum("bdhw,d->bhw", prob, cand)          # soft argmin
        return layers.resize(disp[:, None], left.shape[-2:])[:, 0] * 4.0


class OnlineStereoMatcher:
    """The online stereo stage (MyStereoMatcher when not reading PNGs):
    a full-resolution float32 disparity map [H,W] on the host, which the
    instance tracker's extra points read (depth = fx * baseline / disp)."""

    def __init__(self, image_hw, max_disp: int = 128,
                 params_path: str | None = None, seed: int = 0,
                 dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.image_hw = tuple(image_hw)
        self.model = pretrained.prepare(
            StereoNet(max_disp=max_disp, gen=layers.seeded(seed)),
            params_path, dtype, self.device)

    @torch.no_grad()
    def run(self, left, right) -> torch.Tensor:
        """The disparity [H,W] on the device."""
        l = layers.normalize_image(left, self.dtype, self.device)
        r = layers.normalize_image(right, self.dtype, self.device)
        return self.model(l, r)[0]

    def __call__(self, left, right) -> np.ndarray:
        return self.run(left, right).cpu().numpy()

