"""Shared building blocks of the online perception nets, in NCHW.

Counterpart of the JAX package's `models/layers.py` (flax, NHWC). The
blocks compute what the flax modules compute, with flax's conventions
kept where they differ from torch's defaults:
  * `padding="SAME"` with a stride is asymmetric: flax pads `total // 2`
    before and the rest after (a 3x3 stride-2 conv on an even input pads
    (0, 1), a 7x7 stride-2 one (2, 3)); `Conv` pads explicitly;
  * flax's GroupNorm: epsilon 1e-6, statistics in float32 as
    E[x^2] - E[x]^2, output cast to float32 whatever the compute type;
  * `jax.image.resize` samples at half-pixel centres and antialiases
    (a triangle filter) when it shrinks: `resize` builds its weights and
    applies them as two products, as XLA does (equal to it shrinking and
    growing), nearest is "nearest-exact";
  * `nn.max_pool` is VALID: `F.max_pool2d(2, 2)`.

Submodules carry the names flax gives them (`ConvGN_0`, `BasicBlock_3`,
`lat2`, ...), so a flax parameter path is the torch one
(`convert.flax_params`). A module's parameters start from a seeded
`torch.Generator` (flax's default initializers: LeCun-normal kernels,
zero biases, unit GroupNorm scales); torch cannot reproduce JAX's PRNG
draws, so parity runs carry the JAX parameters across instead.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6            # flax.linen.GroupNorm's epsilon


def same_pad(x, kernel: Sequence[int], stride: Sequence[int]):
    """Pad the trailing len(kernel) dims as flax's "SAME" does."""
    pads = []
    for n, k, s in reversed(list(zip(x.shape[-len(kernel):], kernel,
                                     stride))):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def lecun_normal_(w, fan_in: int, gen: torch.Generator):
    """flax's default kernel init: truncated normal (+-2 sd) of variance
    1 / fan_in, the sd corrected for the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=gen)


class Conv(nn.Module):
    """flax `nn.Conv` with "SAME" padding over 2 or 3 spatial dims.

    weight [out, in, *kernel] (flax HWIO / DHWIO transposed); the input
    is cast to the weight's type (flax promotes to its compute dtype)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, bias: bool = True, dims: int = 2,
                 bias_init: float = 0.0, gen=None):
        super().__init__()
        self.kernel = (kernel,) * dims
        self.stride = (stride,) * dims
        self.weight = nn.Parameter(torch.empty(cout, cin, *self.kernel))
        lecun_normal_(self.weight, cin * kernel ** dims, gen)
        self.bias = nn.Parameter(torch.full((cout,), float(bias_init))) \
            if bias else None

    def forward(self, x):
        x = same_pad(x.to(self.weight.dtype), self.kernel, self.stride)
        conv = F.conv2d if len(self.kernel) == 2 else F.conv3d
        return conv(x, self.weight, self.bias, self.stride)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm(dtype=float32)` over NC* inputs."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, c = x.shape[:2]
        xg = x.reshape(b, self.groups, -1)
        x32 = xg.to(torch.float32)
        mu = x32.mean(-1, keepdim=True)
        var = torch.clamp_min((x32 * x32).mean(-1, keepdim=True) - mu * mu,
                              0.0)
        # flax: mul = rsqrt(var + eps) * scale, in float32
        mul = torch.rsqrt(var + GN_EPS).reshape(b, self.groups, 1) \
            * self.weight.to(torch.float32).reshape(self.groups, -1)
        y = (xg - mu).reshape(b, self.groups, c // self.groups, -1) \
            * mul[..., None]
        y = y.reshape(x.shape) + self.bias.reshape(
            (1, c) + (1,) * (x.dim() - 2))
        return y.to(torch.float32)


class ConvGN(nn.Module):
    """Conv (no bias) -> GroupNorm -> ReLU."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 8, act: bool = True,
                 gen=None):
        super().__init__()
        self.Conv_0 = Conv(cin, features, kernel, stride, bias=False,
                           gen=gen)
        self.GroupNorm_0 = GroupNorm(features, min(groups, features))
        self.act = act

    def forward(self, x):
        x = self.GroupNorm_0(self.Conv_0(x))
        return F.relu(x) if self.act else x


class BasicBlock(nn.Module):
    """ResNet-18 style residual block."""

    def __init__(self, cin: int, features: int, stride: int = 1, gen=None):
        super().__init__()
        self.ConvGN_0 = ConvGN(cin, features, 3, stride, gen=gen)
        self.ConvGN_1 = ConvGN(features, features, 3, 1, act=False,
                               gen=gen)
        self.ConvGN_2 = ConvGN(cin, features, 1, stride, act=False,
                               gen=gen) \
            if cin != features or stride != 1 else None

    def forward(self, x):
        y = self.ConvGN_1(self.ConvGN_0(x))
        if self.ConvGN_2 is not None:
            x = self.ConvGN_2(x)
        return F.relu(x + y)


def stage(module, name_prefix: str, blocks):
    """Register `blocks` on `module` as name_prefix_0, _1, ... (flax's
    automatic names) and return them in order."""
    for i, b in enumerate(blocks):
        module.add_module(f"{name_prefix}_{i}", b)
    return list(blocks)


def max_pool2(x):
    """flax `nn.max_pool(x, (2, 2), strides=(2, 2))` (VALID)."""
    return F.max_pool2d(x, 2, 2)


class Backbone(nn.Module):
    """Small ResNet returning C2..C5 (strides 4, 8, 16, 32)."""

    def __init__(self, widths: Sequence[int] = (32, 64, 128, 256),
                 blocks_per_stage: int = 2, gen=None):
        super().__init__()
        self.ConvGN_0 = ConvGN(3, widths[0], 7, 2, gen=gen)
        blocks, cin = [], widths[0]
        self._ends = []
        for i, w in enumerate(widths):
            blocks.append(BasicBlock(cin, w, 1 if i == 0 else 2, gen=gen))
            blocks += [BasicBlock(w, w, 1, gen=gen)
                       for _ in range(blocks_per_stage - 1)]
            cin = w
            self._ends.append(len(blocks) - 1)
        self._blocks = stage(self, "BasicBlock", blocks)

    def forward(self, x):
        x = max_pool2(self.ConvGN_0(x))
        feats = []
        for i, b in enumerate(self._blocks):
            x = b(x)
            if i in self._ends:
                feats.append(x)
        return feats


class FPN(nn.Module):
    """Top-down feature pyramid: C2..C5 -> P2..P5, all `features` wide."""

    def __init__(self, in_widths: Sequence[int] = (32, 64, 128, 256),
                 features: int = 64, gen=None):
        super().__init__()
        self._lat = [Conv(c, features, 1, gen=gen) for c in in_widths]
        self._post = [Conv(features, features, 3, gen=gen)
                      for _ in in_widths]
        for i, (lat, post) in enumerate(zip(self._lat, self._post)):
            self.add_module(f"lat{i}", lat)
            self.add_module(f"post{i}", post)

    def forward(self, feats):
        laterals = [lat(f) for lat, f in zip(self._lat, feats)]
        out = [laterals[-1]]
        for lat in reversed(laterals[:-1]):
            up = F.interpolate(out[0], size=lat.shape[-2:],
                               mode="nearest-exact")
            out.insert(0, lat + up)
        return [post(p) for post, p in zip(self._post, out)]


@functools.lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int, dtype, device):
    """[in, out] weights of `jax.image.resize(..., "bilinear")` along
    one axis: half-pixel centres, the triangle kernel widened by the
    shrink factor, columns normalized (computed in float64), kept on
    the device (an upload a call would wait for the card's queue)."""
    inv_scale = 1.0 / (out_size / in_size)
    sample_f = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size)[:, None]) \
        / max(inv_scale, 1.0)
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.from_numpy(np.where(inside[None, :], w, 0)).to(
        device=device, dtype=dtype)


def resize(x, hw):
    """`jax.image.resize(..., "bilinear")` of [..., H, W] to `hw`:
    half-pixel centres, a triangle filter when shrinking (the JAX
    package's `upsample_to`, its other bilinear resizes and ORB's
    pyramid). The rows' weights, then the columns', as XLA computes it:
    antialiased interpolation sums the same taps in another order."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    wy = _resize_weights(x.shape[-2], hw[0], x.dtype, x.device)
    wx = _resize_weights(x.shape[-1], hw[1], x.dtype, x.device)
    return torch.matmul(torch.matmul(wy.T, x), wx)



def normalize_image(img, dtype=torch.float32, device="cpu"):
    """[H,W] or [H,W,C] uint8/float image (numpy or tensor) -> normalized
    [1,3,H,W]; grey inputs are broadcast to 3 channels."""
    x = img if isinstance(img, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(img))
    x = x.to(device=device, dtype=dtype) / 255.0
    if x.dim() == 2:
        x = x[..., None]
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], 3)
    x = (x - 0.45) / 0.225
    return x.permute(2, 0, 1)[None].contiguous()


def seeded(seed: int) -> torch.Generator:
    """The CPU generator a module's initialization draws from."""
    return torch.Generator().manual_seed(int(seed))
