"""RAFT-style recurrent optical flow (the reference's dense-flow stage,
`flow/raft.{h,cpp}`), counterpart of the JAX package's `models/raft.py`.

fnet: a shared feature encoder at 1/8; cnet: a context encoder at 1/8
(hidden state, context); the all-pairs correlation volume [h*w, h*w]
(one matrix product); a ConvGRU update with a (2r+1)^2 window looked up
around each pixel's current target, iterated a fixed number of times
with shared parameters; the final 1/8 flow resized x8 bilinearly.

Flattened pixel indices are `y * w + x`, as in the JAX package's NHWC
reshapes. The lookup clamps each sample's corner to [0, w-2] x [0, h-2]
and its weights to [0, 1] (no zero padding). Parameters start from a
seeded `torch.Generator` unless weights are given (`layers`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dynamic_vins_tpu_torch.models import layers, pretrained
from dynamic_vins_tpu_torch.utils.precision import resolve_device


class Encoder(nn.Module):
    """1/8-resolution conv encoder (fnet / cnet)."""

    def __init__(self, out_dim: int = 96, gen=None):
        super().__init__()
        self.ConvGN_0 = layers.ConvGN(3, 32, 7, 2, gen=gen)       # /2
        layers.stage(self, "BasicBlock", [
            layers.BasicBlock(32, 32, gen=gen),
            layers.BasicBlock(32, 48, 2, gen=gen),                # /4
            layers.BasicBlock(48, 64, 2, gen=gen)])               # /8
        self.Conv_0 = layers.Conv(64, out_dim, 1, gen=gen)

    def forward(self, x):
        x = self.ConvGN_0(x)
        x = self.BasicBlock_2(self.BasicBlock_1(self.BasicBlock_0(x)))
        return self.Conv_0(x)


def all_pairs_correlation(f1, f2):
    """[...,c,h,w] x [...,c,h,w] -> [..., h*w, h, w] correlation
    volume (one product an image)."""
    *lead, c, h, w = f1.shape
    a = f1.reshape(*lead, c, h * w).transpose(-1, -2).to(torch.float32)
    b = f2.reshape(*lead, c, h * w).to(torch.float32)
    return (a @ b / math.sqrt(c)).reshape(*lead, h * w, h, w)


def lookup(corr, coords, radius: int = 3):
    """Bilinear samples of corr [N,h,w] in a (2r+1)^2 window (x fastest)
    around coords [N,2] (x, y) -> [N, (2r+1)^2]."""
    n, h, w = corr.shape
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32,
                        device=corr.device)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    x = coords[:, 0:1] + dx.reshape(1, -1)
    y = coords[:, 1:2] + dy.reshape(1, -1)
    x0 = torch.clamp(torch.floor(x), 0, w - 2)
    y0 = torch.clamp(torch.floor(y), 0, h - 2)
    ax = torch.clamp(x - x0, 0.0, 1.0)
    ay = torch.clamp(y - y0, 0.0, 1.0)
    idx = y0.to(torch.int64) * w + x0.to(torch.int64)
    flat = corr.reshape(n, h * w)
    v = lambda i: torch.gather(flat, 1, i)
    return (v(idx) * (1 - ax) * (1 - ay) + v(idx + 1) * ax * (1 - ay)
            + v(idx + w) * (1 - ax) * ay + v(idx + w + 1) * ax * ay)


class ConvGRU(nn.Module):
    def __init__(self, hidden: int, cin: int, gen=None):
        super().__init__()
        self.z = layers.Conv(hidden + cin, hidden, 3, gen=gen)
        self.r = layers.Conv(hidden + cin, hidden, 3, gen=gen)
        self.q = layers.Conv(hidden + cin, hidden, 3, gen=gen)

    def forward(self, h, x):
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(self.z(hx))
        r = torch.sigmoid(self.r(hx))
        q = torch.tanh(self.q(torch.cat([r * h, x], 1)))
        return (1 - z) * h + z * q


class UpdateBlock(nn.Module):
    def __init__(self, hidden: int = 64, corr_dim: int = 49, gen=None):
        super().__init__()
        self.enc_corr = layers.Conv(corr_dim + 2, 48, 3, gen=gen)
        self.ConvGRU_0 = ConvGRU(hidden, hidden + 48, gen=gen)
        self.flow_mid = layers.Conv(hidden, 64, 3, gen=gen)
        self.flow_head = layers.Conv(64, 2, 3, gen=gen)

    def forward(self, h, ctx, corr_feat, flow):
        mot = F.relu(self.enc_corr(torch.cat([corr_feat, flow], 1)))
        h = self.ConvGRU_0(h, torch.cat([ctx, mot], 1))
        return h, self.flow_head(F.relu(self.flow_mid(h)))


class RAFT(nn.Module):
    """(img1, img2) normalized [B,3,H,W] -> flow [B,2,H,W] (pixels).
    Each image of the batch is its own problem (GroupNorm's statistics
    and the correlation volume are per image): the batch computes what
    the JAX package's single-image RAFT computes vmapped over it."""

    def __init__(self, iters: int = 8, radius: int = 3, hidden: int = 64,
                 gen=None):
        super().__init__()
        self.iters, self.radius, self.hidden = iters, radius, hidden
        self.fnet = Encoder(96, gen=gen)
        self.cnet = Encoder(hidden * 2, gen=gen)
        self.UpdateBlock_0 = UpdateBlock(hidden, (2 * radius + 1) ** 2,
                                         gen=gen)

    def forward(self, img1, img2):
        f1, f2 = self.fnet(img1), self.fnet(img2)                # [B,c,h,w]
        ctx_all = self.cnet(img1)
        h = torch.tanh(ctx_all[:, :self.hidden])
        ctx = F.relu(ctx_all[:, self.hidden:])
        bsz, _, hgt, wid = f1.shape
        n = hgt * wid
        corr = all_pairs_correlation(f1, f2).reshape(bsz * n, hgt, wid)
        ys, xs = torch.meshgrid(
            torch.arange(hgt, dtype=torch.float32, device=f1.device),
            torch.arange(wid, dtype=torch.float32, device=f1.device),
            indexing="ij")
        base = torch.stack([xs, ys], -1).reshape(1, n, 2)        # [1,N,2]
        flow = torch.zeros((bsz, 2, hgt, wid), dtype=torch.float32,
                           device=f1.device)
        for _ in range(self.iters):
            coords = base + flow.permute(0, 2, 3, 1).reshape(bsz, n, 2)
            cf = lookup(corr, coords.reshape(bsz * n, 2), self.radius)
            cf = cf.reshape(bsz, n, -1).transpose(1, 2).reshape(
                bsz, -1, hgt, wid)                               # [B,K,h,w]
            h, dflow = self.UpdateBlock_0(h, ctx, cf, flow)
            flow = flow + dflow.to(torch.float32)
        return layers.resize(flow, img1.shape[-2:]) * 8.0


class OnlineFlowEstimator:
    """The online dense-flow stage (FlowEstimator::Launch): a
    full-resolution [H,W,2] float32 flow field (pixels, img1 -> img2),
    left on the device for the tracker."""

    def __init__(self, image_hw, iters: int = 8,
                 params_path: str | None = None, seed: int = 0,
                 dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.image_hw = tuple(image_hw)
        self.model = pretrained.prepare(
            RAFT(iters=iters, gen=layers.seeded(seed)), params_path,
            dtype, self.device)

    @torch.no_grad()
    def __call__(self, img1, img2) -> torch.Tensor:
        a = layers.normalize_image(img1, self.dtype, self.device)
        b = layers.normalize_image(img2, self.dtype, self.device)
        return self.model(a, b)[0].permute(1, 2, 0)
