"""SOLOv2 instance segmentation (the reference's online 2D detector,
`det2d/detector2d.cpp:245` + `det2d/solo_head.cpp:410`), counterpart of
the JAX package's `models/solov2.py`.

A grid-based kernel / category head over an FPN (each level resized
onto its SxS grid, CoordConv channels from linspace(-1, 1, S) in (y, x)
order), a unified mask-feature branch, the dynamic 1x1 convolution of
the predicted kernels against the mask features (one [K,E] x [E,h*w]
product) and MatrixNMS (`solo_head.cpp:31`). `decode` keeps fixed
capacities (`pre_nms`, `max_dets`); its top-k is a stable descending
sort, so equal scores keep the lower index first, as `jax.lax.top_k`
does (zero scores tie by the dozen). Parameters start from a seeded
`torch.Generator` unless weights are given (`layers`).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from dynamic_vins_tpu_torch.models import layers, pretrained
from dynamic_vins_tpu_torch.utils.precision import resolve_device


def top_k(x, k: int):
    """(values, indices) of the k largest of x [N], ties to the lower
    index (`jax.lax.top_k`)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


class Solov2Head(nn.Module):
    """Per-FPN-level kernel and category branches (solo_head.cpp)."""

    def __init__(self, num_classes: int = 80, embed_dim: int = 64,
                 grid_sizes: Sequence[int] = (36, 24, 16, 12),
                 in_features: int = 64, head_width: int = 64,
                 stacked_convs: int = 2, gen=None):
        super().__init__()
        self.grid_sizes = tuple(grid_sizes)
        self.embed_dim, self.num_classes = embed_dim, num_classes
        self._kern, self._cate = [], []
        for i in range(stacked_convs):
            k = layers.ConvGN(in_features + 2 if i == 0 else head_width,
                              head_width, gen=gen)
            c = layers.ConvGN(in_features if i == 0 else head_width,
                              head_width, gen=gen)
            self.add_module(f"kern{i}", k)
            self.add_module(f"cate{i}", c)
            self._kern.append(k)
            self._cate.append(c)
        self.kern_out = layers.Conv(head_width, embed_dim, 3, gen=gen)
        self.cate_out = layers.Conv(head_width, num_classes, 3,
                                    bias_init=-4.6, gen=gen)

    def forward(self, pyramid):
        kernels, scores = [], []
        for feat, s in zip(pyramid, self.grid_sizes):
            g = layers.resize(feat, (s, s))
            lin = torch.linspace(-1.0, 1.0, s, dtype=g.dtype,
                                 device=g.device)
            yy, xx = torch.meshgrid(lin, lin, indexing="ij")
            coord = torch.stack([yy, xx])[None].expand(g.shape[0], 2, s, s)
            k = torch.cat([g, coord.to(g.dtype)], 1)
            c = g
            for conv in self._kern:
                k = conv(k)
            for conv in self._cate:
                c = conv(c)
            flat = lambda t: t.permute(0, 2, 3, 1).reshape(
                t.shape[0], s * s, t.shape[1])
            kernels.append(flat(self.kern_out(k)))
            scores.append(flat(self.cate_out(c)))
        return torch.cat(kernels, 1), torch.cat(scores, 1)   # [B,G,E],[B,G,C]


class Solov2(nn.Module):
    """Backbone + FPN + SOLOv2 head + mask feature branch:
    [B,3,H,W] -> (kernels [B,G,E], scores [B,G,C], mask_feat [B,E,h,w])."""

    def __init__(self, num_classes: int = 80, embed_dim: int = 64,
                 grid_sizes: Sequence[int] = (36, 24, 16, 12), gen=None):
        super().__init__()
        if len(grid_sizes) != 4:
            raise ValueError("one grid size per FPN level (4)")
        self.Backbone_0 = layers.Backbone(gen=gen)
        self.FPN_0 = layers.FPN(features=64, gen=gen)
        self.Solov2Head_0 = Solov2Head(num_classes, embed_dim, grid_sizes,
                                       gen=gen)
        self.mask_feat = layers.ConvGN(64, embed_dim, gen=gen)

    def forward(self, img):
        pyramid = self.FPN_0(self.Backbone_0(img))
        kernels, scores = self.Solov2Head_0(pyramid)
        hw = pyramid[0].shape[-2:]
        fused = sum(layers.resize(p, hw) for p in pyramid)
        return kernels, scores, self.mask_feat(fused)


def matrix_nms(masks_bin, labels, scores, sigma: float = 2.0):
    """MatrixNMS (solo_head.cpp:31): masks_bin [K,P] {0,1} sorted by
    score, labels [K], scores [K] -> decayed scores [K]."""
    areas = masks_bin.sum(-1)
    inter = masks_bin @ masks_bin.t()
    union = areas[:, None] + areas[None, :] - inter
    iou = inter / torch.clamp_min(union, 1.0)
    k = masks_bin.shape[0]
    upper = torch.triu(torch.ones((k, k), dtype=torch.bool,
                                  device=masks_bin.device), 1)
    keep = upper.t() & (labels[:, None] == labels[None, :])
    iou = torch.where(keep, iou, 0.0)
    # row j: IoU of mask j with every higher-scored mask of its class
    iou_max = iou.max(1).values
    decay = torch.exp(-(iou ** 2 - iou_max[None, :] ** 2) / sigma)
    decay = torch.where(keep, decay, 1.0)
    return scores * decay.min(1).values


class SegOutput(NamedTuple):
    """Fixed-capacity decode (valid where score > 0)."""

    masks: torch.Tensor     # [max_dets, H, W] bool
    scores: torch.Tensor    # [max_dets]
    labels: torch.Tensor    # [max_dets] int64


def decode(kernels, scores, mask_feat, out_hw, score_thresh: float = 0.3,
           mask_thresh: float = 0.5, update_thresh: float = 0.05,
           pre_nms: int = 128, max_dets: int = 32) -> SegOutput:
    """SOLOv2's postprocess (GetSegTensor, solo_head.cpp:410-520) for
    the first image of the batch."""
    prob, score, label = decode_prob(kernels, scores, mask_feat, out_hw,
                                     score_thresh, mask_thresh,
                                     update_thresh, pre_nms, max_dets)
    return SegOutput(prob > mask_thresh, score, label)


def decode_prob(kernels, scores, mask_feat, out_hw, score_thresh=0.3,
                mask_thresh=0.5, update_thresh=0.05, pre_nms=128,
                max_dets=32):
    """`decode` before the last threshold: (mask probabilities
    [max_dets,H,W], scores, labels)."""
    kernels, scores, mask_feat = kernels[0], scores[0], mask_feat[0]
    cls_score = torch.sigmoid(scores.to(torch.float32))         # [G,C]
    best, label = cls_score.max(-1)
    best = torch.where(best >= score_thresh, best, 0.0)
    top, idx = top_k(best, pre_nms)
    label = label[idx]
    kern = kernels[idx].to(torch.float32)                       # [K,E]

    e, h, w = mask_feat.shape
    logits = kern @ mask_feat.to(torch.float32).reshape(e, h * w)
    prob = torch.sigmoid(logits)                                # [K,hw]
    binm = (prob > mask_thresh).to(torch.float32)
    area = binm.sum(-1)
    quality = (prob * binm).sum(-1) / torch.clamp_min(area, 1.0)
    score = top * quality * (area > 0)

    # MatrixNMS needs descending order
    score, order = top_k(score, pre_nms)
    binm, prob, label = binm[order], prob[order], label[order]
    score = matrix_nms(binm, label, score)
    score = torch.where(score >= update_thresh, score, 0.0)

    score, order = top_k(score, max_dets)
    final = layers.resize(prob[order].reshape(1, max_dets, h, w),
                          out_hw)[0]
    return final, score, label[order]


class OnlineDetector2D:
    """The online segmentation stage (Detector2D::Launch, online mode):
    a `SegResult` on the host."""

    def __init__(self, image_hw, num_classes: int = 80,
                 score_thresh: float = 0.3, max_dets: int = 32,
                 grid_sizes: Sequence[int] = (36, 24, 16, 12),
                 embed_dim: int = 64, params_path: str | None = None,
                 seed: int = 0, dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.image_hw = tuple(image_hw)
        self.score_thresh, self.max_dets = score_thresh, max_dets
        self.model = pretrained.prepare(
            Solov2(num_classes, embed_dim, tuple(grid_sizes),
                   gen=layers.seeded(seed)), params_path, dtype,
            self.device)

    @torch.no_grad()
    def run(self, img) -> SegOutput:
        """The fixed-capacity decode, on the device."""
        x = layers.normalize_image(img, self.dtype, self.device)
        kernels, sc, mfeat = self.model(x)
        return decode(kernels, sc, mfeat, self.image_hw,
                      score_thresh=self.score_thresh,
                      max_dets=self.max_dets)

    def __call__(self, img):
        from dynamic_vins_tpu_torch.io.perception import SegResult

        out = self.run(img)
        scores = out.scores.cpu().numpy()
        keep = scores > 0
        return SegResult(out.masks.cpu().numpy()[keep], scores[keep],
                         out.labels.cpu().numpy().astype(np.int32)[keep])
