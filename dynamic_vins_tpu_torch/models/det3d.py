"""Monocular 3D detection head (FCOS3D/PGD family; the reference runs it
offline, `det3d/detector3d.cpp:64-90`), counterpart of the JAX
package's `models/det3d.py`.

An anchor-free per-pixel head over P3..P5 and a max-pooled P6 predicts
class scores [C], centerness [1] and 8 regression channels: the offset
to the projected 3D centre [2] (in strides), log depth [1], log dims
[3], yaw as (sin, cos) [2]. `decode` lifts (u, v, depth) through the
pinhole intrinsics and keeps a fixed top-k (a stable sort: ties to the
lower index, as `jax.lax.top_k`); `OnlineDetector3D` returns the
`Box3D` list (camera-frame bottom centre, dims, yaw about -y) that
BoxAssociate2Dto3D consumes. Parameters start from a seeded
`torch.Generator` unless weights are given (`layers`).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from dynamic_vins_tpu_torch.models import layers, pretrained
from dynamic_vins_tpu_torch.models.solov2 import top_k
from dynamic_vins_tpu_torch.utils.precision import resolve_device


class FCOS3DHead(nn.Module):
    def __init__(self, num_classes: int = 10, width: int = 64,
                 in_features: int = 64, stacked_convs: int = 2, gen=None):
        super().__init__()
        self._cls, self._reg = [], []
        for i in range(stacked_convs):
            cin = in_features if i == 0 else width
            c = layers.ConvGN(cin, width, gen=gen)
            r = layers.ConvGN(cin, width, gen=gen)
            self.add_module(f"cls{i}", c)
            self.add_module(f"reg{i}", r)
            self._cls.append(c)
            self._reg.append(r)
        self.cls_out = layers.Conv(width, num_classes, 3, bias_init=-4.6,
                                   gen=gen)
        self.ctr_out = layers.Conv(width, 1, 3, gen=gen)
        self.reg_out = layers.Conv(width, 8, 3, gen=gen)

    def forward(self, pyramid):
        outs = []
        for feat in pyramid:
            c = r = feat
            for conv in self._cls:
                c = conv(c)
            for conv in self._reg:
                r = conv(r)
            outs.append((self.cls_out(c), self.ctr_out(c), self.reg_out(r)))
        return outs


class Det3DOutput(NamedTuple):
    """Fixed-capacity decode (valid where score > 0)."""

    scores: torch.Tensor        # [K]
    labels: torch.Tensor        # [K] int64
    centers: torch.Tensor       # [K,3] camera-frame box centres
    dims: torch.Tensor          # [K,3]
    yaws: torch.Tensor          # [K]


class FCOS3D(nn.Module):
    """[B,3,H,W] -> per level (cls [B,C,h,w], ctr [B,1,h,w],
    reg [B,8,h,w]) on P3, P4, P5 and P6."""

    def __init__(self, num_classes: int = 10,
                 strides: Sequence[int] = (8, 16, 32, 64), gen=None):
        super().__init__()
        self.strides = tuple(strides)
        self.Backbone_0 = layers.Backbone(gen=gen)
        self.FPN_0 = layers.FPN(features=64, gen=gen)
        self.FCOS3DHead_0 = FCOS3DHead(num_classes, gen=gen)

    def forward(self, img):
        pyramid = self.FPN_0(self.Backbone_0(img))
        p6 = layers.max_pool2(pyramid[-1])
        return self.FCOS3DHead_0(pyramid[1:] + [p6])


def decode(level_outputs, strides, intrinsics, score_thresh=0.2,
           max_dets: int = 16) -> Det3DOutput:
    """Per-pixel predictions of the first image -> top-k camera-frame
    3D boxes."""
    fx, fy, cx, cy = intrinsics
    scores_all, labels_all, box_all = [], [], []
    for (cls, ctr, reg), s in zip(level_outputs, strides):
        cls, ctr, reg = cls[0], ctr[0], reg[0]
        _, h, w = cls.shape
        prob = torch.sigmoid(cls.to(torch.float32)) * \
            torch.sigmoid(ctr.to(torch.float32))                # [C,h,w]
        f32 = dict(dtype=torch.float32, device=cls.device)
        vv, uu = torch.meshgrid((torch.arange(h, **f32) + 0.5) * s,
                                (torch.arange(w, **f32) + 0.5) * s,
                                indexing="ij")
        reg = reg.to(torch.float32)
        u = uu + reg[0] * s
        v = vv + reg[1] * s
        depth = torch.exp(reg[2])
        dims = torch.exp(reg[3:6])
        yaw = torch.atan2(reg[6], reg[7])
        x = (u - cx) / fx * depth
        y = (v - cy) / fy * depth
        box = torch.stack([x, y, depth, dims[0], dims[1], dims[2], yaw], -1)
        best, label = prob.max(0)
        scores_all.append(best.reshape(-1))
        labels_all.append(label.reshape(-1))
        box_all.append(box.reshape(-1, 7))
    scores = torch.cat(scores_all)
    scores = torch.where(scores >= score_thresh, scores, 0.0)
    top, idx = top_k(scores, max_dets)
    labels = torch.cat(labels_all)[idx]
    box = torch.cat(box_all, 0)[idx]
    return Det3DOutput(top, labels, box[:, :3], box[:, 3:6], box[:, 6])


class OnlineDetector3D:
    """The online mono 3D detection stage: a list of `Box3D` (the
    bottom-centre convention of Box3dFromFCOS3D, basic/box3d.cpp:27-90)."""

    def __init__(self, image_hw, intrinsics, num_classes: int = 10,
                 score_thresh: float = 0.2, max_dets: int = 16,
                 params_path: str | None = None, seed: int = 0,
                 dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.image_hw = tuple(image_hw)
        self.intrinsics = tuple(float(v) for v in intrinsics)
        self.score_thresh, self.max_dets = score_thresh, max_dets
        self.model = pretrained.prepare(
            FCOS3D(num_classes, gen=layers.seeded(seed)), params_path,
            dtype, self.device)

    @torch.no_grad()
    def run(self, img) -> Det3DOutput:
        """The fixed-capacity decode, on the device."""
        x = layers.normalize_image(img, self.dtype, self.device)
        return decode(self.model(x), self.model.strides, self.intrinsics,
                      score_thresh=self.score_thresh,
                      max_dets=self.max_dets)

    def __call__(self, img):
        from dynamic_vins_tpu_torch.io.perception import (NUSCENES_TO_KITTI,
                                                          Box3D)

        out = Det3DOutput(*(t.cpu().numpy() for t in self.run(img)))
        boxes = []
        for i in range(len(out.scores)):
            s = float(out.scores[i])
            if s <= 0:
                continue
            dims = out.dims[i].copy()
            bottom = out.centers[i].copy()
            bottom[1] += dims[1] / 2.0
            boxes.append(Box3D(
                class_name=NUSCENES_TO_KITTI.get(int(out.labels[i]),
                                                 "DontCare"),
                score=s, bottom_center=bottom, dims=dims,
                yaw=float(out.yaws[i])))
        return boxes

