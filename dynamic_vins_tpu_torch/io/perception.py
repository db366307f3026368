"""Perception results as the DYNAMIC and NAIVE modes consume them: the
instance segmentation of a frame, camera-frame 3D boxes, the COCO class
filters, and the mask helpers (the reference's ImageProcessor /
SemanticImage outputs); and the offline artifacts in the reference's
own file formats, read and written as the JAX package does:
  * SOLOv2 results as torch tensors `seg_label_{seq}.pt` /
    `cate_score_{seq}.pt` / `cate_label_{seq}.pt` (detector2d.cpp:
    419-449), loaded with `weights_only=True`;
  * FCOS3D/PGD per-frame txt files (detector3d.cpp:64-90);
  * LEAStereo disparity PNGs, disp = png / 256 (stereo.cpp:32-44),
    through `io/image_io` (16-bit, unchanged);
  * KITTI-tracking ground-truth labels (detector3d.cpp:93-130).
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from dynamic_vins_tpu_torch.io import image_io

# NuScenes class ids (FCOS3D output) -> KITTI-ish names
NUSCENES_CLASSES = ["car", "truck", "trailer", "bus",
                    "construction_vehicle", "bicycle", "motorcycle",
                    "pedestrian", "traffic_cone", "barrier"]
NUSCENES_TO_KITTI = {0: "Car", 1: "Truck", 3: "Tram", 5: "Cyclist",
                     6: "Cyclist", 7: "Pedestrian"}
# classes treated as dynamic on KITTI (image_process.cpp:218-232)
KITTI_DYNAMIC_CLASSES = {"Car", "Van", "Truck", "Tram"}

# COCO ids considered dynamic (coco_utils.h:26-43 class filter)
COCO_DYNAMIC_IDS = {0, 1, 2, 3, 5, 6, 7}   # person..truck

COCO_TO_KITTI = {2: "Car", 5: "Tram", 7: "Truck", 0: "Pedestrian",
                 1: "Cyclist", 3: "Cyclist"}


class Box3D(NamedTuple):
    """Monocular 3D detection in CAMERA coordinates (y down, z front).

    bottom_center: [3] center of the box bottom face;
    dims: [3] extents along camera x,y,z at yaw=0; yaw around -y."""

    class_name: str
    score: float
    bottom_center: np.ndarray
    dims: np.ndarray
    yaw: float

    @property
    def center(self):
        c = self.bottom_center.copy()
        c[1] -= self.dims[1] / 2.0
        return c

    def rotation_matrix(self):
        """R_cam_obj (yaw about the camera -y axis, box3d.h:81)."""
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        return np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0],
                         [-sy, 0.0, cy]])


class SegResult(NamedTuple):
    masks: np.ndarray        # [N,H,W] bool
    scores: np.ndarray       # [N]
    labels: np.ndarray       # [N] int (COCO ids)


def masks_to_boxes2d(masks: np.ndarray) -> np.ndarray:
    """Per-mask tight bbox [N,4] tlbr (BuildBoxes2D detector2d.cpp:58)."""
    out = np.zeros((len(masks), 4))
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if not len(xs):
            continue
        out[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return out


def merge_masks(masks: np.ndarray, shape=None) -> np.ndarray:
    """Union of instance masks (SemanticImage merge_mask)."""
    if len(masks) == 0:
        if shape is None:
            raise ValueError("need shape for empty mask set")
        return np.zeros(shape, bool)
    return np.any(masks, axis=0)


def read_fcos3d_txt(path: str, score_threshold: float = 0.2
                    ) -> List[Box3D]:
    """Per-frame FCOS3D/PGD text output: each line
    `class score cx cy cz dx dy dz yaw [...]` (detector3d.cpp:64)."""
    boxes = []
    if not os.path.exists(path):
        return boxes
    with open(path) as f:
        for line in f:
            tok = line.split()
            if len(tok) < 9:
                continue
            score = float(tok[1])
            if score < score_threshold:
                continue
            cls = NUSCENES_TO_KITTI.get(int(float(tok[0])), "DontCare")
            boxes.append(Box3D(
                class_name=cls, score=score,
                bottom_center=np.array([float(tok[2]), float(tok[3]),
                                        float(tok[4])]),
                dims=np.array([float(tok[5]), float(tok[6]),
                               float(tok[7])]),
                yaw=float(tok[8])))
    return boxes


def read_kitti_tracking_labels(path: str) -> Dict[int, List[dict]]:
    """KITTI tracking label file -> {frame: [tracked objects]}
    (ReadGroundtruthFromKittiTracking detector3d.cpp:93)."""
    out: Dict[int, List[dict]] = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            tok = line.split()
            if len(tok) < 17:
                continue
            frame = int(tok[0])
            obj = dict(
                track_id=int(tok[1]), class_name=tok[2],
                truncated=float(tok[3]), occluded=int(tok[4]),
                alpha=float(tok[5]),
                bbox=np.array([float(tok[6]), float(tok[7]),
                               float(tok[8]), float(tok[9])]),
                # label dims are h,w,l -> camera x,y,z extents l,h,w
                dims=np.array([float(tok[12]), float(tok[10]),
                               float(tok[11])]),
                bottom_center=np.array([float(tok[13]), float(tok[14]),
                                        float(tok[15])]),
                yaw=float(tok[16]))
            out.setdefault(frame, []).append(obj)
    return out


def read_disparity_png(path: str) -> Optional[np.ndarray]:
    """LEAStereo disparity PNG: uint16 png / 256 -> float disparity
    (stereo.cpp:32-44)."""
    raw = image_io.imread(path, "unchanged")
    if raw is None:
        return None
    return raw.astype(np.float32) / 256.0


def read_solo_seg_pt(dir_path: str, seq: str,
                     score_threshold: float = 0.3
                     ) -> Optional[SegResult]:
    """SOLOv2 offline tensors `seg_label_{seq}.pt` etc.
    (detector2d.cpp:421-449)."""
    paths = {k: os.path.join(dir_path, f"{k}_{seq}.pt")
             for k in ("seg_label", "cate_score", "cate_label")}
    if not all(os.path.exists(p) for p in paths.values()):
        return None
    seg = torch.load(paths["seg_label"], map_location="cpu",
                     weights_only=True)
    score = torch.load(paths["cate_score"], map_location="cpu",
                       weights_only=True)
    label = torch.load(paths["cate_label"], map_location="cpu",
                       weights_only=True)
    seg = seg.numpy().astype(bool)
    score = score.numpy().astype(np.float32)
    label = label.numpy().astype(np.int64)
    keep = score >= score_threshold
    return SegResult(seg[keep], score[keep], label[keep])


# ---------------------------------------------------------------------------
# Artifact WRITERS — inverse of the readers above, byte-compatible with
# the reference's offline preprocessing outputs (scripts/python/
# solov2_det2d_kitti.py, fcos3d_det3d_kitti.py, leastereo_kitti.py).
# ---------------------------------------------------------------------------
_KITTI_TO_NUSCENES = {"Car": 0, "Truck": 1, "Tram": 3, "Cyclist": 5,
                      "Pedestrian": 7}


def write_solo_seg_pt(dir_path: str, seq: str, seg: SegResult) -> None:
    """Dump a SegResult as `seg_label_{seq}.pt` / `cate_score_{seq}.pt`
    / `cate_label_{seq}.pt` (the tensors detector2d.cpp:421-449 loads)."""
    os.makedirs(dir_path, exist_ok=True)
    torch.save(torch.from_numpy(np.asarray(seg.masks, np.uint8)),
               os.path.join(dir_path, f"seg_label_{seq}.pt"))
    torch.save(torch.from_numpy(np.asarray(seg.scores, np.float32)),
               os.path.join(dir_path, f"cate_score_{seq}.pt"))
    torch.save(torch.from_numpy(np.asarray(seg.labels, np.int64)),
               os.path.join(dir_path, f"cate_label_{seq}.pt"))


def write_fcos3d_txt(path: str, boxes: List[Box3D]) -> None:
    """Per-frame `class score cx cy cz dx dy dz yaw` lines
    (the format read_fcos3d_txt / detector3d.cpp:64 parses)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for b in boxes:
            cid = _KITTI_TO_NUSCENES.get(b.class_name, 8)
            c, d = b.bottom_center, b.dims
            f.write(f"{cid} {b.score:.4f} {c[0]:.4f} {c[1]:.4f} "
                    f"{c[2]:.4f} {d[0]:.4f} {d[1]:.4f} {d[2]:.4f} "
                    f"{b.yaw:.4f}\n")


def write_disparity_png(path: str, disp: np.ndarray) -> None:
    """uint16 PNG with disp*256 (the LEAStereo convention
    read_disparity_png / stereo.cpp:32-44 expects)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    q = np.clip(np.asarray(disp, np.float32) * 256.0, 0, 65535)
    image_io.imwrite(path, q.astype(np.uint16))
