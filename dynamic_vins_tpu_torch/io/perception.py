"""Perception results as the DYNAMIC and NAIVE modes consume them: the
instance segmentation of a frame, camera-frame 3D boxes, the COCO class
filters, and the mask helpers (the reference's ImageProcessor /
SemanticImage outputs). Numpy only; the offline file readers and
writers are not ported yet (ROADMAP queue 1, the CLI item).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

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
