"""Trajectory and object output: TUM format (`timestamp tx ty tz qx qy qz
qw`, the reference's SaveBodyTrajectory) for the ego trajectory, so
evo-style tools apply, and the KITTI-tracking format for the objects
(SaveMotTrajectory), so the KITTI devkit applies."""

from __future__ import annotations

import os
from typing import IO, Optional

import numpy as np


class TumWriter:
    """One line per pose; quaternions arrive wxyz, are written xyzw."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f: IO = open(path, "w")

    def write(self, timestamp: float, p, q_wxyz):
        p = np.asarray(p)
        q = np.asarray(q_wxyz)
        self._f.write(
            f"{timestamp:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
            f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class KittiMotWriter:
    """KITTI tracking format (one file per sequence):

    frame track_id type truncated occluded alpha x1 y1 x2 y2 h w l X Y Z
    rotation_y [score]
    (SaveMotTrajectory output.cpp:470-561, so the KITTI devkit's
    evaluate_tracking.py reads it unchanged).
    """

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f: IO = open(path, "w")

    def write(self, frame: int, track_id: int, obj_type: str,
              bbox2d, dims_hwl, center_xyz, rotation_y: float,
              score: Optional[float] = None, alpha: float = 0.0,
              truncated: float = 0.0, occluded: int = 0):
        x1, y1, x2, y2 = [float(v) for v in bbox2d]
        h, w, l = [float(v) for v in dims_hwl]
        X, Y, Z = [float(v) for v in center_xyz]
        line = (f"{frame} {track_id} {obj_type} {truncated:.2f} "
                f"{occluded} {alpha:.6f} {x1:.2f} {y1:.2f} {x2:.2f} "
                f"{y2:.2f} {h:.6f} {w:.6f} {l:.6f} {X:.6f} {Y:.6f} "
                f"{Z:.6f} {rotation_y:.6f}")
        if score is not None:
            line += f" {score:.6f}"
        self._f.write(line + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_mot(path: str):
    """Read a KITTI-tracking file -> list of dict(frame, tid, cls, bbox
    [4], hwl [3], xyz [3], ry)."""
    rows = []
    with open(path) as f:
        for line in f:
            v = line.split()
            if len(v) < 17:
                continue
            rows.append(dict(frame=int(v[0]), tid=int(v[1]), cls=v[2],
                             bbox=[float(x) for x in v[6:10]],
                             hwl=[float(x) for x in v[10:13]],
                             xyz=[float(x) for x in v[13:16]],
                             ry=float(v[16])))
    return rows


def read_tum(path: str):
    """Read a TUM trajectory -> (t [N], p [N,3], q_wxyz [N,4])."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None, :]
    q_xyzw = data[:, 4:8]
    return data[:, 0], data[:, 1:4], np.concatenate(
        [q_xyzw[:, 3:4], q_xyzw[:, 0:3]], axis=1)
