"""Trajectory output: TUM format (`timestamp tx ty tz qx qy qz qw`), the
reference's SaveBodyTrajectory format, so evo-style tools apply."""

from __future__ import annotations

import os
from typing import IO

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


def read_tum(path: str):
    """Read a TUM trajectory -> (t [N], p [N,3], q_wxyz [N,4])."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None, :]
    q_xyzw = data[:, 4:8]
    return data[:, 0], data[:, 1:4], np.concatenate(
        [q_xyzw[:, 3:4], q_xyzw[:, 0:3]], axis=1)
