"""The frontend's feature stream, recorded and replayed.

The counterpart of the reference's `utils/io/feature_serialization.
{h,cpp}` and its replay hook (`system/main.cpp:287-295`): every
`FrameFeatures` the frontend emits (with the frame's IMU interval) goes
to a file, and the backend re-runs from it without images. One JSON line
a frame, with the keys `t`, `features`, then `lines` and `imu` where the
frame has them; the JAX package writes the same lines, so a file that
one package records replays in the other.
"""

from __future__ import annotations

import json
from typing import Iterator

import numpy as np

from dynamic_vins_tpu_torch.estimator.estimator import FrameFeatures


def _arr(x):
    return None if x is None else np.asarray(x).tolist()


def _opt(x):
    return None if x is None else np.asarray(x)


def serialize_frame(frame: FrameFeatures, imu=None) -> str:
    """One frame (and its IMU interval (acc, gyr, dts)) as a JSON line,
    without the newline."""
    feats = {str(fid): [_arr(pl), _arr(vl), _arr(pr), _arr(vr)]
             for fid, (pl, vl, pr, vr) in frame.features.items()}
    rec = {"t": frame.timestamp, "features": feats}
    if frame.lines:
        rec["lines"] = {str(lid): [_arr(s), _arr(e), _arr(sr), _arr(er)]
                        for lid, (s, e, sr, er) in frame.lines.items()}
    if imu is not None:
        acc, gyr, dts = imu
        rec["imu"] = [_arr(acc), _arr(gyr), _arr(dts)]
    return json.dumps(rec)


def deserialize_frame(line: str):
    """A JSON line -> (FrameFeatures, imu interval or None)."""
    rec = json.loads(line)
    feats = {int(fid): (np.asarray(pl), np.asarray(vl), _opt(pr), _opt(vr))
             for fid, (pl, vl, pr, vr) in rec["features"].items()}
    lines = None
    if "lines" in rec:
        lines = {int(lid): (np.asarray(s), np.asarray(e), _opt(sr), _opt(er))
                 for lid, (s, e, sr, er) in rec["lines"].items()}
    imu = None
    if "imu" in rec:
        imu = tuple(np.asarray(a) for a in rec["imu"])
    return FrameFeatures(rec["t"], feats, lines), imu


class FeatureRecorder:
    """Writes one line a recorded frame; a context manager."""

    def __init__(self, path: str):
        self._f = open(path, "w")

    def record(self, frame: FrameFeatures, imu=None):
        self._f.write(serialize_frame(frame, imu) + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def replay(path: str) -> Iterator:
    """Yield (FrameFeatures, imu interval) from a recorded stream."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield deserialize_frame(line)
