"""Dataset readers: EuRoC ASL, KITTI raw/tracking, VIODE (extracted).

The same readers as the JAX package's (the reference's
`utils/io/dataloader.cpp` stereo-dir reader, `utils/dataset/
kitti_utils.cpp` calib parsing, `utils/dataset/viode_utils.cpp` RGB-seg
decoding), with the images decoded by `io/image_io` instead of OpenCV:
grey frames as `IMREAD_GRAYSCALE`, VIODE segmentation as
`IMREAD_COLOR` (BGR), to the byte.
"""

from __future__ import annotations

import csv
import glob
import os
from dataclasses import dataclass, field
from typing import Iterator, NamedTuple, Optional

import numpy as np

from dynamic_vins_tpu_torch.io.image_io import imread


class ImuSample(NamedTuple):
    t: float
    gyr: np.ndarray
    acc: np.ndarray


class StereoFrame(NamedTuple):
    t: float
    img_left: np.ndarray
    img_right: Optional[np.ndarray]
    seg_left: Optional[np.ndarray] = None
    seg_right: Optional[np.ndarray] = None


@dataclass
class EurocDataset:
    """EuRoC ASL layout: <root>/mav0/{cam0,cam1,imu0}/..."""

    root: str

    def imu(self):
        path = os.path.join(self.root, "mav0", "imu0", "data.csv")
        out = []
        with open(path) as f:
            for row in csv.reader(f):
                if row[0].startswith("#"):
                    continue
                t = float(row[0]) * 1e-9
                g = np.array([float(row[1]), float(row[2]),
                              float(row[3])])
                a = np.array([float(row[4]), float(row[5]),
                              float(row[6])])
                out.append(ImuSample(t, g, a))
        return out

    def _cam_index(self, cam: str):
        path = os.path.join(self.root, "mav0", cam, "data.csv")
        out = []
        with open(path) as f:
            for row in csv.reader(f):
                if row[0].startswith("#"):
                    continue
                out.append((float(row[0]) * 1e-9,
                            os.path.join(self.root, "mav0", cam, "data",
                                         row[1].strip())))
        return out

    def frames(self) -> Iterator[StereoFrame]:
        left = self._cam_index("cam0")
        right = {round(t, 6): p for t, p in self._cam_index("cam1")}
        for t, pl in left:
            pr = right.get(round(t, 6))
            il = imread(pl, "grey")
            ir = imread(pr, "grey") if pr else None
            if il is None:
                continue
            yield StereoFrame(t, il.astype(np.float32),
                              None if ir is None
                              else ir.astype(np.float32))

    def ground_truth(self):
        """state_groundtruth_estimate0 -> (t, p, q_wxyz)."""
        path = os.path.join(self.root, "mav0",
                            "state_groundtruth_estimate0", "data.csv")
        ts, ps, qs = [], [], []
        with open(path) as f:
            for row in csv.reader(f):
                if row[0].startswith("#"):
                    continue
                ts.append(float(row[0]) * 1e-9)
                ps.append([float(x) for x in row[1:4]])
                qs.append([float(x) for x in row[4:8]])  # w x y z
        return np.asarray(ts), np.asarray(ps), np.asarray(qs)


@dataclass
class KittiTrackingDataset:
    """KITTI tracking layout: image_02/<seq>/*.png, image_03/<seq>/
    (reference `Dataloader::LoadStereo` dataloader.cpp:62 reads two
    image dirs and synthesizes timestamps at a fixed period)."""

    left_dir: str
    right_dir: Optional[str] = None
    period_s: float = 0.1      # 10 Hz KITTI camera

    def frames(self) -> Iterator[StereoFrame]:
        lefts = sorted(glob.glob(os.path.join(self.left_dir, "*.png")))
        for i, pl in enumerate(lefts):
            name = os.path.basename(pl)
            il = imread(pl, "grey")
            ir = None
            if self.right_dir:
                pr = os.path.join(self.right_dir, name)
                if os.path.exists(pr):
                    ir = imread(pr, "grey")
            if il is None:
                continue
            yield StereoFrame(i * self.period_s, il.astype(np.float32),
                              None if ir is None
                              else ir.astype(np.float32))


def parse_kitti_calib(calib_path: str):
    """Parse a KITTI calib file (P0..P3 projection matrices).

    Returns dict name -> [3,4] array (kitti_utils.cpp parity)."""
    out = {}
    with open(calib_path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            vals = np.array([float(x) for x in v.split()])
            if vals.size == 12:
                out[k.strip()] = vals.reshape(3, 4)
            elif vals.size == 9:
                out[k.strip()] = vals.reshape(3, 3)
            else:
                out[k.strip()] = vals
    return out


# ---------------------------------------------------------------------------
# VIODE semantic masks
# ---------------------------------------------------------------------------

# VIODE dynamic-object segmentation colors (rgb), from the dataset's
# segmentation label table (viode_utils.cpp builds this from config)
VIODE_DYNAMIC_RGB = [
    (0, 0, 142),     # car
    (0, 0, 70),      # truck
    (0, 60, 100),    # bus
    (0, 80, 100),    # train
    (0, 0, 230),     # motorcycle
    (119, 11, 32),   # bicycle
    (220, 20, 60),   # person
    (255, 0, 0),     # rider
]


def viode_pixel_key(seg_rgb):
    """Pack an RGB seg image [H,W,3] into int keys (VIODE::PixelToKey)."""
    seg = seg_rgb.astype(np.int64)
    return (seg[..., 0] << 16) | (seg[..., 1] << 8) | seg[..., 2]


def viode_dynamic_mask(seg_rgb, dynamic_rgb=None):
    """True where the pixel belongs to a (potentially) dynamic class
    (`VIODE::SetViodeMaskSimple` viode_utils.cpp:21-70)."""
    table = dynamic_rgb if dynamic_rgb is not None else VIODE_DYNAMIC_RGB
    keys = viode_pixel_key(seg_rgb)
    dyn_keys = {(r << 16) | (g << 8) | b for r, g, b in table}
    mask = np.zeros(keys.shape, bool)
    for k in dyn_keys:
        mask |= keys == k
    return mask


def viode_instance_masks(seg_rgb, dynamic_rgb=None, min_area: int = 100):
    """Per-instance masks keyed by color (VIODE gives one color per
    instance): returns {key: mask} for dynamic pixels."""
    dyn = viode_dynamic_mask(seg_rgb, dynamic_rgb)
    keys = viode_pixel_key(seg_rgb)
    out = {}
    for k in np.unique(keys[dyn]):
        m = keys == k
        if m.sum() >= min_area:
            out[int(k)] = m
    return out


@dataclass
class ViodeDataset:
    """VIODE (extracted-from-rosbag layout): `<root>/{cam0,cam1}/data/
    *.png`, RGB segmentation in `<root>/segmentation/data/*.png` (or
    seg0), IMU in `<root>/imu0/data.csv` (EuRoC csv schema). The
    reference consumes the same streams as ROS topics
    (`system_call_back.cpp:18-37` img0/img1/seg0 subscriptions); here
    they are file iterators. Frame timestamps come from the
    nanosecond filenames."""

    root: str

    def _dir(self, *cands):
        for c in cands:
            for base in (self.root, os.path.join(self.root, "mav0")):
                d = os.path.join(base, c, "data")
                if os.path.isdir(d):
                    return d
        return None

    def imu(self):
        for base in (self.root, os.path.join(self.root, "mav0")):
            path = os.path.join(base, "imu0", "data.csv")
            if os.path.exists(path):
                return _read_euroc_imu(path)
        return []

    def frames(self) -> Iterator[StereoFrame]:
        ldir = self._dir("cam0")
        rdir = self._dir("cam1")
        sdir = self._dir("segmentation", "seg0")
        if ldir is None:
            return
        for pl in sorted(glob.glob(os.path.join(ldir, "*.png"))):
            name = os.path.basename(pl)
            try:
                t = float(os.path.splitext(name)[0]) * 1e-9
            except ValueError:
                t = None
            il = imread(pl, "grey")
            if il is None:
                continue
            ir = seg = None
            if rdir:
                pr = os.path.join(rdir, name)
                if os.path.exists(pr):
                    ir = imread(pr, "grey")
            if sdir:
                ps = os.path.join(sdir, name)
                if os.path.exists(ps):
                    bgr = imread(ps, "bgr")
                    if bgr is not None:
                        seg = bgr[..., ::-1]       # -> RGB
            yield StereoFrame(
                t if t is not None else 0.0, il.astype(np.float32),
                None if ir is None else ir.astype(np.float32),
                seg_left=seg)

    def ground_truth(self):
        """odometry/data.csv (VIODE ships GT odometry in the bags;
        viode_generate_odometry parity) -> [(t, p[3], q_wxyz[4])]."""
        for base in (self.root, os.path.join(self.root, "mav0")):
            for name in ("odometry", "state_groundtruth_estimate0"):
                path = os.path.join(base, name, "data.csv")
                if not os.path.exists(path):
                    continue
                out = []
                with open(path) as f:
                    for row in csv.reader(f):
                        if not row or row[0].startswith("#"):
                            continue
                        vals = [float(v) for v in row]
                        out.append((vals[0] * 1e-9,
                                    np.array(vals[1:4]),
                                    np.array(vals[4:8])))
                return out
        return []


def _read_euroc_imu(path: str):
    out = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            t = float(row[0]) * 1e-9
            g = np.array([float(row[1]), float(row[2]), float(row[3])])
            a = np.array([float(row[4]), float(row[5]), float(row[6])])
            out.append(ImuSample(t, g, a))
    return out


@dataclass
class KittiRawDataset:
    """KITTI *raw* layout (kitti_pub package parity: publishes raw
    images + OXTS as topics, `kitti_pub/src/*`): drive_dir contains
    image_00..03/data/*.png, oxts/data/*.txt, and per-sensor
    timestamps.txt. Here the same data becomes an iterator + ground
    truth accessor (ROS replaced by file IO, SURVEY.md §7)."""

    drive_dir: str
    left_cam: str = "image_00"
    right_cam: str = "image_01"

    def _timestamps(self, sensor: str):
        path = os.path.join(self.drive_dir, sensor, "timestamps.txt")
        if not os.path.exists(path):
            return None
        out = []
        import datetime
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                # 2011-09-26 13:02:25.594360375 (ns precision)
                d, t = line.split()
                hh, mm, ss = t.split(":")
                out.append(int(hh) * 3600 + int(mm) * 60 + float(ss))
        return np.asarray(out)

    def frames(self) -> Iterator[StereoFrame]:
        ldir = os.path.join(self.drive_dir, self.left_cam, "data")
        rdir = os.path.join(self.drive_dir, self.right_cam, "data")
        ts = self._timestamps(self.left_cam)
        lefts = sorted(glob.glob(os.path.join(ldir, "*.png")))
        for i, pl in enumerate(lefts):
            il = imread(pl, "grey")
            if il is None:
                continue
            pr = os.path.join(rdir, os.path.basename(pl))
            ir = imread(pr, "grey") \
                if os.path.exists(pr) else None
            t = float(ts[i]) if ts is not None and i < len(ts) \
                else i * 0.1
            yield StereoFrame(t, il.astype(np.float32),
                              None if ir is None
                              else ir.astype(np.float32))

    def oxts_ground_truth(self, out_tum: str = None):
        """OXTS -> (t, p, R) list; optionally write TUM ground truth
        (save_oxts parity, via io.eval_tools)."""
        from dynamic_vins_tpu_torch.io import eval_tools

        ts = self._timestamps("oxts")
        poses = eval_tools.read_oxts_dir(
            os.path.join(self.drive_dir, "oxts", "data"), ts)
        if out_tum:
            eval_tools.save_oxts_tum(
                os.path.join(self.drive_dir, "oxts", "data"), out_tum,
                ts)
        return poses
