"""Line segment detection and frame-to-frame tracking (LinePoint mode).

Detection is OpenCV's LSD reproduced on the host (`frontend/lsd.py`,
the reference's choice of a CPU detector), filtered by length, gated by
the mask at the segment's centre, sorted by length and balanced
between near-horizontal and near-vertical segments. Segments are
described by the normalized intensity profile along them (16 bilinear
samples, `pyramid.bilinear_sample`) and matched greedily by
correlation (either direction) under the reference's gates: endpoint
motion below 200 px, angle difference below 0.1 rad. Matches carry ids
from frame to frame; the right image's segments are matched to the
left's the same way. Host work: the images stay on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from dynamic_vins_tpu_torch.frontend import lsd
from dynamic_vins_tpu_torch.frontend import pyramid as pyr


class LineSeg(NamedTuple):
    sx: float
    sy: float
    ex: float
    ey: float
    id: int = -1

    @property
    def angle(self):
        return np.arctan2(self.ey - self.sy, self.ex - self.sx)

    @property
    def length(self):
        return float(np.hypot(self.ex - self.sx, self.ey - self.sy))

    @property
    def center(self):
        return np.array([(self.sx + self.ex) / 2, (self.sy + self.ey) / 2])


@dataclass
class LineTrackerConfig:
    min_length: float = 30.0
    max_lines: int = 50
    match_motion: float = 200.0      # endpoint motion gate (px)
    match_angle: float = 0.1         # angle gate (rad)
    desc_thresh: float = 0.6         # correlation threshold
    band_samples: int = 16


def detect_lines(img_u8: np.ndarray, cfg: LineTrackerConfig,
                 mask: Optional[np.ndarray] = None) -> List[LineSeg]:
    """Segments of an 8-bit image longer than `cfg.min_length`, whose
    centre pixel the mask (True = allowed) keeps, longest first, at most
    `cfg.max_lines` (`_balanced_select`)."""
    segs = []
    for l in lsd.detect(img_u8):
        seg = LineSeg(float(l[0]), float(l[1]), float(l[2]), float(l[3]))
        if seg.length < cfg.min_length:
            continue
        if mask is not None:
            c = seg.center.astype(int)
            h, w = mask.shape
            if not mask[np.clip(c[1], 0, h - 1), np.clip(c[0], 0, w - 1)]:
                continue
        segs.append(seg)
    segs.sort(key=lambda s: -s.length)
    return _balanced_select(segs, cfg.max_lines)


def _balanced_select(segs: List[LineSeg], max_lines: int) -> List[LineSeg]:
    """When the budget binds, near-horizontal (|angle| < 45 deg) and
    near-vertical segments each get up to half of it, the slack going to
    the fuller class (the reference's horizontal/vertical balance)."""
    if len(segs) <= max_lines:
        return segs
    horiz, vert = [], []
    for s in segs:                       # already length-sorted
        a = abs(np.arctan2(np.sin(s.angle), np.cos(s.angle)))
        a = min(a, np.pi - a)            # fold to [0, pi/2]
        (horiz if a < np.pi / 4 else vert).append(s)
    half = max_lines // 2
    take_h = min(len(horiz), max(half, max_lines - len(vert)))
    out = horiz[:take_h] + vert[:max_lines - take_h]
    out.sort(key=lambda s: -s.length)
    return out


def _descriptors(img: torch.Tensor, segs: List[LineSeg], n_samples: int):
    """Normalized intensity profile along each segment [K, n_samples]
    (float32 numpy): the sample points in float64, the interpolation
    and the profile in the image's float32."""
    if not segs:
        return np.zeros((0, n_samples), np.float32)
    t = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float64)
    s = torch.tensor([[g.sx, g.sy] for g in segs], dtype=torch.float64)
    e = torch.tensor([[g.ex, g.ey] for g in segs], dtype=torch.float64)
    vals = pyr.bilinear_sample(img, s[:, None, :]
                               + (e - s)[:, None, :] * t[None, :, None])
    vals = vals - torch.mean(vals, dim=1, keepdim=True)
    norm = torch.linalg.vector_norm(vals, dim=1, keepdim=True)
    return (vals / torch.clamp_min(norm, 1e-6)).numpy()


def match_lines(prev: List[LineSeg], prev_desc, cur: List[LineSeg],
                cur_desc, cfg: LineTrackerConfig):
    """Greedy best-correlation matching under the geometric gates; a
    profile is scored in both directions (the detector may flip the
    endpoints). Returns [(i_prev, i_cur)]."""
    matches = []
    if not prev or not cur:
        return matches
    corr = np.maximum(cur_desc @ prev_desc.T,
                      cur_desc[:, ::-1] @ prev_desc.T)     # [C, P]
    used_prev = set()
    for ci in np.argsort(-corr.max(axis=1)):
        pi = int(np.argmax(corr[ci]))
        if pi in used_prev or corr[ci, pi] < cfg.desc_thresh:
            continue
        a = abs(np.arctan2(np.sin(cur[ci].angle - prev[pi].angle),
                           np.cos(cur[ci].angle - prev[pi].angle)))
        if min(a, np.pi - a) > cfg.match_angle:
            continue
        if np.linalg.norm(cur[ci].center - prev[pi].center) \
                > cfg.match_motion:
            continue
        matches.append((pi, ci))
        used_prev.add(pi)
    return matches


def _as_u8(img):
    """An image as LSD takes it: a non-uint8 image is truncated to uint8
    (numpy's astype), as the JAX package does."""
    img = np.asarray(img)
    return img if img.dtype == np.uint8 else img.astype(np.uint8)


class LineTracker:
    """Frame-to-frame line tracking with persistent ids."""

    def __init__(self, cfg: LineTrackerConfig = LineTrackerConfig()):
        self.cfg = cfg
        self.prev_segs: List[LineSeg] = []
        self.prev_desc = None
        self._next_id = 0

    def track(self, img: np.ndarray, mask: Optional[np.ndarray] = None,
              img_right: Optional[np.ndarray] = None):
        """(segments with ids, right matches {id: LineSeg}) of a
        grayscale image [H,W] (uint8 or float)."""
        cfg = self.cfg
        segs = detect_lines(_as_u8(img), cfg, mask)
        desc = _descriptors(torch.as_tensor(np.asarray(img, np.float32)),
                            segs, cfg.band_samples)
        ids = [-1] * len(segs)
        if self.prev_segs:
            for pi, ci in match_lines(self.prev_segs, self.prev_desc, segs,
                                      desc, cfg):
                ids[ci] = self.prev_segs[pi].id
        out = []
        for seg, i in zip(segs, ids):
            if i < 0:
                i = self._next_id
                self._next_id += 1
            out.append(seg._replace(id=i))

        right = {}
        if img_right is not None:
            segs_r = detect_lines(_as_u8(img_right), cfg)
            desc_r = _descriptors(
                torch.as_tensor(np.asarray(img_right, np.float32)), segs_r,
                cfg.band_samples)
            for li, ri in match_lines(out, desc, segs_r, desc_r, cfg):
                right[out[li].id] = segs_r[ri]
        self.prev_segs = out
        self.prev_desc = desc
        return out, right
