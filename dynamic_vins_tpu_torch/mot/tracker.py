"""Multi-object tracker: Kalman prediction + IoU matching + lifecycle.

Capability parity with `DeepSORT::update` / `TrackerManager<T>::update`
(`mot/deep_sort.cpp:72`, `mot/tracker_manager.h:69`): two-stage
association (confirmed tracks first, then unconfirmed by IoU), Hungarian
assignment (scipy linear_sum_assignment replaces the vendored 383-LoC
HungarianAlgorithm), track lifecycle with n_init / max_age from config.
The ReID appearance metric of the reference is optional and off by
default (IoU-only, the reference's fallback path); an appearance
embedding hook can be plugged via `embed_fn`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
from scipy.optimize import linear_sum_assignment

from dynamic_vins_tpu_torch.mot.kalman import BoxKalman, xyah_from_tlbr


def iou(a, b):
    """IoU of two tlbr boxes."""
    x1 = max(a[0], b[0]); y1 = max(a[1], b[1])
    x2 = min(a[2], b[2]); y2 = min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    return inter / max(area_a + area_b - inter, 1e-9)


@dataclass
class Track:
    track_id: int
    kf: BoxKalman
    cls: int
    hits: int = 1
    age: int = 0
    time_since_update: int = 0
    confirmed: bool = False
    # appearance ring buffer (FeatureBundle, mot/feature_bundle.h:23:
    # the reference keeps the last `budget` ReID embeddings per track
    # and scores a detection against the whole bundle)
    features: List[np.ndarray] = field(default_factory=list)

    @property
    def feature(self):
        """Latest appearance embedding (back-compat accessor)."""
        return self.features[-1] if self.features else None

    def add_feature(self, feat, budget: int):
        self.features.append(feat)
        if len(self.features) > budget:
            del self.features[0]

    def appearance_score(self, feat) -> float:
        """Best cosine similarity over the bundle
        (FeatureMetric::distance takes the min distance)."""
        if not self.features:
            return 0.0
        return max(float(np.dot(f, feat)) for f in self.features)

    @property
    def tlbr(self):
        return self.kf.tlbr


@dataclass
class MotConfig:
    iou_gate: float = 0.3          # min IoU to accept a match
    n_init: int = 3                # confirmations to become confirmed
    max_age: int = 5               # frames to keep unmatched tracks
    appearance_weight: float = 0.5
    feature_budget: int = 10       # FeatureBundle ring size


class MultiObjectTracker:
    def __init__(self, config: MotConfig = MotConfig(),
                 embed_fn: Optional[Callable] = None):
        self.cfg = config
        self.tracks: List[Track] = []
        self._next_id = 0
        self.embed_fn = embed_fn

    def update(self, detections, classes=None, features=None,
               img=None) -> Dict[int, int]:
        """detections: [N,4] tlbr. Returns {detection_idx: track_id}.

        If an `embed_fn` was supplied and `img` is given, appearance
        features are computed here (Extractor::extract role,
        mot/extractor.cpp:31-52)."""
        cfg = self.cfg
        detections = np.asarray(detections, float).reshape(-1, 4)
        n = len(detections)
        if (features is None and self.embed_fn is not None
                and img is not None and n):
            features = self.embed_fn(img, detections)
        classes = (np.asarray(classes) if classes is not None
                   else np.zeros(n, int))

        for t in self.tracks:
            t.kf.predict()
            t.age += 1
            t.time_since_update += 1

        def cost_matrix(tracks):
            C = np.ones((len(tracks), n))
            for i, t in enumerate(tracks):
                for j in range(n):
                    if classes[j] != t.cls:
                        continue
                    v = iou(t.tlbr, detections[j])
                    if features is not None and t.features:
                        app = t.appearance_score(features[j])
                        v = ((1 - cfg.appearance_weight) * v
                             + cfg.appearance_weight * max(app, 0.0))
                    C[i, j] = 1.0 - v
            return C

        # stage 1: confirmed tracks
        assigned_dets = set()
        assigned_tracks = set()
        out = {}
        for stage_tracks in (
            [t for t in self.tracks if t.confirmed],
            [t for t in self.tracks if not t.confirmed],
        ):
            stage_tracks = [t for t in stage_tracks
                            if id(t) not in assigned_tracks]
            free_dets = [j for j in range(n) if j not in assigned_dets]
            if not stage_tracks or not free_dets:
                continue
            C = cost_matrix(stage_tracks)[:, free_dets]
            ri, ci = linear_sum_assignment(C)
            for i, jj in zip(ri, ci):
                j = free_dets[jj]
                if C[i, jj] > 1.0 - cfg.iou_gate:
                    continue
                t = stage_tracks[i]
                t.kf.update(xyah_from_tlbr(detections[j]))
                t.hits += 1
                t.time_since_update = 0
                if t.hits >= cfg.n_init:
                    t.confirmed = True
                if features is not None:
                    t.add_feature(features[j], cfg.feature_budget)
                assigned_dets.add(j)
                assigned_tracks.add(id(t))
                out[j] = t.track_id

        # new tracks for unmatched detections
        for j in range(n):
            if j in assigned_dets:
                continue
            t = Track(self._next_id, BoxKalman(
                xyah_from_tlbr(detections[j])), int(classes[j]))
            if features is not None:
                t.add_feature(features[j], cfg.feature_budget)
            self.tracks.append(t)
            out[j] = t.track_id
            self._next_id += 1

        # cull dead tracks
        self.tracks = [
            t for t in self.tracks
            if t.time_since_update <= cfg.max_age
            and (t.confirmed or t.time_since_update == 0
                 or t.hits > 1 or t.age <= 1)]
        return out

    def visible_tracks(self):
        return [t for t in self.tracks
                if t.confirmed and t.time_since_update == 0]
