"""System orchestration, RAW mode: images (+IMU) -> feature tracker ->
sliding-window estimator -> TUM trajectory.

Built from one `VioConfig` like the JAX package's System. With
`VioConfig.pipelined` the frontend runs two frames ahead of the backend
(each frame's tracker step is dispatched before the oldest one is
collected) and the estimator keeps its steady state on the device, so
`process` returns the output of an earlier frame, or None; `close`
drains every frame in flight. The NAIVE and DYNAMIC modes, lines,
online perception, loop closure and the multi-device engine are not
ported yet and raise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from dynamic_vins_tpu_torch.estimator.estimator import (Estimator,
                                                        EstimatorConfig)
from dynamic_vins_tpu_torch.frontend.tracker import (FeatureTracker,
                                                     TrackerConfig)
from dynamic_vins_tpu_torch.geometry.camera import PinholeIntrinsics
from dynamic_vins_tpu_torch.io.writers import TumWriter
from dynamic_vins_tpu_torch.utils.config import SlamMode, VioConfig
from dynamic_vins_tpu_torch.utils.precision import resolve_device
from dynamic_vins_tpu_torch.utils.timing import StageTimer

# VioConfig switches of paths not ported yet -> ROADMAP.md queue-1 item
_TODO = {
    "use_line": "item 13 (LinePoint)",
    "det2d_online": "item 16 (perception nets)",
    "det3d_online": "item 16 (perception nets)",
    "stereo_online": "item 16 (perception nets)",
    "use_dense_flow": "item 14 (dense-flow tracking)",
    "use_reid": "item 16 (perception nets)",
    "use_loop_closure": "item 17 (loop closure)",
}


def obs_capacity(cfg: VioConfig) -> int:
    """The estimator's obs rows for a config: kMaxCnt x window x stereo,
    rounded up to a power of two (at least 1024); the step graphs are
    captured at this size."""
    cap = 1024
    while cap < cfg.max_cnt * cfg.num_frames * 2:
        cap *= 2
    return cap


@dataclass
class FrameInput:
    """What the RAW system consumes for one frame."""

    timestamp: float
    img_left: np.ndarray
    img_right: Optional[np.ndarray] = None
    imu: Optional[tuple] = None            # (acc [M+1,3], gyr, dt [M])


class System:
    def __init__(self, cfg: VioConfig, output_prefix: str = "output/run",
                 device=None, dtype: torch.dtype = torch.float64):
        """device: CUDA unless "cpu" is asked for; dtype: the
        estimator's float type (the tracker works in float32)."""
        if cfg.slam != SlamMode.RAW:
            raise NotImplementedError(
                f"slam={cfg.slam.value} is not ported yet: ROADMAP queue "
                "1 items 11 (NAIVE) and 15 (DYNAMIC)")
        for name, item in _TODO.items():
            if getattr(cfg, name):
                raise NotImplementedError(
                    f"VioConfig.{name} is not ported yet: ROADMAP queue "
                    f"1 {item}")
        if cfg.devices and cfg.devices > 1:
            raise NotImplementedError(
                "devices > 1 is not ported yet: ROADMAP queue 1 item 18")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.timer = StageTimer()

        intr_vals = cfg.intrinsics_left or [460.0, 460.0,
                                            cfg.image_width / 2,
                                            cfg.image_height / 2]
        intr = PinholeIntrinsics.make(*intr_vals[:4],
                                      *(intr_vals[4:8] or []))
        intr_r_vals = cfg.intrinsics_right or intr_vals
        intr_r = PinholeIntrinsics.make(*intr_r_vals[:4],
                                        *(intr_r_vals[4:8] or []))
        self.intr, self.intr_r = intr, intr_r
        p_bc, q_bc = cfg.extrinsics()

        self.tracker = FeatureTracker(
            TrackerConfig(max_cnt=cfg.max_cnt, min_dist=cfg.min_dist,
                          stereo=cfg.is_stereo), intr, intr_r,
            device=self.device)
        self.tracker.timer = self.timer

        self.estimator = Estimator(
            EstimatorConfig(num_frames=cfg.num_frames,
                            obs_capacity=obs_capacity(cfg),
                            stereo=cfg.is_stereo,
                            use_imu=cfg.use_imu, pipelined=cfg.pipelined,
                            max_iters=cfg.max_solver_iterations,
                            estimate_extrinsic=cfg.estimate_extrinsic,
                            estimate_td=cfg.estimate_td,
                            use_plane_constraint=cfg.use_plane_constraint,
                            dtype=dtype),
            p_bc, q_bc, device=self.device)
        self.estimator.timer = self.timer

        os.makedirs(os.path.dirname(output_prefix) or ".", exist_ok=True)
        self.tum_writer = TumWriter(output_prefix + "_ego_tum.txt")
        self.frame_idx = 0
        # pipelined frontend: frames dispatched to the tracker and not
        # collected yet, at most `_fe_lag` after a call to process
        self._fe_pending: List[tuple] = []
        self._fe_lag = 2

    def process(self, fi: FrameInput):
        """Track one frame, run the backend, write its pose. Pipelined:
        dispatch this frame's tracker step, then finish the oldest frame
        in flight; returns that frame's output or None."""
        t = self.timer
        if self.cfg.pipelined:
            with t.stage("frontend"):
                h = self.tracker.track_begin(fi.img_left, fi.timestamp,
                                             img_right=fi.img_right)
            out = None
            if len(self._fe_pending) >= self._fe_lag:
                out = self._finish_oldest_pending()
            self._fe_pending.append((h, fi))
            return out
        with t.stage("frontend"):
            feats = self.tracker.track(fi.img_left, fi.timestamp,
                                       img_right=fi.img_right)
        return self._finish_frame(fi, feats)

    def _finish_frame(self, fi: FrameInput, feats):
        t = self.timer
        with t.stage("backend"):
            out = self.estimator.process_frame(feats, fi.imu)
        with t.stage("output"):
            if out is not None:
                self.tum_writer.write(out.timestamp, out.p, out.q)
        self.frame_idx += 1
        return out

    def _finish_oldest_pending(self):
        """Collect + finish the oldest frame in flight."""
        h, fi = self._fe_pending.pop(0)
        with self.timer.stage("frontend"):
            feats = self.tracker.track_collect(h)
        return self._finish_frame(fi, feats)

    def drain(self):
        """Finish every frame in flight, the frontend's and then the
        pipelined estimator's; returns their outputs in order (also
        written to the TUM file)."""
        outs = []
        while self._fe_pending:
            out = self._finish_oldest_pending()
            if out is not None:
                outs.append(out)
        for out in self.estimator.flush():
            self.tum_writer.write(out.timestamp, out.p, out.q)
            outs.append(out)
        return outs

    def reset_timers(self):
        """Fresh StageTimer shared by System, tracker and estimator
        (steady-state stage means)."""
        self.timer = StageTimer()
        self.tracker.timer = self.estimator.timer = self.timer
        return self.timer

    def close(self):
        """Drain, close the trajectory file, return the stage means."""
        self.drain()
        self.tum_writer.close()
        return self.timer.summary()
