"""System orchestration, RAW mode, synchronous path: images (+IMU) ->
feature tracker -> sliding-window estimator -> TUM trajectory.

Built from one `VioConfig` like the JAX package's System. The NAIVE and
DYNAMIC modes, lines, online perception, loop closure, the multi-device
engine and the pipelined frontend are not ported yet and raise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

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
    "pipelined": "item 9 (pipelined steady state)",
    "use_line": "item 13 (LinePoint)",
    "det2d_online": "item 16 (perception nets)",
    "det3d_online": "item 16 (perception nets)",
    "stereo_online": "item 16 (perception nets)",
    "use_dense_flow": "item 14 (dense-flow tracking)",
    "use_reid": "item 16 (perception nets)",
    "use_loop_closure": "item 17 (loop closure)",
}


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

        # obs capacity sized to the config: kMaxCnt x window x stereo
        obs_cap = 1024
        while obs_cap < cfg.max_cnt * cfg.num_frames * 2:
            obs_cap *= 2
        self.estimator = Estimator(
            EstimatorConfig(num_frames=cfg.num_frames,
                            obs_capacity=obs_cap, stereo=cfg.is_stereo,
                            use_imu=cfg.use_imu,
                            max_iters=cfg.max_solver_iterations,
                            estimate_extrinsic=cfg.estimate_extrinsic,
                            estimate_td=cfg.estimate_td,
                            use_plane_constraint=cfg.use_plane_constraint,
                            dtype=dtype),
            p_bc, q_bc, device=self.device)

        os.makedirs(os.path.dirname(output_prefix) or ".", exist_ok=True)
        self.tum_writer = TumWriter(output_prefix + "_ego_tum.txt")
        self.frame_idx = 0

    def process(self, fi: FrameInput):
        """Track one frame, run the backend, write its pose."""
        t = self.timer
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

    def reset_timers(self):
        """Fresh StageTimer shared by System + tracker (steady-state
        stage means)."""
        self.timer = StageTimer()
        self.tracker.timer = self.timer
        return self.timer

    def close(self):
        """Flush, close the trajectory file, return the stage means."""
        for out in self.estimator.flush():
            self.tum_writer.write(out.timestamp, out.p, out.q)
        self.tum_writer.close()
        return self.timer.summary()
