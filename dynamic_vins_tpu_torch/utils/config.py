"""Run configuration, mirroring the reference's YAML schema.

Same fields and key names as the JAX package's `VioConfig`, so one
config file drives either package. `yaml` is imported only inside
`from_yaml`: the card's machine has none, and nothing else needs it.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import numpy as np


class SlamMode(enum.Enum):
    RAW = "raw"          # classic static VIO
    NAIVE = "naive"      # mask-gated dynamic rejection
    DYNAMIC = "dynamic"  # full per-object estimation


class DatasetType(enum.Enum):
    KITTI = "kitti"
    VIODE = "viode"
    EUROC = "euroc"
    CUSTOM = "custom"
    SYNTHETIC = "synthetic"


@dataclass
class VioConfig:
    """Full system configuration (flat, reference key names in comments)."""

    # system
    slam: SlamMode = SlamMode.RAW                  # 'slam'
    dataset: DatasetType = DatasetType.SYNTHETIC   # 'dataset'
    is_stereo: bool = True                         # 'is_stereo'
    use_imu: bool = True                           # 'imu'
    use_line: bool = False                         # 'use_line'
    line_weight: float = 1.0
    use_det3d: bool = False                        # 'use_det3d'
    use_dst: bool = False
    use_plane_constraint: bool = False             # 'use_plane'
    basic_dir: str = "output"                      # 'basic_dir'

    # frontend
    max_cnt: int = 150                             # 'max_cnt'
    max_dynamic_cnt: int = 50                      # 'max_dynamic_cnt'
    min_dist: int = 16                             # 'min_dist'
    min_dynamic_dist: int = 4                      # 'min_dynamic_dist'
    f_threshold: float = 1.0                       # 'F_threshold'

    # estimator
    window_size: int = 10                          # kWinSize
    pipelined: bool = False
    devices: int = 0
    max_solver_iterations: int = 8                 # 'max_num_iterations'
    keyframe_parallax: float = 10.0                # 'keyframe_parallax'
    focal_length: float = 460.0
    estimate_extrinsic: bool = False               # 'estimate_extrinsic'
    estimate_td: bool = False                      # 'estimate_td'
    td: float = 0.0                                # 'td'

    # IMU noise (yaml acc_n/gyr_n/acc_w/gyr_w)
    acc_n: float = 0.08
    gyr_n: float = 0.004
    acc_w: float = 4.0e-5
    gyr_w: float = 2.0e-6
    g_norm: float = 9.81                           # 'g_norm'

    # camera
    image_width: int = 752                         # 'image_width'
    image_height: int = 480
    intrinsics_left: Optional[list] = None         # fx fy cx cy k1 k2 p1 p2
    intrinsics_right: Optional[list] = None
    body_T_cam0: Optional[list] = None             # 4x4 row-major
    body_T_cam1: Optional[list] = None

    # dynamic mode
    det2d_score_thresh: float = 0.3
    mot_max_age: int = 5
    mot_n_init: int = 3
    static_inst_threshold: float = 0.5

    # online perception
    det2d_online: bool = False
    det3d_online: bool = False
    stereo_online: bool = False
    use_dense_flow: bool = False                   # 'use_dense_flow'
    use_reid: bool = False
    det2d_weights: Optional[str] = None
    det3d_weights: Optional[str] = None
    stereo_weights: Optional[str] = None
    flow_weights: Optional[str] = None
    reid_weights: Optional[str] = None

    # loop closure
    use_loop_closure: bool = False                 # 'use_loop_closure'
    loop_keyframe_stride: int = 5
    loop_live_correction: bool = True
    loop_min_gap: int = 12
    loop_prox_radius: float = 4.0

    # io
    image_dataset_period_ms: int = 100             # 'image_dataset_period'
    output_dir: str = "output"

    @classmethod
    def from_yaml(cls, path: str, seq_name: str = "") -> "VioConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        cfg = cls()
        b = lambda v: bool(int(v))
        mapping = {
            "slam": ("slam", SlamMode),
            "dataset": ("dataset", DatasetType),
            "is_stereo": ("is_stereo", bool),
            "imu": ("use_imu", b),
            "use_line": ("use_line", b),
            "line_weight": ("line_weight", float),
            "use_det3d": ("use_det3d", b),
            "use_dst": ("use_dst", b),
            "use_plane": ("use_plane_constraint", b),
            "max_cnt": ("max_cnt", int),
            "max_dynamic_cnt": ("max_dynamic_cnt", int),
            "min_dist": ("min_dist", int),
            "min_dynamic_dist": ("min_dynamic_dist", int),
            "F_threshold": ("f_threshold", float),
            "max_num_iterations": ("max_solver_iterations", int),
            "window_size": ("window_size", int),
            "mot_n_init": ("mot_n_init", int),
            "pipelined": ("pipelined", b),
            "devices": ("devices", int),
            "keyframe_parallax": ("keyframe_parallax", float),
            "estimate_extrinsic": ("estimate_extrinsic", b),
            "estimate_td": ("estimate_td", b),
            "td": ("td", float),
            "acc_n": ("acc_n", float),
            "gyr_n": ("gyr_n", float),
            "acc_w": ("acc_w", float),
            "gyr_w": ("gyr_w", float),
            "g_norm": ("g_norm", float),
            "image_width": ("image_width", int),
            "image_height": ("image_height", int),
            "image_dataset_period": ("image_dataset_period_ms", int),
            "output_dir": ("output_dir", str),
            "basic_dir": ("basic_dir", str),
            "det2d_online": ("det2d_online", b),
            "det3d_online": ("det3d_online", b),
            "stereo_online": ("stereo_online", b),
            "use_dense_flow": ("use_dense_flow", b),
            "use_reid": ("use_reid", b),
            "use_loop_closure": ("use_loop_closure", b),
            "loop_keyframe_stride": ("loop_keyframe_stride", int),
            "loop_live_correction": ("loop_live_correction", b),
            "loop_min_gap": ("loop_min_gap", int),
            "loop_prox_radius": ("loop_prox_radius", float),
        }
        for key, (attr, conv) in mapping.items():
            if key in raw and raw[key] is not None:
                setattr(cfg, attr, conv(raw[key]))
        for key in ("intrinsics_left", "intrinsics_right",
                    "body_T_cam0", "body_T_cam1"):
            if key in raw:
                setattr(cfg, key, raw[key])
        cfg.seq_name = seq_name
        return cfg

    @property
    def num_frames(self):
        return self.window_size + 1

    def extrinsics(self):
        """(p_bc [2,3], q_bc [2,4]) float64 numpy from body_T_cam."""
        import torch

        from dynamic_vins_tpu_torch.geometry import lie

        out_p, out_q = [], []
        for key in ("body_T_cam0", "body_T_cam1"):
            T = getattr(self, key)
            if T is None:
                out_p.append(np.zeros(3))
                out_q.append(np.array([1.0, 0, 0, 0]))
            else:
                T = np.asarray(T, dtype=np.float64).reshape(4, 4)
                out_p.append(T[:3, 3])
                out_q.append(lie.matrix_to_quat(
                    torch.tensor(T[:3, :3])).numpy())
        return np.stack(out_p), np.stack(out_q)
