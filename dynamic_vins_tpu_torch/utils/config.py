"""Run configuration, mirroring the reference's YAML schema.

Same fields and key names as the JAX package's `VioConfig`, so one
config file drives either package. `from_yaml` reads the files with a
parser of its own (`parse_flat_yaml`), so the port needs no `yaml`
package: a config is a flat mapping of scalars and lists.
"""

from __future__ import annotations

import ast
import enum
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np

# YAML 1.1 implicit scalar types, as yaml.safe_load resolves them
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE",
                          "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE",
                          "off", "Off", "OFF"), False)}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0b[01_]+|0[0-7_]+|0x[0-9a-fA-F_]+|0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?")
_INF_NAN = {**dict.fromkeys(("+.inf", ".inf", "+.Inf", ".Inf", "+.INF",
                             ".INF"), float("inf")),
            **dict.fromkeys(("-.inf", "-.Inf", "-.INF"), float("-inf")),
            **dict.fromkeys((".nan", ".NaN", ".NAN"), float("nan"))}
_SEXAGESIMAL = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?")


def _yaml_scalar(tok: str, where: str):
    """One scalar token as yaml.safe_load types it."""
    if tok[:1] in ("'", '"'):
        q = tok[0]
        if len(tok) < 2 or tok[-1] != q:
            raise ValueError(f"{where}: unterminated quoted string {tok!r}")
        body = tok[1:-1]
        if q == "'":
            return body.replace("''", "'")
        return ast.literal_eval('"' + body + '"')
    if tok[:1] in ("&", "*", "!", "|", ">", "{", "[", "%", "@", "`"):
        raise ValueError(f"{where}: {tok!r} is not a plain scalar (anchors,"
                         " tags, block strings and nesting are not read)")
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if tok in _INF_NAN:
        return _INF_NAN[tok]
    if _SEXAGESIMAL.fullmatch(tok):
        raise ValueError(f"{where}: base-60 number {tok!r} is not read")
    if _INT.fullmatch(tok):
        t = tok.replace("_", "")
        sign, t = (-1, t[1:]) if t[0] == "-" else (1, t.lstrip("+"))
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.fullmatch(tok) and any(c.isdigit() for c in tok):
        return float(tok.replace("_", ""))
    if ": " in tok or tok.endswith(":"):
        raise ValueError(f"{where}: nested mapping {tok!r} is not read")
    return tok


def _strip_comment(line: str) -> str:
    """The line without a trailing comment (a '#' at the start or after
    whitespace, outside quotes)."""
    q = None
    for i, c in enumerate(line):
        if q:
            if c == q:
                q = None
        elif c in ("'", '"'):
            q = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_flow(body: str, where: str):
    """The items of a flow list's inside ('1.0, 2, "a"')."""
    items, cur, q = [], "", None
    for c in body:
        if q:
            cur += c
            if c == q:
                q = None
        elif c in ("'", '"'):
            q = c
            cur += c
        elif c in "[]{}":
            raise ValueError(f"{where}: nested collections are not read")
        elif c == ",":
            items.append(cur.strip())
            cur = ""
        else:
            cur += c
    if q:
        raise ValueError(f"{where}: unterminated quoted string")
    if cur.strip():
        items.append(cur.strip())
    elif items:
        raise ValueError(f"{where}: empty item in a flow list")
    return [_yaml_scalar(t, where) for t in items]


def parse_flat_yaml(text: str, name: str = "<config>") -> dict:
    """A flat YAML mapping of scalars and lists of scalars, typed as
    `yaml.safe_load` types it: block (`- 1.0`) and flow (`[1.0, 2]`)
    lists, comments, quoted strings, ints, floats, bools and null.
    Anything else raises ValueError naming the line."""
    out: dict = {}
    lines = [_strip_comment(l).rstrip() for l in text.splitlines()]
    block = None               # the key whose block list is being read
    i = 0
    while i < len(lines):
        where, line = f"{name}:{i + 1}", lines[i]
        i += 1
        if not line.strip() or (not out and line == "---"):
            continue
        item = line.lstrip()
        if item == "-" or item.startswith("- "):
            if block is None:
                raise ValueError(f"{where}: list item outside a block list")
            out[block].append(_yaml_scalar(item[1:].strip(), where))
            continue
        if line[0] in " \t":
            raise ValueError(f"{where}: indented line (nested mappings are "
                             "not read)")
        m = re.match(r"""('[^']*'|"[^"]*"|[^:'"][^:]*?)\s*:(?:\s+(.*))?$""",
                     line)
        if not m:
            raise ValueError(f"{where}: not a 'key: value' line: {line!r}")
        key = _yaml_scalar(m.group(1), where)
        value = (m.group(2) or "").strip()
        block = None
        if value.startswith("["):
            while "]" not in value and i < len(lines):  # multi-line flow
                value += " " + lines[i].strip()
                i += 1
            if not value.endswith("]"):
                raise ValueError(f"{where}: malformed flow list {value!r}")
            out[key] = _split_flow(value[1:-1], where)
        elif value:
            out[key] = _yaml_scalar(value, where)
        else:
            # a block list follows, or the value is null
            nxt = next((l for l in lines[i:] if l.strip()), "")
            if nxt.lstrip().startswith("-"):
                out[key], block = [], key
            else:
                out[key] = None
    return out


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
        with open(path) as f:
            raw = parse_flat_yaml(f.read(), str(path))
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
