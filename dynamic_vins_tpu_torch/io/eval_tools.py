"""Evaluation tooling — parity with the `dynamic_vins_eval` package (a
copy of the JAX package's numpy-only module).

Reference binaries rebuilt as library functions + one CLI
(`python -m dynamic_vins_tpu_torch.io.eval_tools <cmd> ...`):
  * `save_oxts_tum`      — OXTS GPS/IMU logs -> TUM ego ground truth
                           (dynamic_vins_eval/src save_oxts; mercator
                           conversion per the KITTI devkit).
  * `split_mot_to_single`— per-object KITTI-format files out of one
                           MOT result (split_mot_to_single).
  * `split_mot_to_tum`   — per-object TUM trajectories
                           (split_mot_to_tum).
  * `convert_tracking_to_object` — tracking-format -> per-frame KITTI
                           object-detection files.
  * `clear_mot`          — CLEAR-MOT metrics (MOTA/MOTP/IDS/FP/FN),
                           the devkit_tracking
                           evaluate_tracking.py measures, computed
                           in-repo so no external devkit is needed.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

EARTH_RADIUS = 6378137.0


def oxts_to_pose(lat, lon, alt, roll, pitch, yaw, scale=None):
    """One OXTS record -> (p[3], R[3,3]) world pose, KITTI devkit
    mercator projection (convertOxtsToPose.m semantics)."""
    if scale is None:
        scale = math.cos(lat * math.pi / 180.0)
    tx = scale * lon * math.pi * EARTH_RADIUS / 180.0
    ty = scale * EARTH_RADIUS * math.log(
        math.tan((90.0 + lat) * math.pi / 360.0))
    tz = alt
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return np.array([tx, ty, tz]), Rz @ Ry @ Rx


def read_oxts_dir(oxts_dir: str, timestamps=None):
    """KITTI raw `oxts/data/*.txt` -> list of (t, p, R), first pose as
    origin (save_oxts parity)."""
    files = sorted(f for f in os.listdir(oxts_dir)
                   if f.endswith(".txt"))
    out = []
    scale = None
    origin = None
    for i, fname in enumerate(files):
        vals = np.loadtxt(os.path.join(oxts_dir, fname))
        lat, lon, alt, roll, pitch, yaw = vals[:6]
        if scale is None:
            scale = math.cos(lat * math.pi / 180.0)
        p, R = oxts_to_pose(lat, lon, alt, roll, pitch, yaw, scale)
        if origin is None:
            origin = (p.copy(), R.copy())
        p0, R0 = origin
        p_rel = R0.T @ (p - p0)
        R_rel = R0.T @ R
        t = timestamps[i] if timestamps is not None else float(i)
        out.append((t, p_rel, R_rel))
    return out


def _quat_from_matrix(R):
    from dynamic_vins_tpu_torch.geometry import lie_np

    return lie_np.matrix_to_quat(R)


def save_oxts_tum(oxts_dir: str, out_path: str, timestamps=None):
    poses = read_oxts_dir(oxts_dir, timestamps)
    with open(out_path, "w") as f:
        for t, p, R in poses:
            q = _quat_from_matrix(R)            # wxyz
            f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")
    return len(poses)


# ---------------------------------------------------------------------------
# MOT file surgery (KITTI tracking format: frame tid type trunc occ
# alpha x1 y1 x2 y2 h w l X Y Z ry [score])
# ---------------------------------------------------------------------------

def read_mot_file(path: str) -> List[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if len(tok) < 17:
                continue
            rows.append(dict(
                frame=int(tok[0]), tid=int(tok[1]), cls=tok[2],
                trunc=float(tok[3]), occ=int(float(tok[4])),
                alpha=float(tok[5]),
                bbox=[float(v) for v in tok[6:10]],
                hwl=[float(v) for v in tok[10:13]],
                xyz=[float(v) for v in tok[13:16]],
                ry=float(tok[16]),
                score=float(tok[17]) if len(tok) > 17 else 1.0,
                line=line.rstrip("\n")))
    return rows


def split_mot_to_single(mot_path: str, out_dir: str) -> List[int]:
    """One KITTI file per track id (split_mot_to_single parity)."""
    os.makedirs(out_dir, exist_ok=True)
    by_tid: Dict[int, List[str]] = {}
    for r in read_mot_file(mot_path):
        by_tid.setdefault(r["tid"], []).append(r["line"])
    for tid, lines in by_tid.items():
        with open(os.path.join(out_dir, f"{tid:04d}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return sorted(by_tid)


def split_mot_to_tum(mot_path: str, out_dir: str, fps: float = 10.0
                     ) -> List[int]:
    """Per-object TUM trajectory from the 3D box centers
    (split_mot_to_tum parity: position = box center, yaw about -y)."""
    os.makedirs(out_dir, exist_ok=True)
    by_tid: Dict[int, List[dict]] = {}
    for r in read_mot_file(mot_path):
        by_tid.setdefault(r["tid"], []).append(r)
    for tid, rows in by_tid.items():
        with open(os.path.join(out_dir, f"{tid:04d}_tum.txt"),
                  "w") as f:
            for r in rows:
                t = r["frame"] / fps
                x, y, z = r["xyz"]
                y -= r["hwl"][0] / 2.0           # bottom -> center
                half, ry = 0.5 * r["ry"], r["ry"]
                # yaw about camera -y: q = (cos, 0, -sin, 0)
                qw, qy = math.cos(half), -math.sin(half)
                f.write(f"{t:.6f} {x:.6f} {y:.6f} {z:.6f} "
                        f"0.000000 {qy:.6f} 0.000000 {qw:.6f}\n")
    return sorted(by_tid)


def convert_tracking_to_object(mot_path: str, out_dir: str) -> int:
    """Tracking-format file -> per-frame KITTI object files
    (convert_tracking_to_object parity: drop frame/tid columns)."""
    os.makedirs(out_dir, exist_ok=True)
    by_frame: Dict[int, List[str]] = {}
    for r in read_mot_file(mot_path):
        tok = r["line"].split()
        by_frame.setdefault(r["frame"], []).append(" ".join(tok[2:]))
    n = max(by_frame) + 1 if by_frame else 0
    for frame in range(n):
        with open(os.path.join(out_dir, f"{frame:06d}.txt"),
                  "w") as f:
            f.write("\n".join(by_frame.get(frame, [])) + "\n")
    return n


# ---------------------------------------------------------------------------
# CLEAR-MOT (devkit_tracking/python/evaluate_tracking.py measures)
# ---------------------------------------------------------------------------

@dataclass
class MotMetrics:
    mota: float
    motp: float
    id_switches: int
    fp: int
    fn: int
    matches: int
    gt_total: int

    def as_dict(self):
        return self.__dict__.copy()


def _iou2d(a, b):
    x1 = max(a[0], b[0])
    y1 = max(a[1], b[1])
    x2 = min(a[2], b[2])
    y2 = min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    area = ((a[2] - a[0]) * (a[3] - a[1])
            + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / area if area > 0 else 0.0


def clear_mot(gt_rows: List[dict], est_rows: List[dict],
              iou_thresh: float = 0.5, use_3d: bool = False,
              dist_thresh: float = 2.0) -> MotMetrics:
    """CLEAR-MOT over parsed MOT rows. Association per frame by
    Hungarian on 2D IoU (devkit behavior) or, with `use_3d`, on 3D
    bottom-center distance (for box-less pipelines).
    """
    from scipy.optimize import linear_sum_assignment

    frames = sorted({r["frame"] for r in gt_rows}
                    | {r["frame"] for r in est_rows})
    gt_by_f: Dict[int, List[dict]] = {}
    est_by_f: Dict[int, List[dict]] = {}
    for r in gt_rows:
        if r["cls"] != "DontCare":
            gt_by_f.setdefault(r["frame"], []).append(r)
    for r in est_rows:
        est_by_f.setdefault(r["frame"], []).append(r)

    fp = fn = ids = matches = gt_total = 0
    dist_sum = 0.0
    last_match: Dict[int, int] = {}              # gt tid -> est tid
    for f in frames:
        g = gt_by_f.get(f, [])
        e = est_by_f.get(f, [])
        gt_total += len(g)
        if not g or not e:
            fn += len(g)
            fp += len(e)
            continue
        C = np.full((len(g), len(e)), 1e6)
        for i, gr in enumerate(g):
            for j, er in enumerate(e):
                if use_3d:
                    d = float(np.linalg.norm(
                        np.array(gr["xyz"]) - np.array(er["xyz"])))
                    if d <= dist_thresh:
                        C[i, j] = d
                else:
                    iou = _iou2d(gr["bbox"], er["bbox"])
                    if iou >= iou_thresh:
                        C[i, j] = 1.0 - iou
        ri, ci = linear_sum_assignment(C)
        used_g, used_e = set(), set()
        for i, j in zip(ri, ci):
            if C[i, j] >= 1e6:
                continue
            used_g.add(i)
            used_e.add(j)
            matches += 1
            dist_sum += C[i, j]
            gtid, etid = g[i]["tid"], e[j]["tid"]
            if gtid in last_match and last_match[gtid] != etid:
                ids += 1
            last_match[gtid] = etid
        fn += len(g) - len(used_g)
        fp += len(e) - len(used_e)

    mota = 1.0 - (fp + fn + ids) / max(gt_total, 1)
    motp = dist_sum / max(matches, 1)
    return MotMetrics(mota, motp, ids, fp, fn, matches, gt_total)


def evaluate_mot_files(gt_path: str, est_path: str, **kw) -> MotMetrics:
    return clear_mot(read_mot_file(gt_path), read_mot_file(est_path),
                     **kw)


# ---------------------------------------------------------------------------
# KITTI object-detection AP (devkit_object/cpp/evaluate_object.cpp
# measures: 2D / BEV / 3D AP with easy/moderate/hard difficulty bins
# and 40-recall-point interpolation)
# ---------------------------------------------------------------------------

# (min bbox height px, max occlusion, max truncation) per difficulty,
# evaluate_object.cpp MIN_HEIGHT/MAX_OCCLUSION/MAX_TRUNCATION tables
DIFFICULTY = {
    "easy": (40.0, 0, 0.15),
    "moderate": (25.0, 1, 0.30),
    "hard": (25.0, 2, 0.50),
}


def _box_bev_corners(x, z, l, w, ry):
    """4 BEV corners [4,2] of a yaw box in the camera x-z ground plane."""
    c, s = math.cos(ry), math.sin(ry)
    dx = np.array([l, l, -l, -l]) / 2.0
    dz = np.array([w, -w, -w, w]) / 2.0
    return np.stack([x + c * dx + s * dz, z - s * dx + c * dz], axis=1)


def _polygon_area(poly):
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _clip_polygon(subject, clip):
    """Sutherland–Hodgman intersection of two convex polygons."""
    out = list(subject)
    n = len(clip)
    for i in range(n):
        a, b = clip[i], clip[(i + 1) % n]
        edge = (b[0] - a[0], b[1] - a[1])
        inside = lambda p: (edge[0] * (p[1] - a[1])
                            - edge[1] * (p[0] - a[0])) <= 1e-12
        inp, out = out, []
        if not inp:
            break
        s = inp[-1]
        for p in inp:
            if inside(p):
                if not inside(s):
                    out.append(_seg_isect(s, p, a, b))
                out.append(tuple(p))
            elif inside(s):
                out.append(_seg_isect(s, p, a, b))
            s = p
    return np.array(out) if out else np.zeros((0, 2))


def _seg_isect(p1, p2, a, b):
    d1 = (p2[0] - p1[0], p2[1] - p1[1])
    d2 = (b[0] - a[0], b[1] - a[1])
    den = d1[0] * d2[1] - d1[1] * d2[0]
    t = ((a[0] - p1[0]) * d2[1] - (a[1] - p1[1]) * d2[0]) / (
        den if abs(den) > 1e-12 else 1e-12)
    return (p1[0] + t * d1[0], p1[1] + t * d1[1])


def iou_bev(ga: dict, gb: dict) -> float:
    """Rotated-rectangle IoU in the ground (bird's-eye) plane."""
    ha, wa, la = ga["hwl"]
    hb, wb, lb = gb["hwl"]
    pa = _box_bev_corners(ga["xyz"][0], ga["xyz"][2], la, wa, ga["ry"])
    pb = _box_bev_corners(gb["xyz"][0], gb["xyz"][2], lb, wb, gb["ry"])
    inter_poly = _clip_polygon(pa, pb)
    if inter_poly.shape[0] < 3:
        return 0.0
    inter = _polygon_area(inter_poly)
    union = la * wa + lb * wb - inter
    return inter / union if union > 0 else 0.0


def iou_3d(ga: dict, gb: dict) -> float:
    """3D IoU: BEV intersection x vertical overlap (KITTI convention:
    y is down, xyz is the bottom center)."""
    ha, wa, la = ga["hwl"]
    hb, wb, lb = gb["hwl"]
    pa = _box_bev_corners(ga["xyz"][0], ga["xyz"][2], la, wa, ga["ry"])
    pb = _box_bev_corners(gb["xyz"][0], gb["xyz"][2], lb, wb, gb["ry"])
    inter_poly = _clip_polygon(pa, pb)
    if inter_poly.shape[0] < 3:
        return 0.0
    inter_bev = _polygon_area(inter_poly)
    ya1, ya0 = ga["xyz"][1], ga["xyz"][1] - ha
    yb1, yb0 = gb["xyz"][1], gb["xyz"][1] - hb
    h_ov = max(0.0, min(ya1, yb1) - max(ya0, yb0))
    inter = inter_bev * h_ov
    union = la * wa * ha + lb * wb * hb - inter
    return inter / union if union > 0 else 0.0


@dataclass
class DetMetrics:
    ap: float                 # 40-point interpolated AP
    precision: List[float]    # at the 40 recall samples
    recall_points: List[float]
    n_gt: int
    n_det: int


def eval_object_detection(gt_rows: List[dict], est_rows: List[dict],
                          cls: str = "Car", metric: str = "2d",
                          difficulty: str = "moderate",
                          iou_thresh: float = 0.7,
                          n_recall: int = 40) -> DetMetrics:
    """KITTI object AP (devkit_object evaluate_object.cpp semantics):
    per-frame greedy score-ordered matching at `iou_thresh`, gt boxes
    outside the difficulty bin are "ignored" (neither tp nor fn),
    AP = mean precision over `n_recall` equally spaced recall points.
    metric: '2d' (image bbox IoU) | 'bev' | '3d'.
    """
    min_h, max_occ, max_trunc = DIFFICULTY[difficulty]
    iou_fn = {"2d": lambda a, b: _iou2d(a["bbox"], b["bbox"]),
              "bev": iou_bev, "3d": iou_3d}[metric]

    gt_by_f: Dict[int, List[dict]] = {}
    for r in gt_rows:
        if r["cls"] == cls or r["cls"] == "DontCare":
            gt_by_f.setdefault(r["frame"], []).append(r)
    dets = sorted((r for r in est_rows if r["cls"] == cls),
                  key=lambda r: -r["score"])

    def bin_of(g):
        """0 = counted, 1 = ignored (wrong difficulty / DontCare)."""
        if g["cls"] == "DontCare":
            return 1
        h = g["bbox"][3] - g["bbox"][1]
        if h < min_h or g["occ"] > max_occ or g["trunc"] > max_trunc:
            return 1
        return 0

    n_gt = sum(1 for rows in gt_by_f.values() for g in rows
               if bin_of(g) == 0)
    matched: Dict[int, set] = {}
    tp_flags, ignore_flags = [], []
    for det in dets:
        f = det["frame"]
        cands = gt_by_f.get(f, [])
        used = matched.setdefault(f, set())
        best, best_iou = -1, iou_thresh
        for i, g in enumerate(cands):
            if i in used:
                continue
            iou = iou_fn(g, det)
            if iou >= best_iou:
                best, best_iou = i, iou
        if best >= 0:
            used.add(best)
            ign = bin_of(cands[best]) == 1
            tp_flags.append(not ign)
            ignore_flags.append(ign)
        else:
            tp_flags.append(False)
            ignore_flags.append(False)

    tp_flags = np.array(tp_flags, bool)
    ignore_flags = np.array(ignore_flags, bool)
    keep = ~ignore_flags                     # ignored matches drop out
    tp = np.cumsum(tp_flags[keep].astype(int))
    fp = np.cumsum((~tp_flags[keep]).astype(int))
    recall = tp / max(n_gt, 1)
    precision = tp / np.maximum(tp + fp, 1)
    # monotone precision envelope, then sample n_recall points
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    r_pts = np.linspace(1.0 / n_recall, 1.0, n_recall)
    p_pts = [float(precision[recall >= r][0]) if np.any(recall >= r)
             else 0.0 for r in r_pts]
    return DetMetrics(float(np.mean(p_pts)), p_pts, list(r_pts),
                      n_gt, int(keep.sum()))


def evaluate_object_files(gt_path: str, est_path: str,
                          **kw) -> DetMetrics:
    return eval_object_detection(read_mot_file(gt_path),
                                 read_mot_file(est_path), **kw)


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="eval_tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("save_oxts")
    p.add_argument("oxts_dir")
    p.add_argument("out")
    p = sub.add_parser("split_mot_to_single")
    p.add_argument("mot")
    p.add_argument("out_dir")
    p = sub.add_parser("split_mot_to_tum")
    p.add_argument("mot")
    p.add_argument("out_dir")
    p = sub.add_parser("convert_tracking_to_object")
    p.add_argument("mot")
    p.add_argument("out_dir")
    p = sub.add_parser("eval_mot")
    p.add_argument("gt")
    p.add_argument("est")
    p.add_argument("--use-3d", action="store_true")
    p = sub.add_parser("eval_object")
    p.add_argument("gt")
    p.add_argument("est")
    p.add_argument("--cls", default="Car")
    p.add_argument("--metric", default="2d", choices=("2d", "bev", "3d"))
    p.add_argument("--difficulty", default="moderate",
                   choices=tuple(DIFFICULTY))
    p.add_argument("--iou", type=float, default=0.7)
    a = ap.parse_args(argv)
    if a.cmd == "save_oxts":
        print(save_oxts_tum(a.oxts_dir, a.out), "poses written")
    elif a.cmd == "split_mot_to_single":
        print(split_mot_to_single(a.mot, a.out_dir))
    elif a.cmd == "split_mot_to_tum":
        print(split_mot_to_tum(a.mot, a.out_dir))
    elif a.cmd == "convert_tracking_to_object":
        print(convert_tracking_to_object(a.mot, a.out_dir), "frames")
    elif a.cmd == "eval_mot":
        m = evaluate_mot_files(a.gt, a.est, use_3d=a.use_3d)
        print(json.dumps(m.as_dict()))
    elif a.cmd == "eval_object":
        m = evaluate_object_files(a.gt, a.est, cls=a.cls,
                                  metric=a.metric,
                                  difficulty=a.difficulty,
                                  iou_thresh=a.iou)
        print(json.dumps({"ap": m.ap, "n_gt": m.n_gt,
                          "n_det": m.n_det}))


if __name__ == "__main__":
    main()
