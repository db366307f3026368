"""Host-side (numpy) math for the instance manager's per-object loops.

Numpy twins of `box_fit.py` and of the two-view DLT: the per-object,
per-landmark bookkeeping runs on the host, where a device op per object
would cost a launch and a synchronization each.
"""

from __future__ import annotations

import numpy as np

from dynamic_vins_tpu_torch.geometry import lie_np


def so3_exp_quat(w):
    """Axis-angle [3] -> quaternion wxyz (host twin of lie.so3_exp_quat)."""
    w = np.asarray(w, float)
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.array([1.0, 0.5 * w[0], 0.5 * w[1], 0.5 * w[2]])
    axis = w / th
    return np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * axis])


def triangulate_dlt(p_cw0, q_cw0, p_cw1, q_cw1, pt0, pt1):
    """Two-view DLT (host twin of triangulation.triangulate_dlt;
    vio_util.cpp:30-56 semantics)."""
    R0 = lie_np.quat_to_matrix(q_cw0)
    R1 = lie_np.quat_to_matrix(q_cw1)
    P0 = np.concatenate([R0, np.asarray(p_cw0)[:, None]], axis=1)
    P1 = np.concatenate([R1, np.asarray(p_cw1)[:, None]], axis=1)
    A = np.stack([
        pt0[0] * P0[2] - P0[0],
        pt0[1] * P0[2] - P0[1],
        pt1[0] * P1[2] - P1[0],
        pt1[1] * P1[2] - P1[1],
    ])
    _, _, vt = np.linalg.svd(A)
    X = vt[-1]
    pw = X[:3] / X[3]
    depth0 = R0[2] @ pw + p_cw0[2]
    return pw, depth0


def fit_box_center(pts_w, valid, q_wo, dims, num_candidates: int = 64,
                   margin: float = 1.2):
    """Host twin of box_fit.fit_box_center (same candidate scheme)."""
    R = lie_np.quat_to_matrix(np.asarray(q_wo, float))
    pts_obj = np.asarray(pts_w, float) @ R
    half = margin * np.asarray(dims, float) / 2.0
    n = len(pts_w)
    idx = np.linspace(0, n - 1, num_candidates).astype(np.int32)
    cand = pts_obj[idx]
    cand_ok = np.asarray(valid)[idx]
    d = np.abs(pts_obj[None, :, :] - cand[:, None, :])
    inside = np.all(d <= half[None, None, :], axis=-1) \
        & np.asarray(valid)[None, :]
    counts = inside.sum(-1) * cand_ok
    best = int(np.argmax(counts))
    mask = inside[best]
    cnt = max(int(mask.sum()), 1)
    center_obj = pts_obj[mask].sum(0) / cnt if mask.any() \
        else np.zeros(3)
    return R @ center_obj, counts[best], mask


def centroid(pts_w, valid):
    n = max(int(np.sum(valid)), 1)
    return np.asarray(pts_w, float)[np.asarray(valid)].sum(0) / n \
        if np.any(valid) else np.zeros(3)
