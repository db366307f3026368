"""3D box fitting to object point clouds, batched (plain torch).

The reference's FitBox3DWithRANSAC / FitBox3DSimple
(`estimator/vio_util.cpp:205-257,351`): given a point cloud, box dims
and orientation, the box center that holds the most points, with a
centroid fallback; and the radius / Euclidean-cluster outlier filters
(`dynamic_tracker.cpp:159-341`) as fixed-shape graph operations. Every
function takes leading batch axes (objects), so one call serves all
objects. Ties in an argmax go to the first maximum, as in the JAX
package.
"""

from __future__ import annotations

import torch

from dynamic_vins_tpu_torch.geometry import lie


def fit_box_center(pts_w, valid, q_wo, dims, num_candidates: int = 64,
                   margin: float = 1.2):
    """Box center from a world point cloud pts_w [...,N,3] (valid
    [...,N]), box orientation q_wo [...,4] and dims [...,3].

    Candidate centers are the points at linspace(0, N-1, C) (truncated);
    the candidate with the most valid points inside margin * dims/2 wins
    and the center is the mean of its inliers. Returns (center [...,3],
    inlier_count [...], inlier_mask [...,N])."""
    R = lie.quat_to_matrix(q_wo)
    pts_obj = pts_w @ R                          # rotate into object axes
    half = margin * dims / 2.0
    n = pts_w.shape[-2]
    idx = torch.linspace(0, n - 1, num_candidates,
                         dtype=torch.float64).to(torch.int64)
    idx = idx.to(pts_w.device)
    cand = pts_obj[..., idx, :]                  # [...,C,3]
    cand_ok = valid[..., idx]
    d = torch.abs(pts_obj[..., None, :, :] - cand[..., :, None, :])
    inside = torch.all(d <= half[..., None, None, :], dim=-1) \
        & valid[..., None, :]                    # [...,C,N]
    counts = inside.sum(dim=-1) * cand_ok
    best = torch.argmax(counts, dim=-1)          # first maximum
    mask = torch.take_along_dim(inside, best[..., None, None],
                                dim=-2)[..., 0, :]
    cnt = torch.clamp_min(mask.sum(dim=-1), 1)
    center_obj = torch.where(mask[..., None], pts_obj, 0.0).sum(dim=-2) \
        / cnt[..., None]
    center_w = (R @ center_obj[..., None])[..., 0]
    count = torch.take_along_dim(counts, best[..., None], dim=-1)[..., 0]
    return center_w, count, mask


def centroid(pts_w, valid):
    """Masked centroid [...,3] of pts_w [...,N,3] (the reference's
    fallback, estimator_insts.cpp:495-560)."""
    n = torch.clamp_min(valid.sum(dim=-1), 1)
    return torch.where(valid[..., None], pts_w, 0.0).sum(dim=-2) \
        / n[..., None]


def radius_filter(pts, valid, radius: float = 1.0, min_neighbors: int = 3):
    """valid points with at least `min_neighbors` other valid points
    within `radius` (the PCL radius outlier filter) -> [...,N] bool."""
    d2 = torch.sum((pts[..., :, None, :] - pts[..., None, :, :]) ** 2, -1)
    near = (d2 <= radius * radius) & valid[..., None, :] \
        & valid[..., :, None]
    neighbors = near.sum(dim=-1) - 1
    return valid & (neighbors >= min_neighbors)


def largest_cluster(pts, valid, radius: float = 0.8, num_iters: int = 8):
    """The cluster of the densest point (PCL EuclideanClusterExtraction
    with a fixed number of rounds): min-label propagation over the
    radius graph for `num_iters` rounds -> [...,N] bool."""
    n = pts.shape[-2]
    d2 = torch.sum((pts[..., :, None, :] - pts[..., None, :, :]) ** 2, -1)
    adj = (d2 <= radius * radius) & valid[..., None, :] \
        & valid[..., :, None]
    ar = torch.arange(n, device=pts.device)
    labels = torch.where(valid, ar, n)
    for _ in range(num_iters):
        neigh = torch.where(adj, labels[..., None, :], n)
        labels = torch.minimum(labels, neigh.min(dim=-1).values)
    degree = adj.sum(dim=-1) * valid
    seed = torch.argmax(degree, dim=-1, keepdim=True)    # first maximum
    return valid & (labels == torch.take_along_dim(labels, seed, dim=-1))
