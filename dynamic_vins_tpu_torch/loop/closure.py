"""Loop closure: keyframe database -> loop-edge proposal -> pose graph,
counterpart of the JAX package's `loop/closure.py`.

  * `KeyframeDatabase`: per-keyframe ORB descriptors (`frontend/orb.py`)
    and a pose-proximity gate; place recognition is brute-force Hamming
    matching with cross-check over the gated candidates (host numpy).
  * `LoopCloser`: on each keyframe, extract ORB on the device, query the
    database, estimate the relative pose of a hit by robust PnP on the
    stored keypoint depths (`triangulation.pnp_gauss_newton`, twice: a
    fit, one inlier pass, a refit), accumulate loop edges.
  * `optimize()`: odometry edges from the VIO poses + loop edges into a
    `solver/pose_graph.PoseGraph`, solved on the device. The distributed
    solve over several cards is not ported yet.

The PnP and the pose graph run in float64 on every device, where the
JAX package runs them in its default float type (float32 on its
accelerator): the float32 solve of a graph at the database's capacity
lands 0.43 m from the float64 one on the H100 (`solver/pose_graph.py`),
and the H100 computes float64 at a useful rate. Both stay off the
per-frame path.

The keyframes are inserted at a stride and the graph is solved on
demand (on an accepted edge or at the end of a sequence).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from dynamic_vins_tpu_torch.estimator.triangulation import pnp_gauss_newton
from dynamic_vins_tpu_torch.frontend.orb import (OrbExtractor,
                                                 match_descriptors)
from dynamic_vins_tpu_torch.geometry import lie_np
from dynamic_vins_tpu_torch.solver import pose_graph as pg
from dynamic_vins_tpu_torch.utils.precision import resolve_device

DTYPE = torch.float64          # of the PnP and the pose graph (see above)


class Keyframe(NamedTuple):
    kf_id: int
    frame_idx: int
    timestamp: float
    p: np.ndarray            # [3] VIO world<-body at insertion
    q: np.ndarray            # [4]
    desc: np.ndarray         # [N,32] uint8 ORB descriptors
    norm: np.ndarray         # [N,2] normalized keypoint coords
    depth: np.ndarray        # [N] camera depth (nan = unknown)
    valid: np.ndarray        # [N] keypoint slot validity
    path_len: float = 0.0    # cumulative VIO path length at insertion


class LoopEdge(NamedTuple):
    i: int                   # older keyframe index (into keyframe list)
    j: int                   # newer keyframe index
    rel_p: np.ndarray        # measured T_bi^-1 T_bj translation
    rel_q: np.ndarray
    n_inliers: int
    mean_err: float


@dataclass
class LoopClosureConfig:
    n_features: int = 300
    n_levels: int = 3
    min_gap: int = 12            # keyframes between query and hit
    prox_radius: float = 4.0     # pose-proximity gate (m, VIO estimate)
    # the gate is evaluated on the drifted VIO estimate, so it widens
    # with the path travelled since the candidate was stored
    prox_drift_rate: float = 0.03  # gate widening per metre of path
    min_matches: int = 25        # descriptor matches to consider a hit
    min_inliers: int = 12        # PnP inliers to accept the edge
    max_desc_dist: int = 48      # Hamming gate
    pnp_err_thresh: float = 4.0 / 460.0   # mean normalized reproj err
    max_keyframes: int = 512
    odom_info: float = 1.0       # sqrt-info scale of odometry edges
    loop_info: float = 10.0      # sqrt-info scale of loop edges


class KeyframeDatabase:
    """ORB keyframe store with pose-proximity-gated place queries."""

    def __init__(self, cfg: LoopClosureConfig):
        self.cfg = cfg
        self.keyframes: List[Keyframe] = []

    def __len__(self):
        return len(self.keyframes)

    def add(self, kf: Keyframe):
        if len(self.keyframes) < self.cfg.max_keyframes:
            self.keyframes.append(kf)

    def query(self, desc, valid, p, path_len: float = 0.0):
        """Best stored keyframe by descriptor-match count among those
        past the index gap and inside the (drift-widened) proximity
        radius: (index into keyframes, matches [M,2] (db_kp, query_kp))
        or (None, None)."""
        cfg = self.cfg
        n = len(self.keyframes)
        best, best_matches = None, None
        d_query = desc[valid]
        qidx = np.flatnonzero(valid)
        if not len(d_query):
            return None, None
        for i in range(n - cfg.min_gap):
            kf = self.keyframes[i]
            gate = cfg.prox_radius + cfg.prox_drift_rate * max(
                path_len - kf.path_len, 0.0)
            if np.linalg.norm(kf.p - p) > gate:
                continue
            kidx = np.flatnonzero(kf.valid)
            if not kidx.size:
                continue
            m = match_descriptors(kf.desc[kidx], d_query,
                                  max_dist=cfg.max_desc_dist)
            if len(m) < cfg.min_matches:
                continue
            if best_matches is None or len(m) > len(best_matches):
                best = i
                best_matches = np.stack([kidx[m[:, 0]],
                                         qidx[m[:, 1]]], -1)
        return best, best_matches


class LoopCloser:
    def __init__(self, cfg: LoopClosureConfig, intr, p_bc, q_bc,
                 baseline: float = 0.1, device=None):
        """intr: PinholeIntrinsics of the left camera; (p_bc, q_bc):
        body<-camera extrinsic; baseline for disparity->depth. device:
        the card unless "cpu" is asked for."""
        self.cfg = cfg
        self.intr = intr
        self.p_bc = np.asarray(p_bc, float)
        self.q_bc = np.asarray(q_bc, float)
        self.baseline = baseline
        self.device = resolve_device(device)
        self.db = KeyframeDatabase(cfg)
        self.edges: List[LoopEdge] = []
        self._orb = OrbExtractor(n_features=cfg.n_features,
                                 n_levels=cfg.n_levels)
        self._path_len = 0.0          # cumulative VIO path length
        self._last_p: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def add_keyframe(self, img, timestamp: float, p_wb, q_wb,
                     depth: Optional[np.ndarray] = None,
                     disparity: Optional[np.ndarray] = None,
                     frame_idx: int = -1) -> Optional[LoopEdge]:
        """Insert a keyframe; returns a LoopEdge if this view closes a
        loop against the database."""
        cfg = self.cfg
        res = self._orb(torch.as_tensor(np.asarray(img, np.float32),
                                        device=self.device))
        xy = res.xy.cpu().numpy()
        valid = res.response.cpu().numpy() > 0.0
        desc = res.desc.cpu().numpy()

        fx, fy = float(self.intr.fx), float(self.intr.fy)
        cx, cy = float(self.intr.cx), float(self.intr.cy)
        norm = np.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy],
                        -1)

        H, W = np.asarray(img).shape
        d = np.full(len(xy), np.nan)
        if depth is None and disparity is not None:
            disp = np.asarray(disparity, float)
            depth = np.where(disp > 0.5,
                             fx * self.baseline / np.maximum(disp, 1e-6),
                             np.nan)
        if depth is not None:
            dep = np.asarray(depth, float)
            xi = np.clip(xy[:, 0].astype(int), 0, W - 1)
            yi = np.clip(xy[:, 1].astype(int), 0, H - 1)
            d = dep[yi, xi]
            d = np.where(np.isfinite(d) & (d > 0.1) & (d < 120.0), d,
                         np.nan)

        p_wb = np.asarray(p_wb, float)
        q_wb = np.asarray(q_wb, float)
        if self._last_p is not None:
            self._path_len += float(np.linalg.norm(p_wb - self._last_p))
        self._last_p = p_wb.copy()
        edge = None
        # an edge names this keyframe by its database index; a full
        # database drops new keyframes, so no edge may point past it
        if len(self.db) >= cfg.max_keyframes:
            return None
        hit, matches = self.db.query(desc, valid, p_wb, self._path_len)
        if hit is not None:
            edge = self._estimate_edge(hit, matches, norm, p_wb, q_wb)
            if edge is not None:
                self.edges.append(edge)

        self.db.add(Keyframe(len(self.db), frame_idx, timestamp,
                             p_wb, q_wb, desc, norm, d, valid,
                             path_len=self._path_len))
        return edge

    # ------------------------------------------------------------------
    def _pnp(self, pts, obs, valid, p0, q0):
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=DTYPE,
                                      device=self.device)
        p, q, err = pnp_gauss_newton(
            t(pts), t(obs), torch.as_tensor(valid, device=self.device),
            t(p0), t(q0))
        return (p.cpu().double().numpy(), q.cpu().double().numpy(),
                float(err))

    def _estimate_edge(self, hit: int, matches, norm_cur, p_wb, q_wb
                       ) -> Optional[LoopEdge]:
        """Robust PnP of the current frame against the hit keyframe's
        stored keypoint depths -> body-frame relative pose edge."""
        cfg = self.cfg
        kf = self.db.keyframes[hit]
        di = kf.depth[matches[:, 0]]
        keep = np.isfinite(di)
        if keep.sum() < cfg.min_inliers:
            return None
        m = matches[keep]
        di = di[keep]
        # 3D points in the old keyframe's camera frame
        ni = kf.norm[m[:, 0]]
        pts_old = np.concatenate([ni * di[:, None], di[:, None]], -1)
        obs_cur = np.concatenate(
            [norm_cur[m[:, 1]], np.ones((len(m), 1))], -1)

        # initial guess T_cj<-ci from the (drifted) VIO poses
        p_wci, q_wci = lie_np.pose_compose(kf.p, kf.q, self.p_bc,
                                           self.q_bc)
        p_wcj, q_wcj = lie_np.pose_compose(p_wb, q_wb, self.p_bc,
                                           self.q_bc)
        p_cjw, q_cjw = lie_np.pose_inverse(p_wcj, q_wcj)
        p0, q0 = lie_np.pose_compose(p_cjw, q_cjw, p_wci, q_wci)

        p_cji, q_cji, err = self._pnp(pts_old, obs_cur,
                                      np.ones(len(m), bool), p0, q0)
        # inlier re-fit (one reject pass)
        pc = lie_np.quat_rotate(q_cji[None, :], pts_old) + p_cji[None, :]
        e = np.linalg.norm(pc[:, :2] / np.maximum(pc[:, 2:3], 1e-6)
                           - obs_cur[:, :2], axis=-1)
        inl = e < 2.0 * cfg.pnp_err_thresh
        if inl.sum() < cfg.min_inliers:
            return None
        p_cji, q_cji, err = self._pnp(pts_old, obs_cur, inl, p_cji, q_cji)
        if err > cfg.pnp_err_thresh:
            return None

        # camera edge T_ci<-cj -> body edge T_bi^-1 T_bj
        p_cij, q_cij = lie_np.pose_inverse(p_cji, q_cji)
        p_cb, q_cb = lie_np.pose_inverse(self.p_bc, self.q_bc)
        pa, qa = lie_np.pose_compose(self.p_bc, self.q_bc, p_cij, q_cij)
        rel_p, rel_q = lie_np.pose_compose(pa, qa, p_cb, q_cb)
        return LoopEdge(hit, len(self.db), rel_p, rel_q,
                        int(inl.sum()), err)

    # ------------------------------------------------------------------
    def build_graph(self, capacity_nodes=None, capacity_edges=None,
                    dtype=None):
        """Odometry edges between consecutive keyframes (from the VIO
        poses, which carry the drift) + the accumulated loop edges, on
        the closer's device; None below two keyframes."""
        cfg = self.cfg
        kfs = self.db.keyframes
        K = len(kfs)
        if K < 2:
            return None
        edges, rels, infos = [], [], []
        for k in range(K - 1):
            a, b = kfs[k], kfs[k + 1]
            p_iw, q_iw = lie_np.pose_inverse(a.p, a.q)
            rp, rq = lie_np.pose_compose(p_iw, q_iw, b.p, b.q)
            edges.append((k, k + 1))
            rels.append((rp, rq))
            infos.append(cfg.odom_info)
        for e in self.edges:
            edges.append((e.i, e.j))
            rels.append((e.rel_p, e.rel_q))
            infos.append(cfg.loop_info)

        g = pg.make_graph([kf.p for kf in kfs], [kf.q for kf in kfs],
                          edges, rels, capacity_nodes=capacity_nodes,
                          capacity_edges=capacity_edges, fixed_nodes=(0,),
                          dtype=dtype or DTYPE, device=self.device)
        s = torch.ones(g.sqrt_info.shape[0], dtype=g.sqrt_info.dtype)
        s[:len(infos)] = torch.tensor(infos, dtype=s.dtype)
        return g._replace(sqrt_info=g.sqrt_info
                          * s.to(self.device)[:, None, None])

    def rebase(self, p, q):
        """Overwrite the stored keyframe poses with a pose-graph result
        (live relocalization): once the estimator's window is re-anchored
        (`Estimator.apply_loop_correction`), later VIO outputs live in the
        corrected frame, so the stored keyframes must too, or the next
        odometry edge would measure the correction as motion."""
        kfs = self.db.keyframes
        for k in range(len(kfs)):
            kfs[k] = kfs[k]._replace(p=np.asarray(p[k], float),
                                     q=np.asarray(q[k], float))
        if kfs:
            self._last_p = kfs[-1].p.copy()

    def optimize(self, mesh=None, config=None):
        """Solve the pose graph; returns (p [K,3], q [K,4], info) of the
        corrected keyframe trajectory (host float64), or None if there
        is nothing to solve. A mesh (the distributed solve) raises."""
        if mesh is not None:
            raise NotImplementedError(
                "the distributed pose-graph solve is not ported yet: "
                "ROADMAP queue 1 item 18")
        g = self.build_graph()
        if g is None:
            return None
        g2, info = pg.solve(g, config or pg.PgoConfig())
        return (g2.p.cpu().double().numpy(), g2.q.cpu().double().numpy(),
                info)
