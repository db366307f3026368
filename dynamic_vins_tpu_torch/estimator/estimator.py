"""Sliding-window visual-inertial estimator (the backend), synchronous
multi-dispatch path.

IMU interval preintegration, keyframe/parallax margin decision, stereo
+IMU initialization with a gyro-bias solve, triangulation, windowed LM,
outlier rejection, marginalization, window slide and failure detection.

Split: this class is the frame-granularity host orchestrator. The
window state, landmark bookkeeping and raw IMU buffers are host numpy
(one packed transfer per stage); the preintegrations and the
marginalization prior stay on the device; every heavy stage below is a
torch function on the estimator's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from dynamic_vins_tpu_torch.estimator import triangulation
from dynamic_vins_tpu_torch.estimator.feature_manager import FeatureManager
from dynamic_vins_tpu_torch.factors import prior as prior_factor
from dynamic_vins_tpu_torch.factors import projection
from dynamic_vins_tpu_torch.geometry import lie, lie_np
from dynamic_vins_tpu_torch.imu import preintegration as pre
from dynamic_vins_tpu_torch.solver import gauss_newton as gn
from dynamic_vins_tpu_torch.solver import layout, marginalization as marg
from dynamic_vins_tpu_torch.utils.precision import resolve_device

# ROADMAP.md names for the parts of the JAX estimator not ported yet
_TODO = {
    "use_megastep": "queue 1 item 9 (single-dispatch megastep)",
    "pipelined": "queue 1 item 9 (pipelined steady state)",
    "mesh": "queue 1 item 18 (multi-GPU)",
    "use_line": "queue 1 item 13 (LinePoint)",
    "dynamic": "queue 1 item 15 (DYNAMIC)",
    "calibrate_extrinsic_rotation": "queue 1 item 12 (ex-rotation "
                                    "calibration)",
}


@dataclass
class EstimatorConfig:
    num_frames: int = 11            # WINDOW_SIZE + 1
    lm_capacity: int = 512
    obs_capacity: int = 8192
    imu_per_edge: int = 256         # max IMU samples per window edge
    stereo: bool = True
    use_imu: bool = True
    max_iters: int = 8
    huber_delta: float = 1.0
    estimate_extrinsic: bool = False
    calibrate_extrinsic_rotation: bool = False
    estimate_td: bool = False
    outlier_thresh: float = 3.0 / 460.0   # reproj err, normalized plane
    max_depth: float = 200.0
    use_megastep: bool = False
    pipelined: bool = False
    use_plane_constraint: bool = False
    dynamic: bool = False
    use_line: bool = False
    mesh: object = None
    dtype: torch.dtype = torch.float64


class FrameFeatures(NamedTuple):
    """Per-frame frontend output: {id: (pt_l, vel_l, pt_r|None, vel_r)}."""

    timestamp: float
    features: dict
    lines: dict = None


class OdometryOut(NamedTuple):
    timestamp: float
    p: np.ndarray
    q: np.ndarray
    v: np.ndarray


# ----------------------------------------------------------------------
# device stages (plain torch functions; state I/O rides a packed array)
# ----------------------------------------------------------------------

def set_edge(pres: pre.Preintegration, e: int, one: pre.Preintegration):
    def put(f, o):
        f = f.clone()
        f[e] = o
        return f
    return pre.Preintegration(*(put(f, o) for f, o in zip(pres, one)))


def roll_edges(pres: pre.Preintegration):
    return pres.map(lambda a: torch.cat([a[1:], a[-1:] * 0], dim=0))


def prepare_frame(flat, pres, e, acc, gyr, dts, mask, k, pnp_pack, F,
                  noise):
    """Refresh IMU edge e, propagate pose/velocity into slot k, refine
    slot k with PnP. Returns (pres, packed state, PnP error)."""
    state = layout.WindowState.unpack(flat, F)
    one = pre.preintegrate(acc, gyr, dts, state.ba[e], state.bg[e],
                           noise=noise, valid_mask=mask)
    pres2 = set_edge(pres, e, one)
    pk, qk, vk = pre.propagate_with(one, state.p[k - 1], state.q[k - 1],
                                    state.v[k - 1])
    p, q, v = state.p.clone(), state.q.clone(), state.v.clone()
    ba, bg = state.ba.clone(), state.bg.clone()
    p[k], q[k], v[k] = pk, qk, vk
    ba[k], bg[k] = ba[k - 1], bg[k - 1]

    ones = torch.ones_like(pnp_pack[:, :1])
    pnp_valid = pnp_pack[:, 5] > 0.5
    p_wc, q_wc = lie.pose_compose(p[k], q[k], state.p_bc[0],
                                  state.q_bc[0])
    p_cw0, q_cw0 = lie.pose_inverse(p_wc, q_wc)
    p_cw, q_cw, err = triangulation.pnp_gauss_newton(
        pnp_pack[:, 0:3], torch.cat([pnp_pack[:, 3:5], ones], dim=1),
        pnp_valid, p_cw0, q_cw0)
    ok = (pnp_valid.sum() >= 6) & torch.isfinite(err) & (err < 0.05)
    p_wc2, q_wc2 = lie.pose_inverse(p_cw, q_cw)
    p_cb, q_cb = lie.pose_inverse(state.p_bc[0], state.q_bc[0])
    p_wb, q_wb = lie.pose_compose(p_wc2, q_wc2, p_cb, q_cb)
    p[k] = torch.where(ok, p_wb, p[k])
    q[k] = torch.where(ok, q_wb, q[k])
    st = state._replace(p=p, q=q, v=v, ba=ba, bg=bg)
    return pres2, st.pack(), err


def triangulate_slots(flat, anchors, tri_f, stereo_ok, two_ok, k, F,
                      max_depth):
    """Per-slot anchored triangulation; tri_f [L,6] = (ptl xy, ptr xy,
    ptc xy). Stereo at the anchor where available, else anchor->k."""
    state = layout.WindowState.unpack(flat, F)
    ones = torch.ones_like(tri_f[:, :1])
    l = torch.cat([tri_f[:, 0:2], ones], dim=1)
    r = torch.cat([tri_f[:, 2:4], ones], dim=1)
    c = torch.cat([tri_f[:, 4:6], ones], dim=1)
    pa, qa = state.p[anchors], state.q[anchors]
    p_cw0, q_cw0 = lie.pose_inverse(*lie.pose_compose(
        pa, qa, state.p_bc[0], state.q_bc[0]))
    p_cw1, q_cw1 = lie.pose_inverse(*lie.pose_compose(
        pa, qa, state.p_bc[1], state.q_bc[1]))
    _, d_st = triangulation.triangulate_dlt(p_cw0, q_cw0, p_cw1, q_cw1,
                                            l, r)
    p_cwk, q_cwk = lie.pose_inverse(*lie.pose_compose(
        state.p[k], state.q[k], state.p_bc[0], state.q_bc[0]))
    _, d_tw = triangulation.triangulate_dlt(p_cw0, q_cw0, p_cwk, q_cwk,
                                            l, c)
    d = torch.where(stereo_ok, d_st, d_tw)
    ok = (stereo_ok | two_ok) & (d > 0.1) & (d < max_depth) \
        & torch.isfinite(d)
    return d, ok


def solve_score(state, inv_depth, problem: gn.BAProblem,
                config: gn.SolverConfig):
    """LM solve + per-landmark mean reprojection error (normalized
    plane) -> (state, inv_depth, final cost, scores [L])."""
    st, dep, info = gn.solve(state, inv_depth, problem, config)
    obs = problem.obs
    err = torch.linalg.vector_norm(
        projection.residual_only(st, dep, obs, sqrt_info=1.0), dim=-1)
    L = dep.shape[0]
    w = (obs.valid & problem.lm_valid[obs.lm]).to(err.dtype)
    ssum = gn._segment_sum(err * w, obs.lm, L)
    n = gn._segment_sum(w, obs.lm, L)
    return st, dep, info.final_cost, ssum / torch.clamp_min(n, 1.0)


def marg_old_shifted(state, inv_depth, problem, drop_lm, pt0, config):
    """Marginalize frame 0, shift the prior for the slide, and re-anchor
    the dropped landmarks' depths from frame 0 to frame 1."""
    new_prior = marg.marginalize_old(state, inv_depth, problem, drop_lm,
                                     config)
    shifted = marg.shift_prior_after_slide_old(new_prior, state)
    pts_c0 = pt0 / torch.clamp_min(inv_depth, 1e-6)[:, None]
    p_wc0, q_wc0 = lie.pose_compose(state.p[0], state.q[0],
                                    state.p_bc[0], state.q_bc[0])
    pw = lie.pose_transform_point(p_wc0[None, :], q_wc0[None, :], pts_c0)
    p_cw1, q_cw1 = lie.pose_inverse(*lie.pose_compose(
        state.p[1], state.q[1], state.p_bc[0], state.q_bc[0]))
    d1 = lie.pose_transform_point(p_cw1[None, :], q_cw1[None, :],
                                  pw)[:, 2]
    re_ok = (d1 > 1e-3) & torch.isfinite(d1)
    new_inv = torch.where(re_ok, 1.0 / torch.clamp_min(d1, 1e-3),
                          inv_depth)
    return shifted, new_inv, re_ok


class Estimator:
    def __init__(self, config: EstimatorConfig, p_bc, q_bc,
                 noise: pre.ImuNoise = pre.ImuNoise(), device=None):
        for name, item in _TODO.items():
            if getattr(config, name):
                raise NotImplementedError(
                    f"EstimatorConfig.{name} is not ported yet: ROADMAP "
                    f"{item}")
        if config.stereo is False and config.use_imu:
            raise NotImplementedError(
                "mono+IMU initialization is not ported yet: ROADMAP "
                "queue 1 item 12")
        self.cfg = config
        self.device = resolve_device(device)
        self.dtype = config.dtype
        F = config.num_frames
        self.fm = FeatureManager(num_frames=F, capacity=config.lm_capacity,
                                 obs_capacity=config.obs_capacity)
        # host mirror of the window state, in the solver's dtype
        self.state = layout.WindowState.identity(F, self.dtype).to_numpy()
        self.state.p_bc[:] = np.asarray(p_bc)
        self.state.q_bc[:] = np.asarray(q_bc)
        self.prior = prior_factor.MarginalPrior.empty(F, self.dtype,
                                                      self.device)
        self.noise = noise
        self.frame_count = 0
        self.initialized = False
        self.failed = False
        self.timestamps = np.zeros(F)
        E, C = F - 1, config.imu_per_edge
        self.imu_acc = np.zeros((E, C + 1, 3))
        self.imu_gyr = np.zeros((E, C + 1, 3))
        self.imu_dt = np.zeros((E, C))
        self.imu_n = np.zeros(E, np.int32)
        self._acc0 = np.zeros(3)
        self._gyr0 = np.zeros(3)
        self._pose_preset = False
        self._latest = None
        self._outlier_scores_cache = None
        self._reanchored = None

        self._solver_cfg = gn.SolverConfig(
            max_iters=config.max_iters, use_imu=config.use_imu,
            huber_delta=config.huber_delta)
        fixed = np.zeros(layout.cam_dim(F), bool)
        if not config.estimate_extrinsic:
            fixed[layout.extrinsic_col(0, F):layout.td_col(F)] = True
        if not config.estimate_td:
            fixed[layout.td_col(F)] = True
        if config.use_plane_constraint:
            fixed |= layout.plane_constraint_cols(F)
        self._fixed = torch.tensor(fixed, device=self.device)
        pose0 = np.zeros(layout.cam_dim(F), bool)
        pose0[layout.pose_col(0):layout.pose_col(0) + 6] = True
        self._pose0_mask = torch.tensor(pose0, device=self.device)
        self._pres = self._preintegrate_all()

    # ------------------------------------------------------------------
    # host <-> device
    # ------------------------------------------------------------------
    def _f(self, a):
        """Copy a host array to the device in the solver dtype (a copy,
        never a view of the host buffer the bookkeeping mutates)."""
        return torch.tensor(np.asarray(a), dtype=self.dtype,
                            device=self.device)

    def _i(self, a):
        return torch.tensor(np.asarray(a), device=self.device)

    @staticmethod
    def _host(t):
        return t.detach().cpu().numpy()

    def _unpack_host(self, flat):
        return layout.WindowState.unpack(self._host(flat).copy(),
                                         self.cfg.num_frames)

    # ------------------------------------------------------------------
    # IMU ingestion
    # ------------------------------------------------------------------
    def add_imu_interval(self, acc, gyr, dts):
        """Record IMU measurements for the edge ending at the next frame.

        acc/gyr: [M+1,3] samples bracketing the interval, dts: [M]."""
        if len(acc):
            self._acc0 = np.asarray(acc[-1], dtype=float).copy()
            self._gyr0 = np.asarray(gyr[-1], dtype=float).copy()
        if self.frame_count == 0:
            return
        e = min(self.frame_count - 1, self.cfg.num_frames - 2)
        n = int(self.imu_n[e])
        m = len(dts)
        take = max(min(m, self.cfg.imu_per_edge - n), 0)
        if n == 0:
            self.imu_acc[e, 0] = acc[0]
            self.imu_gyr[e, 0] = gyr[0]
        self.imu_acc[e, n + 1:n + take + 1] = acc[1:take + 1]
        self.imu_gyr[e, n + 1:n + take + 1] = gyr[1:take + 1]
        self.imu_dt[e, n:n + take] = dts[:take]
        self.imu_n[e] = n + take

    def _edge_mask(self, e=None):
        C = self.cfg.imu_per_edge
        if e is None:
            return self._i(np.arange(C)[None, :] < self.imu_n[:, None])
        return self._i(np.arange(C) < self.imu_n[e])

    def _preintegrate_all(self):
        return pre.preintegrate(
            self._f(self.imu_acc), self._f(self.imu_gyr),
            self._f(self.imu_dt), self._f(self.state.ba[:-1]), self._f(self.state.bg[:-1]),
            noise=self.noise, valid_mask=self._edge_mask())

    def _refresh_edge(self, e: int):
        """Re-preintegrate one edge, linearized at the current estimate
        of its start frame's biases."""
        one = pre.preintegrate(
            self._f(self.imu_acc[e]), self._f(self.imu_gyr[e]),
            self._f(self.imu_dt[e]), self._f(self.state.ba[e]),
            self._f(self.state.bg[e]), noise=self.noise,
            valid_mask=self._edge_mask(e))
        self._pres = set_edge(self._pres, e, one)

    # ------------------------------------------------------------------
    # frame processing
    # ------------------------------------------------------------------
    def process_frame(self, frame: FrameFeatures,
                      imu_interval=None) -> Optional[OdometryOut]:
        """Ingest one frame (+ the IMU since the previous frame)."""
        cfg = self.cfg
        F = cfg.num_frames
        k = self.frame_count
        if k >= F:
            raise RuntimeError("window overflow — slide failed")
        if imu_interval is not None and cfg.use_imu and k > 0:
            self.add_imu_interval(*imu_interval)

        self.timestamps[k] = frame.timestamp
        feats = frame.features
        if not cfg.stereo:
            feats = {fid: (pl, vl, None, None)
                     for fid, (pl, vl, _pr, _vr) in feats.items()}
        is_keyframe = self.fm.add_features(k, feats)

        if k == 0:
            if cfg.use_imu and imu_interval is not None \
                    and not self._pose_preset:
                acc0 = np.mean(np.asarray(imu_interval[0]), axis=0)
                R0 = lie.g2R(torch.tensor(acc0, dtype=torch.float64))
                self.state.q[0] = lie.matrix_to_quat(R0).numpy()
        else:
            self._prepare(k)

        self._triangulate_new(k)

        if not self.initialized and k == F - 1:
            self._initialize()
        if self.initialized:
            self._optimize()
            self._reject_outliers()
            self._check_failure()

        out = self._output(k)
        if k == F - 1:
            if self.initialized:
                self._marginalize_and_slide(is_keyframe)
            else:
                self._slide(True)
        else:
            self.frame_count += 1
        return out

    def flush(self):
        """In-flight outputs to drain: none on the synchronous path."""
        return []

    def _prepare(self, k):
        cfg = self.cfg
        fm = self.fm
        e = min(k - 1, cfg.num_frames - 2)
        pnp_pack = np.zeros((cfg.lm_capacity, 6))
        slots = np.flatnonzero(fm.active & fm.depth_valid
                               & fm.has_obs[:, k] & (fm.start_frame < k))
        if slots.size >= 6:
            pnp_pack[:slots.size, 0:3] = \
                self._landmark_world_positions(slots)
            pnp_pack[:slots.size, 3:5] = fm.pt[slots, k, :2]
            pnp_pack[:slots.size, 5] = 1.0
        pres2, flat, _ = prepare_frame(
            self._f(self.state.pack()), self._pres, e,
            self._f(self.imu_acc[e]), self._f(self.imu_gyr[e]),
            self._f(self.imu_dt[e]), self._edge_mask(e), k,
            self._f(pnp_pack), cfg.num_frames, self.noise)
        self._pres = pres2
        self.state = self._unpack_host(flat)

    def _landmark_world_positions(self, slots):
        fm = self.fm
        st = self.state
        anchors = fm.start_frame[slots]
        pts = fm.pt[slots, anchors] / fm.inv_depth[slots][:, None]
        p_wc, q_wc = lie_np.pose_compose(
            np.asarray(st.p)[anchors], np.asarray(st.q)[anchors],
            np.asarray(st.p_bc[0])[None, :],
            np.asarray(st.q_bc[0])[None, :])
        return lie_np.pose_transform_point(p_wc, q_wc, pts)

    def _triangulate_new(self, k):
        """Depths for landmarks without one (stereo at the anchor, else
        anchor -> current), all slots in one dispatch."""
        cfg = self.cfg
        fm = self.fm
        cap = cfg.lm_capacity
        need = fm.active & ~fm.depth_valid & (fm.start_frame <= k)
        stereo_ok = np.zeros(cap, bool)
        two_ok = np.zeros(cap, bool)
        tri_f = np.zeros((cap, 6))
        for sl in np.flatnonzero(need):
            a = int(fm.start_frame[sl])
            if cfg.stereo and fm.has_right[sl, a]:
                stereo_ok[sl] = True
                tri_f[sl, 0:2] = fm.pt[sl, a, :2]
                tri_f[sl, 2:4] = fm.pt_right[sl, a, :2]
            elif self.initialized and a < k and fm.has_obs[sl, k]:
                two_ok[sl] = True
                tri_f[sl, 0:2] = fm.pt[sl, a, :2]
                tri_f[sl, 4:6] = fm.pt[sl, k, :2]
        if not (stereo_ok.any() or two_ok.any()):
            return
        d, ok = triangulate_slots(
            self._f(self.state.pack()),
            self._i(fm.start_frame.astype(np.int64)), self._f(tri_f),
            self._i(stereo_ok), self._i(two_ok), k, cfg.num_frames,
            cfg.max_depth)
        d = self._host(d)
        ok = self._host(ok) & (stereo_ok | two_ok)
        fm.inv_depth[ok] = 1.0 / d[ok]
        fm.depth_valid[ok] = True

    def _initialize(self):
        """Stereo (+IMU) initialization: gyro bias from visual vs
        preintegrated rotations, finite-difference velocities."""
        cfg = self.cfg
        if cfg.use_imu:
            st = self.state
            q_est = lie_np.quat_multiply(lie_np.quat_conjugate(st.q[:-1]),
                                         st.q[1:])
            dbg = triangulation.solve_gyro_bias(
                self._pres.dq_dbg, self._pres.delta_q, self._f(q_est))
            dbg = self._host(torch.where(torch.isfinite(dbg), dbg, 0.0))
            st.bg[:] = st.bg + dbg[None, :]
            dt = np.maximum(np.diff(self.timestamps[:cfg.num_frames]),
                            1e-3)
            v = np.zeros_like(st.p)
            v[:-1] = (st.p[1:] - st.p[:-1]) / dt[:, None]
            v[-1] = v[-2]
            st.v[:] = v
            self._pres = self._preintegrate_all()
        self.initialized = True

    # ------------------------------------------------------------------
    def _imu_valid_dev(self):
        E = self.cfg.num_frames - 1
        return self._i((self.imu_n > 0) & self.cfg.use_imu
                       & (np.arange(E) < self.frame_count))

    def _problem(self, oi, of, ov, lm_valid):
        fixed = self._fixed
        if not self.cfg.use_imu:
            # visual-only: anchor the gauge on pose 0 until the prior
            # takes over
            fixed = fixed | (self._pose0_mask & ~self.prior.valid)
        return gn.BAProblem(
            obs=projection.unpack_obs(self._i(oi), self._f(of),
                                      self._i(ov)),
            pres=self._pres, imu_valid=self._imu_valid_dev(),
            prior=self.prior, lm_valid=self._i(lm_valid),
            fixed_cols=fixed)

    def _state_dev(self):
        return layout.WindowState.from_numpy(self.state, self.dtype,
                                             self.device)

    def _optimize(self):
        oi, of, ov, lm_valid = self.fm.build_obs_packed()
        st, dep, cost, scores = solve_score(
            self._state_dev(), self._f(self.fm.inv_depth),
            self._problem(oi, of, ov, lm_valid), self._solver_cfg)
        self._outlier_scores_cache = (self._host(scores), lm_valid)
        if not np.isfinite(float(cost)):
            self.failed = True
            return
        self.state = self._unpack_host(st.pack())
        self.fm.set_depths(self._host(dep))

    def _reject_outliers(self):
        cache = self._outlier_scores_cache
        if cache is None:
            return
        scores, lm_valid = cache
        self._outlier_scores_cache = None
        bad = (scores > self.cfg.outlier_thresh) & np.asarray(lm_valid)
        if bad.any():
            self.fm.remove_outliers(bad)

    def _check_failure(self):
        st = self.state
        bad = (not np.all(np.isfinite(st.p))
               or float(np.linalg.norm(st.ba[-1])) > 2.5
               or float(np.linalg.norm(st.bg[-1])) > 1.0)
        if bad:
            self.failed = True

    # ------------------------------------------------------------------
    def _marginalize_and_slide(self, is_keyframe: bool):
        if is_keyframe:
            fm = self.fm
            oi, of, ov, lm_valid = fm.build_obs_packed()
            drop_lm = fm.active & (fm.start_frame == 0) & fm.depth_valid
            shifted, new_inv, re_ok = marg_old_shifted(
                self._state_dev(), self._f(fm.inv_depth),
                self._problem(oi, of, ov, lm_valid), self._i(drop_lm),
                self._f(fm.pt[:, 0]), self._solver_cfg)
            self._reanchored = (drop_lm, self._host(new_inv),
                                self._host(re_ok))
            self._slide(True)
            self.prior = shifted
        else:
            prior = self.prior
            has_prior = bool(prior.valid)
            if has_prior:
                prior = marg.marginalize_second_new(prior,
                                                    self.cfg.num_frames)
            self._slide(False)
            if has_prior:
                self.prior = marg.shift_prior_after_slide_new(prior)

    def _slide(self, old: bool):
        cfg = self.cfg
        F = cfg.num_frames
        st = self.state
        if old:
            pre_computed = self._reanchored
            self._reanchored = None

            def reanchor(slots):
                if pre_computed is not None:
                    _, new_inv, re_ok = pre_computed
                    out = new_inv[slots].copy()
                    out[~re_ok[slots]] = np.nan
                    return out
                return self._reanchor_host(slots)

            self.fm.slide_old(reanchor)
            for a in (st.p, st.q, st.v, st.ba, st.bg):
                a[:-1] = a[1:].copy()
            self.timestamps[:-1] = self.timestamps[1:].copy()
            for a in (self.imu_acc, self.imu_gyr, self.imu_dt, self.imu_n):
                a[:-1] = a[1:].copy()
            self.imu_n[-1] = 0
            self.imu_dt[-1] = 0
            self._pres = roll_edges(self._pres)
        else:
            F2, F1 = F - 2, F - 1
            for a in (st.p, st.q, st.v, st.ba, st.bg):
                a[F2] = a[F1]
            self.timestamps[F2] = self.timestamps[F1]
            e2, e1 = F - 3, F - 2
            n2, n1 = int(self.imu_n[e2]), int(self.imu_n[e1])
            take = min(n1, cfg.imu_per_edge - n2)
            if take > 0:
                self.imu_acc[e2, n2 + 1:n2 + take + 1] = \
                    self.imu_acc[e1, 1:take + 1]
                self.imu_gyr[e2, n2 + 1:n2 + take + 1] = \
                    self.imu_gyr[e1, 1:take + 1]
                self.imu_dt[e2, n2:n2 + take] = self.imu_dt[e1, :take]
                self.imu_n[e2] = n2 + take
            self.imu_n[e1] = 0
            self.imu_dt[e1] = 0
            self._refresh_edge(e2)
            self._pres = set_edge(self._pres, e1,
                                  self._pres.map(lambda x: x[e1] * 0))
            self.fm.slide_new()
        self.frame_count = F - 1

    def _reanchor_host(self, slots):
        """Inverse depths of frame-0-anchored slots in frame 1's left
        camera (NaN where the point is not in front)."""
        fm = self.fm
        st = self.state
        pts = fm.pt[slots, 0] / fm.inv_depth[slots][:, None]
        p_bc, q_bc = np.asarray(st.p_bc[0]), np.asarray(st.q_bc[0])
        p_wc0, q_wc0 = lie_np.pose_compose(st.p[0], st.q[0], p_bc, q_bc)
        pw = lie_np.pose_transform_point(p_wc0[None, :], q_wc0[None, :],
                                         pts)
        p_wc1, q_wc1 = lie_np.pose_compose(st.p[1], st.q[1], p_bc, q_bc)
        p_cw1, q_cw1 = lie_np.pose_inverse(p_wc1, q_wc1)
        d = lie_np.pose_transform_point(p_cw1[None, :], q_cw1[None, :],
                                        pw)[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(d > 1e-3, 1.0 / d, np.nan)

    # ------------------------------------------------------------------
    def _output(self, k) -> OdometryOut:
        st = self.state
        # anchor of IMU-rate prediction (fast_predict: ROADMAP queue 1
        # item 12); set only once the window is aligned
        self._latest = None if not self.initialized else {
            "t": float(self.timestamps[k]), "p": st.p[k].copy(),
            "q": st.q[k].copy(), "v": st.v[k].copy(),
            "ba": st.ba[k].copy(), "bg": st.bg[k].copy(),
            "acc": self._acc0.copy(), "gyr": self._gyr0.copy()}
        return OdometryOut(timestamp=float(self.timestamps[k]),
                           p=st.p[k].copy(), q=st.q[k].copy(),
                           v=st.v[k].copy())

    def set_initial_pose(self, p, q, v=None):
        """Anchor the world frame (otherwise gravity-aligned, yaw-free)."""
        self.state.p[0] = np.asarray(p)
        self.state.q[0] = np.asarray(q)
        if v is not None:
            self.state.v[0] = np.asarray(v)
        self._pose_preset = True

    def reset(self):
        """Clear the state and restart with the same calibration."""
        p_bc, q_bc = self.state.p_bc.copy(), self.state.q_bc.copy()
        self.__init__(self.cfg, p_bc, q_bc, self.noise, self.device)
