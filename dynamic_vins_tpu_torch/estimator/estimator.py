"""Sliding-window visual-inertial estimator (the backend).

IMU interval preintegration, keyframe/parallax margin decision,
initialization (stereo(+IMU) with a gyro-bias solve; mono+IMU by the
essential matrix, SfM and the visual-inertial alignment of
`initializer.py`), triangulation, windowed LM, outlier rejection,
marginalization, window slide and failure detection; also the hand-eye
calibration of the camera rotation, IMU-rate fast prediction, the loop
correction, checkpoints (the JAX package's `.npz` keys), reset and
runtime sensor changes. LinePoint mode (`use_line`) adds world-frame
line landmarks (`line_manager.py`): a line-only refinement, then the
joint solve with their 4-dof blocks, on every path.

Split: this class is the frame-granularity host orchestrator. The
window state, landmark bookkeeping and raw IMU buffers are host numpy;
the preintegrations and the marginalization prior stay on the device;
every heavy stage below is a torch function on the estimator's device.
Until the window is full and initialized, each stage is its own
dispatch (the multi-dispatch path, also the whole path with
`use_megastep=False`). After that, a frame is one step (`megastep`:
one upload, one step, one fetch), which the card replays as a CUDA
graph chain; with `pipelined`, the step keeps the window, depths, masks
and obs pools on the device (`megastep_pipelined`) and the host reads
each frame's results two frames later.
"""

from __future__ import annotations

import contextlib
import functools
from collections import deque
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from dynamic_vins_tpu_torch.estimator import initializer as ini
from dynamic_vins_tpu_torch.estimator import triangulation
from dynamic_vins_tpu_torch.estimator.ex_rotation import ExRotationCalibrator
from dynamic_vins_tpu_torch.estimator.feature_manager import (
    DEFAULT_DEPTH, FeatureManager)
from dynamic_vins_tpu_torch.estimator.line_manager import (
    LineManager, plucker_to_orth_np)
from dynamic_vins_tpu_torch.factors import line_factor
from dynamic_vins_tpu_torch.factors import prior as prior_factor
from dynamic_vins_tpu_torch.factors import projection
from dynamic_vins_tpu_torch.geometry import lie, lie_np
from dynamic_vins_tpu_torch.imu import preintegration as pre
from dynamic_vins_tpu_torch.solver import gauss_newton as gn
from dynamic_vins_tpu_torch.solver import layout, marginalization as marg
from dynamic_vins_tpu_torch.utils.precision import (default_dtype,
                                                    resolve_device)
from dynamic_vins_tpu_torch.utils.step_graph import StepGraph

# ROADMAP.md names for the parts of the JAX estimator not ported yet
_TODO = {
    "mesh": "queue 1 item 18 (multi-GPU)",
}

# RemoveLineOutlier: mean endpoint-to-line distance, normalized plane
LINE_OUTLIER_THRESH = 5.0 / 460.0


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
    # hand-eye self-calibration of q_bc during start-up: once it
    # converges it is written into the window state
    calibrate_extrinsic_rotation: bool = False
    estimate_td: bool = False
    outlier_thresh: float = 3.0 / 460.0   # reproj err, normalized plane
    max_depth: float = 200.0
    use_megastep: bool = True      # the steady state as one step a frame
    # device-resident steady state: frame k+1's step is dispatched
    # before frame k's results are read; outputs lag 2 frames and keep
    # their own timestamps
    pipelined: bool = False
    use_plane_constraint: bool = False
    dynamic: bool = False
    use_line: bool = False          # LinePoint mode (points + lines)
    line_capacity: int = 64
    line_obs_capacity: int = 512
    line_weight: float = 1.0        # line factors against the points
    mesh: object = None
    # None: the device's (float32 on the card, float64 on the CPU)
    dtype: Optional[torch.dtype] = None


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
    ptc xy). Stereo at the anchor where available, else anchor->k. The
    two DLT problems of every slot go to one batched SVD."""
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
    p_cwk, q_cwk = lie.pose_inverse(*lie.pose_compose(
        state.p[k], state.q[k], state.p_bc[0], state.q_bc[0]))
    two = lambda a, b: torch.stack([a, b.expand_as(a)])
    _, d = triangulation.triangulate_dlt(
        p_cw0, q_cw0, two(p_cw1, p_cwk), two(q_cw1, q_cwk), l, two(r, c))
    d = torch.where(stereo_ok, d[0], d[1])
    ok = (stereo_ok | two_ok) & (d > 0.1) & (d < max_depth) \
        & torch.isfinite(d)
    return d, ok


def _point_scores(st, dep, problem: gn.BAProblem):
    """Per-landmark mean reprojection error on the normalized plane [L]."""
    obs = problem.obs
    err = torch.linalg.vector_norm(
        projection.residual_only(st, dep, obs, sqrt_info=1.0), dim=-1)
    L = dep.shape[0]
    w = (obs.valid & problem.lm_valid[obs.lm]).to(err.dtype)
    ssum = gn._segment_sum(err * w, obs.lm, L)
    n = gn._segment_sum(w, obs.lm, L)
    return ssum / torch.clamp_min(n, 1.0)


def solve_score(state, inv_depth, problem: gn.BAProblem,
                config: gn.SolverConfig):
    """LM solve + per-landmark mean reprojection error (normalized
    plane) -> (state, inv_depth, final cost, scores [L])."""
    st, dep, info = gn.solve(state, inv_depth, problem, config)
    return st, dep, info.final_cost, _point_scores(st, dep, problem)


def solve_score_lines(state, inv_depth, problem: gn.BAProblem, line_orth,
                      config: gn.SolverConfig):
    """LinePoint's solve: the line-only refinement with the poses fixed
    (the reference's OptimizationWithOnlyLine), the joint LM with the
    line blocks, per-landmark and per-line scores. The problem carries
    the line table -> (state, inv_depth, cost, scores [L], orth [Lc,4],
    line scores [Lc])."""
    orth0 = line_factor.refine_orth(state, line_orth, problem.line_obs,
                                    problem.line_valid,
                                    huber_delta=config.huber_delta)
    st, dep, orth, info = gn.solve(state, inv_depth, problem, config,
                                   line_orth=orth0)
    return (st, dep, info.final_cost, _point_scores(st, dep, problem), orth,
            line_factor.line_scores(st, orth, problem.line_obs,
                                    problem.line_valid))


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


# ----------------------------------------------------------------------
# steady-state steps: one step a frame once the window is full. Each is
# a pure function of (branch, inputs); `branch` is whether the frame is
# a keyframe (marginalize the oldest frame) or not (drop the second
# newest), known on the host before the step runs. On the card the
# estimator replays each branch as a CUDA graph chain (StepGraph).
# ----------------------------------------------------------------------

class StepLayout:
    """Named sections of a flat step buffer: {name: (start, stop)}."""

    def __init__(self, sections):
        self.off = {}
        o = 0
        for name, n in sections:
            self.off[name] = (o, o + n)
            o += n
        self.size = o

    def get(self, buf, name, shape=None):
        a, b = self.off[name]
        return buf[a:b] if shape is None else buf[a:b].reshape(shape)

    def put(self, buf, name, value):
        a, b = self.off[name]
        buf[a:b] = np.ravel(value)


class StepConsts(NamedTuple):
    """What a steady-state step takes from the estimator's config."""

    num_frames: int
    lm_capacity: int
    obs_capacity: int
    imu_per_edge: int
    use_imu: bool
    max_depth: float
    outlier_thresh: float
    noise: pre.ImuNoise
    solver: gn.SolverConfig
    fixed: torch.Tensor          # [Dc] bool, tangent dims held fixed
    pose0: torch.Tensor          # [Dc] bool, pose 0's dims
    use_line: bool = False       # LinePoint: line sections in the buffers
    line_capacity: int = 64
    line_obs_capacity: int = 512

    def _line_sections(self, *names):
        """The line sections of a layout, empty without lines: l_of and
        l_oi are the observation rows, the rest are per line slot."""
        if not self.use_line:
            return []
        Lc, LoC = self.line_capacity, self.line_obs_capacity
        size = {"l_of": 4 * LoC, "l_oi": 3 * LoC, "l_ov": LoC,
                "l_orth": 4 * Lc, "l_orth_new": 4 * Lc, "orth": 4 * Lc}
        return [(n, size.get(n, Lc)) for n in names]

    def mega_layouts(self):
        """(float, int, output) layouts of the sequential megastep."""
        F, L, Co, C = (self.num_frames, self.lm_capacity,
                       self.obs_capacity, self.imu_per_edge)
        S = sum(layout._SIZES(F))
        ls = self._line_sections
        fl = StepLayout([("flat", S), ("acc", 3 * (C + 1)),
                         ("gyr", 3 * (C + 1)), ("dts", C), ("pnp", 6 * L),
                         ("tri_f", 6 * L), ("of", 9 * Co), ("inv", L),
                         ("pt0", 3 * L)] + ls("l_of", "l_orth"))
        il = StepLayout([("oi", 4 * Co), ("anchors", L), ("stereo", L),
                         ("two", L), ("tri_req", L), ("solv", L),
                         ("lmv", L), ("drop", L), ("ov", Co),
                         ("imu_n", F - 1), ("n_e", 1)]
                        + ls("l_oi", "l_ov", "l_lv"))
        ol = StepLayout([("flat", S), ("dep", L), ("new_tri", L),
                         ("bad", L), ("new_inv", L), ("re_ok", L)]
                        + ls("orth", "lscores") + [("cost", 1)])
        return fl, il, ol

    def pipe_layouts(self):
        """(float, int, output) layouts of the pipelined megastep."""
        F, L, C = self.num_frames, self.lm_capacity, self.imu_per_edge
        S = sum(layout._SIZES(F))
        ls = self._line_sections
        fl = StepLayout([("acc", 3 * (C + 1)), ("gyr", 3 * (C + 1)),
                         ("dts", C), ("acc_m", 3 * (C + 1)),
                         ("gyr_m", 3 * (C + 1)), ("dts_m", C),
                         ("tri_f", 6 * L), ("obs_new", 8 * L),
                         ("pt0", 3 * L), ("pt_a", 2 * L), ("pt_c", 2 * L)]
                        + ls("l_of", "l_orth_new"))
        il = StepLayout([(n, L) for n in (
            "anchors", "stereo", "two", "tri_req", "obs_ok", "cur_ok",
            "hasobs1", "reset", "kill", "ho_k", "hr_k", "emit")]
            + [("imu_n", F - 1), ("n_e", 1), ("n_m", 1)]
            + ls("l_oi", "l_ov", "l_reset", "l_kill"))
        ol = StepLayout([("flat", S), ("dep", L), ("new_tri", L),
                         ("bad", L), ("cost", 1), ("inv", L), ("dv", L)]
                        + ls("orth", "lscores", "l_alive"))
        return fl, il, ol


def _step_problem(c: StepConsts, oi, of, ov, pres, imu_valid, prior,
                  lm_valid):
    fixed = c.fixed
    if not c.use_imu:
        # visual-only: anchor the gauge on pose 0 until the prior takes
        # over
        fixed = fixed | (c.pose0 & ~prior.valid)
    return gn.BAProblem(obs=projection.unpack_obs(oi, of, ov), pres=pres,
                        imu_valid=imu_valid, prior=prior,
                        lm_valid=lm_valid, fixed_cols=fixed)


def _step_lines(c: StepConsts, f, i, b):
    """(LineObs, orth [Lc,4], line mask [Lc]) of a sequential step's
    buffers."""
    LoC, Lc = c.line_obs_capacity, c.line_capacity
    return (line_factor.unpack_obs(i("l_oi", (LoC, 3)), f("l_of", (LoC, 4)),
                                   b("l_ov")),
            f("l_orth", (Lc, 4)), b("l_lv"))


def _imu_valid(c: StepConsts, imu_n):
    return (imu_n > 0) & c.use_imu


def _marg_second_new_kept(prior, F):
    """Drop pose F-2 from the prior and shift it, where a prior exists."""
    pr2 = marg.shift_prior_after_slide_new(
        marg.marginalize_second_new(prior, F))
    return gn._select(prior.valid, pr2, prior)


def megastep(is_keyframe: bool, inputs, c: StepConsts):
    """The sequential steady-state frame as one step: IMU edge refresh,
    propagation and PnP refine -> triangulation of the candidates -> LM
    solve and outlier scores -> the outlier / negative-depth gate ->
    marginalization (frame 0 with the prior's shift and the depth
    re-anchoring, or the second-newest frame).

    inputs: (float buffer, int buffer, preintegrations, prior), the
    buffers laid out by `c.mega_layouts()`. Returns (preintegrations,
    prior, output buffer)."""
    fblob, iblob, pres, prior = inputs
    F, L, Co, C = c.num_frames, c.lm_capacity, c.obs_capacity, \
        c.imu_per_edge
    fl, il, _ = c.mega_layouts()
    f = lambda n, shape=None: fl.get(fblob, n, shape)
    i = lambda n, shape=None: il.get(iblob, n, shape)
    b = lambda n: i(n) != 0
    dev = fblob.device

    mask = torch.arange(C, device=dev) < i("n_e")
    pres2, flat2, _ = prepare_frame(
        f("flat"), pres, F - 2, f("acc", (C + 1, 3)), f("gyr", (C + 1, 3)),
        f("dts"), mask, F - 1, f("pnp", (L, 6)), F, c.noise)
    anchors = i("anchors")
    d, tok = triangulate_slots(flat2, anchors, f("tri_f", (L, 6)),
                               b("stereo"), b("two"), F - 1, F,
                               c.max_depth)
    new_tri = b("tri_req") & tok
    inv_depth = torch.where(new_tri, 1.0 / torch.clamp_min(d, 1e-6),
                            f("inv"))
    lm_valid = b("lmv") | (new_tri & b("solv"))
    oi, of = i("oi", (Co, 4)), f("of", (Co, 9))
    ov2 = b("ov") & lm_valid[oi[:, 3]]
    imu_valid = _imu_valid(c, i("imu_n"))
    problem = _step_problem(c, oi, of, ov2, pres2, imu_valid, prior,
                            lm_valid)
    state2 = layout.WindowState.unpack(flat2, F)
    line_out = []
    if c.use_line:
        l_obs, l_orth, l_lv = _step_lines(c, f, i, b)
        st, dep, cost, scores, orth, lscores = solve_score_lines(
            state2, inv_depth, problem._replace(line_obs=l_obs,
                                                line_valid=l_lv),
            l_orth, c.solver)
        line_out = [orth.reshape(-1), lscores]
    else:
        st, dep, cost, scores = solve_score(state2, inv_depth, problem,
                                            c.solver)

    # outlier + negative-depth gating before the marginalization (the
    # multi-dispatch path prunes the pools between the two)
    bad = ((scores > c.outlier_thresh) | (dep < 1e-4)) & lm_valid
    lm_valid_m = lm_valid & ~bad
    ov3 = ov2 & ~bad[oi[:, 3]]
    drop = b("drop") | (new_tri & (anchors == 0))
    if is_keyframe:
        prior_out, new_inv, re_ok = marg_old_shifted(
            st, dep, _step_problem(c, oi, of, ov3, pres2, imu_valid, prior,
                                   lm_valid_m),
            drop, f("pt0", (L, 3)), c.solver)
    else:
        prior_out = _marg_second_new_kept(prior, F)
        new_inv, re_ok = dep, torch.zeros_like(new_tri)
    dt = dep.dtype
    out = torch.cat([st.pack(), dep, new_tri.to(dt), bad.to(dt), new_inv,
                     re_ok.to(dt)] + line_out + [cost[None]])
    return pres2, prior_out, out


def compact_nonzero(mask, size: int):
    """(idx [size], n): the indices of mask's true entries in order,
    padded with 0, and their count, `jnp.nonzero(mask, size=size,
    fill_value=0)` with a fixed shape: a cumulative sum gives each true
    entry its slot, a scatter writes it there (entries past `size` go to
    a discarded slot). No host synchronization."""
    pos = torch.cumsum(mask.long(), 0) - 1
    slot = torch.where(mask & (pos < size), pos, size)
    out = torch.zeros(size + 1, dtype=torch.long, device=mask.device)
    out.scatter_(0, slot, torch.arange(mask.numel(), device=mask.device))
    return out[:size], pos[-1] + 1


class PipeState(NamedTuple):
    """The pipelined estimator's device-resident state."""

    flat: torch.Tensor           # packed window state
    inv: torch.Tensor            # [L] inverse depths
    dv: torch.Tensor             # [L] depth valid
    alive: torch.Tensor          # [L] slot active
    pres: pre.Preintegration     # [F-1] edges
    prior: prior_factor.MarginalPrior
    obs: tuple   # pools [L,F,2] pt, vel, pt_right, vel_right; [L,F] masks
    lines: tuple = ()   # LinePoint: (orth [Lc,4], alive [Lc])


def _with_col(t, j, col):
    t = t.clone()
    t[:, j] = col
    return t


def megastep_pipelined(is_keyframe: bool, inputs, c: StepConsts):
    """The steady-state frame against device-resident state: applies the
    host's lifecycle deltas ("reset wins"), builds the obs rows and the
    PnP pack on the device, runs the megastep's stages and then the
    window slide of both the state and the obs pools, so the next frame
    needs nothing back from this one.

    inputs: (float buffer, int buffer, PipeState), the buffers laid out
    by `c.pipe_layouts()`. Returns (PipeState after the slide, output
    buffer)."""
    fblob, iblob, res = inputs
    F, L, Co, C = c.num_frames, c.lm_capacity, c.obs_capacity, \
        c.imu_per_edge
    fl, il, _ = c.pipe_layouts()
    f = lambda n, shape=None: fl.get(fblob, n, shape)
    i = lambda n, shape=None: il.get(iblob, n, shape)
    b = lambda n: i(n) != 0
    dev, dt = fblob.device, fblob.dtype
    anchors = i("anchors")
    reset, kill = b("reset"), b("kill")

    # resident obs pools: lifecycle, then the new frame's column; rows
    # in the host's order (slot-major, frame, left before right)
    pt_r, vel_r, ptr_r, velr_r, ho_r, hr_r = res.obs
    clear = (kill | reset)[:, None]
    ho_r = _with_col(ho_r & ~clear, F - 1, b("ho_k"))
    hr_r = _with_col(hr_r & ~clear, F - 1, b("hr_k"))
    obs_new = f("obs_new", (L, 8))
    pt_r = _with_col(pt_r, F - 1, obs_new[:, 0:2])
    vel_r = _with_col(vel_r, F - 1, obs_new[:, 2:4])
    ptr_r = _with_col(ptr_r, F - 1, obs_new[:, 4:6])
    velr_r = _with_col(velr_r, F - 1, obs_new[:, 6:8])
    ff = torch.arange(F, device=dev)[None, :]
    emit = b("emit")[:, None]
    a_col = anchors[:, None]
    sel_l = emit & ho_r & (ff > a_col)
    sel_r = emit & hr_r & (ff >= a_col)
    idx, n_rows = compact_nonzero(
        torch.stack([sel_l, sel_r], dim=-1).reshape(-1), Co)
    ov = torch.arange(Co, device=dev) < n_rows
    s_i = idx // (2 * F)
    f_i = (idx // 2) % F
    c_i = idx % 2
    a_i = anchors[s_i]
    oi = torch.stack([a_i, f_i, c_i, s_i], dim=1)
    a_cl = torch.clamp(a_i, 0, F - 1)
    left = (c_i == 0)[:, None]
    of = torch.cat([pt_r[s_i, a_cl],
                    torch.where(left, pt_r[s_i, f_i], ptr_r[s_i, f_i]),
                    vel_r[s_i, a_cl],
                    torch.where(left, vel_r[s_i, f_i], velr_r[s_i, f_i]),
                    torch.zeros((Co, 1), dtype=dt, device=dev)], dim=1)

    # lifecycle deltas: a slot killed by the slide and allocated again
    # in the same frame is reset (reset wins)
    alive = (res.alive & ~kill) | reset
    dv = res.dv & ~(reset | kill)
    inv_depth = torch.where(reset | kill, 1.0 / DEFAULT_DEPTH, res.inv)

    # PnP pack from the resident depths and state
    st0 = layout.WindowState.unpack(res.flat, F)
    pts_ca = torch.cat([f("pt_a", (L, 2)),
                        torch.ones((L, 1), dtype=dt, device=dev)], dim=1) \
        / torch.clamp_min(inv_depth, 1e-6)[:, None]
    p_wc, q_wc = lie.pose_compose(st0.p[anchors], st0.q[anchors],
                                  st0.p_bc[0][None, :],
                                  st0.q_bc[0][None, :])
    pw = lie.quat_rotate(q_wc, pts_ca) + p_wc
    valid_pnp = b("cur_ok") & dv & alive
    pnp_pack = torch.cat([pw, f("pt_c", (L, 2)), valid_pnp[:, None].to(dt)],
                         dim=1)

    mask_new = torch.arange(C, device=dev) < i("n_e")
    pres2, flat2, _ = prepare_frame(
        res.flat, res.pres, F - 2, f("acc", (C + 1, 3)),
        f("gyr", (C + 1, 3)), f("dts"), mask_new, F - 1, pnp_pack, F,
        c.noise)
    gate = alive & ~dv
    d, tok = triangulate_slots(flat2, anchors, f("tri_f", (L, 6)),
                               b("stereo") & gate, b("two") & gate, F - 1,
                               F, c.max_depth)
    new_tri = b("tri_req") & tok & gate
    inv2 = torch.where(new_tri, 1.0 / torch.clamp_min(d, 1e-6), inv_depth)
    dv2 = dv | new_tri
    lm_valid = alive & dv2 & b("obs_ok")
    ov2 = ov & lm_valid[oi[:, 3]]
    imu_valid = _imu_valid(c, i("imu_n"))
    problem = _step_problem(c, oi, of, ov2, pres2, imu_valid, res.prior,
                            lm_valid)
    state2 = layout.WindowState.unpack(flat2, F)
    lines_out, line_out = (), []
    if c.use_line:
        # line lifecycle deltas -> the resident orth and alive mask; a
        # slot killed by the slide and triangulated again in one frame
        # is reset with the host's fresh orth (reset wins)
        l_reset, l_kill = b("l_reset"), b("l_kill")
        l_orth0, l_alive0 = res.lines
        l_alive = (l_alive0 & ~l_kill) | l_reset
        l_orth = torch.where(l_reset[:, None],
                             f("l_orth_new", (c.line_capacity, 4)), l_orth0)
        l_oi = i("l_oi", (c.line_obs_capacity, 3))
        l_obs = line_factor.unpack_obs(l_oi, f("l_of", (
            c.line_obs_capacity, 4)), b("l_ov") & l_alive[l_oi[:, 2]])
        st, dep, cost, scores, orth, lscores = solve_score_lines(
            state2, inv2, problem._replace(line_obs=l_obs,
                                           line_valid=l_alive),
            l_orth, c.solver)
        # the device's line outlier gate (the host applies the same
        # removal when it drains this frame)
        l_alive2 = l_alive & ~(lscores > LINE_OUTLIER_THRESH)
        lines_out = (orth, l_alive2)
        line_out = [orth.reshape(-1), lscores, l_alive2.to(dt)]
    else:
        st, dep, cost, scores = solve_score(state2, inv2, problem, c.solver)

    bad = ((scores > c.outlier_thresh) | (dep < 1e-4)) & lm_valid
    alive2 = alive & ~bad
    dv3 = dv2 & ~bad
    lm_valid_m = lm_valid & ~bad
    ov3 = ov2 & ~bad[oi[:, 3]]
    inv3 = torch.where(lm_valid_m, dep, inv2)
    if is_keyframe:
        drop = alive & (anchors == 0) & dv2
        prior_out, new_inv, re_ok = marg_old_shifted(
            st, dep, _step_problem(c, oi, of, ov3, pres2, imu_valid,
                                   res.prior, lm_valid_m),
            drop, f("pt0", (L, 3)), c.solver)
        sh = lambda a: torch.cat([a[1:], a[-1:]], dim=0)
        st4 = st._replace(p=sh(st.p), q=sh(st.q), v=sh(st.v),
                          ba=sh(st.ba), bg=sh(st.bg))
        # slide_old's depth re-anchoring
        sel = alive2 & (anchors == 0) & b("hasobs1") & dv3
        inv4 = torch.where(sel & re_ok, new_inv, inv3)
        dv4 = dv3 & ~(sel & ~re_ok)
        pres4 = roll_edges(pres2)
    else:
        prior_out = _marg_second_new_kept(res.prior, F)

        def cp(a):
            a = a.clone()
            a[F - 2] = a[F - 1]
            return a

        st4 = st._replace(p=cp(st.p), q=cp(st.q), v=cp(st.v),
                          ba=cp(st.ba), bg=cp(st.bg))
        # the merged edge F-3 (the host merges the raw samples)
        one_m = pre.preintegrate(
            f("acc_m", (C + 1, 3)), f("gyr_m", (C + 1, 3)), f("dts_m"),
            st.ba[F - 3], st.bg[F - 3], noise=c.noise,
            valid_mask=torch.arange(C, device=dev) < i("n_m"))
        pres4 = set_edge(pres2, F - 3, one_m)
        pres4 = set_edge(pres4, F - 2, pres4.map(lambda x: x[F - 2] * 0))
        inv4, dv4 = inv3, dv3

    # slide the obs pools as the state slid
    def slide_tbl(t):
        zero = torch.zeros_like(t[:, -1:])
        if is_keyframe:
            return torch.cat([t[:, 1:], zero], dim=1)
        return torch.cat([t[:, :F - 2], t[:, F - 1:], zero], dim=1)

    obs2 = tuple(slide_tbl(t) for t in
                 (pt_r, vel_r, ptr_r, velr_r, ho_r, hr_r))
    out = torch.cat([st.pack(), dep, new_tri.to(dt), bad.to(dt), cost[None],
                     inv4, dv4.to(dt)] + line_out)
    return PipeState(st4.pack(), inv4, dv4, alive2, pres4, prior_out,
                     obs2, lines_out), out


def _imu_midpoint(p, q, v, ba, bg, acc0, gyr0, acc1, gyr1, dt):
    """One midpoint IMU step on the host (the reference's fast-path
    propagation): rotation by the exact exponential of the mean rate,
    acceleration the mean of both samples' in the world frame."""
    g = np.array([0.0, 0.0, 9.81])
    un_acc0 = lie_np.quat_rotate(q, acc0 - ba) - g
    half = 0.5 * (0.5 * (gyr0 + gyr1) - bg) * dt
    dq = np.concatenate([[1.0], half])
    n2 = float(half @ half)
    if n2 > 1e-12:          # exact exp for non-tiny rotations
        theta = np.sqrt(n2)
        dq = np.concatenate([[np.cos(theta)], np.sin(theta) / theta * half])
    q = lie_np.quat_multiply(q, dq)
    q /= np.linalg.norm(q)
    un_acc1 = lie_np.quat_rotate(q, acc1 - ba) - g
    un_acc = 0.5 * (un_acc0 + un_acc1)
    return p + v * dt + 0.5 * un_acc * dt * dt, q, v + un_acc * dt


class _HostSlots:
    """Host buffers of a step: float and int inputs to fill and the
    output's landing buffer, pinned on the card. `depth` slots rotate;
    a slot is reused once its output landed, so an upload in flight is
    never overwritten."""

    class Slot(NamedTuple):
        f: torch.Tensor
        i: torch.Tensor
        o: torch.Tensor
        done: Optional[torch.cuda.Event]

    def __init__(self, layouts, dtype, on_card: bool, depth: int):
        fl, il, ol = layouts
        buf = lambda n, dt: torch.zeros(n, dtype=dt, pin_memory=on_card)
        self.slots = [self.Slot(buf(fl.size, dtype), buf(il.size, torch.long),
                                buf(ol.size, dtype),
                                torch.cuda.Event() if on_card else None)
                      for _ in range(depth)]
        self.n = 0

    def next(self):
        slot = self.slots[self.n % len(self.slots)]
        self.n += 1
        if slot.done is not None:
            slot.done.synchronize()
        return slot

    def send(self, slot, out):
        """Start the copy of a step's output buffer into the slot."""
        slot.o.copy_(out, non_blocking=slot.done is not None)
        if slot.done is not None:
            slot.done.record()

    def result(self, slot):
        """The slot's output as a numpy array of its own."""
        if slot.done is not None:
            slot.done.synchronize()
        return slot.o.numpy().copy()



class Estimator:
    def __init__(self, config: EstimatorConfig, p_bc, q_bc,
                 noise: pre.ImuNoise = pre.ImuNoise(), device=None):
        for name, item in _TODO.items():
            if getattr(config, name):
                raise NotImplementedError(
                    f"EstimatorConfig.{name} is not ported yet: ROADMAP "
                    f"{item}")
        self.cfg = config
        self.device = resolve_device(device)
        self.dtype = config.dtype or default_dtype(self.device)
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
        self._latest = None           # fast-prediction anchor state
        self._fast_buf = []           # IMU samples since the last frame
        self._outlier_scores_cache = None
        self._reanchored = None

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
        self._build_steps()
        self._mega_io = self._pipe_io = None
        self._pipe_res = None
        self._pipe_q = deque()
        self._pipe_tri_hist = deque(maxlen=2)
        # pipelined: the timestamps of the host mirror's window slots
        self._pipe_state_ts = None
        # pipelined LinePoint: the line mask sent with the last step
        self._pipe_lmask_prev = None
        # StageTimer for the steady state's stages (be.*), or None
        self.timer = None
        # LinePoint's line landmarks
        self.lines = LineManager(
            num_frames=F, capacity=config.line_capacity,
            obs_capacity=config.line_obs_capacity) \
            if config.use_line else None
        self.ex_calib = ExRotationCalibrator() \
            if config.calibrate_extrinsic_rotation else None
        # per-object backend (DYNAMIC), in the estimator's dtype
        self.im = None
        if config.dynamic:
            from dynamic_vins_tpu_torch.estimator.instance_manager import (
                InstanceConfig, InstanceManager)

            self.im = InstanceManager(InstanceConfig(num_frames=F,
                                                     dtype=self.dtype),
                                      device=self.device)

    def _build_steps(self):
        """The steady-state step functions for the current config: graph
        chains on the card, both branches captured at their first use
        (a new StepGraph captures anew)."""
        config, F = self.cfg, self.cfg.num_frames
        self._solver_cfg = gn.SolverConfig(
            max_iters=config.max_iters, use_imu=config.use_imu,
            huber_delta=config.huber_delta, line_weight=config.line_weight)
        c = StepConsts(F, config.lm_capacity, config.obs_capacity,
                       config.imu_per_edge, config.use_imu,
                       config.max_depth, config.outlier_thresh, self.noise,
                       self._solver_cfg, self._fixed, self._pose0_mask,
                       config.use_line, config.line_capacity,
                       config.line_obs_capacity)
        self._consts = c
        self._mega = StepGraph(functools.partial(megastep, c=c),
                               self.device, keys=(True, False))
        self._pipe = StepGraph(functools.partial(megastep_pipelined, c=c),
                               self.device, keys=(True, False))

    def _st(self, name: str):
        return self.timer.stage(name) if self.timer is not None \
            else contextlib.nullcontext()

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
    def process_frame(self, frame: FrameFeatures, imu_interval=None,
                      instances=None) -> Optional[OdometryOut]:
        """Ingest one frame (+ the IMU since the previous frame).

        frame.lines (LinePoint): {line id: (s_l, e_l, s_r|None, e_r|None)}
        normalized endpoints (z = 1). instances: the frame's per-object
        frontend output (DYNAMIC), in the `InstanceManager.push_frame`
        format."""
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
        if (self.ex_calib is not None and self.ex_calib.result is None
                and k > 0 and cfg.use_imu):
            self._calibrate_ex_rotation(k)
        if self.lines is not None and frame.lines:
            self.lines.add_lines(k, frame.lines)

        if cfg.use_megastep and self.initialized and k == F - 1:
            if cfg.pipelined:
                return self._megastep_frame_pipelined(is_keyframe,
                                                      instances)
            self._megastep_frame(is_keyframe, instances=instances)
            out = self._output(k)
            self._slide(is_keyframe)
            return out

        if k == 0:
            if cfg.use_imu and imu_interval is not None \
                    and not self._pose_preset:
                acc0 = np.mean(np.asarray(imu_interval[0]), axis=0)
                R0 = lie.g2R(torch.tensor(acc0, dtype=torch.float64))
                self.state.q[0] = lie.matrix_to_quat(R0).numpy()
        else:
            self._prepare(k)

        self._triangulate_new(k)
        if self.lines is not None:
            self.lines.triangulate(self.state, k)

        if not self.initialized and k == F - 1:
            self._initialize()
        if self.initialized:
            self._optimize()
            self._reject_outliers()
            self._check_failure()
        if self.im is not None and instances is not None:
            self._process_instances(k, instances)

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
        """Drain the pipelined frames in flight (outputs in order)."""
        outs = []
        while self._pipe_q:
            o = self._pipe_drain_one()
            if o is not None:
                outs.append(o)
        if self._pipe_res is not None:
            # the host's preintegration and prior follow the device
            # residents, as after every dispatch in the JAX package: a
            # loop correction, a checkpoint or a re-prime starts there
            self._pres, self.prior = self._own(
                (self._pipe_res.pres, self._pipe_res.prior))
        if self.im is not None:
            self.im._sync_pending()
        return outs

    # ------------------------------------------------------------------
    # steady state, sequential: one step a frame
    # ------------------------------------------------------------------
    def _own(self, tree):
        """A step's outputs as tensors of the caller's own: on the card
        they are the graph's static outputs, which the next replay
        overwrites."""
        if self._mega.on_card:
            return pytree.tree_map(torch.clone, tree)
        return tree

    def _megastep_frame(self, is_keyframe: bool, instances=None):
        """Window full and initialized: pack the host tables into the
        step's two input buffers, run the step (one graph chain on the
        card), fetch its output buffer, write back. In DYNAMIC mode the
        per-object pipeline runs between the step and the fetch, against
        the IMU-propagated pose of the newest frame (as the JAX package
        does while its solve is in flight)."""
        cfg = self.cfg
        fm = self.fm
        F = cfg.num_frames
        k, e = F - 1, F - 2
        fl, il, ol = self._consts.mega_layouts()
        if self._mega_io is None:
            self._mega_io = _HostSlots((fl, il, ol), self.dtype,
                                       self._mega.on_card, depth=1)

        with self._st("be.pack"):
            stereo_ok, two_ok, tri_f = self._tri_candidates(k)
            tri_req = stereo_ok | two_ok
            total_obs = fm.has_obs.sum(1) + fm.has_right.sum(1)
            solvable_if_tri = tri_req & (total_obs >= 2)
            oi, of, ov, lm_valid_base = fm.build_obs_packed(
                extra_mask=tri_req)
            drop_base = fm.active & (fm.start_frame == 0) & fm.depth_valid
            lmask = None
            if self.lines is not None:
                # new lines against the window's solved frames (slot k
                # is not solved yet); their rows ride the same buffers
                self.lines.triangulate(self.state, k - 1)
                l_oi, l_of, l_ov, lmask = self.lines.build_obs_packed()
            slot = self._mega_io.next()
            fb, ib = slot.f.numpy(), slot.i.numpy()
            for name, a in (("flat", self.state.pack()),
                            ("acc", self.imu_acc[e]),
                            ("gyr", self.imu_gyr[e]),
                            ("dts", self.imu_dt[e]),
                            ("pnp", self._pnp_pack(k)), ("tri_f", tri_f),
                            ("of", of), ("inv", fm.inv_depth),
                            ("pt0", fm.pt[:, 0])):
                fl.put(fb, name, a)
            for name, a in (("oi", oi), ("anchors", fm.start_frame),
                            ("stereo", stereo_ok), ("two", two_ok),
                            ("tri_req", tri_req), ("solv", solvable_if_tri),
                            ("lmv", lm_valid_base), ("drop", drop_base),
                            ("ov", ov), ("imu_n", self.imu_n),
                            ("n_e", self.imu_n[e])):
                il.put(ib, name, a)
            if lmask is not None:
                fl.put(fb, "l_of", l_of)
                fl.put(fb, "l_orth", self.lines.orth)
                il.put(ib, "l_oi", l_oi)
                il.put(ib, "l_ov", l_ov)
                il.put(ib, "l_lv", lmask)

        with self._st("be.step"):
            pres2, prior_out, out = self._mega(
                is_keyframe, (slot.f, slot.i, self._pres, self.prior))
            self._pres = self._own(pres2)
            prior_out = self._own(prior_out)
            self._mega_io.send(slot, out)
        if instances is not None and self.im is not None:
            self._process_instances(
                k, instances, ego_override=self._propagate_pose_host(k))
        with self._st("be.fetch"):
            ob = self._mega_io.result(slot)

        if not np.isfinite(float(ol.get(ob, "cost")[0])):
            self.failed = True
            return
        self.state = layout.WindowState.unpack(ol.get(ob, "flat").copy(),
                                               F)
        dep = ol.get(ob, "dep")
        new_tri = ol.get(ob, "new_tri") > 0.5
        fm.inv_depth[new_tri] = dep[new_tri]
        fm.depth_valid[new_tri] = True
        fm.set_depths(dep, valid_update=lm_valid_base
                      | (new_tri & solvable_if_tri))
        fm.remove_outliers(ol.get(ob, "bad") > 0.5)
        if lmask is not None:
            self.lines.set_orth(ol.get(ob, "orth").reshape(-1, 4),
                                updated_mask=lmask)
            self.lines.remove_outliers(ol.get(ob, "lscores"))
        self._check_failure()
        self.prior = prior_out
        if is_keyframe:
            self._reanchored = (None, ol.get(ob, "new_inv").copy(),
                                ol.get(ob, "re_ok") > 0.5)

    # ------------------------------------------------------------------
    # steady state, pipelined: device-resident state, 2 frames in flight
    # ------------------------------------------------------------------
    def _pipe_prime(self):
        """Push the host mirrors to the device residents (mode entry)."""
        fm = self.fm
        self._pipe_res = PipeState(
            self._f(self.state.pack()), self._f(fm.inv_depth),
            self._i(fm.depth_valid.copy()), self._i(fm.active.copy()),
            self._pres, self.prior,
            (self._f(fm.pt[:, :, :2]), self._f(fm.vel[:, :, :2]),
             self._f(fm.pt_right[:, :, :2]), self._f(fm.vel_right[:, :, :2]),
             self._i(fm.has_obs.copy()), self._i(fm.has_right.copy())),
            self._pipe_lines_prime())
        self._pipe_q.clear()
        self._pipe_tri_hist.clear()
        # at mode entry the mirror is fresh: its slots hold the solved
        # frames at the current timestamps
        self._pipe_state_ts = self.timestamps.copy()

    def _pipe_lines_prime(self):
        """LinePoint: the resident (orth, alive) from the host tables."""
        if self.lines is None:
            return ()
        lmask = self.lines.active & self.lines.orth_valid
        self._pipe_lmask_prev = lmask.copy()
        return self._f(self.lines.orth), self._i(lmask.copy())

    def _megastep_frame_pipelined(self, is_keyframe: bool, instances=None):
        """Dispatch this frame's step against the device residents, after
        draining the oldest in-flight frame if 2 are; returns that
        frame's output (its own timestamp) or None. In DYNAMIC mode the
        per-object pipeline then runs while the step is in flight, and
        the object tables slide with the host's window."""
        k = self.cfg.num_frames - 1
        fl, il, ol = self._consts.pipe_layouts()
        if self._pipe_res is None:
            self._pipe_prime()
        if self._pipe_io is None:
            # 2 frames in flight and 1 being packed
            self._pipe_io = _HostSlots((fl, il, ol), self.dtype,
                                       self._pipe.on_card, depth=3)

        out = None
        if len(self._pipe_q) >= 2:
            with self._st("be.drain"):
                out = self._pipe_drain_one()
            if self.failed:
                return out
        with self._st("be.pack"):
            slot, lmask = self._pipe_pack(is_keyframe, fl, il)
        with self._st("be.step"):
            self._pipe_res, dev_out = self._pipe(
                is_keyframe, (slot.f, slot.i, self._pipe_res))
            self._pipe_io.send(slot, dev_out)
        self._pipe_q.append((slot, float(self.timestamps[k]),
                             bool(is_keyframe), self.timestamps.copy(),
                             lmask))
        if self.im is not None:
            if instances is not None:
                self._process_instances_pipelined(instances)
            # the object tables follow the host's window, not the mirror
            if is_keyframe:
                self.im.slide_window()
            else:
                self.im.slide_window_new()
        self._slide_host_only(is_keyframe)
        return out

    def _pipe_pack(self, is_keyframe: bool, fl, il):
        """The next host slot, filled with this frame's step inputs: the
        host's hints and the raw samples. Returns (slot, the line mask
        sent, or None without lines)."""
        cfg = self.cfg
        fm = self.fm
        F = cfg.num_frames
        k, e = F - 1, F - 2
        L, C = cfg.lm_capacity, cfg.imu_per_edge

        # hints from the host mirrors (up to 2 frames stale; the device's
        # resident masks decide)
        new_slots = fm.last_new_slots.copy()
        kill = fm.last_slide_dead.copy()
        fm.last_slide_dead = np.zeros(L, bool)
        cur_ok = fm.active & fm.has_obs[:, k] & (fm.start_frame < k)
        total_obs = fm.has_obs.sum(1) + fm.has_right.sum(1)
        obs_ok = fm.active & (total_obs >= 2)
        anchors = fm.start_frame
        stereo_ok, two_ok, tri_f = self._tri_candidates(k)
        tri_req = stereo_ok | two_ok
        # rows also for slots hinted in the last 2 frames: the device may
        # have triangulated them in a step the mirror has not seen yet
        extra = tri_req.copy()
        for h in self._pipe_tri_hist:
            extra |= h
        self._pipe_tri_hist.append(tri_req.copy())

        # the merged edge of a non-keyframe slide (host raw samples)
        if is_keyframe:
            acc_m, gyr_m = np.zeros((C + 1, 3)), np.zeros((C + 1, 3))
            dts_m, n_m = np.zeros(C), 0
        else:
            acc_m, gyr_m, dts_m, n_m = self._merged_last_edges()

        slot = self._pipe_io.next()
        fb, ib = slot.f.numpy(), slot.i.numpy()
        obs_new = np.concatenate(
            [fm.pt[:, k, :2], fm.vel[:, k, :2], fm.pt_right[:, k, :2],
             fm.vel_right[:, k, :2]], axis=1)
        for name, a in (
                ("acc", self.imu_acc[e]), ("gyr", self.imu_gyr[e]),
                ("dts", self.imu_dt[e]), ("acc_m", acc_m), ("gyr_m", gyr_m),
                ("dts_m", dts_m), ("tri_f", tri_f), ("obs_new", obs_new),
                ("pt0", fm.pt[:, 0]),
                ("pt_a", fm.pt[np.arange(L), np.minimum(anchors, F - 1),
                               :2]),
                ("pt_c", fm.pt[:, k, :2])):
            fl.put(fb, name, a)
        for name, a in (
                ("anchors", anchors), ("stereo", stereo_ok),
                ("two", two_ok), ("tri_req", tri_req), ("obs_ok", obs_ok),
                ("cur_ok", cur_ok), ("hasobs1", fm.has_obs[:, 1]),
                ("reset", new_slots), ("kill", kill),
                ("ho_k", fm.has_obs[:, k]), ("hr_k", fm.has_right[:, k]),
                ("emit", fm.obs_emit_mask(extra_mask=extra)),
                ("imu_n", self.imu_n), ("n_e", self.imu_n[e]),
                ("n_m", n_m)):
            il.put(ib, name, a)
        lmask = None
        if self.lines is not None:
            # new lines against timestamp-aligned poses (the mirror lags
            # up to 2 frames; the solve's line-only refinement corrects a
            # slightly stale start), then the mask's change since the
            # last step as lifecycle deltas
            win = self._aligned_window_poses()
            if win is None:
                win = (self.state.p.copy(), self.state.q.copy())
            st = self.state._replace(p=win[0], q=win[1])
            self.lines.triangulate(st, k)
            l_oi, l_of, l_ov, lmask = self.lines.build_obs_packed()
            prev = self._pipe_lmask_prev
            self._pipe_lmask_prev = lmask.copy()
            fl.put(fb, "l_of", l_of)
            fl.put(fb, "l_orth_new", self.lines.orth)
            il.put(ib, "l_oi", l_oi)
            il.put(ib, "l_ov", l_ov)
            il.put(ib, "l_reset", lmask & ~prev)
            il.put(ib, "l_kill", prev & ~lmask)
        return slot, lmask

    def _pipe_drain_one(self) -> Optional[OdometryOut]:
        """Wait for the oldest in-flight frame; update the host mirrors."""
        fm = self.fm
        F = self.cfg.num_frames
        ol = self._consts.pipe_layouts()[2]
        slot, t_k, was_kf, ts_win, lmask = self._pipe_q.popleft()
        ob = self._pipe_io.result(slot)
        if not np.isfinite(float(ol.get(ob, "cost")[0])):
            self.failed = True
            return None
        if lmask is not None:
            # the solved orth of the lines alive at dispatch and still
            # alive; the device's outlier kills reach the host tables
            lm = self.lines
            alive = ol.get(ob, "l_alive") > 0.5
            lm.set_orth(ol.get(ob, "orth").reshape(-1, 4),
                        updated_mask=lmask & alive & lm.active)
            dead = lmask & ~alive & lm.active
            if dead.any():
                lm._remove(np.flatnonzero(dead))
        st3 = layout.WindowState.unpack(ol.get(ob, "flat").copy(), F)
        out = OdometryOut(timestamp=t_k, p=st3.p[F - 1].copy(),
                          q=st3.q[F - 1].copy(), v=st3.v[F - 1].copy())
        # the mirror: the drained frame's state after its slide, and the
        # timestamps of its slots (the instance pipeline aligns by them)
        ts_m = ts_win.copy()
        for a in (st3.p, st3.q, st3.v, st3.ba, st3.bg, ts_m):
            if was_kf:
                a[:-1] = a[1:].copy()
            else:
                a[F - 2] = a[F - 1]
        self.state = st3
        self._pipe_state_ts = ts_m
        # landmark mirrors are slot-indexed: the slide does not move them
        fm.inv_depth[:] = ol.get(ob, "inv")
        fm.depth_valid[:] = (ol.get(ob, "dv") > 0.5) & fm.active
        fm.remove_outliers(ol.get(ob, "bad") > 0.5)
        self._check_failure()
        self._latest = {
            "t": t_k, "p": out.p.copy(), "q": out.q.copy(),
            "v": out.v.copy(), "ba": st3.ba[F - 1].copy(),
            "bg": st3.bg[F - 1].copy(), "acc": self._acc0.copy(),
            "gyr": self._gyr0.copy()}
        self._fast_buf = [s for s in self._fast_buf if s[0] > t_k]
        return out

    def _slide_host_only(self, old: bool):
        """The host bookkeeping of a slide; the pipelined step slid the
        device residents (state, depths, preintegrations, prior, pools)."""
        cfg = self.cfg
        F = cfg.num_frames
        if old:
            # the depths arrive with the drain
            self.fm.slide_old(lambda slots: self.fm.inv_depth[slots])
            if self.lines is not None:
                self.lines.slide_old()
            self.timestamps[:-1] = self.timestamps[1:].copy()
            for a in (self.imu_acc, self.imu_gyr, self.imu_dt, self.imu_n):
                a[:-1] = a[1:].copy()
            self.imu_n[-1] = 0
            self.imu_dt[-1] = 0
        else:
            self.timestamps[F - 2] = self.timestamps[F - 1]
            self._merge_last_edges()
            self.fm.slide_new()
            if self.lines is not None:
                self.lines.slide_new()
        self.frame_count = F - 1

    def _merged_last_edges(self):
        """Edge F-3's samples with edge F-2's appended, as a non-keyframe
        slide merges them: copies (acc [C+1,3], gyr, dts [C], count)."""
        F, C = self.cfg.num_frames, self.cfg.imu_per_edge
        e2, e1 = F - 3, F - 2
        n2, n1 = int(self.imu_n[e2]), int(self.imu_n[e1])
        take = max(min(n1, C - n2), 0)
        acc, gyr, dts = (a[e2].copy()
                         for a in (self.imu_acc, self.imu_gyr, self.imu_dt))
        acc[n2 + 1:n2 + take + 1] = self.imu_acc[e1, 1:take + 1]
        gyr[n2 + 1:n2 + take + 1] = self.imu_gyr[e1, 1:take + 1]
        dts[n2:n2 + take] = self.imu_dt[e1, :take]
        return acc, gyr, dts, n2 + take

    def _merge_last_edges(self):
        """Append edge F-2's samples to edge F-3 (a non-keyframe slide)."""
        e2, e1 = self.cfg.num_frames - 3, self.cfg.num_frames - 2
        (self.imu_acc[e2], self.imu_gyr[e2], self.imu_dt[e2],
         self.imu_n[e2]) = self._merged_last_edges()
        self.imu_n[e1] = 0
        self.imu_dt[e1] = 0

    def _prepare(self, k):
        cfg = self.cfg
        e = min(k - 1, cfg.num_frames - 2)
        pres2, flat, _ = prepare_frame(
            self._f(self.state.pack()), self._pres, e,
            self._f(self.imu_acc[e]), self._f(self.imu_gyr[e]),
            self._f(self.imu_dt[e]), self._edge_mask(e), k,
            self._f(self._pnp_pack(k)), cfg.num_frames, self.noise)
        self._pres = pres2
        self.state = self._unpack_host(flat)

    def _pnp_pack(self, k):
        """[L,6] PnP rows for frame k: world point, normalized obs, valid
        (all zero below 6 correspondences)."""
        fm = self.fm
        pnp_pack = np.zeros((self.cfg.lm_capacity, 6))
        slots = np.flatnonzero(fm.active & fm.depth_valid
                               & fm.has_obs[:, k] & (fm.start_frame < k))
        if slots.size >= 6:
            pnp_pack[:slots.size, 0:3] = \
                self._landmark_world_positions(slots)
            pnp_pack[:slots.size, 3:5] = fm.pt[slots, k, :2]
            pnp_pack[:slots.size, 5] = 1.0
        return pnp_pack

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
        stereo_ok, two_ok, tri_f = self._tri_candidates(k)
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

    def _tri_candidates(self, k):
        """Slots to triangulate at frame k: (stereo_ok [L], two_ok [L],
        tri_f [L,6] = anchor left xy, anchor right xy, frame-k xy)."""
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
        return stereo_ok, two_ok, tri_f

    def _initialize(self):
        """Initialization dispatch: mono+IMU by SfM and visual-inertial
        alignment (`_initialize_mono`); else stereo(+IMU): gyro bias from
        visual vs preintegrated rotations, finite-difference
        velocities."""
        cfg = self.cfg
        if not cfg.stereo and cfg.use_imu:
            if self._initialize_mono():
                self.initialized = True
            return
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

    def _calibrate_ex_rotation(self, k: int):
        """Push one hand-eye rotation pair (frame k-1 -> k) and solve
        again; on convergence the calibrated q_bc goes into the window
        state, which every later stage reads."""
        fm = self.fm
        mask = fm.active & fm.has_obs[:, k - 1] & fm.has_obs[:, k]
        if mask.sum() < 15 or self.imu_n[k - 1] == 0:
            return
        rel = ini.solve_relative_pose(fm.pt[mask, k - 1, :2],
                                      fm.pt[mask, k, :2])
        if rel is None:
            return
        q_c = lie_np.matrix_to_quat(rel[0])   # camera k in camera k-1
        # gyro-only body delta from the host IMU buffers (the
        # preintegrations are refreshed later in the frame)
        e = min(k - 1, self.cfg.num_frames - 2)
        bg = self.state.bg[e]
        q_b = np.array([1.0, 0.0, 0.0, 0.0])
        for i in range(int(self.imu_n[e])):
            w_mid = 0.5 * (self.imu_gyr[e, i] + self.imu_gyr[e, i + 1]) - bg
            dq = np.concatenate([[1.0], 0.5 * w_mid * self.imu_dt[e, i]])
            q_b = lie_np.quat_multiply(q_b, dq / np.linalg.norm(dq))
        self.ex_calib.push(q_b, q_c)
        q_bc, conv = self.ex_calib.solve()
        if conv:
            self.state.q_bc[0] = q_bc

    def _initialize_mono(self) -> bool:
        """Mono+IMU: the reference frame by parallax and the essential
        matrix, SfM over the window, the gyro bias from the SfM
        rotations, the linear gravity / velocity / scale alignment, the
        world frame from gravity, and the window's poses, velocities and
        depths in it. Host work, once; False leaves the window
        uninitialized (it slides and tries again next frame)."""
        cfg = self.cfg
        F = cfg.num_frames
        fm = self.fm
        obs = {}        # {feature id: {frame: normalized xy}}
        for sl in np.flatnonzero(fm.active):
            fid = int(fm.feature_id[sl])
            for f in np.flatnonzero(fm.has_obs[sl]):
                obs.setdefault(fid, {})[int(f)] = fm.pt[sl, f, :2]

        # reference: the earliest frame with enough parallax to the newest
        # (30 px at the reference's focal length of 460, in normalized
        # units) and an essential matrix
        ref = rel = None
        for l in range(F - 1):
            both = [fo for fo in obs.values() if l in fo and F - 1 in fo]
            if len(both) < 20:
                continue
            pts_i = np.asarray([fo[l] for fo in both])
            pts_j = np.asarray([fo[F - 1] for fo in both])
            par = np.mean(np.linalg.norm(pts_i - pts_j, axis=-1))
            if par < 30.0 / 460.0:
                continue
            rel = ini.solve_relative_pose(pts_i, pts_j)
            if rel is not None:
                ref = l
                break
        if rel is None:
            return False
        ok, R_sfm, p_sfm, _ = ini.sfm_construct(F, obs, ref, rel[0], rel[1])
        if not ok:
            return False

        # gyro bias from the SfM rotations (camera frame -> body frame)
        R_bc = lie_np.quat_to_matrix(np.asarray(self.state.q_bc[0], float))
        p_bc = np.asarray(self.state.p_bc[0], float)
        R_c0b = [R_sfm[k] @ R_bc.T for k in range(F)]
        q_rel = np.stack([lie.matrix_to_quat(torch.as_tensor(
            R_c0b[k].T @ R_c0b[k + 1])).numpy() for k in range(F - 1)])
        dbg = triangulation.solve_gyro_bias(
            self._pres.dq_dbg[:F - 1], self._pres.delta_q[:F - 1],
            self._f(q_rel))
        dbg = self._host(torch.where(torch.isfinite(dbg), dbg, 0.0))
        self.state.bg[:] = self.state.bg + dbg[None, :]
        self._pres = self._preintegrate_all()
        pres = self._pres.map(lambda a: a.detach().cpu().double().numpy())

        # linear alignment: velocities, gravity (c0 frame), scale
        pres_list = [dict(delta_p=pres.delta_p[k], delta_v=pres.delta_v[k])
                     for k in range(F - 1)]
        dt_edges = [float(pres.sum_dt[k]) for k in range(F - 1)]
        p_sfm = [np.asarray(p) for p in p_sfm]
        ok2, _, g_c0, _ = ini.solve_gravity_velocity_scale(
            pres_list, R_c0b, p_sfm, p_bc, dt_edges)
        if not ok2:
            return False
        v_body, g_c0, s = ini.refine_gravity(pres_list, R_c0b, p_sfm, p_bc,
                                             dt_edges, g_c0)

        # world frame: gravity-aligned, yaw-free, origin at body 0
        R_w_c0 = lie.g2R(torch.as_tensor(g_c0)).numpy()
        p_b_c0 = [s * p_sfm[k] - R_c0b[k] @ p_bc for k in range(F)]
        st = self.state
        for k in range(F):
            R_wb = R_w_c0 @ R_c0b[k]
            st.p[k] = R_w_c0 @ (p_b_c0[k] - p_b_c0[0])
            st.q[k] = lie.matrix_to_quat(torch.as_tensor(R_wb)).numpy()
            st.v[k] = R_wb @ v_body[k]

        # depths against the metric poses
        fm.depth_valid[:] = False
        self._triangulate_new(F - 1)
        return True

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
        problem = self._problem(oi, of, ov, lm_valid)
        lm = self.lines
        if lm is not None and (lm.active & lm.orth_valid).any():
            self._optimize_lines(problem)
            return
        st, dep, cost, scores = solve_score(
            self._state_dev(), self._f(self.fm.inv_depth), problem,
            self._solver_cfg)
        self._outlier_scores_cache = (self._host(scores), lm_valid)
        if not np.isfinite(float(cost)):
            self.failed = True
            return
        self.state = self._unpack_host(st.pack())
        self.fm.set_depths(self._host(dep))

    def _optimize_lines(self, problem):
        """The multi-dispatch solve with lines: the line-only refinement,
        the joint LM, then the line outlier removal at the solution. As
        in the JAX package, this path scores no point outliers."""
        line_obs, line_valid = self.lines.build_obs_table(self.dtype,
                                                          self.device)
        problem = problem._replace(line_obs=line_obs, line_valid=line_valid)
        st0 = self._state_dev()
        orth0 = line_factor.refine_orth(
            st0, self._f(self.lines.orth), line_obs, line_valid,
            huber_delta=self._solver_cfg.huber_delta)
        st, dep, orth, info = gn.solve(st0, self._f(self.fm.inv_depth),
                                       problem, self._solver_cfg,
                                       line_orth=orth0)
        if not np.isfinite(float(info.final_cost)):
            self.failed = True
            return
        self.state = self._unpack_host(st.pack())
        self.fm.set_depths(self._host(dep))
        self.lines.set_orth(self._host(orth))
        scores = line_factor.line_scores(self._state_dev(),
                                         self._f(self.lines.orth), line_obs)
        self.lines.remove_outliers(self._host(scores))

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
            if self.lines is not None:
                self.lines.slide_old()
        else:
            F2, F1 = F - 2, F - 1
            for a in (st.p, st.q, st.v, st.ba, st.bg):
                a[F2] = a[F1]
            self.timestamps[F2] = self.timestamps[F1]
            e2, e1 = F - 3, F - 2
            self._merge_last_edges()
            self._refresh_edge(e2)
            self._pres = set_edge(self._pres, e1,
                                  self._pres.map(lambda x: x[e1] * 0))
            self.fm.slide_new()
            if self.lines is not None:
                self.lines.slide_new()
        if self.im is not None:
            # object per-frame data follows the ego window's move
            # (Instance::SlideWindow / SlideWindowNew)
            if old:
                self.im.slide_window()
            else:
                self.im.slide_window_new()
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
    # DYNAMIC: the per-object pipeline
    # ------------------------------------------------------------------
    def _propagate_pose_host(self, k):
        """Predicted pose of slot k before its solve lands: host midpoint
        IMU propagation of frame k-1's state across edge k-1."""
        st = self.state
        p, q, _v = self._propagate_edge_host(
            st.p[k - 1], st.q[k - 1], st.v[k - 1], st.ba[k - 1],
            st.bg[k - 1], k - 1)
        return p, q

    def _propagate_edge_host(self, p, q, v, ba, bg, e):
        """Host midpoint IMU propagation across edge e's raw buffer.
        Returns (p, q, v)."""
        p = np.array(p, float)
        q = np.array(q, float)
        v = np.array(v, float)
        n = int(self.imu_n[e])
        if n <= 0 or not self.cfg.use_imu:
            return p, q, v
        ba = np.asarray(ba)
        bg = np.asarray(bg)
        acc, gyr, dts = self.imu_acc[e], self.imu_gyr[e], self.imu_dt[e]
        for i in range(n):
            dt = float(dts[i])
            if dt > 0.0:
                p, q, v = _imu_midpoint(p, q, v, ba, bg, acc[i], gyr[i],
                                        acc[i + 1], gyr[i + 1], dt)
        return p, q, v

    def _aligned_window_poses(self):
        """Pipelined: window poses aligned to the host's timestamps while
        the state mirror lags the dispatched frames. A slot whose
        timestamp the mirror holds takes the mirror's solved pose; the
        slots after the newest such anchor (the 1-2 frames in flight)
        are IMU-predicted from it across the raw edge buffers. Returns
        (p_win [F,3], q_win [F,4]), or None if no slot matched."""
        F = self.cfg.num_frames
        st = self.state
        M_ts = self._pipe_state_ts
        p_win = np.array(st.p)
        q_win = np.array(st.q)
        matched = np.full(F, -1, np.int64)
        for j in range(F):
            m = np.flatnonzero(np.abs(M_ts[:F - 1] - self.timestamps[j])
                               < 1e-9)
            if m.size:
                i = int(m[-1])
                p_win[j] = st.p[i]
                q_win[j] = st.q[i]
                matched[j] = i
        anc = np.flatnonzero(matched >= 0)
        if not anc.size:
            return None
        a = int(anc[-1])
        i0 = int(matched[a])
        p, q, v = st.p[i0], st.q[i0], st.v[i0]
        ba, bg = st.ba[i0], st.bg[i0]
        for j in range(a + 1, F):
            p, q, v = self._propagate_edge_host(p, q, v, ba, bg, j - 1)
            p_win[j] = p
            q_win[j] = q
        return p_win, q_win

    def _process_instances_pipelined(self, instances):
        """The per-object pipeline against the pipelined ego path: the
        object tables are frame-synchronous with the host's timestamps,
        the state mirror lags them by up to 2 slides, so the window
        poses are aligned by timestamp (`_aligned_window_poses`).
        Without a mirror yet, frame k's pose is IMU-propagated from
        frame k-1; with no slot aligned, the frame is skipped."""
        k = self.cfg.num_frames - 1
        if self._pipe_state_ts is None:
            self._process_instances(
                k, instances, ego_override=self._propagate_pose_host(k))
            return
        win = self._aligned_window_poses()
        if win is None:
            return
        p_win, q_win = win
        self._process_instances(k, instances,
                                ego_override=(p_win[k], q_win[k]),
                                window_override=win)

    def _process_instances(self, k, instances, ego_override=None,
                           window_override=None):
        """Per-object pipeline for frame k (estimator.cpp:1577-1622:
        PushBack -> PropagatePose -> Triangulate -> InitialInstance ->
        InitialInstanceVelocity -> SetDynamicOrStatic -> Optimization).

        ego_override: (p, q) predicted pose of frame k while its ego
        solve has not landed (the megastep); it also stands in for slot
        k of the window poses the outlier test and the solve see.
        window_override: (p_win, q_win) window poses to use instead
        (pipelined: `_aligned_window_poses`)."""
        with self._st("be.inst"):
            st = self.state
            im = self.im
            if ego_override is not None:
                ego_p, ego_q = (np.asarray(ego_override[0]),
                                np.asarray(ego_override[1]))
            else:
                ego_p = np.asarray(st.p[k])
                ego_q = np.asarray(st.q[k])
            p_bc0 = np.asarray(st.p_bc[0])
            q_bc0 = np.asarray(st.q_bc[0])
            im.push_frame(k, instances, ego_p, ego_q, p_bc0, q_bc0)
            times = self.timestamps
            im.propagate_pose(k, times)
            im.initialize_instances(k)
            im.triangulate(k, ego_p, ego_q, p_bc0, q_bc0,
                           (np.asarray(st.p_bc[1]), np.asarray(st.q_bc[1])))
            im.init_velocity(k, times)
            im.classify_motion(k, times)
            if self.initialized:
                if window_override is not None:
                    p_win, q_win = (np.asarray(window_override[0]),
                                    np.asarray(window_override[1]))
                else:
                    p_win = np.array(st.p)
                    q_win = np.array(st.q)
                    if ego_override is not None:
                        p_win[k] = ego_p
                        q_win[k] = ego_q
                p_wc, q_wc = lie_np.pose_compose(
                    p_win[:, None, :], q_win[:, None, :],
                    np.asarray(st.p_bc)[None, :, :],
                    np.asarray(st.q_bc)[None, :, :])
                p_cw, q_cw = lie_np.pose_inverse(p_wc, q_wc)
                # against the previous frame's solution, with the
                # CURRENT window's camera poses
                im.reject_outliers(p_cw=p_cw, q_cw=q_cw)
                im.optimize(times, p_cw, q_cw)
            im.manage()

    def get_instance_states(self):
        """Snapshot of the per-object states (GetOutputInstInfo), after
        the dispatched object solve is applied (the JAX package's
        `get_instance_states(sync=True)`)."""
        return {} if self.im is None else self.im.output()

    # ------------------------------------------------------------------
    def _output(self, k) -> OdometryOut:
        st = self.state
        self._update_latest(k)
        return OdometryOut(timestamp=float(self.timestamps[k]),
                           p=st.p[k].copy(), q=st.q[k].copy(),
                           v=st.v[k].copy())

    # ------------------------------------------------------------------
    # IMU-rate odometry between frames (FastPredictIMU, re-anchored by
    # UpdateLatestStates at each frame)
    # ------------------------------------------------------------------
    def _update_latest(self, k):
        """Anchor the fast prediction at the newest solved frame and
        replay the IMU samples newer than it. Host numpy only; none
        before initialization (the window is not aligned yet)."""
        st = self.state
        t_k = float(self.timestamps[k])
        if not self.initialized:
            self._latest = None
            self._fast_buf = []
            return
        self._latest = {
            "t": t_k, "p": st.p[k].copy(), "q": st.q[k].copy(),
            "v": st.v[k].copy(), "ba": st.ba[k].copy(),
            "bg": st.bg[k].copy(),
            "acc": self._acc0.copy(), "gyr": self._gyr0.copy()}
        buf = [s for s in self._fast_buf if s[0] > t_k]
        self._fast_buf = []
        for t, acc, gyr in buf:
            self.fast_predict(t, acc, gyr)

    def fast_predict(self, t, acc, gyr) -> Optional[OdometryOut]:
        """Propagate the latest solved state through one IMU sample
        (midpoint rule) for IMU-rate odometry between frames; None
        before the first anchor and for a sample not newer than the
        last one."""
        if self._latest is None:
            return None
        L = self._latest
        acc = np.asarray(acc, float)
        gyr = np.asarray(gyr, float)
        dt = float(t) - L["t"]
        if dt <= 0.0:
            return None
        L["p"], L["q"], L["v"] = _imu_midpoint(
            L["p"], L["q"], L["v"], L["ba"], L["bg"], L["acc"], L["gyr"],
            acc, gyr, dt)
        L["t"] = float(t)
        L["acc"], L["gyr"] = acc, gyr
        self._fast_buf.append((float(t), acc, gyr))
        return OdometryOut(timestamp=float(t), p=L["p"].copy(),
                           q=L["q"].copy(), v=L["v"].copy())

    def apply_loop_correction(self, p_vio, q_vio, p_corr, q_corr):
        """Re-anchor the live window on an accepted loop closure.

        (p_vio, q_vio): the VIO pose of a reference instant (a loop
        keyframe); (p_corr, q_corr): its pose-graph-corrected pose. The
        4-DOF world correction (yaw and translation; pitch and roll are
        observable through gravity and stay) moves the window, the
        marginal prior's linearization point, the fast-prediction anchor,
        the world-frame line landmarks and the object tables. Depths are
        frame-anchored and move with the window. Returns the pipelined frames drained first (the
        device residents are primed again from the corrected mirrors at
        the next frame)."""
        outs = self.flush() if self._pipe_q else []
        self._pipe_res = None

        def yaw_of(q):
            R = lie_np.quat_to_matrix(np.asarray(q, float))
            return float(np.arctan2(R[1, 0], R[0, 0]))

        dyaw = yaw_of(q_corr) - yaw_of(q_vio)
        c, s = np.cos(dyaw), np.sin(dyaw)
        R_c = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        q_c = np.array([np.cos(dyaw / 2), 0.0, 0.0, np.sin(dyaw / 2)])
        t_c = np.asarray(p_corr, float) - R_c @ np.asarray(p_vio, float)
        tf_p = lambda p: p @ R_c.T + t_c
        tf_q = lambda q: lie_np.quat_multiply(
            np.broadcast_to(q_c, np.shape(q)), q)

        st = self.state
        st.p[:] = tf_p(st.p)
        st.q[:] = tf_q(st.q)
        st.v[:] = st.v @ R_c.T
        ls = self.prior.lin_state
        h = lambda a: a.detach().cpu().double().numpy()
        self.prior = self.prior._replace(lin_state=ls._replace(
            p=self._f(tf_p(h(ls.p))), q=self._f(tf_q(h(ls.q))),
            v=self._f(h(ls.v) @ R_c.T)))
        if self._latest is not None:
            L = self._latest
            L["p"] = R_c @ L["p"] + t_c
            L["q"] = lie_np.quat_multiply(q_c, L["q"])
            L["v"] = R_c @ L["v"]
        if self.lines is not None:
            from dynamic_vins_tpu_torch.geometry import lines as lg

            lm = self.lines
            for slot in np.flatnonzero(lm.active & lm.orth_valid):
                n_w, d_w = (x.numpy() for x in lg.orth_to_plucker(
                    torch.tensor(lm.orth[slot], dtype=torch.float64)))
                d2 = R_c @ d_w
                lm.orth[slot] = plucker_to_orth_np(
                    R_c @ n_w + np.cross(t_c, d2), d2)
        if self.im is not None:
            im = self.im
            im._sync_pending()         # world-frame tables move rigidly
            act = np.flatnonzero(im.active)
            if act.size:
                im.p[act] = tf_p(im.p[act])
                im.q[act] = tf_q(im.q[act])
                im.v[act] = im.v[act] @ R_c.T
                im.q_det[act] = tf_q(im.q_det[act])
                im.extra[act] = tf_p(im.extra[act])
        return outs

    def set_initial_pose(self, p, q, v=None):
        """Anchor the world frame (otherwise gravity-aligned, yaw-free)."""
        self.state.p[0] = np.asarray(p)
        self.state.q[0] = np.asarray(q)
        if v is not None:
            self.state.v[0] = np.asarray(v)
        self._pose_preset = True

    # ------------------------------------------------------------------
    # checkpoint / resume: one .npz with the JAX package's keys, so a
    # checkpoint moves between the two packages in either direction
    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str):
        """Snapshot the estimator's state to one .npz file (a pipelined
        estimator drains its frames in flight first)."""
        if self._pipe_q:
            self.flush()
        fm = self.fm
        h = lambda t: t.detach().cpu().numpy()
        prior = self.prior
        np.savez_compressed(
            path,
            state=np.array([], dtype=np.float64),  # marker
            **{f"st_{k}": np.asarray(v)
               for k, v in self.state._asdict().items()},
            **{f"prior_ls_{k}": h(v)
               for k, v in prior.lin_state._asdict().items()},
            prior_jacobian=h(prior.jacobian),
            prior_residual=h(prior.residual), prior_valid=h(prior.valid),
            **{f"pres_{i}": h(v) for i, v in enumerate(self._pres)},
            fm_active=fm.active, fm_feature_id=fm.feature_id,
            fm_start_frame=fm.start_frame, fm_has_obs=fm.has_obs,
            fm_has_right=fm.has_right, fm_pt=fm.pt,
            fm_pt_right=fm.pt_right, fm_vel=fm.vel,
            fm_vel_right=fm.vel_right, fm_inv_depth=fm.inv_depth,
            fm_depth_valid=fm.depth_valid,
            imu_acc=self.imu_acc, imu_gyr=self.imu_gyr,
            imu_dt=self.imu_dt, imu_n=self.imu_n,
            timestamps=self.timestamps,
            meta=np.array([self.frame_count, int(self.initialized),
                           int(self.failed), int(self._pose_preset)]))

    def load_checkpoint(self, path: str):
        """Restore a snapshot of `save_checkpoint` (of either package),
        in this estimator's dtype and on its device. The captured step
        graphs read the estimator's tensors through static copies made
        at every step, so the next step runs on the restored state; a
        pipelined estimator primes its device residents from it."""
        z = np.load(path, allow_pickle=False)
        if z["st_p"].shape[0] != self.cfg.num_frames:
            raise ValueError(f"{path}: a window of {z['st_p'].shape[0]} "
                             f"frames, this estimator's is "
                             f"{self.cfg.num_frames}")
        host_dt = self.state.p.dtype
        self.state = layout.WindowState(
            **{k: np.array(z[f"st_{k}"], dtype=host_dt)
               for k in layout.WindowState._fields})
        self.prior = prior_factor.MarginalPrior(
            lin_state=layout.WindowState(
                **{k: self._f(z[f"prior_ls_{k}"])
                   for k in layout.WindowState._fields}),
            jacobian=self._f(z["prior_jacobian"]),
            residual=self._f(z["prior_residual"]),
            valid=self._i(np.asarray(z["prior_valid"], bool)))
        self._pres = pre.Preintegration(
            *(self._f(z[f"pres_{i}"])
              for i in range(len(pre.Preintegration._fields))))
        fm = self.fm
        for name in ("active", "feature_id", "start_frame", "has_obs",
                     "has_right", "pt", "pt_right", "vel", "vel_right",
                     "inv_depth", "depth_valid"):
            setattr(fm, name, np.array(z[f"fm_{name}"],
                                       dtype=getattr(fm, name).dtype))
        fm._id_to_slot = {int(f): int(s) for s, f in
                          enumerate(fm.feature_id) if f >= 0}
        self.imu_acc = np.array(z["imu_acc"])
        self.imu_gyr = np.array(z["imu_gyr"])
        self.imu_dt = np.array(z["imu_dt"])
        self.imu_n = np.array(z["imu_n"], dtype=np.int32)
        self.timestamps = np.array(z["timestamps"])
        meta = z["meta"]
        self.frame_count = int(meta[0])
        self.initialized = bool(meta[1])
        self.failed = bool(meta[2])
        self._pose_preset = bool(meta[3])
        self._pipe_res = None
        self._pipe_q.clear()
        self._latest = None
        self._fast_buf = []

    def reset(self):
        """Clear the state and restart with the same calibration (the
        reference's ClearState + restart)."""
        p_bc, q_bc = self.state.p_bc.copy(), self.state.q_bc.copy()
        timer = self.timer
        self.__init__(self.cfg, p_bc, q_bc, self.noise, self.device)
        self.timer = timer

    def change_sensor_type(self, use_imu: bool, use_stereo: bool) -> bool:
        """Runtime sensor reconfiguration (the reference's
        ChangeSensorType): both sensors off is refused; turning the IMU
        on restarts (the window was built without speed/bias states);
        turning it off drops the marginal prior (it conditions on the
        speed/bias blocks no longer estimated) and the steady step is
        captured anew; stereo only gates whether right observations are
        ingested from the next frame on. Returns True if applied."""
        cfg = self.cfg
        if not use_imu and not use_stereo:
            return False
        if self._pipe_q:
            raise RuntimeError("flush the pipelined frames in flight "
                               "before changing sensors")
        restart = False
        if cfg.use_imu != bool(use_imu):
            cfg.use_imu = bool(use_imu)
            if cfg.use_imu:
                restart = True
            else:
                self.prior = prior_factor.MarginalPrior.empty(
                    cfg.num_frames, self.dtype, self.device)
                self._pipe_res = None
                self._build_steps()
        cfg.stereo = bool(use_stereo)
        if restart:
            self.reset()
        return True
