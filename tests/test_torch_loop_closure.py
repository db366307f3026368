"""Port parity: loop closure (`loop/closure.py`) against the JAX
package's, on tests/test_loop_closure.py's circle scene (25 keyframes
rendered at 376x240 with their depth, the last pose equal to the first,
the simulated VIO drift of 3.5 and 2 cm a keyframe), both `LoopCloser`s
fed the same images and poses, in float64 on the CPU:

  * the same keyframes close a loop, with equal (i, j, n_inliers), the
    edges' relative poses within 1e-6 and their mean reprojection errors
    within rtol 1e-6 (atol 1e-12: with exact depths both are ~1e-17);
  * `optimize()` within 1e-6 (positions, orientations);
  * tests/test_loop_closure.py's gates on the port (the edge drift-free
    within 0.15 m, the final drift cut at least 2x), and its keyframe
    gate test (16 keyframes without depth: no edge in either);
  * `optimize(mesh=...)`, the distributed solve, raises naming its
    ROADMAP item;
  * the pipelined estimator through a loop correction (the estimator
    alone on tests/test_pipelined.py's feature-domain scene, window 6,
    16 frames, the correction after frame 10): the frames it drains and
    every output after it within 1e-6 m of JAX's. The port's host
    preintegration and prior once stayed at the pipelined mode's entry
    while the device's moved on, and the re-prime after a correction
    started from them (0.2 m apart after it; CPU run).

Both drives take about 40 s here, most of it the JAX side's eager
solve (CPU run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.estimator.estimator import Estimator as JEstimator
from dynamic_vins_tpu.estimator.estimator import \
    EstimatorConfig as JEstimatorConfig
from dynamic_vins_tpu.geometry import lie_np
from dynamic_vins_tpu.sim import frontend_sim as jfs
from dynamic_vins_tpu.sim import synthetic as jsim
from dynamic_vins_tpu.loop import LoopCloser as JLoopCloser
from dynamic_vins_tpu.loop import LoopClosureConfig as JConfig
from dynamic_vins_tpu.sim import render
from dynamic_vins_tpu_torch.estimator.estimator import Estimator as TEstimator
from dynamic_vins_tpu_torch.estimator.estimator import \
    EstimatorConfig as TEstimatorConfig
from dynamic_vins_tpu_torch.geometry.camera import PinholeIntrinsics
from dynamic_vins_tpu_torch.loop import LoopCloser as TLoopCloser
from dynamic_vins_tpu_torch.loop import LoopClosureConfig as TConfig
from test_loop_closure import _circle_scene

torch.set_num_threads(1)   # the xdist workers share the cores

POSE_ATOL = 1e-6
DRIFT_STEP = np.array([0.035, 0.02, 0.0])     # tests/test_loop_closure.py


def _closers(rig, **kw):
    intr = PinholeIntrinsics.make(float(rig.intr.fx), float(rig.intr.fy),
                                  float(rig.intr.cx), float(rig.intr.cy))
    p_bc, q_bc = np.asarray(rig.p_bc), np.asarray(rig.q_bc)
    return (JLoopCloser(JConfig(**kw), rig.intr, p_bc, q_bc),
            TLoopCloser(TConfig(**kw), intr, p_bc, q_bc, device="cpu"))


def _drive(K, cfg, with_depth, drift):
    """Both closers over the scene: (closers, per-keyframe edges of
    each, poses, drifted positions)."""
    rig, poses, landmarks, inten = _circle_scene(K=K)
    jc, tc = _closers(rig, **cfg)
    render_j = jax.jit(lambda p, q: render.render_frame(
        rig, p, q, landmarks, inten, cam=0))
    depth_j = jax.jit(lambda p, q: render.render_depth(
        rig, p, q, landmarks, cam=0))
    hits, drifted = [], []
    for k, (p, q) in enumerate(poses):
        img = np.asarray(render_j(jnp.asarray(p), jnp.asarray(q)))
        dep = np.asarray(depth_j(jnp.asarray(p), jnp.asarray(q))) \
            if with_depth else None
        p_vio = p + k * drift
        drifted.append(p_vio)
        hits.append(tuple(c.add_keyframe(img, 0.1 * k, p_vio, q, depth=dep,
                                         frame_idx=k) for c in (jc, tc)))
    return (jc, tc), hits, poses, np.stack(drifted)


@pytest.fixture(scope="module")
def circle():
    return _drive(25, dict(min_gap=12, prox_radius=4.0, min_matches=20,
                           min_inliers=10), True, DRIFT_STEP)


def test_loop_edges_match_jax(circle):
    (jc, tc), hits, _, _ = circle
    assert [ej is None for ej, _ in hits] == [et is None for _, et in hits]
    assert len(tc.edges) == len(jc.edges) >= 1
    for ej, et in zip(jc.edges, tc.edges):
        assert (et.i, et.j, et.n_inliers) == (ej.i, ej.j, ej.n_inliers)
        np.testing.assert_allclose(et.rel_p, ej.rel_p, rtol=0,
                                   atol=POSE_ATOL)
        np.testing.assert_allclose(et.rel_q, ej.rel_q, rtol=0,
                                   atol=POSE_ATOL)
        np.testing.assert_allclose(et.mean_err, ej.mean_err, rtol=1e-6,
                                   atol=1e-12)
    assert len(tc.db) == len(jc.db) == 25
    for kj, kt in zip(jc.db.keyframes, tc.db.keyframes):
        np.testing.assert_array_equal(kt.valid, kj.valid)
        np.testing.assert_array_equal(kt.norm, kj.norm)


def test_optimize_matches_jax(circle):
    (jc, tc), _, _, _ = circle
    pj, qj, ij = jc.optimize()
    pt, qt, it = tc.optimize()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(qt, qj, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(float(it["final_cost"]),
                               float(ij["final_cost"]), rtol=1e-6)


def test_loop_closure_cuts_drift(circle):
    """tests/test_loop_closure.py's gates on the port."""
    (_, closer), _, poses, drifted = circle
    e = closer.edges[-1]
    assert e.j - e.i >= closer.cfg.min_gap
    p_iw, q_iw = lie_np.pose_inverse(*poses[e.i])
    rp_gt, _ = lie_np.pose_compose(p_iw, q_iw, *poses[e.j])
    assert np.linalg.norm(e.rel_p - rp_gt) < 0.15
    p_corr, _, info = closer.optimize()
    assert float(info["final_cost"]) < float(info["initial_cost"])
    gt_p = np.stack([p for p, _ in poses])
    err_vio = np.linalg.norm(drifted[-1] - gt_p[-1])
    err_pgo = np.linalg.norm(p_corr[len(poses) - 1] - gt_p[-1])
    assert err_pgo < err_vio / 2.0, (err_vio, err_pgo)


def test_keyframe_db_proximity_and_gap_gates():
    """Far-away or too-recent keyframes are never returned: 16 keyframes
    without depth, a 2 m gate, in both packages."""
    (jc, tc), hits, _, _ = _drive(16, dict(min_gap=8, prox_radius=2.0,
                                           min_matches=10), False,
                                  np.zeros(3))
    assert hits == [(None, None)] * 16
    assert jc.edges == [] and tc.edges == []


def test_optimize_on_a_mesh_raises(circle):
    (_, tc), _, _, _ = circle
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 18"):
        tc.optimize(mesh=object())


def test_pipelined_loop_correction_matches_jax():
    frames_n, window, corr_at = 16, 6, 10
    kw = dict(num_frames=window, lm_capacity=256, obs_capacity=2048,
              pipelined=True)
    seq = jsim.generate_sequence(num_frames=frames_n, imu_hz=100.0,
                                 num_landmarks=180, seed=0)
    frames = jfs.make_frames(seq, pixel_noise=0.4)
    rig = seq.rig
    p_bc = np.stack([np.asarray(rig.p_bc),
                     np.asarray(rig.right_extrinsics()[0])])
    q_bc = np.stack([np.asarray(rig.q_bc),
                     np.asarray(rig.right_extrinsics()[1])])
    v0 = np.asarray(jsim.state_at(seq.frame_times[0])[2])
    yaw = 0.05
    q_yaw = np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])
    runs = {}
    for name, est in (
            ("jax", JEstimator(JEstimatorConfig(**kw), p_bc, q_bc)),
            ("torch", TEstimator(TEstimatorConfig(dtype=torch.float64, **kw),
                                 p_bc, q_bc, device="cpu"))):
        est.set_initial_pose(np.asarray(seq.gt_p[0]),
                             np.asarray(seq.gt_q[0]), v0)
        outs = []
        for k, (f, imu) in enumerate(frames):
            o = est.process_frame(f, imu)
            outs += [] if o is None else [("returned", o)]
            if k == corr_at:
                p_vio, q_vio = outs[-1][1].p, outs[-1][1].q
                outs += [("drained", o) for o in est.apply_loop_correction(
                    p_vio, q_vio, p_vio + np.array([0.3, -0.2, 0.05]),
                    lie_np.quat_multiply(q_yaw, q_vio))]
        runs[name] = outs + [("flushed", o) for o in est.flush()]
        assert est.initialized and not est.failed
    oj, ot = runs["jax"], runs["torch"]
    assert [(k, o.timestamp) for k, o in ot] == \
        [(k, o.timestamp) for k, o in oj]
    assert [k for k, _ in ot].count("drained") == 2
    np.testing.assert_allclose(np.stack([o.p for _, o in ot]),
                               np.stack([o.p for _, o in oj]), rtol=0,
                               atol=POSE_ATOL)
