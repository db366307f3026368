"""Port parity: the mono initializer's stages against the JAX
package's, on a copy of tests/test_initializer.py's mono world (8
frames, 120 landmarks, noise-free): the relative pose from the essential
matrix, the incremental SfM, the linear gravity / velocity / scale
alignment and its refinement on the gravity sphere agree within 1e-8,
each stage fed the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.estimator import initializer as jini
from dynamic_vins_tpu.geometry import lie
from dynamic_vins_tpu.imu import preintegration as pre
from dynamic_vins_tpu.sim import synthetic as sim
from dynamic_vins_tpu_torch.estimator import initializer as tini

pytest.importorskip("cv2")
torch.set_num_threads(1)   # the xdist workers share the cores

ATOL = 1e-8
F = 8


def _mono_world(F=F, n_lm=120, seed=0):
    """Camera-frame observations of static landmarks (mono, left cam)."""
    seq = sim.generate_sequence(num_frames=F, imu_hz=200.0,
                                num_landmarks=n_lm, seed=seed)
    rig = seq.rig
    obs = {}
    cam_R = []   # camera->world
    cam_p = []
    for k in range(F):
        p_wc, q_wc = lie.pose_compose(seq.gt_p[k], seq.gt_q[k],
                                      rig.p_bc, rig.q_bc)
        cam_R.append(np.asarray(lie.quat_to_matrix(q_wc)))
        cam_p.append(np.asarray(p_wc))
        p_cw, q_cw = lie.pose_inverse(p_wc, q_wc)
        pts_c = np.asarray(lie.pose_transform_point(
            p_cw[None, :], q_cw[None, :], seq.landmarks))
        for l in range(n_lm):
            pc = pts_c[l]
            if pc[2] < 0.5:
                continue
            xy = pc[:2] / pc[2]
            if abs(xy[0]) > 0.8 or abs(xy[1]) > 0.55:
                continue
            obs.setdefault(l, {})[k] = xy
    return seq, obs, cam_R, cam_p, rig


@pytest.fixture(scope="module")
def world():
    seq, obs, cam_R, cam_p, rig = _mono_world()
    pts_i = [fo[0] for fo in obs.values() if 0 in fo and F - 1 in fo]
    pts_j = [fo[F - 1] for fo in obs.values() if 0 in fo and F - 1 in fo]
    return seq, obs, rig, pts_i, pts_j


def test_relative_pose_matches(world):
    _, _, _, pts_i, pts_j = world
    rj = jini.solve_relative_pose(pts_i, pts_j)
    rt = tini.solve_relative_pose(pts_i, pts_j)
    assert rj is not None and rt is not None
    assert rt[2] == rj[2] and rt[2] > 0.7
    np.testing.assert_allclose(rt[0], rj[0], rtol=0, atol=ATOL)
    np.testing.assert_allclose(rt[1], rj[1], rtol=0, atol=ATOL)


def test_sfm_construct_matches(world):
    _, obs, _, pts_i, pts_j = world
    R_rel, t_rel, _ = jini.solve_relative_pose(pts_i, pts_j)
    okj, Rj, pj, ptsj = jini.sfm_construct(F, obs, 0, R_rel, t_rel)
    okt, Rt, pt, ptst = tini.sfm_construct(F, obs, 0, R_rel, t_rel)
    assert okj and okt
    for k in range(F):
        np.testing.assert_allclose(Rt[k], np.asarray(Rj[k]), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(pt[k], np.asarray(pj[k]), rtol=0,
                                   atol=ATOL)
    assert ptst.keys() == ptsj.keys() and len(ptst) > 20
    for fid in ptsj:
        np.testing.assert_allclose(ptst[fid], ptsj[fid], rtol=0, atol=ATOL)
    # a reference frame inside the window: forward and backward passes
    okj, Rj, pj, _ = jini.sfm_construct(F, obs, 3, R_rel, t_rel)
    okt, Rt, pt, _ = tini.sfm_construct(F, obs, 3, R_rel, t_rel)
    assert okj == okt
    for k in range(F):
        if Rj[k] is not None:
            np.testing.assert_allclose(Rt[k], np.asarray(Rj[k]), rtol=0,
                                       atol=ATOL)
            np.testing.assert_allclose(pt[k], np.asarray(pj[k]), rtol=0,
                                       atol=ATOL)


def test_alignment_matches(world):
    seq, obs, rig, pts_i, pts_j = world
    R_rel, t_rel, _ = jini.solve_relative_pose(pts_i, pts_j)
    _, R_sfm, p_sfm, _ = jini.sfm_construct(F, obs, 0, R_rel, t_rel)
    ipf = 20
    zeros = jnp.zeros(3, dtype=jnp.float64)
    pres, dt_edges = [], []
    for k in range(F - 1):
        a, b = k * ipf, (k + 1) * ipf
        P = pre.preintegrate(seq.acc[a:b + 1], seq.gyr[a:b + 1],
                             jnp.diff(seq.imu_times[a:b + 1]), zeros, zeros)
        pres.append(dict(delta_p=np.asarray(P.delta_p),
                         delta_v=np.asarray(P.delta_v)))
        dt_edges.append(float(P.sum_dt))
    R_bc = np.asarray(lie.quat_to_matrix(rig.q_bc))
    p_bc = np.asarray(rig.p_bc)
    R_c0b = [np.asarray(R_sfm[k]) @ R_bc.T for k in range(F)]
    p_c0b = [np.asarray(p) for p in p_sfm]
    args = (pres, R_c0b, p_c0b, p_bc, dt_edges)
    okj, vj, gj, sj = jini.solve_gravity_velocity_scale(*args)
    okt, vt, gt, st = tini.solve_gravity_velocity_scale(*args)
    assert okj and okt
    np.testing.assert_allclose(vt, vj, rtol=0, atol=ATOL)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=ATOL)
    assert abs(st - sj) < ATOL
    vj2, gj2, sj2 = jini.refine_gravity(*args, gj)
    vt2, gt2, st2 = tini.refine_gravity(*args, gj)
    np.testing.assert_allclose(vt2, vj2, rtol=0, atol=ATOL)
    np.testing.assert_allclose(gt2, gj2, rtol=0, atol=ATOL)
    assert abs(st2 - sj2) < ATOL
    # a gravity far from 9.81 is refused on both sides
    bad = [dict(delta_p=d["delta_p"] * 0, delta_v=d["delta_v"] * 0)
           for d in pres]
    assert jini.solve_gravity_velocity_scale(bad, *args[1:])[0] is False
    assert tini.solve_gravity_velocity_scale(bad, *args[1:])[0] is False
