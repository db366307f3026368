"""Port parity: Lie group and pinhole camera math (float64, 1e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.geometry import camera as jcam
from dynamic_vins_tpu.geometry import lie as jlie
from dynamic_vins_tpu.geometry import lie_np as jlie_np
from dynamic_vins_tpu_torch.geometry import camera as tcam
from dynamic_vins_tpu_torch.geometry import lie as tlie
from dynamic_vins_tpu_torch.geometry import lie_np as tlie_np

torch.set_num_threads(1)   # the xdist workers share the cores

ATOL = 1e-10


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rotvecs(rng, n):
    # mix of regular and small angles (the Taylor branches)
    v = rng.normal(size=(n, 3))
    v[: n // 3] *= 1e-7
    return v


def _same(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=atol)


UNARY = ["quat_normalize", "quat_conjugate", "quat_to_matrix", "quat_log",
         "quat_from_small_angle"]
ROTVEC = ["so3_exp_quat", "so3_exp", "hat", "so3_left_jacobian",
          "so3_right_jacobian", "so3_left_jacobian_inv",
          "so3_right_jacobian_inv"]


@pytest.mark.parametrize("name", UNARY)
def test_quaternion_unary(name):
    q = _quats(np.random.default_rng(0), 64)
    _same(getattr(jlie, name)(jnp.asarray(q)),
          getattr(tlie, name)(torch.tensor(q)))


@pytest.mark.parametrize("name", ROTVEC)
def test_rotation_vector_maps(name):
    v = _rotvecs(np.random.default_rng(1), 60)
    _same(getattr(jlie, name)(jnp.asarray(v)),
          getattr(tlie, name)(torch.tensor(v)))


def test_binary_and_pose_ops():
    rng = np.random.default_rng(2)
    q1, q2 = _quats(rng, 32), _quats(rng, 32)
    p1, p2, x = (rng.normal(size=(32, 3)) for _ in range(3))
    dx = rng.normal(size=(32, 6)) * 0.3
    J = lambda *a: [jnp.asarray(v) for v in a]
    T = lambda *a: [torch.tensor(v) for v in a]
    _same(jlie.quat_multiply(*J(q1, q2)), tlie.quat_multiply(*T(q1, q2)))
    _same(jlie.quat_rotate(*J(q1, x)), tlie.quat_rotate(*T(q1, x)))
    for name, args in [("pose_compose", (p1, q1, p2, q2)),
                       ("pose_inverse", (p1, q1)),
                       ("pose_boxplus", (p1, q1, dx)),
                       ("pose_boxminus", (p1, q1, p2, q2))]:
        a = getattr(jlie, name)(*J(*args))
        b = getattr(tlie, name)(*T(*args))
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            _same(u, v)
    _same(jlie.pose_transform_point(*J(p1, q1, x)),
          tlie.pose_transform_point(*T(p1, q1, x)))


def test_matrix_conversions_and_gravity():
    rng = np.random.default_rng(3)
    R = np.asarray(jlie.quat_to_matrix(jnp.asarray(_quats(rng, 40))))
    _same(jlie.matrix_to_quat(jnp.asarray(R)),
          tlie.matrix_to_quat(torch.tensor(R)))
    _same(jlie.so3_log(jnp.asarray(R)), tlie.so3_log(torch.tensor(R)))
    g = rng.normal(size=(8, 3)) + np.array([0.0, 0.0, 9.8])
    _same(jlie.g2R(jnp.asarray(g)), tlie.g2R(torch.tensor(g)))
    yaw = rng.uniform(-3, 3, size=8)
    _same(jlie.quat_from_yaw(jnp.asarray(yaw)),
          tlie.quat_from_yaw(torch.tensor(yaw)))
    M = rng.normal(size=(8, 3, 3))
    _same(jlie.vee(jnp.asarray(M)), tlie.vee(torch.tensor(M)))
    for u, v in zip(jlie.pose_identity(jnp.float64),
                    tlie.pose_identity(torch.float64)):
        _same(u, v)


def test_lie_np_twins():
    rng = np.random.default_rng(4)
    q, p, x = _quats(rng, 16), rng.normal(size=(16, 3)), \
        rng.normal(size=(16, 3))
    for name, args in [("quat_multiply", (q, q[::-1])),
                       ("quat_rotate", (q, x)), ("quat_to_matrix", (q,)),
                       ("pose_compose", (p, q, x, q[::-1])),
                       ("pose_inverse", (p, q))]:
        a = getattr(jlie_np, name)(*args)
        b = getattr(tlie_np, name)(*args)
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(u, v)
    R = jlie_np.quat_to_matrix(q[0])
    np.testing.assert_array_equal(jlie_np.matrix_to_quat(R),
                                  tlie_np.matrix_to_quat(R))
    np.testing.assert_array_equal(jlie_np.so3_log(R), tlie_np.so3_log(R))


def _intr(distorted):
    vals = [458.65, 457.3, 367.2, 248.4]
    vals += [-0.28, 0.07, 2e-4, 1.8e-5] if distorted else [0.0] * 4
    return (jcam.PinholeIntrinsics.make(*vals, dtype=jnp.float64),
            tcam.PinholeIntrinsics.make(*vals, dtype=torch.float64))


@pytest.mark.parametrize("distorted", [False, True])
def test_camera_projection(distorted):
    ji, ti = _intr(distorted)
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(50, 3)) + np.array([0.0, 0.0, 5.0])
    uv = rng.uniform([0, 0], [752, 480], size=(50, 2))
    xy = rng.normal(size=(50, 2)) * 0.3
    _same(jcam.project(ji, jnp.asarray(pts)),
          tcam.project(ti, torch.tensor(pts)))
    _same(jcam.lift(ji, jnp.asarray(uv)), tcam.lift(ti, torch.tensor(uv)))
    _same(jcam.normalized_from_pixel(ji, jnp.asarray(uv)),
          tcam.normalized_from_pixel(ti, torch.tensor(uv)))
    _same(jcam.pixel_from_normalized(ji, jnp.asarray(xy)),
          tcam.pixel_from_normalized(ti, torch.tensor(xy)))
    assert ti.has_distortion == ji.has_distortion


def test_lift_project_corner_round_trip():
    """Image corners -> lift -> project, on both packages (the
    distortion fixed point is worst there)."""
    ji, ti = _intr(True)
    corners = np.array([[0.0, 0.0], [751.0, 0.0], [0.0, 479.0],
                        [751.0, 479.0], [367.2, 248.4]])
    ray_j = jcam.lift(ji, jnp.asarray(corners), num_iters=8)
    ray_t = tcam.lift(ti, torch.tensor(corners), num_iters=8)
    _same(ray_j, ray_t)
    _same(jcam.project(ji, ray_j), tcam.project(ti, ray_t))
    # the fixed point converges in the interior: round trip to < 1 px
    back = tcam.project(ti, ray_t).numpy()
    assert np.abs(back[-1] - corners[-1]).max() < 1e-9
