"""Port parity: the equidistant (Kannala-Brandt), MEI catadioptric and
Scaramuzza camera models against the JAX package's, float64: project
1e-10, lift 1e-9 (px and ray components), `scaramuzza_fit_inverse` 1e-9;
and the roundtrip gates of tests/test_lie.py on the port's models."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.geometry import camera as jcam
from dynamic_vins_tpu_torch.geometry import camera as tcam

torch.set_num_threads(1)   # the xdist workers share the cores

PROJ_ATOL = 1e-10
LIFT_ATOL = 1e-9

EQUI = dict(args=(380.8, 380.3, 510.0, 514.0),
            kw=dict(k2=-0.01, k3=0.02, k4=-0.02, k5=0.005))
CATA = dict(args=(0.9, 360.0, 362.0, 376.0, 240.0),
            kw=dict(k1=-0.1, k2=0.02, p1=1e-4, p2=-2e-4))
POLY = [-250.0, 0.0, 1.2e-3, -2.0e-7, 1.0e-10]
SCARA_KW = dict(c=1.001, d=1e-4, e=-2e-4)


def _both(cls_name, *args, **kw):
    j = getattr(jcam, cls_name).make(*args, dtype=jnp.float64, **kw)
    t = getattr(tcam, cls_name).make(*args, dtype=torch.float64,
                                     device="cpu", **kw)
    return j, t


def _scaramuzza():
    inv = jcam.scaramuzza_fit_inverse(POLY, max_rho=380.0)
    return _both("ScaramuzzaIntrinsics", POLY, inv, 400.0, 300.0,
                 **SCARA_KW)


def _points(rng, n=256):
    pts = rng.uniform(-1.5, 1.5, size=(n, 3))
    pts[:, 2] = rng.uniform(0.3, 10.0, size=n)
    pts[:8, :2] = 0.0          # on the optical axis: the guards' branch
    pts[8:16, :2] *= 1e-9
    return pts


def _pixels(rng, n=256):
    uv = np.stack([rng.uniform(0, 752, n), rng.uniform(0, 480, n)], -1)
    return uv


MODELS = {
    "equidistant": (lambda: _both("EquidistantIntrinsics", *EQUI["args"],
                                  **EQUI["kw"]),
                    "equidistant_project", "equidistant_lift"),
    "cata": (lambda: _both("CataIntrinsics", *CATA["args"], **CATA["kw"]),
             "cata_project", "cata_lift"),
    "scaramuzza": (_scaramuzza, "scaramuzza_project", "scaramuzza_lift"),
}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_project_and_lift_match(model, rng):
    make, proj, lift = MODELS[model]
    ji, ti = make()
    pts = _points(rng)
    uj = np.asarray(getattr(jcam, proj)(ji, jnp.asarray(pts)))
    ut = getattr(tcam, proj)(ti, torch.from_numpy(pts)).numpy()
    assert np.isfinite(ut).all()
    np.testing.assert_allclose(ut, uj, rtol=0, atol=PROJ_ATOL)

    uv = _pixels(rng)
    kw = {} if model == "scaramuzza" else dict(num_iters=12)
    rj = np.asarray(getattr(jcam, lift)(ji, jnp.asarray(uv), **kw))
    rt = getattr(tcam, lift)(ti, torch.from_numpy(uv), **kw).numpy()
    assert np.isfinite(rt).all()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=LIFT_ATOL)


def test_scaramuzza_fit_inverse_matches():
    for max_rho, n in ((380.0, 256), (500.0, 64)):
        np.testing.assert_allclose(
            tcam.scaramuzza_fit_inverse(POLY, max_rho, n),
            jcam.scaramuzza_fit_inverse(POLY, max_rho, n),
            rtol=0, atol=1e-9)


def test_float32_and_to():
    """float32 intrinsics follow `make(dtype=)` and `.to()` as the
    pinhole's do; a float32 roundtrip stays within float32 rounding."""
    ti = tcam.EquidistantIntrinsics.make(*EQUI["args"], **EQUI["kw"])
    assert ti.fx.dtype == torch.float32
    t64 = ti.to(dtype=torch.float64)
    assert all(v.dtype == torch.float64 for v in t64)
    si = tcam.ScaramuzzaIntrinsics.make(POLY, [1.0, 2.0], 1.0, 2.0)
    assert si.poly.shape == (5,) and si.inv_poly.shape == (12,)
    assert float(si.inv_poly[1]) == 2.0 and float(si.inv_poly[2]) == 0.0
    ci = tcam.CataIntrinsics.make(*CATA["args"], **CATA["kw"]).to(
        dtype=torch.float64)
    uv = torch.tensor([[40.0, 40.0], [376.0, 240.0], [700.0, 430.0]],
                      dtype=torch.float64)
    ray32 = tcam.cata_lift(ci.to(dtype=torch.float32),
                           uv.to(torch.float32), num_iters=12)
    ray64 = tcam.cata_lift(ci, uv, num_iters=12)
    np.testing.assert_allclose(ray32.numpy(), ray64.numpy(), atol=1e-5)


# --- tests/test_lie.py's roundtrip gates, on the port's models ---------

def test_equidistant_roundtrip(rng):
    intr = tcam.EquidistantIntrinsics.make(*EQUI["args"], **EQUI["kw"],
                                           dtype=torch.float64)
    pts = rng.uniform(-1.5, 1.5, size=(128, 3))
    pts[:, 2] = rng.uniform(0.5, 10.0, size=128)
    uv = tcam.equidistant_project(intr, torch.from_numpy(pts))
    ray = tcam.equidistant_lift(intr, uv, num_iters=12)
    ray_gt = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    np.testing.assert_allclose(ray.numpy(), ray_gt, atol=1e-8)


def test_cata_roundtrip():
    intr = tcam.CataIntrinsics.make(*CATA["args"], **CATA["kw"],
                                    dtype=torch.float64)
    uv = torch.tensor([[u, v] for u, v in itertools.product(
        [40.0, 376.0, 700.0], [40.0, 240.0, 430.0])], dtype=torch.float64)
    ray = tcam.cata_lift(intr, uv, num_iters=12)
    assert np.allclose(np.linalg.norm(ray.numpy(), axis=-1), 1.0)
    uv2 = tcam.cata_project(intr, ray * 3.0)   # scale-invariant
    assert np.allclose(uv2.numpy(), uv.numpy(), atol=1e-5)


def test_scaramuzza_roundtrip():
    inv = tcam.scaramuzza_fit_inverse(POLY, max_rho=380.0)
    intr = tcam.ScaramuzzaIntrinsics.make(POLY, inv, 400.0, 300.0,
                                          **SCARA_KW, dtype=torch.float64)
    uv = torch.tensor([[150.0, 120.0], [400.0, 300.0], [620.0, 450.0],
                       [90.0, 500.0]], dtype=torch.float64)
    ray = tcam.scaramuzza_lift(intr, uv)
    assert bool((ray[:, 2] > 0).all())          # forward-looking
    uv2 = tcam.scaramuzza_project(intr, ray * 5.0)
    assert np.allclose(uv2.numpy(), uv.numpy(), atol=0.05)
