"""Port parity: IMU preintegration (float64). Tolerances as in
tests/test_preintegration.py: deltas 1e-10, Jacobian and covariance
1e-6 relative (the port's doubling scan and JAX's associative scan
combine in different trees)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamic_vins_tpu.imu import preintegration as jpre
from dynamic_vins_tpu.sim import synthetic as jsim
from dynamic_vins_tpu_torch import convert
from dynamic_vins_tpu_torch.imu import preintegration as tpre

torch.set_num_threads(1)   # the xdist workers share the cores


def _edges(C=64, E=3, seed=0):
    """E padded edges of a noisy sequence, with n_e < C valid samples
    and garbage in the padding (must be an exact no-op)."""
    seq = jsim.generate_sequence(num_frames=E + 1, imu_hz=200.0,
                                 acc_noise=0.05, gyr_noise=0.005,
                                 seed=seed)
    acc_all, gyr_all = np.asarray(seq.acc), np.asarray(seq.gyr)
    t_all = np.asarray(seq.imu_times)
    rng = np.random.default_rng(seed)
    acc = rng.normal(size=(E, C + 1, 3)) * 1e3
    gyr = rng.normal(size=(E, C + 1, 3)) * 1e3
    dt = rng.uniform(0, 1, size=(E, C))
    mask = np.zeros((E, C), bool)
    for e in range(E):
        a, b = e * 20, (e + 1) * 20
        n = b - a
        acc[e, :n + 1] = acc_all[a:b + 1]
        gyr[e, :n + 1] = gyr_all[a:b + 1]
        dt[e, :n] = np.diff(t_all[a:b + 1])
        mask[e, :n] = True
    ba = rng.normal(size=(E, 3)) * 0.02
    bg = rng.normal(size=(E, 3)) * 0.002
    return acc, gyr, dt, mask, ba, bg


def _check(pj, pt, cov_scale):
    for name in ("delta_p", "delta_q", "delta_v", "sum_dt"):
        np.testing.assert_allclose(getattr(pt, name).numpy(),
                                   np.asarray(getattr(pj, name)),
                                   rtol=0, atol=1e-10, err_msg=name)
    np.testing.assert_allclose(pt.jacobian.numpy(), np.asarray(pj.jacobian),
                               rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(pt.covariance.numpy(),
                               np.asarray(pj.covariance), rtol=1e-6,
                               atol=1e-6 * cov_scale)


def test_batched_masked_preintegration_matches_jax():
    acc, gyr, dt, mask, ba, bg = _edges()
    noise = jpre.ImuNoise(acc_n=0.08, gyr_n=0.004, acc_w=2e-3, gyr_w=3e-5)
    one = lambda a, g, d, m, b1, b2: jpre.preintegrate(
        a, g, d, b1, b2, noise=noise, valid_mask=m)
    pj = jax.vmap(one)(*(jnp.asarray(x) for x in
                         (acc, gyr, dt, mask, ba, bg)))
    T = lambda x: torch.tensor(x)
    pt = tpre.preintegrate(T(acc), T(gyr), T(dt), T(ba), T(bg),
                           noise=convert.imu_noise(noise._asdict()),
                           valid_mask=T(mask))
    _check(pj, pt, float(np.abs(np.asarray(pj.covariance)).max()))


def test_sequential_matches_jax_and_scan():
    acc, gyr, dt, mask, ba, bg = _edges(C=32, E=1, seed=3)
    args = (acc[0], gyr[0], dt[0])
    pj = jpre.preintegrate_sequential(
        *(jnp.asarray(x) for x in args), jnp.asarray(ba[0]),
        jnp.asarray(bg[0]), valid_mask=jnp.asarray(mask[0]))
    T = lambda x: torch.tensor(x)
    ps = tpre.preintegrate_sequential(*(T(x) for x in args), T(ba[0]),
                                      T(bg[0]), valid_mask=T(mask[0]))
    pt = tpre.preintegrate(*(T(x) for x in args), T(ba[0]), T(bg[0]),
                           valid_mask=T(mask[0]))
    scale = float(np.abs(np.asarray(pj.covariance)).max())
    _check(pj, ps, scale)
    _check(pj, pt, scale)


def test_empty_interval_no_nan():
    z = torch.zeros(3, dtype=torch.float64)
    p = tpre.preintegrate(torch.zeros((1, 3), dtype=torch.float64),
                          torch.zeros((1, 3), dtype=torch.float64),
                          torch.zeros((0,), dtype=torch.float64), z, z)
    for f in p:
        assert torch.isfinite(f).all()
    # an all-masked padded buffer is the identity too
    acc, gyr, dt, _, ba, bg = _edges(C=32, E=1)
    T = lambda x: torch.tensor(x)
    q = tpre.preintegrate(T(acc[0]), T(gyr[0]), T(dt[0]), T(ba[0]),
                          T(bg[0]), valid_mask=torch.zeros(32, dtype=bool))
    np.testing.assert_array_equal(q.delta_p.numpy(), 0.0)
    np.testing.assert_array_equal(q.jacobian.numpy(), np.eye(15))
    np.testing.assert_array_equal(q.covariance.numpy(), 0.0)
    assert float(q.sum_dt) == 0.0


def test_evaluate_and_propagation_match_jax():
    acc, gyr, dt, mask, ba, bg = _edges(C=32, E=1, seed=5)
    rng = np.random.default_rng(6)
    pj = jpre.preintegrate(jnp.asarray(acc[0]), jnp.asarray(gyr[0]),
                           jnp.asarray(dt[0]), jnp.asarray(ba[0]),
                           jnp.asarray(bg[0]),
                           valid_mask=jnp.asarray(mask[0]))
    T = lambda x: torch.tensor(x)
    pt = tpre.preintegrate(T(acc[0]), T(gyr[0]), T(dt[0]), T(ba[0]),
                           T(bg[0]), valid_mask=T(mask[0]))
    q = rng.normal(size=(2, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    st = [rng.normal(size=3), q[0], rng.normal(size=3),
          rng.normal(size=3) * 0.01, rng.normal(size=3) * 0.001,
          rng.normal(size=3), q[1], rng.normal(size=3),
          rng.normal(size=3) * 0.01, rng.normal(size=3) * 0.001]
    rj = jpre.evaluate(pj, *(jnp.asarray(x) for x in st))
    rt = tpre.evaluate(pt, *(T(x) for x in st))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                               atol=1e-9)

    # whole-interval propagation == the JAX per-sample scan
    p0, v0 = st[0], st[2]
    pj_, qj_, vj_ = jnp.asarray(p0), jnp.asarray(q[0]), jnp.asarray(v0)
    for i in range(int(mask[0].sum())):
        pj_, qj_, vj_ = jpre.propagate_state(
            pj_, qj_, vj_, jnp.asarray(ba[0]), jnp.asarray(bg[0]),
            jnp.asarray(acc[0, i]), jnp.asarray(gyr[0, i]),
            jnp.asarray(acc[0, i + 1]), jnp.asarray(gyr[0, i + 1]),
            jnp.asarray(dt[0, i]))
    pt_, qt_, vt_ = tpre.propagate_with(pt, T(p0), T(q[0]), T(v0))
    for a, b in ((pj_, pt_), (qj_, qt_), (vj_, vt_)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-10)
