"""Port parity: the LK level and the whole track (the kernels' plain
versions against the Pallas kernel in interpret mode, under the JAX
package's track glue), the Scharr LK level, pyramid and corners.

The plain versions follow the Pallas formulation (central-difference
gradients of bilinear window patches, zero outside the window, clamped
img1 patch origin), not the Scharr form; the Scharr `_lk_level` is held
against the JAX XLA path separately. Flows and tracked points agree
within 1e-3 px (both float32, sums in other orders), `ok` exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.frontend import corners as jcorners
from dynamic_vins_tpu.frontend import lk as jlk
from dynamic_vins_tpu.frontend import pyramid as jpyr
from dynamic_vins_tpu.ops import lk_pallas
from dynamic_vins_tpu_torch.frontend import corners as tcorners
from dynamic_vins_tpu_torch.frontend import lk as tlk
from dynamic_vins_tpu_torch.frontend import pyramid as tpyr
from dynamic_vins_tpu_torch.ops import lk_level as tk

torch.set_num_threads(1)   # the xdist workers share the cores

FLOW_ATOL = 1e-3


def _pair(shift=(3.2, -2.4), seed=0, H=240, W=320):
    rng = np.random.default_rng(seed)
    img0 = jpyr.gaussian_blur5(
        jnp.asarray(rng.uniform(0, 255, (H, W)), jnp.float32))
    yy, xx = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing="ij")
    img1 = jpyr.bilinear_sample(
        img0, jnp.stack([xx - shift[0], yy - shift[1]], -1))
    return np.asarray(img0), np.asarray(img1)


def _pts(rng, n, lo, hi):
    return np.stack([rng.uniform(lo[0], hi[0], n),
                     rng.uniform(lo[1], hi[1], n)], -1).astype(np.float32)


def _cases():
    """(img0, img1, pts, guess, iters): the three tests/test_lk_pallas.py
    cases plus a border/clamp case at a coarse-level image size."""
    out = []
    img0, img1 = _pair()
    out.append((img0, img1, _pts(np.random.default_rng(1), 32, (80, 80),
                                 (240, 160)), np.zeros((32, 2), np.float32),
                12))
    img0, img1 = _pair(seed=3)
    out.append((img0, img1, _pts(np.random.default_rng(2), 16, (100, 100),
                                 (220, 140)), np.zeros((16, 2), np.float32),
                10))
    img0, img1 = _pair(shift=(14.0, 6.0), seed=5)
    out.append((img0, img1, _pts(np.random.default_rng(4), 16, (100, 80),
                                 (220, 150)),
                np.tile(np.float32([[12.0, 5.0]]), (16, 1)), 12))
    # 60 x 94 (a 752x480 level-3 image): features within 12 px of every
    # border, guesses large enough to hit the img1 window clamp
    img0, img1 = _pair(shift=(1.5, -1.0), seed=7, H=60, W=94)
    rng = np.random.default_rng(8)
    pts = np.concatenate([
        _pts(rng, 12, (1, 1), (12, 59)), _pts(rng, 12, (82, 1), (93, 59)),
        _pts(rng, 12, (1, 1), (93, 12)), _pts(rng, 12, (1, 48), (93, 59)),
        _pts(rng, 16, (12, 12), (82, 48))])
    guess = rng.normal(scale=3.0, size=pts.shape).astype(np.float32)
    guess[::5] = np.float32([[40.0, -30.0]])
    out.append((img0, img1, pts, guess, 10))
    return out


@pytest.mark.parametrize("case", range(4))
def test_plain_level_matches_pallas_interpret(case):
    img0, img1, pts, guess, iters = _cases()[case]
    fj, okj = lk_pallas.lk_level(jnp.asarray(img0), jnp.asarray(img1),
                                 jnp.asarray(pts), jnp.asarray(guess),
                                 radius=10, iters=iters, interpret=True)
    T = torch.tensor
    ft, okt = tk.lk_level_plain(T(img0), T(img1), T(pts), T(guess),
                                radius=10, iters=iters)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = np.asarray(okj)
    np.testing.assert_allclose(ft.numpy()[ok], np.asarray(fj)[ok], rtol=0,
                               atol=FLOW_ATOL)


def test_wrapper_runs_plain_on_cpu_without_launching():
    img0, img1, pts, guess, iters = _cases()[3]
    T = torch.tensor
    before = tk.launches
    f1, ok1 = tk.lk_level(T(img0), T(img1), T(pts), T(guess), 10, iters)
    f2, ok2 = tk.lk_level_plain(T(img0), T(img1), T(pts), T(guess), 10,
                                iters)
    assert tk.launches == before
    np.testing.assert_array_equal(f1.numpy(), f2.numpy())
    np.testing.assert_array_equal(ok1.numpy(), ok2.numpy())
    with pytest.raises(TypeError):
        tk.lk_level(T(img0).double(), T(img1), T(pts), T(guess))


def test_plain_track_matches_pallas_track():
    """`lk_track_plain` against the JAX package's `track` with the Pallas
    level in interpret mode and the seeded level-0 back-check, on one
    3-level pyramid (376x240 down to 94x60): 24 features, 8 of them
    within 12 px of the borders, every fifth slot invalid."""
    img0, img1 = _pair(shift=(4.0, -2.5), seed=21, H=240, W=376)
    rng = np.random.default_rng(22)
    pts = np.concatenate([
        _pts(rng, 16, (20, 20), (356, 220)), _pts(rng, 2, (1, 1), (12, 239)),
        _pts(rng, 2, (364, 1), (375, 239)), _pts(rng, 2, (1, 1), (375, 12)),
        _pts(rng, 2, (1, 228), (375, 239))])
    valid = np.ones(24, bool)
    valid[::5] = False
    T = torch.tensor
    p0 = tpyr.build_pyramid(T(img0), 3)
    p1 = tpyr.build_pyramid(T(img1), 3)
    assert tuple(p0[2].shape) == (60, 94)
    J = lambda pyr: [jnp.asarray(a.numpy()) for a in pyr]
    level = lambda a, b, p, g: lk_pallas.lk_level(a, b, p, g, radius=10,
                                                  iters=10, interpret=True)
    pj, okj = jlk.track(J(p0), J(p1), jnp.asarray(pts), jnp.asarray(valid),
                        radius=10, iters=10, fb_thresh=0.5, border=8,
                        level_fn=level, fb_levels=1)
    pt, okt = tk.lk_track_plain(p0, p1, T(pts), T(valid), radius=10,
                                iters=10, fb_thresh=0.5, border=8,
                                fb_levels=1)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert 0 < okt.sum() < valid.sum()
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=FLOW_ATOL)


def test_plain_track_matches_pallas_track_radius8():
    """The instance tracker's track: radius 8, 3 levels, fb 1.0 px,
    border 3, seeded level-0 back-check; `lk_track_plain` against the
    JAX package's `track` with the Pallas level at radius 8 in interpret
    mode. 30 rows, two thirds invalid (the instance rows' unused slots),
    4 near the borders."""
    img0, img1 = _pair(shift=(3.0, 2.0), seed=25, H=240, W=376)
    rng = np.random.default_rng(26)
    pts = np.concatenate([
        _pts(rng, 26, (20, 20), (356, 220)), _pts(rng, 1, (1, 1), (8, 239)),
        _pts(rng, 1, (368, 1), (375, 239)), _pts(rng, 1, (1, 1), (375, 8)),
        _pts(rng, 1, (1, 232), (375, 239))])
    valid = np.zeros(30, bool)
    valid[::3] = True
    valid[26:] = True
    T = torch.tensor
    p0 = tpyr.build_pyramid(T(img0), 3)
    p1 = tpyr.build_pyramid(T(img1), 3)
    J = lambda pyr: [jnp.asarray(a.numpy()) for a in pyr]
    level = lambda a, b, p, g: lk_pallas.lk_level(a, b, p, g, radius=8,
                                                  iters=10, interpret=True)
    pj, okj = jlk.track(J(p0), J(p1), jnp.asarray(pts), jnp.asarray(valid),
                        radius=8, iters=10, fb_thresh=1.0, border=3,
                        level_fn=level, fb_levels=1)
    pt, okt = tk.lk_track_plain(p0, p1, T(pts), T(valid), radius=8,
                                iters=10, fb_thresh=1.0, border=3,
                                fb_levels=1)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert 0 < okt.sum() < valid.sum()
    assert not (okt.numpy() & ~valid).any()
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=FLOW_ATOL)


def test_cuda_path_takes_radius_8_and_10_only():
    assert tk.RADIUS == {8, 10}
    for r in (8, 10):
        tk._check_cuda(r, 10)
    for r in (7, 9, 11):
        with pytest.raises(ValueError):
            tk._check_cuda(r, 10)


def test_track_wrapper_runs_plain_on_cpu_without_launching():
    img0, img1 = _pair(shift=(2.0, 1.0), seed=23, H=120, W=160)
    T = torch.tensor
    p0, p1 = tpyr.build_pyramid(T(img0), 2), tpyr.build_pyramid(T(img1), 2)
    pts = T(_pts(np.random.default_rng(24), 12, (5, 5), (155, 115)))
    valid = torch.ones(12, dtype=torch.bool)
    before = (tk.launches, tk.track_launches)
    q1, ok1 = tk.lk_track(p0, p1, pts, valid, fb_levels=2)
    q2, ok2 = tk.lk_track_plain(p0, p1, pts, valid, fb_levels=2)
    run = tlk.make_tracker(levels=2, border=3, backend="plain",
                           fb_levels=2)
    q3, ok3 = run(T(img0), T(img1), pts, valid)
    assert (tk.launches, tk.track_launches) == before
    for q, ok in ((q2, ok2), (q3, ok3)):
        np.testing.assert_array_equal(q1.numpy(), q.numpy())
        np.testing.assert_array_equal(ok1.numpy(), ok.numpy())
    with pytest.raises(TypeError):
        tk.lk_track(p0, p1, pts, valid.to(torch.uint8))
    with pytest.raises(ValueError):
        tk.lk_track(p0, p1[:1], pts, valid)


def test_scharr_level_matches_xla():
    img0, img1, pts, guess, _ = _cases()[2]
    gj, okj = jlk._lk_level(jnp.asarray(img0), jnp.asarray(img1),
                            jnp.asarray(pts), jnp.asarray(guess), 10, 10)
    T = torch.tensor
    gt, okt = tlk._lk_level(T(img0), T(img1), T(pts), T(guess), 10, 10)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                               atol=FLOW_ATOL)


def test_pyramid_and_gradients_match():
    img0, _ = _pair(seed=9, H=120, W=150)
    pj = jpyr.build_pyramid(jnp.asarray(img0), 4)
    pt = tpyr.build_pyramid(torch.tensor(img0), 4)
    for a, b in zip(pj, pt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4)
    for a, b in zip(jpyr.scharr_gradients(jnp.asarray(img0)),
                    tpyr.scharr_gradients(torch.tensor(img0))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4)
    m = np.random.default_rng(0).uniform(size=(40, 50)) > 0.7
    for it in (1, 3):
        np.testing.assert_array_equal(
            tpyr.dilate3(torch.tensor(m), it).numpy(),
            np.asarray(jpyr.dilate3(jnp.asarray(m), it)))
        np.testing.assert_array_equal(
            tpyr.erode3(torch.tensor(m), it).numpy(),
            np.asarray(jpyr.erode3(jnp.asarray(m), it)))


def test_full_track_matches_xla():
    img0, img1 = _pair(shift=(5.0, 2.0), seed=11)
    pts = _pts(np.random.default_rng(12), 40, (20, 20), (300, 220))
    valid = np.ones(40, bool)
    valid[::7] = False
    run_j = jlk.make_tracker(levels=3, backend="xla")
    run_t = tlk.make_tracker(levels=3, backend="auto", device="cpu")
    assert run_t.backend == "xla"
    pj, okj = run_j(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
                    jnp.asarray(valid))
    T = torch.tensor
    pt, okt = run_t(T(img0), T(img1), T(pts), T(valid))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=FLOW_ATOL)


def test_corner_detection_matches():
    img0, _ = _pair(seed=13)
    ex = _pts(np.random.default_rng(14), 30, (0, 0), (320, 240))
    exv = np.random.default_rng(15).uniform(size=30) > 0.3
    pj, sj, fj = jcorners.detect(jnp.asarray(img0), max_corners=150,
                                 min_dist=16, exclude_pts=jnp.asarray(ex),
                                 exclude_valid=jnp.asarray(exv), border=8)
    pt, st, ft = tcorners.detect(torch.tensor(img0), max_corners=150,
                                 min_dist=16, exclude_pts=torch.tensor(ex),
                                 exclude_valid=torch.tensor(exv), border=8)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    f = np.asarray(fj)
    np.testing.assert_array_equal(pt.numpy()[f], np.asarray(pj)[f])
    # the min-eigenvalue response is a float32 difference (tr - sqrt)
    # that cancels: compare against the map's scale
    sj = np.asarray(sj)
    np.testing.assert_allclose(st.numpy()[f], sj[f], rtol=0,
                               atol=1e-4 * np.abs(sj).max())
