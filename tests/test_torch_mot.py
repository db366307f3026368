"""Port parity: the multi-object tracker (the box Kalman filter, IoU
gating per class, two-stage Hungarian assignment, track lifecycle)
against the JAX package's `mot/`, on seeded detection streams: three
boxes moving with noise, one of them missed for two frames, one of
another class on top of another, a late new object, and a gate that
rejects a jump. The same track ids every frame, the same tracks with
the same hits, ages and flags, their Kalman states and covariances
within 1e-12.
"""

import numpy as np
import pytest

from dynamic_vins_tpu.mot import kalman as jkal
from dynamic_vins_tpu.mot import tracker as jmot
from dynamic_vins_tpu_torch.mot import kalman as tkal
from dynamic_vins_tpu_torch.mot import tracker as tmot

TOL = 1e-12


def _stream(seed, frames=14):
    """Per frame: (boxes [N,4] tlbr, classes [N])."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(frames):
        boxes, cls = [], []
        for i, (x0, y0, vx, vy, c) in enumerate(
                [(10, 20, 6, 0, 2), (200, 50, 0, 4, 2),
                 (120, 100, -3, 1, 0), (126, 104, -3, 1, 7)]):
            if i == 1 and k in (5, 6):          # missed detection
                continue
            if i == 3 and k < 3:                # a late new object
                continue
            x, y = x0 + vx * k, y0 + vy * k
            if i == 2 and k == 9:               # a jump the gate rejects
                x += 80
            b = np.array([x, y, x + 50, y + 70], float)
            boxes.append(b + rng.normal(scale=1.5, size=4))
            cls.append(c)
        order = rng.permutation(len(boxes))
        out.append((np.stack(boxes)[order], np.asarray(cls)[order]))
    return out


def test_box_kalman_matches():
    rng = np.random.default_rng(0)
    box = [10.0, 10.0, 50.0, 90.0]
    kj = jkal.BoxKalman(jkal.xyah_from_tlbr(box))
    kt = tkal.BoxKalman(tkal.xyah_from_tlbr(box))
    for k in range(12):
        np.testing.assert_allclose(kt.predict(), kj.predict(), rtol=0,
                                   atol=TOL)
        if k % 4 != 3:
            z = jkal.xyah_from_tlbr(np.array(box) + 5 * k
                                    + rng.normal(scale=2.0, size=4))
            kj.update(z)
            kt.update(z)
        np.testing.assert_allclose(kt.x, kj.x, rtol=0, atol=TOL)
        np.testing.assert_allclose(kt.P, kj.P, rtol=0, atol=TOL)
        np.testing.assert_allclose(kt.tlbr, kj.tlbr, rtol=0, atol=TOL)
    assert tmot.iou([0, 0, 10, 10], [5, 0, 15, 10]) == \
        jmot.iou([0, 0, 10, 10], [5, 0, 15, 10])


@pytest.mark.parametrize("seed,n_init,max_age", [(0, 3, 5), (1, 2, 1),
                                                 (2, 1, 3)])
def test_multi_object_tracker_matches(seed, n_init, max_age):
    mj = jmot.MultiObjectTracker(jmot.MotConfig(n_init=n_init,
                                                max_age=max_age))
    mt = tmot.MultiObjectTracker(tmot.MotConfig(n_init=n_init,
                                                max_age=max_age))
    for k, (boxes, cls) in enumerate(_stream(seed)):
        oj = mj.update(boxes, classes=cls)
        ot = mt.update(boxes, classes=cls)
        assert ot == oj, k
        assert len(mt.tracks) == len(mj.tracks)
        for a, b in zip(mt.tracks, mj.tracks):
            assert (a.track_id, a.cls, a.hits, a.age, a.time_since_update,
                    a.confirmed) == (b.track_id, b.cls, b.hits, b.age,
                                     b.time_since_update, b.confirmed)
            np.testing.assert_allclose(a.kf.x, b.kf.x, rtol=0, atol=TOL)
            np.testing.assert_allclose(a.kf.P, b.kf.P, rtol=0, atol=TOL)
        assert [t.track_id for t in mt.visible_tracks()] == \
            [t.track_id for t in mj.visible_tracks()]
    # an empty frame and a class gate: the same box, another class
    assert mt.update(np.zeros((0, 4))) == mj.update(np.zeros((0, 4)))
    b = _stream(seed)[-1][0][:1]
    assert mt.update(b, classes=[5]) == mj.update(b, classes=[5])
