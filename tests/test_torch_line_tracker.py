"""The port's line tracker (`frontend/line_tracker.py`) against the JAX
package's, which detects with cv2's LSD: `detect_lines` with and without
a mask, `_balanced_select`, and `LineTracker.track` over 3 shifted
frames with a right image: the same segments (float32 endpoints equal),
ids and right matches.

Descriptors agree within 1e-5: both place the samples in float64 and
interpolate the float32 image, but torch and XLA reduce the profile's
mean and norm in other orders, which moves the last float32 bits (in
float32 sample points alone they would part by ~1e-4: a coordinate
near 300 px keeps 2e-5 px). `match_lines` gates on a 0.6 correlation
and orders by it; the matches are equal here, their margins far above
1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.frontend import line_tracker as jlt
from dynamic_vins_tpu_torch.frontend import line_tracker as tlt

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(1)   # the xdist workers share the cores


def _line_image(offset=(0, 0), seed=0):
    """tests/test_line_tracker.py's image."""
    rng = np.random.default_rng(seed)
    img = np.full((240, 320), 40, np.uint8)
    img = img + rng.integers(0, 10, size=img.shape).astype(np.uint8)
    dx, dy = offset
    for (x1, y1), (x2, y2) in [((40, 50), (200, 60)), ((60, 180), (250, 150)),
                               ((150, 30), (160, 200)),
                               ((260, 40), (280, 220))]:
        cv2.line(img, (x1 + dx, y1 + dy), (x2 + dx, y2 + dy), 220, 2,
                 cv2.LINE_AA)
    return img


def _same_segs(a, b):
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert tuple(x) == tuple(y)


@pytest.mark.parametrize("masked", [False, True])
def test_detect_lines_matches(masked):
    img = _line_image()
    mask = None
    if masked:
        mask = np.ones(img.shape, bool)
        mask[:, :170] = False
    for min_length in (40.0, 10.0):
        _same_segs(tlt.detect_lines(img, tlt.LineTrackerConfig(
                       min_length=min_length), mask),
                   jlt.detect_lines(img, jlt.LineTrackerConfig(
                       min_length=min_length), mask))
    # the budget binds: the balanced selection
    _same_segs(tlt.detect_lines(img, tlt.LineTrackerConfig(
                   min_length=5.0, max_lines=6), mask),
               jlt.detect_lines(img, jlt.LineTrackerConfig(
                   min_length=5.0, max_lines=6), mask))


def test_balanced_select_matches():
    horiz = [(0.0, float(i), 100.0 + i, float(i)) for i in range(20)]
    vert = [(float(i), 0.0, float(i), 40.0 + i) for i in range(6)]
    rng = np.random.default_rng(2)
    rand = [tuple(float(v) for v in rng.uniform(0, 300, 4))
            for _ in range(40)]
    for segs in (horiz + vert, horiz + vert[:2], rand, vert):
        for budget in (4, 10, 25):
            js = sorted((jlt.LineSeg(*s) for s in segs),
                        key=lambda s: -s.length)
            ts = sorted((tlt.LineSeg(*s) for s in segs),
                        key=lambda s: -s.length)
            assert [tuple(s) for s in tlt._balanced_select(ts, budget)] == \
                [tuple(s) for s in jlt._balanced_select(js, budget)]


def test_track_matches_over_shifted_frames():
    cfg = dict(min_length=40)
    jt = jlt.LineTracker(jlt.LineTrackerConfig(**cfg))
    tt = tlt.LineTracker(tlt.LineTrackerConfig(**cfg))
    n_right = 0
    for k, off in enumerate([(0, 0), (6, 4), (11, 7)]):
        left = _line_image(off, seed=k)
        right = _line_image((off[0] - 8, off[1]), seed=10 + k)
        if k == 2:
            left = left.astype(np.float32) + 0.7    # truncated to uint8
        sj, rj = jt.track(left, img_right=right)
        st, rt = tt.track(left, img_right=right)
        _same_segs(st, sj)
        assert [s.id for s in st] == [s.id for s in sj]
        assert sorted(rt) == sorted(rj)
        for i in rt:
            assert tuple(rt[i]) == tuple(rj[i])
        n_right += len(rt)
        np.testing.assert_allclose(tt.prev_desc, jt.prev_desc, rtol=0,
                                   atol=1e-5)
    assert n_right >= 4
    # ids carried across the shift
    assert len({s.id for s in st} & set(range(8))) >= 3
    # descriptors of the same segments, each package's sampler
    segs = [tlt.LineSeg(*s[:4]) for s in st]
    img = _line_image((11, 7), seed=2).astype(np.float32)
    np.testing.assert_allclose(
        tlt._descriptors(torch.tensor(img), segs, 16),
        jlt._descriptors(jnp.asarray(img), [jlt.LineSeg(*s) for s in segs],
                         16), rtol=0, atol=1e-5)
