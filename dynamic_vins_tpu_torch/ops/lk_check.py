"""Holding the LK track kernel against its plain version: the inputs
that reach the borders, and the comparison with its one exemption.

The kernel's `ok` may differ from the plain version's only where a
float32 rounding decides it: a feature whose fb_err lies within NEAR_PX
of fb_thresh, or whose pts1 lies within NEAR_PX of the border.
`chip_smoke.py` and `tests/test_torch_kernels.py` use these.
"""

from __future__ import annotations

from dynamic_vins_tpu_torch.ops import lk_level as K

NEAR_PX = 1e-5


def with_border_tail(pts, nf, H, W, rng):
    """pts [N,2] numpy whose slots from nf on are replaced by points
    within 12 px of the borders (the unfilled tail)."""
    n = pts.shape[0] - nf
    edge = rng.uniform([1, 1], [W - 1, H - 1], size=(n, 2))
    side = rng.integers(0, 4, size=n)
    d = rng.uniform(0.5, 12.0, size=n)
    edge[side == 0, 0] = d[side == 0]
    edge[side == 1, 0] = W - d[side == 1]
    edge[side == 2, 1] = d[side == 2]
    edge[side == 3, 1] = H - d[side == 3]
    pts = pts.copy()
    pts[nf:] = edge
    return pts


def near_threshold(pyr0, pyr1, pts, valid, pts1, fb_thresh, border,
                   fb_levels, radius=10):
    """[N] bool: features whose plain fb_err lies within NEAR_PX of
    fb_thresh (their plain ok differs between thresholds fb_thresh -+
    NEAR_PX), or whose plain pts1 lies within NEAR_PX of the border."""
    kw = dict(radius=radius, border=border, fb_levels=fb_levels)
    ok_lo = K.lk_track_plain(pyr0, pyr1, pts, valid,
                             fb_thresh=fb_thresh - NEAR_PX, **kw)[1]
    ok_hi = K.lk_track_plain(pyr0, pyr1, pts, valid,
                             fb_thresh=fb_thresh + NEAR_PX, **kw)[1]
    H, W = pyr0[0].shape
    lim = pts1.new_tensor([[border, border]])
    near = ((pts1 - lim).abs() < NEAR_PX) | (
        (pts1 - pts1.new_tensor([[W - border, H - border]])).abs()
        < NEAR_PX)
    return (ok_lo != ok_hi) | near.any(dim=1)


def compare_track(kernel, plain, near):
    """(max |pts1 err| px, features whose ok differs outside `near`,
    features whose ok differs inside it)."""
    (pk, okk), (pp, okp) = kernel, plain
    err = float((pk - pp).abs().max())
    diff = okk != okp
    return err, int((diff & ~near).sum()), int((diff & near).sum())
