"""The hand-written CUDA kernels against their plain torch versions, on
the card. Skips without a card (a CUDA kernel has no CPU mode).

This file imports no JAX, so the card's machine (which has none) runs it
with the repository's conftest left out:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest

The track kernel's `ok` may differ from the plain version's only on
features whose fb_err lies within 1e-5 px of fb_thresh or whose pts1
lies within 1e-5 px of the border (a float32 rounding decides them);
such features are counted and printed, and expected to be none.
"""

import numpy as np
import pytest
import torch

from dynamic_vins_tpu_torch.frontend import pyramid as tpyr
from dynamic_vins_tpu_torch.ops import lk_check
from dynamic_vins_tpu_torch.ops import lk_level as tk

torch.set_num_threads(1)   # the xdist workers share the cores

FLOW_ATOL = 1e-3      # px; float64 sums in another order than torch's


def _pair(shift, seed, H, W):
    rng = np.random.default_rng(seed)
    img0 = tpyr.gaussian_blur5(torch.tensor(rng.uniform(0, 255, (H, W)),
                                            dtype=torch.float32))
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    img1 = tpyr.bilinear_sample(
        img0, torch.stack([xx - shift[0], yy - shift[1]], -1))
    return img0, img1


def _case(kind):
    rng = np.random.default_rng(kind)
    if kind == 0:     # level-0 sized, interior, zero guess
        img0, img1 = _pair((3.2, -2.4), 0, 480, 752)
        pts = rng.uniform([20, 20], [730, 460], size=(150, 2))
        guess = np.zeros((150, 2))
    else:             # coarse level: borders and clamped guesses
        img0, img1 = _pair((1.5, -1.0), 7, 60, 94)
        pts = rng.uniform([1, 1], [93, 59], size=(150, 2))
        guess = rng.normal(scale=3.0, size=(150, 2))
        guess[::5] = [40.0, -30.0]
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    return img0, img1, f(pts), f(guess)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [10, 8])
@pytest.mark.parametrize("kind", [0, 1])
def test_lk_kernel_matches_plain(cuda_device, kind, radius):
    args = [a.to(cuda_device) for a in _case(kind)]
    before = tk.launches
    fk, okk = tk.lk_level(*args, radius=radius, iters=10)
    torch.cuda.synchronize()
    assert tk.launches == before + 1
    fp, okp = tk.lk_level_plain(*args, radius=radius, iters=10)
    np.testing.assert_array_equal(okk.cpu().numpy(), okp.cpu().numpy())
    ok = okp.cpu().numpy()
    np.testing.assert_allclose(fk.cpu().numpy()[ok], fp.cpu().numpy()[ok],
                               rtol=0, atol=FLOW_ATOL)


def _track_case(kind, device):
    """(pyr0, pyr1, pts, valid): a 4-level 752x480 pyramid pair with 150
    features, 40 of them within 12 px of the borders (kind 0), or a
    3-level 376x240 pair (94x60 coarse level) with a large shift, so that
    coarse guesses hit the img1 window clamp (kind 1); every seventh
    slot invalid."""
    H, W, levels, shift = ((480, 752, 4, (3.2, -2.4)) if kind == 0
                           else (240, 376, 3, (14.0, 6.0)))
    img0, img1 = _pair(shift, 30 + kind, H, W)
    rng = np.random.default_rng(40 + kind)
    pts = rng.uniform([20, 20], [W - 20, H - 20], size=(150, 2))
    pts = lk_check.with_border_tail(pts, 110, H, W, rng)
    valid = np.ones(150, bool)
    valid[::7] = False
    f = lambda a: a.to(device).contiguous()
    return ([f(a) for a in tpyr.build_pyramid(img0, levels)],
            [f(a) for a in tpyr.build_pyramid(img1, levels)],
            torch.tensor(pts, dtype=torch.float32, device=device),
            torch.tensor(valid, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,fb_levels", [(0, 1), (0, 4), (1, 1),
                                            (1, 3)])
def test_lk_track_kernel_matches_plain(cuda_device, kind, fb_levels):
    pyr0, pyr1, pts, valid = _track_case(kind, cuda_device)
    kw = dict(radius=10, iters=10, fb_thresh=0.5, border=8,
              fb_levels=fb_levels)
    before = (tk.launches, tk.track_launches)
    kern = tk.lk_track(pyr0, pyr1, pts, valid, **kw)
    torch.cuda.synchronize()
    assert (tk.launches, tk.track_launches) == (before[0], before[1] + 1)
    plain = tk.lk_track_plain(pyr0, pyr1, pts, valid, **kw)
    near = lk_check.near_threshold(pyr0, pyr1, pts, valid, plain[0], 0.5,
                                   8, fb_levels)
    err, bad, exempt = lk_check.compare_track(kern, plain, near)
    print(f"kind {kind} fb_levels {fb_levels}: max |pts1 err| {err:.2e} px,"
          f" ok differs on {bad} features and on {exempt} within 1e-5 px "
          f"of a threshold; ok {int(plain[1].sum())}/150")
    assert bad == 0
    assert err <= FLOW_ATOL
    assert not (kern[1] & ~valid).any()
    assert 0 < int(plain[1].sum()) < int(valid.sum())


def _instance_case(device):
    """(pyr0, pyr1, pts, valid): the instance tracker's track, a 3-level
    752x480 pyramid pair and K*N = 400 rows of which a third are valid
    (features on textured patches, 20 of them within 12 px of the
    borders), the rest stale positions spread over the image."""
    img0, img1 = _pair((2.5, -1.5), 50, 480, 752)
    rng = np.random.default_rng(51)
    pts = rng.uniform([20, 20], [732, 460], size=(400, 2))
    pts = lk_check.with_border_tail(pts, 380, 480, 752, rng)
    valid = np.zeros(400, bool)
    valid[rng.permutation(400)[:133]] = True
    valid[380:] = True
    f = lambda a: a.to(device).contiguous()
    return ([f(a) for a in tpyr.build_pyramid(img0, 3)],
            [f(a) for a in tpyr.build_pyramid(img1, 3)],
            torch.tensor(pts, dtype=torch.float32, device=device),
            torch.tensor(valid, device=device))


@pytest.mark.gpu
def test_lk_track_kernel_radius8_matches_plain(cuda_device):
    """The instance tracker's configuration: radius 8, 3 levels, fb 1.0
    px, border 3, seeded level-0 back-check."""
    pyr0, pyr1, pts, valid = _instance_case(cuda_device)
    kw = dict(radius=8, iters=10, fb_thresh=1.0, border=3, fb_levels=1)
    before = tk.track_launches
    kern = tk.lk_track(pyr0, pyr1, pts, valid, **kw)
    torch.cuda.synchronize()
    assert tk.track_launches == before + 1
    plain = tk.lk_track_plain(pyr0, pyr1, pts, valid, **kw)
    near = lk_check.near_threshold(pyr0, pyr1, pts, valid, plain[0], 1.0,
                                   3, 1, radius=8)
    err, bad, exempt = lk_check.compare_track(kern, plain, near)
    print(f"radius 8: max |pts1 err| {err:.2e} px, ok differs on {bad} "
          f"features and on {exempt} within 1e-5 px of a threshold; ok "
          f"{int(plain[1].sum())}/{int(valid.sum())} valid")
    assert bad == 0
    assert err <= FLOW_ATOL
    assert not (kern[1] & ~valid).any()
    assert 0 < int(plain[1].sum()) <= int(valid.sum())


@pytest.mark.gpu
def test_lk_kernels_refuse_other_radii(cuda_device):
    pyr0, pyr1, pts, valid = _instance_case(cuda_device)
    with pytest.raises(ValueError):
        tk.lk_track(pyr0, pyr1, pts, valid, radius=9)
    with pytest.raises(ValueError):
        tk.lk_level(pyr0[0], pyr1[0], pts, torch.zeros_like(pts), radius=7)
