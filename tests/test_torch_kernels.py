"""The hand-written CUDA kernels against their plain torch versions, on
the card. Skips without a card (a CUDA kernel has no CPU mode).

This file imports no JAX, so the card's machine (which has none) runs it
with the repository's conftest left out:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from dynamic_vins_tpu_torch.frontend import pyramid as tpyr
from dynamic_vins_tpu_torch.ops import lk_level as tk

torch.set_num_threads(1)   # the xdist workers share the cores

FLOW_ATOL = 1e-3      # px; float32 sums in another order than torch's


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
@pytest.mark.parametrize("kind", [0, 1])
def test_lk_kernel_matches_plain(cuda_device, kind):
    args = [a.to(cuda_device) for a in _case(kind)]
    before = tk.launches
    fk, okk = tk.lk_level(*args, radius=10, iters=10)
    torch.cuda.synchronize()
    assert tk.launches == before + 1
    fp, okp = tk.lk_level_plain(*args, radius=10, iters=10)
    np.testing.assert_array_equal(okk.cpu().numpy(), okp.cpu().numpy())
    ok = okp.cpu().numpy()
    np.testing.assert_allclose(fk.cpu().numpy()[ok], fp.cpu().numpy()[ok],
                               rtol=0, atol=FLOW_ATOL)
