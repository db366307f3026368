"""Port parity: the ORB extractor (`frontend/orb.py`) against the JAX
package's, and the reference's own ORB checks (tests/test_orb.py) run on
the port.

Inputs are 8-bit images (tests/test_orb.py's blob image, and a rendered
376x240 frame of tests/test_loop_closure.py's circle scene, rounded to
integer grey levels). On them every FAST and centroid sum of level 0 is
an exact integer in float32, so FAST scores, keypoints and levels are
equal and angles agree to 1e-5 rad (the arctan2s' last bits). Levels 1
and up resize the image: JAX's and the port's float32 resize weigh the
same taps but XLA's CPU dot sums them in another order than torch's
matmul, so those levels' pixels differ in the last bit and their
responses agree to rtol 1e-6 (keypoints and levels stay equal). A
descriptor bit can flip only where a rotated test point rounds at .5;
flipped descriptors are counted and held to 1% of the keypoints (0 on
these images, CPU run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.frontend import orb as jorb
from dynamic_vins_tpu.sim import render
from dynamic_vins_tpu_torch.frontend import orb as torb
from dynamic_vins_tpu_torch.models.layers import resize
from test_loop_closure import _circle_scene
from test_orb import _checker_img

torch.set_num_threads(1)   # the xdist workers share the cores

ANGLE_ATOL = 1e-5          # rad
RESP_RTOL = 1e-6           # levels 1 and up (resized)
DESC_FLIP_SHARE = 0.01


def _checker8():
    return np.round(_checker_img()).astype(np.float32)


def _rendered8():
    rig, poses, landmarks, inten = _circle_scene()
    p, q = poses[5]
    img = render.render_frame(rig, jnp.asarray(p), jnp.asarray(q),
                              landmarks, inten, cam=0)
    return np.round(np.asarray(img)).astype(np.float32)


IMAGES = {"checker": _checker8, "rendered": _rendered8}


@pytest.fixture(scope="module")
def images():
    return {k: f() for k, f in IMAGES.items()}


def _check(rj, rt, level0_only=False):
    """Equal keypoints, levels and (level 0) responses; angles, the
    resized levels' responses and the descriptors within the module's
    bounds. Returns the count of flipped descriptors."""
    lv = np.asarray(rj.level)
    np.testing.assert_array_equal(rt.xy.numpy(), np.asarray(rj.xy))
    np.testing.assert_array_equal(rt.level.numpy(), lv)
    rj_resp, rt_resp = np.asarray(rj.response), rt.response.numpy()
    np.testing.assert_array_equal(rt_resp[lv == 0], rj_resp[lv == 0])
    np.testing.assert_allclose(rt_resp, rj_resp, rtol=RESP_RTOL, atol=0)
    assert level0_only is False or (lv == 0).all()
    np.testing.assert_allclose(rt.angle.numpy(), np.asarray(rj.angle),
                               rtol=0, atol=ANGLE_ATOL)
    flips = int((rt.desc.numpy() != np.asarray(rj.desc)).any(1).sum())
    assert flips <= DESC_FLIP_SHARE * len(lv), flips
    return flips


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_fast_score_matches_jax(images, name):
    img = images[name]
    sj = np.asarray(jorb.fast_score(jnp.asarray(img), 20.0))
    st = torb.fast_score(torch.from_numpy(img), 20.0).numpy()
    assert (sj > 0).sum() > 50
    np.testing.assert_array_equal(st, sj)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_extract_level_matches_jax(images, name):
    img = images[name]
    rj = jorb._extract_level(jnp.asarray(img), 20.0, 100, 16, 0, 1.0)
    rt = torb._extract_level(torch.from_numpy(img), 20.0, 100, 16, 0, 1.0)
    _check(rj, rt, level0_only=True)


@pytest.mark.parametrize("name", sorted(IMAGES))
@pytest.mark.parametrize("n_features,n_levels", [(128, 2), (96, 1),
                                                 (300, 3)])
def test_orb_extractor_matches_jax(images, name, n_features, n_levels):
    img = images[name]
    rj = jorb.OrbExtractor(n_features=n_features, n_levels=n_levels)(img)
    rt = torb.OrbExtractor(n_features=n_features, n_levels=n_levels)(img)
    assert rt.desc.dtype == torch.uint8 and rt.level.dtype == torch.int32
    _check(rj, rt)


def test_resize_matches_jax_resize(images):
    """The pyramid's resize (`models.layers.resize`): JAX's weights,
    float32 last-bit agreement."""
    img = images["rendered"]
    for hw in [(200, 313), (166, 261)]:
        a = np.asarray(jax.image.resize(jnp.asarray(img), hw, "bilinear"))
        b = resize(torch.from_numpy(img), hw).numpy()
        np.testing.assert_allclose(b, a, rtol=2e-6, atol=1e-4)


def test_match_descriptors_matches_jax(images):
    img = images["checker"]
    img2 = np.roll(img, (3, 5), (0, 1))
    orb = torb.OrbExtractor(n_features=96, n_levels=1)
    d1 = orb(img).desc.numpy()
    d2 = orb(img2).desc.numpy()
    for max_dist in (40, 64):
        mj = jorb.match_descriptors(d1, d2, max_dist=max_dist)
        mt = torb.match_descriptors(d1, d2, max_dist=max_dist)
        assert len(mt) >= 6
        np.testing.assert_array_equal(mt, mj)


# tests/test_orb.py's checks, on the port

def test_fast_detects_blob_corners():
    img = _checker_img()
    res = torb.OrbExtractor(n_features=128, n_levels=2)(img)
    valid = res.response.numpy() > 0
    assert valid.sum() > 20
    xy = res.xy.numpy()[valid]
    assert xy[:, 0].max() < img.shape[1]
    assert np.all(np.isfinite(res.angle.numpy()))


def test_orb_matching_under_shift():
    """Descriptors of the same scene shifted by a few px must match."""
    img = _checker_img()
    img2 = np.roll(img, (3, 5), (0, 1))
    orb = torb.OrbExtractor(n_features=96, n_levels=1)
    r1, r2 = orb(img), orb(img2)
    v1 = r1.response.numpy() > 0
    v2 = r2.response.numpy() > 0
    m = torb.match_descriptors(r1.desc.numpy()[v1], r2.desc.numpy()[v2],
                               max_dist=40)
    assert len(m) >= 6
    xy1 = r1.xy.numpy()[v1][m[:, 0]]
    xy2 = r2.xy.numpy()[v2][m[:, 1]]
    med = np.median(xy2 - xy1, axis=0)
    assert np.allclose(med, [5.0, 3.0], atol=1.5)


def test_orb_rotation_invariant_angle():
    res = torb.OrbExtractor(n_features=64, n_levels=1)(_checker_img())
    a = res.angle.numpy()
    assert np.all((a >= -np.pi) & (a <= np.pi))
