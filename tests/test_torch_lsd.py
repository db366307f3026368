"""The port's line segment detector (`frontend/lsd.py`, csrc/lsd.cpp)
against `cv2.createLineSegmentDetector().detect` with its defaults
(LSD_REFINE_STD, scale 0.8): the same segments in the same order,
float32 endpoints equal, on drawn lines over noise, a rendered scene
with drawn lines at the tests' 376x240 and at the slice's 752x480,
random texture, flat steps with many equal gradient bins, a flat image
(no segments) and a 20x20 image; also at scale 1 (no blur, no resize).
Its blur and resize stages equal cv2.GaussianBlur (7x7, sigma 0.75)
and cv2.resize(INTER_LINEAR_EXACT, 0.8) byte for byte."""

import numpy as np
import pytest
import torch

from dynamic_vins_tpu_torch.frontend import lsd

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


def _rendered(scale):
    """The port's rendered scene (seed 4, 200 blobs) with 12 bright 2 px
    strokes."""
    from dynamic_vins_tpu_torch.sim import render, synthetic

    rig = render.small_rig(scale)
    seq = synthetic.generate_sequence(num_frames=1, num_landmarks=200,
                                      seed=4)
    img = render.render_frame(rig, seq.gt_p[0], seq.gt_q[0], seq.landmarks,
                              render.make_intensities(200, seed=4),
                              sigma=1.6 * scale * 2)
    img = np.ascontiguousarray(img.numpy().astype(np.uint8))
    rng = np.random.default_rng(5)
    for _ in range(12):
        p = rng.integers(0, [rig.width, rig.height], size=(2, 2))
        cv2.line(img, tuple(int(v) for v in p[0]),
                 tuple(int(v) for v in p[1]), 255, 2)
    return img


def _images():
    rng = np.random.default_rng(1)
    steps = np.add.outer(np.arange(200) // 20, np.arange(260) // 25) * 20
    return {
        "drawn_lines": _line_image(),
        "rendered_376x240": _rendered(0.5),
        "rendered_752x480": _rendered(1.0),
        "random_texture": cv2.GaussianBlur(
            rng.integers(0, 256, (240, 320)).astype(np.uint8), (9, 9), 2),
        "white_noise": rng.integers(0, 256, (120, 160)).astype(np.uint8),
        "flat_steps": steps.astype(np.uint8),
        "flat": np.full((50, 60), 77, np.uint8),
        "small_20x20": rng.integers(0, 256, (20, 20)).astype(np.uint8),
    }


IMAGES = _images()


def _cv2_segments(img, scale=None):
    det = cv2.createLineSegmentDetector() if scale is None else \
        cv2.createLineSegmentDetector(cv2.LSD_REFINE_STD, scale)
    out = det.detect(img)[0]
    return np.zeros((0, 4), np.float32) if out is None else out.reshape(-1, 4)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_lsd_equals_opencv(name):
    img = IMAGES[name]
    ref = _cv2_segments(img)
    got = lsd.detect(img)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if name != "flat":
        assert len(ref) > 0
    ref1 = _cv2_segments(img, 1.0)
    np.testing.assert_array_equal(lsd.detect(img, 1.0), ref1)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_blur_and_resize_equal_opencv(name):
    img = IMAGES[name]
    k, sigma = lsd.blur_kernel_size()
    assert (k, sigma) == (7, 0.6 / 0.8)
    blur = cv2.GaussianBlur(img, (k, k), sigma)
    np.testing.assert_array_equal(lsd.gaussian_blur(img, k, sigma), blur)
    np.testing.assert_array_equal(
        lsd.resize_linear_exact(blur, 0.8, 0.8),
        cv2.resize(blur, None, fx=0.8, fy=0.8,
                   interpolation=cv2.INTER_LINEAR_EXACT))


def test_lsd_rejects_other_images():
    with pytest.raises(ValueError):
        lsd.detect(np.zeros((10, 10), np.float32))
    with pytest.raises(ValueError):
        lsd.detect(np.zeros((10, 10, 3), np.uint8))
