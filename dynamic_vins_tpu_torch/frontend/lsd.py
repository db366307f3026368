"""OpenCV's line segment detector without OpenCV.

`detect(img)` returns what `cv2.createLineSegmentDetector().detect(img)[0]`
returns with the detector's defaults (LSD_REFINE_STD, scale 0.8): the
same segments in the same order, float32 endpoints equal, as an [N,4]
array (x1, y1, x2, y2), empty where OpenCV returns None. It runs on the
host, as the reference's line detector does: `csrc/lsd.cpp`, built with
the host C++ compiler at first use (`ops/build.py`) and called through
ctypes. The blur and resize stages are exposed for their tests.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np

SCALE = 0.8
SIGMA_SCALE = 0.6

_lib = None


def _native():
    global _lib
    if _lib is None:
        from dynamic_vins_tpu_torch.ops import build

        lib = build.load("lsd")
        u8p, f32p = ctypes.c_void_p, ctypes.c_void_p
        lib.lsd_detect.restype = ctypes.c_int
        lib.lsd_detect.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_double, f32p, ctypes.c_int]
        lib.lsd_gaussian_blur.restype = None
        lib.lsd_gaussian_blur.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_double,
                                          u8p]
        lib.lsd_resize_linear_exact.restype = None
        lib.lsd_resize_linear_exact.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_double]
        _lib = lib
    return _lib


def _u8(img) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"an 8-bit single-channel image is needed, got "
                         f"{img.dtype} {img.shape}")
    return img


def detect(img, scale: float = SCALE) -> np.ndarray:
    """Segments [N,4] float32 (x1, y1, x2, y2) of an 8-bit image."""
    img = _u8(img)
    h, w = img.shape
    cap = max(64, h * w // 256)
    while True:
        out = np.empty((cap, 4), np.float32)
        n = _native().lsd_detect(img.ctypes.data, h, w, float(scale),
                                 out.ctypes.data, cap)
        if n < 0:
            raise ValueError(f"image {h}x{w} too small for scale {scale}")
        if n <= cap:
            return out[:n].copy()
        cap = n


def gaussian_blur(img, ksize: int, sigma: float) -> np.ndarray:
    """`cv2.GaussianBlur(img, (ksize, ksize), sigma)` of an 8-bit image
    (the bit-exact fixed-point path, BORDER_DEFAULT)."""
    img = _u8(img)
    out = np.empty_like(img)
    _native().lsd_gaussian_blur(img.ctypes.data, img.shape[0],
                                img.shape[1], int(ksize), float(sigma),
                                out.ctypes.data)
    return out


def resize_linear_exact(img, fx: float, fy: float) -> np.ndarray:
    """`cv2.resize(img, None, fx=fx, fy=fy,
    interpolation=cv2.INTER_LINEAR_EXACT)` of an 8-bit image."""
    img = _u8(img)
    h, w = img.shape
    # cv::resize's output size: saturate_cast<int>, round to nearest even
    dw, dh = int(round(w * fx)), int(round(h * fy))
    out = np.empty((dh, dw), np.uint8)
    _native().lsd_resize_linear_exact(img.ctypes.data, h, w,
                                      out.ctypes.data, dh, dw, float(fx),
                                      float(fy))
    return out


def blur_kernel_size(scale: float = SCALE) -> tuple:
    """(ksize, sigma) of the detector's pre-blur at a scale below 1."""
    sigma = SIGMA_SCALE / scale
    h = math.ceil(sigma * math.sqrt(2 * 3 * math.log(10.0)))
    return 1 + 2 * h, sigma
