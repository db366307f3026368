"""The port's image decoder (`io/image_io`) against OpenCV.

  * `imread` equals `cv2.imread` bit for bit (dtype, shape and bytes)
    in its three modes (grey = IMREAD_GRAYSCALE, bgr = IMREAD_COLOR,
    unchanged = IMREAD_UNCHANGED) on 8-bit grey, grey+alpha, RGB,
    RGBA, 8-bit palette (with and without tRNS) and 16-bit grey PNGs
    written by `cv2.imwrite`, by PIL and by the port's encoder with
    each of the filter types 0-4, and on 8- and 16-bit binary PGMs.
    OpenCV 5.0's IMREAD_GRAYSCALE converts colour through libpng,
    `(9797 R + 19234 G + 3737 B) >> 15`, which `cvtColor` misses by one
    on about half the pixels: the RGB case holds the formula on 65,536
    random pixels.
  * The C unfilter (csrc/png_unfilter.c) equals its numpy twin on rows
    of every filter type at 1-8 bytes a pixel.
  * Interlaced and low-bit-depth PNGs, a bad filter byte and a bad
    signature raise ValueError; a missing file gives None.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

from dynamic_vins_tpu_torch.io import image_io

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

torch.set_num_threads(1)   # the xdist workers share the cores

H, W = 37, 53
FLAGS = {"grey": cv2.IMREAD_GRAYSCALE, "bgr": cv2.IMREAD_COLOR,
         "unchanged": cv2.IMREAD_UNCHANGED}


def _pixels(fmt, seed=0, h=H, w=W):
    """A random image of a format as cv2.imwrite takes it (BGR order),
    or a PIL image for the PIL-only formats."""
    rng = np.random.default_rng(seed)
    u8 = lambda *s: rng.integers(0, 256, (h, w) + s, dtype=np.uint8)
    if fmt == "grey8":
        return u8()
    if fmt == "grey16":
        return rng.integers(0, 65536, (h, w), dtype=np.uint16)
    if fmt == "rgb":
        return u8(3)
    if fmt == "rgba":
        return u8(4)
    if fmt == "grey_alpha":
        return Image.fromarray(u8(2), "LA")
    if fmt in ("palette", "palette_trns"):
        pal = Image.fromarray(u8(3)).quantize(256)
        if fmt == "palette_trns":
            pal.info["transparency"] = bytes(range(0, 256, 2))
        return pal
    raise ValueError(fmt)


def _write(writer, fmt, path, filter_type=0):
    px = _pixels(fmt)
    if isinstance(px, Image.Image):
        assert writer == "pil"
        px.save(path, **({"transparency": px.info["transparency"]}
                         if "transparency" in px.info else {}))
    elif writer == "cv2":
        assert cv2.imwrite(str(path), px)
    elif writer == "pil":
        mode = {"grey8": "L", "rgb": "RGB", "rgba": "RGBA"}[fmt]
        rgb = px[..., [2, 1, 0, 3][:px.shape[2]]] if px.ndim == 3 else px
        Image.fromarray(rgb, mode).save(path)
    else:
        image_io.imwrite(path, px, filter_type)


def _same_as_cv2(path, modes=tuple(FLAGS)):
    for mode in modes:
        ref = cv2.imread(str(path), FLAGS[mode])
        got = image_io.imread(path, mode)
        assert got.dtype == ref.dtype and got.shape == ref.shape, \
            (mode, got.dtype, got.shape, ref.dtype, ref.shape)
        np.testing.assert_array_equal(got, ref, err_msg=mode)


CASES = ([("cv2", f, 0) for f in ("grey8", "grey16", "rgb", "rgba")]
         + [("pil", f, 0) for f in ("grey8", "rgb", "rgba", "grey_alpha",
                                    "palette", "palette_trns")]
         + [("port", f, ft) for f in ("grey8", "grey16", "rgb", "rgba")
            for ft in range(5)])


@pytest.mark.parametrize("writer,fmt,filter_type", CASES)
def test_decoder_equals_cv2(tmp_path, writer, fmt, filter_type):
    path = tmp_path / "img.png"
    _write(writer, fmt, path, filter_type)
    if writer == "port":
        # the encoder really wrote that filter type on every row
        data = path.read_bytes()
        ihdr_end = 8 + 8 + 13 + 4
        n = struct.unpack(">I", data[ihdr_end:ihdr_end + 4])[0]
        raw = zlib.decompress(data[ihdr_end + 8:ihdr_end + 8 + n])
        stride = len(raw) // H
        assert {raw[r * stride] for r in range(H)} == {filter_type}
    _same_as_cv2(path)


def test_grey_is_libpng_formula(tmp_path):
    rgb = np.random.default_rng(7).integers(0, 256, (256, 256, 3),
                                           dtype=np.uint8)
    path = tmp_path / "rgb.png"
    Image.fromarray(rgb, "RGB").save(path)
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    want = ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)
    np.testing.assert_array_equal(image_io.imread(path, "grey"), want)
    np.testing.assert_array_equal(cv2.imread(str(path),
                                             cv2.IMREAD_GRAYSCALE), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_pgm_equals_cv2(tmp_path, dtype):
    px = np.random.default_rng(3).integers(0, np.iinfo(dtype).max + 1,
                                           (H, W)).astype(dtype)
    path = tmp_path / "img.pgm"
    assert cv2.imwrite(str(path), px)
    _same_as_cv2(path)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_equals_plain(bpp):
    rng = np.random.default_rng(bpp)
    rows, stride = 41, bpp * 29
    data = rng.integers(0, 256, (rows, stride + 1), dtype=np.uint8)
    data[:, 0] = rng.integers(0, 5, rows)
    data[:5, 0] = np.arange(5)
    got = image_io.unfilter(data.ravel(), rows, stride, bpp)
    ref = image_io.unfilter_plain(data.ravel(), rows, stride, bpp)
    np.testing.assert_array_equal(got, ref)
    # and the encoder's filters invert it
    raw = rng.integers(0, 256, (rows, stride), dtype=np.uint8)
    for ft in range(5):
        lines = image_io.filter_rows(raw, bpp, ft)
        np.testing.assert_array_equal(
            image_io.unfilter(lines.ravel(), rows, stride, bpp), raw)


def _patched_ihdr(data, depth=None, interlace=None):
    W_, H_, d, ct, c, f, i = struct.unpack(">IIBBBBB", data[16:29])
    body = struct.pack(">IIBBBBB", W_, H_, depth or d, ct, c, f,
                       i if interlace is None else interlace)
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    return data[:16] + body + crc + data[33:]


def test_unsupported_and_malformed_raise(tmp_path):
    good = image_io.encode_png(_pixels("grey8"))
    with pytest.raises(ValueError, match="interlaced"):
        image_io.decode_png(_patched_ihdr(good, interlace=1))
    for mode in ("1", "P"):          # 1-bit, and a 16-colour palette
        img = Image.fromarray(_pixels("rgb")).convert(mode)
        if mode == "P":
            img = Image.fromarray(_pixels("rgb")).quantize(16)
        path = tmp_path / f"low_{mode}.png"
        img.save(path)
        assert path.read_bytes()[24] < 8          # bit depth below 8
        with pytest.raises(ValueError, match="bit depth"):
            image_io.imread(path)
    bad = bytearray(zlib.decompress(good[41:41 + struct.unpack(
        ">I", good[33:37])[0]]))
    bad[(W + 1) * 3] = 7                           # row 3: filter type 7
    with pytest.raises(ValueError, match="row 3"):
        image_io.unfilter(np.frombuffer(bytes(bad), np.uint8), H, W, 1)
    with pytest.raises(ValueError, match="signature"):
        image_io.decode_png(b"GIF89a" + good[6:])
    with pytest.raises(ValueError, match="mode"):
        image_io.decode_png(good, "rgb")
    assert image_io.imread(tmp_path / "missing.png") is None
