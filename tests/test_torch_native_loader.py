"""Port parity: the prefetching greyscale decoder against the JAX
package's `io/native_loader`, whose decoder is the native library
(`native/libdvio_runtime.so`: libpng, a PGM reader). On PNGs of every
colour type the native library takes (8-bit grey, grey+alpha, RGB, RGBA,
palette, 16-bit grey and colour, grey and palette of 1-4 bits, Adam7;
palette, grey and RGB with tRNS, whose native decode runs in a process
of its own), filters 0-4, written by the port's encoder, cv2
and this file's raw writer, and on P5 PGMs, `decode_image` is byte-equal
to the native one (rejections included); `PrefetchLoader(workers=2,
capacity=2)` gives the same (index, image) stream with a corrupt file
skipped; a JPEG raises, and no path reaches cv2."""

import json
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamic_vins_tpu.io import native_loader as jnl
from dynamic_vins_tpu_torch.io import image_io
from dynamic_vins_tpu_torch.io import native_loader as tnl

torch.set_num_threads(1)   # the xdist workers share the cores

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


@pytest.fixture(scope="module", autouse=True)
def _native():
    if not jnl.native_available():
        pytest.fail("native/libdvio_runtime.so does not load")


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pack_rows(samples, depth):
    """samples [h, w*nc] (ints) -> row bytes at `depth` bits a sample."""
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in samples]
    if depth == 8:
        return [r.astype(np.uint8).tobytes() for r in samples]
    bits = ((samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    return [np.packbits(r.reshape(-1).astype(np.uint8)).tobytes()
            for r in bits]


def _raw_png(px, depth, ctype, pre=b"", interlace=False, filt=0):
    """px [H, W, nc] ints -> PNG bytes (one filter type on every row)."""
    H, W, nc = px.shape
    bpp = max(1, nc * depth // 8)
    data = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_rows(sub.reshape(sub.shape[0], -1), depth)
        raw = np.frombuffer(b"".join(rows), np.uint8).reshape(len(rows), -1)
        data += image_io.filter_rows(raw, bpp, filt).tobytes()
    return (image_io.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                          0, 0, int(interlace)))
            + pre + _chunk(b"IDAT", zlib.compress(data))
            + _chunk(b"IEND", b""))


def _cases(tmp_path):
    """{name: path} of the files both decoders read."""
    rng = np.random.default_rng(0)
    H, W = 23, 37
    files = {}

    def put(name, data):
        p = tmp_path / name
        p.write_bytes(data)
        files[name] = str(p)

    g8 = rng.integers(0, 256, (H, W), dtype=np.uint8)
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    rgb[::3, ::4] = rgb[::3, ::4, :1]            # grey pixels in colour
    a8 = rng.integers(0, 256, (H, W, 1), dtype=np.uint8)
    for f in range(5):
        put(f"grey8_f{f}.png", image_io.encode_png(g8, f))
        put(f"rgb8_f{f}.png", image_io.encode_png(rgb, f))
        put(f"rgba8_f{f}.png", image_io.encode_png(
            np.concatenate([rgb, a8], 2), f))
    g16 = rng.integers(0, 65536, (H, W), dtype=np.uint16)
    rgb16 = rng.integers(0, 65536, (H, W, 3), dtype=np.uint16)
    put("grey16.png", image_io.encode_png(g16, 4))
    put("rgb16.png", image_io.encode_png(rgb16, 1))
    put("rgba16.png", image_io.encode_png(np.concatenate(
        [rgb16, rng.integers(0, 65536, (H, W, 1), dtype=np.uint16)], 2), 3))
    put("grey_alpha8.png", _raw_png(np.concatenate([g8[..., None], a8], 2),
                                    8, 4, filt=4))
    put("grey_alpha16.png", _raw_png(np.stack([g16, g16[::-1]], 2), 16, 4))
    pal = rng.integers(0, 256, (40, 3), dtype=np.uint8)
    idx = rng.integers(0, 40, (H, W, 1))
    plte = _chunk(b"PLTE", pal.tobytes())
    put("palette8.png", _raw_png(idx, 8, 3, pre=plte, filt=1))
    put("palette2.png", _raw_png(idx % 4, 2, 3, pre=plte))
    for d in (1, 2, 4):
        put(f"grey{d}.png", _raw_png(
            rng.integers(0, 1 << d, (H, W, 1)), d, 0, filt=d % 5))
    # a tRNS chunk beside an alpha channel is invalid: libpng ignores it
    put("rgba8_trns.png", _raw_png(np.concatenate([rgb, a8], 2), 8, 6,
                                   pre=_chunk(b"tRNS", b"\x00" * 6)))
    put("rgb8_adam7.png", _raw_png(rgb, 8, 2, interlace=True, filt=4))
    put("grey2_adam7.png", _raw_png(rng.integers(0, 4, (H, W, 1)), 2, 0,
                                    interlace=True, filt=3))
    put("tiny_adam7.png", _raw_png(rgb[:3, :2], 8, 2, interlace=True))
    put("rgb8_gama1.png", _raw_png(rgb, 8, 2, pre=_chunk(
        b"gAMA", struct.pack(">I", 100000))))
    put("grey8_srgb.png", _raw_png(g8[..., None], 8, 0,
                                   pre=_chunk(b"sRGB", b"\x00")))
    import cv2

    ok, enc = cv2.imencode(".png", rgb[..., ::-1])
    assert ok
    put("rgb8_cv2.png", enc.tobytes())
    ok, enc = cv2.imencode(".png", g16)
    put("grey16_cv2.png", enc.tobytes())
    # PGMs as the native reader takes or rejects them
    body = g8.tobytes()
    for name, hdr in (("std", b"P5\n37 23\n255\n"), ("tight", b"P5 37 23 9 "),
                      ("crlf", b"P5\r\n37 23\r\n255\r\n"),
                      ("signs", b"P5 +37 +23 0\n"),
                      ("comment", b"P5\n# made here\n37 23\n255\n"),
                      ("max300", b"P5\n37 23\n300\n"),
                      ("short", b"P5\n37 23\n255\n")):
        put(f"pgm_{name}.pgm", hdr + (body[:100] if name == "short"
                                      else body + b"tail"))
    # rejected PNGs
    good = image_io.encode_png(g8)
    i = good.index(b"IDAT")
    n = struct.unpack(">I", good[i - 4:i])[0]
    put("bad_idat_crc.png", good[:i + 4 + n] + b"\0\0\0\0"
        + good[i + 8 + n:])
    put("truncated.png", good[:i + 4 + n // 2])
    put("no_iend.png", good[:-12])
    put("bad_signature.png", b"\x89PNX" + good[4:])
    put("bad_ancillary_crc.png", good[:33] + struct.pack(">I", 4) + b"tIME"
        + b"abcd" + b"\0\0\0\0" + good[33:])
    put("garbage.png", b"\x89P" + bytes(rng.integers(0, 256, 200,
                                                       dtype=np.uint8)))
    put("tiny.bin", b"\x89P")
    return files


def test_decode_image_byte_equal(tmp_path):
    files = _cases(tmp_path)
    rejected = 0
    for name, path in files.items():
        j = jnl.decode_image(path)
        t = tnl.decode_image(path)
        assert (j is None) == (t is None), name
        if j is None:
            rejected += 1
            continue
        assert t.dtype == np.uint8 and t.shape == j.shape, name
        np.testing.assert_array_equal(t, j, err_msg=name)
    assert rejected == 8, rejected
    # the native size cap: too many pixels for max_hw gives None in both
    p = files["grey8_f0.png"]
    assert jnl.decode_image(p, (10, 10)) is None
    assert tnl.decode_image(p, (10, 10)) is None


def _native_in_subprocess(paths):
    """The native library's decode of each path, in a process of its
    own: on a tRNS PNG without an alpha channel it writes W bytes past
    its buffer, which may abort the process that called it."""
    code = (
        "import ctypes, json, sys\n"
        "lib = ctypes.CDLL(sys.argv[1])\n"
        "out = []\n"
        "for p in sys.argv[2:]:\n"
        "    buf = (ctypes.c_uint8 * (1 << 16))()\n"
        "    h, w = ctypes.c_int(), ctypes.c_int()\n"
        "    rc = lib.dvio_decode(p.encode(), buf, len(buf), "
        "ctypes.byref(h), ctypes.byref(w))\n"
        "    out.append([rc, h.value, w.value, "
        "bytes(buf[:h.value * w.value]).hex()])\n"
        "print(json.dumps(out))\n")
    lib = str(Path(jnl.__file__).resolve().parents[2] / "native"
              / "libdvio_runtime.so")
    proc = subprocess.run([sys.executable, "-c", code, lib, *paths],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return [None if rc else np.frombuffer(bytes.fromhex(b), np.uint8)
            .reshape(h, w) for rc, h, w, b in json.loads(proc.stdout)]


def test_trns_without_alpha_channel(tmp_path):
    """Palette, grey and RGB PNGs with tRNS: the native library returns
    (grey, alpha) pairs, W bytes a row (see the module docstring). The
    sizes leave the allocator's slack behind the native buffer at least
    W bytes, so its overrun stays inside memory it owns."""
    rng = np.random.default_rng(5)
    cases = []
    for k, (H, W) in enumerate(((5, 6), (3, 5), (9, 7), (2, 4))):
        pal = rng.integers(0, 256, (12, 3), dtype=np.uint8)
        plte = _chunk(b"PLTE", pal.tobytes())
        idx = rng.integers(0, 12, (H, W, 1))
        rgb = rng.integers(0, 256, (H, W, 3))
        rgb[0, 0] = rgb[-1, -1]
        g = rng.integers(0, 256, (H, W, 1))
        g16 = rng.integers(0, 65536, (H, W, 1))
        g16[1, 1] = 4097
        cases += [
            ("pal8", _raw_png(idx, 8, 3, pre=plte + _chunk(
                b"tRNS", bytes(range(0, 200, 30))), filt=k)),
            ("pal4", _raw_png(idx, 4, 3, pre=plte + _chunk(
                b"tRNS", b"\x00\x80"), filt=4 - k)),
            ("grey8", _raw_png(g, 8, 0, pre=_chunk(
                b"tRNS", struct.pack(">H", int(g[0, 0, 0]))))),
            ("grey2", _raw_png(g % 4, 2, 0, pre=_chunk(b"tRNS",
                                                        b"\x00\x02"))),
            ("grey16", _raw_png(g16, 16, 0, pre=_chunk(b"tRNS",
                                                        b"\x10\x01"))),
            ("rgb8", _raw_png(rgb, 8, 2, pre=_chunk(
                b"tRNS", struct.pack(">HHH", *rgb[0, 0])))),
            ("rgb16", _raw_png(rgb * 257, 16, 2, pre=_chunk(
                b"tRNS", struct.pack(">HHH", *(rgb[0, 0] * 257))))),
        ]
    paths = []
    for i, (name, data) in enumerate(cases):
        p = tmp_path / f"{i:02d}_{name}.png"
        p.write_bytes(data)
        paths.append(str(p))
    native = _native_in_subprocess(paths)
    for path, j in zip(paths, native):
        t = tnl.decode_image(path)
        assert j is not None and t is not None, path
        np.testing.assert_array_equal(t, j, err_msg=path)
    # the alpha bytes are there: a transparent pixel shows as a 0
    assert any((j[:, 1::2] == 0).any() for j in native)


def test_colour_managed_png_raises(tmp_path):
    """libpng applies gAMA/sRGB to RGB -> grey; the port raises there
    (the native result differs from the plain formula)."""
    rgb = np.random.default_rng(1).integers(0, 256, (9, 11, 3))
    for name, pre in (("gama", _chunk(b"gAMA", struct.pack(">I", 45455))),
                      ("srgb", _chunk(b"sRGB", b"\x00"))):
        p = tmp_path / f"{name}.png"
        p.write_bytes(_raw_png(rgb, 8, 2, pre=pre))
        plain = tmp_path / f"{name}_plain.png"
        plain.write_bytes(_raw_png(rgb, 8, 2))
        assert not np.array_equal(jnl.decode_image(str(p)),
                                  jnl.decode_image(str(plain)))
        with pytest.raises(NotImplementedError):
            tnl.decode_image(str(p))


def test_prefetch_stream_equal(tmp_path):
    rng = np.random.default_rng(2)
    paths = []
    for k in range(9):
        p = tmp_path / f"{k:03d}.png"
        img = rng.integers(0, 256, (31 + k, 45), dtype=np.uint8)
        data = image_io.encode_png(img, k % 5)
        if k == 4:
            data = data[:60]                    # corrupt: truncated
        p.write_bytes(data)
        paths.append(str(p))
    jl = jnl.PrefetchLoader(paths, workers=2, capacity=2)
    j = list(jl)
    jl.close()
    with tnl.PrefetchLoader(paths, workers=2, capacity=2) as loader:
        t = list(loader)
    assert [i for i, _ in t] == [i for i, _ in j] == [0, 1, 2, 3, 5, 6, 7,
                                                      8]
    for (_, a), (_, b) in zip(j, t):
        np.testing.assert_array_equal(b, a)
    # stopping early leaves no worker behind
    loader = tnl.PrefetchLoader(paths, workers=2, capacity=2)
    first = next(iter(loader))
    loader.close()
    assert first[0] == 0
    assert not any(th.is_alive() for th in loader._threads)


def test_jpeg_raises(tmp_path):
    import cv2

    img = np.random.default_rng(3).integers(0, 256, (16, 16), np.uint8)
    ok, enc = cv2.imencode(".jpg", img)
    p = tmp_path / "a.jpg"
    p.write_bytes(enc.tobytes())
    assert jnl.decode_image(str(p)) is not None    # libjpeg decodes it
    with pytest.raises(NotImplementedError, match="JPEG"):
        tnl.decode_image(str(p))
    png = tmp_path / "b.png"
    png.write_bytes(image_io.encode_png(img))
    with pytest.raises(NotImplementedError, match="JPEG"):
        list(tnl.PrefetchLoader([str(png), str(p)], workers=2, capacity=2))


def test_no_cv2(monkeypatch, tmp_path):
    """The port's loader reads without cv2 (the card's machine has
    none)."""
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    p = tmp_path / "a.png"
    img = np.arange(20 * 30, dtype=np.uint8).reshape(20, 30)
    p.write_bytes(image_io.encode_png(img, 4))
    assert tnl.native_available()
    np.testing.assert_array_equal(tnl.decode_image(str(p)), img)
    with tnl.PrefetchLoader([str(p)] * 3) as loader:
        assert [i for i, _ in loader] == [0, 1, 2]
