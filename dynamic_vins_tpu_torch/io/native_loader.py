"""Prefetching greyscale image decoder, without OpenCV.

The counterpart of the JAX package's `io/native_loader.py`, whose
decoder is `native/dvio_runtime.cpp` (libpng, libjpeg, a PGM reader):
worker threads read and decode files ahead of the consumer into a
bounded queue and hand them out in order, so disk and decode overlap
the device's work. The PNG reading (chunks, inflate, unfilter, Adam7,
1-16 bit samples) is `io/image_io.py`'s, with the row unfilter of
`csrc/png_unfilter.c` (built with the host C compiler at first use);
this module converts the samples as the native library does. It
returns what the native library returns, byte for byte, and does not
fall back to another decoder:

  * PNG (libpng with `png_set_strip_16`, `png_set_palette_to_rgb`,
    `png_set_expand_gray_1_2_4_to_8`, `png_set_tRNS_to_alpha`,
    `png_set_strip_alpha` for colour types with an alpha channel, and
    `png_set_rgb_to_gray_fixed(png, 1, -1, -1)`): an alpha channel is
    dropped without compositing; colour becomes grey by libpng's default
    coefficients, `(6968 R + 23434 G + 2366 B) >> 15` on 8-bit samples
    and `(... + 16384) >> 15` on 16-bit ones before their high byte is
    kept (libpng converts before it strips to 8 bits); grey of 1, 2 or 4
    bits is scaled to 8; Adam7 interlacing is undone. A colour PNG whose
    colour space libpng would apply (a significant gAMA, or sRGB, cHRM,
    iCCP) raises NotImplementedError: libpng's gamma tables are not
    reproduced.
  * The trap, a PNG without an alpha channel but with a tRNS chunk: the
    native library's tRNS becomes an alpha channel that it does not
    strip, so libpng writes grey+alpha rows of 2 W bytes into its W-byte
    rows. Each row of the result holds the first W bytes of that row's
    (grey, alpha) pairs, the next row overwriting the rest (the last
    row's rest lands past the native buffer's end). Those are the bytes
    the native library returns, and this decoder returns them too.
  * PGM: binary P5 only, read as `fscanf("%2s %d %d %d")` reads the
    header (no comments), maxval at most 255 and not scaled, one byte
    after maxval, then width * height bytes.
  * JPEG raises NotImplementedError: the port has no JPEG decoder yet
    (ROADMAP.md queue 1, "JPEG in the loader"). The datasets the CLI
    reads are PNG.

A file that the native library rejects (a bad signature or CRC of a
critical chunk, missing image data, a malformed PGM header) is skipped
by `PrefetchLoader` and gives None from `decode_image`, as there.
"""

from __future__ import annotations

import struct
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from dynamic_vins_tpu_torch.io import image_io

JPEG_TODO = ("JPEG decoding is not ported: ROADMAP.md queue 1, "
             "'JPEG in the loader'")

# libpng's default rgb_to_gray coefficients (png_set_rgb_to_gray_fixed
# with negative weights), out of 32768
_RC, _GC = 6968, 23434
_BC = 32768 - _RC - _GC


def native_available() -> bool:
    """Whether the decoder's C part (the PNG row unfilter) builds and
    loads here."""
    try:
        image_io._native_unfilter()
    except (OSError, RuntimeError):
        return False
    return True


def _grey(px: np.ndarray, depth: int) -> np.ndarray:
    """RGB samples [H,W,3] -> grey uint8, libpng's fixed-point formula."""
    r, g, b = (px[..., i].astype(np.int64) for i in range(3))
    if depth == 16:
        return (((_RC * r + _GC * g + _BC * b + 16384) >> 15) >> 8) \
            .astype(np.uint8)
    return ((_RC * r + _GC * g + _BC * b) >> 15).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> grey uint8 [H,W] under the native rules."""
    info, chunks, first = image_io.png_info(data)
    if info.colour and info.managed:
        raise NotImplementedError(
            "a colour PNG with a colour space (gAMA, sRGB, cHRM, iCCP): "
            "libpng's gamma-corrected grey is not reproduced")
    px = image_io.png_samples(info, chunks, first)
    ctype, depth, trns = info.ctype, info.depth, info.trns
    H, W = info.height, info.width
    if ctype == 3:                                 # palette -> RGB
        pal = np.zeros((256, 3), np.uint8)         # out of range: black
        pal[:len(info.plte)] = info.plte[:256]
        grey = _grey(pal[px[..., 0]], 8)
    elif info.colour:
        grey = _grey(px[..., :3], depth)
    elif depth == 16:
        grey = (px[..., 0] >> 8).astype(np.uint8)
    else:
        grey = px[..., 0] * np.uint8(255 // ((1 << depth) - 1))
    if trns is None:
        return grey
    if ctype == 3:
        a = np.full(256, 255, np.uint8)
        a[:len(trns)] = np.frombuffer(trns, np.uint8)
        alpha = a[px[..., 0]]
    else:
        key = np.array(struct.unpack(f">{len(trns) // 2}H", trns))
        if depth < 16:
            key &= (1 << depth) - 1 if depth < 8 else 0xFF
        alpha = np.where((px == key).all(axis=-1), 0, 255).astype(np.uint8)
    return np.stack([grey, alpha], -1).reshape(H, 2 * W)[:, :W].copy()


def _scan_int(data: bytes, pos: int):
    """C `%d`: skip white space, an optional sign, then digits."""
    while pos < len(data) and data[pos] in b" \t\n\v\f\r":
        pos += 1
    start = pos
    if pos < len(data) and data[pos] in b"+-":
        pos += 1
    digits = pos
    while pos < len(data) and 48 <= data[pos] <= 57:
        pos += 1
    if pos == digits:
        raise ValueError("malformed PGM header")
    return int(data[start:pos]), pos


def decode_pgm(data: bytes) -> np.ndarray:
    """A binary PGM file's bytes -> uint8 [H,W] under the native rules."""
    if data[:2] != b"P5":
        raise ValueError("not a binary PGM (P5) file")
    W, pos = _scan_int(data, 2)
    H, pos = _scan_int(data, pos)
    maxval, pos = _scan_int(data, pos)
    if maxval > 255 or W < 0 or H < 0:
        raise ValueError(f"PGM {W}x{H}, maxval {maxval} not supported")
    pos += 1                                      # one byte, any
    n = W * H
    if len(data) - pos < n:
        raise ValueError("PGM pixel data is truncated")
    return np.frombuffer(data[pos:pos + n], np.uint8).reshape(H, W).copy()


def decode_bytes(data: bytes) -> np.ndarray:
    """A file's bytes -> grey uint8 [H,W], by its first bytes as the
    native library picks: PNG, JPEG (raises NotImplementedError) or P5
    PGM. Raises ValueError where the native library fails."""
    if len(data) < 4:
        raise ValueError("file shorter than 4 bytes")
    if data[0] == 0x89 and data[1:2] == b"P":
        return decode_png(data)
    if data[:2] == b"\xff\xd8":
        raise NotImplementedError(JPEG_TODO)
    if data[:2] == b"P5":
        return decode_pgm(data)
    raise ValueError("neither a PNG, a JPEG nor a P5 PGM file")


def _decode_file(path: str) -> np.ndarray:
    try:
        data = Path(path).read_bytes()
    except OSError as e:
        raise ValueError(str(e)) from None
    return decode_bytes(data)


def decode_image(path: str, max_hw: Tuple[int, int] = (2048, 4096)
                 ) -> Optional[np.ndarray]:
    """Decode one image to grey uint8 [H,W]; None where the native
    decoder fails or the image holds more than max_hw's pixels."""
    try:
        img = _decode_file(path)
    except ValueError:
        return None
    return img if img.size <= max_hw[0] * max_hw[1] else None


class PrefetchLoader:
    """Iterate `(index, grey image)` over `paths` in order, decoded by
    `workers` threads at most `capacity` frames ahead of the consumer.
    A file that fails to decode (or holds more than max_hw's pixels) is
    skipped; a JPEG or a colour-managed colour PNG raises
    NotImplementedError at its turn."""

    def __init__(self, paths: List[str], workers: int = 2,
                 capacity: int = 8,
                 max_hw: Tuple[int, int] = (2048, 4096)):
        self.paths = [str(p) for p in paths]
        self.max_hw = max_hw
        self.workers = workers if workers > 0 else 2
        self.capacity = capacity if capacity > 0 else 8
        self._cv = threading.Condition()
        self._done = {}             # index -> image, None or an exception
        self._next_fetch = 0
        self._next_out = 0
        self._stop = False
        self._threads = [threading.Thread(target=self._work, daemon=True)
                         for _ in range(self.workers)]
        for t in self._threads:
            t.start()

    def _work(self):
        while True:
            with self._cv:
                idx = self._next_fetch
                if self._stop or idx >= len(self.paths):
                    return
                self._next_fetch += 1
            try:
                img = _decode_file(self.paths[idx])
                if img.size > self.max_hw[0] * self.max_hw[1]:
                    img = None
            except ValueError:
                img = None
            except Exception as e:          # handed to the consumer
                img = e
            with self._cv:
                # an in-order bounded window: no further than capacity
                # frames ahead of the consumer
                self._cv.wait_for(lambda: self._stop or
                                  idx < self._next_out + self.capacity)
                if self._stop:
                    return
                self._done[idx] = img
                self._cv.notify_all()

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        while True:
            with self._cv:
                want = self._next_out
                if self._stop or want >= len(self.paths):
                    return
                self._cv.wait_for(lambda: self._stop or want in self._done)
                if self._stop:
                    return
                img = self._done.pop(want)
                self._next_out += 1
                self._cv.notify_all()
            if isinstance(img, Exception):
                raise img
            if img is not None:
                yield want, img

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
