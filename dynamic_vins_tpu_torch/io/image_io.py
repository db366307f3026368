"""PNG and binary PGM images without OpenCV: the port's counterpart of
`cv2.imread` / `cv2.imwrite` for the dataset readers and the offline
perception files.

`imread(path, mode)` returns what `cv2.imread` returns for the same
file, byte for byte, in three modes:
  * "grey" (`IMREAD_GRAYSCALE`): uint8 [H,W]. Colour is converted as
    libpng converts it for OpenCV, `(9797 R + 19234 G + 3737 B) >> 15`
    (a floor, not `cvtColor`'s rounding), after palette expansion and
    with alpha dropped; 16-bit samples become their high byte.
  * "bgr" (`IMREAD_COLOR`): uint8 [H,W,3] in B, G, R order; grey is
    replicated, alpha dropped, 16-bit samples become their high byte.
  * "unchanged" (`IMREAD_UNCHANGED`): the file's own depth (uint8 or
    uint16) and channels in OpenCV's order: grey [H,W], grey+alpha
    [H,W,4] (grey replicated), colour BGR [H,W,3] or BGRA [H,W,4]; a
    palette or colour image with a tRNS chunk gains its alpha.
A missing file gives None, as with OpenCV. PNGs must be non-interlaced
with 8 or 16 bits a sample; Adam7 interlacing, bit depths below 8 and
16-bit colour in "grey" mode raise ValueError, as does a malformed file.

The PNG reading itself (`png_info`, `png_samples`: the chunk walk with
libpng's CRC and tRNS rules, inflating, unfiltering, Adam7 and 1-16 bit
samples) is shared with `io/native_loader.py`, which converts the
samples under the native library's rules instead of OpenCV's.

The PNG row filters are undone by `csrc/png_unfilter.c` (built with the
host compiler at first use, `ops/build.py`): Average and Paeth are
sequential along a row, which in Python costs about a second for a
752x480 image. `unfilter_plain` is the same function in numpy.

`imwrite(path, img, filter_type=0)` writes a PNG (8 or 16 bit, grey,
BGR or BGRA as OpenCV takes them) with one filter type on every row.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

MODES = ("grey", "bgr", "unchanged")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples a pixel, and its valid bit depths
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
           4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_COLOUR_SPACE = (b"sRGB", b"cHRM", b"iCCP")
_MAX_SIDE = 1000000         # libpng's default user width/height limit

_unfilter_fn = None


def _native_unfilter():
    global _unfilter_fn
    if _unfilter_fn is None:
        from dynamic_vins_tpu_torch.ops import build

        fn = build.load("png_unfilter").png_unfilter
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64]
        _unfilter_fn = fn
    return _unfilter_fn


def unfilter(data: np.ndarray, rows: int, stride: int,
             bpp: int) -> np.ndarray:
    """Undo the PNG row filters: `data` holds `rows` scanlines of one
    filter-type byte and `stride` bytes; returns uint8 [rows, stride]
    (csrc/png_unfilter.c)."""
    src = np.ascontiguousarray(data, np.uint8)
    if rows < 0 or stride < 0 or bpp < 1:
        raise ValueError(f"bad PNG geometry: {rows} rows of {stride} "
                         f"bytes, {bpp} bytes a pixel")
    if src.size != rows * (stride + 1):
        raise ValueError(f"PNG image data holds {src.size} bytes, "
                         f"expected {rows * (stride + 1)}")
    out = np.empty((rows, stride), np.uint8)
    bad = _native_unfilter()(src.ctypes.data, out.ctypes.data, rows,
                             stride, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: filter type "
                         f"{int(src[(bad - 1) * (stride + 1)])} is not 0-4")
    return out


def unfilter_plain(data: np.ndarray, rows: int, stride: int,
                   bpp: int) -> np.ndarray:
    """numpy version of `unfilter`, the same function byte for byte."""
    src = np.asarray(data, np.uint8)
    if src.size != rows * (stride + 1):
        raise ValueError(f"PNG image data holds {src.size} bytes, "
                         f"expected {rows * (stride + 1)}")
    src = src.reshape(rows, stride + 1)
    out = np.zeros((rows + 1, stride + bpp), np.int32)  # zero row, column
    for r in range(rows):
        ft = int(src[r, 0])
        x = src[r, 1:].astype(np.int32)
        up = out[r, bpp:]
        cur = out[r + 1]
        if ft == 0:
            cur[bpp:] = x
        elif ft == 2:
            cur[bpp:] = (x + up) & 255
        elif ft in (1, 3, 4):
            upl = out[r]
            for i in range(0, stride, bpp):
                j = slice(bpp + i, bpp + i + bpp)
                a = cur[i:i + bpp]
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + upl[j]) >> 1
                else:
                    b, c = upl[j], upl[i:i + bpp]
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[j] = (x[i:i + bpp] + pred) & 255
        else:
            raise ValueError(f"PNG row {r}: filter type {ft} is not 0-4")
    return out[1:, bpp:].astype(np.uint8)


def _grey_from_rgb(rgb: np.ndarray) -> np.ndarray:
    """libpng's RGB -> grey for OpenCV's IMREAD_GRAYSCALE (8-bit)."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)


def _high_byte(a: np.ndarray) -> np.ndarray:
    return (a >> 8).astype(np.uint8) if a.dtype == np.uint16 else a


def _convert(px: np.ndarray, alpha: Optional[np.ndarray], grey: bool,
             mode: str) -> np.ndarray:
    """Samples [H,W,C] (C = 1 grey, 3 RGB) and optional alpha [H,W] in
    the file's depth -> what OpenCV returns in `mode`."""
    if mode == "unchanged":
        if grey and alpha is None:
            return px[..., 0]
        bgr = np.repeat(px, 3, axis=2) if grey else px[..., ::-1]
        if alpha is not None:
            bgr = np.concatenate([bgr, alpha[..., None]], axis=2)
        return np.ascontiguousarray(bgr)
    if mode == "bgr":
        px8 = _high_byte(px)
        return np.ascontiguousarray(np.repeat(px8, 3, axis=2) if grey
                                    else px8[..., ::-1])
    if grey:
        return np.ascontiguousarray(_high_byte(px[..., 0]))
    if px.dtype == np.uint16:
        raise ValueError("16-bit colour PNG in grey mode is not supported")
    return _grey_from_rgb(px)


class PngInfo(NamedTuple):
    """A PNG's header and the chunks before its image data."""
    width: int
    height: int
    depth: int
    ctype: int
    interlace: int
    plte: Optional[np.ndarray]      # [n,3] uint8
    trns: Optional[bytes]           # the first valid tRNS chunk
    managed: bool                   # a colour space libpng would apply

    @property
    def channels(self) -> int:
        return _CHANNELS[self.ctype]

    @property
    def colour(self) -> bool:
        return self.ctype in (2, 3, 6)


def png_chunks(data: bytes):
    """(type, body) of each chunk in order; a critical chunk with a bad
    CRC raises, an ancillary one is dropped (libpng's defaults)."""
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if n >= 1 << 31 or pos + 12 + n > len(data):
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        pos += 12 + n
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            if kind[0] & 0x20:             # ancillary
                continue
            raise ValueError(f"PNG chunk {kind!r}: CRC error")
        yield kind, body
    raise ValueError("PNG without enough image data")


def png_info(data: bytes):
    """(PngInfo, the chunk iterator, the first IDAT's body) as libpng
    reads them: IHDR first, the first valid tRNS kept, an invalid
    header, palette or a critical chunk before the image data raises
    ValueError."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    chunks = png_chunks(data)
    kind, body = next(chunks)
    if kind != b"IHDR" or len(body) != 13:
        raise ValueError("PNG does not start with IHDR")
    W, H, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              body)
    if (ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or comp
            or filt or interlace > 1 or not 0 < W <= _MAX_SIDE
            or not 0 < H <= _MAX_SIDE):
        raise ValueError(f"PNG header: {W}x{H}, depth {depth}, colour "
                         f"type {ctype} not supported")
    plte, trns, managed = None, None, False
    for kind, body in chunks:
        if kind == b"IDAT":
            break
        if kind == b"PLTE":
            if ctype == 3 and (len(body) % 3 or len(body) > 768):
                raise ValueError("PNG: invalid palette")
            plte = np.frombuffer(body[:len(body) // 3 * 3],
                                 np.uint8).reshape(-1, 3)
        elif kind == b"tRNS" and trns is None:
            if ((ctype == 0 and len(body) == 2)
                    or (ctype == 2 and len(body) == 6)
                    or (ctype == 3 and plte is not None
                        and 0 < len(body) <= len(plte))):
                trns = body
        elif kind in _COLOUR_SPACE:
            managed = True
        elif kind == b"gAMA" and len(body) == 4:
            g, = struct.unpack(">I", body)
            managed |= 16 <= g <= 625000000 and abs(g - 100000) > 5000
        elif kind == b"IEND" or not kind[0] & 0x20:
            raise ValueError(f"PNG chunk {kind!r} before the image data")
    if ctype == 3 and plte is None:
        raise ValueError("palette PNG without PLTE")
    return (PngInfo(W, H, depth, ctype, interlace, plte, trns, managed),
            chunks, body)


def _passes(info: PngInfo):
    """[(x0, y0, dx, dy, width, height, row bytes)] of the image's passes
    (one, or Adam7's seven; an empty pass has no rows)."""
    out = []
    for x0, y0, dx, dy in (_ADAM7 if info.interlace else ((0, 0, 1, 1),)):
        w = (info.width - x0 + dx - 1) // dx
        h = (info.height - y0 + dy - 1) // dy
        if w > 0 and h > 0:
            out.append((x0, y0, dx, dy, w, h,
                        (w * info.channels * info.depth + 7) // 8))
    return out


def _unpack(rows: np.ndarray, width: int, nc: int, depth: int):
    """Unfiltered rows [h, stride] -> samples [h, width, nc] (uint8 for
    depths up to 8, uint16 for 16)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16)[:, :width * nc] \
            .reshape(h, width, nc)
    if depth == 8:
        return rows[:, :width * nc].reshape(h, width, nc)
    bits = np.unpackbits(rows, axis=1)[:, :width * nc * depth]
    vals = bits.reshape(h, width * nc, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (vals * weights).sum(-1).astype(np.uint8).reshape(h, width, nc)


def png_samples(info: PngInfo, chunks, first: bytes,
                unfilter_fn=unfilter) -> np.ndarray:
    """The image data from `png_info`'s first IDAT on -> samples
    [H,W,C] in the file's depth (uint8 up to 8 bits, uint16 for 16),
    Adam7 undone. Inflates only what the image needs, as libpng does."""
    passes = _passes(info)
    nc, depth = info.channels, info.depth
    need = sum(h * (s + 1) for *_, h, s in passes)
    inflate = zlib.decompressobj()
    try:
        raw = inflate.decompress(first, need)
        while len(raw) < need and not inflate.eof:
            if inflate.unconsumed_tail:
                raw += inflate.decompress(inflate.unconsumed_tail,
                                          need - len(raw))
                continue
            kind, body = next(chunks)
            if kind != b"IDAT":
                raise ValueError("PNG: not enough image data")
            raw += inflate.decompress(body, need - len(raw))
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from None
    if len(raw) < need:
        raise ValueError("PNG: not enough image data")
    bpp = max(1, nc * depth // 8)
    out = np.zeros((info.height, info.width, nc),
                   np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy, w, h, stride in passes:
        n = h * (stride + 1)
        rows = unfilter_fn(np.frombuffer(raw[pos:pos + n], np.uint8), h,
                           stride, bpp)
        pos += n
        out[y0::dy, x0::dx] = _unpack(rows, w, nc, depth)
    return out


def decode_png(data: bytes, mode: str = "grey",
               unfilter_fn=unfilter) -> np.ndarray:
    """A PNG file's bytes -> the array `cv2.imdecode` gives in `mode`."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    info, chunks, first = png_info(data)
    if info.interlace:
        raise ValueError("interlaced (Adam7) PNGs are not supported")
    if info.depth not in (8, 16):
        raise ValueError(f"PNG bit depth {info.depth} is not supported "
                         "(8 or 16 bits a sample)")
    px = png_samples(info, chunks, first, unfilter_fn)
    plte, trns = info.plte, info.trns
    alpha = None
    if info.ctype == 3:                         # palette
        idx = px[..., 0]
        if int(idx.max(initial=0)) >= len(plte):
            raise ValueError("palette index out of range")
        if trns is not None:
            a = np.full(len(plte), 255, np.uint8)
            a[:len(trns)] = np.frombuffer(trns, np.uint8)
            alpha = a[idx]
        px, grey = plte[idx], False
    elif info.ctype in (4, 6):                  # with an alpha channel
        px, alpha, grey = px[..., :-1], px[..., -1], info.ctype == 4
    else:
        grey = info.ctype == 0
        if trns is not None and not grey:       # one colour transparent
            key = np.array(struct.unpack(">HHH", trns), px.dtype)
            full = np.iinfo(px.dtype).max
            alpha = np.where((px == key).all(axis=2), 0,
                             full).astype(px.dtype)
    return _convert(px, alpha, grey, mode)


def decode_pgm(data: bytes, mode: str = "grey") -> np.ndarray:
    """A binary PGM (P5) file's bytes -> what `cv2.imdecode` gives."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    fields, pos = [], 2
    if data[:2] != b"P5":
        raise ValueError("not a binary PGM (P5) file")
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and data[end:end + 1].isdigit():
            end += 1
        if end == pos:
            raise ValueError("malformed PGM header")
        fields.append(int(data[pos:end]))
        pos = end
    W, H, maxval = fields
    pos += 1                                     # one whitespace byte
    if not 0 < maxval < 65536:
        raise ValueError(f"PGM maxval {maxval} is not supported")
    dt = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    n = W * H * dt.itemsize
    if len(data) - pos < n:
        raise ValueError("PGM pixel data is truncated")
    px = np.frombuffer(data[pos:pos + n], dt).astype(
        dt.newbyteorder("=")).reshape(H, W, 1)
    return _convert(px, None, True, mode)


def imread(path, mode: str = "grey") -> Optional[np.ndarray]:
    """`cv2.imread(path, flag)` for PNG and binary PGM files; None if
    the file does not exist."""
    p = Path(path)
    if not p.is_file():
        return None
    data = p.read_bytes()
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data, mode)
    if data[:2] == b"P5":
        return decode_pgm(data, mode)
    raise ValueError(f"{path}: neither a PNG nor a binary PGM file")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def filter_rows(raw: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """Apply one PNG filter type to every row of raw bytes [H, stride];
    returns the scanlines with their filter-type byte [H, stride + 1]."""
    x = raw.astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    if filter_type == 0:
        pred = 0
    elif filter_type == 1:
        pred = left
    elif filter_type == 2:
        pred = up
    elif filter_type == 3:
        pred = (left + up) >> 1
    elif filter_type == 4:
        p = left + up - upleft
        pa, pb, pc = (np.abs(p - left), np.abs(p - up),
                      np.abs(p - upleft))
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"filter type {filter_type} is not 0-4")
    out = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    out[:, 0] = filter_type
    out[:, 1:] = (x - pred) & 255
    return out


def encode_png(img: np.ndarray, filter_type: int = 0) -> bytes:
    """An image as `cv2.imwrite` takes it (uint8 or uint16; [H,W] grey,
    [H,W,3] BGR or [H,W,4] BGRA) -> PNG file bytes."""
    a = np.asarray(img)
    if a.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, not "
                         f"{a.dtype}")
    if a.ndim == 2:
        ctype, px = 0, a[..., None]
    elif a.ndim == 3 and a.shape[2] in (3, 4):
        ctype = 2 if a.shape[2] == 3 else 6
        px = a[..., [2, 1, 0, 3][:a.shape[2]]]       # BGR(A) -> RGB(A)
    else:
        raise ValueError(f"cannot write an image of shape {a.shape}")
    H, W, nc = px.shape
    depth = 8 * a.dtype.itemsize
    raw = np.ascontiguousarray(px, a.dtype.newbyteorder(">")).view(
        np.uint8).reshape(H, -1)
    lines = filter_rows(raw, nc * a.dtype.itemsize, filter_type)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(lines.tobytes()))
            + _chunk(b"IEND", b""))


def imwrite(path, img: np.ndarray, filter_type: int = 0) -> bool:
    """`cv2.imwrite(path, img)` for PNG files."""
    Path(path).write_bytes(encode_png(img, filter_type))
    return True
