"""Sun raster files read as PIL 12 reads them for the JAX package
(``PIL/SunImagePlugin.py``): its TIFF fallback's ``Image.open`` of a
file under a TIFF name, and the toolbox's ``imread``.

A 32-byte big-endian header (magic 0x59A66A95, width, height, depth,
length, type, colour map type and length), the colour map, then the
rows: depth 1 (``1``, a set bit black), 4 and 8 (``L``, 4-bit samples
scaled by 17; with a colour map ``P``, the indices), 24 and 32 (``RGB``,
BGR and BGRX, or RGB and RGBX for type 3).  Types 0, 1, 3, 4 and 5 hold
the rows raw, each padded to 16 bits; type 2 holds them coded by
``sun_rle`` (0x80, n, v: n + 1 times v, a run that goes on across rows;
0x80 0: one 0x80; any other byte itself), whose rows PIL does not pad. A
colour map on a 1-bit or RGB image raises ``ValueError`` once the pixels
are decoded, as PIL's ``load`` does.  A colour map longer than 1024
bytes or of type other than 1, another depth or another type raise
``SyntaxError``, on which ``Image.open`` tries its next plugin.  Data
that end early raise PIL's ``OSError``.

The RLE is native (``native/rlecodec.cpp``,
:func:`_native.sun_rle_rows`) where the library loads, else
:func:`rle_decode_py`, the plain version.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from unmicst_tpu_torch.io import _native, _pil

# rle_decode_py's result codes: every row full, the data ended first
OK, TRUNCATED = 0, -2
_RAWMODES = {1: ("1", "1;I"), 4: ("L", "L;4"), 8: ("L", "L")}
_BITS = {"1;I": 1, "L;4": 4, "P;4": 4, "L": 8, "P": 8, "RGB": 24,
         "BGR": 24, "RGBX": 32, "BGRX": 32}


@dataclasses.dataclass
class SunHeader:
    width: int
    height: int
    depth: int
    mode: str
    rawmode: str
    offset: int
    rle: bool
    palette: bool


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 4 and _pil.u32be(prefix) == 0x59A66A95


def open_header(data: bytes) -> SunHeader:
    """``SunImageFile._open``: ``SyntaxError`` (or ``struct.error`` for
    a header cut short) where PIL refuses the file."""
    s = data[:32]
    if not accept(s):
        raise SyntaxError("not an SUN raster file")
    w, h, depth, _, ftype, ptype, plen = struct.unpack_from(">7I", s, 4)
    if depth in _RAWMODES:
        mode, rawmode = _RAWMODES[depth]
    elif depth in (24, 32):
        mode = "RGB"
        rawmode = ("RGB" if ftype == 3 else "BGR") + ("X" if depth == 32
                                                     else "")
    else:
        raise SyntaxError("Unsupported Mode/Bit Depth")
    offset = 32
    if plen:
        if plen > 1024:
            raise SyntaxError("Unsupported Color Palette Length")
        if ptype != 1:
            raise SyntaxError("Unsupported Palette Type")
        offset += plen
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise SyntaxError("Unsupported Sun Raster file type")
    return SunHeader(w, h, depth, mode, rawmode, offset, ftype == 2,
                     bool(plen))


def rle_decode_py(data: bytes, pos: int, out: np.ndarray):
    """``SunRleDecode.c`` from ``data[pos]`` into ``out`` (``[rows,
    row_bytes]``, rows written only when whole): ``(code, position of
    the first byte not consumed)``."""
    rows, row = out.shape
    n, x, y = len(data), 0, 0
    buf = bytearray(row)
    while True:
        if pos >= n:
            return TRUNCATED, pos
        c = data[pos]
        extra = 0
        if c == 0x80:
            if n - pos < 2:
                return TRUNCATED, pos
            if data[pos + 1] == 0:
                count, value = 1, 0x80
                pos += 2
            else:
                if n - pos < 3:
                    return TRUNCATED, pos
                count, value = data[pos + 1] + 1, data[pos + 2]
                if x + count > row:
                    extra, count = count - (row - x), row - x
                pos += 3
        else:
            count, value = 1, c
            pos += 1
        buf[x : x + count] = bytes([value]) * count
        while True:
            x += count
            if x >= row:
                out[y] = np.frombuffer(bytes(buf), np.uint8)
                x, y = 0, y + 1
                if y >= rows:
                    return OK, pos
            if extra == 0 or x > 0:
                break
            count = min(extra, row)
            buf[:count] = bytes([value]) * count
            extra -= count


def read_frame(data: bytes, index) -> np.ndarray:
    """The image, as ``np.asarray(Image.open(f))`` gives it (see the
    module docstring); ``EOFError`` past frame 0."""
    hdr = open_header(data)
    if index:
        raise EOFError("no more images in file")
    w, h = hdr.width, hdr.height
    bits = _BITS[hdr.rawmode]
    _pil.setimage_check(w, bits)
    row = (w * bits + 7) // 8
    if hdr.rle:
        rows = np.zeros((h, row), np.uint8)
        got = _native.sun_rle_rows(data, hdr.offset, rows)
        code, pos = rle_decode_py(data, hdr.offset, rows) if got is None \
            else got
        if code == TRUNCATED:
            raise _pil.truncated(max(0, len(data) - pos))
    else:
        stride = ((w * hdr.depth + 15) // 16) * 2
        rows = _pil.raw_rows(data, hdr.offset, row, h, stride)
    if hdr.palette and hdr.mode != "P":  # PIL puts the map on a 1 or RGB
        raise ValueError("unrecognized image mode")  # image after the decode
    return _pil.unpack(rows, hdr.rawmode, w)
