"""Truevision TGA files read and written as PIL 12 reads and writes them
for the JAX package (``PIL/TgaImagePlugin.py``): its TIFF fallback's
``Image.open`` of a file under a TIFF name (``unmicst_tpu/io/slides.py:
74-79``, ``unmicst_tpu/io/tiff.py:1286-1291``), the toolbox's ``imread``
and its ``Image.fromarray(image).save(path)`` of a ``.tga``, ``.icb``,
``.vda`` or ``.vst`` name.

Reading (:func:`open_header`, :func:`load`):

* the 18-byte header as ``TgaImageFile._open`` checks it: colour-map
  type 0 or 1, a size above zero, depth 1, 8, 16, 24 or 32 (so 15 is
  refused), image types 1-3 and their RLE forms 9-11, the id section
  skipped, a colour map of 16, 24 or 32 bits skipped (another depth is
  refused: "unknown TGA map depth"); each refusal is a ``SyntaxError``,
  on which ``Image.open`` tries the next plugin (:mod:`identify`);
* the modes: type 3 ``L`` (depth 1 ``1``, 16 ``LA``), type 1 ``P`` with a
  colour map (its indices, as ``np.asarray`` gives them) and ``L``
  without one (whose raw mode ``P`` PIL cannot unpack into ``L``:
  ``ValueError``), type 2 ``RGB`` at 24 bits and ``RGBA`` else (16 bits
  ``BGRA;15Z``: 5 bits a channel scaled ``v * 255 // 31``, the top bit
  clear for opaque); a type and depth PIL has no raw mode for (type 1 at
  16 bits, type 3 at 24) opens and does not load ("cannot load this
  image");
* the rows bottom-up unless the descriptor's bit 0x20 is set, mirrored
  where bit 0x10 is;
* RLE as ``TgaRleDecode.c`` decodes it: a packet's pixel count is its low
  7 bits plus one, each pixel ``depth // 8`` bytes (so a 1-bit image never
  fills a row: "truncated"); a raw packet runs on across rows, a run
  packet past its row's end is a buffer overrun (``OSError``);
* PIL's exceptions at load: ``ValueError`` where it maps the file (modes
  ``L`` and ``P`` stored raw) and the data ends short, ``OSError`` where
  it reads it; a colour map is put on the image whatever its mode (for a
  ``P`` image before its pixels decode, for the others after): modes
  other than ``L``, ``LA`` and ``P`` refuse it ("unrecognized image
  mode"), a 32-bit map is "unrecognized raw mode" and more than 256
  entries (counted from 0, the ``first`` entry's offset included)
  "invalid palette size", each a ``ValueError``.  One frame:
  ``EOFError`` past it.

Writing (:func:`encode_tga`): ``Image.fromarray``'s modes ``1``, ``L``,
``LA``, ``RGB`` and ``RGBA`` as types 3 and 2 at 1, 8, 16, 24 and 32
bits, uncompressed (``fromarray`` sets no ``compression``), rows
bottom-up, the alpha bits (8) in the descriptor of ``LA`` and ``RGBA``,
and the version 2 footer ``TRUEVISION-XFILE.``; any other mode
``OSError`` ("cannot write mode I;16 as TGA").

The RLE decode runs in the port's native host library
(``native/rlecodec.cpp``) when it loads, and otherwise in
:func:`rle_decode_py`, the plain version the tests hold it to.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from unmicst_tpu_torch.io import _native
from unmicst_tpu_torch.io import _pil
from unmicst_tpu_torch.io.png import array_mode

# (image type & 7, depth) -> the raw mode PIL unpacks the rows with
_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
             (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}
_RAW_BITS = {"1": 1, "P": 8, "L": 8, "LA": 16, "BGRA;15Z": 16, "BGR": 24,
             "BGRA": 32}
_MAP_BYTES = {16: 2, 24: 3, 32: 4}
# mode -> (raw mode, bits, image type) of TgaImagePlugin's SAVE
_SAVE = {"1": ("1", 1, 3), "L": ("L", 8, 3), "LA": ("LA", 16, 3),
         "RGB": ("BGR", 24, 2), "RGBA": ("BGRA", 32, 2)}
FOOTER = b"\0" * 8 + b"TRUEVISION-XFILE.\0"
EXTENSIONS = (".tga", ".icb", ".vda", ".vst")
# rle_decode_py's results
OK, OVERRUN, TRUNCATED = 0, -1, -2


@dataclasses.dataclass
class TgaHeader:
    """What ``TgaImageFile._open`` finds."""

    width: int
    height: int
    mode: str
    rawmode: str  # "" where PIL sets no tile
    compressed: bool
    top_down: bool
    mirrored: bool
    offset: int  # the pixel data's first byte
    depth: int
    palette_entries: int  # the colour map's entries as read, from 0
    map_depth: int  # 0 without a colour map


def open_header(data: bytes) -> TgaHeader:
    """``TgaImageFile._open`` on ``data``: the header, or PIL's
    exception (``SyntaxError``, ``IndexError`` or ``struct.error``, on
    which ``Image.open`` tries the next plugin)."""
    s = data[:18]
    id_len, maptype, imagetype, depth, flags = s[0], s[1], s[2], s[16], s[17]
    w, h = _pil.u16le(s, 12), _pil.u16le(s, 14)
    if maptype not in (0, 1) or w <= 0 or h <= 0 or \
            depth not in (1, 8, 16, 24, 32):
        raise SyntaxError("not a TGA file")
    if imagetype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif imagetype in (1, 9):
        mode = "P" if maptype else "L"
    elif imagetype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise SyntaxError("unknown TGA mode")
    pos = min(len(data), 18 + id_len)
    entries = map_depth = 0
    if maptype:
        first, length, map_depth = (_pil.u16le(s, 3), _pil.u16le(s, 5),
                                    s[7])
        if map_depth not in _MAP_BYTES:
            raise SyntaxError("unknown TGA map depth")
        got = min(len(data) - pos, _MAP_BYTES[map_depth] * length)
        pos += got
        entries = (_MAP_BYTES[map_depth] * first + got) // _MAP_BYTES[
            map_depth]
    return TgaHeader(w, h, mode, _RAWMODES.get((imagetype & 7, depth), ""),
                     bool(imagetype & 8), bool(flags & 0x20),
                     bool(flags & 0x10), pos, depth, entries, map_depth)


def rle_decode_py(data: bytes, pos: int, out: np.ndarray, depth: int) -> int:
    """``TgaRleDecode.c`` from ``data[pos]`` into ``out`` (``[rows,
    row_bytes]`` uint8, rows in file order), ``depth`` bytes a pixel:
    ``OK`` once the last row is full, ``OVERRUN`` for a run packet past
    its row's end, ``TRUNCATED`` where the data ends first."""
    rows, row = out.shape
    end = len(data)
    x = y = 0
    if depth == 0:  # no packet moves the row on
        return TRUNCATED
    while True:
        if pos >= end:
            return TRUNCATED
        c = data[pos]
        n = depth * ((c & 0x7F) + 1)
        if c & 0x80:
            if end - pos < 1 + depth:
                return TRUNCATED
            if x + n > row:
                return OVERRUN
            out[y, x : x + n] = np.tile(
                np.frombuffer(data, np.uint8, depth, pos + 1), n // depth)
            pos += 1 + depth
            x += n
            if x >= row:
                x, y = 0, y + 1
                if y == rows:
                    return OK
            continue
        if end - pos < 1 + n:
            return TRUNCATED
        src = np.frombuffer(data, np.uint8, n, pos + 1)
        pos += 1 + n
        k = 0
        while k < n:  # a raw packet runs on into the next rows
            take = min(n - k, row - x)
            out[y, x : x + take] = src[k : k + take]
            x, k = x + take, k + take
            if x >= row:
                x, y = 0, y + 1
                if y == rows:
                    return OK


def _rle_rows(data: bytes, hdr: TgaHeader, row: int) -> np.ndarray:
    out = np.zeros((hdr.height, row), np.uint8)
    rc = _native.tga_rle_decode(data, hdr.offset, out, hdr.depth // 8)
    if rc is None:
        rc = rle_decode_py(data, hdr.offset, out, hdr.depth // 8)
    if rc == OVERRUN:
        raise OSError(_pil.OVERRUN)
    if rc != OK:
        raise OSError(_pil.TRUNCATED)
    return out


def unpack_rows(rows: np.ndarray, rawmode: str, w: int) -> np.ndarray:
    """PIL's unpacker of ``rawmode`` over ``[h, row_bytes]`` rows."""
    h = rows.shape[0]
    if rawmode == "1":
        return np.unpackbits(rows, axis=1)[:, :w].astype(bool)
    if rawmode in ("L", "P"):
        return np.ascontiguousarray(rows[:, :w])
    if rawmode == "LA":
        return np.ascontiguousarray(rows[:, : 2 * w]).reshape(h, w, 2)
    if rawmode == "BGR":
        return np.ascontiguousarray(rows[:, : 3 * w].reshape(h, w, 3)[
            ..., ::-1])
    if rawmode == "BGRA":
        return np.ascontiguousarray(rows[:, : 4 * w].reshape(h, w, 4)[
            ..., [2, 1, 0, 3]])
    # BGRA;15Z: 5 bits each of blue, green, red, the top bit inverted alpha
    v = np.ascontiguousarray(rows[:, : 2 * w]).view("<u2").astype(np.int32)
    out = np.empty((h, w, 4), np.uint8)
    for c, shift in enumerate((10, 5, 0)):
        out[..., c] = ((v >> shift) & 31) * 255 // 31
    out[..., 3] = np.where(v >> 15, 0, 255)
    return out


def _palette_error(hdr: TgaHeader):
    """The error of ``putpalette`` with the colour map, or None: PIL
    puts it on the image of any mode, and takes only L, LA and P."""
    if not hdr.map_depth:
        return None
    if hdr.mode not in ("L", "LA", "P"):
        return ValueError("unrecognized image mode")
    if hdr.map_depth == 32:
        return ValueError("unrecognized raw mode")
    if hdr.palette_entries > 256:
        return ValueError("invalid palette size")
    return None


def load(data: bytes, hdr: TgaHeader) -> np.ndarray:
    """The pixels of the image ``hdr`` describes, as ``np.asarray`` gives
    them after ``ImageFile.load`` (see the module docstring)."""
    w, h = hdr.width, hdr.height
    if not hdr.rawmode:
        raise OSError("cannot load this image")
    if hdr.rawmode == "P" and hdr.mode == "L":
        raise ValueError("unknown raw mode for given image mode")
    row = (w * _RAW_BITS[hdr.rawmode] + 7) // 8
    short = len(data) - hdr.offset < row * h
    if short and not hdr.compressed and hdr.rawmode == hdr.mode in ("L", "P"):
        raise ValueError(_pil.NOT_LARGE_ENOUGH)  # PIL maps the file
    palette = _palette_error(hdr)
    if palette is not None and hdr.mode == "P":  # put before the decode
        raise palette
    if hdr.compressed:
        rows = _rle_rows(data, hdr, row)
    elif short:
        raise _pil.truncated(len(data) - hdr.offset)
    else:
        rows = np.frombuffer(data, np.uint8, row * h, hdr.offset).reshape(
            h, row)
    if palette is not None:  # put after it
        raise palette
    px = unpack_rows(rows, hdr.rawmode, w)
    if not hdr.top_down:
        px = px[::-1]
    if hdr.mirrored:
        px = px[:, ::-1]
    return np.ascontiguousarray(px)


def read_frame(data: bytes, index: int = 0) -> np.ndarray:
    """Frame ``index`` of a TGA file's bytes, as PIL's ``Image.open``,
    ``seek`` and ``np.asarray`` give it: the header first (with the
    decompression-bomb check), then ``EOFError`` past frame 0, then the
    pixels."""
    hdr = open_header(data)
    _pil.bomb_check(hdr.width, hdr.height)
    if index != 0:
        raise EOFError("no more images in file")
    return load(data, hdr)


def encode_tga(image: np.ndarray) -> bytes:
    """The bytes ``Image.fromarray(image).save(path)`` writes for a TGA
    name (see the module docstring)."""
    mode, img = array_mode(image)
    if mode not in _SAVE:
        raise OSError(f"cannot write mode {mode} as TGA")
    rawmode, bits, imagetype = _SAVE[mode]
    h, w = img.shape[:2]
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, imagetype, 0, 0, 0, 0, 0, w, h,
                       bits, 8 if mode in ("LA", "RGBA") else 0)
    if 0 in img.shape:
        raise SystemError("tile cannot extend outside image")
    rows = img[::-1]
    if rawmode == "1":
        body = np.packbits(rows != 0, axis=1)
    elif rawmode == "BGR":
        body = rows[..., ::-1]
    elif rawmode == "BGRA":
        body = rows[..., [2, 1, 0, 3]]
    else:
        body = rows
    return head + np.ascontiguousarray(body, np.uint8).tobytes() + FOOTER


def write_tga(path: str, image: np.ndarray) -> None:
    """Write :func:`encode_tga`'s bytes to ``path``."""
    data = encode_tga(image)
    with open(path, "wb") as f:
        f.write(data)
