"""Photoshop (PSD) files read as PIL 12 reads them for the JAX package
(``PIL/PsdImagePlugin.py``): its TIFF fallback's ``Image.open`` and
``seek(channel)`` of a file under a TIFF name, and the toolbox's
``imread`` (no seek).

The 26-byte header (``8BPS``, version 1) names the channels, the size,
the depth and the colour mode, which PIL's ``MODES`` table turns into an
image mode: bitmap ``1``, gray, multichannel and duotone ``L``, indexed
``P`` (``np.asarray`` gives the indices), ``RGB`` (``RGBA`` with four
channels), ``CMYK`` (stored inverted) and ``LAB`` (a and b signed, read
+128); any other pair raises ``KeyError``, on which ``Image.open`` tries
its next plugin, and too few channels ``OSError``.  The colour mode data and the image resources are
skipped; the layer and mask section is kept for the layers; then the
composite image: one compression word, then each channel raw or as
PackBits rows (every row's byte count first).

Frames follow PIL's seek rules.  ``index`` None (no seek) and 1 give the
composite; 0 raises ``EOFError``; ``k`` at 2 or more gives PIL's layer
``k - 1`` (its first layer is never reached) and ``IndexError`` past the
last.  PIL parses the layer records from a copy of the layer section and
keeps the channel data offsets it finds there, counted from that
section's start, as offsets into the file: a layer reads whatever the
file holds there, in the layer's mode (``L``, ``RGB`` or ``RGBA`` by its
channels' ids, read in the order R, G, B, A whatever the file's), on a
canvas of the composite's size, zero outside the layer's box; a one-
channel raw layer is mapped from the file at the canvas's size.  On an
indexed PSD, PIL puts the colour table on an ``RGB`` or ``RGBA`` layer
once it is decoded, which raises ``ValueError``.

PackBits is PIL's ``PackDecode.c``: 0x80 does nothing, the bytes of a
run or literal past the row's end are dropped (the row ends there), and
data that end early raise ``OSError``; the native version is
``native/rlecodec.cpp`` (:func:`_native.packbits_rows`), the plain one
:func:`packbits_rows_py`. Raw data that end early raise ``OSError``
(``ValueError`` for a mapped ``L`` or ``P`` image), a box past the
canvas's right or bottom edge ``ValueError``; a box that starts above or
left of the canvas makes PIL write outside its image (its result is
undefined), and the port raises that ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import List, Optional, Tuple

import numpy as np

from unmicst_tpu_torch.io import _native, _pil

MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
         (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
         (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}
# packbits_rows_py's result codes: every row full, the data ended first
OK, TRUNCATED = 0, -2
# image mode -> its bands, for a raw mode of one band
_BANDS = {"RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK", "LAB": "LAB"}


@dataclasses.dataclass
class Tile:
    decoder: str  # "raw" or "packbits"
    bbox: Tuple[int, int, int, int]  # x0, y0, x1, y1
    offset: int
    rawmode: str


@dataclasses.dataclass
class PsdHeader:
    width: int
    height: int
    mode: str
    tiles: List[Tile]
    layers_at: Optional[int]
    layers_size: int
    palette: bool  # a P image's 768-byte colour table


def _u16(s: bytes, o: int = 0) -> int:
    return struct.unpack_from(">H", s, o)[0]


def _u32(s: bytes, o: int = 0) -> int:
    return struct.unpack_from(">I", s, o)[0]


def accept(prefix: bytes) -> bool:
    return prefix.startswith(b"8BPS")


def _maketile(fp, mode: str, bbox, channels: int) -> List[Tile]:
    """``_maketile``: one tile a channel from the compression word at
    ``fp``'s position, and ``fp`` past the channels (and a pad byte where
    they end at an odd offset)."""
    tiles = []
    compression = _u16(fp.read(2))
    xsize, ysize = bbox[2] - bbox[0], bbox[3] - bbox[1]
    offset = fp.tell()
    if compression == 0:
        for channel in range(channels):
            rawmode = mode[channel] + (";I" if mode == "CMYK" else "")
            tiles.append(Tile("raw", bbox, offset, rawmode))
            offset += xsize * ysize
    elif compression == 1:
        i = 0
        bytecount = fp.read(channels * ysize * 2)
        offset = fp.tell()
        for channel in range(channels):
            rawmode = mode[channel] + (";I" if mode == "CMYK" else "")
            tiles.append(Tile("packbits", bbox, offset, rawmode))
            for _ in range(ysize):
                offset += _u16(bytecount, i)
                i += 2
    fp.seek(offset)
    if offset & 1:
        fp.read(1)
    return tiles


def open_header(data: bytes) -> PsdHeader:
    """``PsdImageFile._open`` (see the module docstring): PIL's
    exceptions where it refuses the file."""
    fp = io.BytesIO(data)
    read = fp.read
    s = read(26)
    if not accept(s) or _u16(s, 4) != 1:
        raise SyntaxError("not a PSD file")
    bits, channels, psd_mode = _u16(s, 22), _u16(s, 12), _u16(s, 24)
    mode, need = MODES[(psd_mode, bits)]
    if need > channels:
        raise OSError("not enough channels")
    if mode == "RGB" and channels == 4:
        mode, need = "RGBA", 4
    w, h = _u32(s, 18), _u32(s, 14)
    size = _u32(read(4))
    palette = False
    if size:
        read(size)
        palette = mode == "P" and size == 768
    size = _u32(read(4))
    if size:
        end = fp.tell() + size
        while fp.tell() < end:
            read(4)
            _u16(read(2))
            name = read(read(1)[0])
            if not len(name) & 1:
                read(1)
            body = read(_u32(read(4)))
            if len(body) & 1:
                read(1)
    layers_at, layers_size = None, 0
    size = _u32(read(4))
    if size:
        end = fp.tell() + size
        size = _u32(read(4))
        if size:
            layers_at, layers_size = fp.tell(), size
        fp.seek(end)
    tiles = _maketile(fp, mode, (0, 0, w, h), need)
    return PsdHeader(w, h, mode, tiles, layers_at, layers_size, palette)


def _safe_read(fp, size: int) -> bytes:
    """``ImageFile._safe_read``."""
    if size <= 0:
        return b""
    out = fp.read(size)
    if len(out) < size:
        raise OSError("Truncated File Read")
    return out


def layers(data: bytes, hdr: PsdHeader):
    """``PsdImageFile.layers``: ``(mode, tiles)`` of each layer PIL
    finds (``_layerinfo``), the tiles' offsets into the layer section."""
    if hdr.layers_at is None:
        return []
    fp = io.BytesIO(data)
    fp.seek(hdr.layers_at)
    fp = io.BytesIO(_safe_read(fp, hdr.layers_size))

    def read(size):
        return _safe_read(fp, size)

    ct = struct.unpack(">h", read(2))[0]
    if hdr.layers_size < abs(ct) * 20:
        raise SyntaxError("Layer block too short for number of layers "
                          "requested")
    found = []
    for _ in range(abs(ct)):
        y0, x0, y1, x1 = struct.unpack(">4i", read(16))
        ct_types = _u16(read(2))
        if ct_types > 4:
            fp.seek(ct_types * 6 + 12, io.SEEK_CUR)
            fp.seek(_u32(read(4)), io.SEEK_CUR)
            continue
        bands = []
        for _ in range(ct_types):
            kind = _u16(read(2))
            bands.append("A" if kind == 65535 else "RGBA"[kind])
            read(4)
        bands.sort()
        mode = {("R",): "L", ("B", "G", "R"): "RGB",
                ("A", "B", "G", "R"): "RGBA"}.get(tuple(bands), "")
        read(12)
        size = _u32(read(4))
        if size:
            data_end = fp.tell() + size
            length = _u32(read(4))
            if length:
                fp.seek(length - 16, io.SEEK_CUR)
            length = _u32(read(4))
            if length:
                fp.seek(length, io.SEEK_CUR)
            length = read(1)[0]
            if length:
                read(length)
            fp.seek(data_end)
        found.append((mode, (x0, y0, x1, y1)))
    out = []
    for mode, bbox in found:
        tiles = []
        for m in mode:
            tiles.extend(_maketile(fp, m, bbox, 1))
        out.append((mode, tiles))
    return out


def packbits_rows_py(data: bytes, pos: int, out: np.ndarray):
    """``PackDecode.c`` from ``data[pos]`` into ``out`` (``[rows,
    row_bytes]``, rows written only when whole): ``(code, rows written,
    position of the first byte not consumed)``, the code ``OK`` or
    ``TRUNCATED``."""
    rows, row = out.shape
    n, x, y = len(data), 0, 0
    buf = bytearray(row)
    while True:
        if pos >= n:
            return TRUNCATED, y, pos
        c = data[pos]
        if c & 0x80:
            if c == 0x80:
                pos += 1
                continue
            if n - pos < 2:
                return TRUNCATED, y, pos
            count = 257 - c
            run = bytes([data[pos + 1]]) * count
            pos += 2
        else:
            count = c + 1
            if n - pos < count + 1:
                return TRUNCATED, y, pos
            run = data[pos + 1 : pos + 1 + count]
            pos += count + 1
        if x < row:
            buf[x : min(x + count, row)] = run[: row - x]
        x += count
        if x >= row:
            out[y] = np.frombuffer(bytes(buf), np.uint8)
            x, y = 0, y + 1
            if y >= rows:
                return OK, y, pos


def _extent(bbox, w: int, h: int):
    """``decoder.setimage``'s extent of a tile on a ``w`` x ``h`` image:
    ``(x0, y0, xsize, ysize)``, or ``ValueError`` past its right or
    bottom edge, or empty.  PIL does not check a negative offset and
    writes outside its image; the port raises the same ``ValueError``."""
    x0, y0, x1, y1 = bbox
    if x0 == 0 and x1 == 0:
        x0, y0, xs, ys = 0, 0, w, h
    else:
        xs, ys = x1 - x0, y1 - y0
    if x0 < 0 or xs <= 0 or xs + x0 > w or y0 < 0 or ys <= 0 or ys + y0 > h:
        raise ValueError("tile cannot extend outside image")
    return x0, y0, xs, ys


def _put(img: np.ndarray, mode: str, rawmode: str, rows: np.ndarray,
         x0: int, y0: int, xs: int) -> None:
    """Unpack ``rows`` (whole rows from the extent's top) into ``img``."""
    n = rows.shape[0]
    if mode in _BANDS:
        band = _BANDS[mode].index(rawmode[0])
        px = rows[:, :xs]
        if rawmode.endswith(";I"):
            px = 255 - px
        elif mode == "LAB" and band:  # a and b are signed: +128
            px = px ^ np.uint8(0x80)
        img[y0 : y0 + n, x0 : x0 + xs, band] = px
    else:
        img[y0 : y0 + n, x0 : x0 + xs] = _pil.unpack(rows, rawmode, xs)


def _load(data: bytes, mode: str, w: int, h: int,
          tiles: List[Tile]) -> np.ndarray:
    """``ImageFile.load`` of ``tiles`` on a new ``w`` x ``h`` image of
    ``mode`` (see the module docstring)."""
    if not mode or not tiles:
        raise OSError("cannot load this image")
    if len(tiles) == 1 and tiles[0].decoder == "raw" and \
            tiles[0].rawmode == mode in _pil.MAP_MODES and \
            tiles[0].offset <= len(data):  # mapped at the canvas's size
        rows = _pil.raw_rows(data, tiles[0].offset, w, h, mapped=mode,
                             width=w)
        return _pil.unpack(rows, mode, w)
    bands = len(_BANDS.get(mode, ""))
    img = np.zeros((h, w, bands) if bands else (h, w),
                   bool if mode == "1" else np.uint8)
    ordered = sorted(tiles, key=lambda t: t.offset)
    kept = [t for k, t in enumerate(ordered) if k + 1 == len(ordered) or (
        t.decoder, t.bbox, t.rawmode) != (ordered[k + 1].decoder,
                                          ordered[k + 1].bbox,
                                          ordered[k + 1].rawmode)]
    for t in kept:
        x0, y0, xs, ys = _extent(t.bbox, w, h)
        bits = 1 if t.rawmode == "1" else 8
        _pil.setimage_check(xs, bits)
        row = (xs * bits + 7) // 8
        if t.decoder == "raw":
            rows = _pil.raw_rows(data, t.offset, row, ys)
        else:
            if t.offset < 0:
                raise OSError(22, "Invalid argument")
            rows = np.zeros((ys, row), np.uint8)
            got = _native.packbits_rows(data, t.offset, rows)
            if got is None:
                got = packbits_rows_py(data, t.offset, rows)
            code, _, pos = got
            if code == TRUNCATED:
                raise _pil.truncated(max(0, len(data) - pos))
        _put(img, mode, t.rawmode, rows, x0, y0, xs)
    return img


def read_frame(data: bytes, index) -> np.ndarray:
    """Frame ``index`` of a PSD (None: no seek; see the module
    docstring)."""
    hdr = open_header(data)
    mode, tiles = hdr.mode, hdr.tiles
    if index is not None:
        if index < 1:
            raise EOFError("attempt to seek outside sequence")
        if index > 1:
            mode, tiles = layers(data, hdr)[index - 1]
    px = _load(data, mode, hdr.width, hdr.height, tiles)
    if hdr.palette and mode not in ("L", "P"):  # PIL puts the colour
        raise ValueError("unrecognized image mode")  # table on it
    return px
