"""PNG files in the standard library (``zlib``, ``struct``) and numpy.

The deploy path writes its ``I%05d_{Im,PM}.png`` pairs here, and
``utils/imtools`` reads and writes PNGs here; the JAX package does both
through PIL, which this package does not use.

* :func:`read_png` reads every PNG kind the standard defines (gray at
  1/2/4/8/16 bits, RGB at 8/16, palette at 1/2/4/8, gray+alpha and RGBA
  at 8/16), interlaced (Adam7) or not, with the five row filters, and
  returns what PIL's ``np.asarray(Image.open(path))`` gives:

  ====================  =====  ======================================
  PNG                   mode   array
  ====================  =====  ======================================
  gray 1-bit            1      ``[H, W]`` bool
  gray 2/4-bit          L      uint8, 85 and 17 a step
  gray 8/16-bit         L      uint8 / ``I;16`` uint16
  palette 1/2/4/8-bit   P      uint8, the indices as stored
  gray+alpha 8-bit      LA     ``[H, W, 2]`` uint8
  gray+alpha 16-bit     RGBA   ``[H, W, 4]``: L, L, L, A
  RGB / RGBA            RGB(A) ``[H, W, 3 or 4]`` uint8
  ====================  =====  ======================================

  16-bit colour samples keep their high byte.  ``PLTE`` and ``tRNS``
  change none of it (PIL keeps them beside the pixels).  A corrupt file
  raises ``ValueError``.
* :func:`write_png` writes what ``Image.fromarray(image).save(path)``
  writes (:func:`encode_png` returns those bytes, :func:`encode_pixels`
  those of an image given by its mode and pixels, for the icons that
  embed PNGs), each row with filter type 0: bool as 1-bit gray, uint8 planes,
  gray+alpha, RGB and RGBA at 8 bits, uint16 planes at 16 bits, and
  PIL's mode ``I`` (int8 read as its bytes, int16, int32, uint32 read as
  int32) at 16 bits, clipped to 0..65535.  It raises where PIL raises:
  ``TypeError`` for a dtype or shape ``fromarray`` has no mode for,
  ``OSError`` for float planes (mode ``F``).
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import Tuple

import numpy as np

from unmicst_tpu_torch.io import _native, _pil

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, the bit depths the standard allows)
_KINDS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
          4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# the largest image read: far beyond any toolbox image, and it bounds the
# buffers an untrusted header sizes
_MAX_BYTES = 1 << 32


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


# -- PIL's modes for an array (``Image.fromarray``) ---------------------------

# (channels, dtype kind + size) -> PIL's mode; big-endian uint16 is I;16B
_ARRAY_MODES = {(1, "b1"): "1", (1, "u1"): "L", (2, "u1"): "LA",
                (3, "u1"): "RGB", (4, "u1"): "RGBA", (1, "i1"): "I",
                (1, "u2"): "I;16", (1, "i2"): "I", (1, "u4"): "I",
                (1, "i4"): "I", (1, "f4"): "F", (1, "f8"): "F"}


def array_mode(image) -> Tuple[str, np.ndarray]:
    """PIL's mode for ``image`` as ``Image.fromarray`` picks it, and the
    pixels as that mode holds them: ``[H, W]`` or ``[H, W, C]`` (a 1-D
    array is one column); bool as 0/1 uint8; mode ``I`` as int64 (int8
    read as its unsigned bytes, uint32 as int32).  ``TypeError`` with
    PIL's message where it has no mode."""
    img = np.asarray(image)
    if img.ndim == 1:
        img = img[:, None]
    channels = img.shape[2] if img.ndim == 3 else 1
    key = (channels if img.ndim <= 3 else 0,
           img.dtype.kind + str(img.dtype.itemsize))
    mode = _ARRAY_MODES.get(key)
    if mode is None or (img.ndim == 3 and channels == 1):
        shape = (1, 1) + img.shape[2:]
        raise TypeError(f"Cannot handle this data type: {shape}, "
                        f"{img.dtype.str}")
    if mode == "I;16" and img.dtype.byteorder == ">":
        mode = "I;16B"
    if mode == "1":
        return mode, (img.view(np.uint8) != 0).astype(np.uint8)
    if mode == "I":
        if img.dtype.itemsize == 1:
            img = img.view(np.uint8)
        elif img.dtype.kind == "u":
            img = img.astype(img.dtype.newbyteorder("=")).view(np.int32)
        return mode, img.astype(np.int64)
    return mode, img


def encode_pixels(mode: str, img: np.ndarray, level: int = 6) -> bytes:
    """PIL's PNG save of an image in ``mode`` whose pixels are ``img``
    (as :func:`array_mode` gives them), as bytes: each row with filter
    type 0, the port's own deflate."""
    if mode == "F":
        raise OSError(f"cannot write mode {mode} as PNG")
    if 0 in img.shape:
        raise SystemError("tile cannot extend outside image")
    colour = {"LA": 4, "RGB": 2, "RGBA": 6}.get(mode, 0)
    h, w = img.shape[:2]
    if mode == "1":
        depth, raw = 1, np.packbits(img, axis=1)
    elif mode in ("I", "I;16", "I;16B"):
        depth = 16
        raw = np.clip(img, 0, 65535).astype(">u2").view(np.uint8)
    else:
        depth, raw = 8, np.ascontiguousarray(img, np.uint8)
    raw = raw.reshape(h, -1)
    rows = np.zeros((h, 1 + raw.shape[1]), np.uint8)  # a filter byte a row
    rows[:, 1:] = raw
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """The bytes :func:`write_png` writes for ``image``."""
    return encode_pixels(*array_mode(image), level)


def write_png(path: str, image: np.ndarray, level: int = 6) -> None:
    """Write ``image`` as ``Image.fromarray(image).save(path)`` writes a
    PNG (see the module docstring)."""
    data = encode_png(image, level)
    with open(path, "wb") as f:
        f.write(data)


# -- reading ------------------------------------------------------------------


def _unfilter(data: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec section 9) of a ``[h, 1 +
    stride]`` array of the inflated bytes: in the native host library
    when it loads, else in :func:`_unfilter_py`."""
    out = _native.png_unfilter(data, bpp)
    return _unfilter_py(data, bpp) if out is None else out


def _unfilter_py(data: np.ndarray, bpp: int) -> np.ndarray:
    """:func:`_unfilter` in numpy and Python, the plain version of
    ``native/pngfilter.cpp``."""
    h, stride = data.shape[0], data.shape[1] - 1
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the zero prior row
    for y in range(h):
        kind = data[y, 0]
        line = data[y, 1:]
        prior = out[y]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum per byte of the pixel
            pad = (-stride) % bpp
            cur = np.cumsum(np.pad(line, (0, pad)).reshape(-1, bpp), 0,
                            dtype=np.uint8).reshape(-1)[:stride]
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left
            cur = line.astype(np.int32)
            up = prior.astype(np.int32)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"corrupt PNG: row filter type {kind}")
        out[y + 1] = cur
    return out[1:]


def _samples(rows: np.ndarray, w: int, spp: int, depth: int) -> np.ndarray:
    """Unfiltered rows -> ``[n, w, spp]`` samples: uint16 at 16 bits,
    uint8 otherwise, sub-byte samples unpacked most significant first."""
    n = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(n, w, spp).astype(np.uint16)
    if depth == 8:
        return rows.reshape(n, w, spp)
    bits = np.unpackbits(rows, axis=1)[:, : w * depth].reshape(n, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :, None]


def _pixels(raw: bytes, w: int, h: int, spp: int, depth: int,
            interlace: int) -> np.ndarray:
    """The inflated IDAT bytes -> ``[h, w, spp]`` samples, pass by pass
    where the image is interlaced (a pass without pixels has no bytes)."""
    bpp = max(1, spp * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.empty((h, w, spp), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * spp * depth + 7) // 8
        n = ph * (stride + 1)
        if pos + n > len(raw):
            raise ValueError("truncated PNG data")
        rows = _unfilter(np.frombuffer(raw, np.uint8, n, pos).reshape(
            ph, stride + 1), bpp)
        pos += n
        out[y0::dy, x0::dx] = _samples(rows, pw, spp, depth)
    return out


def _image_size(w: int, h: int, spp: int, depth: int) -> int:
    """The inflated size of a non-interlaced image (an interlaced one's
    is at most about twice as large)."""
    return h * ((w * spp * depth + 7) // 8 + 1)


_CID = re.compile(rb"\w\w\w\w")


def check_header(blob: bytes) -> Tuple[int, int]:
    """``PngImageFile._open`` of a PNG inside another file (an icon's
    entry): the chunk walk to the first IDAT with PIL's exceptions
    (``SyntaxError`` for a bad signature, chunk name, filter method or
    checksum, or for a mode PIL does not know, ``struct.error`` for a
    chunk header cut short, ``ValueError`` for a short IHDR, ``OSError``
    for a chunk cut short)."""
    if not blob.startswith(_SIGNATURE):
        raise SyntaxError("not a PNG file")
    pos, known, size = 8, False, (0, 0)
    while True:
        length = struct.unpack(">I", blob[pos : pos + 4])[0]
        cid = blob[pos + 4 : pos + 8]
        pos += 8
        if not _CID.match(cid):
            raise SyntaxError(f"broken PNG file (chunk {cid!r})")
        if cid in (b"IDAT", b"IEND"):
            break
        body = blob[pos : pos + length]
        if len(body) < length:
            raise OSError("Truncated File Read")
        pos += length
        if cid == b"IHDR":
            if length < 13:
                raise ValueError("Truncated IHDR chunk")
            w, h, depth, colour, _, filt, _ = struct.unpack_from(">IIBBBBB",
                                                                  body)
            size = (w, h)
            known = depth in _KINDS.get(colour, (0, ()))[1]
            if filt:
                raise SyntaxError("unknown filter category")
        crc = blob[pos : pos + 4]
        pos += 4
        if len(crc) < 4:
            raise SyntaxError(f"broken PNG file (incomplete checksum in "
                              f"{cid!r})")
        if zlib.crc32(body, zlib.crc32(cid)) != struct.unpack(">I", crc)[0]:
            raise SyntaxError(f"broken PNG file (bad header checksum in "
                              f"{cid!r})")
    if not known or size[0] <= 0 or size[1] <= 0:
        raise SyntaxError("not identified by this driver")
    return size


def decode_embedded(blob: bytes, what: str) -> np.ndarray:
    """A PNG inside another file as PIL opens and loads it: the header's
    exceptions (:func:`check_header`), the decompression-bomb check, then
    the pixels, data that do not decode raising ``OSError``."""
    try:  # PngImageFile(f): ImageFile.__init__'s mapping
        w, h = check_header(blob)
    except _pil.PASS as e:
        raise SyntaxError(str(e)) from None
    _pil.bomb_check(w, h)
    try:
        return decode_png(blob, what, embedded=True)
    except ValueError as e:
        raise OSError(str(e)) from None


def read_png(path: str) -> np.ndarray:
    """Read a PNG as PIL does (see the module docstring)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(blob: bytes, path: str, embedded: bool = False
               ) -> np.ndarray:
    """The pixels of the PNG file ``blob`` as :func:`read_png` reads them
    (``path`` names it in errors).  ``embedded``: a PNG inside another
    file, whose data PIL takes from the IDAT chunks that follow one
    another, needing no IEND and no checksum after them."""
    if not blob.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat, bad_name = len(_SIGNATURE), None, [], False
    while True:
        if pos + 8 > len(blob):
            if embedded and idat:
                break
            raise ValueError(f"{path}: truncated PNG (no IEND)")
        n, kind = struct.unpack_from(">I4s", blob, pos)
        if embedded and idat and kind != b"IDAT":
            # PIL's data end at the first other chunk, whose name it reads
            # where it needs more data
            bad_name = _CID.match(kind) is None
            break
        body = blob[pos + 8 : pos + 8 + n]
        if (len(body) != n or pos + 12 + n > len(blob)) and not (
                embedded and kind == b"IDAT"):  # PIL decodes what is there
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            if n != 13:
                raise ValueError(f"{path}: corrupt PNG header")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without a header")
    w, h, depth, colour, _comp, _filt, interlace = header
    spp, depths = _KINDS.get(colour, (0, ()))
    if depth not in depths or interlace > 1:
        raise ValueError(f"{path}: corrupt PNG header (colour type {colour}"
                         f" at {depth} bits, interlace {interlace})")
    size = _image_size(w, h, spp, depth)
    if not (w and h) or size > _MAX_BYTES:
        raise ValueError(f"{path}: implausible PNG size {w}x{h}")
    try:  # PIL's decoder stops where the image is whole
        raw = zlib.decompressobj().decompress(
            b"".join(idat), size if embedded and not interlace
            else 2 * size + h)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG data: {e}") from None
    if bad_name and not interlace and len(raw) < size:
        raise SyntaxError(f"{path}: broken PNG file (a chunk's name)")
    try:
        px = _pixels(raw, w, h, spp, depth, interlace)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if colour in (0, 3):
        px = px[:, :, 0]
        if colour == 0 and depth == 1:
            return px.astype(bool)
        if colour == 0 and depth in (2, 4):
            return px * np.uint8(255 // ((1 << depth) - 1))
        return px
    if depth == 16:  # PIL's RGB;16B, RGBA;16B and LA;16B: the high bytes
        px = (px >> 8).astype(np.uint8)
        if colour == 4:
            px = px[:, :, [0, 0, 0, 1]]
    return px
