"""PNG files in the standard library (``zlib``, ``struct``) and numpy.

The deploy path writes its ``I%05d_{Im,PM}.png`` pairs here, and
``utils/imtools`` reads and writes PNGs here; the JAX package does both
through PIL, which this package does not use.

* :func:`write_png` writes gray 8-bit, gray 16-bit and RGB 8-bit images,
  every row with filter type 0 (none); pixels decode the same in any PNG
  reader.
* :func:`read_png` reads gray 8/16-bit, RGB 8-bit and RGBA 8-bit images
  that are not interlaced, with the five row filters, and returns them as
  PIL's ``np.asarray`` does: ``[H, W]`` uint8 or uint16, ``[H, W, 3]`` or
  ``[H, W, 4]`` uint8.  Other PNGs raise ``NotImplementedError``, a
  corrupt file ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from unmicst_tpu_torch.io import _native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (colour type, bit depth) -> (samples per pixel, numpy dtype)
_LAYOUTS = {(0, 8): (1, np.uint8), (0, 16): (1, np.uint16),
            (2, 8): (3, np.uint8), (6, 8): (4, np.uint8)}
# the largest image read: far beyond any toolbox image, and it bounds the
# buffers an untrusted header sizes
_MAX_BYTES = 1 << 32


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray, level: int = 6) -> None:
    """Write a ``[H, W]`` uint8 or uint16 plane, or a ``[H, W, 3]``
    uint8 image, as a PNG."""
    img = np.asarray(image)
    layout = {(2, np.dtype(np.uint8)): (0, 8),
              (2, np.dtype(np.uint16)): (0, 16),
              (3, np.dtype(np.uint8)): (2, 8)}.get((img.ndim, img.dtype))
    if layout is None or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(
            f"write_png takes a [H, W] uint8 or uint16 plane or a [H, W, 3] "
            f"uint8 image, got {img.shape} {img.dtype}")
    colour, depth = layout
    h, w = img.shape[:2]
    raw = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = np.zeros((h, 1 + raw[0].nbytes), np.uint8)  # a filter byte a row
    rows[:, 1:] = raw.view(np.uint8).reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _chunk(b"IEND", b""))


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


def read_png(path: str) -> np.ndarray:
    """Read a PNG (see the module docstring for the kinds it reads)."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, []
    while True:
        if pos + 8 > len(blob):
            raise ValueError(f"{path}: truncated PNG (no IEND)")
        n, kind = struct.unpack_from(">I4s", blob, pos)
        body = blob[pos + 8 : pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(blob):
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
    layout = _LAYOUTS.get((colour, depth))
    if layout is None or interlace:
        raise NotImplementedError(
            f"{path}: PNG colour type {colour} at {depth} bits"
            f"{', interlaced' if interlace else ''} is not supported "
            "(gray 8/16-bit and RGB/RGBA 8-bit, not interlaced, are; "
            "ROADMAP M17)")
    spp, dtype = layout
    bpp = spp * depth // 8
    stride = w * bpp
    if not (w and h) or h * (stride + 1) > _MAX_BYTES:
        raise ValueError(f"{path}: implausible PNG size {w}x{h}")
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat),
                                              h * (stride + 1))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG data: {e}") from None
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: truncated PNG data")
    px = _unfilter(np.frombuffer(raw, np.uint8).reshape(h, stride + 1), bpp)
    if depth == 16:
        return px.view(">u2").reshape(h, w).astype(np.uint16)
    return px.reshape((h, w) if spp == 1 else (h, w, spp)).astype(dtype)
