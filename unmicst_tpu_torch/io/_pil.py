"""What PIL 12's ``Image.open`` and ``ImageFile.load`` do around a format
plugin, for the port's readers of the formats the JAX package reaches
through PIL (``io/pcx.py``, ``io/tga.py``, ``io/sgi.py``,
``io/identify.py``): the decompression-bomb check, the exceptions a
plugin's ``_open`` may raise for ``Image.open`` to try the next plugin,
the messages of the loader's decoder errors, its ``raw`` decoder
(:func:`raw_rows`, :func:`unpack`), its CMYK to RGB conversion
(:func:`cmyk_to_rgb`), and what ``Image.save`` does around a save
handler (:func:`save_file`).
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Callable

import numpy as np

# Image.MAX_IMAGE_PIXELS; Image.open refuses twice as many
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3
# a plugin's _open raising one of these hands the file to the next plugin
# (ImageFile.__init__ turns the last four into SyntaxError)
PASS = (SyntaxError, IndexError, TypeError, KeyError, EOFError, struct.error)

TRUNCATED = "image file is truncated"
OVERRUN = "buffer overrun when reading image file"
NOT_LARGE_ENOUGH = "buffer is not large enough"
# Image._MAPMODES: a single raw tile whose raw mode is the image's mode,
# read from a file PIL opened by name, is mapped from the file
MAP_MODES = ("L", "P", "RGBX", "RGBA", "CMYK", "I;16", "I;16L", "I;16B")


class DecompressionBombError(Exception):
    """PIL's ``DecompressionBombError``: an image of more than twice
    ``MAX_IMAGE_PIXELS`` pixels."""


def bomb_check(w: int, h: int) -> None:
    """``Image._decompression_bomb_check`` of a ``w`` x ``h`` image (its
    warning above ``MAX_IMAGE_PIXELS`` is not repeated here)."""
    pixels = max(1, w) * max(1, h)
    if pixels > 2 * MAX_IMAGE_PIXELS:
        raise DecompressionBombError(
            f"Image size ({pixels} pixels) exceeds limit of "
            f"{2 * MAX_IMAGE_PIXELS} pixels, could be decompression bomb DOS "
            "attack.")


def setimage_check(width: int, bits: int) -> None:
    """A C decoder's ``setimage`` (``decode.c``): ``MemoryError`` where a
    row of ``width`` pixels of ``bits`` bits would overflow its int."""
    if width > (2**31 - 1) // bits - 7:
        raise MemoryError


def truncated(unread: int) -> OSError:
    """``ImageFile.load``'s error where the data ends before the image."""
    return OSError(f"{TRUNCATED} ({unread} bytes not processed)")


def u16le(s: bytes, o: int = 0) -> int:
    return struct.unpack_from("<H", s, o)[0]


def u16be(s: bytes, o: int = 0) -> int:
    return struct.unpack_from(">H", s, o)[0]


def u32le(s: bytes, o: int = 0) -> int:
    return struct.unpack_from("<I", s, o)[0]


def u32be(s: bytes, o: int = 0) -> int:
    return struct.unpack_from(">I", s, o)[0]


def _mapped_stride(mode: str, w: int) -> int:
    """``map_buffer``'s row stride where the tile gives none."""
    if mode in ("L", "P"):
        return w
    return 2 * w if mode.startswith("I;16") else 4 * w


def raw_rows(data: bytes, offset: int, row: int, h: int, stride: int = 0,
             ystep: int = 1, mapped: str = "", width: int = 0) -> np.ndarray:
    """``[h, row]`` uint8: the rows PIL's ``raw`` decoder reads from
    ``data[offset]`` for one tile, ``row`` bytes each and ``stride``
    bytes apart where above 0, the image's top row first (``ystep`` -1:
    the file holds them bottom-up); PIL's error where the data ends first
    (``OSError``, image file is truncated), or a stride shorter than a row
    (``OSError``, codec configuration error) or past a C int
    (``OverflowError``).  ``mapped`` is the image's mode
    where ``ImageFile.load`` maps the file instead (one raw tile whose
    raw mode is that mode, in ``MAP_MODES``; ``width`` its width): there a
    negative offset and data that end before the image raise
    ``ValueError``, but for an offset past the end, which takes the
    decoder."""
    n = len(data)
    if not -2**31 <= stride < 2**31:  # the decoder's C int
        raise OverflowError("signed integer is greater than maximum")
    if mapped:
        if offset < 0:
            raise ValueError("Tile offset cannot be negative")
        if offset + h * stride <= n:
            step = stride if stride > 0 else _mapped_stride(mapped, width)
            if offset + h * step > n:
                raise ValueError(NOT_LARGE_ENOUGH)
            buf = np.frombuffer(data, np.uint8)
            rows = np.lib.stride_tricks.as_strided(
                buf[offset:], (h, row), (step, 1)).copy()
            return rows[::-1] if ystep < 0 else rows
    if offset < 0:
        raise OSError(22, "Invalid argument")
    avail = max(0, n - offset)
    skip = stride - row if stride else 0
    if avail and skip < 0:  # the raw decoder's IMAGING_CODEC_CONFIG
        raise OSError("codec configuration error when reading image file")
    need = h * row + (h - 1) * skip
    if avail < need:
        k = (avail + skip) // (row + skip)  # the whole rows read
        done = k * row + max(k - 1, 0) * skip
        if k and avail - done >= skip:
            done += skip
        raise truncated(avail - done)
    buf = np.frombuffer(data, np.uint8, need, offset)
    if skip:
        buf = np.concatenate([buf, np.zeros(skip, np.uint8)])
    rows = buf.reshape(h, row + skip)[:, :row]
    return np.ascontiguousarray(rows[::-1] if ystep < 0 else rows)


def unpack(rows: np.ndarray, rawmode: str, w: int) -> np.ndarray:
    """The pixels ``np.asarray`` gives for the rows one raw tile of
    ``rawmode`` holds (``Unpack.c``, for the raw modes the port's plugins
    read)."""
    h = rows.shape[0]
    if rawmode in ("1", "1;I"):
        bits = np.unpackbits(rows, axis=1)[:, :w].astype(bool)
        return ~bits if rawmode == "1;I" else bits
    if rawmode in ("L;4", "P;4"):
        px = np.unpackbits(rows, axis=1)[:, : 4 * w].reshape(h, w, 4)
        px = (px * np.array([8, 4, 2, 1], np.uint8)).sum(2, dtype=np.uint8)
        return px * np.uint8(17) if rawmode == "L;4" else px
    if rawmode in ("L", "P"):
        return rows[:, :w]
    if rawmode in ("RGB", "BGR", "RGBX", "BGRX"):
        px = rows[:, : w * len(rawmode)].reshape(h, w, len(rawmode))[..., :3]
        return np.ascontiguousarray(px[..., ::-1] if rawmode[0] == "B"
                                    else px)
    dtype = {"F;32BF": ">f4", "F;32F": "<f4", "F": "<f4", "I;16": "<u2",
             "I;16B": ">u2", "I;32B": ">i4", "I": "<i4"}[rawmode]
    px = np.ascontiguousarray(rows[:, : w * 4 if dtype[-1] == "4"
                                   else w * 2]).view(dtype)
    if rawmode == "I;16B":
        return px
    return px.astype(dtype[1:] if dtype[0] == ">" else dtype)


def cmyk_to_rgb(px: np.ndarray) -> np.ndarray:
    """PIL's ``cmyk2rgb`` (``Convert.c``): each of C, M, Y scaled by
    ``255 - K`` and taken from it, rounded as ``MULDIV255``."""
    px = px.astype(np.int64)
    nk = 255 - px[..., 3:]
    t = px[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def save_file(path: str, write: Callable[[BinaryIO], None]) -> None:
    """``Image.save`` of a file name around a save handler ``write``: the
    file opened ``w+b``; where the handler raises, the file closed with
    what it wrote, and removed if the save created it."""
    created = not os.path.exists(path)
    f = open(path, "w+b")
    try:
        write(f)
    except Exception:
        f.close()
        if created:
            try:
                os.remove(path)
            except PermissionError:
                pass
        raise
    f.close()
