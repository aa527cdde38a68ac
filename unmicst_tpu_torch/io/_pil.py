"""What PIL 12's ``Image.open`` and ``ImageFile.load`` do around a format
plugin, for the port's readers of the formats the JAX package reaches
through PIL (``io/pcx.py``, ``io/tga.py``, ``io/sgi.py``,
``io/identify.py``): the decompression-bomb check, the exceptions a
plugin's ``_open`` may raise for ``Image.open`` to try the next plugin,
and the messages of the loader's decoder errors.
"""

from __future__ import annotations

import struct

# Image.MAX_IMAGE_PIXELS; Image.open refuses twice as many
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3
# a plugin's _open raising one of these hands the file to the next plugin
# (ImageFile.__init__ turns the last four into SyntaxError)
PASS = (SyntaxError, IndexError, TypeError, KeyError, EOFError, struct.error)

TRUNCATED = "image file is truncated"
OVERRUN = "buffer overrun when reading image file"
NOT_LARGE_ENOUGH = "buffer is not large enough"


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
