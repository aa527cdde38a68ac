"""8-bit grayscale PNG files, in the standard library (``zlib``, ``struct``).

The deploy path writes its ``I%05d_{Im,PM}.png`` pairs here; the JAX
package writes them through PIL, which this package does not use.  Every
row goes out with filter type 0 (none); pixels decode the same in any PNG
reader.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray, level: int = 6) -> None:
    """Write a ``[H, W]`` uint8 plane as an 8-bit grayscale PNG."""
    img = np.asarray(image)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(
            f"write_png takes a [H, W] uint8 plane, got {img.shape} "
            f"{img.dtype}")
    h, w = img.shape
    rows = np.zeros((h, w + 1), np.uint8)  # a filter-type byte per row
    rows[:, 1:] = img
    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # gray, 8 bit
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _chunk(b"IEND", b""))

