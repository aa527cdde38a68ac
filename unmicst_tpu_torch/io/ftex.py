"""FTEX textures (IW2: Enemy of the Community) read as PIL 12 reads them
for the JAX package (``PIL/FtexImagePlugin.py``): its TIFF fallback's
``Image.open`` of a file under a TIFF name, and the toolbox's
``imread``.

``FTEX``, a version, the size (signed), the mipmap and format counts (a
format count other than 1 fails PIL's ``assert``, an ``AssertionError``
that ``Image.open`` lets escape), the first format and where its first
mipmap lies: its size word, then its data (a size of -1 reads to the end
of the file, a smaller one is the file's ``ValueError``).  Format 0 is DXT1 (``RGBA``, through
:mod:`unmicst_tpu_torch.io.bcn`), 1 uncompressed ``RGB``; another raises
PIL's ``ValueError``.  Data that end before the image raise PIL's
``OSError``.  A size that is not above zero raises ``ValueError``:
PIL's ``_open`` closes the file before ``Image.open`` refuses the size,
and the next plugin finds it closed.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from unmicst_tpu_torch.io import _pil, bcn

MAGIC = b"FTEX"


def open_header(data: bytes) -> Tuple[int, int, int, bytes]:
    """``FtexImageFile._open``: ``(width, height, format, mipmap data)``,
    or PIL's exception (``SyntaxError`` for a size not above zero)."""
    if not data.startswith(MAGIC):
        raise SyntaxError("not an FTEX file")
    struct.unpack("<i", data[4:8])  # the version
    w, h = struct.unpack("<2i", data[8:16])
    _, format_count = struct.unpack("<2i", data[16:24])
    if format_count != 1:  # PIL's assert
        raise AssertionError
    fmt, where = struct.unpack("<2i", data[24:32])
    if where < 0:  # the file's seek
        raise OSError(22, "Invalid argument")
    (size,) = struct.unpack("<i", data[where : where + 4])
    if size < -1:  # the file's read: -1 reads to the end, less refuses
        raise ValueError("read length must be non-negative or -1")
    start = where + 4
    mip = data[start:] if size < 0 else data[start : start + size]
    if fmt not in (0, 1):
        raise ValueError(f"Invalid texture compression format: {fmt!r}")
    if w <= 0 or h <= 0:
        # PIL's _open has closed the file it was given: Image.open's next
        # plugin cannot read it
        raise ValueError("I/O operation on closed file.")
    return w, h, fmt, mip


def read_frame(data: bytes, index: int = 0) -> np.ndarray:
    """Frame ``index`` of an FTEX file's bytes as ``Image.open``, ``seek``
    and ``np.asarray`` give it: DXT1 as ``[h, w, 4]``, uncompressed as
    ``[h, w, 3]`` uint8; ``EOFError`` past frame 0."""
    w, h, fmt, mip = open_header(data)
    _pil.bomb_check(w, h)
    if index != 0:
        raise EOFError("attempt to seek outside sequence")
    if fmt == 0:
        return bcn.decode(mip, 0, 1, w, h)
    _pil.setimage_check(w, 24)
    return _pil.raw_rows(mip, 0, 3 * w, h).reshape(h, w, 3)
