"""McIDAS area files (satellite imagery) read as PIL 12 reads them for the
JAX package (``PIL/McIdasImagePlugin.py``): its TIFF fallback's
``Image.open`` of a file under a TIFF name, and the toolbox's ``imread``.

The file starts with a 256-byte directory of 64 big-endian signed words
whose first eight bytes are ``00 00 00 00 00 00 00 04``.  Counting the
words from 1, word 9 is the height, 10 the width, 11 the bytes a sample
(1: ``L``; 2: ``I;16B``, big-endian uint16 as PIL keeps it; 4: ``I``,
from big-endian int32), 14 the bands, 15 each row's prefix and 34 the
data's offset.  PIL reads one band, rows ``prefix + width * bytes *
bands`` bytes apart from ``offset + prefix``; it maps ``L`` and
``I;16B`` from the file (data that end early raise ``ValueError``, as
they do where the data start past the file's end) and decodes ``I``
(``OSError``; a row step shorter than a row: ``OSError``).  Any other
sample size raises ``SyntaxError``, on which ``Image.open`` tries its
next plugin.
"""

from __future__ import annotations

import struct

import numpy as np

from unmicst_tpu_torch.io import _pil

_MODES = {1: ("L", "L"), 2: ("I;16B", "I;16B"), 4: ("I", "I;32B")}


def accept(prefix: bytes) -> bool:
    return prefix.startswith(b"\0\0\0\0\0\0\0\x04")


def open_header(data: bytes):
    """``McIdasImageFile._open``: ``(mode, rawmode, (w, h), offset,
    stride)``, or ``SyntaxError``."""
    s = data[:256]
    if not accept(s) or len(s) != 256:
        raise SyntaxError("not an McIdas area file")
    w = (0,) + struct.unpack("!64i", s)
    if w[11] not in _MODES:
        raise SyntaxError("unsupported McIdas format")
    mode, rawmode = _MODES[w[11]]
    return (mode, rawmode, (w[10], w[9]), w[34] + w[15],
            w[15] + w[10] * w[11] * w[14])


def read_frame(data: bytes, index) -> np.ndarray:
    """The image, as ``np.asarray(Image.open(f))`` gives it (see the
    module docstring); ``EOFError`` past frame 0."""
    mode, rawmode, (w, h), offset, stride = open_header(data)
    if index:
        raise EOFError("no more images in file")
    size = {"L": 1, "I;16B": 2, "I;32B": 4}[rawmode]
    mapped = mode if mode == rawmode else ""
    if not mapped:
        _pil.setimage_check(w, 8 * size)
    rows = _pil.raw_rows(data, offset, w * size, h, stride, mapped=mapped,
                         width=w)
    return _pil.unpack(rows, rawmode, w)
