"""PIXAR raster images read as PIL 12 reads them for the JAX package
(``PIL/PixarImagePlugin.py``): its TIFF fallback's ``Image.open`` of a
file under a TIFF name, and the toolbox's ``imread``.

A 512-byte header starting ``80 E8 00 00``: the height and width are the
little-endian words at 416 and 418, the channels and depth those at 424
and 426.  PIL reads only 3 channels of depth 2 (``RGB``, 8-bit samples,
from byte 1024 on); any other pair leaves the image without a mode, and
``Image.open`` tries its next plugin.  Data that end early raise PIL's
``OSError``.
"""

from __future__ import annotations

import numpy as np

from unmicst_tpu_torch.io import _pil

MAGIC = b"\200\350\000\000"


def open_header(data: bytes):
    """``PixarImageFile._open``: ``(w, h)``, or ``SyntaxError`` (or
    ``struct.error`` for a header cut short)."""
    if not data.startswith(MAGIC):
        raise SyntaxError("not a PIXAR file")
    s = data[:512]
    w, h = _pil.u16le(s, 418), _pil.u16le(s, 416)
    if (_pil.u16le(s, 424), _pil.u16le(s, 426)) != (14, 2) or w <= 0 \
            or h <= 0:
        raise SyntaxError("not identified by this plugin")
    return w, h


def read_frame(data: bytes, index) -> np.ndarray:
    """The image, as ``np.asarray(Image.open(f))`` gives it; ``EOFError``
    past frame 0."""
    w, h = open_header(data)
    if index:
        raise EOFError("no more images in file")
    _pil.setimage_check(w, 24)
    return _pil.unpack(_pil.raw_rows(data, 1024, 3 * w, h), "RGB", w)
