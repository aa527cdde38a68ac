"""XV thumbnails read as PIL 12 reads them for the JAX package
(``PIL/XVThumbImagePlugin.py``): its TIFF fallback's ``Image.open`` of a
file under a TIFF name, and the toolbox's ``imread``.

``P7 332``, the rest of that line, ``#`` comment lines, then a line whose
first two words are the width and height, then one byte a pixel: ``P``
over the 3-3-2 RGB palette (``np.asarray`` gives the bytes).  A file that
ends in the comments raises ``SyntaxError``, on which ``Image.open``
tries its next plugin; a size line of fewer than two words, or words
that are no integers, ``ValueError``, which escapes ``Image.open``.  PIL
maps the pixels from the file: data that end early raise ``ValueError``
(``OSError`` where they start past the file's end).
"""

from __future__ import annotations

import io

import numpy as np

from unmicst_tpu_torch.io import _pil

MAGIC = b"P7 332"


def open_header(data: bytes):
    """``XVThumbImageFile._open``: ``(w, h, offset)``."""
    fp = io.BytesIO(data)
    if not fp.read(6).startswith(MAGIC):
        raise SyntaxError("not an XV thumbnail file")
    fp.readline()
    while True:
        s = fp.readline()
        if not s:
            raise SyntaxError("Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:
            break
    w, h = s.strip().split(maxsplit=2)[:2]
    w, h = int(w), int(h)
    if w <= 0 or h <= 0:
        raise SyntaxError("not identified by this plugin")
    return w, h, fp.tell()


def read_frame(data: bytes, index) -> np.ndarray:
    """The image's indices, as ``np.asarray(Image.open(f))`` gives them;
    ``EOFError`` past frame 0."""
    w, h, offset = open_header(data)
    if index:
        raise EOFError("no more images in file")
    return _pil.raw_rows(data, offset, w, h, mapped="P", width=w)
