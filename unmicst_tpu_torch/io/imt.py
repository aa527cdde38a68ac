"""IM Tools images read as PIL 12 reads them for the JAX package
(``PIL/ImtImagePlugin.py``): its TIFF fallback's ``Image.open`` of a
file under a TIFF name, and the toolbox's ``imread``.

A text header of ``key value`` lines (``*`` starts a comment; a newline
among the first 100 bytes) up to a form feed, after which the 8-bit
pixels start: ``width``, ``height`` and ``pixel n8`` (mode ``L``) are
the keys PIL reads; a line PIL does not parse ends the header early, and
then the image has no data (``OSError``, "cannot load this image").  A
file without ``pixel n8`` or a size above zero is not identified, and
``Image.open`` tries its next plugin.  PIL maps the pixels from the file:
data that end early raise ``ValueError`` (``OSError`` where they start
past the file's end).
"""

from __future__ import annotations

import io
import re

import numpy as np

from unmicst_tpu_torch.io import _pil

_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def open_header(data: bytes):
    """``ImtImageFile._open``: ``(w, h, mode, offset)``, the offset None
    where the header ends without a form feed; ``SyntaxError`` where PIL
    does not identify the file (``ValueError`` for a size that is no
    integer)."""
    fp = io.BytesIO(data)
    buffer = fp.read(100)
    if b"\n" not in buffer:
        raise SyntaxError("not an IM file")
    w = h = 0
    mode = ""
    offset = None
    size = (0, 0)
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = fp.tell() - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            w = int(v)
            size = (w, h)
        elif k == b"height":
            h = int(v)
            size = (w, h)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise SyntaxError("not identified by this plugin")
    return size[0], size[1], mode, offset


def read_frame(data: bytes, index) -> np.ndarray:
    """The image, as ``np.asarray(Image.open(f))`` gives it; ``EOFError``
    past frame 0."""
    w, h, _, offset = open_header(data)
    if index:
        raise EOFError("no more images in file")
    if offset is None:
        raise OSError("cannot load this image")
    return _pil.raw_rows(data, offset, w, h, mapped="L", width=w)
