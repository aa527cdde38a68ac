"""X11 pixmaps (XPM) read as PIL 12 reads them for the JAX package
(``PIL/XpmImagePlugin.py``): its TIFF fallback's ``Image.open`` of a
file under a TIFF name, and the toolbox's ``imread``.

``/* XPM */``, then the first line that starts ``"w h colours cpp``,
then one colour line each: the ``cpp`` characters after its first byte
are the key, and the first ``c`` entry names its colour (``#rrggbb``;
``None`` is the transparent key, which PIL keeps out of the palette; any
other name, or no ``c`` entry, raises ``ValueError``, which escapes
``Image.open``).  Up to 256 colours the image is ``P`` (``np.asarray``
gives each key's rank among the ``#`` colours), above ``RGB``.  The
pixel lines follow: ``/* pixels */`` is skipped once, each other line
gives the text between its first and last double quote, ``cpp``
characters a pixel, until the image is full; a key the palette lacks
raises ``ValueError`` (``KeyError`` in an ``RGB`` image), too few pixels
``ValueError`` ("not enough image data").  A file without the size line
raises ``SyntaxError``, on which ``Image.open`` tries its next plugin.
"""

from __future__ import annotations

import dataclasses
import io
import re

import numpy as np

_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


@dataclasses.dataclass
class XpmHeader:
    width: int
    height: int
    bpp: int
    palette: dict  # key -> (r, g, b), the "#" colours in their order
    offset: int  # the first pixel line's
    mode: str  # "P" up to 256 colour lines, else "RGB"


def open_header(data: bytes) -> XpmHeader:
    """``XpmImageFile._open`` (see the module docstring)."""
    fp = io.BytesIO(data)
    if not fp.read(9).startswith(b"/* XPM */"):
        raise SyntaxError("not an XPM file")
    while True:
        line = fp.readline()
        if not line:
            raise SyntaxError("broken XPM file")
        m = _HEAD.match(line)
        if m:
            break
    w, h = int(m.group(1)), int(m.group(2))
    n, bpp = int(m.group(3)), int(m.group(4))
    palette = {}
    for _ in range(n):
        line = fp.readline().rstrip()
        c = line[1 : bpp + 1]
        s = line[bpp + 1 : -2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                rgb = s[i + 1]
                if rgb == b"None":
                    pass
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[c] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise ValueError("cannot read this XPM file")
                break
        else:
            raise ValueError("cannot read this XPM file")
    if w <= 0 or h <= 0:
        raise SyntaxError("not identified by this plugin")
    return XpmHeader(w, h, bpp, palette, fp.tell(),
                     "RGB" if n > 256 else "P")


def read_frame(data: bytes, index) -> np.ndarray:
    """The image, as ``np.asarray(Image.open(f))`` gives it (see the
    module docstring); ``EOFError`` past frame 0."""
    hdr = open_header(data)
    if index:
        raise EOFError("no more images in file")
    fp = io.BytesIO(data)
    fp.seek(hdr.offset)
    rgb = hdr.mode == "RGB"
    keys = tuple(hdr.palette)
    need = hdr.width * hdr.height * (3 if rgb else 1)
    out = bytearray()
    pixel_header = False
    while len(out) < need:
        line = fp.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not pixel_header:
            pixel_header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(line), hdr.bpp):
            key = line[i : i + hdr.bpp]
            if rgb:
                out += bytes(hdr.palette[key])
            else:
                out.append(keys.index(key))
    if len(out) < need:
        raise ValueError("not enough image data")
    px = np.frombuffer(bytes(out[:need]), np.uint8)
    return px.reshape(hdr.height, hdr.width, 3) if rgb else \
        px.reshape(hdr.height, hdr.width)
