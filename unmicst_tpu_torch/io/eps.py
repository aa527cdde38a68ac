"""Encapsulated PostScript as PIL 12 opens and writes it for the JAX
package (``PIL/EpsImagePlugin.py``): ``Image.open`` of a file under a
TIFF name or in the toolbox's ``imread``, and ``_save`` with
``EpsEncode.c`` for ``Image.fromarray(image).save(path)`` of an ``.eps``
or ``.ps`` name.  Reading the pixels needs Ghostscript in PIL, and stays
with ROADMAP M17.

:func:`open_header` is ``EpsImageFile._open``: ``%!PS``, or a DOS EPS
binary header that gives the PostScript's offset; then the lines (``\r``
or ``\n`` ended, 255 bytes at most where they start with ``%``) of the
header comments (``%!PS-Adobe`` and ``%%BoundingBox`` required where they
end: ``SyntaxError``, the next plugin; a line of the header that is no
comment: ``OSError``), the first ``%ImageData`` (its size and mode; a
bit depth other than 1 or 8 ends the walk, a mode PIL does not know is
its ``KeyError``, the next plugin), ``%%BeginBinary`` skips, the trailer's
``%%BoundingBox`` where the header's was ``(atend)``, and ``%%EOF``.
Without a bounding box ``OSError``; the size is the ``%ImageData`` one,
else the box's.

:func:`encode_eps` writes modes ``L`` (an ``image`` operator) and ``RGB``
(``false 3 colorimage``): PIL's DSC comments (``%ImageData`` with one
``%``, as its formatting leaves it), the PostScript prologue, the pixels
as lowercase hex, 39 bytes (78 digits) a line counted across rows, no
newline after the last, then ``\\n%%%%EndBinary`` (four ``%``, as PIL
writes it) and ``grestore end``.  Any other mode raises PIL's
``ValueError``.
"""

from __future__ import annotations

import re
import struct
from typing import Tuple

import numpy as np

from unmicst_tpu_torch.io.png import array_mode

_SPLIT = re.compile(r"^%%([^:]*):[ \t]*(.*)[ \t]*$")
_FIELD = re.compile(r"^%[%!\w]([^:]*)[ \t]*$")
_MODES = {1: "L", 2: "LAB", 3: "RGB", 4: "CMYK"}


def open_header(data: bytes) -> Tuple[int, int]:
    """``EpsImageFile._open`` over the file ``data``: the size PIL opens,
    or its exception."""
    if data[:4] == b"%!PS":
        pos = 0
    elif struct.unpack("<I", data[:4])[0] == 0xC6D3D0C5:
        pos = struct.unpack("<I", data[4:8])[0]
    else:
        raise SyntaxError("not an EPS file")
    info: dict = {}
    bbox = None
    imagedata = None
    header, trailer_comments, trailer = True, False, False

    def required():
        if "PS-Adobe" not in info:
            raise SyntaxError('EPS header missing "%!PS-Adobe" comment')
        if "BoundingBox" not in info:
            raise SyntaxError('EPS header missing "%%BoundingBox" comment')

    def comment(text: str) -> bool:
        nonlocal bbox, trailer_comments
        m = _SPLIT.match(text)
        if not m:
            return False
        k, v = m.group(1, 2)
        info[k] = v
        if k == "BoundingBox":
            if v == "(atend)":
                trailer_comments = True
            elif not bbox or (trailer and trailer_comments):
                try:
                    bbox = [int(float(i)) for i in v.split()]
                except Exception:  # noqa: BLE001 -- PIL passes over it
                    pass
        return True

    # PIL's line buffer: 255 bytes never cleared, so the prefix tests
    # below see what an earlier, longer line left past this one's end
    buf, nread = bytearray(255), 0
    while True:
        byte = data[pos : pos + 1] if pos >= 0 else b""
        pos += 1
        if byte == b"":
            if nread == 0:
                if header:
                    required()
                break
        elif byte in b"\r\n":
            if nread == 0:
                continue
        else:
            if nread >= 255:
                if buf[0] == ord("%"):
                    raise SyntaxError("not an EPS file")
                if header:
                    required()
                    header = False
                nread = 0
            buf[nread] = byte[0]
            nread += 1
            continue
        if header:
            if buf[0] != ord("%") or buf[:13] == b"%%EndComments":
                required()
                header = False
                continue
            text = buf[:nread].decode("latin-1")
            if not comment(text):
                m = _FIELD.match(text)
                if m:
                    k = m.group(1)
                    info["PS-Adobe" if k.startswith("PS-Adobe") else k] = ""
        elif buf[:11] == b"%ImageData:":
            if imagedata:
                nread = 0
                continue
            values = buf[11:nread].split(None, 7)
            cols, rows, depth, mode = (int(v) for v in values[:4])
            if depth == 8:
                _MODES[mode]  # noqa: B018 -- KeyError: the next plugin
            elif depth != 1:
                break
            imagedata = cols, rows
        elif buf[:5] == b"%%EOF":
            break
        elif trailer and trailer_comments:
            comment(buf[:nread].decode("latin-1"))
        elif buf[:9] == b"%%Trailer":
            trailer = True
        elif buf[:14] == b"%%BeginBinary:":
            pos += int(buf[14:nread])
            if pos < 0:
                raise OSError(22, "Invalid argument")
        nread = 0
    if not bbox:
        raise OSError("cannot determine EPS bounding box")
    w, h = imagedata or (bbox[2] - bbox[0], bbox[3] - bbox[1])
    if w <= 0 or h <= 0:
        raise SyntaxError("not identified by this driver")
    return w, h


_OPERATORS = {"L": (8, 1, b"image"), "RGB": (8, 3, b"false 3 colorimage")}
_PER_LINE = 79 // 2


def encode_eps(image: np.ndarray) -> bytes:
    """The bytes ``Image.fromarray(image).save(path)`` writes for an EPS
    name (see the module docstring)."""
    mode, img = array_mode(image)
    if mode not in _OPERATORS:
        raise ValueError("image mode is not supported")
    h, w = img.shape[:2]
    bits, bands, op = _OPERATORS[mode]
    head = (b"%!PS-Adobe-3.0 EPSF-3.0\n%%Creator: PIL 0.1 EpsEncode\n"
            + b"%%%%BoundingBox: 0 0 %d %d\n" % (w, h)
            + b"%%Pages: 1\n%%EndComments\n%%Page: 1 1\n"
            + b"%%ImageData: %d %d " % (w, h)
            + b'%d %d 0 1 1 "%s"\n' % (bits, bands, op)
            + b"gsave\n10 dict begin\n/buf %d string def\n" % (w * bands)
            + b"%d %d scale\n%d %d 8\n" % (w, h, w, h)
            + b"[%d 0 0 -%d 0 %d]\n" % (w, h, h)
            + b"{ currentfile buf readhexstring pop } bind\n" + op + b"\n")
    if 0 in img.shape:
        raise SystemError("tile cannot extend outside image")
    vals = np.ascontiguousarray(img).ravel()
    n = len(vals)
    hexes = np.frombuffer(b"0123456789abcdef", np.uint8)
    cells = np.empty((n, 3), np.uint8)
    cells[:, 0], cells[:, 1] = hexes[vals >> 4], hexes[vals & 15]
    cells[:, 2] = ord("\n")
    keep = np.ones((n, 3), bool)
    keep[:, 2] = (np.arange(n) + 1) % _PER_LINE == 0
    keep[-1, 2] = False
    return (head + cells[keep].tobytes()
            + b"\n%%%%EndBinary\ngrestore end\n")


def write_eps(path: str, image: np.ndarray) -> None:
    """Write ``image`` as ``Image.fromarray(image).save(path)`` writes an
    EPS file (:func:`encode_eps`)."""
    data = encode_eps(image)
    with open(path, "wb") as f:
        f.write(data)
