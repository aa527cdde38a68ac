"""Encapsulated PostScript written as PIL 12 writes it for the JAX
package's toolbox (``PIL/EpsImagePlugin.py`` ``_save`` and
``EpsEncode.c``, ``Image.fromarray(image).save(path)`` of an ``.eps`` or
``.ps`` name).  Reading EPS needs Ghostscript in PIL, and stays with
ROADMAP M17.

:func:`encode_eps` writes modes ``L`` (an ``image`` operator) and ``RGB``
(``false 3 colorimage``): PIL's DSC comments (``%ImageData`` with one
``%``, as its formatting leaves it), the PostScript prologue, the pixels
as lowercase hex, 39 bytes (78 digits) a line counted across rows, no
newline after the last, then ``\\n%%%%EndBinary`` (four ``%``, as PIL
writes it) and ``grestore end``.  Any other mode raises PIL's
``ValueError``.
"""

from __future__ import annotations

import numpy as np

from unmicst_tpu_torch.io.png import array_mode

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
