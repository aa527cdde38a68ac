"""X11 bitmaps (XBM) read and written as PIL 12 reads and writes them for
the JAX package (``PIL/XbmImagePlugin.py``, ``XbmDecode.c``,
``XbmEncode.c``): its TIFF fallback's ``Image.open`` of a file under a
TIFF name, the toolbox's ``imread`` and its ``Image.fromarray(image)
.save(path)`` of an ``.xbm`` name.

Reading (:func:`open_header`, :func:`read_frame`): PIL's header pattern
over the first 512 bytes (``#define ..._width N``, ``..._height N``, an
optional hotspot, then anything up to ``_bits[]``; no match is a
``SyntaxError``, on which ``Image.open`` tries its next plugin), then the
data from the end of the match as ``XbmDecode.c`` reads it: skip to the
next ``x``, take the two characters after it as hex digits (anything not
a hex digit as 0), three characters on, again; each row is ``ceil(w /
8)`` such bytes, the bits LSB first, a set bit ``True``.  Data that ends
before the image raises ``OSError`` (truncated).

Writing (:func:`encode_xbm`): mode ``1`` (bool) only: ``#define
im_width``, ``im_height``, ``static char im_bits[] = {``, the bytes as
``0x..`` separated by commas, a newline after every 15th (counted across
rows) and after the last, and ``};``.  Any other mode raises PIL's
``OSError``.
"""

from __future__ import annotations

import re

import numpy as np

from unmicst_tpu_torch.io import _pil
from unmicst_tpu_torch.io.png import array_mode

_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
_HEX = np.zeros(256, np.uint8)
for _c in b"0123456789":
    _HEX[_c] = _c - ord("0")
for _c in b"abcdef":
    _HEX[_c] = _HEX[_c - 32] = _c - ord("a") + 10
_PER_LINE = 79 // 5


def accept(prefix: bytes) -> bool:
    return prefix.lstrip().startswith(b"#define")


def open_header(data: bytes):
    """``XbmImageFile._open``: (width, height, data offset), or
    ``SyntaxError``."""
    m = _HEAD.match(data[:512])
    if not m:
        raise SyntaxError("not a XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    if w <= 0 or h <= 0:
        raise SyntaxError("not identified by this driver")
    return w, h, m.end()


def _digits(data: bytes, pos: int, need: int) -> np.ndarray:
    """The positions of the first ``need`` bytes' ``x`` characters, as
    ``XbmDecode.c`` walks from ``pos`` (an ``x`` among the two digits
    after one is a digit); fewer where the data ends first."""
    buf = np.frombuffer(data, np.uint8, offset=pos)
    xs = np.flatnonzero(buf == ord("x"))
    xs = xs[xs + 3 <= len(buf)] if len(xs) else xs
    if len(xs) and (np.diff(xs) >= 3).all():
        return xs[:need] + pos
    out, last = [], -3
    for x in xs.tolist():
        if x >= last + 3:
            out.append(x)
            last = x
            if len(out) == need:
                break
    return np.asarray(out, np.int64) + pos


def read_frame(data: bytes, index: int = 0) -> np.ndarray:
    """Frame ``index`` of an XBM file's bytes as ``Image.open``, ``seek``
    and ``np.asarray`` give it (see the module docstring)."""
    w, h, pos = open_header(data)
    _pil.bomb_check(w, h)
    if index != 0:
        raise EOFError("attempt to seek outside sequence")
    row = (w + 7) // 8
    xs = _digits(data, pos, row * h)
    if len(xs) < row * h:
        raise _pil.truncated(0)
    raw = np.frombuffer(data, np.uint8)
    vals = (_HEX[raw[xs + 1]] << 4) | _HEX[raw[xs + 2]]
    bits = np.unpackbits(vals.reshape(h, row), axis=1, bitorder="little")
    return bits[:, :w].astype(bool)


def encode_xbm(image: np.ndarray) -> bytes:
    """The bytes ``Image.fromarray(image).save(path)`` writes for an XBM
    name (see the module docstring)."""
    mode, img = array_mode(image)
    if mode != "1":
        raise OSError(f"cannot write mode {mode} as XBM")
    h, w = img.shape
    head = (f"#define im_width {w}\n#define im_height {h}\n"
            "static char im_bits[] = {\n").encode("ascii")
    if 0 in img.shape:
        raise SystemError("tile cannot extend outside image")
    vals = np.packbits(img, axis=1, bitorder="little").ravel()
    n = len(vals)
    hexes = np.frombuffer(b"0123456789abcdef", np.uint8)
    # each byte "0x..," and a newline after every 15th (not the last)
    cells = np.empty((n, 6), np.uint8)
    cells[:, 0], cells[:, 1] = ord("0"), ord("x")
    cells[:, 2], cells[:, 3] = hexes[vals >> 4], hexes[vals & 15]
    cells[:, 4], cells[:, 5] = ord(","), ord("\n")
    keep = np.ones((n, 6), bool)
    keep[:, 5] = (np.arange(n) + 1) % _PER_LINE == 0
    keep[-1, 4], keep[-1, 5] = False, True
    return head + cells[keep].tobytes() + b"};\n"


def write_xbm(path: str, image: np.ndarray) -> None:
    """Write ``image`` as ``Image.fromarray(image).save(path)`` writes an
    XBM file (:func:`encode_xbm`)."""
    data = encode_xbm(image)
    with open(path, "wb") as f:
        f.write(data)
