"""GIMP brushes read as PIL 12 reads them for the JAX package
(``PIL/GbrImagePlugin.py``): its TIFF fallback's ``Image.open`` of a
file under a TIFF name, and the toolbox's ``imread``.

A big-endian header: its size (at least 20), the version (1, or 2 with
``GIMP`` and the spacing after the depth), the width, height and depth
(1: ``L``; 4: ``RGBA``), then a comment to the header's end, then the
pixels, ``w * h * depth`` bytes (a version 2 header shorter than 27
bytes raises ``ValueError``, a negative read from PIL's file).  A header
PIL refuses raises ``SyntaxError``, on which ``Image.open`` tries its
next plugin; too few pixel bytes raise ``ValueError`` ("not enough image
data").
"""

from __future__ import annotations

import io

import numpy as np

from unmicst_tpu_torch.io import _pil


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 8 and _pil.u32be(prefix) >= 20 and \
        _pil.u32be(prefix, 4) in (1, 2)


def open_header(data: bytes):
    """``GbrImageFile._open``: ``(w, h, depth, offset)``."""
    fp = io.BytesIO(data)
    header_size = _pil.u32be(fp.read(4))
    if header_size < 20:
        raise SyntaxError("not a GIMP brush")
    version = _pil.u32be(fp.read(4))
    if version not in (1, 2):
        raise SyntaxError(f"Unsupported GIMP brush version: {version}")
    w, h, depth = (_pil.u32be(fp.read(4)) for _ in range(3))
    if w == 0 or h == 0:
        raise SyntaxError("not a GIMP brush")
    if depth not in (1, 4):
        raise SyntaxError(f"Unsupported GIMP brush color depth: {depth}")
    if version == 1:
        comment_length = header_size - 20
    else:
        comment_length = header_size - 28
        if fp.read(4) != b"GIMP":
            raise SyntaxError("not a GIMP brush, bad magic number")
        _pil.u32be(fp.read(4))
    if comment_length < -1:  # a file's read refuses it
        raise ValueError("read length must be non-negative or -1")
    fp.read(comment_length)
    _pil.bomb_check(w, h)
    return w, h, depth, fp.tell()


def read_frame(data: bytes, index) -> np.ndarray:
    """The brush, as ``np.asarray(Image.open(f))`` gives it; ``EOFError``
    past frame 0."""
    w, h, depth, offset = open_header(data)
    if index:
        raise EOFError("no more images in file")
    _pil.setimage_check(w, 8 * depth)
    body = data[offset : offset + w * h * depth]
    if len(body) < w * h * depth:
        raise ValueError("not enough image data")
    px = np.frombuffer(body, np.uint8).reshape(h, w, depth)
    return px[..., 0].copy() if depth == 1 else px.copy()
