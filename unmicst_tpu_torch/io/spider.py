"""SPIDER images and stacks (the image format of the SPIDER and cryo-EM
tool chains) read as PIL 12 reads them for the JAX package
(``PIL/SpiderImagePlugin.py``): its TIFF fallback's ``Image.open`` and
``seek(channel)`` of a file under a TIFF name, and the toolbox's
``imread`` (no seek).

A SPIDER file has no magic number: its label is 27 or more 4-byte floats,
big-endian or else little-endian, where words 1, 2, 5, 12, 13, 22 and 23
(counting from 1) are integral, word 5 (``iform``) is one of 1, 3, -11,
-12, -21, -22 and the label's length in bytes (word 22) is its records
(13) times their length (23); PIL opens only ``iform`` 1, a 2-D image.
Words 24 (``istack``) and 27 (``imgnum``) tell a single image (both 0:
its float32 plane follows the label) from a stack's own label
(``istack`` above 0, ``imgnum`` 0: word 26 counts its images, the first
image's label follows this one's, its plane that label).

:func:`read_frame` is ``Image.open``, then ``seek(index)``, then
``np.asarray``: ``index`` None (no seek) gives a single image, or a
stack's first image; on a single image any seek raises ``EOFError``
("attempt to seek in a non-stack file", which the JAX CLI turns into
``IndexError``); on a stack ``seek(k)`` re-opens the label at ``hdrlen +
k * (hdrlen + imgbytes)`` (``hdrlen`` and ``imgbytes`` the stack label's)
and reads the plane after it, and ``k`` at or past word 26 raises
``EOFError``.  The pixels are mode ``F``: float32 in the label's byte
order.  A plane cut short raises PIL's ``OSError``.
"""

from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np

from unmicst_tpu_torch.io import _pil

IFORMS = (1, 3, -11, -12, -21, -22)


@dataclasses.dataclass
class SpiderHeader:
    width: int
    height: int
    bigendian: bool
    hdrlen: int
    istack: int
    imgnumber: int
    nimages: int
    offset: int
    imgbytes: int = 0


def _is_int(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def header_length(t) -> int:
    """``isSpiderHeader``: the label's length in bytes, or 0 where the
    floats ``t`` are no SPIDER label."""
    h = (99,) + tuple(t)
    for i in (1, 2, 5, 12, 13, 22, 23):
        if not _is_int(h[i]):
            return 0
    if int(h[5]) not in IFORMS:
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def open_header(data: bytes, pos: int = 0,
                stkoffset: float = math.nan) -> SpiderHeader:
    """``SpiderImageFile._open`` of the label at ``data[pos]``
    (``stkoffset``: where ``seek`` found it); ``SyntaxError`` where PIL
    refuses it, ``ValueError`` for a NaN or infinite stack word, as
    PIL's ``int``."""
    f = data[pos : pos + 27 * 4]
    if len(f) < 27 * 4:
        raise SyntaxError("not a valid Spider file")
    for order in (">", "<"):
        t = struct.unpack(order + "27f", f)
        hdrlen = header_length(t)
        if hdrlen:
            break
    else:
        raise SyntaxError("not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    w, hh = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    imgbytes = 0
    if istack == 0 and imgnumber == 0:
        offset, nimages = hdrlen, 1
    elif istack > 0 and imgnumber == 0:
        imgbytes = w * hh * 4
        nimages = int(h[26])
        offset, imgnumber = hdrlen * 2, 1
    elif istack == 0 and imgnumber > 0:
        if math.isnan(stkoffset):
            raise AttributeError(
                "'SpiderImageFile' object has no attribute 'stkoffset'")
        offset, istack, nimages = hdrlen + stkoffset, 2, -1
    else:
        raise SyntaxError("inconsistent stack header values")
    return SpiderHeader(w, hh, order == ">", hdrlen, istack, imgnumber,
                        nimages, int(offset), imgbytes)


def _seek(data: bytes, hdr: SpiderHeader, frame: int) -> SpiderHeader:
    """``SpiderImageFile.seek(frame)`` from ``hdr``, the first label."""
    if hdr.istack == 0:
        raise EOFError("attempt to seek in a non-stack file")
    if frame < 0 or frame >= hdr.nimages:
        raise EOFError("attempt to seek outside sequence")
    if frame == hdr.imgnumber - 1:  # tell()
        return hdr
    stkoffset = hdr.hdrlen + frame * (hdr.hdrlen + hdr.imgbytes)
    new = open_header(data, stkoffset, stkoffset)
    if new.nimages < 0:  # an image of the stack keeps the stack's count
        new.nimages = hdr.nimages
    if new.imgbytes == 0:  # and its label's length and plane size
        new.hdrlen, new.imgbytes = hdr.hdrlen, hdr.imgbytes
    return new


def read_frame(data: bytes, index) -> np.ndarray:
    """Image ``index`` of a SPIDER file (None: no seek; see the module
    docstring)."""
    hdr = open_header(data)
    if index is not None:
        hdr = _seek(data, hdr, index)
    rawmode = "F;32BF" if hdr.bigendian else "F;32F"
    _pil.setimage_check(hdr.width, 32)
    rows = _pil.raw_rows(data, hdr.offset, 4 * hdr.width, hdr.height)
    return _pil.unpack(rows, rawmode, hdr.width)
