"""IPTC/NAA image records read as PIL 12 reads them for the JAX package
(``PIL/IptcImagePlugin.py``): its TIFF fallback's ``Image.open`` of a
file under a TIFF name, and the toolbox's ``imread``.

Fields of 0x1C, record, tag and a 2-byte length (or, above 0x8000, a
count of length bytes); the image's fields are (3, 20) width, (3, 30)
height, (3, 60) layers and component, (3, 65) band and (3, 120)
compression (1 raw, 5 JPEG), and the data fields (8, 10) follow.  One
layer without a component is ``L``; 3 or 4 layers with one are ``RGB``
or ``CMYK``, the data filling band (3, 65) - 1 (0 without it; -1 is the
last) and the other bands 0.  PIL's ``load`` copies the data fields out,
behind a ``P5`` header of the record's size for raw data, and opens that
copy as an image: raw data read as a PGM (short data ``OSError``), JPEG
data through :mod:`unmicst_tpu_torch.io.mpo` (frame 0).  A JPEG of
other than 8-bit gray samples, or of another size than the record's,
raises ``NotImplementedError`` naming ROADMAP M17.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Optional

import numpy as np

from unmicst_tpu_torch.io import _pil

_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)
_COMPRESSION = {1: "raw", 5: "jpeg"}


@dataclasses.dataclass
class IptcHeader:
    width: int
    height: int
    mode: str
    band: Optional[int]
    compression: str
    offset: Optional[int]  # the first data field, None without one


def _field(fp):
    """``IptcImageFile.field``: ``(tag, size)``, ``(None, 0)`` at the
    end."""
    s = fp.read(5)
    if not s.strip(b"\x00"):
        return None, 0
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in _RECORDS:
        raise SyntaxError("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise OSError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        size = _pil.u32be((b"\0\0\0\0" + fp.read(size - 128))[-4:])
    else:
        size = _pil.u16be(s, 3)
    return tag, size


def open_header(data: bytes) -> IptcHeader:
    """``IptcImageFile._open``: PIL's exceptions where it refuses the
    file (``SyntaxError`` and the others on which ``Image.open`` tries
    its next plugin, ``OSError`` for a bad field length or compression)."""
    fp = io.BytesIO(data)
    info: dict = {}
    while True:
        offset = fp.tell()
        tag, size = _field(fp)
        if not tag or tag == (8, 10):
            break
        body = fp.read(size) if size else None
        if tag in info:
            old = info[tag]
            info[tag] = old + [body] if isinstance(old, list) else [old, body]
        else:
            info[tag] = body
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0

    def getint(key):
        return _pil.u32be((b"\0\0\0\0" + info[key])[-4:])

    w, h = getint((3, 20)), getint((3, 30))
    try:
        compression = _COMPRESSION[getint((3, 120))]
    except KeyError:
        raise OSError("Unknown IPTC image compression") from None
    if not mode or w <= 0 or h <= 0:
        raise SyntaxError("not identified by this plugin")
    return IptcHeader(w, h, mode, band, compression,
                      offset if tag == (8, 10) else None)


def _inner(data: bytes, hdr: IptcHeader) -> np.ndarray:
    """The image PIL opens from the data fields' copy, as ``L``."""
    fp = io.BytesIO(data)
    fp.seek(hdr.offset)
    body = bytearray()
    while True:
        tag, size = _field(fp)
        if tag != (8, 10):
            break
        chunk = fp.read(size)
        body += chunk
        if len(chunk) < size:
            break
    body = bytes(body)
    w, h = hdr.width, hdr.height
    if hdr.compression == "raw":
        rows = _pil.raw_rows(body, 0, w, h)
        return rows
    from unmicst_tpu_torch.io import mpo

    px = mpo.read_frame(body, 0)
    if px.dtype != np.uint8 or px.shape != (h, w):
        raise NotImplementedError(
            f"an IPTC record holding a JPEG of {px.shape} {px.dtype} "
            f"samples for a {w}x{h} {hdr.mode} image is not read by "
            "unmicst_tpu_torch (ROADMAP M17)")
    return px


def read_frame(data: bytes, index) -> np.ndarray:
    """The image, as ``np.asarray(Image.open(f))`` gives it (see the
    module docstring); ``EOFError`` past frame 0."""
    hdr = open_header(data)
    if index:
        raise EOFError("no more images in file")
    if hdr.offset is None:
        raise OSError("cannot load this image")
    px = _inner(data, hdr)
    if hdr.band is None:
        return px
    bands = len(hdr.mode)
    out = np.zeros(px.shape + (bands,), np.uint8)
    if not -bands <= hdr.band < bands:
        raise IndexError("list assignment index out of range")
    out[..., hdr.band] = px
    return out
