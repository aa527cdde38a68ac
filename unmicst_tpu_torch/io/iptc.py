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
data through :mod:`unmicst_tpu_torch.io.mpo` (frame 0), whose own size
and mode the loaded image keeps: a colour JPEG in an ``L`` record packs
as ``L`` from its four bytes a pixel (each row's first bytes), and
``Image.merge`` refuses it among the bands of an ``RGB`` or ``CMYK``
record (``ValueError``).  ``np.asarray`` takes the record's shape from
those bytes, the first of them where the image is larger than the
record; where it is smaller PIL's array reads past the image's bytes
(memory it does not own), and the port raises ``ValueError``.
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
    """The image PIL opens from the data fields' copy: the record's ``L``
    plane for raw data; a JPEG's own array for JPEG data."""
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

    return mpo.read_frame(body, 0)


def _packed(mem: np.ndarray, hdr: IptcHeader, bands: int) -> np.ndarray:
    """``np.asarray`` of the record: ``tobytes`` packs the loaded image at
    its own size (``mem``: its memory, ``[h', w', 4]`` for more than one
    band), and the array takes the record's shape from those bytes."""
    h, w = hdr.height, hdr.width
    if mem.ndim == 2:
        flat = mem.reshape(-1)
    elif bands == 1:  # an L packer over four bytes a pixel: each row's
        hj, wj = mem.shape[:2]  # first w' bytes
        flat = mem.reshape(hj, 4 * wj)[:, :wj].reshape(-1)
    else:
        flat = mem[..., :bands].reshape(-1)
    need = h * w * bands
    if flat.size < need:
        raise ValueError(
            f"an IPTC record of {w}x{h} holding a {mem.shape[1]}x"
            f"{mem.shape[0]} image: PIL's array reads past the image's "
            "bytes, so unmicst_tpu_torch refuses it")
    out = flat[:need]
    return out.reshape((h, w) if bands == 1 else (h, w, bands))


def read_frame(data: bytes, index) -> np.ndarray:
    """The image, as ``np.asarray(Image.open(f))`` gives it (see the
    module docstring); ``EOFError`` past frame 0."""
    hdr = open_header(data)
    if index:
        raise EOFError("no more images in file")
    if hdr.offset is None:
        raise OSError("cannot load this image")
    px = _inner(data, hdr)
    if px.ndim == 3:  # RGB: the image's memory holds a fourth byte, 255
        px = np.concatenate([px, np.full(px.shape[:2] + (1,), 255,
                                         np.uint8)], 2)
    if hdr.band is None:
        return _packed(px, hdr, 1)
    bands = len(hdr.mode)
    if not -bands <= hdr.band < bands:
        raise IndexError("list assignment index out of range")
    if px.ndim == 3:  # Image.merge: the colour image among L bands
        raise ValueError("image has wrong mode" if hdr.band in (0, -bands)
                         else "mode mismatch")
    mem = np.zeros(px.shape + (4,), np.uint8)
    mem[..., hdr.band % bands] = px
    return _packed(mem, hdr, bands)
