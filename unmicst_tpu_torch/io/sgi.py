"""SGI image files read and written as PIL 12 reads and writes them for
the JAX package (``PIL/SgiImagePlugin.py``): its TIFF fallback's
``Image.open`` of a file under a TIFF name (``unmicst_tpu/io/slides.py:
74-79``, ``unmicst_tpu/io/tiff.py:1286-1291``), the toolbox's ``imread``
and its ``Image.fromarray(image).save(path)`` of a ``.sgi``, ``.bw``,
``.rgb`` or ``.rgba`` name.

Reading (:func:`open_header`, :func:`load`):

* the 512-byte header as ``SgiImageFile._open`` reads it: magic 474
  (big-endian), storage 0 (verbatim) or 1 (RLE), 1 or 2 bytes a sample,
  dimension and channel count among PIL's (1 or 2 dimensions with one
  channel give ``L``, 3 dimensions with 3 or 4 channels ``RGB`` and
  ``RGBA``); any other combination raises PIL's ``ValueError``
  ("Unsupported SGI image mode"), a size of zero its ``SyntaxError``
  (``Image.open`` then tries the next plugin) and another storage opens
  and does not load ("cannot load this image");
* the planes one after the other, rows bottom-up; 2-byte samples read as
  their high byte, as PIL decodes raw mode ``L;16B`` into mode ``L``;
* RLE as ``SgiRleDecode.c`` decodes it: the start and length tables
  (``ysize * zsize`` big-endian words each) after the header, each row of
  each channel its own run of packets (the low 7 bits a count, the top
  bit a literal copy, a zero count ends the row); the packet loop counts
  the row's table length down one a packet, stops decoding the image
  (no error) where the last counted packet is not an end, and reports
  an overrun for a row past its width, a table entry before the data,
  or a read past the file's last byte (a literal may not end on it);
* PIL's exceptions at load: ``ValueError`` where the data ends short and
  PIL maps the file (one 1-byte channel) or builds the planes from bytes
  (2-byte samples stored verbatim: "not enough image data"), ``OSError``
  where it reads them.  One frame: ``EOFError`` past it.

Writing (:func:`encode_sgi`): ``Image.fromarray``'s modes ``L``, ``RGB``
and ``RGBA`` at PIL's defaults: 1 byte a sample, verbatim, dimension 1
for a one-row gray image and 2 for any other (3 for colour), min 0 and
max 255, the image name (the file's base name without its extension,
its ASCII characters, at most 79 bytes, NUL-padded), the planes bottom-up;
any other mode raises PIL's ``ValueError``.

The RLE decode runs in the port's native host library
(``native/rlecodec.cpp``) when it loads, and otherwise in
:func:`rle_decode_py`, the plain version the tests hold it to.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from unmicst_tpu_torch.io import _native
from unmicst_tpu_torch.io import _pil
from unmicst_tpu_torch.io.png import array_mode

MAGIC = 474
HEADER = 512
# (bytes a sample, dimension, channels) -> the mode PIL opens
_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L",
          (1, 3, 3): "RGB", (2, 3, 3): "RGB", (1, 3, 4): "RGBA",
          (2, 3, 4): "RGBA"}
EXTENSIONS = (".sgi", ".bw", ".rgb", ".rgba")
# rle_decode_py's results: the image decoded (to its end, or to a row
# whose table length ends on a packet other than an end), or an overrun
OK, OVERRUN = 0, -1


@dataclasses.dataclass
class SgiHeader:
    """What ``SgiImageFile._open`` finds."""

    width: int
    height: int
    mode: str
    bpc: int
    storage: int


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and _pil.u16be(prefix) == MAGIC


def open_header(data: bytes) -> SgiHeader:
    """``SgiImageFile._open`` on ``data`` (which :func:`accept` takes):
    the header, or PIL's exception."""
    s = data[:HEADER]
    storage, bpc = s[2], s[3]
    dimension, xsize, ysize, zsize = struct.unpack_from(">4H", s, 4)
    mode = _MODES.get((bpc, dimension, zsize))
    if mode is None:
        raise ValueError("Unsupported SGI image mode")
    if xsize <= 0 or ysize <= 0:  # ImageFile's check after _open
        raise SyntaxError("not identified by this plugin")
    return SgiHeader(xsize, ysize, mode, bpc, storage)


def rle_decode_py(data: bytes, out: np.ndarray, bpc: int) -> int:
    """``SgiRleDecode.c`` over the file ``data`` into ``out`` (``[ysize,
    zsize, xsize * bpc]`` uint8: each row's channels in file order, rows
    bottom-up as the tables list them); rows it does not reach keep their
    contents.  ``OK`` or ``OVERRUN``."""
    ysize, zsize, _ = out.shape
    xsize = out.shape[2] // bpc
    body = len(data) - HEADER
    tablen = ysize * zsize
    if body < 8 * tablen:
        return OVERRUN
    tabs = np.frombuffer(data, ">u4", 2 * tablen, HEADER).astype(np.int64)
    starts, lengths = tabs[:tablen], tabs[tablen:]
    last = len(data) - 1  # the file's last byte, past which no read goes
    row = np.zeros((zsize, xsize * bpc), np.uint8)  # PIL's buffer persists
    for y in range(ysize):
        for z in range(zsize):
            start, n = int(starts[y + z * ysize]), int(lengths[y + z * ysize])
            if start < HEADER:
                return OVERRUN
            src, x, dst = start, 0, row[z]
            status = OK
            while n > 0:
                if src + bpc - 1 > last:
                    return OVERRUN
                pixel = data[src + bpc - 1]
                src += bpc
                if n == 1 and pixel != 0:
                    status = 1
                    break
                count = pixel & 0x7F
                if not count:
                    break
                if x + count > xsize:
                    return OVERRUN
                if pixel & 0x80:
                    if src + bpc * count > last:
                        return OVERRUN
                    dst[bpc * x : bpc * (x + count)] = np.frombuffer(
                        data, np.uint8, bpc * count, src)
                    src += bpc * count
                else:
                    if src + bpc - 1 > last:
                        return OVERRUN
                    dst[bpc * x : bpc * (x + count)] = np.tile(
                        np.frombuffer(data, np.uint8, bpc, src), count)
                    src += bpc
                x += count
                n -= 1
            if status == 1:  # a row's table length ends on a packet
                return OK
        out[y] = row
    return OK


def load(data: bytes, hdr: SgiHeader) -> np.ndarray:
    """The pixels of the image ``hdr`` describes, as ``np.asarray`` gives
    them after ``ImageFile.load`` (see the module docstring)."""
    w, h, bpc = hdr.width, hdr.height, hdr.bpc
    z = len(hdr.mode)
    if hdr.storage == 1:
        planes = np.zeros((h, z, w * bpc), np.uint8)
        rc = _native.sgi_rle_decode(data, planes, bpc)
        if rc is None:
            rc = rle_decode_py(data, planes, bpc)
        if rc != OK:
            raise OSError(_pil.OVERRUN)
        px = planes[::-1, :, ::bpc].transpose(0, 2, 1)
    elif hdr.storage == 0:
        page = w * h * bpc
        body = len(data) - HEADER
        if body < page * z:
            if bpc == 2:  # SGI16Decoder's frombytes of each plane
                raise ValueError("not enough image data")
            if z == 1 and body >= 0:  # one raw L tile: PIL maps the file
                raise ValueError(_pil.NOT_LARGE_ENOUGH)
            raise _pil.truncated(max(0, body - page * (body // page)))
        planes = np.frombuffer(data, np.uint8, page * z, HEADER).reshape(
            z, h, w * bpc)
        px = planes[:, ::-1, ::bpc].transpose(1, 2, 0)
    else:
        raise OSError("cannot load this image")
    return np.ascontiguousarray(px[..., 0] if z == 1 else px)


def read_frame(data: bytes, index: int = 0) -> np.ndarray:
    """Frame ``index`` of an SGI file's bytes, as PIL's ``Image.open``,
    ``seek`` and ``np.asarray`` give it."""
    hdr = open_header(data)
    _pil.bomb_check(hdr.width, hdr.height)
    if index != 0:
        raise EOFError("no more images in file")
    return load(data, hdr)


def encode_sgi(image: np.ndarray, path: str) -> bytes:
    """The bytes ``Image.fromarray(image).save(path)`` writes for an SGI
    name (see the module docstring); ``path`` gives the image name."""
    mode, img = array_mode(image)
    if mode not in ("L", "RGB", "RGBA"):
        raise ValueError("Unsupported SGI image mode")
    h, w = img.shape[:2]
    z = len(mode)
    dimension = (1 if h == 1 else 2) if mode == "L" else 3
    name = os.path.splitext(os.path.basename(path))[0].encode("ascii",
                                                              "ignore")
    head = (struct.pack(">hBBHHHHll4s79ss", MAGIC, 0, 1, dimension, w, h, z,
                        0, 255, b"", name, b"")
            + struct.pack(">l404s", 0, b""))
    planes = img[::-1] if z == 1 else img[::-1].transpose(2, 0, 1)
    return head + np.ascontiguousarray(planes, np.uint8).tobytes()


def write_sgi(path: str, image: np.ndarray) -> None:
    """Write :func:`encode_sgi`'s bytes to ``path``."""
    data = encode_sgi(image, path)
    with open(path, "wb") as f:
        f.write(data)
