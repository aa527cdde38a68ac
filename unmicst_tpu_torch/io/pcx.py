"""PCX files, and the DCX files that hold several, read and written as PIL
12 reads and writes them for the JAX package (``PIL/PcxImagePlugin.py``,
``PIL/DcxImagePlugin.py``): its TIFF fallback's ``Image.open`` and
``seek(channel)`` of a file under a TIFF name (``unmicst_tpu/io/slides.py:
74-79``, ``unmicst_tpu/io/tiff.py:1286-1291``), the toolbox's ``imread``
and its ``Image.fromarray(image).save(path)`` of a ``.pcx`` name.

Reading (:func:`open_header`, :func:`load`, :func:`read_frame`):

* the 128-byte header as ``PcxImageFile._open`` reads it: manufacturer
  10, version 0, 2, 3 or 5, the bounding box (``xmax`` and ``ymax``
  inclusive; an empty box is a ``SyntaxError``, on which ``Image.open``
  tries the next plugin); 1 bit and 1 plane gives ``1`` (bool), 1 bit and
  2 or 4 planes ``P`` (raw modes ``P;2L`` and ``P;4L``: the index's bits
  from the planes, a stride apart), version 5 with 8 bits and 1 plane
  ``L`` or ``P`` (the same bytes either way; PIL looks for the 769-byte
  palette at the end of the file, and a file shorter than that fails to
  seek: ``OSError``), version 5 with 8 bits and 3 planes ``RGB`` (raw mode
  ``RGB;L``); any other layout is PIL's ``OSError`` ("unknown PCX mode");
* the row stride PIL trusts: ``ceil(width * bits / 8)`` a plane, made
  even where the header's own stride differs;
* the RLE as ``PcxDecode.c`` decodes it, one row of ``planes * stride``
  bytes at a time: a byte with its top two bits set is a run of its low 6
  bits' count of the next byte, any other a literal; a run past the
  row's end is cut there and leaves an overrun, reported (``OSError``)
  once the image is whole; data that ends first is "truncated"
  (``OSError``).  Where the row's bytes are not a whole number of widths
  PIL moves each 8-bit plane after the first to ``width`` bytes after
  the last (from ``k * (row // (row // width))``) before it unpacks the
  row, so a plane's padding byte can land in a pixel.

A DCX file (magic 987654321, little-endian) is a table of up to 1024
frame offsets, a zero ending it early; frame ``k`` is the PCX image at
the ``k``-th offset (its L/P palette test reads the end of the whole
file, as PIL's does); a table cut short, an empty table or a first
frame PIL does not open is a ``SyntaxError`` from ``Image.open``, a later
frame's header fault PIL's exception from ``seek``.  Past the last frame
``EOFError``.

Writing (:func:`encode_pcx`): ``Image.fromarray``'s modes ``1`` (version
2), ``L`` (version 5, then the 0x0C marker and the gray ramp palette) and
``RGB`` (version 5, 3 planes), 100 dpi, each plane's row padded to an
even stride with a zero byte after its RLE; the RLE as ``PcxEncode.c``
writes it: runs of at most 63, a single byte below 0xC0 as a literal,
each plane's row on its own.  Any other mode raises PIL's
``ValueError``.

The RLE decode and encode run in the port's native host library
(``native/rlecodec.cpp``) when it loads, and otherwise in
:func:`rle_decode_py` and :func:`rle_encode_py`, the plain versions the
tests hold them to.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List

import numpy as np

from unmicst_tpu_torch.io import _native
from unmicst_tpu_torch.io import _pil
from unmicst_tpu_torch.io.png import array_mode

DCX_MAGIC = 0x3ADE68B1
_DCX_FRAMES = 1024
# rle_decode_py's results: the image whole, whole after a run was cut at
# a row's end, or the data ending first
OK, OVERRUN, TRUNCATED = 0, -1, -2
# mode -> (version, bits, planes) of PcxImagePlugin's SAVE
_SAVE = {"1": (2, 1, 1), "L": (5, 8, 1), "RGB": (5, 8, 3)}
_GRAY_RAMP = bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))


@dataclasses.dataclass
class PcxHeader:
    """What ``PcxImageFile._open`` finds."""

    width: int
    height: int
    mode: str
    rawmode: str
    row: int  # bytes a row: planes times the stride
    offset: int  # the RLE data's first byte
    palette: bool  # whether _open sets the image's palette (modes P)


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def open_header(data: bytes, at: int = 0) -> PcxHeader:
    """``PcxImageFile._open`` on the PCX image at ``data[at]``: the
    header, or PIL's exception (``SyntaxError``, ``IndexError`` and
    ``struct.error`` make ``Image.open`` try the next plugin; ``OSError``
    does not)."""
    s = data[at : at + 68]
    if not accept(s):
        raise SyntaxError("not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<4H", s, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise SyntaxError("bad PCX image size")
    offset = at + len(s) + 60
    version, bits, planes = s[1], s[3], s[65]
    provided = _pil.u16le(s, 66)
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
    elif version == 5 and bits == 8 and planes == 1:
        if len(data) < 769:  # fp.seek(-769, SEEK_END) before the start
            raise OSError(22, "Invalid argument")
        mode = rawmode = "L"
        tail = data[-769:]
        if tail[0] == 12 and tail[1:] != _GRAY_RAMP:
            mode = rawmode = "P"
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        raise OSError("unknown PCX mode")
    w, h = x1 + 1 - x0, y1 + 1 - y0
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    return PcxHeader(w, h, mode, rawmode, planes * stride, offset,
                     mode == "P")


def rle_decode_py(data: bytes, pos: int, out: np.ndarray) -> int:
    """``PcxDecode.c`` from ``data[pos]`` into ``out`` (``[rows,
    row_bytes]`` uint8): ``OK`` once the last row is full, ``OVERRUN``
    where it is full but a run was cut at a row's end, ``TRUNCATED``
    where the data ends first."""
    rows, row = out.shape
    end = len(data)
    x = y = 0
    overrun = False
    while True:
        if pos >= end:
            return TRUNCATED
        c = data[pos]
        if c & 0xC0 == 0xC0:
            if end - pos < 2:
                return TRUNCATED
            n = c & 0x3F
            if x + n > row:
                n, overrun = row - x, True
            out[y, x : x + n] = data[pos + 1]
            x += n
            pos += 2
        else:
            out[y, x] = c
            x += 1
            pos += 1
        if x >= row:
            x, y = 0, y + 1
            if y == rows:
                return OVERRUN if overrun else OK


def unpack_rows(rows: np.ndarray, rawmode: str, w: int) -> np.ndarray:
    """PIL's handling of each decoded row (``[h, row_bytes]``): the plane
    move of ``PcxDecode.c`` where the row is not whole widths, then the
    unpacker of ``rawmode``."""
    h, row = rows.shape
    if rawmode in ("P;2L", "P;4L"):  # one bit plane a stride
        planes = int(rawmode[2])
        s = row // planes
        out = np.zeros((h, w), np.uint8)
        for p in range(planes):
            bits = np.unpackbits(rows[:, p * s : (p + 1) * s], axis=1)[:, :w]
            out |= bits << p
        return out
    if row % w and row > w:
        bands = row // w
        stride = row // bands
        rows = rows.copy()
        for i in range(1, bands):
            rows[:, i * w : (i + 1) * w] = rows[:, i * stride : i * stride + w]
    if rawmode == "1":
        return np.unpackbits(rows, axis=1)[:, :w].astype(bool)
    if rawmode in ("L", "P"):
        return np.ascontiguousarray(rows[:, :w])
    if rawmode == "RGB;L":
        return np.ascontiguousarray(rows[:, : 3 * w].reshape(h, 3, w)
                                    .transpose(0, 2, 1))


def load(data: bytes, hdr: PcxHeader) -> np.ndarray:
    """The pixels of the PCX image ``hdr`` describes, as ``np.asarray``
    gives them after ``ImageFile.load``."""
    rows = np.zeros((hdr.height, hdr.row), np.uint8)
    rc = _native.pcx_rle_decode(data, hdr.offset, rows)
    if rc is None:
        rc = rle_decode_py(data, hdr.offset, rows)
    if rc == OVERRUN:
        raise OSError(_pil.OVERRUN)
    if rc != OK:
        raise OSError(_pil.TRUNCATED)
    return unpack_rows(rows, hdr.rawmode, hdr.width)


def dcx_accept(prefix: bytes) -> bool:
    return len(prefix) >= 4 and _pil.u32le(prefix) == DCX_MAGIC


def dcx_offsets(data: bytes) -> List[int]:
    """``DcxImageFile._open``'s table (``data`` starts with the magic):
    ``struct.error`` where it is cut short, ``EOFError`` where it is
    empty (both make ``Image.open`` try the next plugin)."""
    offsets = []
    for i in range(_DCX_FRAMES):
        (offset,) = struct.unpack("<I", data[4 + 4 * i : 8 + 4 * i])
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise EOFError("attempt to seek outside sequence")
    return offsets


def read_frame(data: bytes, index: int = 0) -> np.ndarray:
    """Frame ``index`` of a PCX or DCX file's bytes, as PIL's
    ``Image.open``, ``seek`` and ``np.asarray`` give it."""
    if dcx_accept(data[:4]):
        offsets = dcx_offsets(data)
        hdr = open_header(data, offsets[0])
        _pil.bomb_check(hdr.width, hdr.height)
        if not 0 <= index < len(offsets):
            raise EOFError("attempt to seek outside sequence")
        if not index:
            return load(data, hdr)
        frame = open_header(data, offsets[index])
        px = load(data, frame)
        if hdr.palette and not frame.palette and frame.mode != "L":
            # frame 0's palette stays on the image, and PIL puts it on
            # frame k's pixels, which only L takes
            raise ValueError("unrecognized image mode")
        return px
    hdr = open_header(data)
    _pil.bomb_check(hdr.width, hdr.height)
    if index != 0:
        raise EOFError("no more images in file")
    return load(data, hdr)


def rle_encode_py(rows: np.ndarray, planes: int) -> bytes:
    """``PcxEncode.c`` over ``rows`` (``[h, planes * width_bytes]``
    uint8, each plane's bytes of a row in turn): each plane's row coded on
    its own, then a zero byte where its bytes are odd."""
    h, total = rows.shape
    per = total // planes
    pad = per % 2
    out = bytearray()
    for y in range(h):
        row = rows[y].tobytes()
        for p in range(planes):
            seg = row[p * per : (p + 1) * per]
            last, count = seg[0], 1
            for v in seg[1:]:
                if count == 63:
                    out += bytes((0xC0 | count, last))
                    count = 0
                if v == last:
                    count += 1
                    continue
                if count == 1 and last < 0xC0:
                    out.append(last)
                elif count:
                    out += bytes((0xC0 | count, last))
                last, count = v, 1
            if count == 1 and last < 0xC0:
                out.append(last)
            elif count:
                out += bytes((0xC0 | count, last))
            out += bytes(pad)
    return bytes(out)


def encode_pcx(image: np.ndarray) -> bytes:
    """The bytes ``Image.fromarray(image).save(path)`` writes for a PCX
    name (see the module docstring)."""
    mode, img = array_mode(image)
    if mode not in _SAVE:
        raise ValueError(f"Cannot save {mode} images as PCX")
    version, bits, planes = _SAVE[mode]
    h, w = img.shape[:2]
    stride = (w * bits + 7) // 8
    stride += stride % 2
    head = (struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1,
                        h - 1, 100, 100) + b"\0" * 24 + b"\xff" * 24 + b"\0"
            + struct.pack("<BHHHH", planes, stride, 1, w, h) + b"\0" * 54)
    if 0 in img.shape:
        raise SystemError("tile cannot extend outside image")
    if mode == "1":
        rows = np.packbits(img != 0, axis=1)
    elif mode == "RGB":
        rows = img.transpose(0, 2, 1).reshape(h, 3 * w)
    else:
        rows = img
    rows = np.ascontiguousarray(rows, np.uint8)
    body = _native.pcx_rle_encode(rows, planes)
    if body is None:
        body = rle_encode_py(rows, planes)
    tail = b""
    if mode == "L":
        tail = b"\x0c" + _GRAY_RAMP
    return head + body + tail


def write_pcx(path: str, image: np.ndarray) -> None:
    """Write :func:`encode_pcx`'s bytes to ``path``."""
    data = encode_pcx(image)
    with open(path, "wb") as f:
        f.write(data)
