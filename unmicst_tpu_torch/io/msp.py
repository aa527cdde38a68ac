"""Windows Paint (MSP) files read and written as PIL 12 reads and writes
them for the JAX package (``PIL/MspImagePlugin.py``): its TIFF fallback's
``Image.open`` of a file under a TIFF name, the toolbox's ``imread`` and
its ``Image.fromarray(image).save(path)`` of an ``.msp`` name.

Reading (:func:`open_header`, :func:`read_frame`): a 32-byte header of 16
little-endian words starting ``DanM`` (version 1) or ``LinS`` (version
2) whose XOR is 0, the size in words 2 and 3; anything else is a
``SyntaxError`` (a header cut short PIL's ``struct.error``), on which
``Image.open`` tries its next plugin.  Version 1 holds the rows raw from
byte 32 (mode ``1``, MSB first, a set bit white: ``True``); data that
ends early raises ``OSError``.  Version 2 holds a map of each row's
length, then each row as ``MspDecoder`` reads it: a 0 byte and then a
count and a byte is a run, any other byte a count of literal bytes; an
empty row is white; the rows' bytes are joined and cut into the image's
rows whatever their lengths, and too few of them raise ``ValueError``
("not enough image data"), a run cut short or a short map ``OSError``.

Writing (:func:`encode_msp`): mode ``1`` (bool) only, as version 1, the
checksum in word 12; any other mode raises PIL's ``OSError``.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from unmicst_tpu_torch.io import _pil
from unmicst_tpu_torch.io.png import array_mode


@dataclasses.dataclass
class MspHeader:
    width: int
    height: int
    version: int


def accept(prefix: bytes) -> bool:
    return prefix.startswith((b"DanM", b"LinS"))


def open_header(data: bytes) -> MspHeader:
    """``MspImageFile._open``: ``SyntaxError`` (or ``struct.error``)
    where PIL refuses the file."""
    s = data[:32]
    if not accept(s):
        raise SyntaxError("not an MSP file")
    checksum = 0
    for i in range(0, 32, 2):
        checksum ^= _pil.u16le(s, i)
    if checksum != 0:
        raise SyntaxError("bad MSP checksum")
    w, h = _pil.u16le(s, 4), _pil.u16le(s, 6)
    if w <= 0 or h <= 0:
        raise SyntaxError("not identified by this driver")
    return MspHeader(w, h, 1 if s.startswith(b"DanM") else 2)


def _rows_v2(data: bytes, w: int, h: int) -> bytes:
    """``MspDecoder.decode``: the rows' bytes, joined."""
    blank = b"\xff" * ((w + 7) // 8)
    rowmap = data[32 : 32 + 2 * h]
    if len(rowmap) < 2 * h:
        raise OSError("Truncated MSP file in row map")
    out = bytearray()
    pos = 32 + 2 * h
    for y, rowlen in enumerate(struct.unpack(f"<{h}H", rowmap)):
        if rowlen == 0:
            out += blank
            continue
        row = data[pos : pos + rowlen]
        pos += len(row)
        if len(row) != rowlen:
            raise OSError(f"Truncated MSP file, expected {rowlen} bytes on "
                          f"row {y}")
        i = 0
        while i < rowlen:
            kind = row[i]
            i += 1
            if kind == 0:
                if i + 2 > rowlen:
                    raise OSError(f"Corrupted MSP file in row {y}")
                out += row[i + 1 : i + 2] * row[i]
                i += 2
            else:
                out += row[i : i + kind]
                i += kind
    return bytes(out)


def read_frame(data: bytes, index: int = 0) -> np.ndarray:
    """Frame ``index`` of an MSP file's bytes as ``Image.open``, ``seek``
    and ``np.asarray`` give it (see the module docstring)."""
    hdr = open_header(data)
    _pil.bomb_check(hdr.width, hdr.height)
    if index != 0:
        raise EOFError("attempt to seek outside sequence")
    w, h = hdr.width, hdr.height
    row = (w + 7) // 8
    if hdr.version == 1:
        body = data[32 : 32 + row * h]
        if len(body) < row * h:
            raise _pil.truncated(len(body) % row)
    else:
        body = _rows_v2(data, w, h)
        if len(body) < row * h:
            raise ValueError("not enough image data")
        body = body[: row * h]
    rows = np.frombuffer(body, np.uint8).reshape(h, row)
    return np.unpackbits(rows, axis=1)[:, :w].astype(bool)


def encode_msp(image: np.ndarray) -> bytes:
    """The bytes ``Image.fromarray(image).save(path)`` writes for an MSP
    name (see the module docstring)."""
    mode, img = array_mode(image)
    if mode != "1":
        raise OSError(f"cannot write mode {mode} as MSP")
    h, w = img.shape
    header = [0] * 16
    header[0], header[1] = _pil.u16le(b"Da"), _pil.u16le(b"nM")
    header[2], header[3] = w, h
    header[4:8] = [1, 1, 1, 1]
    header[8], header[9] = w, h
    checksum = 0
    for v in header:
        checksum ^= v
    header[12] = checksum
    if 0 in img.shape:
        raise SystemError("tile cannot extend outside image")
    return struct.pack("<16H", *header) + np.packbits(img, axis=1).tobytes()


def write_msp(path: str, image: np.ndarray) -> None:
    """Write ``image`` as ``Image.fromarray(image).save(path)`` writes an
    MSP file (:func:`encode_msp`)."""
    data = encode_msp(image)
    with open(path, "wb") as f:
        f.write(data)
