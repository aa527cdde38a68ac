"""QOI ("Quite OK Image") files read and written as PIL 12 reads and
writes them for the JAX package (``PIL/QoiImagePlugin.py``): its TIFF
fallback's ``Image.open`` of a file under a TIFF name, the toolbox's
``imread`` and its ``Image.fromarray(image).save(path)`` of a ``.qoi``
name.

Reading (:func:`open_header`, :func:`read_frame`): ``qoif``, the
big-endian width and height, the channel count (3 is RGB, anything else
RGBA) and a colour-space byte; a header cut short or a size that is not
above zero is refused, and ``Image.open`` tries its next plugin.  The
chunks decode as ``QoiDecoder`` decodes them (a 64-entry table of seen
pixels, empty at the start; runs do not enter it); data that ends early
raises what PIL's decoder raises there (``IndexError``, or
``ValueError`` for a chunk cut short).

Writing (:func:`encode_qoi`): RGB and RGBA only (``ValueError``
"Unsupported QOI image mode" for any other mode), colour space 1, the
chunks as ``QoiEncoder`` writes them (runs of at most 62, the table's
slot 0 holding transparent black at the start), and the 8-byte end
marker.

Both loops run in the port's native host library
(``native/qoicodec.cpp``) when it loads, and otherwise in
:func:`encode_py` / :func:`decode_py`, the plain versions the tests hold
them to; a native decode that runs out of data hands the file to
:func:`decode_py` for PIL's exception.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from unmicst_tpu_torch.io import _native
from unmicst_tpu_torch.io import _pil
from unmicst_tpu_torch.io.png import array_mode

MAGIC = b"qoif"
_END = bytes((0, 0, 0, 0, 0, 0, 0, 1))


def open_header(data: bytes) -> Tuple[int, int, int]:
    """``QoiImageFile._open``: (width, height, bands), or PIL's
    ``SyntaxError`` / ``struct.error`` / ``IndexError``."""
    if not data.startswith(MAGIC):
        raise SyntaxError("not a QOI file")
    w, h = _pil.u32be(data[4:8]), _pil.u32be(data[8:12])
    bands = 3 if data[12:13][0] == 3 else 4
    if w <= 0 or h <= 0:
        raise SyntaxError("not identified by this driver")
    return w, h, bands


def _hash(p) -> int:
    return (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64


def decode_py(data: bytes, pos: int, n: int, bands: int) -> np.ndarray:
    """``QoiDecoder.decode`` from ``data[pos]``: ``n * bands`` bytes."""
    seen = {}
    prev = bytearray((0, 0, 0, 255))
    out = bytearray()
    need = n * bands

    def read(k: int) -> bytes:
        nonlocal pos
        part = data[pos : pos + k]
        pos += len(part)
        return part

    while len(out) < need:
        byte = read(1)[0]
        if byte == 0xFE:
            value = bytearray(read(3)) + prev[3:]
        elif byte == 0xFF:
            value = read(4)
        elif byte >> 6 == 0:
            value = seen.get(byte & 63, bytearray((0, 0, 0, 0)))
        elif byte >> 6 == 1:
            value = bytearray(((prev[0] + ((byte >> 4) & 3) - 2) % 256,
                               (prev[1] + ((byte >> 2) & 3) - 2) % 256,
                               (prev[2] + (byte & 3) - 2) % 256, prev[3]))
        elif byte >> 6 == 2:
            second = read(1)[0]
            dg = (byte & 63) - 32
            value = bytearray(
                (prev[i] + dg + d) % 256
                for i, d in enumerate(((second >> 4) - 8, 0,
                                       (second & 15) - 8))) + prev[3:]
        else:
            out += (prev[:3] if bands == 3 else prev) * ((byte & 63) + 1)
            continue
        r, g, b, a = value  # PIL unpacks it: a chunk cut short raises
        prev = value
        seen[_hash(value)] = value
        out += value[:3] if bands == 3 else value
    return np.frombuffer(bytes(out[:need]), np.uint8)


def read_frame(data: bytes, index: int = 0) -> np.ndarray:
    """Frame ``index`` of a QOI file's bytes as ``Image.open``, ``seek``
    and ``np.asarray`` give it (see the module docstring)."""
    w, h, bands = open_header(data)
    _pil.bomb_check(w, h)
    if index != 0:
        raise EOFError("attempt to seek outside sequence")
    px = _native.qoi_decode(data, 14, w * h, bands)
    if px is None:
        px = decode_py(data, 14, w * h, bands)
    return px.reshape(h, w, bands)


def encode_py(px: np.ndarray, bands: int) -> bytes:
    """``QoiEncoder.encode`` of ``px`` (``[n, bands]`` uint8)."""
    seen = {0: (0, 0, 0, 0)}
    prev = (0, 0, 0, 255)
    out = bytearray()
    run = 0

    def delta(a: int, b: int) -> int:
        d = (a - b) & 255
        return d - 256 if d >= 128 else d

    for p in map(tuple, px.tolist()):
        if bands == 3:
            p = p + (255,)
        if p == prev:
            run += 1
            if run == 62:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        h = _hash(p)
        if seen.get(h) == p:
            out.append(h)
        else:
            seen[h] = p
            if prev[3] == p[3]:
                dr, dg, db = (delta(p[i], prev[i]) for i in range(3))
                dgr, dgb = delta(dr, dg), delta(db, dg)
                if -2 <= dr < 2 and -2 <= dg < 2 and -2 <= db < 2:
                    out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2
                               | (db + 2))
                elif -8 <= dgr < 8 and -32 <= dg < 32 and -8 <= dgb < 8:
                    out += bytes((0x80 | (dg + 32), (dgr + 8) << 4
                                  | (dgb + 8)))
                else:
                    out += bytes((0xFE,) + p[:3])
            else:
                out += bytes((0xFF,) + p)
        prev = p
    if run:
        out.append(0xC0 | (run - 1))
    return bytes(out) + _END


def encode_qoi(image: np.ndarray) -> bytes:
    """The bytes ``Image.fromarray(image).save(path)`` writes for a QOI
    name (see the module docstring)."""
    mode, img = array_mode(image)
    if mode not in ("RGB", "RGBA"):
        raise ValueError("Unsupported QOI image mode")
    h, w, bands = img.shape
    head = MAGIC + struct.pack(">IIBB", w, h, bands, 1)
    if 0 in img.shape:  # PyEncoder.setimage
        raise ValueError("Size cannot be negative")
    px = np.ascontiguousarray(img).reshape(-1, bands)
    body = _native.qoi_encode(px)
    return head + (encode_py(px, bands) if body is None else body)


def write_qoi(path: str, image: np.ndarray) -> None:
    """Write ``image`` as ``Image.fromarray(image).save(path)`` writes a
    QOI file (:func:`encode_qoi`)."""
    data = encode_qoi(image)
    with open(path, "wb") as f:
        f.write(data)
