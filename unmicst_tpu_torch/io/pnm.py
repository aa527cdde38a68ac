"""Netpbm files (PBM, PGM, PPM and PFM) read and written as PIL reads and
writes them for the JAX package: its TIFF fallback's ``Image.open`` of a
file under a TIFF name (``unmicst_tpu/io/slides.py:74-79``,
``unmicst_tpu/io/tiff.py:1286-1291``), the toolbox's ``imread`` and its
``Image.fromarray(image).save(path)`` of a ``.pbm``, ``.pgm``, ``.ppm``,
``.pnm`` or ``.pfm`` name (``PIL/PpmImagePlugin.py``).

Reading (:func:`read_frame`):

* the header as PIL's ``_open`` reads it: the magic up to 6 bytes or a
  whitespace byte, then tokens of at most 10 bytes split by whitespace,
  a ``#`` comment running to CR or LF wherever it starts (inside a token
  too), width and height through Python's ``int``, then maxval (1-65535)
  or, for ``Pf``, the scale (finite, non-zero; its sign gives the byte
  order);
* P1 and P4 give bool (1 is black: False); P2 and P5 ``L`` (uint8) up to
  maxval 255 and ``I`` (int32) above, each sample scaled to 255 or 65535
  by Python's ``round`` and clipped there, but maxval 255 and (binary)
  65535 stored as they are; P3 and P6 RGB uint8 at any maxval; ``Pf``
  float32, rows stored bottom-up; PIL's own ``P0CMYK``, ``PyP``,
  ``PyRGBA`` and ``PyCMYK`` as their modes give them;
* the plain (ASCII) kinds through ``PpmPlainDecoder``'s blocks of 1 MiB:
  comments dropped, a PBM's digits with optional whitespace (any other
  byte of the block raises), the other kinds' tokens through ``int``
  (negative, above maxval or over 10 bytes raise);
* PIL's exceptions: ``ValueError`` for the header's and the plain data's
  faults and for binary samples cut short where PIL maps the file (modes
  L, P, RGBA, CMYK: "buffer is not large enough"), ``OSError`` where it
  reads it ("image file is truncated"), :class:`UnidentifiedImageError`
  (an ``OSError``) for a magic PIL does not know (``PF``, ``P7`` among
  them) or a size not above zero.  One frame: ``EOFError`` past it.

Writing (:func:`write_pnm`): ``Image.fromarray``'s mode picks the kind,
not the extension: bool P4, uint8 P5 at 255, PIL's ``I`` and ``I;16``
(int8 as its bytes, uint16, int16, int32, uint32) P5 at 65535 (clipped to
0..65535), RGB and RGBA P6 (alpha dropped), float ``Pf`` little-endian
at scale -1.0, rows bottom-up; header ``<magic>\\n<w> <h>\\n`` and the
maxval or scale line.  ``TypeError`` where ``fromarray`` has no mode,
``OSError`` ("cannot write mode ... as PPM") for the rest (gray+alpha,
big-endian uint16), ``SystemError`` for an empty image.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from unmicst_tpu_torch.io import png

_WHITESPACE = b" \t\n\x0b\x0c\r"
# magic -> PIL's mode
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
          b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
          b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4,
          "CMYK": 4}
# the modes whose binary samples PIL maps from the file, so that a short
# file raises ValueError there (OSError where it reads them)
_MAPPED = {"L", "P", "RGBA", "CMYK"}
_SAFEBLOCK = 1 << 20  # ImageFile.SAFEBLOCK: the plain decoder's reads
# PIL refuses images above twice Image.MAX_IMAGE_PIXELS at open
_PIL_MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


class UnidentifiedImageError(OSError):
    """A file PIL's PPM plugin does not take (PIL's
    ``UnidentifiedImageError``)."""


class _Reader:
    """The header bytes as PIL's ``fp.read(1)`` walks them."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read1(self) -> bytes:
        c = self.data[self.pos : self.pos + 1]
        self.pos += len(c)
        return c

    def magic(self) -> bytes:
        out = b""
        for _ in range(6):
            c = self.read1()
            if not c or c in _WHITESPACE:
                break
            out += c
        return out

    def token(self) -> bytes:
        tok = b""
        while len(tok) <= 10:
            c = self.read1()
            if not c:
                break
            if c in _WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while self.read1() not in b"\r\n":
                    pass
                continue
            tok += c
        if not tok:
            raise ValueError("Reached EOF while reading header")
        if len(tok) > 10:
            raise ValueError(f"Token too long in file header: {tok!r}")
        return tok


def _header(data: bytes):
    """``(magic, mode, (w, h), maxval or scale, data offset)`` as PIL's
    ``PpmImageFile._open`` finds them."""
    r = _Reader(data)
    magic = r.magic()
    mode = _MODES.get(magic)
    if mode is None:
        raise UnidentifiedImageError("cannot identify image file: not a PPM "
                                     "file")
    w, h = int(r.token()), int(r.token())
    if mode == "1":
        arg = None
    elif mode == "F":
        arg = float(r.token())
        if arg == 0.0 or not math.isfinite(arg):
            raise ValueError("scale must be finite and non-zero")
    else:
        arg = int(r.token())
        if not 0 < arg < 65536:
            raise ValueError("maxval must be greater than 0 and less than "
                             "65536")
        if arg > 255 and mode == "L":
            mode = "I"
    if w <= 0 or h <= 0:
        raise UnidentifiedImageError("cannot identify image file: size "
                                     f"{w}x{h}")
    if w * h > _PIL_MAX_PIXELS:
        raise ValueError(f"Image size ({w * h} pixels) exceeds limit of "
                         f"{_PIL_MAX_PIXELS} pixels, could be decompression "
                         "bomb DOS attack.")
    return magic, mode, (w, h), arg, r.pos


def _shape(mode: str, w: int, h: int) -> Tuple[int, ...]:
    bands = _BANDS[mode]
    return (h, w) if bands == 1 else (h, w, bands)


def _scale(values: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """``min(out_max, round(value / maxval * out_max))`` in Python's float
    arithmetic, halves to even."""
    return np.minimum(out_max, np.round(values / maxval * out_max))


def _decoded(mode: str, values, w: int, h: int) -> np.ndarray:
    out = np.asarray(values).reshape(_shape(mode, w, h))
    if mode == "1":
        return out != 0
    return out.astype(np.int32 if mode == "I" else np.uint8)


def _short(mode: str, need: int, have: int):
    if mode in _MAPPED:
        return ValueError("buffer is not large enough")
    return OSError(f"image file is truncated ({have} bytes of {need})")


def _binary(data: bytes, at: int, mode: str, w: int, h: int, arg,
            magic: bytes) -> np.ndarray:
    body = memoryview(data)[at:]
    if mode == "1":  # "1;I": rows of whole bytes, 1 is black
        stride = (w + 7) // 8
        if len(body) < stride * h:
            raise _short(mode, stride * h, len(body))
        bits = np.unpackbits(np.frombuffer(body, np.uint8, stride * h)
                             .reshape(h, stride), axis=1)[:, :w]
        return bits == 0
    if mode == "F":  # rows bottom-up; a negative scale: little-endian
        if len(body) < 4 * w * h:
            raise _short(mode, 4 * w * h, len(body))
        px = np.frombuffer(body, "<f4" if arg < 0 else ">f4", w * h)
        return px.reshape(h, w)[::-1].astype(np.float32)
    bands = _BANDS[mode]
    n = w * h * bands
    if arg == 255 or (arg == 65535 and magic == b"P5"):  # the raw decoder
        wide = arg == 65535
        need = n * (2 if wide else 1)
        if len(body) < need:
            raise _short(mode, need, len(body))
        px = np.frombuffer(body, ">u2" if wide else np.uint8, n)
        return _decoded(mode, px, w, h)
    # PpmDecoder: 1- or 2-byte samples, scaled; a short file gives what it
    # holds, and then "not enough image data"
    wide = arg >= 256
    size = (2 if wide else 1) * bands
    have = len(body) // size
    if have < w * h:
        raise ValueError("not enough image data")
    px = np.frombuffer(body, ">u2" if wide else np.uint8, n).astype(
        np.float64)
    return _decoded(mode, _scale(px, arg, 65535 if mode == "I" else 255),
                    w, h)


class _PlainBlocks:
    """``PpmPlainDecoder``'s reads of the data, a block at a time, with
    its comment removal."""

    def __init__(self, data: bytes, at: int):
        self.data, self.pos, self.spans = data, at, False

    def read(self) -> bytes:
        block = self.data[self.pos : self.pos + _SAFEBLOCK]
        self.pos += len(block)
        return block

    @staticmethod
    def _comment_end(block: bytes, start: int = 0) -> int:
        a, b = block.find(b"\n", start), block.find(b"\r", start)
        return min(a, b) if a * b > 0 else max(a, b)

    def uncomment(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = self._comment_end(block)
                if end != -1:
                    block = block[end + 1 :]
                    break
                block = self.read()
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = self._comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1 :]
            else:
                block = block[:start]
                self.spans = True
                break
        return block


def _plain(data: bytes, at: int, mode: str, w: int, h: int,
           maxval) -> np.ndarray:
    blocks = _PlainBlocks(data, at)
    if mode == "1":
        total, got = w * h, bytearray()
        while len(got) != total:
            block = blocks.read()
            if not block:
                break
            tokens = b"".join(blocks.uncomment(block).split())
            for t in tokens:
                if t not in (48, 49):
                    raise ValueError(f"Invalid token for this mode: "
                                     f"{bytes([t])!r}")
            got = (got + tokens)[:total]
        if len(got) < total:
            raise ValueError("not enough image data")
        return _decoded(mode, np.frombuffer(bytes(got), np.uint8) == 48, w,
                        h)
    total = w * h * _BANDS[mode]
    out_max = 65535 if mode == "I" else 255
    values, half = [], b""
    while len(values) != total:
        block = blocks.read()
        if not block:
            if not half:
                break
            block = b" "
        block = blocks.uncomment(block)
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise ValueError(f"Token too long found in data: "
                                 f"{half[:11]!r}")
        for tok in tokens:
            if len(tok) > 10:
                raise ValueError(f"Token too long found in data: "
                                 f"{tok[:11]!r}")
            v = int(tok)
            if v < 0:
                raise ValueError(f"Channel value is negative: {v}")
            if v > maxval:
                raise ValueError(f"Channel value too large for this mode: "
                                 f"{v}")
            values.append(round(v / maxval * out_max))
            if len(values) == total:
                break
    if len(values) < total:
        raise ValueError("not enough image data")
    return _decoded(mode, values, w, h)


def read_frame(path: str, index: int = 0) -> np.ndarray:
    """Frame ``index`` of a Netpbm file, as PIL's ``Image.open``,
    ``seek`` and ``np.asarray`` give it (see the module docstring); the
    header is read before ``index`` is looked at, the samples after."""
    with open(path, "rb") as f:
        data = f.read()
    magic, mode, (w, h), arg, at = _header(data)
    if index != 0:
        raise EOFError("attempt to seek outside sequence")
    if magic in (b"P1", b"P2", b"P3"):
        return _plain(data, at, mode, w, h, arg)
    return _binary(data, at, mode, w, h, arg, magic)


def encode_pnm(image: np.ndarray) -> bytes:
    """The bytes ``Image.fromarray(image).save(path)`` writes for a
    Netpbm name (see the module docstring)."""
    mode, img = png.array_mode(image)
    h, w = img.shape[:2]
    if mode == "1":
        head, body = b"P4", np.packbits(img == 0, axis=1).tobytes()
    elif mode == "L":
        head, body = b"P5", np.ascontiguousarray(img, np.uint8).tobytes()
    elif mode in ("I", "I;16"):
        head = b"P5"
        body = np.clip(img, 0, 65535).astype(">u2").tobytes()
    elif mode in ("RGB", "RGBA"):
        head = b"P6"
        body = np.ascontiguousarray(img[..., :3], np.uint8).tobytes()
    elif mode == "F":
        head = b"Pf"
        body = np.ascontiguousarray(img[::-1], "<f4").tobytes()
    else:
        raise OSError(f"cannot write mode {mode} as PPM")
    if 0 in img.shape:
        raise SystemError("tile cannot extend outside image")
    out = head + b"\n%d %d\n" % (w, h)
    if head == b"P6" or mode == "L":
        out += b"255\n"
    elif head == b"P5":
        out += b"65535\n"
    elif head == b"Pf":
        out += b"-1.0\n"
    return out + body


def write_pnm(path: str, image: np.ndarray) -> None:
    """Write :func:`encode_pnm`'s bytes to ``path``."""
    data = encode_pnm(image)
    with open(path, "wb") as f:
        f.write(data)
