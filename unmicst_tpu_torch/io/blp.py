"""Blizzard Mipmap (BLP1 and BLP2) textures read as PIL 12 reads them for
the JAX package (``PIL/BlpImagePlugin.py``): its TIFF fallback's
``Image.open`` of a file under a TIFF name, and the toolbox's
``imread``.

:func:`open_header` is ``BlpImageFile._open``: the magic, the
compression, the alpha flag (``RGBA`` where it is set, else ``RGB``), for
BLP2 the encoding and alpha encoding (signed bytes), the size, and for
BLP1 the encoding; the pixels follow a table of 16 mipmap offsets and 16
lengths.  :func:`read_frame` is PIL's decoders, which read the first
mipmap:

* BLP1, compression 0: a JPEG, the header stored once before the table
  of offsets glued to the mipmap's data, decoded by
  :func:`unmicst_tpu_torch.io.jpeg.decode` and converted to RGB, its
  bytes then stored as BGR (a gray JPEG replicated).  A frame of four
  components is taken as CMYK whatever its markers say, inverted as
  PIL's ``CMYK;I`` raw mode inverts it, and converted by PIL's
  ``cmyk2rgb``; gray and colour frames keep the colour space their
  markers give (JFIF or Adobe YCbCr, Adobe transform 0 or lossless
  RGB);
* BLP1, compression 1, encodings 4 and 5: a 256-entry BGRA palette, then
  one index a pixel (read from where the palette ends);
* BLP2, compression 1: the palette, then at the first offset encoding 1
  (indices), or encoding 2 with alpha encoding 0 (DXT1, transparent
  where the alpha flag is set), 1 (DXT3) or 7 (DXT5), through PIL's own
  Python decoders (5:6:5 fields shifted, not widened) in rows of blocks.

The decoded bytes are read as raw rows of the image's mode, so a DXT3 or
DXT5 texture without the alpha flag reads its four-byte pixels three
bytes at a time, and a width that is no multiple of 4 runs each block
row into the next, as PIL does.  Where PIL's plugin raises its
``BLPFormatError`` (a ``NotImplementedError``: another compression,
encoding or alpha encoding) the same class carries PIL's message; a
file cut short raises PIL's ``OSError``, too little pixel data its
``ValueError``.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from unmicst_tpu_torch.io import _pil


class BLPFormatError(NotImplementedError):
    """PIL's ``BLPFormatError``."""


@dataclasses.dataclass
class BlpHeader:
    magic: bytes
    compression: int
    encoding: int
    alpha: bool
    alpha_encoding: int
    width: int
    height: int
    offset: int  # the table of mipmap offsets and lengths

    @property
    def mode(self) -> str:
        return "RGBA" if self.alpha else "RGB"


def open_header(data: bytes) -> BlpHeader:
    """``BlpImageFile._open`` (PIL's exceptions; ``SyntaxError`` for a
    size not above zero)."""
    magic = data[:4]
    if magic not in (b"BLP1", b"BLP2"):
        raise BLPFormatError(f"Bad BLP magic {magic!r}")
    (compression,) = struct.unpack("<i", data[4:8])
    alpha_encoding = 0
    if magic == b"BLP1":
        alpha = struct.unpack("<I", data[8:12])[0] != 0
    else:
        encoding, alpha, alpha_encoding = struct.unpack("<3b", data[8:11])
        alpha = alpha != 0
    w, h = struct.unpack("<II", data[12:20])
    offset = 20
    if magic == b"BLP1":
        (encoding,) = struct.unpack("<i", data[20:24])
        offset = 28
    if w <= 0 or h <= 0:
        raise SyntaxError("not identified by this driver")
    return BlpHeader(magic, compression, encoding, alpha, alpha_encoding, w,
                     h, offset)


class _Reader:
    """The decoder's file: ``ImageFile._safe_read`` (``OSError`` where the
    file ends first)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        s = self.data[self.pos : self.pos + n] if self.pos >= 0 else b""
        self.pos += len(s)
        if len(s) < n:
            raise OSError("Truncated File Read")
        return s


def _palette(f: _Reader) -> np.ndarray:
    """``[256, 4]`` BGRA (PIL reads all 256 entries or fails)."""
    return np.frombuffer(f.read(1024), np.uint8).reshape(256, 4)


def _indexed(f: _Reader, palette: np.ndarray, length: int,
             alpha: bool) -> bytes:
    """``_read_bgra``: ``length`` indices as RGB or RGBA bytes."""
    idx = np.frombuffer(f.read(length), np.uint8)
    px = palette[idx][:, [2, 1, 0, 3] if alpha else [2, 1, 0]]
    return px.tobytes()


def _565(c: np.ndarray) -> np.ndarray:
    """PIL's ``unpack_565``: ``[..., 3]`` shifted, not widened."""
    return np.stack([((c >> 11) & 31) << 3, ((c >> 5) & 63) << 2,
                     (c & 31) << 3], -1)


def _colours(blocks: np.ndarray, three: np.ndarray) -> np.ndarray:
    """``[n, 16, 4]`` of the colour half at bytes 0-7 of ``blocks``
    (``three``: the blocks where ``c0 <= c1`` makes DXT1's three-colour
    palette)."""
    b = blocks.astype(np.int64)
    c0, c1 = b[:, 0] | b[:, 1] << 8, b[:, 2] | b[:, 3] << 8
    codes = b[:, 4] | b[:, 5] << 8 | b[:, 6] << 16 | b[:, 7] << 24
    e0, e1 = _565(c0), _565(c1)
    p = np.empty((len(b), 4, 4), np.int64)
    p[:, 0, :3], p[:, 1, :3] = e0, e1
    t = three[:, None]
    p[:, 2, :3] = np.where(t, (e0 + e1) // 2, (2 * e0 + e1) // 3)
    p[:, 3, :3] = np.where(t, 0, (2 * e1 + e0) // 3)
    p[..., 3] = 255
    p[:, 3, 3] = np.where(three, 0, 255)
    idx = (codes[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(p, idx[:, :, None], 1)


def _dxt(raw: bytes, alpha_encoding: int) -> np.ndarray:
    """``decode_dxt1`` (RGBA), ``decode_dxt3`` and ``decode_dxt5`` of
    whole blocks: ``[n, 16, 4]``."""
    size = 8 if alpha_encoding == 0 else 16
    blocks = np.frombuffer(raw, np.uint8)[: len(raw) // size * size].reshape(
        -1, size)
    if alpha_encoding == 0:
        b = blocks.astype(np.int64)
        three = (b[:, 0] | b[:, 1] << 8) <= (b[:, 2] | b[:, 3] << 8)
        return _colours(blocks, three)
    out = _colours(blocks[:, 8:], np.zeros(len(blocks), bool))
    if alpha_encoding == 1:
        nib = np.stack([blocks[:, :8] & 15, blocks[:, :8] >> 4], 2)
        out[..., 3] = nib.reshape(-1, 16).astype(np.int64) * 17
        return out
    b = blocks.astype(np.int64)
    a0, a1 = b[:, 0], b[:, 1]
    bits = sum(b[:, 2 + k] << (8 * k) for k in range(6))
    code = (bits[:, None] >> (3 * np.arange(16))) & 7
    a0, a1 = a0[:, None], a1[:, None]
    seven = ((8 - code) * a0 + (code - 1) * a1) // 7
    five = ((6 - code) * a0 + (code - 1) * a1) // 5
    five = np.where(code == 6, 0, np.where(code == 7, 255, five))
    a = np.where(a0 > a1, seven, five)
    out[..., 3] = np.where(code == 0, a0, np.where(code == 1, a1, a))
    return out


def _dxt_rows(f: _Reader, hdr: BlpHeader) -> bytes:
    """The bytes PIL's DXT decoders leave: each row of blocks as four
    rows of pixels, RGBA (DXT1 without the alpha flag: RGB)."""
    bw, bh = (hdr.width + 3) // 4, (hdr.height + 3) // 4
    line = bw * (8 if hdr.alpha_encoding == 0 else 16)
    raw = b"".join(f.read(line) for _ in range(bh))
    px = _dxt(raw, hdr.alpha_encoding).reshape(bh, bw, 4, 4, 4)
    if hdr.alpha_encoding == 0 and not hdr.alpha:
        px = px[..., :3]
    return px.transpose(0, 2, 1, 3, 4).astype(np.uint8).tobytes()


def _jpeg(f: _Reader, offsets, lengths) -> bytes:
    """``_decode_jpeg_stream``: the JPEG's RGB bytes.  Only a frame of
    four components (PIL's mode ``CMYK``) gets PIL's ``jpegmode``
    ``CMYK``, which has libjpeg take it as CMYK whatever an Adobe marker
    says; it is inverted by the ``CMYK;I`` raw mode, then converted.
    Gray and colour frames keep the colour space libjpeg reads from their
    markers."""
    from unmicst_tpu_torch.io import jpeg

    (head_size,) = struct.unpack("<I", f.read(4))
    head = f.read(head_size)
    f.read(offsets[0] - f.pos)
    stream = head + f.read(lengths[0])
    if not stream.startswith(b"\xff\xd8\xff"):
        raise SyntaxError("not a JPEG file")
    try:
        frame, _ = jpeg.parse(stream)
        _pil.bomb_check(frame.width, frame.height)
        px = jpeg.decode(stream, colour="cmyk" if len(frame.components) == 4
                         else None, feed=jpeg.PIL_FEED)
    except ValueError as e:  # the decoder's JpegError: PIL's OSError
        raise OSError(str(e)) from None
    if px.ndim == 2:
        px = np.repeat(px[:, :, None], 3, 2)
    elif px.shape[2] == 4:  # PIL's CMYK;I raw mode inverts the samples
        px = _pil.cmyk_to_rgb(255 - px)
    return px.tobytes()


def _raw(body: bytes, rawmode: str, hdr: BlpHeader) -> np.ndarray:
    """``PyDecoder.set_as_raw``: ``body`` as rows of ``rawmode`` into the
    image (``ValueError`` where it is too short)."""
    bands = len(rawmode)
    w, h = hdr.width, hdr.height
    if len(body) < w * h * bands:
        raise ValueError("not enough image data")
    px = np.frombuffer(body, np.uint8, w * h * bands).reshape(h, w, bands)
    if rawmode == "BGR":
        px = px[..., ::-1]
        if hdr.alpha:
            px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], 2)
    return np.ascontiguousarray(px)


def read_frame(data: bytes, index: int = 0) -> np.ndarray:
    """Frame ``index`` of a BLP file's bytes as ``Image.open``, ``seek``
    and ``np.asarray`` give it (see the module docstring)."""
    hdr = open_header(data)
    _pil.bomb_check(hdr.width, hdr.height)
    if index != 0:
        raise EOFError("attempt to seek outside sequence")
    f = _Reader(data, hdr.offset)
    offsets = struct.unpack("<16I", f.read(64))
    lengths = struct.unpack("<16I", f.read(64))
    if hdr.magic == b"BLP1":
        if hdr.compression == 0:
            return _raw(_jpeg(f, offsets, lengths), "BGR", hdr)
        if hdr.compression != 1:
            raise BLPFormatError(
                f"Unsupported BLP compression {hdr.encoding!r}")
        if hdr.encoding not in (4, 5):
            raise BLPFormatError(f"Unsupported BLP encoding {hdr.encoding!r}")
        palette = _palette(f)
        return _raw(_indexed(f, palette, lengths[0], hdr.alpha), hdr.mode,
                    hdr)
    palette = _palette(f)
    f.pos = offsets[0]
    if hdr.compression != 1:
        raise BLPFormatError(f"Unknown BLP compression {hdr.compression!r}")
    if hdr.encoding == 1:
        body = _indexed(f, palette, lengths[0], hdr.alpha)
    elif hdr.encoding == 2:
        if hdr.alpha_encoding not in (0, 1, 7):
            raise BLPFormatError(
                f"Unsupported alpha encoding {hdr.alpha_encoding!r}")
        body = _dxt_rows(f, hdr)
    else:
        raise BLPFormatError(f"Unknown BLP encoding {hdr.encoding!r}")
    return _raw(body, hdr.mode, hdr)
