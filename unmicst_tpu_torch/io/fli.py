"""Autodesk FLI and FLC animations read as PIL 12 reads them for the JAX
package (``PIL/FliImagePlugin.py`` and its ``FliDecode.c``): its TIFF
fallback's ``Image.open`` and ``seek(channel)`` of a file under a TIFF
name, and the toolbox's ``imread`` (frame 0).

:func:`open_header` is ``FliImageFile._open``: the 128-byte header
(``0xAF11`` FLI or ``0xAF12`` FLC, flags 0 or 3, its reserved bytes 0;
else the next plugin), then the palette walk over the first frame's
subchunks (a prefix chunk ``0xF100`` skipped) as far as the first colour
chunk (4: 8-bit, 11: 6-bit levels), whose parse can fail (``IndexError``,
``struct.error``: the next plugin), then ``seek(0)`` (no frames, or no
frame size: ``EOFError``, the next plugin).  The image is ``P``, so
``np.asarray`` gives the palette's indices and the palette itself does
not reach the caller.

:func:`read_frame` is ``seek(k)`` and ``np.asarray``: frames 0 to ``k``
decoded one after another onto the same image, which starts at 0 (frame
k is channel k, as for a GIF; ``EOFError`` past the header's frame
count, and where a frame's size is missing).  Each frame is fed to the
decoder as ``ImageFile.load`` feeds it (reads of the frame's size until
the decoder ends the frame), and the decoder runs the frame chunk
(``0xF1FA``) and its subchunks: 4 and 11 (colour, ignored), 7 (SS2, word
delta), 12 (LC, byte delta), 13 (black), 15 (BRUN), 16 (copy), 18
(postage stamp, ignored); another subchunk type or another chunk (the
prefix chunk among them) raises PIL's ``OSError``, as does data that
overruns the frame.

The chunk decoder runs in the native host library (``native/flidec.cpp``,
through :mod:`unmicst_tpu_torch.io._native`) and otherwise in
:func:`decode_py`, its plain version: both give the same bytes and the
same outcome.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from unmicst_tpu_torch.io import _native, _pil

# the decoder's outcomes besides "consumed n bytes, feed more"
END, OVERRUN, BROKEN, UNKNOWN = -1, -2, -3, -4
_MESSAGES = {OVERRUN: "buffer overrun when reading image file",
             BROKEN: "broken data stream when reading image file",
             UNKNOWN: "unrecognized data stream contents when reading image "
                      "file"}


@dataclasses.dataclass
class FliHeader:
    width: int
    height: int
    frames: int
    first_size: int  # frame 0's size word


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 16 and _pil.u16le(prefix, 4) in (0xAF11, 0xAF12) \
        and _pil.u16le(prefix, 14) in (0, 3)


def _palette(data: bytes, pos: int) -> None:
    """``FliImageFile._palette`` from ``data[pos]``, for its exceptions
    (the palette itself does not reach ``np.asarray`` of a ``P``
    image)."""
    i = 0
    count = _pil.u16le(data[pos : pos + 2])
    pos += 2
    for _ in range(count):
        s = data[pos : pos + 2]
        pos += len(s)
        i += s[0]
        n = s[1] or 256
        s = data[pos : pos + 3 * n]
        pos += len(s)
        for k in range(0, len(s), 3):
            s[k + 2]  # noqa: B018 -- IndexError on a partial entry
            if i >= 256:
                raise IndexError("list assignment index out of range")
            i += 1


def open_header(data: bytes) -> FliHeader:
    """``FliImageFile._open`` over the file ``data`` (PIL's exceptions;
    ``SyntaxError`` for a size that is not above zero)."""
    s = data[:128]
    if not (accept(s) and s[20:22] == bytes(2) and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise SyntaxError("not an FLI/FLC file")
    frames, w, h = struct.unpack_from("<3H", s, 6)
    s = data[128:144]
    pos = 128 + len(s)
    if _pil.u16le(s, 4) == 0xF100:
        pos = 128 + _pil.u32le(s)
        s = data[pos : pos + 16]
        pos += len(s)
    if _pil.u16le(s, 4) == 0xF1FA:
        chunk_size = None
        for _ in range(_pil.u16le(s, 6)):
            if chunk_size is not None:
                pos += chunk_size - 6
            s = data[pos : pos + 6]
            pos += len(s)
            kind = _pil.u16le(s, 4)
            if kind in (4, 11):
                _palette(data, pos)
                break
            chunk_size = _pil.u32le(s)
            if not chunk_size:
                break
    if frames == 0:  # seek(0) refuses every frame
        raise EOFError("attempt to seek outside sequence")
    s = data[128:132]
    if not s:
        raise EOFError("missing frame size")
    first = _pil.u32le(s)
    if w <= 0 or h <= 0:
        raise SyntaxError("not identified by this driver")
    return FliHeader(w, h, frames, first)


def _i32(buf, at: int) -> int:
    return struct.unpack_from("<i", buf, at)[0]


def decode_py(buf: bytes, img: np.ndarray) -> int:
    """``ImagingFliDecode`` over ``buf`` onto ``img`` (``[ysize, xsize]``
    uint8): the bytes consumed (>= 0: feed more), ``END`` at the frame's
    end, or an error code."""
    n = len(buf)
    if n < 4:
        return 0
    framesize = _pil.u32le(buf)  # unsigned: a size past 2**31 waits too
    if n + n % 2 < framesize:
        return 0
    if n < 8:
        return OVERRUN
    if _pil.u16le(buf, 4) != 0xF1FA:
        return UNKNOWN
    ysize, xsize = img.shape
    chunks = _pil.u16le(buf, 6)
    ptr, left = 16, n - 16
    for _ in range(chunks):
        if left < 10:
            return OVERRUN
        end = ptr + left  # ERR_IF_DATA_OOB's bound
        d = ptr + 6
        kind = _pil.u16le(buf, ptr + 4)
        if kind in (4, 11, 18):
            pass
        elif kind == 7:  # SS2
            lines = _pil.u16le(buf, d)
            d += 2
            y = l = 0
            while l < lines and y < ysize:
                row = y
                if d + 2 > end:
                    return OVERRUN
                packets = _pil.u16le(buf, d)
                d += 2
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= ysize:
                            return OVERRUN
                        row = y
                    else:
                        img[row, xsize - 1] = packets & 255
                    if d + 2 > end:
                        return OVERRUN
                    packets = _pil.u16le(buf, d)
                    d += 2
                x = p = 0
                while p < packets:
                    if d + 2 > end:
                        return OVERRUN
                    x += buf[d]
                    if buf[d + 1] >= 128:
                        if d + 4 > end:
                            return OVERRUN
                        i = 256 - buf[d + 1]
                        if x + 2 * i > xsize:
                            break
                        img[row, x : x + 2 * i] = np.tile(
                            np.frombuffer(buf, np.uint8, 2, d + 2), i)
                        x += 2 * i
                        d += 4
                    else:
                        i = 2 * buf[d + 1]
                        if x + i > xsize:
                            break
                        if d + 2 + i > end:
                            return OVERRUN
                        img[row, x : x + i] = np.frombuffer(buf, np.uint8, i,
                                                            d + 2)
                        d += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                l += 1
                y += 1
            if l < lines:
                return OVERRUN
        elif kind == 12:  # LC
            y = _pil.u16le(buf, d)
            ymax = y + _pil.u16le(buf, d + 2)
            d += 4
            while y < ymax and y < ysize:
                if d + 1 > end:
                    return OVERRUN
                packets = buf[d]
                d += 1
                x = p = 0
                while p < packets:
                    if d + 2 > end:
                        return OVERRUN
                    x += buf[d]
                    if buf[d + 1] & 0x80:
                        i = 256 - buf[d + 1]
                        if x + i > xsize:
                            break
                        if d + 3 > end:
                            return OVERRUN
                        img[y, x : x + i] = buf[d + 2]
                        d += 3
                    else:
                        i = buf[d + 1]
                        if x + i > xsize:
                            break
                        if d + 2 + i > end:
                            return OVERRUN
                        img[y, x : x + i] = np.frombuffer(buf, np.uint8, i,
                                                          d + 2)
                        d += i + 2
                    p += 1
                    x += i
                if p < packets:
                    break
                y += 1
            if y < ymax:
                return OVERRUN
        elif kind == 13:  # BLACK
            img[:] = 0
        elif kind == 15:  # BRUN
            for y in range(ysize):
                d += 1  # the packet count
                x = 0
                while x < xsize:
                    if d + 2 > end:
                        return OVERRUN
                    if buf[d] & 0x80:
                        i = 256 - buf[d]
                        if x + i > xsize:
                            break
                        if d + i + 1 > end:
                            return OVERRUN
                        img[y, x : x + i] = np.frombuffer(buf, np.uint8, i,
                                                          d + 1)
                        d += i + 1
                    else:
                        i = buf[d]
                        if x + i > xsize:
                            break
                        img[y, x : x + i] = buf[d + 1]
                        d += 2
                    x += i
                if x != xsize:
                    return OVERRUN
        elif kind == 16:  # COPY
            if (2**31 - 1) // xsize < ysize:
                return OVERRUN
            if d + xsize * ysize > end:
                return ptr
            img[:] = np.frombuffer(buf, np.uint8, xsize * ysize, d).reshape(
                ysize, xsize)
        else:
            return UNKNOWN
        advance = _i32(buf, ptr)
        if advance == 0:
            return BROKEN
        if advance < 0 or advance > left:
            return OVERRUN
        ptr += advance
        left -= advance
    return END


def _load(data: bytes, offset: int, framesize: int, img: np.ndarray) -> None:
    """``ImageFile.load`` of one frame: reads of ``framesize`` bytes from
    ``offset`` fed to the decoder until it ends the frame (PIL's
    ``OSError`` where the file ends first or the decoder fails)."""
    b = b""
    pos = offset
    while True:
        s = data[pos : pos + framesize] if pos >= 0 else b""
        pos += len(s)
        if not s:
            raise _pil.truncated(len(b))
        b += s
        got = _native.fli_decode(b, img)
        if got is None:
            got = decode_py(b, img)
        if got < 0:
            break
        b = b[got:]
    if got != END:
        raise OSError(_MESSAGES[got])


def read_frame(data: bytes, index: int = 0) -> np.ndarray:
    """Frame ``index`` of an FLI or FLC file's bytes as ``Image.open``,
    ``seek`` and ``np.asarray`` give it (see the module docstring)."""
    hdr = open_header(data)
    _pil.bomb_check(hdr.width, hdr.height)
    if index >= hdr.frames:
        raise EOFError("attempt to seek outside sequence")
    img = np.zeros((hdr.height, hdr.width), np.uint8)
    offset, size = 128, hdr.first_size
    for f in range(index + 1):
        if f:
            s = data[offset : offset + 4]
            if not s:
                raise EOFError("missing frame size")
            size = _pil.u32le(s)
        _load(data, offset, size, img)
        offset += size
    return img
