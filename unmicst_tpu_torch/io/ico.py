"""Windows icons (ICO) and cursors (CUR) read as PIL 12 reads them for the
JAX package (``PIL/IcoImagePlugin.py``, ``PIL/CurImagePlugin.py``): its
TIFF fallback's ``Image.open`` of a file under a TIFF name, and the
toolbox's ``imread``.

ICO (:func:`load`, ``IcoFile`` and ``IcoImageFile``): the directory's
16-byte entries, sorted by colour depth (the entry's bit count, or
``ceil(log2(colours))``, or 256) and then, stably, by area, largest
first; PIL loads the first while it opens the file, so an entry it
cannot load decides whether the file opens at all.  A PNG entry is the
PNG as :mod:`unmicst_tpu_torch.io.png` reads it, in its own mode and at
its own size (PIL warns where the directory gives another).  Any other
entry is a DIB (:mod:`unmicst_tpu_torch.io.bmp`, read through PIL's
decoder, never mapped) of half its stated height, converted to RGBA with
an alpha taken by the directory's bit count: for 32 bits, the fourth
byte of each pixel from the DIB's data; otherwise the AND mask, 1 bit a
pixel in rows padded to 32 bits, that ends where the directory's size
ends (a clear bit opaque).  Both are read bottom-up, and data too short
for them raise PIL's ``ValueError``.

CUR (:func:`cur_open_header`, :func:`cur_read_frame`, ``CurImageFile``):
the largest cursor of the directory by PIL's comparison, its DIB read at
half its height, without a mask.

Writing (:func:`write_ico`, ``IcoImagePlugin._save`` as the toolbox's
``Image.fromarray(image).save(path)`` reaches it: PNG entries, PIL's
default sizes, no other images): one entry for each square side of
16, 24, 32, 48, 64, 128 and 256 that fits the image's width and height,
the image itself where it is that square, else its thumbnail
(:func:`unmicst_tpu_torch.io.resample.thumbnail`, LANCZOS: the aspect
kept, so a side shrinks below the square's); the 16-byte directory (0
for a side of 256, no colours, 0 planes, 32 bits), then each entry's PNG
(:func:`unmicst_tpu_torch.io.png.encode_pixels`: PIL's pixels, the
port's deflate).  An image under 16 pixels a side has no entry.  A mode
PNG cannot hold (``F``) raises PIL's ``OSError`` at the first entry,
after the bytes PIL writes before it, and the file goes where
``Image.save`` removes it.
"""

from __future__ import annotations

import dataclasses
import math
import struct
import warnings
from typing import List, Optional, Tuple

import numpy as np

from unmicst_tpu_torch.io import _pil, bmp, resample

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# IcoImagePlugin._save's default sizes (squares), sorted
SAVE_SIDES = (16, 24, 32, 48, 64, 128, 256)


@dataclasses.dataclass
class IconEntry:
    width: int
    height: int
    bpp: int
    size: int
    offset: int
    depth: int  # the colour depth PIL sorts by


def entries(data: bytes) -> List[IconEntry]:
    """``IcoFile.__init__``: the directory in PIL's order (its
    exceptions where it is cut short)."""
    if not data.startswith(b"\0\0\1\0"):
        raise SyntaxError("not an ICO file")
    out, pos = [], 6
    for _ in range(_pil.u16le(data, 4)):
        s = data[pos : pos + 16]
        pos += len(s)
        w, h, colours = s[0] or 256, s[1] or 256, s[2]
        _, bpp, size, offset = struct.unpack_from("<HHII", s, 4)
        depth = bpp or (colours != 0 and math.ceil(math.log(colours, 2))) \
            or 256
        out.append(IconEntry(w, h, bpp, size, offset, depth))
    out.sort(key=lambda e: e.depth)
    out.sort(key=lambda e: e.width * e.height, reverse=True)
    return out


def _half_height(dib: bytes, h2: int) -> bytes:
    """The DIB with its height field set to ``h2`` (kept top-down where it
    was)."""
    dib = bytearray(dib)
    if _pil.u32le(dib) == 12:
        struct.pack_into("<H", dib, 6, h2)
    elif dib[11] == 0xFF:
        struct.pack_into("<I", dib, 8, 2**32 - h2)
    else:
        struct.pack_into("<I", dib, 8, h2)
    return bytes(dib)


def read_dib(data: bytes, at: int, h2: int, info: dict) -> np.ndarray:
    """The DIB whose header starts at ``data[at]``, ``h2`` rows of it, as
    PIL's decoder reads it (``info`` takes its mode and palette)."""
    dib = _half_height(data[at:], h2)
    head = b"BM" + struct.pack("<IHHI", 0, 0, 0, 14 + bmp.dib_start(dib))
    return bmp.decode_bmp(head + dib, "ICO", mapped=False, info=info)


def _rgba(px: np.ndarray, info: dict) -> np.ndarray:
    """``convert("RGBA")`` of a DIB read in PIL's ``info["mode"]``."""
    mode = info["mode"]
    h, w = px.shape[:2]
    out = np.full((h, w, 4), 255, np.uint8)
    if mode in ("1", "L"):
        out[..., :3] = (px.astype(np.uint8) * 255 if mode == "1"
                        else px)[..., None]
    elif mode == "P":
        pal = info["palette"]
        e = info["entry"]
        table = np.zeros((256, 3), np.uint8)
        n = min(len(pal) // e, 256)
        if n:
            table[:n] = np.frombuffer(pal, np.uint8, n * e).reshape(
                n, e)[:, 2::-1]
        out[..., :3] = table[px]
    else:
        out[..., : px.shape[2]] = px
    return out


def _frame(data: bytes, e: IconEntry) -> np.ndarray:
    """``IcoFile.frame`` and its load: the entry's image as ``np.asarray``
    gives it."""
    if e.offset > len(data) or data[e.offset : e.offset + 8] != PNG_MAGIC:
        w, h = bmp.open_bitmap(data, e.offset)
        if w <= 0 or h <= 0:
            raise SyntaxError("not identified by this driver")
        _pil.bomb_check(w, h)
        h2 = int(h / 2)
        o = e.offset + bmp.dib_start(data[e.offset :])
        if e.bpp == 32:
            alpha = data[o : o + 4 * w * h2][3::4]
            if len(alpha) < w * h2:
                raise ValueError("buffer is not large enough")
            mask = np.frombuffer(alpha, np.uint8, w * h2).reshape(h2, w)
        else:
            wp = w + (-w % 32)
            total = int(wp * h2 / 8)
            at = e.offset + e.size - total
            if at < 0:
                raise OSError(22, "Invalid argument")
            rows = data[at : at + total]
            stride, need = wp // 8, (w + 7) // 8
            if h2 and len(rows) < (h2 - 1) * stride + need:
                raise ValueError("not enough image data")
            bits = np.unpackbits(np.frombuffer(
                rows + bytes(stride - need), np.uint8)[: h2 * stride]
                .reshape(h2, stride), axis=1)[:, :w]
            mask = np.where(bits == 1, 0, 255).astype(np.uint8)
        mask = mask[::-1]
        info: dict = {}
        out = _rgba(read_dib(data, e.offset, h2, info), info)
        out[..., 3] = mask
        return out
    from unmicst_tpu_torch.io import png

    return png.decode_embedded(data[e.offset :], "ICO")


def load(data: bytes) -> np.ndarray:
    """``IcoImageFile._open``, which loads the largest entry: its pixels,
    or PIL's exception."""
    first = entries(data)[0]  # IndexError without an entry
    px = _frame(data, first)
    if (px.shape[1], px.shape[0]) != (first.width, first.height):
        warnings.warn("Image was not the expected size")
    if px.shape[0] <= 0 or px.shape[1] <= 0:
        raise SyntaxError("not identified by this driver")
    return px


def read_frame(data: bytes, index: int = 0,
               px: Optional[np.ndarray] = None) -> np.ndarray:
    """Frame ``index`` of an ICO file's bytes as ``Image.open``, ``seek``
    and ``np.asarray`` give it (see the module docstring); ``px``: what
    :func:`load` already gave for them."""
    if px is None:
        px = load(data)
    _pil.bomb_check(px.shape[1], px.shape[0])
    if index != 0:
        raise EOFError("attempt to seek outside sequence")
    return px


def _cursor(data: bytes) -> Tuple[int, int, int]:
    """``CurImageFile._open``: where the chosen cursor's DIB starts, and
    its width and height (half the DIB's)."""
    if not data.startswith(b"\0\0\2\0"):
        raise SyntaxError("not a CUR file")
    m = b""
    pos = 6
    for _ in range(_pil.u16le(data, 4)):
        s = data[pos : pos + 16]
        pos += len(s)
        if not m:
            m = s
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise TypeError("No cursors were found")
    at = _pil.u32le(m, 12) or pos  # at 0, PIL reads on where the loop ends
    w, h = bmp.open_bitmap(data, at)
    return at, w, h // 2


def cur_open_header(data: bytes) -> Tuple[int, int]:
    """The size ``CurImageFile._open`` gives (PIL's exceptions)."""
    _, w, h = _cursor(data)
    if w <= 0 or h <= 0:
        raise SyntaxError("not identified by this driver")
    return w, h


def cur_read_frame(data: bytes, index: int = 0) -> np.ndarray:
    """Frame ``index`` of a CUR file's bytes as ``Image.open``, ``seek``
    and ``np.asarray`` give it: the cursor's DIB as a BMP reads."""
    at, w, h = _cursor(data)
    _pil.bomb_check(w, h)
    if index != 0:
        raise EOFError("attempt to seek outside sequence")
    dib = _half_height(data[at:], h)
    return bmp.read_frame(dib, 0)


def _save(f, image: np.ndarray) -> None:
    """``IcoImagePlugin._save`` of ``Image.fromarray(image)`` onto ``f``
    (see the module docstring)."""
    from unmicst_tpu_torch.io import png

    mode, px = png.array_mode(image)
    f.write(b"\0\0\1\0")
    h, w = px.shape[:2]
    frames = [px if (w, h) == (side, side) else resample.thumbnail(
        px, mode, (side, side), resample.LANCZOS)
        for side in SAVE_SIDES if side <= w and side <= h]
    f.write(struct.pack("<H", len(frames)))
    offset = f.tell() + 16 * len(frames)
    for frame in frames:
        fh, fw = frame.shape[:2]
        f.write(bytes((fw % 256, fh % 256, 0, 0, 0, 0)) + b"\x20\0")
        data = png.encode_pixels(mode, frame)
        f.write(struct.pack("<II", len(data), offset))
        current = f.tell()
        f.seek(offset)
        f.write(data)
        offset += len(data)
        f.seek(current)


def write_ico(path: str, image: np.ndarray) -> None:
    """Write ``image`` as ``Image.fromarray(image).save(path)`` writes an
    ICO (see the module docstring)."""
    from unmicst_tpu_torch.io import png

    png.array_mode(image)  # fromarray's TypeError before the file opens
    _pil.save_file(path, lambda f: _save(f, image))
