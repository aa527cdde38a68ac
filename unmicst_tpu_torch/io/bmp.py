"""Windows BMP files in numpy and the standard library, as PIL 12's
``BmpImagePlugin`` reads and writes them (the JAX toolbox's ``imread`` /
``imwrite`` reach BMP through PIL).

:func:`read_bmp` returns PIL's ``np.asarray(Image.open(path))``:

* the OS/2 core header (12 bytes, 3-byte palette entries) and the
  Windows headers of 40, 52, 56, 64, 108 and 124 bytes; a height whose
  top byte is 0xFF is a top-down image, any other a bottom-up one;
* 1-, 4- and 8-bit palette images, raw or RLE4/RLE8 (PIL's decoder,
  quirks included: a delta reads four bytes, an absolute run of RLE4
  takes ``n // 2`` bytes, runs are word-aligned on the file's offset);
  mode ``1`` (bool) where a 2-colour palette is black then white, ``L``
  where the palette is the identity gray ramp ``(i, i, i)``, otherwise
  ``P`` (the indices);
* 16-bit (5-5-5, or 5-6-5 by BITFIELDS; each field scaled as
  ``v * 255 // max``), 24-bit and 32-bit (the fourth byte dropped) as
  RGB; 32-bit BITFIELDS layouts with an alpha mask as RGBA.

:func:`read_frame` reads a DIB file (``DibImageFile``: the info header
first, the pixels where PIL's reads of the header, the masks and the
palette leave the file) the same way.

Other depths, compressions (JPEG, PNG) and BITFIELDS layouts raise
``OSError`` with PIL's message, as does raw data that ends early; RLE
data that ends early, and RLE under a black/white palette or at a
depth above 8 bits, ``ValueError``.  An 8-bit "L" or "P" image PIL maps
from the file where it holds every row's stride: a 4-bit image with the
identity gray palette, which PIL reads as 8-bit "L" at the 4-bit stride,
then reads each row's ``w`` bytes on into the next row (and refuses it,
as a codec configuration error, where the file is shorter).

:func:`write_bmp` writes ``Image.fromarray(image).save(path)``'s bytes:
bool as a 1-bit black/white image, uint8 planes as 8-bit with the gray
ramp, RGB as 24-bit and RGBA as 32-bit BGRA (which PIL reads back as
RGB), bottom-up, rows padded to 4 bytes, 96 dpi; :func:`write_dib` the
same bytes without the 14-byte file header.  Every other mode raises
PIL's ``OSError`` (``cannot write mode I;16 as BMP``), and a dtype PIL
has no mode for its ``TypeError`` (:func:`png.array_mode`).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from unmicst_tpu_torch.io import _pil
from unmicst_tpu_torch.io.png import array_mode

_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
# 32-bit BITFIELDS masks (R, G, B, A) -> the bytes' order in a pixel
_MASKS_32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX",
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
    (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR",
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA",
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR",
    (0x0, 0x0, 0x0, 0x0): "BGRA",
}
# 16-bit layouts: (shift, bits) of R, G and B
_BGR15 = ((10, 5), (5, 5), (0, 5))
_BGR16 = ((11, 5), (5, 6), (0, 5))
_SAVE = {"1": 1, "L": 8, "RGB": 24, "RGBA": 32}
_PPM = int(96 * 39.3701 + 0.5)  # PIL's default 96 dpi in pixels per metre


def _u16(b: bytes, pos: int) -> int:
    return struct.unpack_from("<H", b, pos)[0]


def _u32(b: bytes, pos: int) -> int:
    return struct.unpack_from("<I", b, pos)[0]


def _rle(blob: bytes, pos: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """PIL's ``BmpRleDecoder`` from file offset ``pos``: one byte a
    pixel, rows in file order."""
    data = bytearray()
    x, need, end = 0, w * h, len(blob)
    while len(data) < need:
        if pos + 2 > end:
            break
        count, byte = blob[pos], blob[pos + 1]
        pos += 2
        if count:  # an encoded run, cut at the row's end
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                pair = bytes((byte >> 4, byte & 15))
                data += (pair * ((count + 1) // 2))[:count]
            else:
                data += bytes((byte,)) * count
            x += count
        elif byte == 0:  # end of line
            data += bytes((-len(data)) % w)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: PIL reads two bytes, then two more
            if pos + 2 > end:
                break
            right, up = blob[pos + 2 : pos + 4]
            pos += 4
            data += bytes(right + up * w)
            x = len(data) % w
        else:  # an absolute run
            n = byte // 2 if rle4 else byte
            run = blob[pos : pos + n]
            pos += len(run)
            if rle4:
                data += bytes(v for b in run for v in (b >> 4, b & 15))
            else:
                data += run
            if len(run) < n:
                break
            x += byte
            pos += pos % 2
    if len(data) < need:
        raise ValueError("not enough image data")
    return np.frombuffer(bytes(data[:need]), np.uint8).reshape(h, w)


def _unpack_bits(rows: np.ndarray, w: int, bits: int) -> np.ndarray:
    flat = np.unpackbits(rows, axis=1)[:, : w * bits]
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (flat.reshape(len(rows), w, bits) * weights).sum(2, dtype=np.uint8)


DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_BMP_BITS = (1, 4, 8, 16, 24, 32)
_BMP_MASKS = {
    32: [(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
         (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
         (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)],
    24: [(0xFF0000, 0xFF00, 0xFF)],
    16: [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)],
}


def open_bitmap(data: bytes, at: int) -> Tuple[int, int]:
    """``BmpImageFile._bitmap`` of the info header at ``data[at]``: the
    size PIL opens, or its exception."""
    hs = _pil.u32le(data[at : at + 4])
    body = data[at + 4 : at + hs] if hs > 4 else b""
    if len(body) < hs - 4:
        raise OSError("Truncated File Read")
    masks = None
    if hs == 12:
        w, h, _, bits = struct.unpack_from("<4H", body)
        compression = colors = 0
    elif hs in DIB_HEADERS[1:]:
        w = _pil.u32le(body, 0)
        h = _pil.u32le(body, 4)
        if body[7] == 0xFF:
            h = 2**32 - h
        bits, compression = _pil.u16le(body, 10), _pil.u32le(body, 12)
        colors = _pil.u32le(body, 28)
        if compression == 3:
            if len(body) >= 48:
                masks = struct.unpack_from(
                    "<4I" if len(body) >= 52 else "<3I", body, 36)
            else:
                masks = tuple(_pil.u32le(data[k : k + 4])
                              for k in range(at + hs, at + hs + 12, 4))
            masks = tuple(masks) + (0,) * (4 - len(masks))
    else:
        raise OSError(f"Unsupported BMP header type ({hs})")
    colors = colors or (1 << bits)
    if bits not in _BMP_BITS:
        raise OSError(f"Unsupported BMP pixel depth ({bits})")
    if compression == 3:
        if not (bits == 32 and masks in _BMP_MASKS[32]) and not (
                bits in (24, 16) and masks[:3] in _BMP_MASKS[bits]):
            raise OSError("Unsupported BMP bitfields layout")
    elif compression not in (0, 1, 2):
        raise OSError(f"Unsupported BMP compression ({compression})")
    if bits <= 8 and not 0 < colors <= 65536:
        raise OSError(f"Unsupported BMP Palette size ({colors})")
    return w, h


def read_bmp(path: str) -> np.ndarray:
    """Read a BMP file as PIL does (see the module docstring)."""
    with open(path, "rb") as f:
        return decode_bmp(f.read(), path)


def dib_start(data: bytes) -> int:
    """Where ``DibImageFile`` finds a DIB's pixels: after its header, the
    three BITFIELDS masks of a 40-byte header, and (1 to 8 bits) the
    palette, as far as the file holds them."""
    size = _u32(data, 0)
    at = size
    compression = _u32(data, 16) if size >= 20 else _RAW
    if size == 40 and compression == _BITFIELDS:
        at += 12
    bits = _u16(data, 10 if size == 12 else 14)
    if bits <= 8:
        colors = (_u32(data, 32) if size > 12 else 0) or (1 << bits)
        at += (3 if size == 12 else 4) * colors
    return min(at, len(data))


def read_frame(data: bytes, index: int = 0) -> np.ndarray:
    """Frame ``index`` of a DIB file's bytes (a BMP without its 14-byte
    file header, ``DibImageFile``): ``EOFError`` past frame 0, else the
    pixels as :func:`read_bmp` reads them from where PIL reads them."""
    if index != 0:
        raise EOFError("attempt to seek outside sequence")
    head = b"BM" + struct.pack("<IHHI", 0, 0, 0, 14 + dib_start(data))
    return decode_bmp(head + data, "DIB")


def decode_bmp(blob: bytes, path: str, mapped: bool = True,
               info: Optional[dict] = None) -> np.ndarray:
    """The pixels of the BMP file ``blob`` (``path`` names it in
    errors).  ``mapped`` False: PIL reads the file through its decoder,
    never by a map (a DIB inside another file); ``info``, where given,
    takes PIL's ``mode`` and, for a palette image, its ``palette`` bytes
    (``entry`` bytes an entry, BGR first)."""
    if blob[:2] != b"BM" or len(blob) < 18:
        raise ValueError(f"{path}: not a BMP file")
    offset, size = _u32(blob, 10), _u32(blob, 14)
    hdr = blob[18 : 14 + size]
    if size not in _HEADERS:
        raise OSError(f"Unsupported BMP header type ({size})")
    if len(hdr) < size - 4:
        raise ValueError(f"{path}: truncated BMP header")
    masks = None
    if size == 12:
        w, h, bits = _u16(hdr, 0), _u16(hdr, 2), _u16(hdr, 6)
        compression, colors, entry, down = _RAW, 0, 3, False
        after = 26
    else:
        down = hdr[7] == 0xFF
        w, h = _u32(hdr, 0), _u32(hdr, 4)
        h = 2**32 - h if down else h
        bits, compression = _u16(hdr, 10), _u32(hdr, 12)
        colors, entry, after = _u32(hdr, 28), 4, 14 + size
        if compression == _BITFIELDS:
            if len(hdr) >= 48:
                masks = struct.unpack_from("<4I" if len(hdr) >= 52 else "<3I",
                                           hdr, 36)
            else:  # a 40-byte header: three masks after it
                masks = struct.unpack_from("<3I", blob, after)
                after += 12
            masks = tuple(masks) + (0,) * (4 - len(masks))
    colors = colors or (1 << bits)
    if offset == 14 + size and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise OSError(f"Unsupported BMP pixel depth ({bits})")
    layout = {16: "BGR;15", 24: "BGR", 32: "BGRX"}.get(bits)
    if compression == _BITFIELDS:
        if bits == 32 and masks in _MASKS_32:
            layout = _MASKS_32[masks]
        elif bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF):
            layout = "BGR"
        elif bits == 16 and masks[:3] == (0xF800, 0x7E0, 0x1F):
            layout = "BGR;16"
        elif bits == 16 and masks[:3] == (0x7C00, 0x3E0, 0x1F):
            layout = "BGR;15"
        else:
            raise OSError("Unsupported BMP bitfields layout")
    elif compression not in (_RAW, _RLE8, _RLE4):
        raise OSError(f"Unsupported BMP compression ({compression})")
    if not (0 < w and 0 < h) or w * h > 1 << 31:
        raise ValueError(f"{path}: implausible BMP size {w}x{h}")
    mode = "RGB"
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise OSError(f"Unsupported BMP Palette size ({colors})")
        palette = blob[after : after + entry * colors]
        ramp = (0, 255) if colors == 2 else range(colors)
        gray = all(palette[k * entry : k * entry + 3] == bytes((v,)) * 3
                   for k, v in enumerate(ramp))
        mode = ("1" if colors == 2 else "L") if gray else "P"
        if info is not None:
            info.update(palette=palette, entry=entry)
        if mode == "P" and len(palette) // entry > 256:  # at load, first
            raise ValueError("invalid palette size")
    if info is not None:
        info["mode"] = mode
    if compression in (_RLE8, _RLE4):
        px = _rle(blob, offset, w, h, compression == _RLE4)
        if mode not in ("L", "P"):  # PIL sets a "P" raw mode into a mode-1
            # image, or into the RGB image of a depth above 8 bits
            raise ValueError("unknown raw mode for given image mode")
        return px if down else px[::-1]
    stride = ((w * bits + 31) >> 3) & ~3
    # PIL reads a gray palette image's rows in its mode's raw layout, at
    # the stride of the stored depth
    bits_read = {"1": 1, "L": 8}.get(mode, bits)
    row_bytes = (w * bits_read + 7) // 8
    if mapped and mode in ("L", "P") and bits_read == 8 and (
            offset + h * stride <= len(blob)):
        # PIL maps the file: each row is the w bytes from its start, past
        # its stride where that is shorter (a 4-bit "L" image), and past
        # the end of the file as zeros
        body = np.frombuffer(blob + bytes(w), np.uint8)[offset:]
    else:
        _pil.setimage_check(w, bits_read)
        if row_bytes > stride:
            raise OSError("codec configuration error when reading image "
                          "file")
        if offset + stride * (h - 1) + row_bytes > len(blob):
            raise OSError("image file is truncated")
        body = np.frombuffer(blob, np.uint8)[offset:]
    rows = np.lib.stride_tricks.as_strided(body, (h, row_bytes), (stride, 1))
    rows = rows if down else rows[::-1]
    if bits_read < 8:
        px = _unpack_bits(np.ascontiguousarray(rows), w, bits_read)
        return px.astype(bool) if mode == "1" else px
    if bits_read == 8:
        return np.ascontiguousarray(rows[:, :w])
    if layout.startswith("BGR;"):
        v = np.ascontiguousarray(rows[:, : 2 * w]).view("<u2").astype(
            np.int64)
        out = np.empty((h, w, 3), np.uint8)
        for c, (shift, n) in enumerate(_BGR16 if layout == "BGR;16"
                                       else _BGR15):
            top = (1 << n) - 1
            out[..., c] = ((v >> shift) & top) * 255 // top
        return out
    nb = len(layout)
    px = np.ascontiguousarray(rows[:, : nb * w]).reshape(h, w, nb)
    order = [layout.index(c) for c in ("RGBA" if "A" in layout else "RGB")]
    return px[:, :, order]


def encode_bmp(image: np.ndarray, file_header: bool = True) -> bytes:
    """The bytes ``Image.fromarray(image).save(path)`` writes for a BMP
    name, or without the 14-byte file header for a DIB name (see the
    module docstring)."""
    mode, img = array_mode(image)
    if mode not in _SAVE:
        raise OSError(f"cannot write mode {mode} as BMP")
    h, w = img.shape[:2]
    if not (h and w):
        raise SystemError("tile cannot extend outside image")
    bits = _SAVE[mode]
    stride = ((w * bits + 7) // 8 + 3) & ~3
    if mode == "1":
        palette, colors = b"\0\0\0\0\xff\xff\xff\0", 2
        rows = np.packbits(img, axis=1)
    elif mode == "L":
        palette = bytes(b for i in range(256) for b in (i, i, i, 0))
        colors = 256
        rows = img
    else:
        palette, colors = b"", 0
        rows = img[:, :, [2, 1, 0, 3][: img.shape[2]]].reshape(h, -1)
    body = np.zeros((h, stride), np.uint8)
    body[:, : rows.shape[1]] = rows[::-1]
    image_size = stride * h
    offset = 14 + 40 + 4 * colors
    head = b"BM" + struct.pack("<III", offset + image_size, 0, offset) \
        if file_header else b""
    return head + struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, 0,
                              image_size, _PPM, _PPM, colors,
                              colors) + palette + body.tobytes()


def write_bmp(path: str, image: np.ndarray) -> None:
    """Write ``image`` as ``Image.fromarray(image).save(path)`` writes a
    BMP (see the module docstring)."""
    data = encode_bmp(image)
    with open(path, "wb") as f:
        f.write(data)


def write_dib(path: str, image: np.ndarray) -> None:
    """Write ``image`` as ``Image.fromarray(image).save(path)`` writes a
    DIB: the BMP's bytes without the file header."""
    data = encode_bmp(image, file_header=False)
    with open(path, "wb") as f:
        f.write(data)
