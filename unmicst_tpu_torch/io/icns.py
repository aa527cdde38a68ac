"""Apple icon (ICNS) files read as PIL 12 reads them for the JAX package
(``PIL/IcnsImagePlugin.py``): its TIFF fallback's ``Image.open`` of a
file under a TIFF name, and the toolbox's ``imread``.

:func:`open_header` is ``IcnsFile`` and ``IcnsImageFile._open``: the
``icns`` header's file size bounds the walk of 8-byte block headers (a
block size of 0 or less is PIL's ``SyntaxError``, a header cut short its
``struct.error``: the next plugin), and the largest (width, height,
scale) with a known block is the size PIL opens (none: ``SyntaxError``).
:func:`read_frame` is its ``load``: every block of that size is read, in
PIL's order, and the image is a PNG or JPEG 2000 entry where there is
one, else the RGB one with its mask as alpha (``RGB`` without a mask):

* ``ic07``-``ic14``, ``icp4``-``icp6``: a PNG, kept in its own mode
  (:mod:`unmicst_tpu_torch.io.png`), or a JPEG 2000 codestream or JP2
  file converted to RGBA (:mod:`unmicst_tpu_torch.io.jpeg2000`; from L,
  LA, RGB, CMYK, ``I;16`` (clipped to 255) and ``P``/``PA`` through the
  ``pclr`` palette as PIL's ``putpalette`` holds it); other data raise
  PIL's ``ValueError``;
* ``is32``, ``il32``, ``ih32`` and ``it32`` (which starts with four zero
  bytes, else ``SyntaxError``): RGB, uncompressed where the block holds
  exactly three planes, else each plane in PIL's run-length coding
  (a byte of 128 or more repeats the next ``n - 125`` times, one below
  copies ``n + 1``), a plane that over- or under-runs raising
  ``SyntaxError``;
* ``s8mk``, ``l8mk``, ``h8mk`` and ``t8mk``: the 8-bit mask.

An image whose size is none PIL allows for the file raises PIL's
``ValueError``; planes cut short, its ``ValueError``.

Writing (:func:`write_icns`, ``IcnsImagePlugin._save`` as the toolbox's
``Image.fromarray(image).save(path)`` reaches it): the image resized to
each side of 32, 64, 128, 256, 512 and 1024 at ``resize``'s default
filter (:mod:`unmicst_tpu_torch.io.resample`: BICUBIC, NEAREST for mode
``1``; the image itself where it has that size), each as a PNG
(:func:`unmicst_tpu_torch.io.png.encode_pixels`: PIL's pixels, the
port's deflate); then ``icns`` and the file's length, the ``TOC `` block
and the eight entries ``ic07`` ... ``ic14`` in ``_save``'s order, each
with its size's PNG.  A mode PNG cannot hold (``F``) raises PIL's
``OSError`` and the file goes where ``Image.save`` removes it.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

from unmicst_tpu_torch.io import _pil, resample

MAGIC = b"icns"
# IcnsImagePlugin._save's entries, in its order, and their sides
SAVE_SIZES = {b"ic07": 128, b"ic08": 256, b"ic09": 512, b"ic10": 1024,
              b"ic11": 32, b"ic12": 64, b"ic13": 256, b"ic14": 512}
# (width, height, scale) -> the blocks PIL reads for it, in order
SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",),
    (256, 256, 2): (b"ic14",), (256, 256, 1): (b"ic08",),
    (128, 128, 2): (b"ic13",), (128, 128, 1): (b"ic07", b"it32", b"t8mk"),
    (64, 64, 1): (b"icp6",), (32, 32, 2): (b"ic12",),
    (48, 48, 1): (b"ih32", b"h8mk"),
    (32, 32, 1): (b"icp5", b"il32", b"l8mk"), (16, 16, 2): (b"ic11",),
    (16, 16, 1): (b"icp4", b"is32", b"s8mk"),
}
_RGB = (b"is32", b"il32", b"ih32", b"it32")
_MASKS = (b"s8mk", b"l8mk", b"h8mk", b"t8mk")


def open_header(data: bytes) -> Tuple[Dict[bytes, Tuple[int, int]],
                                       Tuple[int, int, int]]:
    """``IcnsFile`` and ``bestsize``: ``(blocks, best)``, each block's
    ``(start, length)`` by its type (PIL's exceptions)."""
    sig, filesize = struct.unpack(">4sI", data[:8])
    if not sig.startswith(MAGIC):
        raise SyntaxError("not an icns file")
    blocks, i = {}, 8
    while i < filesize:
        sig, size = struct.unpack(">4sI", data[i : i + 8])
        if size <= 0:
            raise SyntaxError("invalid block header")
        i += 8
        size -= 8
        blocks[sig] = (i, size)
        i += size
    sizes = [s for s, codes in SIZES.items()
             if any(c in blocks for c in codes)]
    if not sizes:
        raise SyntaxError("No 32bit icon resources found")
    return blocks, max(sizes)


def _rgb(data: bytes, start: int, length: int, side: int) -> np.ndarray:
    """``read_32``: ``[side, side, 4]``, the image's memory, whose fourth
    byte is 255 where PIL unpacks the data whole and 0 where it puts each
    decoded plane into a new image."""
    n = side * side
    out = np.zeros((side, side, 4), np.uint8)
    if length == 3 * n:
        raw = data[start : start + length] if start >= 0 else b""
        if len(raw) < 3 * n:
            raise ValueError("not enough image data")
        out[..., :3] = np.frombuffer(raw, np.uint8).reshape(side, side, 3)
        out[..., 3] = 255
        return out
    pos = start
    for band in range(3):
        parts, left = [], n
        while left > 0:
            byte = data[pos : pos + 1] if pos >= 0 else b""
            if not byte:
                break
            pos += 1
            b = byte[0]
            if b & 0x80:
                count = b - 125
                rep = data[pos : pos + 1]
                pos += len(rep)
                parts.append(rep * count)
            else:
                count = b + 1
                chunk = data[pos : pos + count]
                pos += len(chunk)
                parts.append(chunk)
            left -= count
        if left != 0:
            raise SyntaxError(f"Error reading channel [{left!r} left]")
        plane = b"".join(parts)
        if len(plane) < n:
            raise ValueError("buffer is not large enough")
        out[..., band] = np.frombuffer(plane, np.uint8, n).reshape(side, side)
    return out


def _mask(data: bytes, start: int, side: int) -> np.ndarray:
    """``read_mk``: ``[side, side]``."""
    n = side * side
    raw = data[start : start + n]
    if len(raw) < n:
        raise ValueError("buffer is not large enough")
    return np.frombuffer(raw, np.uint8).reshape(side, side)


def _to_rgba(px: np.ndarray, hdr) -> np.ndarray:
    """``convert("RGBA")`` of a JPEG 2000 image as ``jpeg2000`` reads it
    (``hdr`` its header: PIL's mode and a palette): ``P`` and ``PA``
    through the palette as ``putpalette`` holds it (``PA``'s alpha its
    own), ``I;16`` clipped to 255."""
    mode = hdr.mode
    if mode == "CMYK":
        px = _pil.cmyk_to_rgb(px)
    elif mode == "I;16":
        px = np.minimum(px, 255).astype(np.uint8)
    elif mode in ("P", "PA"):
        table = hdr.palette.rgba()
        if mode == "P":
            return table[px]
        out = table[px[..., 0]]
        out[..., 3] = px[..., 1]
        return out
    h, w = px.shape[:2]
    out = np.full((h, w, 4), 255, np.uint8)
    if px.ndim == 2:
        out[..., :3] = px[..., None]
    elif px.shape[2] == 2:
        out[..., :3], out[..., 3] = px[..., :1], px[..., 1]
    else:
        out[..., : px.shape[2]] = px
    return out


def _png_or_jpeg2000(data: bytes, start: int, length: int) -> np.ndarray:
    """``read_png_or_jpeg2000``."""
    sig = data[start : start + 12]
    if sig.startswith(b"\x89PNG\r\n\x1a\n"):
        from unmicst_tpu_torch.io import png

        return png.decode_embedded(data[start:], "ICNS")
    if sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")) or \
            sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
        from unmicst_tpu_torch.io import jpeg2000

        # a block size under 8 leaves a negative length: the file's read
        # takes -1 as "to the end" and refuses less
        if length < -1:
            raise ValueError("read length must be non-negative or -1")
        stream = data[start:] if length < 0 else data[start : start + length]
        try:  # Jpeg2KImageFile(f): ImageFile.__init__'s mapping
            hdr = jpeg2000.open_header(stream)
        except _pil.PASS as e:
            raise SyntaxError(str(e)) from None
        if hdr.width <= 0 or hdr.height <= 0:
            raise SyntaxError("not identified by this driver")
        _pil.bomb_check(hdr.width, hdr.height)
        return _to_rgba(jpeg2000.load(stream, hdr), hdr)
    raise ValueError("Unsupported icon subimage format")


def read_frame(data: bytes, index: int = 0) -> np.ndarray:
    """Frame ``index`` of an ICNS file's bytes as ``Image.open``, ``seek``
    and ``np.asarray`` give it (see the module docstring)."""
    blocks, best = open_header(data)
    w, h, scale = best
    _pil.bomb_check(w * scale, h * scale)
    if index != 0:
        raise EOFError("attempt to seek outside sequence")
    side = w * scale
    channels = {}
    for code in SIZES[best]:
        if code not in blocks:
            continue
        start, length = blocks[code]
        if code in _MASKS:
            channels["A"] = _mask(data, start, side)
        elif code in _RGB:
            if code == b"it32":
                if data[start : start + 4] != bytes(4):
                    raise SyntaxError(
                        "Unknown signature, expecting 0x00000000")
                start, length = start + 4, length - 4
            channels["RGB"] = _rgb(data, start, length, side)
        else:
            channels["RGBA"] = _png_or_jpeg2000(data, start, length)
    px = channels.get("RGBA")
    if px is None:
        px = channels["RGB"]  # KeyError with a mask alone, as PIL's
        if "A" in channels:
            px = px.copy()
            px[..., 3] = channels["A"]
        else:
            px = px[..., :3]
    vh, vw = px.shape[:2]  # the size setter: a size some scale allows
    if not any(sh * ss / vh == sw * ss // vw for sw, sh, ss in SIZES
               if any(c in blocks for c in SIZES[sw, sh, ss])):
        raise ValueError("This is not one of the allowed sizes of this image")
    return _as_rgba_bytes(px, channels)


def _as_rgba_bytes(px: np.ndarray, channels: dict) -> np.ndarray:
    """``np.asarray`` of the loaded image: ``tobytes`` packs it with the
    raw mode of the mode PIL opened (``RGBA``), and the shape is the
    loaded image's.  An RGB image packs its memory's four bytes a pixel
    (the first three quarters of them make the array); other modes than
    RGB and RGBA have no such packer (``ValueError``)."""
    if px.ndim == 3 and px.shape[2] == 4:
        return px
    if px.ndim == 3 and px.shape[2] == 3:
        if "RGBA" in channels:  # a PNG's RGB: its memory's fourth byte 255
            mem = np.concatenate([px, np.full(px.shape[:2] + (1,), 255,
                                              np.uint8)], 2)
        else:
            mem = channels["RGB"]
        h, w = px.shape[:2]
        return np.ascontiguousarray(mem).reshape(-1)[: h * w * 3].reshape(
            h, w, 3)
    raise ValueError("No packer found from this mode to RGBA")


def _save(f, image: np.ndarray) -> None:
    """``IcnsImagePlugin._save`` of ``Image.fromarray(image)`` onto ``f``
    (see the module docstring)."""
    from unmicst_tpu_torch.io import png

    mode, px = png.array_mode(image)
    streams = {}
    for side in sorted(set(SAVE_SIZES.values())):
        streams[side] = png.encode_pixels(
            mode, resample.resize(px, mode, (side, side)))
    toc = 8 + 8 * len(SAVE_SIZES)
    blocks = [(code, 8 + len(streams[side]), streams[side])
              for code, side in SAVE_SIZES.items()]
    f.write(MAGIC + struct.pack(">i", 8 + toc + sum(b[1] for b in blocks)))
    f.write(b"TOC " + struct.pack(">i", toc))
    for code, size, _ in blocks:
        f.write(code + struct.pack(">i", size))
    for code, size, stream in blocks:
        f.write(code + struct.pack(">i", size) + stream)


def write_icns(path: str, image: np.ndarray) -> None:
    """Write ``image`` as ``Image.fromarray(image).save(path)`` writes an
    ICNS file (see the module docstring)."""
    from unmicst_tpu_torch.io import png

    png.array_mode(image)  # fromarray's TypeError before the file opens
    _pil.save_file(path, lambda f: _save(f, image))
