"""FITS images read as PIL 12 reads them for the JAX package
(``PIL/FitsImagePlugin.py``): its TIFF fallback's ``Image.open`` of a
file under a TIFF name, and the toolbox's ``imread``.

The header is 80-byte cards in 2880-byte blocks, the first ``SIMPLE =
T``; the keywords of every header unit go into one table, and the first
unit whose ``END`` card finds an image (``NAXIS`` above 0; ``NAXIS`` 1
is a 1-pixel-wide column) names it: the data start at the first card read
after that unit's blocks.  A ``BINTABLE`` extension with ``ZIMAGE = T``
and ``ZCMPTYPE = 'GZIP_1  '`` holds the image gzip-coded after its table
(``NAXIS1 * NAXIS2 * BITPIX / 8`` bytes on), its size and depth in the
``Z`` keywords.  BITPIX 8, 16, 32, -32 and -64 give modes ``L``,
``I;16``, ``I`` and ``F``.

The pixels are PIL's, not the file's: the raw decoder reads each mode in
its own layout, little-endian (``I;16`` as uint16, ``I`` as int32, ``F``
as 4-byte floats, so BITPIX -64 gives the first half of the data read
as float32), rows bottom-up; the gzip form keeps the last
``min(BITPIX / 8, 4)`` bytes of every 4 (none for negative BITPIX),
rows bottom-up, read the same way.  Data that end early raise PIL's
``OSError`` (``ValueError`` for ``L`` and ``I;16``, which PIL maps from
the file, and for the gzip form's short data); a gzip stream that does
not decode raises what ``gzip.decompress`` raises.  A header PIL refuses
raises ``SyntaxError`` (or one of the exceptions on which ``Image.open``
tries its next plugin); "No image data" and a value that is no integer
raise ``ValueError``, and a file that ends inside the header ``OSError``,
as PIL's.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import math

import numpy as np

from unmicst_tpu_torch.io import _pil

_MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}
_BITS = {"L": 8, "I;16": 16, "I": 32, "F": 32}


@dataclasses.dataclass
class FitsHeader:
    width: int
    height: int
    mode: str
    decoder: str  # "raw" or "fits_gzip"
    offset: int
    bitpix: int


def _size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _parse(headers: dict):
    """``_parse_headers``: (size, mode, decoder, offset, BITPIX) or None
    where the unit holds no image."""
    prefix, decoder, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'"
            and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        w, h = _size(headers, prefix) or (0, 0)
        offset = w * h * (int(headers[b"BITPIX"]) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _size(headers, prefix)
    if not size:
        return None
    bitpix = int(headers[prefix + b"BITPIX"])
    return size, _MODES.get(bitpix, ""), decoder, offset, bitpix


def open_header(data: bytes) -> FitsHeader:
    """``FitsImageFile._open`` (see the module docstring)."""
    fp = io.BytesIO(data)
    headers: dict = {}
    in_progress = False
    found = None
    while True:
        card = fp.read(80)
        if not card:
            raise OSError("Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            fp.seek(math.ceil(fp.tell() / 2880) * 2880)
            if not found:
                found = _parse(headers)
            in_progress = False
            continue
        if found:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE")
                            or value != b"T"):
            raise SyntaxError("Not a FITS file")
        headers[keyword] = value
    if not found:
        raise ValueError("No image data")
    (w, h), mode, decoder, offset, bitpix = found
    if not mode or w <= 0 or h <= 0:
        raise SyntaxError("not identified by this plugin")
    return FitsHeader(w, h, mode, decoder, offset + fp.tell() - 80, bitpix)


def _gzip_rows(data: bytes, hdr: FitsHeader) -> bytes:
    """``FitsGzipDecoder``: the bytes it hands the raw decoder."""
    value = gzip.decompress(data[hdr.offset :])
    nb = min(hdr.bitpix // 8, 4)
    w, h = hdr.width, hdr.height
    if nb <= 0:
        return b""
    if len(value) >= 4 * w * h:
        px = np.frombuffer(value, np.uint8, 4 * w * h).reshape(h, w, 4)
        return px[::-1, :, 4 - nb :].tobytes()
    rows = []
    offset = 0
    for _ in range(h):
        row = bytearray()
        for _ in range(w):
            row += value[offset + 4 - nb : offset + 4]
            offset += 4
        rows.append(bytes(row))
    return b"".join(rows[::-1])


def read_frame(data: bytes, index) -> np.ndarray:
    """The image of a FITS file, as ``np.asarray(Image.open(f))`` gives it
    (see the module docstring); ``EOFError`` past frame 0."""
    hdr = open_header(data)
    if index:
        raise EOFError("no more images in file")
    w, h, mode = hdr.width, hdr.height, hdr.mode
    row = w * _BITS[mode] // 8
    if hdr.decoder == "fits_gzip":
        if hdr.offset < 0:
            raise OSError(22, "Invalid argument")
        body = _gzip_rows(data, hdr)
        if len(body) < row * h:
            raise ValueError("not enough image data")
        rows = np.frombuffer(body, np.uint8, row * h).reshape(h, row)
        return _pil.unpack(rows, mode, w)
    mapped = mode if mode in _pil.MAP_MODES else ""
    if not mapped:
        _pil.setimage_check(w, _BITS[mode])
    rows = _pil.raw_rows(data, hdr.offset, row, h, ystep=-1, mapped=mapped,
                         width=w)
    return _pil.unpack(rows, mode, w)
