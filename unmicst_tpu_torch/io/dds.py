"""DirectDraw Surface (DDS) files read and written as PIL 12 reads and
writes them for the JAX package (``PIL/DdsImagePlugin.py``): its TIFF
fallback's ``Image.open`` of a file under a TIFF name, the toolbox's
``imread`` and its ``Image.fromarray(image).save(path)`` of a ``.dds``
name.

Reading (:func:`open_header`, :func:`read_frame`): ``DDS `` and a
124-byte header (another size, or a header cut short, is PIL's
``OSError``, which ``Image.open`` lets escape; a file too short for the
size word its ``struct.error``, on which it tries the next plugin).  The
pixel formats read here are PIL's uncompressed ones: RGB flags (RGB, or
RGBA with the alpha flag) through ``DdsRgbDecoder`` (each pixel
``bitcount // 8`` little-endian bytes, each mask's field scaled as
``int(v / max * 255)``, zeros past the end of the data); luminance
(8-bit ``L``, 16-bit ``LA`` with the alpha flag; other counts ``OSError``)
and 8-bit palette indices (``P``, after a 1024-byte palette) raw; and the
DX10 header's R8G8B8A8 formats (``RGBA``) raw; raw data that ends early
raises ``OSError``.  The block-compressed formats go through
:mod:`unmicst_tpu_torch.io.bcn` in PIL's modes: the fourcc forms DXT1,
DXT3 and DXT5 (``RGBA``), BC4U and ATI1 (``L``), BC5U, ATI2 and BC5S
(``RGB``), and the DX10 names BC1-BC3 (``RGBA``), BC4 (``L``), BC5 and
BC5S, BC6H and BC6HS (``RGB``) and BC7 (``RGBA``); data that hold fewer
blocks than the image raise PIL's ``OSError``.  Other formats (BC4S
among them, which PIL names and does not open) raise PIL's own
``NotImplementedError``.

Writing (:func:`encode_dds`): ``L``, ``LA``, ``RGB`` and ``RGBA``
uncompressed, as PIL's ``_save`` writes them without a ``pixel_format``:
the header with the pitch, the pixel format's flags and masks, then the
pixels (``L``/``LA`` as they are, RGB as BGR, RGBA as BGRA).  Any other
mode raises PIL's ``OSError``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple

import numpy as np

from unmicst_tpu_torch.io import _pil, bcn
from unmicst_tpu_torch.io.png import array_mode

MAGIC = b"DDS "
# DDSD, DDPF and DDSCAPS flags
_CAPS, _HEIGHT, _WIDTH, _PITCH, _PIXELFORMAT = 0x1, 0x2, 0x4, 0x8, 0x1000
_ALPHAPIXELS, _FOURCC, _PALETTEINDEXED8 = 0x1, 0x4, 0x20
_RGB, _LUMINANCE = 0x40, 0x20000
_TEXTURE = 0x1000
_DX10 = 0x30315844
# D3DFMT codes PIL decodes with its BCn decoder
_BCN_FOURCC = {0x31545844: "DXT1", 0x33545844: "DXT3", 0x35545844: "DXT5",
               0x55344342: "BC4", 0x31495441: "BC4", 0x53354342: "BC5S",
               0x55354342: "BC5", 0x32495441: "BC5"}
# PIL's pixel formats -> its bcn decoder, signed, and the image's mode
_BCN = {"DXT1": (1, False), "BC1": (1, False), "DXT3": (2, False),
        "BC2": (2, False), "DXT5": (3, False), "BC3": (3, False),
        "BC4": (4, False), "BC5": (5, False), "BC5S": (5, True),
        "BC6H": (6, False), "BC6HS": (6, True), "BC7": (7, False)}
# DXGI_FORMAT codes PIL decodes: BCn, and R8G8B8A8 (raw RGBA)
_BCN_DXGI = {70: "BC1", 71: "BC1", 73: "BC2", 74: "BC2", 76: "BC3",
             77: "BC3", 79: "BC4", 80: "BC4", 82: "BC5", 83: "BC5",
             84: "BC5S", 95: "BC6H", 96: "BC6HS", 97: "BC7", 98: "BC7",
             99: "BC7"}
_RGBA_DXGI = (27, 28, 29)


@dataclasses.dataclass
class DdsHeader:
    """What ``DdsImageFile._open`` finds: the mode, and how the pixels
    are stored (``rgb`` with its bit count and masks, ``raw`` from
    ``offset``, or a block-compressed ``bcn`` format)."""

    width: int
    height: int
    mode: str
    codec: str
    offset: int = 0
    bitcount: int = 0
    masks: Tuple[int, ...] = ()
    bcn: Optional[str] = None


def open_header(data: bytes) -> DdsHeader:
    """``DdsImageFile._open`` over the file ``data`` (PIL's exceptions;
    ``SyntaxError`` for a size that is not above zero)."""
    if not data.startswith(MAGIC):
        raise SyntaxError("not a DDS file")
    (size,) = struct.unpack("<I", data[4:8])
    if size != 124:
        raise OSError(f"Unsupported header size {size!r}")
    header = data[8:128]
    if len(header) != 120:
        raise OSError(f"Incomplete header: {len(header)} bytes")
    _, height, width = struct.unpack("<3I", header[:12])
    pfflags, fourcc, bitcount = struct.unpack("<3I", header[72:84])
    out = DdsHeader(width, height, "", "raw", offset=128)
    if pfflags & _RGB:
        n = 4 if pfflags & _ALPHAPIXELS else 3
        out.mode, out.codec = ("RGBA" if n == 4 else "RGB"), "rgb"
        out.bitcount = bitcount
        out.masks = struct.unpack(f"<{n}I", header[84 : 84 + 4 * n])
    elif pfflags & _LUMINANCE:
        if bitcount == 8:
            out.mode = "L"
        elif bitcount == 16 and pfflags & _ALPHAPIXELS:
            out.mode = "LA"
        else:
            raise OSError(f"Unsupported bitcount {bitcount} for {pfflags}")
    elif pfflags & _PALETTEINDEXED8:
        out.mode = "P"
        out.offset = min(128 + 1024, len(data))
    elif pfflags & _FOURCC:
        if fourcc in _BCN_FOURCC:
            out.bcn = _BCN_FOURCC[fourcc]
        elif fourcc == _DX10:
            (dxgi,) = struct.unpack("<I", data[128:132])
            out.offset = min(128 + 20, len(data))
            if dxgi in _BCN_DXGI:
                out.bcn = _BCN_DXGI[dxgi]
            elif dxgi in _RGBA_DXGI:
                out.mode = "RGBA"
            else:
                raise NotImplementedError(f"Unimplemented DXGI format {dxgi}")
        else:
            raise NotImplementedError(
                f"Unimplemented pixel format {fourcc!r}")
        if out.bcn:
            out.mode, out.codec = bcn.FORMATS[_BCN[out.bcn][0]][1], "bcn"
    else:
        raise NotImplementedError(f"Unknown pixel format flags {pfflags}")
    if width <= 0 or height <= 0:
        raise SyntaxError("not identified by this driver")
    return out


def _rgb(data: bytes, hdr: DdsHeader) -> np.ndarray:
    """``DdsRgbDecoder``: each mask's field of each pixel, scaled."""
    n = hdr.width * hdr.height
    nbytes = hdr.bitcount // 8
    buf = np.frombuffer(data, np.uint8)
    value = np.zeros(n, np.uint64)
    # the masks are 32-bit: a pixel's bytes past its fourth do not count
    start = hdr.offset + nbytes * np.arange(n, dtype=np.int64)
    for k in range(min(nbytes, 4)):
        at = start + k
        inside = at < len(buf)
        byte = np.zeros(n, np.uint64)
        byte[inside] = buf[at[inside]]
        value |= byte << np.uint64(8 * k)
    out = np.zeros((n, len(hdr.masks)), np.uint8)
    for i, mask in enumerate(hdr.masks):
        shift = 0
        if mask:
            while mask >> (shift + 1) << (shift + 1) == mask:
                shift += 1
        total = mask >> shift
        if total:
            field = (value & np.uint64(mask)) >> np.uint64(shift)
            out[:, i] = ((field.astype(np.float64) / total) * 255).astype(
                np.int64)
    return out.reshape(hdr.height, hdr.width, len(hdr.masks))


def read_frame(data: bytes, index: int = 0) -> np.ndarray:
    """Frame ``index`` of a DDS file's bytes as ``Image.open``, ``seek``
    and ``np.asarray`` give it (see the module docstring)."""
    hdr = open_header(data)
    _pil.bomb_check(hdr.width, hdr.height)
    if index != 0:
        raise EOFError("attempt to seek outside sequence")
    if hdr.codec == "bcn":
        n, signed = _BCN[hdr.bcn]
        return bcn.decode(data, hdr.offset, n, hdr.width, hdr.height, signed)
    if hdr.codec == "rgb":
        return _rgb(data, hdr)
    bands = {"L": 1, "P": 1, "LA": 2, "RGBA": 4}[hdr.mode]
    _pil.setimage_check(hdr.width, 8 * bands)
    row = hdr.width * bands
    body = data[hdr.offset : hdr.offset + row * hdr.height]
    if len(body) < row * hdr.height:
        raise _pil.truncated(len(body) % row)
    px = np.frombuffer(body, np.uint8).reshape(hdr.height, hdr.width, bands)
    return np.ascontiguousarray(px[..., 0] if bands == 1 else px)


def encode_dds(image: np.ndarray) -> bytes:
    """The bytes ``Image.fromarray(image).save(path)`` writes for a DDS
    name (see the module docstring)."""
    mode, img = array_mode(image)
    if mode not in ("RGB", "RGBA", "L", "LA"):
        raise OSError(f"cannot write mode {mode} as DDS")
    h, w = img.shape[:2]
    bands = len(mode)
    bitcount = 8 * bands
    alpha = mode[-1] == "A"
    if mode[0] == "L":
        flags = _LUMINANCE
        masks = [0xFF] * 3 if alpha else [0xFF000000] * 3
        px = img
    else:
        flags = _RGB
        masks = [0xFF0000, 0xFF00, 0xFF]
        px = img[..., [2, 1, 0, 3][:bands]]
    if alpha:
        flags |= _ALPHAPIXELS
    masks.append(0xFF000000 if alpha else 0)
    head = (MAGIC + struct.pack("<7I", 124, _CAPS | _HEIGHT | _WIDTH
                                | _PIXELFORMAT | _PITCH, h, w,
                                (w * bitcount + 7) // 8, 0, 0)
            + bytes(44) + struct.pack("<4I", 32, flags, 0, bitcount)
            + struct.pack("<4I", *masks)
            + struct.pack("<5I", _TEXTURE, 0, 0, 0, 0))
    if 0 in img.shape:
        raise SystemError("tile cannot extend outside image")
    return head + np.ascontiguousarray(px).tobytes()


def write_dds(path: str, image: np.ndarray) -> None:
    """Write ``image`` as ``Image.fromarray(image).save(path)`` writes an
    uncompressed DDS file (:func:`encode_dds`)."""
    data = encode_dds(image)
    with open(path, "wb") as f:
        f.write(data)
