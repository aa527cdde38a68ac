"""Which format PIL 12's ``Image.open`` opens a file as, for the files the
port's readers do not tell apart by their first bytes: the JAX package
opens every file its TIFF reader refuses, and every file its toolbox's
``imread`` gets under another name than TIFF, with ``Image.open``, which
tries its plugins in turn (``PIL/Image.py`` ``open``).

The plugins run in the order PIL registers them in ``Image.ID`` (BMP, GIF,
JPEG, PPM and PNG first, the callers' own magic-byte tests; then DIB and
the rest of ``PIL/__init__.py``'s list as this installation imports it):
a plugin whose ``_accept`` takes the file's first 16 bytes (or that has
none) opens it with ``_open``; ``SyntaxError``, ``IndexError``,
``TypeError``, ``KeyError``, ``EOFError`` and ``struct.error`` there, or
a size that is not above zero, hand the file to the next plugin, any
other exception escapes ``Image.open``.  :func:`open_image` walks the
same order and names the format of the first plugin to open the file,
with the decompression-bomb check of ``Image.open``; :func:`read` reads
a frame of the formats the port reads (``READ``: PCX, DCX, SGI, TGA,
DIB, IM, MSP, XBM, QOI, DDS and JPEG 2000, through :mod:`pcx`,
:mod:`sgi`, :mod:`tga`, :mod:`bmp`, :mod:`im`, :mod:`msp`, :mod:`xbm`,
:mod:`qoi`, :mod:`dds` and :mod:`jpeg2000`) and refuses the others with
``NotImplementedError`` naming ROADMAP M17.  The plugins the port
reads, the plugins that take a file without a magic number (IMT, IPTC,
PCD, SPIDER) and those whose magic a TGA header can hold (CUR, ICO,
MPEG, GBR, FLI, McIDAS) run their header checks here as PIL's do (ICO's
and FLI's only so far: ``PARTLY_CHECKED``); the others (``MAGIC_ONLY``)
open any file their magic bytes start (the port does not check whether
their ``_open`` would refuse it and hand it on: none of their magic
numbers can start a file of a format the port reads, but for AVIF's,
which is checked as far as its first two boxes).

None where no plugin opens the file (PIL's ``UnidentifiedImageError``).
"""

from __future__ import annotations

import io
import math
import re
import struct
from typing import Optional, Tuple

import numpy as np

from unmicst_tpu_torch.io import _pil
from unmicst_tpu_torch.io import (bmp, dds, im, jpeg2000, msp, pcx, qoi, sgi,
                                  tga, xbm)

_DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)
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
_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")
_SPIDER_IFORMS = (1, 3, -11, -12, -21, -22)


def _bitmap(data: bytes, at: int) -> Tuple[int, int]:
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
    elif hs in _DIB_HEADERS[1:]:
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


def _opens(name: str, w, h):
    """``(name, size)`` where ``ImageFile.__init__`` keeps the image
    (its size above zero), else None (the next plugin)."""
    return (name, (w, h)) if w > 0 and h > 0 else None


def _dib(data: bytes):
    if _pil.u32le(data[:4]) not in _DIB_HEADERS:
        return None
    return _opens("DIB", *_bitmap(data, 0))


def _cur(data: bytes):
    if not data.startswith(b"\0\0\2\0"):
        return None
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
    at = _pil.u32le(m, 12)  # at 0, _bitmap reads on where the loop ends
    w, h = _bitmap(data, at or pos)
    return _opens("CUR", w, h // 2)


def _ico(data: bytes):
    if not data.startswith(b"\0\0\1\0"):
        return None
    n, pos, entries = _pil.u16le(data, 4), 6, []
    for _ in range(n):
        s = data[pos : pos + 16]
        pos += len(s)
        w, h, colors, bpp = s[0] or 256, s[1] or 256, s[2], _pil.u16le(s, 6)
        entries.append((w * h, bpp or (colors != 0 and math.ceil(
            math.log(colors, 2))) or 256, _pil.u32le(s, 12)))
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    offset = entries[0][2]  # IndexError without an entry
    if data[offset : offset + 8] != b"\x89PNG\r\n\x1a\n":
        # the frame PIL loads while it opens the file, as a DIB
        w, h = _bitmap(data, offset)
        if not (w > 0 and h > 0):
            return None
        _pil.bomb_check(w, h)
    return "ICO", None


def _mpeg(data: bytes):
    if not data.startswith(b"\x00\x00\x01\xb3"):
        return None
    w = (data[4] << 4) | (data[5] >> 4)
    h = ((data[5] & 15) << 8) | data[6]
    return _opens("MPEG", w, h)


def _gbr(data: bytes):
    if len(data) < 8 or _pil.u32be(data) < 20 or \
            _pil.u32be(data, 4) not in (1, 2):
        return None
    size, version, w, h, depth = (_pil.u32be(data[k : k + 4])
                                  for k in range(0, 20, 4))
    if w == 0 or h == 0 or depth not in (1, 4):
        return None
    if version == 2:
        if data[20:24] != b"GIMP":
            return None
        _pil.u32be(data[24:28])
    _pil.bomb_check(w, h)
    return _opens("GBR", w, h)


def _fli(data: bytes):
    if len(data) < 16 or _pil.u16le(data, 4) not in (0xAF11, 0xAF12) or \
            _pil.u16le(data, 14) not in (0, 3):
        return None
    s = data[:128]
    if s[20:22] != bytes(2) or s[42:80] != bytes(38) or s[88:] != bytes(40):
        return None
    _pil.u16le(data[128:134], 4)  # the first chunk's type
    return _opens("FLI", _pil.u16le(s, 8), _pil.u16le(s, 10))


def _mcidas(data: bytes):
    if not data.startswith(b"\0\0\0\0\0\0\0\x04") or len(data) < 256:
        return None
    w = struct.unpack("!64i", data[:256])
    if w[10] not in (1, 2, 4):
        return None
    return _opens("MCIDAS", w[9], w[8])


def _im(data: bytes):
    """``ImImageFile._open`` (:func:`im.open_header`)."""
    hdr = im.open_header(data)
    return "IM", (hdr.width, hdr.height)


def _imt(data: bytes):
    """``ImtImageFile._open``: ``key value`` lines up to a form feed,
    ``pixel n8`` and a size above zero."""
    fp = io.BytesIO(data)
    buffer = fp.read(100)
    if b"\n" not in buffer:
        return None
    w = h = 0
    mode = ""
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s or s == b"\x0c":
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            w = int(v)
        elif k == b"height":
            h = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    return _opens("IMT", w, h) if mode else None


def _iptc(data: bytes):
    """``IptcImageFile._open``: its fields up to the image data."""
    fp = io.BytesIO(data)
    info = {}
    while True:
        s = fp.read(5)
        if not s.strip(b"\x00"):
            tag = None
            break
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            return None
        size = s[3]
        if size > 132:
            raise OSError("illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            size = _pil.u32be((b"\0\0\0\0" + fp.read(size - 128))[-4:])
        else:
            size = _pil.u16be(s, 3)
        if tag == (8, 10):
            break
        data_ = fp.read(size) if size else None
        if tag in info:
            old = info[tag]
            info[tag] = old + [data_] if isinstance(old, list) else [old,
                                                                     data_]
        else:
            info[tag] = data_
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode = ""
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        if (3, 65) in info:
            info[(3, 65)][0] - 1  # noqa: B018 -- PIL's band

    def getint(key):
        return _pil.u32be((b"\0\0\0\0" + info[key])[-4:])

    w, h = getint((3, 20)), getint((3, 30))
    try:
        if getint((3, 120)) not in (1, 5):
            raise KeyError
    except KeyError:
        raise OSError("Unknown IPTC image compression") from None
    return _opens("IPTC", w, h) if mode else None


def _pcd(data: bytes):
    s = data[2048 : 2048 + 1539]
    if not s.startswith(b"PCD_"):
        return None
    s[1538]  # noqa: B018 -- PIL reads the orientation byte
    return _opens("PCD", 768, 512)


def _spider(data: bytes):
    f = data[:108]
    for order in (">27f", "<27f"):
        try:
            t = struct.unpack(order, f)
        except struct.error:
            return None
        hdrlen = _spider_header(t)
        if hdrlen:
            break
    else:
        return None
    h = (99,) + t
    if int(h[5]) != 1:
        return None
    stack, number = int(h[24]), int(h[27])  # NaN: ValueError, as PIL's
    if stack > 0 and number == 0:
        int(h[26])
    elif stack == 0 and number > 0:  # PIL reads a stack offset it lacks
        raise AttributeError("'SpiderImageFile' object has no attribute "
                             "'stkoffset'")
    elif not (stack == 0 and number == 0):
        return None
    return _opens("SPIDER", int(h[12]), int(h[2]))


def _spider_header(t) -> int:
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        if not _is_int(h[i]):
            return 0
    if int(h[5]) not in _SPIDER_IFORMS:
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _is_int(f) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _magic(name: str, *heads: bytes):
    """A plugin the port only knows by its magic bytes."""
    def accept(data: bytes):
        return (name, None) if data.startswith(heads) else None
    return accept


def _avif(data: bytes):
    """AVIF: libavif opens an ISO media file, its ``ftyp`` box followed
    by a ``meta`` box; anything else it refuses, and PIL tries the next
    plugin."""
    if data[4:8] != b"ftyp" or data[8:12] not in (b"avif", b"avis", b"mif1",
                                                  b"msf1"):
        return None
    size = _pil.u32be(data)
    if 16 <= size <= len(data) - 8 and data[size + 4 : size + 8] == b"meta":
        return "AVIF", None
    return None


def _eps(data: bytes):
    if data.startswith(b"%!PS") or (
            len(data) >= 4 and _pil.u32le(data) == 0xC6D3D0C5):
        return "EPS", None
    return None


def _sun(data: bytes):
    if len(data) >= 4 and _pil.u32be(data) == 0x59A66A95:
        return "SUN", None
    return None


def _grib(data: bytes):
    if len(data) >= 8 and data.startswith(b"GRIB") and data[7] == 1:
        return "GRIB", None
    return None


def _webp(data: bytes):
    if data.startswith(b"RIFF") and data[8:12] == b"WEBP" and \
            data[12:16] in (b"VP8 ", b"VP8X", b"VP8L"):
        return "WEBP", None
    return None


def _xbm(data: bytes):
    if not xbm.accept(data[:16]):
        return None
    w, h, _ = xbm.open_header(data)
    return "XBM", (w, h)


def _msp(data: bytes):
    if not msp.accept(data[:16]):
        return None
    hdr = msp.open_header(data)
    return "MSP", (hdr.width, hdr.height)


def _qoi(data: bytes):
    if not data.startswith(qoi.MAGIC):
        return None
    w, h, _ = qoi.open_header(data)
    return "QOI", (w, h)


def _dds(data: bytes):
    if not data.startswith(dds.MAGIC):
        return None
    hdr = dds.open_header(data)
    return "DDS", (hdr.width, hdr.height)


def _jpeg2000(data: bytes):
    if not jpeg2000.accept(data[:16]):
        return None
    hdr = jpeg2000.open_header(data)
    return _opens("JPEG2000", hdr.width, hdr.height)


def _pcx(data: bytes):
    if not pcx.accept(data[:16]):
        return None
    hdr = pcx.open_header(data)
    return "PCX", (hdr.width, hdr.height)


def _dcx(data: bytes):
    if not pcx.dcx_accept(data[:16]):
        return None
    hdr = pcx.open_header(data, pcx.dcx_offsets(data)[0])
    return "DCX", (hdr.width, hdr.height)


def _sgi(data: bytes):
    if not sgi.accept(data[:16]):
        return None
    hdr = sgi.open_header(data)
    return "SGI", (hdr.width, hdr.height)


def _tga(data: bytes):
    hdr = tga.open_header(data)
    return "TGA", (hdr.width, hdr.height)


# Image.ID after BMP, GIF, JPEG, PPM and PNG, in this installation's order
_PLUGINS = (
    _dib, _avif, _magic("BLP", b"BLP1", b"BLP2"),
    _magic("BUFR", b"BUFR", b"ZCZC"), _cur, _pcx, _dcx, _dds, _eps,
    _magic("FITS", b"SIMPLE"), _fli,
    _magic("FTEX", b"FTEX"), _gbr, _grib,
    _magic("HDF5", b"\x89HDF\r\n\x1a\n"),
    _jpeg2000,
    _magic("ICNS", b"icns"), _ico, _im, _imt, _iptc, _mcidas, _mpeg,
    _magic("TIFF", b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00",
           b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00"),
    _msp, _pcd,
    _magic("PIXAR", b"\200\350\000\000"), _magic("PSD", b"8BPS"),
    _qoi, _sgi, _spider, _sun, _tga, _webp,
    _magic("WMF", b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00"), _xbm,
    _magic("XPM", b"/* XPM */"), _magic("XVTHUMB", b"P7 332"),
)
# the formats the port reads, by their readers of frame k
_READERS = {"PCX": pcx.read_frame, "DCX": pcx.read_frame,
            "SGI": sgi.read_frame, "TGA": tga.read_frame,
            "DIB": bmp.read_frame, "IM": im.read_frame,
            "MSP": msp.read_frame, "XBM": xbm.read_frame,
            "QOI": qoi.read_frame, "DDS": dds.read_frame,
            "JPEG2000": jpeg2000.read_frame}
READ = tuple(_READERS)
# the plugins that open any file their magic bytes start (AVIF: any with
# its first two boxes): the port does not check whether their _open would
# refuse it and hand it on
MAGIC_ONLY = ("AVIF", "BLP", "BUFR", "EPS", "FITS", "FTEX", "GRIB", "HDF5",
              "ICNS", "TIFF", "PIXAR", "PSD", "SUN", "WEBP",
              "WMF", "XPM", "XVTHUMB")
# the plugins whose header checks stop short of PIL's: ICO (PIL loads the
# first icon while it opens the file), FLI (its first chunks)
PARTLY_CHECKED = ("ICO", "FLI")


def open_image(data: bytes) -> Optional[str]:
    """The format ``Image.open`` opens the file ``data`` as, after the
    plugins the callers test by magic bytes, or None where no plugin
    opens it.  A plugin's exception that PIL lets escape escapes, as does
    the decompression-bomb check's (on the size the plugin found, where
    the port knows it)."""
    for plugin in _PLUGINS:
        try:
            found = plugin(data)
        except _pil.PASS:
            continue
        if found is not None:
            name, size = found
            if size is not None:
                _pil.bomb_check(*size)
            return name
    return None


def read(data: bytes, index: int, what: str) -> Optional[np.ndarray]:
    """Frame ``index`` of the file ``data`` as ``Image.open``, ``seek``
    and ``np.asarray`` give it for a format in ``READ`` (PIL's exceptions,
    ``EOFError`` past the last frame); ``NotImplementedError`` naming
    ROADMAP M17 (with ``what``, the file's name) for a format PIL opens
    and the port does not read; None where no plugin opens the file."""
    name = open_image(data)
    if name is None:
        return None
    if name not in READ:
        raise NotImplementedError(
            f"{what}: PIL opens this file as {name}, which unmicst_tpu_torch "
            "does not read (ROADMAP M17)")
    return _READERS[name](data, index)
