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
DIB, IM, MSP, XBM, QOI, DDS (its block-compressed formats too) and JPEG
2000, SPIDER, FITS, McIDAS, PSD, Sun raster, PIXAR, XV thumbnails, XPM,
IMT, GBR, IPTC and PhotoCD, and ICO, CUR, ICNS, BLP, FTEX and FLI, each
through its module of this package), raises PIL's ``OSError`` for the
plugins that open a file and cannot load it (``NO_LOADER``: the BUFR,
GRIB, HDF5 and WMF stubs, MPEG) and refuses the others with
``NotImplementedError`` naming ROADMAP M17 (EPS among them, whose pixels
PIL takes from Ghostscript; ``EOFError`` past its one frame).  Every
plugin runs its header checks here as PIL's ``_open`` does (ICO's loads
its largest entry, as PIL's does) but those of ``MAGIC_ONLY``: AVIF and
WebP, whose ``_open`` is their codec's own parser, and TIFF, the port's
own reader, open any file their magic bytes start (the port does not
check whether their ``_open`` would refuse it and hand it on: none of
their magic numbers can start a file of a format the port reads, and
AVIF's is checked as far as its first two boxes).

None where no plugin opens the file (PIL's ``UnidentifiedImageError``).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from unmicst_tpu_torch.io import _pil
from unmicst_tpu_torch.io import (blp, bmp, dds, eps, fits, fli, ftex, gbr,
                                  icns, ico, im, imt, iptc, jpeg2000, mcidas,
                                  msp, pcd, pcx, pixar, psd, qoi, sgi, spider,
                                  sun, tga, xbm, xpm, xvthumb)

def _opens(name: str, w, h):
    """``(name, size)`` where ``ImageFile.__init__`` keeps the image
    (its size above zero), else None (the next plugin)."""
    return (name, (w, h)) if w > 0 and h > 0 else None


def _dib(data: bytes):
    if _pil.u32le(data[:4]) not in bmp.DIB_HEADERS:
        return None
    return _opens("DIB", *bmp.open_bitmap(data, 0))


def _cur(data: bytes):
    if not data.startswith(b"\0\0\2\0"):
        return None
    return "CUR", ico.cur_open_header(data)


def _ico(data: bytes):
    """``IcoImageFile._open``, which loads the largest entry: the size it
    ends with, and the pixels, which :func:`read` then takes as they
    are."""
    if not data.startswith(b"\0\0\1\0"):
        return None
    px = ico.load(data)
    return "ICO", (px.shape[1], px.shape[0]), px


def _icns(data: bytes):
    if not data.startswith(icns.MAGIC):
        return None
    _, (w, h, scale) = icns.open_header(data)
    return "ICNS", (w * scale, h * scale)


def _blp(data: bytes):
    if not data.startswith((b"BLP1", b"BLP2")):
        return None
    hdr = blp.open_header(data)
    return "BLP", (hdr.width, hdr.height)


def _ftex(data: bytes):
    if not data.startswith(ftex.MAGIC):
        return None
    w, h, _, _ = ftex.open_header(data)
    return "FTEX", (w, h)


def _mpeg(data: bytes):
    if not data.startswith(b"\x00\x00\x01\xb3"):
        return None
    w = (data[4] << 4) | (data[5] >> 4)
    h = ((data[5] & 15) << 8) | data[6]
    return _opens("MPEG", w, h)


def _gbr(data: bytes):
    if not gbr.accept(data[:16]):
        return None
    w, h, _, _ = gbr.open_header(data)
    return _opens("GBR", w, h)


def _fli(data: bytes):
    if not fli.accept(data[:16]):
        return None
    hdr = fli.open_header(data)
    return "FLI", (hdr.width, hdr.height)


def _mcidas(data: bytes):
    if not mcidas.accept(data[:16]):
        return None
    _, _, (w, h), _, _ = mcidas.open_header(data)
    return _opens("MCIDAS", w, h)


def _im(data: bytes):
    """``ImImageFile._open`` (:func:`im.open_header`)."""
    hdr = im.open_header(data)
    return "IM", (hdr.width, hdr.height)


def _imt(data: bytes):
    w, h, _, _ = imt.open_header(data)
    return "IMT", (w, h)


def _iptc(data: bytes):
    hdr = iptc.open_header(data)
    return "IPTC", (hdr.width, hdr.height)


def _pcd(data: bytes):
    pcd.open_header(data)
    return "PCD", (768, 512)


def _spider(data: bytes):
    hdr = spider.open_header(data)
    return _opens("SPIDER", hdr.width, hdr.height)


def _fits(data: bytes):
    if not data.startswith(b"SIMPLE"):
        return None
    hdr = fits.open_header(data)
    return "FITS", (hdr.width, hdr.height)


def _pixar(data: bytes):
    if not data.startswith(pixar.MAGIC):
        return None
    return "PIXAR", pixar.open_header(data)


def _psd(data: bytes):
    if not psd.accept(data[:16]):
        return None
    hdr = psd.open_header(data)
    return _opens("PSD", hdr.width, hdr.height)


def _xpm(data: bytes):
    if not data.startswith(b"/* XPM */"):
        return None
    hdr = xpm.open_header(data)
    return "XPM", (hdr.width, hdr.height)


def _xvthumb(data: bytes):
    if not data.startswith(xvthumb.MAGIC):
        return None
    w, h, _ = xvthumb.open_header(data)
    return "XVTHUMB", (w, h)


def _stub(name: str, accept):
    """A plugin of PIL's that opens any file ``accept`` takes at 1 x 1
    and has no loader (BUFR, GRIB, HDF5)."""
    def plugin(data: bytes):
        return (name, (1, 1)) if accept(data[:16]) else None
    return plugin


def _wmf(data: bytes):
    """``WmfStubImageFile._open``: a placeable metafile (its bounding box
    at 72 dots an inch) or an enhanced one (``" EMF"`` at 40)."""
    if not data.startswith((b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00")):
        return None
    s = data[:44]
    if s.startswith(b"\xd7\xcd\xc6\x9a\x00\x00"):
        inch = _pil.u16le(s, 14)
        if inch == 0:
            raise ValueError("Invalid inch")
        x0, y0, x1, y1 = struct.unpack_from("<4h", s, 6)
        size = ((x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch)
        if s[22:26] != b"\x01\x00\t\x00":
            raise SyntaxError("Unsupported WMF file format")
    elif s.startswith(b"\x01\x00\x00\x00") and s[40:44] == b" EMF":
        x0, y0, x1, y1, f0, f1, f2, f3 = struct.unpack_from("<8i", s, 8)
        size = (x1 - x0, y1 - y0)
        2540.0 * (x1 - x0) / (f2 - f0)  # noqa: B018 -- PIL's dpi
        2540.0 * (y1 - y0) / (f3 - f1)  # noqa: B018
    else:
        raise SyntaxError("Unsupported file format")
    return _opens("WMF", *size)


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
    if not (data.startswith(b"%!PS") or (
            len(data) >= 4 and _pil.u32le(data) == 0xC6D3D0C5)):
        return None
    return "EPS", eps.open_header(data)


def _sun(data: bytes):
    if not sun.accept(data[:16]):
        return None
    hdr = sun.open_header(data)
    return _opens("SUN", hdr.width, hdr.height)


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
    _dib, _avif, _blp,
    _stub("BUFR", lambda p: p.startswith((b"BUFR", b"ZCZC"))), _cur, _pcx,
    _dcx, _dds, _eps, _fits, _fli,
    _ftex, _gbr,
    _stub("GRIB", lambda p: p.startswith(b"GRIB") and p[7] == 1),
    _stub("HDF5", lambda p: p.startswith(b"\x89HDF\r\n\x1a\n")),
    _jpeg2000,
    _icns, _ico, _im, _imt, _iptc, _mcidas, _mpeg,
    _magic("TIFF", b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00",
           b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00"),
    _msp, _pcd, _pixar, _psd, _qoi, _sgi, _spider, _sun, _tga, _webp, _wmf,
    _xbm, _xpm, _xvthumb,
)


def _no_loader(name: str, message: str):
    """The reader of a plugin that opens a file and cannot load it:
    ``np.asarray`` raises PIL's ``OSError``, ``seek`` past frame 0
    ``EOFError``."""
    def read(data: bytes, index):
        if index:
            raise EOFError("no more images in file")
        raise OSError(message)
    return read


# the formats the port reads, by their readers of frame k (None: no seek)
_READERS = {"PCX": pcx.read_frame, "DCX": pcx.read_frame,
            "SGI": sgi.read_frame, "TGA": tga.read_frame,
            "DIB": bmp.read_frame, "IM": im.read_frame,
            "MSP": msp.read_frame, "XBM": xbm.read_frame,
            "QOI": qoi.read_frame, "DDS": dds.read_frame,
            "JPEG2000": jpeg2000.read_frame,
            "SPIDER": spider.read_frame, "FITS": fits.read_frame,
            "MCIDAS": mcidas.read_frame, "PSD": psd.read_frame,
            "SUN": sun.read_frame, "PIXAR": pixar.read_frame,
            "XVTHUMB": xvthumb.read_frame, "XPM": xpm.read_frame,
            "IMT": imt.read_frame, "GBR": gbr.read_frame,
            "IPTC": iptc.read_frame, "PCD": pcd.read_frame,
            "ICO": ico.read_frame, "CUR": ico.cur_read_frame,
            "ICNS": icns.read_frame, "BLP": blp.read_frame,
            "FTEX": ftex.read_frame, "FLI": fli.read_frame}
READ = tuple(_READERS)
# the readers that tell no seek from seek(0): the others get 0 for None
_SEEKS = ("SPIDER", "PSD")
# the plugins that open a file they cannot load: np.asarray raises PIL's
# OSError (WMF's loader is Windows-only)
NO_LOADER = {name: _no_loader(name, f"cannot find loader for this {name} "
                              "file") for name in ("BUFR", "GRIB", "HDF5",
                                                   "WMF")}
NO_LOADER["MPEG"] = _no_loader("MPEG", "cannot load this image")
# the plugins that open any file their magic bytes start (AVIF: any with
# its first two boxes): their _open is their codec's own parser (AVIF,
# WebP) or the port's TIFF reader, so the port does not check whether it
# would refuse the file and hand it on
MAGIC_ONLY = ("AVIF", "TIFF", "WEBP")


def _open(data: bytes):
    """The first plugin's ``(name, size)``, with the pixels where its
    ``_open`` loads them (ICO), or None (see :func:`open_image`)."""
    for plugin in _PLUGINS:
        try:
            found = plugin(data)
        except _pil.PASS:
            continue
        if found is not None:
            if found[1] is not None:
                _pil.bomb_check(*found[1])
            return found
    return None


def open_image(data: bytes) -> Optional[str]:
    """The format ``Image.open`` opens the file ``data`` as, after the
    plugins the callers test by magic bytes, or None where no plugin
    opens it.  A plugin's exception that PIL lets escape escapes, as does
    the decompression-bomb check's (on the size the plugin found, where
    the port knows it)."""
    found = _open(data)
    return None if found is None else found[0]


def read(data: bytes, index: Optional[int], what: str
         ) -> Optional[np.ndarray]:
    """Frame ``index`` of the file ``data`` as ``Image.open``, ``seek``
    and ``np.asarray`` give it for a format in ``READ`` (PIL's exceptions,
    ``EOFError`` past the last frame; ``index`` None: no seek, which only
    SPIDER and PSD tell from ``seek(0)``); PIL's ``OSError`` for a format
    PIL opens and cannot load (``NO_LOADER``); ``NotImplementedError``
    naming ROADMAP M17 (with ``what``, the file's name) for a format PIL
    opens and the port does not read; None where no plugin opens the
    file."""
    found = _open(data)
    if found is None:
        return None
    name, _, *loaded = found
    if name in NO_LOADER:
        return NO_LOADER[name](data, index)
    if name == "EPS" and index:  # one frame: PIL's seek refuses the rest
        raise EOFError("attempt to seek outside sequence")
    if name not in READ:
        raise NotImplementedError(
            f"{what}: PIL opens this file as {name}, which unmicst_tpu_torch "
            "does not read (ROADMAP M17)")
    if index is None and name not in _SEEKS:
        index = 0
    if loaded:  # ICO: loaded while it opened, as PIL loads it once
        return ico.read_frame(data, index, loaded[0])
    return _READERS[name](data, index)
