"""JPEG 2000 files (J2K codestreams and JP2 files) read as PIL 12.1 reads
them for the JAX package through openjpeg 2.5: its TIFF fallback's
``Image.open`` of a file under a TIFF name (``unmicst_tpu/io/slides.py:
66-89``, ``unmicst_tpu/io/tiff.py:1273-1291``) and the toolbox's
``imread`` (``unmicst_tpu/utils/imtools.py:48-56``).

The header (:func:`open_header`) is ``Jpeg2KImagePlugin._open``: the mode
from SIZ's ``Csiz`` and ``Ssiz`` or from the JP2 ``ihdr``, ``colr``
(CMYK) and ``pclr`` (``P``/``PA``) boxes, the size ``Xsiz - XOsiz`` x
``Ysiz - YOsiz`` (or ihdr's), its ``SyntaxError`` and ``struct.error``
that hand the file to PIL's next plugin, and the ``OSError`` and
``ValueError`` a file object raises where the plugin reads past the end
or seeks before the start.

The pixels (:func:`load`) are openjpeg's decode, tile by tile, unpacked
into the mode as Pillow's ``Jpeg2KDecode.c`` unpacks it:

* openjpeg's checks of the JP2 boxes (signature, ``ftyp``, ``jp2h`` with
  ``ihdr``, ``colr``, ``pclr``, ``cmap``, ``cdef`` and ``bpcc``, the
  codestream box) and of the main and tile-part headers (SIZ, COD, COC,
  QCD, QCC, a later COD or QCD overriding an earlier COC or QCC; TLM,
  PLM, PLT, CRG and COM checked and skipped; unknown markers skipped as
  openjpeg skips them);
* tier 2 (packet headers: tag trees, passes, lengths) over all five
  progression orders, precincts, quality layers and code-block sizes,
  single and multi-tile images with image and tile offsets;
* tier 1 (the MQ decoder and the three coding passes, openjpeg's
  midpoint reconstruction) and the inverse 5/3 and 9/7 wavelets, in the
  port's native host library (``native/j2kdec.cpp``) when it loads and
  otherwise in :func:`t1_decode_py`, :func:`idwt53_py` and
  :func:`idwt97_py`, the plain versions the tests hold it to: the 9/7
  path is openjpeg's float32 arithmetic op for op (the step size
  ``(1 + mant/2048) 2^(prec - expn)``, the lifting constants and order,
  ``2/K`` for the high band), then the RCT or the float ICT, ``lrintf``,
  the DC shift and the clamp;
* Pillow's unpack: ``I;16`` for one component above 8 bits (shifted to
  16), 8-bit ``L``/``LA``/``RGB``/``RGBA``/``CMYK`` from wider components
  (shifted with rounding), the ``+2^(prec-1)`` offset of signed
  components, ``P``/``PA`` as the palette's indices; a colour space and
  mode Pillow has no unpacker for is its "broken data stream" ``OSError``.

What PIL's encoder cannot make raises ``NotImplementedError`` naming
ROADMAP M17: code-block styles other than 0 (HT among them), SOP and EPH
markers, PPM, PPT, POC, RGN, CAP and CPF, coding styles and
quantization in tile-part headers, the Part 2 markers, subsampled
components, components of more than 16 bits, mixed wavelets under a
component transform and sYCC JP2 files.  Where openjpeg conceals
a truncated or corrupt stream (missing tiles, short tile-parts, packet
data past the tile's end, no EOC), the port raises ``OSError`` instead.
"""

from __future__ import annotations

import dataclasses
import io
import os
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from unmicst_tpu_torch.io import _native
from unmicst_tpu_torch.io import _pil

J2K_MAGIC = b"\xff\x4f\xff\x51"
JP2_MAGIC = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
BROKEN = "broken data stream when reading image file"


class _Broken(Exception):
    """openjpeg refused the stream: PIL's decoder reports it broken."""


def _refuse(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"JPEG 2000: {what} is not read by unmicst_tpu_torch (the JAX "
        "package reads it through PIL: ROADMAP M17)")


# -- PIL's header side (Jpeg2KImagePlugin.py) ---------------------------------


class _File(io.BytesIO):
    """A file object over bytes with a real file's failures: a read of
    less than -1 bytes is ``ValueError``, a seek before the start
    ``OSError``."""

    def read(self, n=-1):
        if n is not None and n < -1:
            raise ValueError("read length must be non-negative or -1")
        return super().read(n)

    def seek(self, offset, whence=os.SEEK_SET):
        target = {os.SEEK_SET: 0, os.SEEK_CUR: self.tell(),
                  os.SEEK_END: len(self.getbuffer())}[whence] + offset
        if target < 0:
            raise OSError(22, "Invalid argument")
        return super().seek(target)


class _BoxReader:
    """``Jpeg2KImagePlugin.BoxReader``."""

    def __init__(self, fp, length: int = -1):
        self.fp = fp
        self.has_length = length >= 0
        self.length = length
        self.remaining_in_box = -1

    def _can_read(self, n: int) -> bool:
        if self.has_length and self.fp.tell() + n > self.length:
            return False
        if self.remaining_in_box >= 0:
            return n <= self.remaining_in_box
        return True

    def _read_bytes(self, n: int) -> bytes:
        if not self._can_read(n):
            raise SyntaxError("Not enough data in header")
        data = self.fp.read(n)
        if len(data) < n:
            raise OSError(f"Expected to read {n} bytes but only got "
                          f"{len(data)}.")
        if self.remaining_in_box > 0:
            self.remaining_in_box -= n
        return data

    def read_fields(self, fmt: str):
        return struct.unpack(fmt, self._read_bytes(struct.calcsize(fmt)))

    def read_boxes(self) -> "_BoxReader":
        size = self.remaining_in_box
        return _BoxReader(_File(self._read_bytes(size)), size)

    def has_next_box(self) -> bool:
        if self.has_length:
            return self.fp.tell() + self.remaining_in_box < self.length
        return True

    def next_box_type(self) -> bytes:
        if self.remaining_in_box > 0:
            self.fp.seek(self.remaining_in_box, os.SEEK_CUR)
        self.remaining_in_box = -1
        lbox, tbox = self.read_fields(">I4s")
        if lbox == 1:
            lbox = self.read_fields(">Q")[0]
            hlen = 16
        else:
            hlen = 8
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise SyntaxError("Invalid header length")
        self.remaining_in_box = lbox - hlen
        return tbox


class Palette:
    """A ``pclr`` palette as ``ImagePalette.getcolor`` keeps it: its
    colours by index and its bytes (a colour shorter or longer than the
    mode's entry shifts the ones after it), and what ``putpalette``
    makes of them (:meth:`rgba`)."""

    def __init__(self, mode: str):
        self.mode = mode
        self.colors: Dict[tuple, int] = {}
        self.data = bytearray()

    def getcolor(self, color: tuple) -> int:
        if self.mode == "RGBA" and len(color) == 3:
            color += (255,)
        if color in self.colors:
            return self.colors[color]
        n = len(self.mode)
        index = len(self.data) // n
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        self.colors[color] = index
        if index * n < len(self.data):  # a short colour before: overwritten
            self.data[index * n :] = bytes(color) + self.data[index * n + n :]
        else:
            self.data += bytes(color)
        return index

    def rgba(self) -> np.ndarray:
        """``[256, 4]`` uint8: the image's palette after ``putpalette``
        (entries past the palette's bytes black and opaque, an RGB
        palette's alpha 255)."""
        n = len(self.mode)
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        k = len(self.data) // n
        table[:k, :n] = np.frombuffer(bytes(self.data[: k * n]),
                                      np.uint8).reshape(k, n)
        return table


def _parse_codestream(fp) -> Tuple[Tuple[int, int], str]:
    hdr = fp.read(2)
    lsiz = _pil.u16be(hdr)
    siz = hdr + fp.read(lsiz - 2)
    (_, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _,
     csiz) = struct.unpack_from(">HHIIIIIIIIH", siz)
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        mode = "I;16" if (struct.unpack_from(">B", siz, 38)[0] & 0x7F) + 1 \
            > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise SyntaxError("unable to determine J2K image mode")
    return size, mode


def _parse_jp2_header(fp):
    reader = _BoxReader(fp)
    header = None
    while reader.has_next_box():
        tbox = reader.next_box_type()
        if tbox == b"jp2h":
            header = reader.read_boxes()
            break
        if tbox == b"ftyp":
            reader.read_fields(">4s")
    if header is None:  # PIL's assert
        raise AssertionError
    size = mode = nc = None
    palette = None
    while header.has_next_box():
        tbox = header.next_box_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.read_fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc in (1, 2, 3, 4):
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[nc]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.read_fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.read_fields(">HB")
            depths = header.read_fields(">" + "B" * npc)
            if max((0,) + depths) <= 8:
                palette = Palette("RGBA" if npc == 4 else "RGB")
                for _ in range(ne):
                    palette.getcolor(header.read_fields(">" + "B" * npc))
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.read_boxes()
            while res.has_next_box():
                if res.next_box_type() == b"resc":
                    res.read_fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise SyntaxError("Malformed JP2 header")
    return size, mode, palette


def _parse_comment(fp) -> None:
    while True:
        marker = fp.read(2)
        if not marker:
            break
        typ = marker[1]
        if typ in (0x90, 0xD9):
            break
        length = _pil.u16be(fp.read(2))
        if typ == 0x64:
            fp.read(length - 2)
            break
        fp.seek(length - 2, os.SEEK_CUR)


@dataclasses.dataclass
class J2kHeader:
    """What ``Jpeg2KImageFile._open`` finds: ``codec`` ``"j2k"`` or
    ``"jp2"``, the size, PIL's mode and a ``P``/``PA`` image's
    palette."""

    codec: str
    width: int
    height: int
    mode: str
    palette: Optional[Palette] = None


def accept(prefix: bytes) -> bool:
    """``Jpeg2KImagePlugin._accept``."""
    return prefix.startswith((J2K_MAGIC, JP2_MAGIC))


def open_header(data: bytes) -> J2kHeader:
    """``Jpeg2KImageFile._open`` of the file ``data``: its exceptions
    (``SyntaxError``, ``struct.error``, ``IndexError``: the next plugin;
    ``OSError``, ``ValueError``, ``AssertionError``: escape
    ``Image.open``)."""
    fp = _File(data)
    sig = fp.read(4)
    palette = None
    if sig == J2K_MAGIC:
        codec = "j2k"
        size, mode = _parse_codestream(fp)
        _parse_comment(fp)
    else:
        sig += fp.read(8)
        if sig != JP2_MAGIC:
            raise SyntaxError("not a JPEG 2000 file")
        codec = "jp2"
        size, mode, palette = _parse_jp2_header(fp)
        if fp.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
            length = _pil.u16be(fp.read(2))
            fp.seek(length - 2, os.SEEK_CUR)
            _parse_comment(fp)
    return J2kHeader(codec, size[0], size[1], mode, palette)


# -- openjpeg's JP2 boxes -----------------------------------------------------

_JP2_SIG, _JP2_FTYP, _JP2_HEADER = 1, 2, 4
_IMG_BOXES = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")
# JP2 enumerated colour spaces -> openjpeg's OPJ_COLOR_SPACE (another
# value, no colr box or an ICC profile: unspecified, as PIL reads them)
_UNSPECIFIED = 0
_SRGB, _GRAY, _SYCC, _EYCC, _CMYK = 1, 2, 3, 4, 5
_ENUMCS = {16: _SRGB, 17: _GRAY, 18: _SYCC, 24: _EYCC, 12: _CMYK}


@dataclasses.dataclass
class _Jp2:
    state: int = 0
    ihdr: Optional[Tuple[int, int, int, int]] = None  # h, w, nc, bpc
    enumcs: int = 0
    has_colr: bool = False
    pclr: Optional[int] = None  # its column count
    cmap: bool = False
    cdef: bool = False


def _jp2_img_box(jp2: _Jp2, typ: bytes, body: bytes) -> None:
    """openjpeg's handler of a box of the JP2 header."""
    n = len(body)
    if typ == b"ihdr":
        if jp2.ihdr is not None:
            return  # "Ignoring ihdr box. First ihdr box already read"
        if n != 14:
            raise _Broken("Bad image header box (bad size)")
        h, w, nc, bpc = struct.unpack_from(">IIHB", body)
        if (nc - 1) % 2**32 >= 16384 or h < 1 or w < 1:
            raise _Broken("Wrong values in ihdr")
        jp2.ihdr = (h, w, nc, bpc)
    elif typ == b"colr":
        if jp2.has_colr:
            return
        if n < 3:
            raise _Broken("Bad COLR header box (bad size)")
        if body[0] == 1:
            if n < 7:
                raise _Broken("Bad COLR header box (bad size)")
            jp2.enumcs = _pil.u32be(body, 3)
            jp2.has_colr = True
        elif body[0] == 2:
            jp2.has_colr = True  # an ICC profile: enumcs stays 0
    elif typ == b"pclr":
        if jp2.pclr is not None or n < 3:
            raise _Broken("Invalid PCLR box")
        ne, npc = _pil.u16be(body), body[2]
        if not 0 < ne <= 1024 or npc == 0 or n < 3 + npc:
            raise _Broken("Invalid PCLR box")
        need = 3 + npc + ne * sum(min(4, ((b & 0x7F) + 8) >> 3)
                                  for b in body[3 : 3 + npc])
        if need > n:
            raise _Broken("Invalid PCLR box")
        jp2.pclr = npc
    elif typ == b"cmap":
        if jp2.pclr is None or jp2.cmap or n < jp2.pclr * 4:
            raise _Broken("Invalid CMAP box")
        jp2.cmap = True
    elif typ == b"cdef":
        if jp2.cdef or n < 2:
            raise _Broken("Invalid CDEF box")
        k = _pil.u16be(body)
        if k == 0 or n < 2 + 6 * k:
            raise _Broken("Invalid CDEF box")
        jp2.cdef = True
    elif typ == b"bpcc":
        nc = jp2.ihdr[2] if jp2.ihdr is not None else 0
        if n != nc:
            raise _Broken("Bad BPCC header box (bad size)")


def _jp2h(jp2: _Jp2, body: bytes) -> None:
    if not jp2.state & _JP2_FTYP:
        raise _Broken("The  box must be the first box in the file.")
    if len(body) < 8:
        raise _Broken("Cannot handle box of less than 8 bytes")
    pos, left, has_ihdr = 0, len(body), False
    while left > 0:
        if left < 8:
            raise _Broken("Cannot handle box of less than 8 bytes")
        length, typ = struct.unpack_from(">I4s", body, pos)
        hdr = 8
        if length == 1:
            if left < 16:
                raise _Broken("Cannot handle XL box of less than 16 bytes")
            hi, length = struct.unpack_from(">II", body, pos + 8)
            hdr = 16
            if hi != 0:
                raise _Broken("Cannot handle box sizes higher than 2^32")
        if length == 0 or length < hdr or length > left:
            raise _Broken("Stream error while reading JP2 Header box")
        if typ in _IMG_BOXES:
            _jp2_img_box(jp2, typ, body[pos + hdr : pos + length])
        has_ihdr |= typ == b"ihdr"
        pos += length
        left -= length
    if not has_ihdr:
        raise _Broken("Stream error while reading JP2 Header box: no 'ihdr'")
    jp2.state |= _JP2_HEADER


def _jp2_boxes(data: bytes) -> Tuple[int, _Jp2]:
    """openjpeg's walk of a JP2 file's boxes
    (``opj_jp2_read_header_procedure``): the offset of the codestream and
    what the header boxes hold."""
    jp2 = _Jp2()
    pos, n = 0, len(data)
    while n - pos >= 8:
        length, typ = struct.unpack_from(">I4s", data, pos)
        hdr = 8
        if length == 0:
            length = n - pos
        elif length == 1:
            if n - pos < 16:
                break
            hi, length = struct.unpack_from(">II", data, pos + 8)
            hdr = 16
            if hi != 0:
                raise _Broken("Cannot handle box sizes higher than 2^32")
        if typ == b"jp2c":
            if not jp2.state & _JP2_HEADER:
                raise _Broken("bad placed jpeg codestream")
            return pos + hdr, jp2
        if length < hdr:
            raise _Broken("invalid box size")
        size, start = length - hdr, pos + hdr
        top = typ in (b"jP  ", b"ftyp", b"jp2h")
        if top or typ in _IMG_BOXES:
            if not top and not jp2.state & _JP2_HEADER:
                if size > n - start:  # the skip runs past the end
                    raise _Broken("Problem with skipping JPEG2000 box")
                pos = start + size
                continue
            if size > n - start:
                raise _Broken("Invalid box size")
            body = data[start : start + size]
            if typ == b"jP  ":
                if jp2.state != 0 or size != 4 or \
                        _pil.u32be(body) != 0x0D0A870A:
                    raise _Broken("Error with JP signature box")
                jp2.state |= _JP2_SIG
            elif typ == b"ftyp":
                if jp2.state != _JP2_SIG or size < 8 or (size - 8) & 3:
                    raise _Broken("Error with FTYP signature Box")
                jp2.state |= _JP2_FTYP
            elif typ == b"jp2h":
                _jp2h(jp2, body)
            else:
                _jp2_img_box(jp2, typ, body)
        else:
            if not jp2.state & _JP2_SIG or not jp2.state & _JP2_FTYP:
                raise _Broken("Malformed JP2 file format")
            if size > n - start:
                raise _Broken("Problem with skipping JPEG2000 box")
        pos = start + size
    raise _Broken("no codestream box")


# -- the codestream: markers --------------------------------------------------

SOC, SOT, SOD, EOC, SIZ = 0xFF4F, 0xFF90, 0xFF93, 0xFFD9, 0xFF51
COD, COC, QCD, QCC, COM = 0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF64
_MHSIZ, _MH, _TPH = 1, 2, 4
# marker -> the header states openjpeg takes it in (opj_j2k_get_marker_
# handler); the rest are unknown markers, which it skips
_STATES = {SOT: _MH, COD: _MH | _TPH, COC: _MH | _TPH, 0xFF5E: _MH | _TPH,
           QCD: _MH | _TPH, QCC: _MH | _TPH, 0xFF5F: _MH | _TPH,
           SIZ: _MHSIZ, 0xFF55: _MH, 0xFF57: _MH, 0xFF58: _TPH,
           0xFF60: _MH, 0xFF61: _TPH, 0xFF91: 0, 0xFF63: _MH,
           COM: _MH | _TPH, 0xFF74: _MH | _TPH, 0xFF78: _MH,
           0xFF50: _MH, 0xFF59: _MH, 0xFF75: _MH | _TPH, 0xFF77: _MH | _TPH}
_SKIPPED = (0xFF55, 0xFF57, 0xFF58, 0xFF63, COM)  # TLM PLM PLT CRG COM
_REFUSED = {0xFF5E: "an RGN marker (regions of interest)",
            0xFF5F: "a POC marker (progression order changes)",
            0xFF60: "a PPM marker (packed packet headers)",
            0xFF61: "a PPT marker (packed packet headers)",
            0xFF74: "a Part 2 MCT marker", 0xFF75: "a Part 2 MCC marker",
            0xFF77: "a Part 2 MCO marker", 0xFF78: "a Part 2 CBD marker",
            0xFF50: "a CAP marker (Part 15, HTJ2K)",
            0xFF59: "a CPF marker (Part 15, HTJ2K)"}


@dataclasses.dataclass
class _Comp:
    prec: int
    sgnd: int
    dx: int
    dy: int


@dataclasses.dataclass
class _Style:
    """A component's coding style (SPcod / SPcoc) and quantization
    (SQcd / SQcc)."""

    nres: int = 0
    cbw: int = 0
    cbh: int = 0
    cblksty: int = 0
    qmfbid: int = 0
    prc: Tuple[Tuple[int, int], ...] = ()
    qntsty: int = 0
    guard: int = 0
    steps: Tuple[Tuple[int, int], ...] = ((0, 0),) * 97  # (expn, mant)


@dataclasses.dataclass
class _Main:
    x0: int = 0
    y0: int = 0
    x1: int = 0
    y1: int = 0
    tdx: int = 0
    tdy: int = 0
    tx0: int = 0
    ty0: int = 0
    comps: List[_Comp] = dataclasses.field(default_factory=list)
    csty: int = 0
    order: int = 0
    layers: int = 0
    mct: int = 0
    styles: List[_Style] = dataclasses.field(default_factory=list)
    has_cod: bool = False

    @property
    def tw(self) -> int:
        return -(-(self.x1 - self.tx0) // self.tdx)

    @property
    def th(self) -> int:
        return -(-(self.y1 - self.ty0) // self.tdy)


def _siz(m: _Main, body: bytes) -> None:
    n = len(body)
    if n < 36 or (n - 36) % 3:
        raise _Broken("Error with SIZ marker size")
    (_, m.x1, m.y1, m.x0, m.y0, m.tdx, m.tdy, m.tx0, m.ty0,
     nc) = struct.unpack_from(">HIIIIIIIIH", body)
    if nc > 16384 or nc != (n - 36) // 3:
        raise _Broken("Error with SIZ marker: number of components")
    if m.x0 >= m.x1 or m.y0 >= m.y1:
        raise _Broken("Error with SIZ marker: negative or zero image size")
    if m.tdx == 0 or m.tdy == 0:
        raise _Broken("Error with SIZ marker: invalid tile size")
    if m.tx0 > m.x0 or m.ty0 > m.y0 or m.tx0 + m.tdx <= m.x0 or \
            m.ty0 + m.tdy <= m.y0:
        raise _Broken("Error with SIZ marker: illegal tile offset")
    for k in range(nc):
        s, dx, dy = body[36 + 3 * k : 39 + 3 * k]
        if not (1 <= dx <= 255 and 1 <= dy <= 255):
            raise _Broken("Invalid values for comp: dx, dy")
        if (s & 0x7F) + 1 > 31:
            raise _Broken("Invalid values for comp: prec")
        m.comps.append(_Comp((s & 0x7F) + 1, s >> 7, dx, dy))
    if m.tw == 0 or m.th == 0 or m.tw > 65535 // m.th:
        raise _Broken("Invalid number of tiles")
    m.styles = [_Style() for _ in range(nc)]


def _spcod(st: _Style, body: bytes, pos: int, csty: int) -> int:
    """SPcod / SPcoc at ``body[pos:]`` into ``st``: the position after."""
    if len(body) - pos < 5:
        raise _Broken("Error reading SPCod SPCoc element")
    nres, cbw, cbh, cblksty, qmfbid = body[pos : pos + 5]
    pos += 5
    st.nres, st.cbw, st.cbh = nres + 1, cbw + 2, cbh + 2
    if st.nres > 33:
        raise _Broken("Invalid value for numresolutions")
    if st.cbw > 10 or st.cbh > 10 or st.cbw + st.cbh > 12:
        raise _Broken("Invalid cblkw/cblkh combination")
    if cblksty & 0x80:  # mixed HT: openjpeg refuses it
        raise _Broken("Unsupported Mixed HT code-block style found")
    if qmfbid > 1:
        raise _Broken("Invalid transformation found")
    st.cblksty, st.qmfbid = cblksty, qmfbid
    if csty & 1:
        if len(body) - pos < st.nres:
            raise _Broken("Error reading SPCod SPCoc element")
        prc = []
        for r in range(st.nres):
            b = body[pos + r]
            if r and (b & 15 == 0 or b >> 4 == 0):
                raise _Broken("Invalid precinct size")
            prc.append((b & 15, b >> 4))
        pos += st.nres
        st.prc = tuple(prc)
    else:
        st.prc = ((15, 15),) * st.nres
    return pos


def _sqcd(st: _Style, body: bytes, pos: int) -> None:
    if len(body) - pos < 1:
        raise _Broken("Error reading SQcd or SQcc element")
    st.qntsty, st.guard = body[pos] & 31, body[pos] >> 5
    rest = body[pos + 1 :]
    if st.qntsty == 0:
        steps = [(b >> 3, 0) for b in rest]
    elif len(rest) % 2 or (st.qntsty == 1 and len(rest) != 2):
        raise _Broken("Error reading SQcd or SQcc element")
    else:
        steps = [(v >> 11, v & 0x7FF) for v in
                 struct.unpack(f">{len(rest) // 2}H", rest)]
    if st.qntsty == 1:
        e0, m0 = steps[0]
        steps += [(max(e0 - (b - 1) // 3, 0), m0) for b in range(1, 97)]
    # the bands the segment does not give keep their step sizes
    st.steps = tuple(steps[:97]) + st.steps[len(steps):]


def _main_marker(m: _Main, marker: int, body: bytes) -> None:
    if marker in _REFUSED:
        raise _refuse(_REFUSED[marker])
    nc = len(m.comps)
    if marker == SIZ:
        _siz(m, body)
    elif marker == COD:
        if m.has_cod:
            raise _Broken("COD marker already read")
        if len(body) < 5:
            raise _Broken("Error reading COD marker")
        m.csty, m.order = body[0], body[1]
        m.layers, m.mct = _pil.u16be(body, 2), body[4]
        if m.csty & ~7:
            raise _Broken("Unknown Scod value in COD marker")
        if m.order > 4:
            raise _Broken("Unknown progression order in COD marker")
        if m.layers == 0:
            raise _Broken("Invalid number of layers in COD marker")
        if m.mct > 1:
            raise _Broken("Invalid multiple component transformation")
        if m.csty & 6:
            raise _refuse("SOP or EPH markers (Scod "
                          f"0x{m.csty:02x})")
        base = m.styles[0]
        if _spcod(base, body, 5, m.csty) != len(body):
            raise _Broken("Error reading COD marker")
        for st in m.styles[1:]:
            st.nres, st.cbw, st.cbh = base.nres, base.cbw, base.cbh
            st.cblksty, st.qmfbid, st.prc = base.cblksty, base.qmfbid, \
                base.prc
        m.has_cod = True
    elif marker == COC:
        k_bytes = 1 if nc <= 256 else 2
        if len(body) < k_bytes + 1:
            raise _Broken("Error reading COC marker")
        k = body[0] if k_bytes == 1 else _pil.u16be(body)
        if k >= nc:
            raise _Broken("Error reading COC marker (bad number of "
                          "components)")
        st = m.styles[k]
        if _spcod(st, body, k_bytes + 1, body[k_bytes]) != len(body):
            raise _Broken("Error reading COC marker")
    elif marker == QCD:
        _sqcd(m.styles[0], body, 0)
        for st in m.styles[1:]:
            st.qntsty, st.guard = m.styles[0].qntsty, m.styles[0].guard
            st.steps = m.styles[0].steps
    elif marker == QCC:
        k_bytes = 1 if nc <= 256 else 2
        if len(body) < k_bytes:
            raise _Broken("Error reading QCC marker")
        k = body[0] if k_bytes == 1 else _pil.u16be(body)
        if k >= nc:
            raise _Broken("Invalid component number in QCC")
        _sqcd(m.styles[k], body, k_bytes)


def _check_skipped(marker: int, body: bytes, nc: int) -> None:
    """openjpeg's checks of the marker segments it does not use: TLM,
    PLM, PLT, CRG (COM has none)."""
    n = len(body)
    if marker == 0xFF55 and n < 2:  # (a bad size or ST is a warning)
        raise _Broken("Error reading TLM marker")
    elif marker == 0xFF57 and n < 1:
        raise _Broken("Error reading PLM marker")
    elif marker == 0xFF58 and (n < 1 or (n > 1 and body[-1] & 0x80)):
        raise _Broken("Error reading PLT marker")
    elif marker == 0xFF63 and n != 4 * nc:
        raise _Broken("Error reading CRG marker")


def _marker(cs: bytes, pos: int) -> int:
    if pos + 2 > len(cs):
        raise _Broken("Stream too short")
    return _pil.u16be(cs, pos)


def _skip_unknown(cs: bytes, pos: int, state: int) -> Tuple[int, int]:
    """``opj_j2k_read_unk``: 2 bytes at a time up to the next marker
    openjpeg knows; that marker and the position after it."""
    while True:
        marker = _marker(cs, pos)
        pos += 2
        if marker >= 0xFF00:
            states = _STATES.get(marker, _MH | _TPH)
            if not state & states:
                raise _Broken("Marker is not compliant with its position")
            if marker in _STATES:
                return marker, pos


def _segments(cs: bytes, pos: int, state: int, stop: int, on_marker):
    """The marker segments from ``cs[pos]`` (a marker) up to ``stop``:
    each handed to ``on_marker(marker, body)``; the position after
    ``stop``."""
    marker = _marker(cs, pos)
    pos += 2
    while marker != stop:
        if marker < 0xFF00:
            raise _Broken("A marker ID was expected")
        if marker not in _STATES:
            marker, pos = _skip_unknown(cs, pos, state)
            if marker == stop:
                break
        if not state & _STATES[marker]:
            raise _Broken("Marker is not compliant with its position")
        size = _marker(cs, pos)
        if size < 2:
            raise _Broken("Invalid marker size")
        if pos + size > len(cs):
            raise _Broken("Stream too short")
        on_marker(marker, cs[pos + 2 : pos + size])
        pos += size
        if marker == SIZ:
            state = _MH
        marker = _marker(cs, pos)
        pos += 2
    return pos


def _read_codestream(cs: bytes) -> Tuple[_Main, Dict[int, bytes]]:
    """The main header and each tile's data (its tile-parts' bodies in
    order), as openjpeg reads them; ``_Broken`` where it refuses the
    stream, and where it would conceal a fault (see the module
    docstring)."""
    if cs[:2] != b"\xff\x4f":
        raise _Broken("Expected a SOC marker")
    m = _Main()
    seen = set()

    def on_main(marker, body):
        seen.add(marker)
        if marker in _SKIPPED:
            _check_skipped(marker, body, len(m.comps))
        else:
            _main_marker(m, marker, body)

    pos = _segments(cs, 2, _MHSIZ, SOT, on_main)
    for marker, name in ((SIZ, "SIZ"), (COD, "COD"), (QCD, "QCD")):
        if marker not in seen:
            raise _Broken(f"required {name} marker not found in main header")
    tiles: Dict[int, List[bytes]] = {}
    parts: Dict[int, int] = {}  # each tile's TNsot, where given
    ntiles = m.tw * m.th
    while True:
        sot = pos - 2
        if _marker(cs, pos) != 10 or pos + 10 > len(cs):
            raise _Broken("Error reading SOT marker")
        isot, psot, tpsot, tnsot = struct.unpack_from(">HIBB", cs, pos + 2)
        if isot >= ntiles:
            raise _Broken("Invalid tile number")
        if tpsot != len(tiles.get(isot, ())):
            raise _Broken("Invalid tile part index")
        if tnsot:
            if tpsot >= parts.get(isot, 256) or tpsot >= tnsot:
                raise _Broken("In SOT marker, TPSot is not valid")
            parts[isot] = tnsot
        if psot and psot < 14:
            raise _Broken("Psot value is not correct")

        def on_tile(marker, body):
            _check_skipped(marker, body, len(m.comps))
            if marker in (COD, COC, QCD, QCC):
                raise _refuse("coding styles or quantization in a tile-part "
                              "header")
            if marker in _REFUSED:
                raise _refuse(_REFUSED[marker])

        start = _segments(cs, pos + 10, _TPH, SOD, on_tile)
        end = len(cs) - 2 if psot == 0 else sot + psot
        if end > len(cs) or end < start:
            raise _Broken("Tile part length size inconsistent with stream "
                          "length")
        tiles.setdefault(isot, []).append(cs[start:end])
        marker = _marker(cs, end) if end + 2 <= len(cs) else None
        if marker == EOC:
            break
        if marker != SOT:
            raise _Broken("Stream too short, expected SOT")
        pos = end + 2
    if len(tiles) != ntiles:
        raise _Broken("tiles missing from the codestream")
    return m, {k: b"".join(v) for k, v in tiles.items()}


# -- tier 2 -------------------------------------------------------------------


class _Bits:
    """``opj_bio`` reading a packet header: MSB first, 7 bits after a
    0xFF byte; reading past ``end`` is a truncated stream."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.start, self.bp, self.end = data, pos, pos, end
        self.buf = 0
        self.ct = 0

    def _bytein(self) -> bool:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.bp < self.end:
            self.buf |= self.data[self.bp]
            self.bp += 1
            return True
        return False

    def bit(self) -> int:
        if self.ct == 0 and not self._bytein():
            raise _Broken("packet header past the end of the tile")
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def inalign(self) -> int:
        """``opj_bio_inalign``; the bytes the header took."""
        if self.buf & 0xFF == 0xFF:
            self._bytein()
        self.ct = 0
        return self.bp - self.start


class _TagTree:
    """``opj_tgt`` of ``w`` x ``h`` leaves (decoding)."""

    def __init__(self, w: int, h: int):
        parent, sizes = [], []
        lw, lh = w, h
        while True:
            sizes.append((lw, lh))
            if lw * lh <= 1:
                break
            lw, lh = (lw + 1) // 2, (lh + 1) // 2
        base = 0
        for k, (lw, lh) in enumerate(sizes):
            nxt = base + lw * lh
            if k + 1 < len(sizes):
                pw = sizes[k + 1][0]
                for j in range(lh):
                    for i in range(lw):
                        parent.append(nxt + (j // 2) * pw + i // 2)
            else:
                parent.extend([-1] * (lw * lh))
            base = nxt
        self.parent = parent
        self.value = [999] * len(parent)
        self.low = [0] * len(parent)

    def decode(self, bits: _Bits, leaf: int, threshold: int) -> int:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bits.bit():
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()
        return 1 if self.value[node] < threshold else 0


class _Cblk:
    __slots__ = ("x0", "y0", "x1", "y1", "numbps", "lenbits", "segs",
                 "new")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps = 0
        self.lenbits = 0
        self.segs: List[list] = []  # [passes, [chunks]]
        self.new: List[Tuple[int, int]] = []  # (passes, length) this packet


@dataclasses.dataclass
class _Band:
    bandno: int
    x0: int
    y0: int
    x1: int
    y1: int
    numbps: int
    step: float  # openjpeg's band stepsize (9/7)
    precincts: list  # per precinct: (cw, ch, cblks, incl tree, msb tree)

    @property
    def empty(self) -> bool:
        return self.x1 == self.x0 or self.y1 == self.y0


@dataclasses.dataclass
class _Res:
    x0: int
    y0: int
    x1: int
    y1: int
    pdx: int
    pdy: int
    pw: int
    ph: int
    bands: List[_Band]


def _cdiv(a: int, b: int) -> int:
    """``ceildivpow2``."""
    return -((-a) >> b)


def _tile_comp(tile: Tuple[int, int, int, int], comp: _Comp, st: _Style
               ) -> List[_Res]:
    """openjpeg's resolutions, bands, precincts and code-blocks of one
    tile-component (``opj_tcd_init_tile``)."""
    tcx0, tcy0, tcx1, tcy1 = tile
    nl = st.nres - 1
    out = []
    for r in range(st.nres):
        lev = nl - r
        rx0, ry0, rx1, ry1 = (_cdiv(tcx0, lev), _cdiv(tcy0, lev),
                              _cdiv(tcx1, lev), _cdiv(tcy1, lev))
        pdx, pdy = st.prc[r]
        px0, py0 = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
        px1, py1 = _cdiv(rx1, pdx) << pdx, _cdiv(ry1, pdy) << pdy
        pw = 0 if rx0 == rx1 else (px1 - px0) >> pdx
        ph = 0 if ry0 == ry1 else (py1 - py0) >> pdy
        if r == 0:
            cbgx0, cbgy0, cbgw, cbgh = px0, py0, pdx, pdy
            bandnos = (0,)
        else:
            cbgx0, cbgy0, cbgw, cbgh = (_cdiv(px0, 1), _cdiv(py0, 1),
                                        pdx - 1, pdy - 1)
            bandnos = (1, 2, 3)
        cbw, cbh = min(st.cbw, cbgw), min(st.cbh, cbgh)
        bands = []
        for bandno in bandnos:
            if r == 0:
                bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
                k = 0
            else:
                xb, yb = bandno & 1, bandno >> 1
                bx0 = _cdiv(tcx0 - (xb << lev), lev + 1)
                by0 = _cdiv(tcy0 - (yb << lev), lev + 1)
                bx1 = _cdiv(tcx1 - (xb << lev), lev + 1)
                by1 = _cdiv(tcy1 - (yb << lev), lev + 1)
                k = 3 * r - 3 + bandno
            expn, mant = st.steps[k] if k < len(st.steps) else (0, 0)
            step = np.float32((1.0 + mant / 2048.0)
                              * 2.0 ** (comp.prec - expn))
            precincts = []
            for p in range(pw * ph):
                gx0 = cbgx0 + (p % pw) * (1 << cbgw)
                gy0 = cbgy0 + (p // pw) * (1 << cbgh)
                qx0, qy0 = max(gx0, bx0), max(gy0, by0)
                qx1 = min(gx0 + (1 << cbgw), bx1)
                qy1 = min(gy0 + (1 << cbgh), by1)
                cx0, cy0 = (qx0 >> cbw) << cbw, (qy0 >> cbh) << cbh
                cw = max(0, (_cdiv(qx1, cbw) << cbw) - cx0) >> cbw
                ch = max(0, (_cdiv(qy1, cbh) << cbh) - cy0) >> cbh
                cblks = []
                for c in range(cw * ch):
                    x = cx0 + (c % cw) * (1 << cbw)
                    y = cy0 + (c // cw) * (1 << cbh)
                    cblks.append(_Cblk(max(x, qx0), max(y, qy0),
                                       min(x + (1 << cbw), qx1),
                                       min(y + (1 << cbh), qy1)))
                precincts.append([cw, ch, cblks, None, None])
            bands.append(_Band(bandno, bx0, by0, bx1, by1,
                               expn + st.guard - 1, step, precincts))
        out.append(_Res(rx0, ry0, rx1, ry1, pdx, pdy, pw, ph, bands))
    return out


def _packet_order(order: int, layers: int, tile, comps: List[List[_Res]]):
    """The packets of a tile, ``(layer, resolution, component, precinct)``,
    in progression order ``order`` as openjpeg's ``opj_pi_next_*``
    iterate them (each packet once)."""
    nc = len(comps)
    maxres = max(len(c) for c in comps)
    if order in (0, 1):  # LRCP, RLCP
        outer = ((l, r) for l in range(layers) for r in range(maxres)) \
            if order == 0 else \
            ((l, r) for r in range(maxres) for l in range(layers))
        for l, r in outer:
            for c in range(nc):
                if r < len(comps[c]):
                    res = comps[c][r]
                    for p in range(res.pw * res.ph):
                        yield l, r, c, p
        return
    tx0, ty0, tx1, ty1 = tile

    def steps(cs):
        dx = dy = 0
        for c in cs:
            nres = len(comps[c])
            for r, res in enumerate(comps[c]):
                ex, ey = res.pdx + nres - 1 - r, res.pdy + nres - 1 - r
                if ex < 32:
                    dx = min(dx, 1 << ex) if dx else 1 << ex
                if ey < 32:
                    dy = min(dy, 1 << ey) if dy else 1 << ey
        return dx, dy

    def precinct(c, r, x, y):
        nres = len(comps[c])
        if r >= nres:
            return None
        res = comps[c][r]
        lev = nres - 1 - r
        trx0, try0 = _cdiv(tx0, lev), _cdiv(ty0, lev)
        trx1, try1 = _cdiv(tx1, lev), _cdiv(ty1, lev)
        rpx, rpy = res.pdx + lev, res.pdy + lev
        if rpx >= 31 or rpy >= 31:
            return None
        if not (y % (1 << rpy) == 0 or (y == ty0 and (try0 << lev)
                                         % (1 << rpy))):
            return None
        if not (x % (1 << rpx) == 0 or (x == tx0 and (trx0 << lev)
                                         % (1 << rpx))):
            return None
        if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (_cdiv(x, lev) >> res.pdx) - (trx0 >> res.pdx)
        prcj = (_cdiv(y, lev) >> res.pdy) - (try0 >> res.pdy)
        return prci + prcj * res.pw

    seen = set()

    def emit(c, r, p):
        for l in range(layers):
            if (l, r, c, p) not in seen:
                seen.add((l, r, c, p))
                yield l, r, c, p

    def grid(dx, dy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += dx - x % dx
            y += dy - y % dy

    if order == 2:  # RPCL
        dx, dy = steps(range(nc))
        if not dx or not dy:
            return
        for r in range(maxres):
            for x, y in grid(dx, dy):
                for c in range(nc):
                    p = precinct(c, r, x, y)
                    if p is not None:
                        yield from emit(c, r, p)
    elif order == 3:  # PCRL
        dx, dy = steps(range(nc))
        if not dx or not dy:
            return
        for x, y in grid(dx, dy):
            for c in range(nc):
                for r in range(len(comps[c])):
                    p = precinct(c, r, x, y)
                    if p is not None:
                        yield from emit(c, r, p)
    else:  # CPRL
        for c in range(nc):
            dx, dy = steps((c,))
            if not dx or not dy:
                return
            for x, y in grid(dx, dy):
                for r in range(len(comps[c])):
                    p = precinct(c, r, x, y)
                    if p is not None:
                        yield from emit(c, r, p)


def _num_passes(bits: _Bits) -> int:
    if not bits.bit():
        return 1
    if not bits.bit():
        return 2
    n = bits.read(2)
    if n != 3:
        return 3 + n
    n = bits.read(5)
    if n != 31:
        return 6 + n
    return 37 + bits.read(7)


_MAXPASSES = 109  # a segment's passes without termination or bypass


def _read_packet(data: bytes, pos: int, layer: int, res: _Res, p: int
                 ) -> int:
    """One packet (``opj_t2_read_packet_header`` and ``_data``) at
    ``data[pos]``: the code-blocks' new passes and bytes; the position
    after it."""
    bands = [b for b in res.bands if not b.empty]
    if layer == 0:
        for b in bands:
            prc = b.precincts[p]
            prc[3], prc[4] = _TagTree(prc[0], prc[1]), _TagTree(prc[0],
                                                               prc[1])
            for cb in prc[2]:
                cb.segs = []
    bits = _Bits(data, pos, len(data))
    if not bits.bit():
        for b in bands:
            for cb in b.precincts[p][2]:
                cb.new = []
        return pos + bits.inalign()
    for b in bands:
        cw, ch, cblks, incl, msb = b.precincts[p]
        for k, cb in enumerate(cblks):
            cb.new = []
            if not cb.segs:
                included = incl.decode(bits, k, layer + 1)
            else:
                included = bits.bit()
            if not included:
                continue
            if not cb.segs:
                i = 0
                while not msb.decode(bits, k, i):
                    i += 1
                cb.numbps = b.numbps + 1 - i
                cb.lenbits = 3
            n = _num_passes(bits)
            while bits.bit():
                cb.lenbits += 1
            room = _MAXPASSES - cb.segs[-1][0] if cb.segs else _MAXPASSES
            if room == 0:
                room = _MAXPASSES
            while n > 0:
                take = min(room, n)
                nbits = cb.lenbits + take.bit_length() - 1
                if nbits > 32:
                    raise _Broken("Invalid bit number in packet header")
                cb.new.append((take, bits.read(nbits)))
                n -= take
                room = _MAXPASSES
    pos += bits.inalign()
    for b in bands:
        for cb in b.precincts[p][2]:
            for k, (take, length) in enumerate(cb.new):
                if pos + length > len(data):
                    raise _Broken("read: segment too long")
                if k == 0 and cb.segs and cb.segs[-1][0] < _MAXPASSES:
                    seg = cb.segs[-1]
                else:
                    seg = [0, []]
                    cb.segs.append(seg)
                seg[0] += take
                seg[1].append(data[pos : pos + length])
                pos += length
    return pos


# -- tier 1: the plain version ------------------------------------------------

# the MQ coder's states (ITU-T T.800 Table C.2): Qe, NMPS, NLPS, SWITCH
_QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
       0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
       0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
       0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
       0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
       0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601)
_NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19,
         20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
         37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46)
_NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16,
         17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
         33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46)
_SWITCH = (1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1) + (0,) * 32
_CTX_RL, _CTX_UNI = 17, 18
T1_BAD_BITPLANES = -1  # t1_decode's result: 31 or more bit-planes


def _zc_context(h: int, v: int, d: int, orient: int) -> int:
    """The significance context (ITU-T T.800 Table D.1) of a sample with
    ``h``/``v``/``d`` significant horizontal/vertical/diagonal
    neighbours in a band of orientation ``orient`` (0 LL, 1 HL, 2 LH,
    3 HH)."""
    if orient == 1:
        h, v = v, h
    if orient == 3:
        hv = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if hv >= 1 else 6
        if d == 1:
            return 5 if hv >= 2 else 4 if hv == 1 else 3
        return 2 if hv >= 2 else hv
    if h == 2:
        return 8
    if h == 1:
        return 7 if v >= 1 else 6 if d >= 1 else 5
    if v == 2:
        return 4
    if v == 1:
        return 3
    return 2 if d >= 2 else d


_ZC = tuple(tuple(tuple(tuple(_zc_context(h, v, d, o) for d in range(5))
                        for v in range(3)) for h in range(3))
            for o in range(4))
# (horizontal, vertical) sign contribution + 1 -> (context, xor bit)
_SC = {(2, 2): (13, 0), (2, 1): (12, 0), (2, 0): (11, 0), (1, 2): (10, 0),
       (1, 1): (9, 0), (1, 0): (10, 1), (0, 2): (11, 1), (0, 1): (12, 1),
       (0, 0): (13, 1)}


def _t1_block(segs: List[Tuple[bytes, int]], w: int, h: int, orient: int,
              numbps: int) -> List[int]:
    """One code-block's samples as openjpeg keeps them (twice the
    magnitude, plus the midpoint of the undecoded bit-planes), row by
    row, from its segments' bytes and coding passes."""
    out = [0] * (w * h)
    bp = numbps if numbps < 2**31 else numbps - 2**32
    if bp >= 31:
        raise _Broken("unsupported bpno_plus_one")
    W = w + 2
    sig = bytearray(W * (h + 2))
    vis = bytearray(W * (h + 2))
    refd = bytearray(W * (h + 2))
    neg = bytearray(W * (h + 2))
    st = [0] * 19
    mps = [0] * 19
    st[_CTX_UNI], st[_CTX_RL], st[0] = 46, 3, 4
    zc = _ZC[orient]
    mq = [0, 0, 0, 0, b""]  # a, c, ct, bp, buffer

    def bytein():
        buf, p = mq[4], mq[3]
        nxt = buf[p + 1]
        if buf[p] == 0xFF:
            if nxt > 0x8F:
                mq[1] += 0xFF00
                mq[2] = 8
            else:
                mq[3] = p + 1
                mq[1] += nxt << 9
                mq[2] = 7
        else:
            mq[3] = p + 1
            mq[1] += nxt << 8
            mq[2] = 8
        mq[1] &= 0xFFFFFFFF

    def decode(cx):
        s = st[cx]
        qe = _QE[s]
        a = mq[0] - qe
        c = mq[1]
        if (c >> 16) < qe:
            if a < qe:
                d = mps[cx]
                st[cx] = _NMPS[s]
            else:
                d = 1 - mps[cx]
                if _SWITCH[s]:
                    mps[cx] = d
                st[cx] = _NLPS[s]
            a = qe
        else:
            c -= qe << 16
            mq[1] = c
            if a & 0x8000:
                mq[0] = a
                return mps[cx]
            if a < qe:
                d = 1 - mps[cx]
                if _SWITCH[s]:
                    mps[cx] = d
                st[cx] = _NLPS[s]
            else:
                d = mps[cx]
                st[cx] = _NMPS[s]
        mq[1] = c
        while True:
            if mq[2] == 0:
                bytein()
            a <<= 1
            mq[1] = (mq[1] << 1) & 0xFFFFFFFF
            mq[2] -= 1
            if a >= 0x8000:
                break
        mq[0] = a
        return d

    def counts(i):
        hh = sig[i - 1] + sig[i + 1]
        vv = sig[i - W] + sig[i + W]
        dd = sig[i - W - 1] + sig[i - W + 1] + sig[i + W - 1] + sig[i + W + 1]
        return hh, vv, dd

    def sign(i):
        hc = vc = 1
        for j in (i - 1, i + 1):
            if sig[j]:
                hc += -1 if neg[j] else 1
        for j in (i - W, i + W):
            if sig[j]:
                vc += -1 if neg[j] else 1
        cx, xor = _SC[(min(max(hc, 0), 2), min(max(vc, 0), 2))]
        return decode(cx) ^ xor

    def significant(i, k, one):
        s = sign(i)
        sig[i] = 1
        neg[i] = s
        v = one | (one >> 1)
        out[k] = -v if s else v

    def positions():
        for y0 in range(0, h, 4):
            for x in range(w):
                yield y0, x

    passtype = 2
    for data, npass in segs:
        mq[4] = data + b"\xff\xff"
        mq[3] = 0
        mq[1] = mq[4][0] << 16
        bytein()
        mq[1] = (mq[1] << 7) & 0xFFFFFFFF
        mq[2] -= 7
        mq[0] = 0x8000
        for _ in range(npass):
            if bp < 1:
                break
            one = 1 << bp
            if passtype == 0:  # significance propagation
                for y0, x in positions():
                    for y in range(y0, min(y0 + 4, h)):
                        i = (y + 1) * W + x + 1
                        if sig[i]:
                            continue
                        hh, vv, dd = counts(i)
                        if hh + vv + dd == 0:
                            continue
                        if decode(zc[hh][vv][dd]):
                            significant(i, y * w + x, one)
                        vis[i] = 1
            elif passtype == 1:  # magnitude refinement
                half = one >> 1
                for y0, x in positions():
                    for y in range(y0, min(y0 + 4, h)):
                        i = (y + 1) * W + x + 1
                        if not sig[i] or vis[i]:
                            continue
                        hh, vv, dd = counts(i)
                        cx = 16 if refd[i] else 15 if hh + vv + dd else 14
                        k = y * w + x
                        if decode(cx) ^ (out[k] < 0):
                            out[k] += half
                        else:
                            out[k] -= half
                        refd[i] = 1
            else:  # cleanup
                for y0, x in positions():
                    rows = range(y0, min(y0 + 4, h))
                    start = y0
                    if len(rows) == 4 and not any(
                            sig[i] or vis[i] or sum(counts(i))
                            for i in ((y + 1) * W + x + 1 for y in rows)):
                        if not decode(_CTX_RL):
                            continue
                        run = decode(_CTX_UNI) << 1
                        run |= decode(_CTX_UNI)
                        y = y0 + run
                        significant((y + 1) * W + x + 1, y * w + x, one)
                        start = y + 1
                    for y in range(start, min(y0 + 4, h)):
                        i = (y + 1) * W + x + 1
                        if sig[i] or vis[i]:
                            continue
                        hh, vv, dd = counts(i)
                        if decode(zc[hh][vv][dd]):
                            significant(i, y * w + x, one)
                    for y in rows:
                        vis[(y + 1) * W + x + 1] = 0
            passtype += 1
            if passtype == 3:
                passtype = 0
                bp -= 1
    return out


def t1_decode_py(data: bytes, blocks: np.ndarray, segs: np.ndarray,
                 out: np.ndarray) -> int:
    """Tier 1 of many code-blocks, the plain version of
    ``_native.j2k_t1``: row ``(offset, w, h, stride, orient, numbps,
    first segment, segments)`` of ``blocks`` decodes the segments
    ``(data offset, length, passes)`` of ``segs`` into ``out`` (flat
    int32) at ``offset + y * stride + x``.  0, or ``T1_BAD_BITPLANES``."""
    for off, w, h, stride, orient, numbps, s0, ns in blocks.tolist():
        parts = [(data[o : o + n], p) for o, n, p in segs[s0 : s0 + ns]
                 .tolist()]
        try:
            vals = _t1_block(parts, w, h, orient, numbps)
        except _Broken:
            return T1_BAD_BITPLANES
        for y in range(h):
            out[off + y * stride : off + y * stride + w] = vals[y * w :
                                                                (y + 1) * w]
    return 0


# -- the inverse wavelets: the plain versions ---------------------------------

_ALPHA, _BETA = np.float32(1.586134342), np.float32(0.052980118)
_GAMMA, _DELTA = np.float32(-0.882911075), np.float32(-0.443506852)
_K, _TWO_INV_K = np.float32(1.230174105), np.float32(1.625732422)


def _clip(idx, n):
    return np.clip(idx, 0, n - 1)


def _lift53(x: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """The inverse 5/3 of each row of ``x`` (low half first): the
    interleaved rows."""
    n = x.shape[1]
    dn = n - sn
    lo = x[:, :sn].astype(np.int64)
    hi = x[:, sn:].astype(np.int64)
    out = np.empty_like(x)
    if n == 1:  # one sample: odd ones halve (C's division), even ones stay
        out[:] = (hi + (hi < 0)) >> 1 if cas else x
        return out
    i, j = np.arange(sn), np.arange(dn)
    if cas == 0:
        lo -= (hi[:, _clip(i - 1, dn)] + hi[:, _clip(i, dn)] + 2) >> 2
        hi += (lo[:, _clip(j, sn)] + lo[:, _clip(j + 1, sn)]) >> 1
    else:
        lo -= (hi[:, _clip(i, dn)] + hi[:, _clip(i + 1, dn)] + 2) >> 2
        hi += (lo[:, _clip(j - 1, sn)] + lo[:, _clip(j, sn)]) >> 1
    out[:, cas::2] = lo
    out[:, 1 - cas :: 2] = hi
    return out


def _lift97(x: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """The inverse 9/7 of each row of float32 ``x``, as openjpeg's
    ``opj_v8dwt_decode`` computes it."""
    n = x.shape[1]
    dn = n - sn
    if (cas == 0 and dn == 0 and sn <= 1) or (cas == 1 and sn == 0
                                              and dn <= 1):
        return x.copy()
    lo = x[:, :sn] * _K
    hi = x[:, sn:] * _TWO_INV_K
    i, j = np.arange(sn), np.arange(dn)
    if cas == 0:
        li, lj = _clip(i - 1, dn), _clip(i, dn)
        hi0, hi1 = _clip(j, sn), _clip(j + 1, sn)
    else:
        li, lj = _clip(i, dn), _clip(i + 1, dn)
        hi0, hi1 = _clip(j - 1, sn), _clip(j, sn)
    for c_lo, c_hi in ((_DELTA, _GAMMA), (_BETA, _ALPHA)):
        lo = lo + (hi[:, li] + hi[:, lj]) * c_lo
        hi = hi + (lo[:, hi0] + lo[:, hi1]) * c_hi
    out = np.empty_like(x)
    out[:, cas::2] = lo
    out[:, 1 - cas :: 2] = hi
    return out


def _idwt_py(a: np.ndarray, bounds: np.ndarray, lift) -> None:
    for r in range(1, len(bounds)):
        sw = bounds[r - 1][2] - bounds[r - 1][0]
        sh = bounds[r - 1][3] - bounds[r - 1][1]
        x0, y0, x1, y1 = bounds[r]
        rw, rh = x1 - x0, y1 - y0
        if rw == 0 or rh == 0:
            continue
        a[:rh, :rw] = lift(a[:rh, :rw], sw, x0 % 2)
        a[:rh, :rw] = lift(a[:rh, :rw].T, sh, y0 % 2).T


def idwt53_py(a: np.ndarray, bounds: np.ndarray) -> None:
    """The inverse 5/3 wavelet of a tile-component in place (int32
    ``a``, its bands where openjpeg keeps them), resolution by
    resolution (``bounds``: each one's x0, y0, x1, y1), rows then
    columns: the plain version of ``_native.j2k_idwt53``."""
    _idwt_py(a, bounds.tolist(), _lift53)


def idwt97_py(a: np.ndarray, bounds: np.ndarray) -> None:
    """:func:`idwt53_py` for the 9/7 wavelet on float32 ``a``."""
    _idwt_py(a, bounds.tolist(), _lift97)


# -- a tile -------------------------------------------------------------------


def _lap(times: Optional[dict], stage: str, t0: float) -> float:
    """Add the seconds since ``t0`` to ``times[stage]``; now."""
    now = time.perf_counter()
    if times is not None:
        times[stage] = times.get(stage, 0.0) + now - t0
    return now


def _decode_tile(m: _Main, index: int, data: bytes,
                 times: Optional[dict] = None) -> List[np.ndarray]:
    """The components of tile ``index`` after the wavelet, the component
    transform, the DC shift and the clamp (int32, ``(h, w)`` each); the
    seconds of each stage added to ``times``."""
    t0 = time.perf_counter()
    p, q = index % m.tw, index // m.tw
    tx0 = max(m.tx0 + p * m.tdx, m.x0)
    ty0 = max(m.ty0 + q * m.tdy, m.y0)
    tx1 = min(m.tx0 + (p + 1) * m.tdx, m.x1)
    ty1 = min(m.ty0 + (q + 1) * m.tdy, m.y1)
    tile = (tx0, ty0, tx1, ty1)
    comps = [_tile_comp(tile, c, st) for c, st in zip(m.comps, m.styles)]
    pos = 0
    for l, r, c, prc in _packet_order(m.order, m.layers, tile, comps):
        pos = _read_packet(data, pos, l, comps[c][r], prc)
    t0 = _lap(times, "tier2", t0)
    out = []
    for comp, st, res in zip(m.comps, m.styles, comps):
        w, h = tx1 - tx0, ty1 - ty0
        coef = np.zeros(h * w, np.int32)
        blocks, segs, chunks = [], [], []
        nbytes = 0
        for r, rr in enumerate(res):
            for band in rr.bands:
                if band.empty:
                    continue
                xo = yo = 0
                if band.bandno & 1:
                    xo = res[r - 1].x1 - res[r - 1].x0
                if band.bandno & 2:
                    yo = res[r - 1].y1 - res[r - 1].y0
                for prc in band.precincts:
                    for cb in prc[2]:
                        cw, chh = cb.x1 - cb.x0, cb.y1 - cb.y0
                        if cw <= 0 or chh <= 0 or not cb.segs:
                            continue
                        first = len(segs)
                        for passes, parts in cb.segs:
                            blob = b"".join(parts)
                            segs.append((nbytes, len(blob), passes))
                            chunks.append(blob)
                            nbytes += len(blob)
                        off = (cb.y0 - band.y0 + yo) * w + cb.x0 - band.x0 + xo
                        blocks.append((off, cw, chh, w, band.bandno,
                                       cb.numbps % 2**32, first,
                                       len(segs) - first))
        blocks = np.array(blocks, np.int64).reshape(-1, 8)
        segs = np.array(segs, np.int64).reshape(-1, 3)
        blob = b"".join(chunks)
        rc = _native.j2k_t1(blob, blocks, segs, coef)
        if rc is None:
            rc = t1_decode_py(blob, blocks, segs, coef)
        if rc != 0:
            raise _Broken("unsupported bpno_plus_one = 31 or more")
        t0 = _lap(times, "tier1", t0)
        coef = coef.reshape(h, w)
        bounds = np.array([(rr.x0, rr.y0, rr.x1, rr.y1) for rr in res],
                          np.int64)
        if st.qmfbid == 1:
            coef = (coef + (coef < 0)) >> 1
            if _native.j2k_idwt(coef, bounds) is None:
                idwt53_py(coef, bounds)
        else:
            steps = np.zeros((h, w), np.float32)
            for r, rr in enumerate(res):
                for band in rr.bands:
                    if band.empty:
                        continue
                    xo = res[r - 1].x1 - res[r - 1].x0 if band.bandno & 1 \
                        else 0
                    yo = res[r - 1].y1 - res[r - 1].y0 if band.bandno & 2 \
                        else 0
                    steps[yo : yo + band.y1 - band.y0,
                          xo : xo + band.x1 - band.x0] = np.float32(0.5) * \
                        band.step
            coef = coef.astype(np.float32) * steps
            if _native.j2k_idwt(coef, bounds) is None:
                idwt97_py(coef, bounds)
        t0 = _lap(times, "wavelet", t0)
        out.append(coef)
    if m.mct and len(out) >= 3:
        if any(len(r) != len(comps[0]) for r in comps[1:3]):
            raise _Broken("Tiles don't all have the same dimension")
        if {st.qmfbid for st in m.styles[:3]} != {m.styles[0].qmfbid}:
            raise _refuse("a component transform over components of "
                          "different wavelets")
        y, u, v = out[:3]
        if m.styles[0].qmfbid == 1:
            g = y - ((u + v) >> 2)
            out[:3] = [v + g, g, u + g]
        else:
            out[:3] = [y + v * np.float32(1.402),
                       y - u * np.float32(0.34413) - v * np.float32(0.71414),
                       y + u * np.float32(1.772)]
    shifted = []
    for comp, st, x in zip(m.comps, m.styles, out):
        lo = -(1 << (comp.prec - 1)) if comp.sgnd else 0
        hi = (1 << (comp.prec - 1)) - 1 if comp.sgnd else (1 << comp.prec) - 1
        dc = 0 if comp.sgnd else 1 << (comp.prec - 1)
        if st.qmfbid == 1:  # openjpeg's int32 sum
            v = x + np.int32(dc)
        else:  # lrintf, then the shift: exact wherever it is not clamped
            v = np.rint(x) + np.float32(dc)
            v[np.isnan(v)] = lo
        shifted.append(np.clip(v, lo, hi).astype(np.int32))
    _lap(times, "rest", t0)
    return shifted


# -- Pillow's unpack ----------------------------------------------------------

# (mode, colour space, components) -> Pillow's unpacker
_UNPACKERS = {("L", _GRAY, 1): "gray_l", ("P", _SRGB, 1): "gray_l",
              ("PA", _SRGB, 2): "graya_la", ("I;16", _GRAY, 1): "gray_i",
              ("LA", _GRAY, 2): "graya_la", ("RGB", _GRAY, 1): "gray_rgb",
              ("RGB", _GRAY, 2): "gray_rgb", ("RGB", _SRGB, 3): "srgb_rgb",
              ("RGB", _SRGB, 4): "srgb_rgb", ("RGBA", _GRAY, 1): "gray_rgb",
              ("RGBA", _GRAY, 2): "graya_la", ("RGBA", _SRGB, 3): "srgb_rgb",
              ("RGBA", _SRGB, 4): "srgba_rgba",
              ("RGBA", _GRAY, 4): "srgba_rgba",
              ("CMYK", _CMYK, 4): "srgba_rgba"}
_YCC = {("RGB", _SYCC, 3), ("RGB", _SYCC, 4), ("RGBA", _SYCC, 3),
        ("RGBA", _SYCC, 4)}


def _unpacker(mode: str, space: int, nc: int) -> str:
    """Pillow's unpacker of ``nc`` components in colour space ``space``
    into ``mode``: "broken" where it has none, as Pillow finds before it
    decodes a tile; sYCC (through Pillow's YCbCr tables) refused."""
    if (mode, space, nc) in _YCC:
        raise _refuse("an sYCC JP2 file")
    kind = _UNPACKERS.get((mode, space, nc))
    if kind is None:
        raise _Broken("no unpacker for this mode and colour space")
    return kind


def _to_bits(v: np.ndarray, comp: _Comp, bits: int) -> np.ndarray:
    """``j2ku_shift(offset + word, shift)`` of Pillow's unpackers: the
    stored sample (the component's value in its 1, 2 or 4 bytes, read
    unsigned) to ``bits`` bits, in C's unsigned arithmetic (which, for
    components of at most 16 bits, never leaves int32)."""
    word = v & ((1 << (8 * ((comp.prec + 7) >> 3))) - 1)
    shift = bits - comp.prec
    offset = 1 << (comp.prec - 1) if comp.sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    x = word + np.int32(offset) if offset else word
    x = x << shift if shift > 0 else x >> -shift if shift < 0 else x
    return x & ((1 << bits) - 1)


def _unpack(kind: str, mode: str, m: _Main, planes: List[np.ndarray]
            ) -> np.ndarray:
    c = m.comps
    if kind == "gray_i":
        return _to_bits(planes[0], c[0], 16).astype(np.uint16)
    if kind == "gray_l":
        return _to_bits(planes[0], c[0], 8).astype(np.uint8)
    if kind == "gray_rgb":
        g = _to_bits(planes[0], c[0], 8)
        bands = [g, g, g, np.full_like(g, 255)]
    elif kind == "graya_la":
        g = _to_bits(planes[0], c[0], 8)
        bands = [g, g, g, _to_bits(planes[1], c[1], 8)]
    elif kind == "srgb_rgb":
        bands = [_to_bits(planes[k], c[k], 8) for k in range(3)]
        bands.append(np.full_like(bands[0], 255))
    else:
        bands = [_to_bits(planes[k], c[k], 8) for k in range(4)]
    keep = {"LA": (0, 3), "PA": (0, 3), "RGB": (0, 1, 2)}.get(
        mode, (0, 1, 2, 3))
    return np.stack([bands[k] for k in keep], -1).astype(np.uint8)


# -- the whole file -----------------------------------------------------------


def load(data: bytes, hdr: J2kHeader, times: Optional[dict] = None
         ) -> np.ndarray:
    """The pixels of a JPEG 2000 file whose header :func:`open_header`
    read, as ``np.asarray`` of PIL's image gives them (``OSError`` where
    PIL's decoder reports the stream broken).  Where ``times`` is a dict,
    the seconds of each stage are added to it: ``tier2`` (the markers and
    the packet headers), ``tier1``, ``wavelet`` (with the dequantization)
    and ``rest`` (the component transform, the DC shift, the unpack)."""
    t0 = time.perf_counter()
    try:
        space = _UNSPECIFIED
        cs = data
        ihdr = None
        if hdr.codec == "jp2":
            start, jp2 = _jp2_boxes(data)
            cs = data[start:]
            ihdr = jp2.ihdr
            space = _ENUMCS.get(jp2.enumcs, _UNSPECIFIED)
        m, tiles = _read_codestream(cs)
        _lap(times, "tier2", t0)
        if ihdr is not None and (ihdr[1], ihdr[0]) != (m.x1 - m.x0,
                                                        m.y1 - m.y0):
            raise _Broken("Error with SIZ marker: IHDR w, h vs. SIZ w, h")
        nc = len(m.comps)
        if not 1 <= nc <= 4:
            raise _Broken("unsupported number of components")
        if any(c.dx != 1 or c.dy != 1 for c in m.comps):
            raise _refuse("subsampled components")
        if any(c.prec > 16 for c in m.comps):
            raise _refuse("components of more than 16 bits")
        if any(st.cblksty for st in m.styles):
            styles = sorted({st.cblksty for st in m.styles})
            raise _refuse(f"code-block style {styles} (bypass, resets, "
                          "termination, causal contexts, segmentation "
                          "symbols or HT)")
        if space == _UNSPECIFIED:
            space = _GRAY if nc <= 2 else _SRGB
        w, h = m.x1 - m.x0, m.y1 - m.y0
        if (hdr.width, hdr.height) != (w, h):
            raise _Broken("the tiles lie outside PIL's image")
        kind = _unpacker(hdr.mode, space, nc)
        planes = [np.zeros((h, w), np.int32) for _ in range(nc)]
        for index in sorted(tiles):
            tile = _decode_tile(m, index, tiles[index], times)
            t0 = time.perf_counter()
            p, q = index % m.tw, index // m.tw
            x0 = max(m.tx0 + p * m.tdx, m.x0) - m.x0
            y0 = max(m.ty0 + q * m.tdy, m.y0) - m.y0
            for plane, t in zip(planes, tile):
                plane[y0 : y0 + t.shape[0], x0 : x0 + t.shape[1]] = t
            _lap(times, "rest", t0)
        t0 = time.perf_counter()
        px = _unpack(kind, hdr.mode, m, planes)
        _lap(times, "rest", t0)
        return px
    except _Broken:
        raise OSError(BROKEN) from None


def read_frame(data: bytes, index: int = 0) -> np.ndarray:
    """Frame ``index`` of a JPEG 2000 file's bytes, as PIL's
    ``Image.open``, ``seek`` and ``np.asarray`` give it: the header
    first (with the decompression-bomb check), then ``EOFError`` past
    frame 0, then the pixels."""
    hdr = open_header(data)
    _pil.bomb_check(hdr.width, hdr.height)
    if index != 0:
        raise EOFError("no more images in file")
    return load(data, hdr)
