"""An 8-bit JPEG decoder in numpy and the standard library: the port's
counterpart of PIL's decode of CZI JPEG sub-blocks
(``unmicst_tpu/io/czi.py:177-207``), of the JPEG-compressed TIFF pages
the JAX package reads through PIL (``unmicst_tpu/io/tiff.py:1274-1291``,
``io/slides.py:66-97``; :mod:`unmicst_tpu_torch.io.tiff`) and of JPEG
and MPO files (:mod:`unmicst_tpu_torch.io.mpo`) in ``utils/imtools.imread``
and under a TIFF name.

What it decodes (ITU T.81):

* SOF0 baseline and SOF1 extended sequential, SOF2 progressive (DC first
  and refine, interleaved or not; AC first with end-of-band runs, AC
  refine), all Huffman coded, 8-bit samples;
* SOF9 sequential and SOF10 progressive frames, arithmetic coded (Annex
  D's QM decoder, with DAC conditioning), as libjpeg-turbo's
  ``jdarith.c`` decodes them, its quiet recovery from bad data included
  (see :func:`arith_scan_py`);
* SOF3 lossless frames, Huffman coded: predictors 1-7, any point
  transform, restart intervals of whole rows, one component or three
  (RGB; libjpeg-turbo converts no lossless YCbCr), sampled 1x1;
* gray frames (one component) and colour frames (three components) at
  every integral sampling libjpeg-turbo upsamples: h2v1, h1v2 and h2v2
  "fancy", the other factors by replication;
* SOI, APPn (JFIF and Adobe read for the colour space), COM, JPGn
  (skipped), DQT (8- and 16-bit tables), DHT, DRI, SOS, RST0-7 and EOI;
* abbreviated streams whose tables came before, in a tables-only stream
  (:func:`parse_tables`; a TIFF's ``JPEGTables``, tag 347).

Everything else raises ``ValueError`` naming the marker: SOF5-7 and
DHP/EXP (hierarchical), SOF11 and SOF13-15 (arithmetic lossless and
hierarchical, which libjpeg-turbo refuses too), DNL, 12-bit samples,
frames of 2 or 4 components and fractional samplings.  A stream cut short
anywhere, EOI included, raises as PIL does.

PIL hands a JPEG file to libjpeg in reads of 65536 bytes
(``ImageFile.MAXBLOCK``), and libjpeg's arithmetic decoder cannot wait for
the next read: a scan whose decode needs a byte past the read that holds
its SOS header makes PIL raise "broken data stream".  ``feed`` (at
:data:`PIL_FEED` for a file PIL opens) makes the decode refuse such a
scan as PIL does; libtiff hands a TIFF page's strip or tile over whole,
so a JPEG-compressed page has no such limit.

The decode follows libjpeg: canonical Huffman codes from BITS/HUFFVAL,
byte stuffing undone, DC predictors and the end-of-band run reset at each
restart marker, coefficients kept as int16 in natural order, then the
dequantise and the integer "islow" inverse DCT of IJG ``jidctint.c``
(13-bit constants, 2 pass-1 bits) over all blocks at once, the samples
saturated as libjpeg-turbo's SIMD version saturates them (its 16-bit
lanes, where corrupt coefficients overflow them: :func:`idct_islow`);
colour frames then take ``jdsample.c``'s fancy (triangle)
upsampling and ``jdcolor.c``'s fixed-point YCbCr to RGB tables.  That is
what libjpeg-turbo runs under PIL.

Each scan's entropy decode runs in the port's native host library
(``io/_native.py``, ``native/jpegdec.cpp``) when it loads, and otherwise
in :func:`decode_scan_py` (arithmetic: :func:`arith_scan_py`; lossless:
:func:`lossless_scan_py`, and the predictor's :func:`undifference_py`),
the plain versions that the tests
hold the native ones to: both give the same coefficients or samples bit
for bit, and fail on the same inputs.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from unmicst_tpu_torch.io import _native

# the zigzag scan position -> natural (row-major) index, with libjpeg's 16
# extra entries so that a corrupt run past 63 lands on 63, never outside
NATURAL_ORDER = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
) + (63,) * 16

# the markers this decoder refuses, by name
_REFUSED = {
    0xC5: "SOF5 (hierarchical)", 0xC6: "SOF6 (hierarchical)",
    0xC7: "SOF7 (hierarchical)", 0xC8: "JPG (reserved)",
    0xCB: "SOF11 (arithmetic coding)", 0xCD: "SOF13 (arithmetic coding)",
    0xCE: "SOF14 (arithmetic coding)", 0xCF: "SOF15 (arithmetic coding)",
    0xDC: "DNL",
    0xDE: "DHP (hierarchical)", 0xDF: "EXP (hierarchical)",
}
# the largest plane decoded without a caller-given shape (a standalone
# file): the 16-bit SOF fields allow 65535^2, far beyond any real JPEG
_MAX_PIXELS = 1 << 30
# blocks per pass of the inverse DCT: about 20 int64 temporaries of this
# many coefficients bound its memory
_IDCT_CHUNK = 1 << 14
# the bytes PIL reads from a JPEG file per call of its decoder
# (``ImageFile.MAXBLOCK``)
PIL_FEED = 65536
_SOFS = (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA)


class JpegError(ValueError):
    """A JPEG stream this decoder cannot decode (corrupt, truncated or
    outside what it supports)."""


@dataclasses.dataclass(frozen=True)
class HuffTable:
    bits: bytes  # BITS: the count of codes of each length 1..16
    values: bytes  # HUFFVAL, in code order


@dataclasses.dataclass
class Tables:
    """The quantisation and Huffman tables defined so far, by slot; an
    abbreviated stream starts from those of a tables-only stream, as
    libjpeg keeps them from one stream to the next."""

    q: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    dc: Dict[int, HuffTable] = dataclasses.field(default_factory=dict)
    ac: Dict[int, HuffTable] = dataclasses.field(default_factory=dict)

    def copy(self) -> "Tables":
        return Tables(dict(self.q), dict(self.dc), dict(self.ac))


@dataclasses.dataclass
class Component:
    cid: int
    h: int  # sampling factors
    v: int
    tq: int  # quantisation table slot
    qtable: Optional[np.ndarray] = None  # latched at its first scan


@dataclasses.dataclass
class Scan:
    """One SOS: where its entropy-coded data starts and its parameters;
    ``comps`` are frame component indices in scan order, ``dc`` and ``ac``
    the tables of each (None where the scan needs none)."""

    pos: int
    comps: Tuple[int, ...]
    dc: Tuple[Optional[HuffTable], ...]
    ac: Tuple[Optional[HuffTable], ...]
    ss: int
    se: int
    ah: int
    al: int
    restart_interval: int  # in MCUs
    # arithmetic coding: each scan component's (DC table, AC table, L, U,
    # Kx), the conditioning in force at the SOS (DAC's or T.81's default)
    cond: Optional[Tuple[Tuple[int, int, int, int, int], ...]] = None


@dataclasses.dataclass
class Frame:
    height: int
    width: int
    progressive: bool
    components: List[Component]
    colour: str = "gray"  # "gray", "ycbcr" or "rgb"
    lossless: bool = False  # SOF3: predicted samples, no DCT
    arith: bool = False  # SOF9 / SOF10: arithmetic-coded scans

    @property
    def hmax(self) -> int:
        return max(c.h for c in self.components)

    @property
    def vmax(self) -> int:
        return max(c.v for c in self.components)

    @property
    def mcus(self) -> Tuple[int, int]:
        """MCU rows and columns of an interleaved scan."""
        return (-(-self.height // (8 * self.vmax)),
                -(-self.width // (8 * self.hmax)))

    def grid(self, i: int) -> Tuple[int, int]:
        """Component ``i``'s coefficient blocks, rows and columns, padded
        to whole MCUs."""
        c, (mr, mc) = self.components[i], self.mcus
        return mr * c.v, mc * c.h

    def size(self, i: int) -> Tuple[int, int]:
        """Component ``i``'s samples, rows and columns (libjpeg's
        ``downsampled_height`` / ``downsampled_width``)."""
        c = self.components[i]
        return (-(-self.height * c.v // self.vmax),
                -(-self.width * c.h // self.hmax))

    @property
    def offsets(self) -> List[int]:
        """The first coefficient block of each component."""
        out = [0]
        for i in range(len(self.components)):
            bh, bw = self.grid(i)
            out.append(out[-1] + bh * bw)
        return out


def _u16(data: bytes, pos: int) -> int:
    if pos + 2 > len(data):
        raise JpegError("truncated JPEG marker segment")
    return (data[pos] << 8) | data[pos + 1]


def _segment(data: bytes, pos: int) -> bytes:
    """The payload of the length-prefixed marker segment at ``pos``."""
    n = _u16(data, pos)
    if n < 2 or pos + n > len(data):
        raise JpegError("truncated JPEG marker segment")
    return data[pos + 2 : pos + n]


def _next_marker(data: bytes, pos: int) -> int:
    """Offset of the 0xFF of the next marker at or after ``pos``, skipping
    stuffed bytes, fill bytes and (as libjpeg does, with a warning)
    extraneous data."""
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            raise JpegError("truncated JPEG stream (no EOI)")
        if data[pos + 1] == 0x00:
            pos += 2
        elif data[pos + 1] == 0xFF:
            pos += 1
        else:
            return pos


def _data_end(data: bytes, pos: int) -> int:
    """The end of the entropy-coded bytes from ``pos``: the first 0xFF
    not followed by a stuffed 0x00 (or the end of the stream)."""
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0:
            return len(data)
        if pos + 1 < len(data) and data[pos + 1] == 0x00:
            pos += 2
        else:
            return pos


def _parse_dqt(body: bytes, tables: Dict[int, np.ndarray]) -> None:
    p = 0
    while p < len(body):
        pq, tq = body[p] >> 4, body[p] & 15
        size = 128 if pq else 64
        if pq > 1 or tq > 3 or p + 1 + size > len(body):
            raise JpegError("corrupt JPEG DQT segment")
        raw = np.frombuffer(body, ">u2" if pq else np.uint8, 64, p + 1)
        q = np.zeros(64, np.int64)
        # libjpeg keeps the quantisers as 16-bit signed multipliers
        q[list(NATURAL_ORDER[:64])] = raw.astype(np.int64)
        tables[tq] = q.astype(np.int16).astype(np.int64)
        p += 1 + size


def _parse_dht(body: bytes, dc: Dict[int, HuffTable],
               ac: Dict[int, HuffTable]) -> None:
    p = 0
    while p < len(body):
        if p + 17 > len(body):
            raise JpegError("corrupt JPEG DHT segment")
        tc, th = body[p] >> 4, body[p] & 15
        bits = body[p + 1 : p + 17]
        count = sum(bits)
        if tc > 1 or th > 3 or count > 256 or p + 17 + count > len(body):
            raise JpegError("corrupt JPEG DHT segment")
        table = HuffTable(bytes(bits), bytes(body[p + 17 : p + 17 + count]))
        huffman_codes(table)  # validates the code lengths
        (ac if tc else dc)[th] = table
        p += 17 + count


def huffman_codes(table: HuffTable) -> List[Tuple[int, int, int]]:
    """Canonical codes (Annex C): ``(code, length, symbol)`` in order; a
    table whose codes overflow their length (or use the all-ones code)
    raises, as libjpeg's ``jpeg_make_d_derived_tbl`` does."""
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(table.bits[length - 1]):
            out.append((code, length, table.values[k]))
            code, k = code + 1, k + 1
        if table.bits[length - 1] and code >= 1 << length:
            raise JpegError("corrupt JPEG Huffman table")
        code <<= 1
    return out


_MAX_BLOCKS_IN_MCU = 10  # libjpeg's D_MAX_BLOCKS_IN_MCU


def _refuse_components(nc: int):
    raise JpegError(f"JPEG frame has {nc} components; only gray (1) and "
                    "colour (3) are supported")


def _parse_sof(body: bytes, m: int, shape) -> Frame:
    if len(body) < 6:
        raise JpegError("corrupt JPEG SOF segment")
    prec, h, w, nc = struct.unpack_from(">BHHB", body)
    if prec != 8:
        raise JpegError(f"{prec}-bit JPEG samples are not supported "
                        "(8-bit only)")
    if h == 0:
        raise JpegError("JPEG height defined by DNL is not supported")
    if nc not in (1, 3, 4):
        _refuse_components(nc)
    if w == 0 or len(body) != 6 + 3 * nc:
        raise JpegError("corrupt JPEG SOF segment")
    if shape is not None and (h, w) != tuple(shape):
        raise JpegError(f"JPEG frame is {(h, w)}, expected {tuple(shape)}")
    if shape is None and h * w > _MAX_PIXELS:
        raise JpegError(f"implausible JPEG frame {h}x{w}")
    comps = []
    for k in range(nc):
        cid, hv, tq = body[6 + 3 * k : 9 + 3 * k]
        if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4) or tq > 3 \
                or any(c.cid == cid for c in comps):
            raise JpegError("corrupt JPEG SOF segment")
        # a lone component's sampling factors do not matter (libjpeg)
        comps.append(Component(cid, hv >> 4 if nc > 1 else 1,
                               hv & 15 if nc > 1 else 1, tq))
    frame = Frame(h, w, m in (0xC2, 0xCA), comps, lossless=m == 0xC3,
                  arith=m in (0xC9, 0xCA))
    if frame.lossless:
        if frame.hmax > 1 or frame.vmax > 1:  # libjpeg-turbo reads them
            raise NotImplementedError(
                "lossless JPEG colour frames sampled "
                f"{'/'.join(f'{x.h}x{x.v}' for x in comps)} are not "
                "read by unmicst_tpu_torch (1x1 only; ROADMAP M17)")
        return frame
    for c in comps:  # libjpeg upsamples by integral factors only
        if frame.hmax % c.h or frame.vmax % c.v:
            raise JpegError(
                "JPEG sampling factors "
                f"{'/'.join(f'{x.h}x{x.v}' for x in comps)} need fractional "
                "upsampling, which libjpeg does not implement")
    return frame


def _colour_space(nc: int, jfif: bool, adobe: Optional[int],
                  ids: List[int], lossless: bool = False) -> str:
    """libjpeg-turbo's ``default_decompress_parms`` for 1, 3 and 4
    components: without a JFIF or Adobe marker a lossless frame is RGB;
    four components are CMYK, or YCCK where an Adobe marker's transform
    is not 0."""
    if nc == 1:
        return "gray"
    if nc == 4:
        return "ycck" if adobe not in (None, 0) else "cmyk"
    if jfif:
        return "ycbcr"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycbcr"
    if lossless or ids == [82, 71, 66]:  # 'R', 'G', 'B'
        return "rgb"
    return "ycbcr"


def _walk(data: bytes, tables: Tables, shape=None, tables_only=False):
    """Walk the markers of one stream from SOI to EOI, defining tables
    into ``tables``: ``(frame, scans)``, or ``(None, [])`` for a
    tables-only stream."""
    if len(data) < 2 or data[0] != 0xFF or data[1] != 0xD8:
        raise JpegError("not a JPEG stream (no SOI)")
    frame: Optional[Frame] = None
    scans: List[Scan] = []
    restart = 0
    jfif, adobe = False, None
    cond = ([0] * 16, [1] * 16, [5] * 16)  # L, U, Kx; SOI's defaults
    pos = 2
    while True:
        pos = _next_marker(data, pos)
        m = data[pos + 1]
        pos += 2
        if m == 0xD9:  # EOI
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:  # stray RSTn, TEM: no payload
            continue
        if m in _REFUSED:
            raise JpegError(f"JPEG marker {_REFUSED[m]} is not supported")
        if m == 0xD8:
            raise JpegError("corrupt JPEG stream: a second SOI")
        body = _segment(data, pos)
        end = pos + 2 + len(body)
        if tables_only and m in _SOFS + (0xDA,):
            raise JpegError("JPEG tables stream holds an image")
        if m in _SOFS:
            if frame is not None:
                raise JpegError("corrupt JPEG stream: a second frame")
            frame = _parse_sof(body, m, shape)
        elif m == 0xC4:
            _parse_dht(body, tables.dc, tables.ac)
        elif m == 0xDB:
            _parse_dqt(body, tables.q)
        elif m == 0xDD:
            if len(body) < 2:
                raise JpegError("corrupt JPEG DRI segment")
            restart = _u16(body, 0)
        elif m == 0xDA:
            if frame is None:
                raise JpegError("corrupt JPEG stream: SOS before SOF")
            if not scans:
                frame.colour = _colour_space(
                    len(frame.components), jfif, adobe,
                    [c.cid for c in frame.components], frame.lossless)
            scans.append(_parse_sos(body, end, frame, tables, restart, cond))
            end = _scan_end(data, end)
        elif m == 0xCC:
            _parse_dac(body, cond)
        elif m == 0xE0:
            jfif = jfif or (len(body) >= 14 and body[:5] == b"JFIF\0")
        elif m == 0xEE:
            if len(body) >= 12 and body[:5] == b"Adobe":
                adobe = body[11]
        elif 0xE1 <= m <= 0xEF or m == 0xFE or 0xF0 <= m <= 0xFD:
            pass  # APPn, COM, JPGn
        else:
            raise JpegError(f"unknown JPEG marker 0x{m:02X}")
        pos = end
    if tables_only:
        return None, []
    if frame is None or not scans:
        raise JpegError("JPEG stream holds no image")
    return frame, scans


def _parse_dac(body: bytes, cond) -> None:
    """A DAC segment into ``cond`` (L, U and Kx of the 16 tables), as
    libjpeg's ``get_dac``: DC tables 0-15 take ``U << 4 | L`` (L <= U),
    AC tables 16-31 their Kx."""
    if len(body) % 2:
        raise JpegError("corrupt JPEG DAC segment: odd length")
    for p in range(0, len(body), 2):
        index, val = body[p], body[p + 1]
        if index >= 32:
            raise JpegError(f"corrupt JPEG DAC segment: table {index}")
        if index >= 16:
            cond[2][index - 16] = val
        elif val & 15 > val >> 4:
            raise JpegError(f"corrupt JPEG DAC segment: L {val & 15} above "
                            f"U {val >> 4}")
        else:
            cond[0][index], cond[1][index] = val & 15, val >> 4


def _parse_sos(body: bytes, pos: int, frame: Frame, tables: Tables,
               restart: int, cond=None) -> Scan:
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
        raise JpegError("corrupt JPEG SOS segment")
    comps, sel = [], []
    for k in range(ns):
        cs, t = body[1 + 2 * k], body[2 + 2 * k]
        idx = [i for i, c in enumerate(frame.components) if c.cid == cs]
        if not idx or idx[0] in comps:
            raise JpegError("corrupt JPEG SOS segment: a component the "
                            "frame lacks, or twice")
        comps.append(idx[0])
        sel.append((t >> 4, t & 15))
    ss, se = body[1 + 2 * ns], body[2 + 2 * ns]
    ah, al = body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15
    if frame.lossless:  # ss is the predictor, al the point transform
        if not 1 <= ss <= 7 or se or ah or al >= 8:
            raise JpegError(
                f"SOF3 (lossless) scan with predictor {ss}, Se {se}, Ah {ah}"
                f", Al {al}: libjpeg-turbo takes predictors 1-7, Se 0, Ah 0 "
                "and Al 0-7")
        if any(tables.dc.get(td) is None for td, _ in sel):
            raise JpegError("JPEG Huffman table missing")
        dcs = tuple(tables.dc[td] for td, _ in sel)
        if any(v > 16 for t in dcs for v in t.values):
            raise JpegError("corrupt JPEG DHT segment: lossless symbol "
                            "above 16")
        return Scan(pos, tuple(comps), dcs, (None,) * ns, ss, se, ah, al,
                    restart)
    if frame.progressive:
        bad = (se != 0) if ss == 0 else (ss > se or se > 63 or ns != 1)
        if bad or (ah and al != ah - 1) or al > 13:
            raise JpegError("corrupt JPEG progression parameters")
    else:
        ss, se, ah, al = 0, 63, 0, 0
    if ns > 1 and sum(frame.components[i].h * frame.components[i].v
                      for i in comps) > _MAX_BLOCKS_IN_MCU:
        raise JpegError("corrupt JPEG SOS segment: too many blocks in an MCU")
    for i in comps:  # libjpeg latches a table at the component's first scan
        c = frame.components[i]
        if c.qtable is None:
            if c.tq not in tables.q:
                raise JpegError("JPEG quantisation table missing")
            c.qtable = tables.q[c.tq]
    if frame.arith:  # 16 conditioning tables, each with its defaults
        return Scan(pos, tuple(comps), (None,) * ns, (None,) * ns, ss, se,
                    ah, al, restart, tuple(
                        (td, ta, cond[0][td], cond[1][td], cond[2][ta])
                        for td, ta in sel))
    need_dc = ss == 0 and ah == 0
    need_ac = ss > 0 or not frame.progressive
    if any((need_dc and td not in tables.dc)
           or (need_ac and ta not in tables.ac) for td, ta in sel):
        raise JpegError("JPEG Huffman table missing")
    if need_dc and any(v > 15 for td, _ in sel for v in tables.dc[td].values):
        raise JpegError("corrupt JPEG DHT segment: DC symbol above 15")
    return Scan(pos, tuple(comps),
                tuple(tables.dc[td] if need_dc else None for td, _ in sel),
                tuple(tables.ac[ta] if need_ac else None for _, ta in sel),
                ss, se, ah, al, restart)


def parse_tables(data: bytes) -> Tables:
    """The tables of a tables-only stream (SOI, DQT/DHT, EOI): what a
    TIFF's ``JPEGTables`` holds for its abbreviated segments."""
    tables = Tables()
    _walk(bytes(data), tables, tables_only=True)
    return tables


def parse(data: bytes, shape: Optional[Tuple[int, int]] = None,
          tables: Optional[Tables] = None):
    """Parse the marker structure: ``(frame, scans)``, of 1, 3 or 4
    (CMYK or YCCK) components.

    ``shape`` is the (height, width) the caller expects (a CZI
    directory's); a frame of another size raises before any buffer is
    allocated.  Without it, frames above 2**30 pixels raise.  ``tables``:
    the tables an abbreviated stream starts from (:func:`parse_tables`);
    the stream's own override them, for this stream only."""
    start = Tables() if tables is None else tables.copy()
    return _walk(data, start, shape)


def _scan_end(data: bytes, pos: int) -> int:
    """Where the marker after a scan's entropy-coded data starts: the
    first marker that is not a restart marker."""
    while True:
        pos = _next_marker(data, pos)
        if not 0xD0 <= data[pos + 1] <= 0xD7:
            return pos
        pos += 2


def scan_blocks(frame: Frame, scan: Scan):
    """The blocks a scan visits, in order: ``(order, slots, per_mcu)``,
    the coefficient rows (int64), the scan component of each (uint8) and
    the blocks of one MCU.  A one-component scan visits its component's
    blocks that hold samples, row by row; an interleaved one visits the
    MCUs, each component's ``v x h`` blocks in turn (T.81 A.2)."""
    offs = frame.offsets
    if len(scan.comps) == 1:
        i = scan.comps[0]
        ch, cw = frame.size(i)
        bw = frame.grid(i)[1]
        rows, cols = -(-ch // 8), -(-cw // 8)
        order = offs[i] + (np.arange(rows, dtype=np.int64)[:, None] * bw
                           + np.arange(cols, dtype=np.int64)).ravel()
        return order, np.zeros(len(order), np.uint8), 1
    mr, mc = frame.mcus
    parts, slots = [], []
    for k, i in enumerate(scan.comps):
        c, bw = frame.components[i], frame.grid(i)[1]
        by, bx = (a.ravel() for a in np.mgrid[: c.v, : c.h])
        rows = np.arange(mr, dtype=np.int64)[:, None, None] * c.v + by
        cols = np.arange(mc, dtype=np.int64)[None, :, None] * c.h + bx
        parts.append(offs[i] + rows * bw + cols)
        slots.append(np.full(c.v * c.h, k, np.uint8))
    per_mcu = sum(len(s) for s in slots)
    order = np.concatenate(parts, axis=2).ravel()
    return order, np.tile(np.concatenate(slots), mr * mc), per_mcu


# -- the entropy decode, in Python (the plain version) -------------------------


class _Bits:
    """Bit reader over one restart interval's unstuffed bytes: ``symbol``
    looks 16 bits ahead, zeros past the end (libjpeg's lookahead); it and
    ``take`` raise when the bits a code needs are not there."""

    def __init__(self, data: bytes, pos: int):
        self.end = _data_end(data, pos)  # the 0xFF after the interval
        raw = data[pos : self.end].replace(b"\xff\x00", b"\xff")
        bits = np.unpackbits(np.frombuffer(raw, np.uint8))
        self.bits = bits.tobytes().translate(_TO_ASCII) + b"0" * 16
        self.n = len(raw) * 8
        self.p = 0

    def take(self, k: int) -> int:
        p = self.p
        if p + k > self.n:
            raise JpegError("JPEG entropy-coded data ends early")
        self.p = p + k
        return int(self.bits[p : p + k], 2)

    def symbol(self, lut) -> int:
        v = int(self.bits[self.p : self.p + 16], 2)
        length = lut[0][v]
        if length == 0:
            raise JpegError("corrupt JPEG Huffman code")
        if self.p + length > self.n:
            raise JpegError("JPEG entropy-coded data ends early")
        self.p += length
        return lut[1][v]


_TO_ASCII = bytes.maketrans(b"\x00\x01", b"01")


def _lut(table: HuffTable):
    """(length, symbol) of every 16-bit window, as Python lists."""
    lens = np.zeros(1 << 16, np.int64)
    syms = np.zeros(1 << 16, np.int64)
    for code, length, sym in huffman_codes(table):
        lo = code << (16 - length)
        lens[lo : lo + (1 << (16 - length))] = length
        syms[lo : lo + (1 << (16 - length))] = sym
    return lens.tolist(), syms.tolist()


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < 1 << (s - 1) else v


def _i16(v: int) -> int:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _i32(v: int) -> int:
    return ((v + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def decode_scan_py(data: bytes, frame: Frame, scan: Scan, coef: np.ndarray,
                   order: np.ndarray, slots: np.ndarray, per_mcu: int) -> int:
    """Entropy-decode one scan into ``coef`` (int16, ``[blocks, 64]`` in
    natural order, updated in place), visiting the blocks of
    :func:`scan_blocks`; returns the offset of the marker after the scan.
    The plain version of the native decoder."""
    nblocks = len(order)
    c = coef.reshape(-1).tolist()
    dcs = [_lut(t) if t is not None else None for t in scan.dc]
    acs = [_lut(t) if t is not None else None for t in scan.ac]
    bases = (np.asarray(order, np.int64) * 64).tolist()
    slot_of = np.asarray(slots).tolist()
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    p1, m1 = 1 << al, -1 << al
    nat = NATURAL_ORDER
    ri = scan.restart_interval * per_mcu or nblocks
    pos = scan.pos
    for start in range(0, nblocks, ri):
        bits = _Bits(data, pos)
        last_dc, eobrun = [0] * 4, 0
        for b in range(start, min(start + ri, nblocks)):
            base, t = bases[b], slot_of[b]
            dc, ac = dcs[t], acs[t]
            if not frame.progressive or (ss == 0 and ah == 0):
                if ss == 0 and ah == 0:  # DC (sequential, or first scan)
                    s = bits.symbol(dc)
                    if s:
                        s = _extend(bits.take(s), s)
                    last_dc[t] = _i32(last_dc[t] + s)
                    c[base] = _i16(last_dc[t] << al)
                if frame.progressive:
                    continue
                k = 1
                while k < 64:
                    rs = bits.symbol(ac)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        c[base + nat[k]] = _i16(_extend(bits.take(s), s))
                    elif r != 15:
                        break
                    else:
                        k += 15
                    k += 1
            elif ss == 0:  # DC refine
                if bits.take(1):
                    c[base] = _i16(c[base] | p1)
            elif ah == 0:  # AC first
                if eobrun > 0:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = bits.symbol(ac)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        c[base + nat[k]] = _i16(
                            _extend(bits.take(s), s) << al)
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + (bits.take(r) if r else 0) - 1
                        break
                    k += 1
            else:  # AC refine
                k = ss
                if eobrun == 0:
                    while k <= se:
                        rs = bits.symbol(ac)
                        r, s = rs >> 4, rs & 15
                        if s:
                            s = p1 if bits.take(1) else m1
                        elif r != 15:
                            eobrun = 1 << r
                            if r:
                                eobrun += bits.take(r)
                            break
                        while k <= se:
                            i = base + nat[k]
                            if c[i] != 0:
                                if bits.take(1) and (c[i] & p1) == 0:
                                    c[i] = _i16(c[i] + (p1 if c[i] >= 0
                                                        else m1))
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if s:
                            c[base + nat[k]] = _i16(s)
                        k += 1
                if eobrun > 0:
                    while k <= se:
                        i = base + nat[k]
                        if c[i] != 0 and bits.take(1) and (c[i] & p1) == 0:
                            c[i] = _i16(c[i] + (p1 if c[i] >= 0 else m1))
                        k += 1
                    eobrun -= 1
        pos = _next_marker(data, bits.end)
        m = data[pos + 1]
        last = start + ri >= nblocks
        if last and 0xD0 <= m <= 0xD7:
            raise JpegError("corrupt JPEG stream: unexpected restart marker")
        if not last:
            if m != 0xD0 + (start // ri) % 8:
                raise JpegError("corrupt JPEG stream: restart marker "
                                "missing or out of order")
            pos += 2
    coef.reshape(-1)[:] = np.asarray(c, np.int64).astype(np.int16)
    return pos


# -- arithmetic-coded scans (libjpeg-turbo's jdarith.c, jaricom.c) -----------

# jaricom.c's Table D.2, packed as Qe << 16 | Next_Index_MPS << 8 |
# Switch_MPS << 7 | Next_Index_LPS; the last entry is the fixed bin's
# (probability 0.5, never adapted)
ARITAB = (
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171,
)

_PAST_FEED = ("JPEG arithmetic-coded scan needs data past the 65536-byte read "
              "of the stream that holds its SOS header: libjpeg's arithmetic "
              "decoder cannot wait for the next read, and PIL raises "
              "'broken data stream'")


class _QMDecoder:
    """``jdarith.c``'s ``arith_decode`` (T.81 D.2) over one scan's data
    from ``pos``: the C and A registers and the bit counter ``ct`` (-16
    before the first two bytes, -1 once the decode gave up until the next
    restart).  At a marker it feeds zeros and leaves the marker unread
    (``unread``: its code, ``pos`` past it), as libjpeg does.  No byte at
    or past ``limit`` is read."""

    def __init__(self, data: bytes, pos: int, limit: int):
        self.data, self.limit, self.pos, self.unread = data, limit, pos, 0
        self.reset()

    def reset(self) -> None:
        self.c, self.a, self.ct = 0, 0, -16

    def _byte(self) -> int:
        p = self.pos
        if p >= self.limit:
            raise JpegError(_PAST_FEED if self.limit < len(self.data)
                            else "JPEG entropy-coded data ends early")
        self.pos = p + 1
        return self.data[p]

    def next_marker(self) -> None:
        """libjpeg's ``next_marker`` from ``pos``: extraneous bytes, fill
        bytes and stuffed zeros skipped, the marker left unread."""
        while True:
            b = self._byte()
            while b != 0xFF:
                b = self._byte()
            b = self._byte()
            while b == 0xFF:
                b = self._byte()
            if b:
                self.unread = b
                return

    def restart(self, n: int) -> None:
        """``read_restart_marker`` expecting RSTn, with
        ``jpeg_resync_to_restart`` where another marker comes: an earlier
        restart or a marker below SOF0 is skipped for the next one, the
        next two restarts and any other marker stay unread (the interval
        then decodes from zeros), any other restart is taken as RSTn."""
        if not self.unread:
            self.next_marker()
        while self.unread != 0xD0 + n:
            m = self.unread
            if 0xD0 <= m <= 0xD7:
                if (m - 0xD0 - n) % 8 in (1, 2):
                    break
                if (m - 0xD0 - n) % 8 in (6, 7):
                    self.next_marker()
                    continue
            elif m >= 0xC0:
                break
            else:
                self.next_marker()
                continue
            self.unread = 0
            break
        else:
            self.unread = 0
        self.reset()

    def end(self) -> int:
        """The offset of the marker after the scan's data."""
        return self.pos - 2 if self.unread else _next_marker(self.data,
                                                             self.pos)

    def decode(self, st, i: int) -> int:
        """One binary decision with the statistics bin ``st[i]``."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                if self.unread:
                    b = 0
                else:
                    b = self._byte()
                    if b == 0xFF:
                        b = self._byte()
                        while b == 0xFF:
                            b = self._byte()
                        if b == 0:
                            b = 0xFF
                        else:
                            self.unread, b = b, 0
                c = (c << 8) | b
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        t = ARITAB[sv & 0x7F]
        qe = t >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ ((t >> 8) & 0xFF)
            else:
                st[i] = (sv & 0x80) ^ (t & 0xFF)
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ (t & 0xFF)
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ ((t >> 8) & 0xFF)
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


class _GiveUp(Exception):
    """``jdarith.c``'s ``ct = -1``: a magnitude or spectral overflow."""


def _arith_value(dec, st, i: int, sign: int, first: int, kbins: int) -> int:
    """Figures F.23-F.24 from bin ``i`` (past the sign): the magnitude
    category, then its bits; ``first`` is 1 where the category's first
    decision is already taken (DC), ``kbins`` the bin of the further
    decisions (X1: 20 for DC, 189 or 217 for AC)."""
    m = dec(st, i)
    if m:
        if first or dec(st, i):
            if not first:
                m <<= 1
            i = kbins
            while dec(st, i):
                m <<= 1
                if m == 0x8000:
                    raise _GiveUp
                i += 1
    v = m
    i += 14
    m >>= 1
    while m:
        if dec(st, i):
            v |= m
        m >>= 1
    return -(v + 1) if sign else v + 1


def arith_scan_py(data: bytes, frame: Frame, scan: Scan, coef: np.ndarray,
                  order: np.ndarray, slots: np.ndarray, per_mcu: int,
                  limit: Optional[int] = None) -> int:
    """Decode one arithmetic-coded scan into ``coef`` (int16, ``[blocks,
    64]``, natural order, in place), visiting the blocks of
    :func:`scan_blocks`, as libjpeg-turbo's ``jdarith.c`` does: the
    statistics areas (64 DC and 256 AC bins a table, shared by the scan's
    components that name the table) and the DC contexts start at zero, and
    again at each restart marker with the decoder's registers; a
    magnitude or spectral overflow (bad data) leaves the rest of the
    restart interval's blocks as they are, where libjpeg sets ``ct = -1``;
    at a marker the decoder reads zeros, and a restart marker out of order
    is resynchronised as libjpeg does (:meth:`_QMDecoder.restart`).  No
    byte at or past ``limit``
    (default: the stream's end) is read.  Returns the offset of the marker
    after the scan.  The plain version of the native decoder."""
    limit = len(data) if limit is None else min(limit, len(data))
    c = coef.reshape(-1).tolist()
    bases = (np.asarray(order, np.int64) * 64).tolist()
    slot_of = np.asarray(slots).tolist()
    nat = NATURAL_ORDER
    prog = frame.progressive
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    dc_first = ss == 0 and ah == 0
    uses_dc, uses_ac = not prog or dc_first, not prog or ss > 0
    tds = [x[0] for x in scan.cond]
    tas = [x[1] for x in scan.cond]
    lows = [(1 << x[2]) >> 1 for x in scan.cond]
    ups = [(1 << x[3]) >> 1 for x in scan.cond]
    kxs = [x[4] for x in scan.cond]
    dc_stats: Dict[int, bytearray] = {}
    ac_stats: Dict[int, bytearray] = {}
    fixed = bytearray([113])
    last_dc, ctx = [0] * 4, [0] * 4

    def reset_stats():
        for t in tds if uses_dc else ():
            dc_stats[t] = bytearray(64)
        for t in tas if uses_ac else ():
            ac_stats[t] = bytearray(256)
        last_dc[:], ctx[:] = [0] * 4, [0] * 4

    reset_stats()
    qm = _QMDecoder(data, scan.pos, limit)
    dec = qm.decode
    p1, m1 = 1 << al, -1 << al

    def dc_block(base, t):
        st, s0 = dc_stats[tds[t]], ctx[t]
        if dec(st, s0) == 0:
            ctx[t] = 0
        else:
            sign = dec(st, s0 + 1)
            v = _arith_value(dec, st, s0 + 2 + sign, sign, 1, 20)
            m = abs(v) - 1
            m = 1 << (m.bit_length() - 1) if m else 0
            ctx[t] = 0 if m < lows[t] else (12 if m > ups[t] else 4) + 4 * sign
            last_dc[t] = (last_dc[t] + v) & 0xFFFF
        c[base] = _i16(last_dc[t] << al)

    def ac_block(base, t, k, end):
        st, kx = ac_stats[tas[t]], kxs[t]
        while k <= end:
            i = 3 * (k - 1)
            if dec(st, i):
                break
            while dec(st, i + 1) == 0:
                i += 3
                k += 1
                if k > end:
                    raise _GiveUp
            sign = dec(fixed, 0)
            v = _arith_value(dec, st, i + 2, sign, 0,
                             189 if k <= kx else 217)
            c[base + nat[k]] = _i16(v << al)
            k += 1

    def refine_block(base, t):
        st = ac_stats[tas[t]]
        kex = se
        while kex > 0 and c[base + nat[kex]] == 0:
            kex -= 1
        k = ss
        while k <= se:
            i = 3 * (k - 1)
            if k > kex and dec(st, i):
                break
            while True:
                j = base + nat[k]
                if c[j]:
                    if dec(st, i + 2):
                        c[j] = _i16(c[j] + (m1 if c[j] < 0 else p1))
                    break
                if dec(st, i + 1):
                    c[j] = _i16(m1 if dec(fixed, 0) else p1)
                    break
                i += 3
                k += 1
                if k > se:
                    raise _GiveUp
            k += 1

    ri = scan.restart_interval
    togo, rst = ri, 0
    for mcu in range(len(bases) // per_mcu):
        if ri:
            if togo == 0:
                qm.restart(rst)
                rst = (rst + 1) & 7
                reset_stats()
                togo = ri
            togo -= 1
        if qm.ct == -1:
            continue
        try:
            for b in range(mcu * per_mcu, (mcu + 1) * per_mcu):
                base, t = bases[b], slot_of[b]
                if uses_dc:
                    dc_block(base, t)
                    if not prog:
                        ac_block(base, t, 1, 63)
                elif ss == 0:  # DC refine: one bit, fixed probability
                    if dec(fixed, 0):
                        c[base] = _i16(c[base] | p1)
                elif ah == 0:
                    ac_block(base, t, ss, se)
                else:
                    refine_block(base, t)
        except _GiveUp:
            qm.ct = -1
    coef.reshape(-1)[:] = np.asarray(c, np.int64).astype(np.int16)
    return qm.end()


# -- lossless frames (libjpeg-turbo's jdlhuff.c, jdpred.c, jdlossls.c) --------


def _lossless_restart_rows(frame: Frame, scan: Scan) -> int:
    """The restart interval in sample rows (0: none); libjpeg-turbo takes
    only whole rows of MCUs."""
    ri = scan.restart_interval
    if ri and ri % frame.width:
        raise JpegError(f"SOF3 (lossless) restart interval {ri} is not a "
                        f"multiple of the {frame.width} MCUs in a row")
    return ri // frame.width


def lossless_scan_py(data: bytes, frame: Frame, scan: Scan,
                     diffs: np.ndarray) -> int:
    """Entropy-decode one lossless scan into ``diffs`` (int32, ``[scan
    components, height, width]``): each MCU holds one sample of each scan
    component, coded as its difference category (0-16; 16 is 32768) and
    the difference's bits.  Returns the offset of the marker after the
    scan.  The plain version of the native decoder."""
    ns, h, w = diffs.shape
    luts = [_lut(t) for t in scan.dc]
    out = diffs.reshape(ns, -1)
    ri = (_lossless_restart_rows(frame, scan) * w) or h * w
    pos = scan.pos
    for start in range(0, h * w, ri):
        bits = _Bits(data, pos)
        for i in range(start, min(start + ri, h * w)):
            for k in range(ns):
                s = bits.symbol(luts[k])
                if s == 16:
                    d = 32768
                elif s:
                    d = _extend(bits.take(s), s)
                else:
                    d = 0
                out[k, i] = d
        pos = _next_marker(data, bits.end)
        m = data[pos + 1]
        last = start + ri >= h * w
        if last and 0xD0 <= m <= 0xD7:
            raise JpegError("corrupt JPEG stream: unexpected restart marker")
        if not last:
            if m != 0xD0 + (start // ri) % 8:
                raise JpegError("corrupt JPEG stream: restart marker "
                                "missing or out of order")
            pos += 2
    return pos


def undifference_py(diff: np.ndarray, predictor: int, pt: int,
                    restart_rows: int) -> np.ndarray:
    """``jdpred.c`` over one component's differences (``[h, w]``): the
    first row of the scan and of each restart interval predicted from the
    left (its first sample from ``2**(7 - pt)``), each later row's first
    sample from above and the rest by ``predictor``, all modulo 2**16;
    then ``jdlossls.c``'s point transform, ``<< pt`` into the 8-bit
    sample.  ``[h, w]`` uint8.  The plain version of the native one."""
    h, w = diff.shape
    d = diff.tolist()
    out = np.empty((h, w), np.uint8)
    prev: List[int] = []
    for r in range(h):
        row, dr = [0] * w, d[r]
        if r == 0 or (restart_rows and r % restart_rows == 0):
            ra = (dr[0] + (1 << (7 - pt))) & 0xFFFF
            row[0] = ra
            for x in range(1, w):
                ra = (dr[x] + ra) & 0xFFFF
                row[x] = ra
        else:
            rb = prev[0]
            ra = (dr[0] + rb) & 0xFFFF
            row[0] = ra
            for x in range(1, w):
                rc, rb = rb, prev[x]
                if predictor == 1:
                    p = ra
                elif predictor == 2:
                    p = rb
                elif predictor == 3:
                    p = rc
                elif predictor == 4:
                    p = ra + rb - rc
                elif predictor == 5:
                    p = ra + ((rb - rc) >> 1)
                elif predictor == 6:
                    p = rb + ((ra - rc) >> 1)
                else:
                    p = (ra + rb) >> 1
                ra = (dr[x] + p) & 0xFFFF
                row[x] = ra
        out[r] = [(v << pt) & 0xFF for v in row]
        prev = row
    return out


def decode_lossless(data: bytes, frame: Frame, scans: List[Scan]
                    ) -> List[np.ndarray]:
    """The samples of a lossless frame, one ``[H, W]`` uint8 plane per
    component: each scan's differences through the native library when
    it loads (else :func:`lossless_scan_py`), then each component's
    undifferencing (:func:`undifference_py` the plain version)."""
    planes: List[Optional[np.ndarray]] = [None] * len(frame.components)
    native = _native.get_lib() is not None
    for scan in scans:
        diffs = np.zeros((len(scan.comps), frame.height, frame.width),
                         np.int32)
        rows = _lossless_restart_rows(frame, scan)
        if native:
            _native.jpeg_lossless_scan(data, scan, diffs)
        else:
            lossless_scan_py(data, frame, scan, diffs)
        for k, i in enumerate(scan.comps):
            plane = _native.jpeg_undifference(diffs[k], scan.ss, scan.al,
                                              rows)
            if plane is None:
                plane = undifference_py(diffs[k], scan.ss, scan.al, rows)
            planes[i] = plane
    if any(p is None for p in planes):
        raise JpegError("lossless JPEG frame with a component no scan "
                        "codes")
    return planes


# -- the inverse DCT --------------------------------------------------------------

# jidctint.c's FIX(x) = round(x * 2**13)
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _w16(x):
    """``x`` wrapped to int16, as a 16-bit SIMD lane keeps it."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _w32(x):
    """``x`` wrapped to int32, as a 32-bit SIMD lane keeps it."""
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _idct_1d(x):
    """The even/odd butterflies of ``jpeg_idct_islow`` on 8 int64 arrays
    (inputs 0..7); returns the 8 undescaled outputs."""
    z1 = (x[2] + x[6]) * _F0541
    tmp2 = z1 - x[6] * _F1847
    tmp3 = z1 + x[2] * _F0765
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
    z1, z2 = o0 + o3, o1 + o2
    z3, z4 = o0 + o2, o1 + o3
    z5 = (z3 + z4) * _F1175
    o0, o1 = o0 * _F0298, o1 * _F2053
    o2, o3 = o2 * _F3072, o3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    o0 = o0 + z1 + z3
    o1 = o1 + z2 + z4
    o2 = o2 + z2 + z3
    o3 = o3 + z1 + z4
    return (t10 + o3, t11 + o2, t12 + o1, t13 + o0,
            t13 - o0, t12 - o1, t11 - o2, t10 - o3)


def _idct_1d_lanes(x):
    """:func:`_idct_1d` as libjpeg-turbo's SSE2/AVX2 version
    (``jidctint-sse2.asm``) keeps its lanes: the sums ``in0 +- in4``,
    ``in3 + in7`` and ``in1 + in5`` in 16 bits, each rotation a pair of
    16-bit products summed in 32 bits, the rest in 32 bits."""
    z2, z3 = x[2], x[6]
    tmp3 = z2 * (_F0541 + _F0765) + z3 * _F0541
    tmp2 = z2 * _F0541 + z3 * (_F0541 - _F1847)
    tmp0 = _w16(x[0] + x[4]) << 13
    tmp1 = _w16(x[0] - x[4]) << 13
    t10, t13 = _w32(tmp0 + tmp3), _w32(tmp0 - tmp3)
    t11, t12 = _w32(tmp1 + tmp2), _w32(tmp1 - tmp2)
    z3, z4 = _w16(x[3] + x[7]), _w16(x[1] + x[5])
    z3, z4 = (z3 * (_F1175 - _F1961) + z4 * _F1175,
              z3 * _F1175 + z4 * (_F1175 - _F0390))
    o0 = _w32(x[7] * (_F0298 - _F0899) - x[1] * _F0899 + z3)
    o3 = _w32(x[1] * (_F1501 - _F0899) - x[7] * _F0899 + z4)
    o1 = _w32(x[5] * (_F2053 - _F2562) - x[3] * _F2562 + z4)
    o2 = _w32(x[3] * (_F3072 - _F2562) - x[5] * _F2562 + z3)
    return tuple(_w32(v) for v in (t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                                   t13 - o0, t12 - o1, t11 - o2, t10 - o3))


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _descale16(x, n: int):
    """:func:`_descale` in a 32-bit lane, saturated to int16 (``paddd``,
    ``psrad``, ``packssdw``)."""
    return np.clip(_w32(x + (1 << (n - 1))) >> n, -32768, 32767)


# Within these bounds every lane of the SIMD version holds its value
# exactly, so the exact arithmetic gives its result: the dequantised terms
# (the shortcut shifts a DC term left 2 in 16 bits; a rotation's gain on 8
# inputs is below 2**16, so 32 bits hold it) and pass 1's outputs (pass 2
# sums them in pairs in 16 bits)
_EXACT_TERMS, _EXACT_PASS1 = 8191, 16383


def _within(a: np.ndarray, bound: int) -> bool:
    return -bound <= a.min() and a.max() <= bound


def _idct_exact(z: np.ndarray) -> Optional[np.ndarray]:
    """``jidctint.c``'s two passes on one chunk of dequantised blocks
    (``[8, 8, n]``), ``[row, col, n]`` before the level shift; None where a
    term leaves :data:`_EXACT_TERMS` or :data:`_EXACT_PASS1`."""
    if not _within(z, _EXACT_TERMS):
        return None
    # pass 1 down the columns, scaled up by 2**2: ws[row] is [col, n]
    ws = [_descale(v, 11) for v in _idct_1d(z)]
    if not all(_within(w, _EXACT_PASS1) for w in ws):
        return None
    # pass 2 along the rows, descaled by 2**(13 + 2 + 3)
    px = _idct_1d([np.stack([w[k] for w in ws]) for k in range(8)])
    return np.stack([_descale(v, 18) for v in px], 1)


def _idct_lanes(raw: np.ndarray, z: np.ndarray) -> np.ndarray:
    """The two passes of ``jsimd_idct_islow`` on one chunk (``raw`` the
    coefficients and ``z`` them dequantised, both ``[8, 8, n]``), lane
    widths and all: the dequantised terms kept to 16 bits, a block whose
    rows 1-7 are all zero taking pass 1's shortcut (the DC row shifted
    left 2 in 16 bits), each pass's outputs saturated to 16 bits.
    Returns ``[row, col, n]`` before the level shift."""
    z = _w16(z)
    ws = [_descale16(v, 11) for v in _idct_1d_lanes(z)]
    flat = ~raw[1:].any(axis=(0, 1))
    if flat.any():  # the shortcut, block by block
        dc = _w16(z[0] << 2)
        ws = [np.where(flat, dc, w) for w in ws]
    px = _idct_1d_lanes([np.stack([w[k] for w in ws]) for k in range(8)])
    return np.stack([_descale16(v, 18) for v in px], 1)


def idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Dequantise and inverse-DCT ``[n, 64]`` int16 coefficient blocks
    into ``[n, 8, 8]`` uint8 samples, bit for bit as libjpeg-turbo's
    SIMD ``jsimd_idct_islow`` (the one PIL runs on x86-64), the samples
    saturated to -128..127 before the +128 level shift.  A chunk of
    blocks runs ``jidctint.c``'s exact arithmetic (:func:`_idct_exact`),
    which gives the SIMD result wherever its terms stay within
    :data:`_EXACT_TERMS` and :data:`_EXACT_PASS1` (every stream a real
    encoder writes); a chunk past them (corrupt data) runs the lanes
    (:func:`_idct_lanes`)."""
    out = np.empty((coef.shape[0], 8, 8), np.uint8)
    q = qtable.reshape(8, 8)[:, :, None]
    for a in range(0, coef.shape[0], _IDCT_CHUNK):
        # [vertical frequency, horizontal frequency, block], contiguous
        raw = coef[a : a + _IDCT_CHUNK].T.reshape(8, 8, -1)
        z = raw.astype(np.int64) * q
        px = _idct_exact(z)
        if px is None:
            px = _idct_lanes(raw, z)
        px += 128
        out[a : a + _IDCT_CHUNK] = np.clip(px, 0, 255, out=px).transpose(
            2, 0, 1)
    return out


# -- the decoder ---------------------------------------------------------------------


def decode_coefficients(data: bytes, shape: Optional[Tuple[int, int]] = None,
                        tables: Optional[Tables] = None,
                        feed: Optional[int] = None):
    """Parse and entropy-decode: ``(frame, coef)`` with ``coef`` int16
    ``[blocks, 64]`` in natural order, each component's padded block grid
    in turn (``frame.offsets``), each scan through the native library when
    it loads and through :func:`decode_scan_py` (:func:`arith_scan_py`)
    otherwise.  ``feed``: the stream reaches the decoder in reads of this
    many bytes (:data:`PIL_FEED` for a file PIL opens), and an
    arithmetic-coded scan that needs a byte past the read holding its SOS
    header raises.  A lossless frame has no coefficients, and raises."""
    data = bytes(data)
    frame, scans = parse(data, shape, tables)
    if frame.lossless:
        raise JpegError("a SOF3 (lossless) frame has no DCT coefficients")
    return frame, _coefficients(data, frame, scans, feed)


def _coefficients(data: bytes, frame: Frame, scans: List[Scan],
                  feed: Optional[int] = None) -> np.ndarray:
    coef = np.zeros((frame.offsets[-1], 64), np.int16)
    native = _native.get_lib() is not None
    for scan in scans:
        order, slots, per_mcu = scan_blocks(frame, scan)
        if frame.arith:
            limit = len(data) if not feed else min(
                len(data), -(-scan.pos // feed) * feed)
            if native:
                _native.jpeg_arith_scan(data, scan, frame.progressive, coef,
                                        order, slots, per_mcu, limit)
            else:
                arith_scan_py(data, frame, scan, coef, order, slots,
                              per_mcu, limit)
        elif native:
            _native.jpeg_scan(data, scan, frame.progressive, coef, order,
                              slots, per_mcu)
        else:
            decode_scan_py(data, frame, scan, coef, order, slots, per_mcu)
    return coef


# -- upsampling and colour (libjpeg-turbo's jdsample.c and jdcolor.c) ---------


def _edge(x: np.ndarray, axis: int, step: int) -> np.ndarray:
    """``x`` shifted one sample along ``axis`` (-1: each sample's
    predecessor, +1: its successor), the edge sample repeated."""
    n = x.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(x, idx, axis=axis)


def upsample(plane: np.ndarray, ratio: Tuple[int, int]) -> np.ndarray:
    """A component's plane ``[dh, dw]`` (uint8) brought to ``ratio = (h,
    v)`` times its size as libjpeg-turbo's ``jdsample.c`` does under PIL:
    h2v1, h1v2 and h2v2 "fancy" (triangle) upsampling with their
    alternating rounding, context rows and columns repeated at the edges;
    h2v1 and h2v2 of a plane 2 columns wide or less, and every other
    integral ratio (``int_upsample``), by replication."""
    if ratio == (1, 1):
        return plane
    dh, dw = plane.shape
    x = plane.astype(np.int32)
    if ratio == (1, 2):  # h1v2_fancy_upsample
        out = np.empty((2 * dh, dw), np.uint8)
        out[0::2] = (3 * x + _edge(x, 0, -1) + 1) >> 2
        out[1::2] = (3 * x + _edge(x, 0, 1) + 2) >> 2
        return out
    if ratio not in ((2, 1), (2, 2)) or dw <= 2:
        return np.repeat(np.repeat(plane, ratio[1], axis=0), ratio[0],
                         axis=1)
    if ratio == (2, 1):  # h2v1_fancy_upsample
        out = np.empty((dh, 2 * dw), np.uint8)
        out[:, 0::2] = (3 * x + _edge(x, 1, -1) + 1) >> 2
        out[:, 1::2] = (3 * x + _edge(x, 1, 1) + 2) >> 2
        return out
    out = np.empty((2 * dh, 2 * dw), np.uint8)  # h2v2_fancy_upsample
    for parity, far in ((0, _edge(x, 0, -1)), (1, _edge(x, 0, 1))):
        cs = 3 * x + far  # the column sums of the nearer and farther rows
        out[parity::2, 0::2] = (3 * cs + _edge(cs, 1, -1) + 8) >> 4
        out[parity::2, 1::2] = (3 * cs + _edge(cs, 1, 1) + 7) >> 4
    return out


def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


_CHROMA = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _CHROMA + (1 << 15)) >> 16
_CB_B = (_fix(1.77200) * _CHROMA + (1 << 15)) >> 16
_CR_G = -_fix(0.71414) * _CHROMA
_CB_G = -_fix(0.34414) * _CHROMA + (1 << 15)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c``'s ``ycc_rgb_convert``: its 16-bit fixed-point tables,
    then the clamp to 0..255; ``[H, W, 3]`` uint8."""
    y = y.astype(np.int64)
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = np.clip(y + _CR_R[cr], 0, 255)
    out[..., 1] = np.clip(y + ((_CB_G[cb] + _CR_G[cr]) >> 16), 0, 255)
    out[..., 2] = np.clip(y + _CB_B[cb], 0, 255)
    return out


# the natural-order positions of the quantisers libjpeg-turbo's block
# smoothing divides by: DC and the first nine AC terms in zigzag order
_SMOOTHING_Q = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)


def _smoothed(frame: Frame, scans: List[Scan]) -> bool:
    """Whether libjpeg-turbo's ``smoothing_ok`` holds after every scan of
    a progressive frame: each component latched a table with no zero
    among those quantisers and saw its DC, and some component's first ten
    coefficients (zigzag) are not all at full precision (a coefficient no
    scan coded counts as short)."""
    bits = [[-1] * 10 for _ in frame.components]
    for scan in scans:
        for i in scan.comps:
            for k in range(scan.ss, min(scan.se, 9) + 1):
                bits[i][k] = scan.al
    useful = False
    for comp, b in zip(frame.components, bits):
        if comp.qtable is None or not all(comp.qtable[list(_SMOOTHING_Q)]) \
                or b[0] < 0:
            return False
        useful = useful or any(b[1:])
    return useful


def decode_planes(data: bytes, shape: Optional[Tuple[int, int]] = None,
                  tables: Optional[Tables] = None,
                  feed: Optional[int] = None):
    """``(frame, planes)``: each component's samples at its own sampling
    (``frame.size(i)``, uint8), before any upsampling or colour
    conversion: what libjpeg's raw-data output gives (libtiff's old-style
    JPEG reads colour pages this way).  A lossless frame's planes are its
    samples (:func:`decode_lossless`).  ``feed`` as
    :func:`decode_coefficients` takes it.  A progressive frame libjpeg
    would smooth (:func:`_smoothed`) raises ``NotImplementedError``
    naming ROADMAP M17."""
    data = bytes(data)
    frame, scans = parse(data, shape, tables)
    if len(frame.components) == 4:
        _refuse_components(4)
    return frame, _planes(data, frame, scans, feed)


def _planes(data: bytes, frame: Frame, scans: List[Scan],
            feed: Optional[int]) -> List[np.ndarray]:
    """:func:`decode_planes` of a parsed stream."""
    if frame.lossless:
        return decode_lossless(data, frame, scans)
    if frame.progressive and _smoothed(frame, scans):
        raise NotImplementedError(
            "progressive JPEG whose scans leave its first ten coefficients "
            "short of full precision: libjpeg smooths such blocks "
            "(jdcoefct.c decompress_smooth_data), which unmicst_tpu_torch "
            "does not (ROADMAP M17)")
    coef = _coefficients(data, frame, scans, feed)
    offs, planes = frame.offsets, []
    for i, comp in enumerate(frame.components):
        bh, bw = frame.grid(i)
        # a component no scan reached has no table latched: libjpeg's
        # multipliers stay zero, and its samples 128
        q = comp.qtable if comp.qtable is not None else np.zeros(64, np.int64)
        px = idct_islow(coef[offs[i] : offs[i + 1]], q)
        img = px.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            bh * 8, bw * 8)
        ch, cw = frame.size(i)
        planes.append(img[:ch, :cw])
    return planes


def decode(data: bytes, shape: Optional[Tuple[int, int]] = None,
           tables: Optional[Tables] = None,
           colour: Optional[str] = None,
           feed: Optional[int] = None) -> np.ndarray:
    """A JPEG stream -> ``[H, W]`` uint8 (gray) or ``[H, W, 3]`` uint8
    (colour, RGB), as PIL decodes it.

    ``shape``: the (height, width) the caller expects; a frame of another
    size raises before any buffer is allocated.  ``tables``: what an
    abbreviated stream starts from (:func:`parse_tables`).  ``colour``
    overrides the colour space libjpeg would pick for a colour frame:
    ``"ycbcr"`` converts to RGB, ``"rgb"`` returns the components as they
    are (libtiff's choice for a JPEG TIFF page by its photometric
    interpretation).  ``feed`` as :func:`decode_coefficients` takes it.
    ``colour`` ``"cmyk"``: a frame of four components decodes too, as
    libjpeg's CMYK output gives it from a stream it takes as CMYK
    (``[H, W, 4]``, before the inversion of PIL's ``CMYK;I`` raw mode);
    other callers get :class:`JpegError` for it.
    Every failure raises :class:`JpegError` (a ``ValueError``); what the
    port does not decode yet and PIL does, ``NotImplementedError``
    (:func:`decode_planes`)."""
    data = bytes(data)
    frame, scans = parse(data, shape, tables)
    if len(frame.components) == 4 and colour != "cmyk":
        _refuse_components(4)
    planes = _planes(data, frame, scans, feed)
    if frame.lossless and len(planes) == 3 and (colour or frame.colour) \
            == "ycbcr":
        raise JpegError("libjpeg-turbo converts no lossless JPEG colour "
                        "(YCbCr to RGB)")
    planes = [upsample(img, (frame.hmax // comp.h, frame.vmax // comp.v))[
        : frame.height, : frame.width]
        for img, comp in zip(planes, frame.components)]
    if frame.colour == "gray":
        return np.ascontiguousarray(planes[0])
    if len(planes) == 4 or (colour or frame.colour) == "rgb":
        return np.stack(planes, -1)
    return ycc_to_rgb(*planes)
