"""CCITT bilevel decoding in the standard library: the plain version of
the port's native decoder (``native/tiffcodec.cpp``
``unmicst_ccitt_decode``), for the TIFF pages the JAX package reads
through PIL and libtiff's ``tif_fax3.c`` (``unmicst_tpu/io/tiff.py:1274-
1291``, ``io/slides.py:66-97``); and the Group 4 encoder PIL's PDF save
of a mode ``1`` image reaches through libtiff (:func:`encode_g4`, below).

Three TIFF compressions, each strip or tile coded on its own:

* 2, Modified Huffman run lengths (ITU T.4 one-dimensional coding): no
  EOL codes, every row starting on a byte boundary;
* 3, ITU T.4 ("Group 3"): every row after an EOL code; with T4Options bit
  0 set, a tag bit after the EOL says whether the row is coded in one
  dimension or in two (against the row above); bit 2 (fill bits before
  the EOL) needs nothing, since the search for an EOL skips zero bits;
* 4, ITU T.6 ("Group 4"): two-dimensional coding only, against an all
  white row above the first, no EOL codes.

Rows come out packed, most significant bit first, each row padded to a
whole byte, a set bit for each black pixel: what libtiff hands PIL, which
then applies the page's photometric interpretation.  FillOrder 2 is the
caller's: it reverses the bits of each stored byte first.

The decode is strict where libtiff conceals: a code word that is no code,
an EOL or extension code within a row, a row that runs past its width or
short of it, and data that ends before the last row all raise
:class:`CcittError` (a ``ValueError``).  libtiff logs those and goes on
with the row padded (ROADMAP M17, "not queued").
"""

from __future__ import annotations

import struct
from bisect import bisect_right
from typing import Dict, List

import numpy as np

COMPRESSION_RLE = 2  # Modified Huffman run lengths, byte-aligned rows
COMPRESSION_T4 = 3
COMPRESSION_T6 = 4
T4_2D = 1  # T4Options bit 0: rows may be coded in two dimensions

# T.4 Table 2: the terminating codes of runs 0-63, white then black
WHITE_TERM = (
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000",
    "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011",
    "00010010", "00010011", "00010100", "00010101", "00010110", "00010111",
    "00101000", "00101001", "00101010", "00101011", "00101100", "00101101",
    "00000100", "00000101", "00001010", "00001011", "01010010", "01010011",
    "01010100", "01010101", "00100100", "00100101", "01011000", "01011001",
    "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100")
BLACK_TERM = (
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111")
# T.4 Table 3: the make-up codes of runs 64, 128, ..., 1728
WHITE_MAKEUP = (
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011")
BLACK_MAKEUP = (
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101")
# the make-up codes both colours share, runs 1792, 1856, ..., 2560
EXT_MAKEUP = (
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111")

# T.4 Table 4: the two-dimensional modes; vertical modes as a1 - b1
PASS, HORIZONTAL = "P", "H"
MODES = {"1": 0, "011": 1, "000011": 2, "0000011": 3, "010": -1,
         "000010": -2, "0000010": -3, "001": HORIZONTAL, "0001": PASS}


class CcittError(ValueError):
    """CCITT data that does not decode to the rows asked for."""


def _runs(term, makeup) -> Dict[str, int]:
    table = {code: run for run, code in enumerate(term)}
    table.update({code: 64 * (k + 1) for k, code in enumerate(makeup)})
    table.update({code: 1792 + 64 * k for k, code in enumerate(EXT_MAKEUP)})
    return table


_TABLES = (_runs(WHITE_TERM, WHITE_MAKEUP), _runs(BLACK_TERM, BLACK_MAKEUP))


class _Reader:
    """The stored bits as a string of ``0`` and ``1``, read MSB first."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8)).tobytes(
        ).translate(bytes.maketrans(b"\0\1", b"01")).decode("ascii")
        self.pos = 0

    def code(self, table, longest: int, what: str):
        """The next code word of ``table`` (a dict of code -> value)."""
        bits, pos = self.bits, self.pos
        for n in range(1, longest + 1):
            value = table.get(bits[pos : pos + n])
            if value is not None:
                self.pos = pos + n
                return value
        if pos + longest > len(bits):
            raise CcittError(f"data ends within a {what} code at bit {pos}")
        raise CcittError(f"no {what} code at bit {pos}: "
                         f"{bits[pos : pos + longest]}")

    def run(self, colour: int) -> int:
        """One run of ``colour`` (0 white, 1 black): make-up codes, then a
        terminating code."""
        total = 0
        while True:
            n = self.code(_TABLES[colour], 13, ("white", "black")[colour])
            total += n
            if n < 64:
                return total

    def sync_eol(self) -> None:
        """Past the next EOL code, as libtiff's ``SYNC_EOL`` finds it: the
        first 11 zero bits, then every zero bit after them, then the 1."""
        at = self.bits.find("0" * 11, self.pos)
        one = -1 if at < 0 else self.bits.find("1", at + 11)
        if one < 0:
            raise CcittError(f"no EOL code after bit {self.pos}")
        self.pos = one + 1


def _row_1d(rd: _Reader, width: int) -> List[int]:
    """One row coded in one dimension: its changing elements."""
    changes, a0, colour = [], 0, 0
    while a0 < width:
        a0 += rd.run(colour)
        changes.append(a0)
        colour ^= 1
    if a0 != width:
        raise CcittError(f"a row's runs add up to {a0}, not {width}")
    return changes


def _row_2d(rd: _Reader, width: int, above: List[int]) -> List[int]:
    """One row coded against the row above, whose changing elements are
    ``above`` (ascending, each below ``width``)."""
    ref = above + [width] * 3
    changes, a0, colour = [], -1, 0
    while a0 < width:
        i = bisect_right(ref, a0)
        if (i & 1) != colour:  # b1: the first change to the other colour
            i += 1
        b1, b2 = ref[i], ref[i + 1]
        mode = rd.code(MODES, 7, "mode")
        if mode == PASS:
            a0 = b2
        elif mode == HORIZONTAL:
            a1 = max(a0, 0) + rd.run(colour)
            a0 = a1 + rd.run(colour ^ 1)
            changes += (a1, a0)
        else:
            a1 = b1 + mode
            if a1 < max(a0, 0) or a1 > width:
                raise CcittError(f"a vertical mode puts a change at {a1}, "
                                 f"outside [{max(a0, 0)}, {width}]")
            changes.append(a1)
            a0, colour = a1, colour ^ 1
    if a0 != width:
        raise CcittError(f"a row's runs add up to {a0}, not {width}")
    return changes


def _reference(changes: List[int], width: int) -> List[int]:
    """The changing elements of a decoded row as the row below reads them:
    pairs at one position (runs of length 0) cancelled, the row's end
    dropped."""
    out: List[int] = []
    for x in changes:
        if x >= width:
            break
        if out and out[-1] == x:
            out.pop()
        else:
            out.append(x)
    return out


def decode(data: bytes, width: int, rows: int, compression: int,
           options: int = 0) -> np.ndarray:
    """``rows`` rows of ``width`` pixels from one strip or tile: ``[rows,
    ceil(width / 8)]`` uint8, packed MSB first, 1 = black.
    ``compression`` is the TIFF tag's value (2, 3 or 4) and ``options``
    the page's T4Options (compression 3)."""
    if compression not in (COMPRESSION_RLE, COMPRESSION_T4, COMPRESSION_T6):
        raise ValueError(f"compression {compression} is not CCITT")
    rd = _Reader(data)
    out = np.zeros((rows, width), np.uint8)
    ref: List[int] = []  # an all-white row above the first
    for r in range(rows):
        if compression == COMPRESSION_RLE:
            changes = _row_1d(rd, width)
            rd.pos = -(-rd.pos // 8) * 8
        elif compression == COMPRESSION_T6:
            changes = _row_2d(rd, width, ref)
        else:
            rd.sync_eol()
            one_d = True
            if options & T4_2D:
                if rd.pos >= len(rd.bits):
                    raise CcittError("data ends at a row's tag bit")
                one_d = rd.bits[rd.pos] == "1"
                rd.pos += 1
            changes = (_row_1d(rd, width) if one_d
                       else _row_2d(rd, width, ref))
        ref = _reference(changes, width)
        for k in range(0, len(ref), 2):  # black from each odd change
            out[r, ref[k] : ref[k + 1] if k + 1 < len(ref) else width] = 1
    return np.packbits(out, axis=1)


# -- Group 4 encoding ---------------------------------------------------------

EOFB = "000000000001" * 2
# the vertical modes' codes by b1 - a1 + 3, as libtiff's vcodes
_VCODES = ("0000011", "000011", "011", "1", "010", "000010", "0000010")


def _span_codes(span: int, colour: int) -> str:
    """libtiff's ``putspan``: make-up codes of 2560 while the run is
    2624 or more, one make-up code, then the terminating code."""
    term, makeup = ((WHITE_TERM, WHITE_MAKEUP), (BLACK_TERM,
                                                   BLACK_MAKEUP))[colour]
    out = []
    while span >= 2624:
        out.append(EXT_MAKEUP[-1])
        span -= 2560
    if span >= 64:
        k = span >> 6
        out.append(makeup[k - 1] if k <= 27 else EXT_MAKEUP[k - 28])
        span -= 64 * k
    out.append(term[span])
    return "".join(out)


def _finder(row: np.ndarray, width: int):
    """libtiff's ``finddiff`` over one row of 0/1 pixels: from ``bs``,
    past the run of ``colour`` (none where the pixel there differs),
    ending at the row's end."""
    changes = (np.flatnonzero(np.diff(row)) + 1).tolist() + [width]

    def finddiff(bs: int, colour: int) -> int:
        if bs >= width or row[bs] != colour:
            return bs
        return changes[bisect_right(changes, bs)]

    return finddiff


def _row_g4(cur: np.ndarray, ref: np.ndarray, width: int) -> str:
    """``Fax3Encode2DRow``: one row coded against the row above."""
    fc, fr = _finder(cur, width), _finder(ref, width)
    out = []
    a0 = 0
    a1 = 0 if cur[0] else fc(0, 0)
    b1 = 0 if ref[0] else fr(0, 0)
    while True:
        b2 = fr(b1, int(ref[b1])) if b1 < width else width
        if b2 >= a1:
            d = b1 - a1
            if not -3 <= d <= 3:  # horizontal mode
                a2 = fc(a1, int(cur[a1])) if a1 < width else width
                first = 0 if a0 + a1 == 0 or cur[a0] == 0 else 1
                out += ["001", _span_codes(a1 - a0, first),
                        _span_codes(a2 - a1, first ^ 1)]
                a0 = a2
            else:  # vertical mode
                out.append(_VCODES[d + 3])
                a0 = a1
        else:  # pass mode
            out.append("0001")
            a0 = b2
        if a0 >= width:
            break
        colour = int(cur[a0])
        a1 = fc(a0, colour)
        b1 = fr(fr(a0, colour ^ 1), colour)
    return "".join(out)


def encode_g4_py(rows: np.ndarray, width: int) -> bytes:
    """:func:`encode_g4` in Python, the plain version of
    ``native/tiffcodec.cpp`` ``unmicst_g4_encode``."""
    bits = np.unpackbits(np.asarray(rows, np.uint8), axis=1)[:, :width]
    ref = np.zeros(width, np.uint8)
    parts = []
    for cur in bits:
        parts.append(_row_g4(cur, ref, width))
        ref = cur
    code = "".join(parts) + EOFB
    code += "0" * (-len(code) % 8)
    return int(code, 2).to_bytes(len(code) // 8, "big")


def encode_g4(rows: np.ndarray, width: int) -> bytes:
    """libtiff 4.7's ``Fax4Encode`` of one strip: ``rows`` (``[n,
    ceil(width / 8)]`` uint8, packed MSB first, a set bit coded as
    black) row by row against the row above (all white above the first),
    then EOFB, the last byte padded with zero bits.  In the native host
    library when it loads, else :func:`encode_g4_py`."""
    from unmicst_tpu_torch.io import _native

    rows = np.ascontiguousarray(rows, np.uint8)
    out = _native.g4_encode(rows, width)
    return encode_g4_py(rows, width) if out is None else out


def g4_tiff(image: np.ndarray) -> bytes:
    """The TIFF PIL's libtiff save of a mode ``1`` image (``image``: 0/1)
    writes with ``compression="group4"`` in one strip: the header, the
    strip at 8, a zero byte where its length is odd, then the IFD of
    libtiff's nine tags (ImageWidth, ImageLength, BitsPerSample 1,
    Compression 4, Photometric 1 (BlackIsZero), StripOffsets,
    RowsPerStrip, StripByteCounts, PlanarConfiguration 1)."""
    h, w = image.shape
    strip = encode_g4(np.packbits(np.asarray(image, np.uint8), axis=1), w)
    pad = b"\0" * (len(strip) % 2)
    ifd_at = 8 + len(strip) + len(pad)

    def short_or_long(tag: int, value: int) -> bytes:
        if value <= 0xFFFF:
            return struct.pack("<HHIHH", tag, 3, 1, value, 0)
        return struct.pack("<HHII", tag, 4, 1, value)

    entries = [short_or_long(256, w), short_or_long(257, h),
               short_or_long(258, 1), short_or_long(259, COMPRESSION_T6),
               short_or_long(262, 1), struct.pack("<HHII", 273, 4, 1, 8),
               short_or_long(278, h),
               struct.pack("<HHII", 279, 4, 1, len(strip)),
               short_or_long(284, 1)]
    return (b"II*\0" + struct.pack("<I", ifd_at) + strip + pad
            + struct.pack("<H", len(entries)) + b"".join(entries)
            + bytes(4))
