"""CCITT bilevel decoding in the standard library: the plain version of
the port's native decoder (``native/tiffcodec.cpp``
``unmicst_ccitt_decode``), for the TIFF pages the JAX package reads
through PIL and libtiff's ``tif_fax3.c`` (``unmicst_tpu/io/tiff.py:1274-
1291``, ``io/slides.py:66-97``).

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
