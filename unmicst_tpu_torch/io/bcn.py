"""The block-compressed texture formats as PIL 12's ``bcn`` decoder
(``BcnDecode.c``) decodes them for the DDS and FTEX plugins the JAX
package reaches through PIL: its TIFF fallback's ``Image.open`` of a file
under a TIFF name, and the toolbox's ``imread``.

Seven decoders, each of 4 x 4 pixel blocks in raster order, a block's
pixels written where they fall inside the image:

* 1, BC1/DXT1 (8 bytes, ``RGBA``): two 5:6:5 endpoints, each field
  widened by repeating its top bits; ``c0 <= c1`` makes a three-colour
  block whose fourth colour is transparent black;
* 2, BC2/DXT3 (16 bytes, ``RGBA``): 4-bit alpha (times 17), then a BC1
  colour block taken as four-colour whatever its endpoints;
* 3, BC3/DXT5 (16 bytes, ``RGBA``): an interpolated 8-bit alpha block
  (six steps between ``a0 > a1``, else four and then 0 and 255), then
  the colour block as for 2;
* 4, BC4 (8 bytes, ``L``): one such interpolated block;
* 5, BC5 and BC5S (16 bytes, ``RGB``): two, as red and green, blue 0;
  BC5S reads each endpoint as a signed byte plus 128, and blue is 128;
* 6, BC6H and BC6HS (16 bytes, ``RGB``): the 14 modes of the D3D11
  format (a reserved mode gives black), endpoints unquantised and
  interpolated as integers (without the format's rounding term, and the
  delta endpoints' sums not sign-extended again, as Pillow does), scaled
  by 31/64 (31/32 signed) to a half float, and that float times 255
  truncated to 8 bits (0 below 0, 255 above 1);
* 7, BC7 (16 bytes, ``RGBA``): the eight modes with their partitions,
  rotations and index selection; a block whose first byte is 0 (no mode
  bit) is opaque black.

:func:`decode` runs the native host library's decoder
(``native/bcndec.cpp``, through :mod:`unmicst_tpu_torch.io._native`) and
otherwise :func:`decode_blocks_py`, its plain version in numpy,
vectorised over blocks (float32 where the C is float); both give the
same bytes.  Data that hold fewer blocks than the image raise PIL's
``OSError`` (image file is truncated).
"""

from __future__ import annotations

import numpy as np

from unmicst_tpu_torch.io import _native, _pil

# decoder -> (bytes a block, PIL's mode)
FORMATS = {1: (8, "RGBA"), 2: (16, "RGBA"), 3: (16, "RGBA"), 4: (8, "L"),
           5: (16, "RGB"), 6: (16, "RGB"), 7: (16, "RGBA")}

# -- the BC6H and BC7 tables (D3D11 functional specification) ----------------

# BC7 mode -> subsets, partition bits, rotation bits, index-selection
# bit, colour bits, alpha bits, endpoint p-bits, shared p-bits, index
# bits, second index bits
_BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
              (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
              (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))
# two-subset partitions, one bit a pixel
_P2 = (0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
       0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
       0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
       0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
       0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
       0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
       0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
       0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22)
# three-subset partitions, two bits a pixel
_P3 = (0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000,
       0xa0a05050, 0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500,
       0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4, 0xa9a59450,
       0x2a0a4250, 0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0,
       0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500, 0x0050a4a4,
       0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
       0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050,
       0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50,
       0x500aa550, 0xaaaa4444, 0x66660000, 0xa5a0a5a0, 0x50a050a0,
       0x69286928, 0x44aaaa44, 0x66666600, 0xaa444444, 0x54a854a8,
       0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414,
       0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
       0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254)
# the anchor pixel of subset 1 (two subsets), and of subsets 1 and 2
# (three subsets)
_A2 = (15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
       15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
       15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
       6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)
_A3A = (3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
        3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
        8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
        3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3)
_A3B = (15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
        15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
        15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
        15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8)
WEIGHTS = {2: (0, 21, 43, 64), 3: (0, 9, 18, 27, 37, 46, 55, 64),
           4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64)}

# BC6H mode -> subsets, transformed (delta) endpoints, partition bits,
# endpoint bits, red, green and blue delta bits
_BC6_MODES = ((2, 1, 5, 10, 5, 5, 5), (2, 1, 5, 7, 6, 6, 6),
              (2, 1, 5, 11, 5, 4, 4), (2, 1, 5, 11, 4, 5, 4),
              (2, 1, 5, 11, 4, 4, 5), (2, 1, 5, 9, 5, 5, 5),
              (2, 1, 5, 8, 6, 5, 5), (2, 1, 5, 8, 5, 6, 5),
              (2, 1, 5, 8, 5, 5, 6), (2, 0, 5, 6, 6, 6, 6),
              (1, 0, 0, 10, 10, 10, 10), (1, 1, 0, 11, 9, 9, 9),
              (1, 1, 0, 12, 8, 8, 8), (1, 1, 0, 16, 4, 4, 4))
# each mode's endpoint bits in stream order after the mode bits, as the
# specification lists them: ``r0:9-0`` is r0's bits 0 to 9, ``r0:10-15``
# bits 15 down to 10 (the stream runs from the second number to the
# first)
_BC6_LAYOUTS = (
    "g2:4 b2:4 b3:4 r0:9-0 g0:9-0 b0:9-0 r1:4-0 g3:4 g2:3-0 g1:4-0 b3:0 "
    "g3:3-0 b1:4-0 b3:1 b2:3-0 r2:4-0 b3:2 r3:4-0 b3:3",
    "g2:5 g3:4 g3:5 r0:6-0 b3:0 b3:1 b2:4 g0:6-0 b2:5 b3:2 g2:4 b0:6-0 "
    "b3:3 b3:5 b3:4 r1:5-0 g2:3-0 g1:5-0 g3:3-0 b1:5-0 b2:3-0 r2:5-0 "
    "r3:5-0",
    "r0:9-0 g0:9-0 b0:9-0 r1:4-0 r0:10 g2:3-0 g1:3-0 g0:10 b3:0 g3:3-0 "
    "b1:3-0 b0:10 b3:1 b2:3-0 r2:4-0 b3:2 r3:4-0 b3:3",
    "r0:9-0 g0:9-0 b0:9-0 r1:3-0 r0:10 g3:4 g2:3-0 g1:4-0 g0:10 g3:3-0 "
    "b1:3-0 b0:10 b3:1 b2:3-0 r2:3-0 b3:0 b3:2 r3:3-0 g2:4 b3:3",
    "r0:9-0 g0:9-0 b0:9-0 r1:3-0 r0:10 b2:4 g2:3-0 g1:3-0 g0:10 b3:0 "
    "g3:3-0 b1:4-0 b0:10 b2:3-0 r2:3-0 b3:1 b3:2 r3:3-0 b3:4 b3:3",
    "r0:8-0 b2:4 g0:8-0 g2:4 b0:8-0 b3:4 r1:4-0 g3:4 g2:3-0 g1:4-0 b3:0 "
    "g3:3-0 b1:4-0 b3:1 b2:3-0 r2:4-0 b3:2 r3:4-0 b3:3",
    "r0:7-0 g3:4 b2:4 g0:7-0 b3:2 g2:4 b0:7-0 b3:3 b3:4 r1:5-0 g2:3-0 "
    "g1:4-0 b3:0 g3:3-0 b1:4-0 b3:1 b2:3-0 r2:5-0 r3:5-0",
    "r0:7-0 b3:0 b2:4 g0:7-0 g2:5 g2:4 b0:7-0 g3:5 b3:4 r1:4-0 g3:4 "
    "g2:3-0 g1:5-0 g3:3-0 b1:4-0 b3:1 b2:3-0 r2:4-0 b3:2 r3:4-0 b3:3",
    "r0:7-0 b3:1 b2:4 g0:7-0 b2:5 g2:4 b0:7-0 b3:5 b3:4 r1:4-0 g3:4 "
    "g2:3-0 g1:4-0 b3:0 g3:3-0 b1:5-0 b2:3-0 r2:4-0 b3:2 r3:4-0 b3:3",
    "r0:5-0 g3:4 b3:0 b3:1 b2:4 g0:5-0 g2:5 b2:5 b3:2 g2:4 b0:5-0 g3:5 "
    "b3:3 b3:5 b3:4 r1:5-0 g2:3-0 g1:5-0 g3:3-0 b1:5-0 b2:3-0 r2:5-0 "
    "r3:5-0",
    "r0:9-0 g0:9-0 b0:9-0 r1:9-0 g1:9-0 b1:9-0",
    "r0:9-0 g0:9-0 b0:9-0 r1:8-0 r0:10 g1:8-0 g0:10 b1:8-0 b0:10",
    "r0:9-0 g0:9-0 b0:9-0 r1:7-0 r0:10-11 g1:7-0 g0:10-11 b1:7-0 "
    "b0:10-11",
    "r0:9-0 g0:9-0 b0:9-0 r1:3-0 r0:10-15 g1:3-0 g0:10-15 b1:3-0 "
    "b0:10-15",
)


def _packing(layout: str):
    """A layout -> ``[(endpoint word, bit)]`` in stream order; the words
    are r0, g0, b0, r1, g1, b1, r2 ... b3 (0-11)."""
    out = []
    for item in layout.split():
        name, bits = item.split(":")
        word = 3 * int(name[1]) + "rgb".index(name[0])
        hi, _, lo = bits.partition("-")
        hi, lo = int(hi), int(lo or hi)
        step = 1 if hi >= lo else -1
        out += [(word, b) for b in range(lo, hi + step, step)]
    return out


BC6_PACKINGS = tuple(_packing(s) for s in _BC6_LAYOUTS)


# -- the plain decoders -------------------------------------------------------


def _bits(blocks: np.ndarray) -> np.ndarray:
    """``[n, 8 * size]`` bits of each block, least significant first."""
    return np.unpackbits(blocks, axis=1, bitorder="little").astype(np.int64)


def _take(bits: np.ndarray, pos, count: int) -> np.ndarray:
    """The ``count``-bit fields from bit ``pos`` (an int, or one position
    a block) of each block."""
    out = np.zeros(len(bits), np.int64)
    pos = np.broadcast_to(np.asarray(pos, np.int64), (len(bits),))
    rows = np.arange(len(bits))
    for j in range(count):
        out |= bits[rows, pos + j] << j
    return out


def _u16(blocks: np.ndarray, at: int) -> np.ndarray:
    return blocks[:, at].astype(np.int64) | blocks[:, at + 1].astype(
        np.int64) << 8


def _bc1_colour(blocks: np.ndarray, at: int, four: bool) -> np.ndarray:
    """``decode_bc1_color``: ``[n, 16, 4]`` of the colour block at byte
    ``at`` (``four``: always the four-colour palette)."""
    c0, c1 = _u16(blocks, at), _u16(blocks, at + 2)
    p = np.empty((len(blocks), 4, 4), np.int64)
    for k, c in enumerate((c0, c1)):
        r, g, b = (c >> 11) & 31, (c >> 5) & 63, c & 31
        p[:, k] = np.stack([(r << 3) | (r >> 2), (g << 2) | (g >> 4),
                            (b << 3) | (b >> 2), np.full_like(r, 255)], 1)
    e0, e1 = p[:, 0, :3], p[:, 1, :3]
    opaque = (c0 > c1) | four
    p[:, 2, :3] = np.where(opaque[:, None], (2 * e0 + e1) // 3,
                           (e0 + e1) // 2)
    p[:, 3, :3] = np.where(opaque[:, None], (e0 + 2 * e1) // 3, 0)
    p[:, 2, 3] = 255
    p[:, 3, 3] = np.where(opaque, 255, 0)
    lut = _u16(blocks, at + 4) | _u16(blocks, at + 6) << 16
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(p, idx[:, :, None], 1)


def _bc3_alpha(blocks: np.ndarray, at: int, signed: bool = False
               ) -> np.ndarray:
    """``decode_bc3_alpha``: ``[n, 16]`` of the interpolated block at byte
    ``at`` (``signed``: BC5S's endpoints, signed bytes plus 128)."""
    a0 = blocks[:, at].astype(np.int64)
    a1 = blocks[:, at + 1].astype(np.int64)
    if signed:
        a0 = (a0 ^ 128)
        a1 = (a1 ^ 128)
    a = np.empty((len(blocks), 8), np.int64)
    a[:, 0], a[:, 1] = a0, a1
    six = a0 > a1
    for k in range(6):
        seven = ((6 - k) * a0 + (k + 1) * a1) // 7
        five = ((4 - k) * a0 + (k + 1) * a1) // 5 if k < 4 else (
            np.zeros_like(a0) if k == 4 else np.full_like(a0, 255))
        a[:, 2 + k] = np.where(six, seven, five)
    a &= 255
    out = np.empty((len(blocks), 16), np.int64)
    for half in range(2):
        b = blocks[:, at + 2 + 3 * half : at + 5 + 3 * half].astype(np.int64)
        lut = b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16
        idx = (lut[:, None] >> (3 * np.arange(8))) & 7
        out[:, 8 * half : 8 * half + 8] = np.take_along_axis(a, idx, 1)
    return out


def _subsets(ns: int, partition: np.ndarray) -> np.ndarray:
    """``[n, 16]`` subset of each pixel."""
    if ns == 1:
        return np.zeros((len(partition), 16), np.int64)
    shift = np.arange(16) * (1 if ns == 2 else 2)
    table = np.array(_P2 if ns == 2 else _P3, np.int64)[partition]
    return (table[:, None] >> shift) & (1 if ns == 2 else 3)


def _anchors(ns: int, partition: np.ndarray, subset: np.ndarray
             ) -> np.ndarray:
    """``[n, 16]`` 1 where the pixel's index has one bit fewer."""
    px = np.arange(16)
    out = (px == 0)[None].repeat(len(partition), 0).astype(np.int64)
    if ns == 2:
        out |= px[None] == np.array(_A2)[partition][:, None]
    elif ns == 3:
        out |= (subset == 1) & (px[None] == np.array(_A3A)[partition][:, None])
        out |= (subset == 2) & (px[None] == np.array(_A3B)[partition][:, None])
    return out


def _indices(bits: np.ndarray, start: int, ib: int, short: np.ndarray):
    """``[n, 16]`` indices of ``ib`` bits a pixel from bit ``start``, a
    bit fewer where ``short``; and the bit after the last."""
    counts = ib - np.broadcast_to(short, (len(bits), 16))
    pos = start + np.cumsum(counts, 1) - counts
    out = np.zeros(counts.shape, np.int64)
    rows = np.arange(len(bits))[:, None]
    for j in range(ib):
        take = j < counts
        out |= np.where(take, bits[rows, np.minimum(pos + j, 127)], 0) << j
    return out


def _expand(v: np.ndarray, n: int) -> np.ndarray:
    """``expand_quantized``: ``n`` bits widened to 8 in a byte."""
    v = (v << (8 - n)) & 255
    return v | (v >> n)


def _bc7(blocks: np.ndarray) -> np.ndarray:
    n = len(blocks)
    out = np.zeros((n, 16, 4), np.int64)
    out[..., 3] = 255  # a block without a mode bit: opaque black
    first = blocks[:, 0].astype(np.int64)
    mode = np.full(n, -1)
    for m in range(7, -1, -1):
        mode[(first >> m) & 1 == 1] = m
    bits = _bits(blocks)
    for m, (ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2) in enumerate(
            _BC7_MODES):
        sel = np.flatnonzero(mode == m)
        if not len(sel):
            continue
        b = bits[sel]
        k = len(sel)
        pos = m + 1
        partition = _take(b, pos, pb)
        pos += pb
        rotation = _take(b, pos, rb)
        pos += rb
        index_sel = _take(b, pos, isb)
        pos += isb
        numep = 2 * ns
        ep = np.zeros((k, numep, 4), np.int64)
        for c in range(3):
            for i in range(numep):
                ep[:, i, c] = _take(b, pos, cb)
                pos += cb
        for i in range(numep):
            if ab:
                ep[:, i, 3] = _take(b, pos, ab)
                pos += ab
            else:
                ep[:, i, 3] = 255
        cbits, abits = cb, ab
        chans = 4 if ab else 3
        if epb:
            cbits += 1
            abits += 1 if ab else 0
            for i in range(numep):
                p = _take(b, pos, 1)
                pos += 1
                ep[:, i, :chans] = ((ep[:, i, :chans] << 1) | p[:, None]) & 255
        if spb:
            cbits += 1
            abits += 1 if ab else 0
            for i in range(0, numep, 2):
                p = _take(b, pos, 1)
                pos += 1
                ep[:, i : i + 2, :chans] = (
                    (ep[:, i : i + 2, :chans] << 1) | p[:, None, None]) & 255
        ep[..., :3] = _expand(ep[..., :3], cbits)
        if ab:
            ep[..., 3] = _expand(ep[..., 3], abits)
        subset = _subsets(ns, partition)
        short = _anchors(ns, partition, subset)
        i0 = _indices(b, pos, ib, short)
        cw = np.array(WEIGHTS[ib], np.int64)
        aw = np.array(WEIGHTS[ib2 if ab and ib2 else ib], np.int64)
        if ab and ib2:
            i1 = _indices(b, pos + 16 * ib - ns, ib2,
                          (np.arange(16) == 0)[None].astype(np.int64))
            sel_c = np.where(index_sel[:, None] == 1, aw[i1], cw[i0])
            sel_a = np.where(index_sel[:, None] == 1, cw[i0], aw[i1])
        else:
            sel_c = sel_a = cw[i0]
        e0 = np.take_along_axis(ep, (2 * subset)[:, :, None], 1)
        e1 = np.take_along_axis(ep, (2 * subset + 1)[:, :, None], 1)
        px = np.empty((k, 16, 4), np.int64)
        px[..., :3] = ((64 - sel_c)[..., None] * e0[..., :3]
                       + sel_c[..., None] * e1[..., :3] + 32) >> 6
        px[..., 3] = ((64 - sel_a) * e0[..., 3] + sel_a * e1[..., 3]
                      + 32) >> 6
        px &= 255
        for r in (1, 2, 3):
            rot = rotation == r
            c = px[rot, :, r - 1].copy()
            px[rot, :, r - 1] = px[rot, :, 3]
            px[rot, :, 3] = c
        out[sel] = px
    return out


def _sign_extend(v: np.ndarray, prec: int) -> np.ndarray:
    v = v & ((1 << prec) - 1) if prec < 16 else v & 0xFFFF
    return np.where(v & (1 << (prec - 1)), v - (1 << prec), v)


def _unquantize(v: np.ndarray, prec: int, signed: bool) -> np.ndarray:
    if not signed:
        if prec >= 15:
            return v
        top = (1 << prec) - 1
        return np.where(v == 0, 0, np.where(
            v == top, 0xFFFF, ((v << 15) + 0x4000) >> (prec - 1)))
    v = ((v & 0xFFFF) ^ 0x8000) - 0x8000  # the stored word as an int16
    if prec >= 16:
        return v
    s, x = v < 0, np.abs(v)
    x = np.where(x == 0, 0, np.where(
        x >= (1 << (prec - 1)) - 1, 0x7FFF, ((x << 15) + 0x4000) >> (prec - 1)))
    return np.where(s, -x, x)


def _finalize(v: np.ndarray, signed: bool) -> np.ndarray:
    """The interpolated values as 8-bit samples: a half float, times 255
    in float32, truncated (0 below 0, 255 above 1)."""
    if signed:
        h = np.where(v < 0, 0x8000 | ((-v) * 31 // 32), v * 31 // 32)
    else:
        h = v * 31 // 64
    f = (h & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float32)
    scaled = np.clip(f * np.float32(255.0), 0, 255).astype(np.int64)
    return np.where(f < 0, 0, np.where(f > 1, 255, scaled))


def _bc6(blocks: np.ndarray, signed: bool) -> np.ndarray:
    n = len(blocks)
    out = np.zeros((n, 16, 4), np.int64)
    m5 = blocks[:, 0].astype(np.int64) & 31
    low = m5 & 3
    mode = np.where(low < 2, low, np.where(low == 2, 2 + (m5 >> 2),
                                           10 + (m5 >> 2)))
    bits = _bits(blocks)
    for m, (ns, tr, pb, epb, rb, gb, bb) in enumerate(_BC6_MODES):
        sel = np.flatnonzero(mode == m)
        if not len(sel):
            continue
        b = bits[sel]
        k = len(sel)
        pos = 2 if m < 2 else 5
        ep = np.zeros((k, 12), np.int64)
        for word, bit in BC6_PACKINGS[m]:
            ep[:, word] |= b[:, pos] << bit
            pos += 1
        partition = _take(b, pos, pb)
        pos += pb
        numep = 12 if ns == 2 else 6
        deltas = (rb, gb, bb)
        if signed:
            for c in range(3):
                ep[:, c] = _sign_extend(ep[:, c], epb)
        if signed or tr:
            for i in range(3, numep):
                ep[:, i] = _sign_extend(ep[:, i], deltas[i % 3])
        if tr:  # the sums are not sign-extended again, as Pillow leaves
            for i in range(3, numep):  # them
                ep[:, i] = (ep[:, i] + ep[:, i % 3]) & ((1 << epb) - 1)
        uq = _unquantize(ep[:, :numep], epb, signed)
        subset = _subsets(ns, partition)
        ib = 3 if ns == 2 else 4
        idx = _indices(b, pos, ib, _anchors(ns, partition, subset))
        w = np.array(WEIGHTS[ib], np.int64)[idx]
        e0 = np.stack([np.take_along_axis(uq, 6 * subset + c, 1)
                       for c in range(3)], -1)
        e1 = np.stack([np.take_along_axis(uq, 6 * subset + 3 + c, 1)
                       for c in range(3)], -1)
        # Pillow's interpolation has no rounding term
        v = (e0 * (64 - w)[..., None] + e1 * w[..., None]) >> 6
        out[sel, :, :3] = _finalize(v, signed)
    return out


def decode_blocks_py(blocks: np.ndarray, n: int, signed: bool = False
                     ) -> np.ndarray:
    """``[k, 16, 4]`` uint8: the pixels of ``k`` blocks (``[k, size]``
    uint8) of decoder ``n``, each in raster order, as ``BcnDecode.c``
    leaves them (``L`` in the first byte, ``RGB`` in the first three)."""
    blocks = np.ascontiguousarray(blocks, np.uint8)
    k = len(blocks)
    if n == 1:
        out = _bc1_colour(blocks, 0, False)
    elif n in (2, 3):
        out = _bc1_colour(blocks, 8, True)
        if n == 2:
            nib = np.stack([blocks[:, :8] & 15, blocks[:, :8] >> 4],
                           2).reshape(k, 16).astype(np.int64)
            out[..., 3] = nib * 17
        else:
            out[..., 3] = _bc3_alpha(blocks, 0)
    elif n == 4:
        out = np.zeros((k, 16, 4), np.int64)
        out[..., 0] = _bc3_alpha(blocks, 0)
    elif n == 5:
        out = np.zeros((k, 16, 4), np.int64)
        out[..., 0] = _bc3_alpha(blocks, 0, signed)
        out[..., 1] = _bc3_alpha(blocks, 8, signed)
        if signed:
            out[..., 2] = 128
    elif n == 6:
        out = _bc6(blocks, signed)
    elif n == 7:
        out = _bc7(blocks)
    else:
        raise ValueError("block compression type unknown")
    return out.astype(np.uint8)


def decode(data: bytes, offset: int, n: int, width: int, height: int,
           signed: bool = False) -> np.ndarray:
    """The image PIL's ``bcn`` decoder ``n`` makes of ``data`` from
    ``offset`` at ``width`` x ``height``, in its mode (``FORMATS``):
    ``[h, w, 4]``, ``[h, w, 3]`` or ``[h, w]`` uint8; PIL's ``OSError``
    where the data end before the last block."""
    size, mode = FORMATS[n]
    bw, bh = (width + 3) // 4, (height + 3) // 4
    avail = max(0, len(data) - max(offset, 0))
    if avail < bw * bh * size:
        raise _pil.truncated(avail % size)
    blocks = np.frombuffer(data, np.uint8, bw * bh * size, offset).reshape(
        bw * bh, size)
    px = _native.bcn_decode(blocks, n, signed)
    if px is None:
        px = decode_blocks_py(blocks, n, signed)
    img = px.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(
        4 * bh, 4 * bw, 4)[:height, :width]
    if mode == "L":
        return np.ascontiguousarray(img[..., 0])
    return np.ascontiguousarray(img[..., : len(mode)])
