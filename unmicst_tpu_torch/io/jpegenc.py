"""A baseline JPEG writer in numpy and the standard library: the bytes of
``Image.fromarray(image).save(path)`` for a ``.jpg`` / ``.jpeg`` /
``.jpe`` / ``.jfif`` name at PIL's defaults, which the JAX toolbox's
``imwrite`` reaches (``unmicst_tpu/utils/imtools.py:60-67``).  PIL runs
libjpeg-turbo there; this is its compressor, step for step:

* quality 75: the Annex K tables through ``jpeg_quality_scaling``
  (``(q * 50 + 50) // 100``, clamped to 1..255);
* the markers in ``jcmarker.c``'s order: SOI, the JFIF 1.01 APP0 (no
  units, density 1x1), one DQT per table, SOF0, one DHT per table as the
  scan first needs it, SOS, the scan, EOI; the standard Huffman tables,
  no restart interval;
* modes ``1`` (bool, as 0/255) and ``L`` as one gray component; ``RGB``
  through ``jccolor.c``'s fixed-point RGB to YCbCr, 4:2:0 with
  ``jcsample.c``'s h2v2 box average (bias 1, 2, 1, 2 along a row);
* the right and bottom edges replicated to whole blocks (``jcprepct.c``,
  ``expand_right_edge``), and the blocks of an MCU past them "dummy":
  no AC, the DC of the block before (``jccoefct.c``);
* ``jfdctint.c``'s islow forward DCT over all blocks at once, then
  ``jcdctmgr.c``'s quantisation by reciprocal multiplication;
* ``jchuff.c``'s entropy coding: DC differences per component, AC runs
  with ZRL and EOB, 0xFF stuffed, the last byte padded with ones.

Modes PIL cannot write as JPEG (``LA``, ``RGBA``, ``I;16``, ``I``, ``F``)
raise its ``OSError``; a dtype it has no mode for its ``TypeError``.

The entropy coding runs in the port's native host library
(``native/jpegenc.cpp``) when it loads, and otherwise in
:func:`encode_blocks_py`, the plain version the tests hold it to byte
for byte.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from unmicst_tpu_torch.io import _native
from unmicst_tpu_torch.io.jpeg import NATURAL_ORDER
from unmicst_tpu_torch.io.png import array_mode

QUALITY = 75
# ITU T.81 Annex K, K.1 and K.2, in natural (row-major) order
_BASE_LUMA = (
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99)
_BASE_CHROMA = (
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99) + (
    99,) * 32
# Annex K.3 (BITS, then HUFFVAL): DC luminance, AC luminance, DC and AC
# chrominance, as libjpeg's std_huff_tables
_STD_HUFF = {
    (0, 0): bytes.fromhex("00010501010101010100000000000000"
                          "000102030405060708090a0b"),
    (1, 0): bytes.fromhex(
        "0002010303020403050504040000017d01020300041105122131410613516107"
        "227114328191a1082342b1c11552d1f02433627282090a161718191a25262728"
        "292a3435363738393a434445464748494a535455565758595a63646566676869"
        "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
        "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
        "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    (0, 1): bytes.fromhex("00030101010101010101010000000000"
                          "000102030405060708090a0b"),
    (1, 1): bytes.fromhex(
        "0002010204040304070504040001027700010203110405213106124151076171"
        "1322328108144291a1b1c109233352f0156272d10a162434e125f11718191a26"
        "2728292a35363738393a434445464748494a535455565758595a636465666768"
        "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5"
        "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
        "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}
_ZIGZAG = np.asarray(NATURAL_ORDER[:64], np.int64)


def quant_table(base) -> np.ndarray:
    """``jpeg_add_quant_table`` at quality 75 (``jpeg_quality_scaling``:
    a scale of 50%) with ``force_baseline``: int64[64] in natural
    order."""
    q = (np.asarray(base, np.int64) * (200 - 2 * QUALITY) + 50) // 100
    return np.clip(q, 1, 255)


def huff_codes(spec: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """``jpeg_make_c_derived_tbl``: the code and its length of each of
    the 256 symbols (length 0: no code)."""
    bits, vals = spec[:16], spec[16:]
    code_of = np.zeros(256, np.int64)
    size_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code_of[vals[k]] = code
            size_of[vals[k]] = length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, size_of


# -- colour and sampling (jccolor.c, jcsample.c, jcprepct.c) -----------------


def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


_I = np.arange(256, dtype=np.int64)
_HALF = 1 << 15
_CBCR_OFF = 128 << 16
_Y_TAB = (_fix(0.29900) * _I, _fix(0.58700) * _I, _fix(0.11400) * _I + _HALF)
_CB_TAB = (-_fix(0.16874) * _I, -_fix(0.33126) * _I,
           _fix(0.50000) * _I + _CBCR_OFF + _HALF - 1)
_CR_TAB = (_fix(0.50000) * _I + _CBCR_OFF + _HALF - 1,
           -_fix(0.41869) * _I, -_fix(0.08131) * _I)


def rgb_to_ycc(rgb: np.ndarray) -> List[np.ndarray]:
    """``rgb_ycc_convert``: Y, Cb and Cr planes (uint8)."""
    r, g, b = (rgb[..., k] for k in range(3))
    return [((t[0][r] + t[1][g] + t[2][b]) >> 16).astype(np.uint8)
            for t in (_Y_TAB, _CB_TAB, _CR_TAB)]


def _pad(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """The last row and column repeated out to ``rows`` x ``cols``."""
    h, w = plane.shape
    return np.pad(plane, ((0, rows - h), (0, cols - w)), mode="edge")


def downsample_h2v2(plane: np.ndarray, out_rows: int,
                    out_cols: int) -> np.ndarray:
    """A chroma plane through ``jcprepct.c`` and ``h2v2_downsample``: its
    rows made even and its columns ``2 * out_cols`` by repetition, each
    2x2 box summed with the bias 1, 2, 1, 2 along a row, then the last
    row repeated to ``out_rows``."""
    h = plane.shape[0]
    x = _pad(plane, h + (h & 1), 2 * out_cols).astype(np.int64)
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    bias = np.tile(np.array([1, 2], np.int64), out_cols)[:out_cols]
    return _pad(((s + bias) >> 2).astype(np.uint8), out_rows, out_cols)


# -- the forward DCT and the quantisation (jfdctint.c, jcdctmgr.c) ------------

_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, pass1: bool):
    """One pass of ``jpeg_fdct_islow`` over 8 int64 arrays."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if pass1:
        out[0] = (tmp10 + tmp11) << 2
        out[4] = (tmp10 - tmp11) << 2
        n = 13 - 2
    else:
        out[0] = _descale(tmp10 + tmp11, 2)
        out[4] = _descale(tmp10 - tmp11, 2)
        n = 13 + 2
    z1 = (tmp12 + tmp13) * _F0541
    out[2] = _descale(z1 + tmp13 * _F0765, n)
    out[6] = _descale(z1 - tmp12 * _F1847, n)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5 = tmp4 * _F0298, tmp5 * _F2053
    tmp6, tmp7 = tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return out


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """``[n, 8, 8]`` uint8 samples -> ``[n, 64]`` int64 coefficients,
    scaled up by 8, bit for bit as ``jfdctint.c``."""
    x = blocks.astype(np.int64) - 128
    rows = _fdct_1d([x[:, :, k] for k in range(8)], True)  # [n, row] each
    cols = _fdct_1d([np.stack([rows[k][:, r] for k in range(8)], 1)
                     for r in range(8)], False)  # cols[r]: [n, col]
    return np.stack(cols, 1).reshape(-1, 64)


def _divisors(q: np.ndarray):
    """``compute_reciprocal`` of each ``q << 3`` (16-bit elements):
    reciprocal, correction and shift (the whole of ``r``)."""
    d = q.astype(np.int64) << 3
    b = np.array([int(v).bit_length() - 1 for v in d], np.int64)
    r = 16 + b
    fq = (np.int64(1) << r) // d
    fr = (np.int64(1) << r) % d
    c = d // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr <= d // 2, fq, fq + 1))
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= d // 2), c + 1, c)
    return fq, c, r


def quantize(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """``jcdctmgr.c``'s ``quantize``: ``[n, 64]`` int16 in natural
    order."""
    fq, c, r = _divisors(q)
    mag = ((np.abs(coef) + c) * fq) >> r
    return np.where(coef < 0, -mag, mag).astype(np.int16)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """A plane of whole blocks -> ``[rows, cols, 8, 8]``."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


# blocks per pass of the forward DCT: about 30 int64 temporaries of this
# many coefficients bound its memory
_FDCT_CHUNK = 1 << 14


def _component(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Quantised coefficients of a padded plane: ``[rows, cols, 64]``."""
    b = _blocks(plane)
    flat = b.reshape(-1, 8, 8)
    coef = np.empty((len(flat), 64), np.int16)
    for a in range(0, len(flat), _FDCT_CHUNK):
        coef[a : a + _FDCT_CHUNK] = quantize(
            fdct_islow(flat[a : a + _FDCT_CHUNK]), q)
    return coef.reshape(b.shape[0], b.shape[1], 64)


# -- the entropy coding (jchuff.c), the plain version -------------------------


def encode_blocks_py(blocks: np.ndarray, slots: np.ndarray,
                     dc_tables, ac_tables) -> bytes:
    """Huffman-code ``blocks`` (``[n, 64]`` int16, natural order, in scan
    order), block ``i`` of the scan component ``slots[i]`` whose tables
    are ``dc_tables[s]`` / ``ac_tables[s]`` (code and size arrays): DC
    predictors per component, 0xFF stuffed, padded with ones.  The plain
    version of the native encoder."""
    out = bytearray()
    acc = nacc = 0
    last = [0] * (int(slots.max()) + 1 if len(slots) else 1)
    zz = blocks[:, _ZIGZAG].astype(np.int64).tolist()
    slot_of = np.asarray(slots).tolist()
    dcs = [(c.tolist(), s.tolist()) for c, s in dc_tables]
    acs = [(c.tolist(), s.tolist()) for c, s in ac_tables]

    def put(code: int, size: int) -> None:
        nonlocal acc, nacc
        acc = (acc << size) | (code & ((1 << size) - 1))
        nacc += size
        while nacc >= 8:
            byte = (acc >> (nacc - 8)) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
            nacc -= 8
        acc &= (1 << nacc) - 1

    for blk, t in zip(zz, slot_of):
        dcode, dsize = dcs[t]
        acode, asize = acs[t]
        diff = blk[0] - last[t]
        last[t] = blk[0]
        nbits = abs(diff).bit_length()
        put(dcode[nbits], dsize[nbits])
        if nbits:
            put(diff - 1 if diff < 0 else diff, nbits)
        run = 0
        for v in blk[1:]:
            if v == 0:
                run += 1
                continue
            while run > 15:
                put(acode[0xF0], asize[0xF0])
                run -= 16
            nbits = abs(v).bit_length()
            sym = (run << 4) + nbits
            put(acode[sym], asize[sym])
            put(v - 1 if v < 0 else v, nbits)
            run = 0
        if run:
            put(acode[0], asize[0])
    if nacc:
        put(0x7F, 8 - nacc)
    return bytes(out)


# -- the stream ---------------------------------------------------------------


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _dqt(slot: int, q: np.ndarray) -> bytes:
    return _segment(0xDB, bytes([slot]) + bytes(q[_ZIGZAG].tolist()))


def _dht(ac: int, slot: int) -> bytes:
    return _segment(0xC4, bytes([(ac << 4) | slot]) + _STD_HUFF[(ac, slot)])


_JFIF = _segment(0xE0, b"JFIF\0" + bytes([1, 1, 0, 0, 1, 0, 1, 0, 0]))


def encode_jpeg(image: np.ndarray) -> bytes:
    """The bytes of ``Image.fromarray(image).save(f, "JPEG")`` (see the
    module docstring)."""
    mode, img = array_mode(image)
    h, w = img.shape[:2]
    if h == 0 or w == 0:  # PIL's first check, before the mode's
        raise ValueError("cannot write empty image as JPEG")
    if mode not in ("1", "L", "RGB"):
        raise OSError(f"cannot write mode {mode} as JPEG")
    if h > 65500 or w > 65500:  # libjpeg's JPEG_MAX_DIMENSION
        raise OSError("broken data stream when writing image file")
    qy = quant_table(_BASE_LUMA)
    if mode != "RGB":
        plane = img * np.uint8(255) if mode == "1" else img
        hb, wb = -(-h // 8), -(-w // 8)
        coef = _component(_pad(plane, 8 * hb, 8 * wb), qy).reshape(-1, 64)
        slots = np.zeros(len(coef), np.uint8)
        head = (_JFIF + _dqt(0, qy)
                + _segment(0xC0, struct.pack(">BHHB", 8, h, w, 1)
                           + bytes([1, 0x11, 0]))
                + _dht(0, 0) + _dht(1, 0)
                + _segment(0xDA, bytes([1, 1, 0x00, 0, 63, 0])))
        tables = [0]
    else:
        qc = quant_table(_BASE_CHROMA)
        y, cb, cr = rgb_to_ycc(img)
        mr, mc = -(-h // 16), -(-w // 16)
        hb, wb = -(-h // 8), -(-w // 8)
        g = np.zeros((2 * mr, 2 * mc, 64), np.int16)
        g[:hb, :wb] = _component(_pad(y, 8 * hb, 8 * wb), qy)
        if wb & 1:  # a dummy column: the DC of the block to its left
            g[:hb, wb, 0] = g[:hb, wb - 1, 0]
        if hb & 1:  # a dummy row: the DC of its MCU's first-row last block
            g[hb, :, 0] = np.repeat(g[hb - 1, 1::2, 0], 2)
        chroma = [_component(downsample_h2v2(p, 8 * mr, 8 * mc), qc)
                  for p in (cb, cr)]
        luma = g.reshape(mr, 2, mc, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
            mr, mc, 4, 64)
        coef = np.concatenate([luma, chroma[0][:, :, None],
                               chroma[1][:, :, None]], 2).reshape(-1, 64)
        slots = np.tile(np.array([0, 0, 0, 0, 1, 2], np.uint8), mr * mc)
        head = (_JFIF + _dqt(0, qy) + _dqt(1, qc)
                + _segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                           + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
                + _dht(0, 0) + _dht(1, 0) + _dht(0, 1) + _dht(1, 1)
                + _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11,
                                        0, 63, 0])))
        tables = [0, 1, 1]
    dc = [huff_codes(_STD_HUFF[(0, t)]) for t in tables]
    ac = [huff_codes(_STD_HUFF[(1, t)]) for t in tables]
    coef = np.ascontiguousarray(coef, np.int16)
    scan = _native.jpeg_huff_encode(coef, slots, dc, ac)
    if scan is None:
        scan = encode_blocks_py(coef, slots, dc, ac)
    return b"\xff\xd8" + head + scan + b"\xff\xd9"


def write_jpeg(path: str, image: np.ndarray) -> None:
    """Write ``image`` as ``Image.fromarray(image).save(path)`` writes a
    JPEG (:func:`encode_jpeg`)."""
    data = encode_jpeg(image)
    with open(path, "wb") as f:
        f.write(data)
