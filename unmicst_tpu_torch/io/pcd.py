"""Kodak PhotoCD images read as PIL 12 reads them for the JAX package
(``PIL/PcdImagePlugin.py``): its TIFF fallback's ``Image.open`` of a
file under a TIFF name, and the toolbox's ``imread``.

PIL reads the 768 x 512 base image only: ``PCD_`` at byte 2048 names the
file, the low two bits of byte 2048 + 1538 its orientation (1: turned 90
degrees, 3: 270, counter-clockwise; 512 x 768 then), and from 96 * 2048
on each pair of rows is 768 + 768 luma samples, then 384 Cb and 384 Cr
samples shared by each 2 x 2 block (``PcdDecode.c``).  PhotoYCC becomes
RGB through ``Unpack.c``'s ``YCC;P`` tables: red ``L[y] + CR[cr]``,
green ``L[y] + GB[cb] + GR[cr]``, blue ``L[y] + CB[cb]``, each clipped to
0-255.  The tables below were read off Pillow 12.1's decode of files
that sweep every pair of values (``tests/fixtures/torch_rasters/make.py``
``pcd_tables``); the additive form reproduces that decode bit for bit.
Data that end early raise PIL's ``OSError``.
"""

from __future__ import annotations

import numpy as np

from unmicst_tpu_torch.io import _pil

W, H = 768, 512
OFFSET = 96 * 2048


def _table(start: int, sign: int, steps) -> np.ndarray:
    """A 256-entry table from its first value and its steps, one digit
    each (their magnitude; ``sign`` their sign)."""
    d = np.array([int(c) for c in "".join(steps)], np.int32) * sign
    return np.concatenate([[start], start + np.cumsum(d)]).astype(np.int32)


_L = _table(0, 1, (
    "1211212112112112112121121121121121211211211211212112112112121121"
    "1211211212112112112112121121121121121211211211211212112112112121"
    "1211211211212112112112112121121121121121211211211212112112112112"
    "121121121121121211211211211212112112112121121121121121211211211"))
_CR = _table(-249, 1, (
    "2222212222122222122222122221222221222212222212222212222122222122"
    "2212222212222212222122222122221222221222221222212222212222122222"
    "1222221212212222212222212222122222122221222221222221222212222212"
    "222122222122222122221222221222212222212222212222122222122221222"))
_CB = _table(-345, 1, (
    "2232223222232222322232222322232222322232222322223222322223222322"
    "2232222322232222322232222322223222322223222322223222322223222232"
    "2232222322232222322223222321223222322223222232223222232223222232"
    "222322232222322232222322232222322223222322223222322223222232223"))
_GB = _table(67, -1, (
    "0101001010100101010010101001010101001010100101010010101001010100"
    "1010100101010010101001010100101010010101001010100101010100101010"
    "0101010010101001010100101010000101001010100101010010101001010100"
    "101010100101010010101001010100101010010101001010100101010010101"))
_GR = _table(127, -1, (
    "1111110111111111111101111111111111011111111111101111111111111011"
    "1111111111101111111111110111111111111101111111111111011111111111"
    "1101111110111110111111111111101111111111111011111111111110111111"
    "111111011111111111110111111111111101111111111110111111111111101"))


def open_header(data: bytes) -> int:
    """``PcdImageFile._open``: the orientation (0-3), or ``SyntaxError``
    (``IndexError`` where the file ends before the orientation byte)."""
    s = data[2048 : 2048 + 1539]
    if not s.startswith(b"PCD_"):
        raise SyntaxError("not a PCD file")
    return s[1538] & 3


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray
               ) -> np.ndarray:
    """``[..., 3]`` uint8 RGB of PhotoYCC samples, as ``YCC;P`` unpacks
    them."""
    ly = _L[y]
    rgb = np.stack([ly + _CR[cr], ly + _GB[cb] + _GR[cr], ly + _CB[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def read_frame(data: bytes, index) -> np.ndarray:
    """The base image, as ``np.asarray(Image.open(f))`` gives it;
    ``EOFError`` past frame 0."""
    orientation = open_header(data)
    if index:
        raise EOFError("no more images in file")
    chunk = 3 * W
    pairs = _pil.raw_rows(data, OFFSET, chunk, H // 2)
    y = pairs[:, : 2 * W].reshape(H, W)
    cb = np.repeat(pairs[:, 2 * W : 2 * W + W // 2], 2, 1)
    cr = np.repeat(pairs[:, 2 * W + W // 2 :], 2, 1)
    rgb = ycc_to_rgb(y, np.repeat(cb, 2, 0), np.repeat(cr, 2, 0))
    if orientation == 1:
        return np.ascontiguousarray(np.rot90(rgb, 1))
    if orientation == 3:
        return np.ascontiguousarray(np.rot90(rgb, 3))
    return rgb
