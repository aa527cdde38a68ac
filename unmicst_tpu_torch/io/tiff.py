"""TIFF reading and writing for slide IO, in numpy and the standard library.

A subset of ``unmicst_tpu/io/tiff.py`` with no PIL.  Deflate, LZW and
PackBits segments and predictor 2 go through the port's native codec
(:mod:`unmicst_tpu_torch.io._native`, C++ built at first use) when it
loads, and through the Python codecs below when it does not:

* :class:`TiffFile` reads classic and BigTIFF files in either byte order,
  strip- or tile-organised pages, uncompressed, Deflate (zlib), LZW,
  PackBits, LZMA (xz) or zstd (through the host's libzstd,
  :mod:`unmicst_tpu_torch.io.zstd`), with horizontal predictor 2,
  8/16/32/64-bit samples, and the reduced-resolution levels a page hangs
  off its SubIFDs (tag 330: :meth:`TiffFile.subifd_page`,
  :meth:`TiffFile.read_subifd`);
* :class:`TiffWriter` writes grayscale pages, classic or BigTIFF, in
  strips or tiles, uncompressed, Deflate or zstd, appending to an existing
  file by re-chaining the IFD list — the reference's output contract
  (``UnMicst1-5.py:834-843``: bigtiff, no metadata, per-page append) —
  and pyramidal pages (:meth:`TiffWriter.write_pyramid`: 2x box-mean
  levels chained through SubIFDs, every level tiled).

``imread``, ``num_pages`` and ``imwrite`` keep the JAX package's names.
Where the reader refuses a page, ``imread`` (and ``slides.read_channel``)
turn to :func:`read_page_fallback`, the port's stand-in for the JAX
package's PIL fallback, which opens the file by content and reads whole:
a PNG, JPEG or BMP under a TIFF name; JPEG-compressed pages (compression
7), gray, colour or plane by plane; old-style JPEG pages (6), in either
form, one strip or several; float32 pages with the floating-point
predictor (3); gray and palette 1-, 2- and 4-bit pages and gray 12-bit
ones, CCITT bilevel ones (2-4, :mod:`unmicst_tpu_torch.io.ccitt`) among
them; subsampled YCbCr pages; 8-bit RGB, RGBA and YCbCr pages stored
plane by plane.  The windowed and pyramid reads keep refusing them, as
the JAX package's do.
"""

from __future__ import annotations

import functools
import lzma
import os
import struct
import sys
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from unmicst_tpu_torch.io import _native
from unmicst_tpu_torch.io import zstd as _zstd

TAG_NEW_SUBFILE_TYPE = 254
TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_IMAGE_DESCRIPTION = 270
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_PLANAR_CONFIG = 284
TAG_PREDICTOR = 317
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTE_COUNTS = 325
TAG_SUBIFDS = 330
TAG_SAMPLE_FORMAT = 339
TAG_JPEG_TABLES = 347
# tags only the fallback reads (:attr:`TiffPage.fallback_tags`)
TAG_FILL_ORDER = 266
TAG_T4_OPTIONS = 292
TAG_JPEG_IF_OFFSET = 513  # old-style JPEG: a complete JPEG stream
TAG_JPEG_IF_LENGTH = 514
TAG_JPEG_RESTART_INTERVAL = 515
TAG_JPEG_QTABLES = 519  # old-style JPEG's table form: offsets of tables
TAG_JPEG_DCTABLES = 520
TAG_JPEG_ACTABLES = 521
TAG_YCBCR_COEFFICIENTS = 529
TAG_YCBCR_SUBSAMPLING = 530
TAG_REFERENCE_BLACK_WHITE = 532
TAG_EXTRA_SAMPLES = 338
_FALLBACK_TAGS = (TAG_FILL_ORDER, TAG_T4_OPTIONS, TAG_JPEG_IF_OFFSET,
                  TAG_JPEG_IF_LENGTH, TAG_JPEG_RESTART_INTERVAL,
                  TAG_JPEG_QTABLES, TAG_JPEG_DCTABLES, TAG_JPEG_ACTABLES,
                  TAG_YCBCR_COEFFICIENTS, TAG_YCBCR_SUBSAMPLING,
                  TAG_REFERENCE_BLACK_WHITE, TAG_EXTRA_SAMPLES)

COMPRESSION_NONE = 1
COMPRESSION_CCITT_RLE = 2  # bilevel, Modified Huffman rows (io/ccitt.py)
COMPRESSION_CCITT_T4 = 3
COMPRESSION_CCITT_T6 = 4
COMPRESSION_LZW = 5
COMPRESSION_OJPEG = 6  # old-style JPEG (TIFF 6.0 section 22)
COMPRESSION_JPEG = 7  # one JPEG stream a strip or tile (TIFF Technote 2)
COMPRESSION_DEFLATE_ADOBE = 8
COMPRESSION_DEFLATE = 32946
COMPRESSION_PACKBITS = 32773
COMPRESSION_LZMA = 34925  # libtiff: one .xz stream per strip
COMPRESSION_ZSTD = 50000  # libtiff/tifffile: one zstd frame per strip

# TIFF field type -> (struct char, size)
_FIELD_TYPES = {
    1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 4),
    6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("i", 4),
    11: ("f", 4), 12: ("d", 8), 13: ("I", 4), 16: ("Q", 8), 17: ("q", 8),
    18: ("Q", 8),
}


class PageTooLargeError(ValueError):
    """Full-page materialisation refused."""


def _unpack_lzw(data: bytes, max_out: int = 0) -> bytes:
    """TIFF LZW (MSB-first codes, early change); stops at ``max_out``
    bytes when given (the strip geometry bounds the output)."""
    result = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    bitpos, nbits = 0, 9
    prev: Optional[bytes] = None
    maxlen = len(data) * 8
    while bitpos + nbits <= maxlen:
        chunk = data[bitpos >> 3 : (bitpos >> 3) + 4]
        val = int.from_bytes(chunk.ljust(4, b"\0"), "big")
        code = (val >> (32 - (bitpos & 7) - nbits)) & ((1 << nbits) - 1)
        bitpos += nbits
        if code == 256:  # clear
            table = table[:258]
            nbits, prev = 9, None
            continue
        if code == 257:  # end of information
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("corrupt LZW stream")
        result += entry
        prev = entry
        if max_out and len(result) >= max_out:
            return bytes(result[:max_out])
        if len(table) >= (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    return bytes(result)


def _unpack_packbits(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i : i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i : i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _encode_deflate(data: bytes, level: int) -> bytes:
    """One Deflate strip or tile (``unmicst_tpu/io/tiff.py:157-172``):
    levels 1-3 through the native greedy encoder, 4-9 through the native
    chain-search encoder at zlib's parameters for that level, zlib at the
    level when the library is absent."""
    out = (_native.deflate(data) if level <= 3
           else _native.deflate_chain(data, level))
    return out if out is not None else zlib.compress(data, level)


def _decode(data: bytes, compression: int, max_out: int):
    """One segment, bounded by ``max_out`` (its geometry's bytes): the
    native codec first, then the Python one, whose decode is more
    lenient; the caller truncates what comes out longer
    (``unmicst_tpu/io/tiff.py:175-230``)."""
    if compression == COMPRESSION_NONE:
        return data
    if compression in (COMPRESSION_DEFLATE, COMPRESSION_DEFLATE_ADOBE):
        # the slack covers writer-padded final strips
        try:
            out = _native.inflate(data, max_out + 65536)
            if out is not None:
                return out
        except ValueError:
            pass  # over-slack padding or a stream the native codec
            # refuses: zlib below decodes and the caller truncates
        try:
            # bounded: a crafted strip must not decompression-bomb the host
            return zlib.decompressobj().decompress(data, max_out + 65536)
        except zlib.error as exc:
            raise ValueError(f"corrupt deflate strip: {exc}") from None
    if compression == COMPRESSION_LZW:
        try:
            out = _native.lzw_decode(data, max_out)
            if out is not None:
                return out
        except ValueError:
            pass  # the native codec's stricter contract: Python below
        return _unpack_lzw(data, max_out)
    if compression == COMPRESSION_PACKBITS:
        try:
            out = _native.packbits_decode(data, max_out)
            if out is not None:
                return out
        except ValueError:
            pass
        return _unpack_packbits(data)
    if compression == COMPRESSION_LZMA:
        try:
            # bounded like deflate
            return lzma.LZMADecompressor().decompress(data, max_out + 65536)
        except lzma.LZMAError as exc:
            raise ValueError(f"corrupt LZMA strip: {exc}") from None
    if compression == COMPRESSION_ZSTD:
        # one frame per strip or tile, bounded like deflate
        return _zstd.decompress(data, max_out + 65536)
    raise NotImplementedError(
        f"TIFF compression {compression} is not read by unmicst_tpu_torch "
        "(none, deflate, LZW, PackBits, LZMA and zstd are; JPEG pages are "
        "read whole, the rest of what the JAX package reads through PIL is "
        "item M17)"
    )


def _undo_predictor(arr: np.ndarray) -> np.ndarray:
    """Undo horizontal differencing in place on ``(rows, width,
    samples)``, along the width per sample; natively for C-contiguous
    single-sample 1- and 2-byte rows (``unmicst_tpu/io/tiff.py:249-270``)."""
    if (arr.shape[-1] == 1 and arr.flags["C_CONTIGUOUS"]
            and arr.dtype.itemsize in (1, 2)
            and _native.predictor_undo(arr.reshape(arr.shape[0], -1))
            is not None):
        return arr
    np.cumsum(arr, axis=1, dtype=arr.dtype, out=arr)
    return arr


@dataclass
class TiffPage:
    width: int
    height: int
    bits: int
    sample_format: int  # 1 uint, 2 int, 3 float
    samples: int
    compression: int
    predictor: int
    planar: int
    rows_per_strip: int
    offsets: np.ndarray  # strip or tile offsets
    counts: np.ndarray
    tile_width: int = 0
    tile_length: int = 0
    description: str = ""
    subifds: Optional[np.ndarray] = None  # tag 330: the pyramid's levels
    photometric: Optional[int] = None  # tag 262, None where it is absent
    jpeg_tables: Optional[bytes] = None  # tag 347
    # the tags of _FALLBACK_TAGS the page has (rationals as float64)
    fallback_tags: dict = field(default_factory=dict)

    @property
    def tiled(self) -> bool:
        return self.tile_width > 0

    @property
    def dtype(self) -> np.dtype:
        if self.bits not in (8, 16, 32, 64) or self.sample_format not in (1, 2, 3):
            raise NotImplementedError(
                f"{self.bits}-bit samples of format {self.sample_format} "
                "not supported"
            )
        if self.sample_format == 3 and self.bits == 8:
            raise NotImplementedError("8-bit float TIFF samples")
        kind = {1: "u", 2: "i", 3: "f"}[self.sample_format]
        return np.dtype(f"{kind}{self.bits // 8}")


class TiffFile:
    """Random-access TIFF reader (classic + BigTIFF).  ``chain=False``
    reads the header only: :meth:`page_at` then walks the page chain to
    the page it is asked for, as PIL's ``seek`` does, and ``pages`` stays
    empty."""

    def __init__(self, path: str, chain: bool = True):
        self.path = path
        self._fh = open(path, "rb")
        try:
            self._parse(chain)
        except Exception:
            self._fh.close()
            raise

    def _parse(self, chain: bool) -> None:
        fh = self._fh
        self._fsize = os.fstat(fh.fileno()).st_size
        header = fh.read(16)
        if header[:2] not in (b"II", b"MM") or len(header) < 8:
            raise ValueError(f"{self.path}: not a TIFF file")
        self.byteorder = "<" if header[:2] == b"II" else ">"
        magic = struct.unpack(self.byteorder + "H", header[2:4])[0]
        if magic == 42:
            self.big = False
            offset = struct.unpack(self.byteorder + "I", header[4:8])[0]
        elif magic == 43 and len(header) == 16:
            self.big = True
            offset = struct.unpack(self.byteorder + "Q", header[8:16])[0]
        else:
            raise ValueError(f"{self.path}: bad TIFF magic {magic}")
        self.pages: List[TiffPage] = []
        self._first = offset
        if not chain:
            return
        seen = set()
        while offset:
            if offset in seen:
                raise ValueError(f"{self.path}: IFD chain cycles at {offset:#x}")
            seen.add(offset)
            page, offset = self._read_ifd(offset)
            self.pages.append(page)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def page_at(self, index: int) -> TiffPage:
        """Page ``index`` of the page chain, as PIL's ``seek`` finds it:
        the IFDs before it are followed by their next-IFD pointers alone,
        and past the chain's end (or where it cycles) ``EOFError``."""
        offset, seen = self._first, set()
        for _ in range(index):
            if not offset or offset in seen:
                raise EOFError("attempt to seek outside sequence")
            seen.add(offset)
            offset = self._next_ifd(offset)
        if not offset or offset in seen:
            raise EOFError("attempt to seek outside sequence")
        return self._read_ifd(offset)[0]

    def _next_ifd(self, offset: int) -> int:
        """The next-IFD pointer of the IFD at ``offset``."""
        bo, fh = self.byteorder, self._fh
        cnt_fmt, off_fmt = ("Q", "Q") if self.big else ("H", "I")
        fh.seek(offset)
        head = fh.read(struct.calcsize(cnt_fmt))
        if len(head) < struct.calcsize(cnt_fmt):
            raise ValueError(f"{self.path}: truncated IFD at {offset:#x}")
        (n,) = struct.unpack(bo + cnt_fmt, head)
        fh.seek(offset + len(head) + (20 if self.big else 12) * n)
        tail = fh.read(struct.calcsize(off_fmt))
        if len(tail) < struct.calcsize(off_fmt):
            raise ValueError(f"{self.path}: truncated IFD at {offset:#x}")
        return struct.unpack(bo + off_fmt, tail)[0]

    def _read_ifd(self, offset: int) -> Tuple[TiffPage, int]:
        bo, fh, big = self.byteorder, self._fh, self.big
        cnt_fmt, off_fmt, slot = ("Q", "Q", 8) if big else ("H", "I", 4)
        entry_size = 20 if big else 12
        fh.seek(offset)
        head = fh.read(struct.calcsize(cnt_fmt))
        if len(head) < struct.calcsize(cnt_fmt):
            raise ValueError(f"{self.path}: truncated IFD at {offset:#x}")
        (n,) = struct.unpack(bo + cnt_fmt, head)
        if entry_size * n > self._fsize:
            raise ValueError(f"{self.path}: IFD claims {n} entries")
        raw = fh.read(entry_size * n)
        tail = fh.read(slot)
        if len(raw) < entry_size * n or len(tail) < slot:
            raise ValueError(f"{self.path}: truncated IFD at {offset:#x}")
        (next_ifd,) = struct.unpack(bo + off_fmt, tail)
        tags = {}
        for i in range(n):
            ent = raw[i * entry_size : (i + 1) * entry_size]
            tag, ftype = struct.unpack(bo + "HH", ent[:4])
            (count,) = struct.unpack(bo + ("Q" if big else "I"),
                                     ent[4 : 4 + slot])
            payload = ent[4 + slot :]
            if ftype not in _FIELD_TYPES:
                continue
            ch, sz = _FIELD_TYPES[ftype]
            total = sz * count * (2 if ftype in (5, 10) else 1)
            if total <= slot:
                data = payload[:total]
            else:
                if total > self._fsize:
                    continue
                (ptr,) = struct.unpack(bo + off_fmt, payload[:slot])
                pos = fh.tell()
                fh.seek(ptr)
                data = fh.read(total)
                fh.seek(pos)
                if len(data) < total:
                    continue
            if ftype == 2:
                tags[tag] = data.rstrip(b"\0").decode("utf-8", "replace")
            elif ftype not in (5, 10):
                tags[tag] = np.frombuffer(
                    data, dtype=np.dtype(ch).newbyteorder(bo), count=count
                )
            elif tag in _FALLBACK_TAGS:  # a rational: numerator / denominator
                pairs = np.frombuffer(data, np.dtype(ch).newbyteorder(bo),
                                      2 * count).reshape(count, 2)
                with np.errstate(divide="ignore", invalid="ignore"):
                    tags[tag] = pairs[:, 0] / pairs[:, 1].astype(np.float64)

        def scalar(tag, default=None):
            v = tags.get(tag)
            if v is None or isinstance(v, str) or not len(v):
                return default
            return int(v[0])

        def array(tag):
            return np.atleast_1d(
                tags.get(tag, np.array([], np.int64))
            ).astype(np.int64)

        width, height = scalar(TAG_IMAGE_WIDTH), scalar(TAG_IMAGE_LENGTH)
        if width is None or height is None:
            raise ValueError("TIFF page missing dimensions")
        if not (0 < width <= 1 << 20 and 0 < height <= 1 << 20):
            raise ValueError(f"implausible TIFF page dimensions {width}x{height}")
        tiled = TAG_TILE_OFFSETS in tags
        page = TiffPage(
            width=width, height=height,
            bits=scalar(TAG_BITS_PER_SAMPLE, 1),
            sample_format=scalar(TAG_SAMPLE_FORMAT, 1),
            samples=scalar(TAG_SAMPLES_PER_PIXEL, 1),
            compression=scalar(TAG_COMPRESSION, 1),
            predictor=scalar(TAG_PREDICTOR, 1),
            planar=scalar(TAG_PLANAR_CONFIG, 1),
            rows_per_strip=scalar(TAG_ROWS_PER_STRIP, height),
            offsets=array(TAG_TILE_OFFSETS if tiled else TAG_STRIP_OFFSETS),
            counts=array(TAG_TILE_BYTE_COUNTS if tiled
                         else TAG_STRIP_BYTE_COUNTS),
            description=(tags[TAG_IMAGE_DESCRIPTION]
                         if isinstance(tags.get(TAG_IMAGE_DESCRIPTION), str)
                         else ""),
        )
        if tiled:
            page.tile_width = scalar(TAG_TILE_WIDTH, 0)
            page.tile_length = scalar(TAG_TILE_LENGTH, 0)
            if not (0 < page.tile_width <= 1 << 20
                    and 0 < page.tile_length <= 1 << 20):
                raise ValueError("implausible TIFF tile geometry")
        if len(page.offsets) != len(page.counts):
            raise ValueError("TIFF segment offsets/byte counts length mismatch")
        if isinstance(tags.get(TAG_SUBIFDS), np.ndarray):
            page.subifds = array(TAG_SUBIFDS)
        page.photometric = scalar(TAG_PHOTOMETRIC)
        if isinstance(tags.get(TAG_JPEG_TABLES), np.ndarray):
            page.jpeg_tables = tags[TAG_JPEG_TABLES].tobytes()
        page.fallback_tags = {t: tags[t] for t in _FALLBACK_TAGS
                              if isinstance(tags.get(t), np.ndarray)
                              and len(tags[t])}
        return page, next_ifd

    def subifd_page(self, index: int, level: int) -> TiffPage:
        """The header of pyramid level ``level`` of page ``index`` (no
        pixels decoded), so a reader can pick a level before it decodes
        one (``unmicst_tpu/io/tiff.py:522-542``)."""
        page = self.pages[index]
        if page.subifds is None:
            raise ValueError(f"page {index} has no SubIFDs")
        if not 0 <= level < len(page.subifds):
            raise ValueError(
                f"page {index} has {len(page.subifds)} pyramid level(s), "
                f"requested {level}")
        try:
            sub, _ = self._read_ifd(int(page.subifds[level]))
        except (struct.error, ValueError):
            raise ValueError(
                f"corrupt SubIFD at offset {int(page.subifds[level]):#x}"
            ) from None
        return sub

    def read_subifd(self, index: int, level: int) -> np.ndarray:
        """Decode pyramid level ``level`` of page ``index`` whole; the
        page chain itself holds the full-resolution pages only."""
        return self._read_whole(self.subifd_page(index, level))

    def _stored(self, page: TiffPage, k: int) -> bytes:
        """Strip/tile ``k`` as stored in the file."""
        if k >= len(page.offsets):
            raise ValueError(f"TIFF page holds {len(page.offsets)} segments, "
                             f"needs segment {k}")
        off, cnt = int(page.offsets[k]), int(page.counts[k])
        if off < 0 or cnt < 0 or off + cnt > self._fsize:
            raise ValueError(f"TIFF segment at {off} extends past EOF")
        self._fh.seek(off)
        return self._fh.read(cnt)

    def _segment(self, page: TiffPage, k: int, rows: int, cols: int
                 ) -> np.ndarray:
        """Decode strip/tile ``k`` as ``rows x cols x samples``."""
        nbytes = rows * cols * page.samples * (page.bits // 8)
        buf = _decode(self._stored(page, k), page.compression, nbytes)
        if len(buf) < nbytes:
            raise ValueError(f"TIFF segment {k} decodes to {len(buf)} of "
                             f"{nbytes} bytes")
        dtype = page.dtype.newbyteorder(self.byteorder)
        arr = np.frombuffer(buf, dtype=dtype, count=rows * cols * page.samples)
        arr = arr.reshape(rows, cols, page.samples).astype(page.dtype)
        return _undo_predictor(arr) if page.predictor == 2 else arr

    def _batched(self, page: TiffPage, ks: np.ndarray, dst_lens: np.ndarray
                 ) -> Optional[np.ndarray]:
        """Segments ``ks`` decoded in one native call into one uint8
        buffer, each to exactly its ``dst_lens`` bytes
        (``unmicst_tpu/io/tiff.py:555-640``), or None where the one-call
        path does not apply: a codec it does not speak, no library, a
        predictor-2 layout the native undo does not take, segments the
        header lacks, a descending or sparse span, one past the end of the
        file, or any segment outside the strict native contract.  The
        per-segment path is more lenient (native, then the Python decode,
        then truncation) and raises with the segment's context."""
        if (page.compression not in (COMPRESSION_DEFLATE,
                                     COMPRESSION_DEFLATE_ADOBE,
                                     COMPRESSION_LZW, COMPRESSION_PACKBITS)
                or not len(ks) or int(ks.max()) >= len(page.offsets)
                or (page.predictor == 2
                    and not (page.samples == 1
                             and page.dtype.itemsize in (1, 2)))
                or _native.get_lib() is None):
            return None
        offs, cnts = page.offsets[ks], page.counts[ks]
        if (len(ks) > 1 and np.any(np.diff(offs) < 0)) or np.any(
                cnts < 0) or np.any(offs < 0):
            return None
        span0, span1 = int(offs[0]), int((offs + cnts).max())
        total, need = int(cnts.sum()), span1 - span0
        if need < 0 or need > total + (total >> 2) + 65536:
            return None  # sparse: it would read unrelated bytes
        if span1 > self._fsize:
            return None  # the per-segment path names the truncation
        self._fh.seek(span0)
        span = self._fh.read(need)
        if len(span) < need:
            raise ValueError("TIFF data truncated mid-page")
        dst_offs = np.concatenate(([0], np.cumsum(dst_lens[:-1])))
        out8 = np.empty(int(dst_lens.sum()), np.uint8)
        codec = (COMPRESSION_DEFLATE_ADOBE
                 if page.compression == COMPRESSION_DEFLATE
                 else page.compression)
        try:
            _native.decode_strips(span, offs - span0, cnts, dst_offs,
                                  dst_lens, codec, out8)
        except ValueError:
            return None
        return out8

    def _samples(self, page: TiffPage, out8: np.ndarray, rows: int,
                 cols: int) -> np.ndarray:
        """Decoded bytes -> ``(rows, cols, samples)`` in native byte
        order, predictor undone (each row its own predictor row)."""
        arr = out8.view(page.dtype.newbyteorder(self.byteorder))
        if arr.dtype != page.dtype:  # a byte-swapped file: one swap copy
            arr = arr.astype(page.dtype)
        arr = arr.reshape(rows, cols, page.samples)
        return _undo_predictor(arr) if page.predictor == 2 else arr

    def _check_readable(self, page: TiffPage) -> None:
        if page.planar != 1 and page.samples > 1:
            raise NotImplementedError("planar TIFF not supported (item M17)")
        if page.predictor not in (1, 2):
            raise NotImplementedError(f"TIFF predictor {page.predictor}")

    def read_page(self, index: int = 0) -> np.ndarray:
        """Decode a full page to ``(H, W)`` or ``(H, W, S)``."""
        return self._read_whole(self.pages[index])

    def _read_whole(self, page: TiffPage) -> np.ndarray:
        self._check_readable(page)
        if page.height * page.width * page.samples > 1 << 31:
            raise PageTooLargeError(
                f"TIFF page {page.height}x{page.width} is too large to read "
                "whole"
            )
        return self._read_region(page, 0, 0, page.height, page.width)

    def read_region(self, index: int, r0: int, c0: int, nrows: int,
                    ncols: int) -> np.ndarray:
        """Decode only the strips or tiles under a window: rows
        ``[r0, r0 + nrows)``, columns ``[c0, c0 + ncols)``, zero outside
        the page (``unmicst_tpu/io/tiff.py:805``).  The streaming engine
        reads a slide this way, so it never sits whole in host RAM."""
        return self._read_region(self.pages[index], r0, c0, nrows, ncols)

    def _read_region(self, page: TiffPage, r0: int, c0: int, nrows: int,
                     ncols: int) -> np.ndarray:
        self._check_readable(page)
        if r0 < 0 or c0 < 0 or nrows < 0 or ncols < 0:
            raise ValueError(f"bad region ({r0}, {c0}, {nrows}, {ncols})")
        out = np.zeros((nrows, ncols, page.samples), page.dtype)
        r1 = min(r0 + nrows, page.height)
        c1 = min(c0 + ncols, page.width)
        if page.tiled:
            th, tw = page.tile_length, page.tile_width
            across = -(-page.width // tw)
            ti0, ti1 = r0 // th, -(-r1 // th)
            tj0, tj1 = c0 // tw, -(-c1 // tw)
            ks = (np.arange(ti0, ti1, dtype=np.int64)[:, None] * across
                  + np.arange(tj0, tj1, dtype=np.int64)[None, :]).ravel()
            tile_bytes = th * tw * page.samples * (page.bits // 8)
            band = self._batched(page, ks, np.full(len(ks), tile_bytes,
                                                   np.int64))
            if band is not None:
                band = self._samples(page, band, len(ks) * th, tw).reshape(
                    len(ks), th, tw, page.samples)
            for idx, k in enumerate(ks.tolist()):
                arr = (band[idx] if band is not None
                       else self._segment(page, k, th, tw))
                ti, tj = divmod(k, across)
                tr0, tc0 = ti * th, tj * tw
                a, b = max(r0, tr0), min(r1, tr0 + th)
                c, d = max(c0, tc0), min(c1, tc0 + tw)
                out[a - r0 : b - r0, c - c0 : d - c0] = arr[
                    a - tr0 : b - tr0, c - tc0 : d - tc0]
        else:
            rps = max(1, min(page.rows_per_strip, page.height))
            s0, s1 = r0 // rps, -(-r1 // rps)
            ks = np.arange(s0, max(s0, s1), dtype=np.int64)
            row_bytes = page.width * page.samples * (page.bits // 8)
            band = self._batched(
                page, ks, np.minimum(rps, page.height - ks * rps) * row_bytes)
            if band is not None:
                # whole rows of strips [s0, s1): the window is a slice
                b0 = s0 * rps
                band = self._samples(page, band, len(band) // row_bytes,
                                     page.width)
                a, b = max(r0, b0), min(r1, b0 + band.shape[0])
                out[a - r0 : b - r0, : max(0, c1 - c0)] = band[
                    a - b0 : b - b0, c0:c1]
            else:
                for st in range(s0, s1):
                    sr0 = st * rps
                    rows = min(rps, page.height - sr0)
                    arr = self._segment(page, st, rows, page.width)
                    a, b = max(r0, sr0), min(r1, sr0 + rows)
                    out[a - r0 : b - r0, : max(0, c1 - c0)] = arr[
                        a - sr0 : b - sr0, c0:c1]
        return out[:, :, 0] if page.samples == 1 else out


# -- the pages the JAX package reads through PIL ------------------------------

# PIL refuses images above twice ``Image.MAX_IMAGE_PIXELS`` outright (its
# decompression-bomb check)
_PIL_MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)
# the codecs with which libtiff applies a predictor; with the others the
# tag is ignored and the stored samples come back as they are
_PREDICTED = (COMPRESSION_LZW, COMPRESSION_DEFLATE, COMPRESSION_DEFLATE_ADOBE,
              COMPRESSION_LZMA, COMPRESSION_ZSTD)


class FallbackError(OSError):
    """A page the fallback decoder takes whose data does not decode, or a
    page PIL refuses too; PIL raises ``OSError`` there ("decoder error",
    ``UnidentifiedImageError``)."""


def _segment_grid(page: TiffPage):
    """``(k, r0, c0, rows, cols)`` of each strip or tile: where it lands
    and the rows and columns it is coded at (an edge tile whole, the last
    strip as the rows that are left)."""
    if page.tiled:
        th, tw = page.tile_length, page.tile_width
        across = -(-page.width // tw)
        for k in range(-(-page.height // th) * across):
            r, c = divmod(k, across)
            yield k, r * th, c * tw, th, tw
    else:
        rps = max(1, min(page.rows_per_strip, page.height))
        for k, r0 in enumerate(range(0, page.height, rps)):
            yield k, r0, 0, min(rps, page.height - r0), page.width


def _jpeg_segment(tf: TiffFile, page: TiffPage, k: int, r0: int, rows: int,
                  cols: int, tables, components: int, sampling=None):
    """Segment ``k`` of a JPEG-compressed page (compression 7), landing at
    row ``r0``, as libtiff's ``tif_jpeg.c`` decodes it under PIL: one JPEG
    stream, abbreviated after the page's ``JPEGTables`` or complete,
    whose SOF sets its size, which must be the tile's, or the strip's rows
    (the last strip may be coded taller, and is cropped, as libtiff
    allows).  A colour segment (``components`` 3) must be sampled as
    ``sampling`` (h, v) says where it is given, its chroma at h1v1; it
    comes back converted from YCbCr to RGB (photometric 6) or as its
    components are (photometric 2).  Returns ``[rows, cols]`` or ``[rows,
    cols, 3]`` uint8, and the luma's sampling."""
    from unmicst_tpu_torch.io import jpeg

    where = f"{tf.path}: JPEG page"
    kind = "tile" if page.tiled else "strip"
    try:
        data = tf._stored(page, k)
        frame, _ = jpeg.parse(data, tables=tables)
        h, w = frame.height, frame.width
        taller = (not page.tiled and r0 + rows == page.height
                  and rows < h <= page.rows_per_strip)
        if w != cols or (h != rows and not taller):
            raise FallbackError(f"{where}: {kind} {k} is coded {h}x{w}, "
                                f"expected {rows}x{cols}")
        if len(frame.components) != components:
            raise FallbackError(
                f"{where}: {kind} {k} holds {len(frame.components)} "
                f"component(s) for {components} sample(s)")
        luma = (frame.components[0].h, frame.components[0].v)
        if components == 3:
            chroma = {(c.h, c.v) for c in frame.components[1:]}
            if chroma != {(1, 1)} or (sampling or luma) != luma:
                raise FallbackError(
                    f"{where}: {kind} {k} is sampled {luma}, photometric "
                    f"{page.photometric} with YCbCrSubsampling {sampling}: "
                    "libtiff refuses it")
        px = jpeg.decode(data, (h, w), tables, colour=(
            "rgb" if page.photometric == 2 else "ycbcr"))
    except ValueError as e:  # JpegError, or the segment past EOF
        raise FallbackError(f"{where}: {kind} {k}: {e}") from None
    return px[:rows], luma


def _jpeg_tables(tf: TiffFile, page: TiffPage):
    """The page's ``JPEGTables`` (tag 347), parsed, or None."""
    from unmicst_tpu_torch.io import jpeg

    if page.jpeg_tables is None:
        return None
    try:
        return jpeg.parse_tables(page.jpeg_tables)
    except jpeg.JpegError as e:
        raise FallbackError(f"{tf.path}: JPEG page: JPEGTables: {e}") from None


def _jpeg_page(tf: TiffFile, page: TiffPage) -> np.ndarray:
    """A JPEG-compressed page (compression 7) stored interleaved, each
    strip or tile one stream (:func:`_jpeg_segment`).  Gray 8-bit pages:
    WhiteIsZero pages, and pages without the tag (PIL's default), come
    back inverted.  Colour pages (3 samples): photometric 6 (YCbCr)
    converted to RGB at the stream's sampling, which must be the
    ``YCbCrSubsampling`` tag's where there is one, and the same in every
    segment; photometric 2 (RGB) as the components are, every one at
    h1v1.  Pages stored plane by plane are :func:`_planar_page`'s."""
    where = f"{tf.path}: JPEG page"
    colour = page.samples == 3 and page.photometric in (2, 6)
    if not colour and (page.samples != 1
                       or page.photometric not in (None, 0, 1)):
        raise NotImplementedError(
            f"{where} of {page.samples} samples, photometric "
            f"{page.photometric}, planar configuration {page.planar}: "
            "ROADMAP M17")
    _check_jpeg_bits(tf, page)
    tables = _jpeg_tables(tf, page)
    sampling = None
    if colour:
        sampling = (1, 1) if page.photometric == 2 else _sampling(page, None)
    out = np.empty((page.height, page.width) + ((3,) if colour else ()),
                   np.uint8)
    for k, r0, c0, rows, cols in _segment_grid(page):
        px, luma = _jpeg_segment(tf, page, k, r0, rows, cols, tables,
                                 3 if colour else 1, sampling)
        sampling = sampling or luma  # the first segment sets it
        b, d = min(rows, page.height - r0), min(cols, page.width - c0)
        out[r0 : r0 + b, c0 : c0 + d] = px[:b, :d]
    if not colour and page.photometric != 1:
        np.subtract(255, out, out=out)
    return out


def _check_jpeg_bits(tf: TiffFile, page: TiffPage) -> None:
    if page.bits != 8 or page.sample_format != 1:
        raise NotImplementedError(
            f"{tf.path}: JPEG page of {page.bits}-bit samples of format "
            f"{page.sample_format}: 12-bit JPEG is ROADMAP M17")


def _sampling(page: TiffPage, default):
    """The ``YCbCrSubsampling`` tag as ``(h, v)``, or ``default``."""
    tag = page.fallback_tags.get(TAG_YCBCR_SUBSAMPLING)
    if tag is None or len(tag) != 2:
        return default
    return int(tag[0]), int(tag[1])


# libtiff's defaults for the YCbCr conversion: Rec. 601 luma, and the
# ReferenceBlackWhite it gives a YCbCr page without the tag
_LUMA = (0.299, 0.587, 0.114)
_REFERENCE_BW = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)


@functools.lru_cache(maxsize=16)
def _tiff_ycc_tables(luma=_LUMA, ref=_REFERENCE_BW):
    """libtiff's ``TIFFYCbCrToRGBInit`` at ``luma`` (YCbCrCoefficients)
    and ``ref`` (ReferenceBlackWhite): the factors computed in float32,
    clamped to [0, 2] and taken to 16-bit fixed point; the code values
    mapped through ``Code2V`` in float32, clamped to +-4096 and truncated.
    Returns the Y, Cr->R, Cb->B, Cr->G and Cb->G tables, each indexed by
    the sample value."""
    f32 = np.float32
    red, green, blue = (f32(v) for v in luma)
    ref = [f32(v) for v in ref]

    def fix(f):
        return int(float(min(max(f, f32(0)), f32(2))) * 65536 + 0.5)

    f1, f3 = f32(2) - f32(2) * red, f32(2) - f32(2) * blue
    d1, d2, d3, d4 = fix(f1), fix(red * f1 / green), fix(f3), fix(
        blue * f3 / green)

    def code2v(c, black, white, top):
        span = f32(white - black)
        num = (c - int(black)).astype(f32) * f32(top)
        return num / (span if span != 0 else f32(1))

    def clampw(v):
        v = np.where(v < f32(-4096), f32(-4096), np.where(
            v > f32(4096), f32(4096), v))
        return np.trunc(v).astype(np.int64)

    x = np.arange(-128, 128, dtype=np.int64)
    cr = clampw(code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127))
    cb = clampw(code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127))
    y = clampw(code2v(x + 128, ref[0], ref[1], 255))
    return (y, (d1 * cr + (1 << 15)) >> 16, (d3 * cb + (1 << 15)) >> 16,
            -d2 * cr, -d4 * cb + (1 << 15))


def _ycc_params(tf: TiffFile, page: TiffPage):
    """The page's YCbCrCoefficients and ReferenceBlackWhite as libtiff
    takes them (a tag of another count is ignored, as libtiff ignores
    it), checked as ``initYCbCrConversion`` checks them."""
    tags = page.fallback_tags
    luma = tags.get(TAG_YCBCR_COEFFICIENTS)
    luma = _LUMA if luma is None or len(luma) != 3 else tuple(
        float(np.float32(v)) for v in luma)
    ref = tags.get(TAG_REFERENCE_BLACK_WHITE)
    ref = _REFERENCE_BW if ref is None or len(ref) != 6 else tuple(
        float(np.float32(v)) for v in ref)
    if any(np.isnan(luma)) or abs(luma[1]) < np.finfo(np.float32).tiny:
        raise FallbackError(f"{tf.path}: invalid YCbCrCoefficients {luma}:"
                            " libtiff refuses the page")
    if not all(-0x7FFFFFFF + 128 < v < 0x7FFFFFFF for v in ref):
        raise FallbackError(f"{tf.path}: invalid ReferenceBlackWhite {ref}:"
                            " libtiff refuses the page")
    return luma, ref


def _tiff_ycc_to_rgb(y, cb, cr, luma=_LUMA, ref=_REFERENCE_BW) -> np.ndarray:
    """``TIFFYCbCrtoRGB`` over whole planes of the same size: ``[H, W,
    3]`` uint8."""
    y_tab, cr_r, cb_b, cr_g, cb_g = _tiff_ycc_tables(luma, ref)
    y = y_tab[y]
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = np.clip(y + cr_r[cr], 0, 255)
    out[..., 1] = np.clip(y + ((cb_g[cb] + cr_g[cr]) >> 16), 0, 255)
    out[..., 2] = np.clip(y + cb_b[cb], 0, 255)
    return out


def _replicate(planes, sizes, height: int, width: int) -> list:
    """Subsampled planes brought to ``height x width`` as libtiff's
    ``putcontig8bitYCbCr*`` routines do: each sample repeated over its
    ``(h, v)`` block, the padding cropped."""
    return [np.repeat(np.repeat(p, v, 0), h, 1)[:height, :width]
            for p, (h, v) in zip(planes, sizes)]


# -- old-style JPEG (compression 6), as libtiff's tif_ojpeg.c rebuilds it -----

_SOI, _SOS, _DRI, _DQT, _DHT = 0xD8, 0xDA, 0xDD, 0xDB, 0xC4
_OJPEG_SOF = (0xC0, 0xC1, 0xC3)  # the frames tif_ojpeg.c takes


class _OJpegHeader:
    """What ``OJPEGReadHeaderInfoSec`` collects: the tables by id, the
    restart interval and the frame and scan parameters."""

    def __init__(self, restart: int):
        self.q, self.dc, self.ac = {}, {}, {}  # id -> a whole segment
        self.restart = restart
        self.sof = None  # (marker, height, width, [(c, hv, tq)])
        self.sos = None  # [(c, tables)]


def _ojpeg_sources(tf: TiffFile, page: TiffPage, n: int):
    """The bytes ``OJPEGReadBufferFill`` reads in turn: the
    JPEGInterchangeFormat stream (offset and length fixed up as libtiff
    fixes them; ``b""`` without one), then each of the ``n`` strips or
    tiles (one at offset 0 reads nothing, one with no byte count runs to
    the end of the file)."""
    tags, fsize = page.fallback_tags, tf._fsize

    def read(off, count):
        if not off or off >= fsize:
            return b""
        if not count or off + count > fsize:
            count = fsize - off
        tf._fh.seek(off)
        return tf._fh.read(count)

    jif = read(int(tags.get(TAG_JPEG_IF_OFFSET, [0])[0]),
               int(tags.get(TAG_JPEG_IF_LENGTH, [0])[0]))
    if n > len(page.offsets):
        raise FallbackError(f"the page holds {len(page.offsets)} "
                            f"segments, needs {n}")
    return jif, [read(int(page.offsets[k]), int(page.counts[k]))
                 for k in range(n)]


def _ojpeg_header(data: bytes, head: _OJpegHeader, samples: int,
                  sampling) -> int:
    """``OJPEGReadHeaderInfoSec``'s walk of the markers at the start of
    ``data``: up to the first byte that is not a marker's (the table
    form's bare scan) or past the SOS header, a SOF's components checked
    against ``sampling`` (h, v) unless it is None.  Returns where the
    compressed data starts."""
    pos, n = 0, len(data)

    def word(at):
        if at + 2 > n:
            raise FallbackError("old-style JPEG header ends early")
        return struct.unpack_from(">H", data, at)[0]

    while pos < n and data[pos] == 0xFF:
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise FallbackError("old-style JPEG header ends early")
        m, pos = data[pos], pos + 1
        if m == _SOI:
            continue
        length = word(pos)
        body = data[pos + 2 : pos + length]
        if length < 2 or len(body) != length - 2:
            raise FallbackError(f"corrupt JPEG marker 0x{m:02X}")
        seg = bytes((0xFF, m)) + data[pos : pos + length]
        pos += length
        if m == 0xFE or 0xE0 <= m <= 0xEF:
            continue
        if m == _DRI:
            if length != 4:
                raise FallbackError("corrupt DRI marker in JPEG data")
            head.restart = struct.unpack(">H", body)[0]
        elif m == _DQT:
            while body:
                if len(body) < 65 or body[0] >> 4 or body[0] & 15 > 3:
                    raise FallbackError("corrupt DQT marker in JPEG data")
                head.q[body[0] & 15] = (b"\xff\xdb\x00\x43" + body[:65])
                body = body[65:]
        elif m == _DHT:
            if not body or body[0] >> 4 > 1 or body[0] & 15 > 3:
                raise FallbackError("corrupt DHT marker in JPEG data")
            (head.ac if body[0] >> 4 else head.dc)[body[0] & 15] = seg
        elif m in _OJPEG_SOF:
            nc = body[5] if len(body) > 5 else 0
            if head.sof is not None or body[:1] != b"\x08" or (
                    nc != samples or len(body) != 6 + 3 * nc):
                raise FallbackError("corrupt or unexpected SOF marker in "
                                    "JPEG data")
            comps = [tuple(body[6 + 3 * k : 9 + 3 * k]) for k in range(nc)]
            if sampling and [c[1] for c in comps] != [
                    (sampling[0] << 4) | sampling[1]] + [0x11] * (nc - 1):
                raise FallbackError("JPEG compressed data indicates "
                                    "unexpected subsampling values")
            height, width = struct.unpack_from(">HH", body, 1)
            head.sof = (m, height, width, comps)
        elif m == _SOS:
            if head.sof is None or length != 6 + 2 * samples or (
                    body[0] != samples):
                raise FallbackError("corrupt SOS marker in JPEG data")
            head.sos = [(body[1 + 2 * k], body[2 + 2 * k])
                        for k in range(samples)]
            return pos
        else:
            raise FallbackError(f"unknown marker type 0x{m:02X} in JPEG "
                                "data")
    if pos >= n:
        raise FallbackError("old-style JPEG data holds no scan")
    return pos


def _ojpeg_tables(tf: TiffFile, page: TiffPage, head: _OJpegHeader,
                  samples: int) -> list:
    """The table form: ``OJPEGReadHeaderInfoSecTables*`` reading
    JPEGQTables, JPEGDCTables and JPEGACTables (519-521; a 64-byte
    table, or 16 counts and their values, at each offset) into DQT and
    DHT segments, table ``m`` for component ``m``, a component whose
    offset repeats its predecessor's sharing its table.  Returns each
    component's (quantisation table, DC table, AC table) ids."""
    ids = [[0, 0, 0] for _ in range(samples)]
    for j, tag in enumerate((TAG_JPEG_QTABLES, TAG_JPEG_DCTABLES,
                             TAG_JPEG_ACTABLES)):
        offs = [int(v) for v in page.fallback_tags.get(tag, [])][:3]
        offs += [0] * (samples - len(offs))
        if not offs or not offs[0]:
            raise FallbackError("missing JPEG tables (JPEGQTables, "
                                "JPEGDCTables, JPEGACTables)")
        for m in range(samples):
            if not offs[m] or (m and offs[m] == offs[m - 1]):
                ids[m][j] = ids[m - 1][j]
                continue
            if offs[m] in offs[: max(m - 1, 0)]:
                raise FallbackError("corrupt JPEG table tags")
            tf._fh.seek(offs[m])
            if j == 0:
                table = tf._fh.read(64)
                seg = b"\xff\xdb\x00\x43" + bytes((m,)) + table
            else:
                counts = tf._fh.read(16)
                table = counts + tf._fh.read(sum(counts))
                seg = b"\xff\xc4" + struct.pack(">HB", 19 + sum(counts), (
                    16 if j == 2 else 0) | m) + table
            if len(table) != (64 if j == 0 else 16 + sum(table[:16])):
                raise FallbackError("a JPEG table runs past the end of the "
                                    "file")
            (head.q, head.dc, head.ac)[j][m] = seg
            ids[m][j] = m
    return ids


def _ojpeg_stream(tf: TiffFile, page: TiffPage, colour: bool) -> bytes:
    """The JPEG stream libtiff's ``tif_ojpeg.c`` hands libjpeg for an
    old-style JPEG page: the header read from the JPEGInterchangeFormat
    stream or the first strip (or, in the table form, from tags 519-521,
    with a baseline SOF of the strip's or tile column's size and
    components 0, 1, 2), regenerated as SOI, DQT, DHT, DRI, SOF and SOS;
    then the compressed data from where the header ended, through the
    rest of that source and every strip or tile after it, an RST marker
    after each strip or tile but the last; then EOI.  Strips or tiles
    shorter than the page make the restart interval one strip's or tile's
    MCUs, unless the stream's own DRI says otherwise.  A colour page's
    sampling is its stream's where the header has a SOF, else the
    ``YCbCrSubsampling`` tag's (2x2 by default); a gray page's 1x1.
    ``JPEGProc`` is not read, as libtiff does not read it."""
    tiled = page.tiled
    width = page.tile_width if tiled else page.width
    length = page.tile_length if tiled else page.rows_per_strip
    n = len(list(_segment_grid(page)))
    total = -(-page.height // length) * length if tiled else page.height
    restart = int(page.fallback_tags.get(TAG_JPEG_RESTART_INTERVAL, [0])[0])
    jif, striles = _ojpeg_sources(tf, page, n)
    sources = [jif] + striles
    flat = b"".join(sources)
    sampling = (1, 1)
    if colour:  # OJPEGSubsamplingCorrect: a probe of the header
        probe = _OJpegHeader(0)
        try:
            _ojpeg_header(flat, probe, page.samples, None)
        except FallbackError:
            pass
        sampling = _sampling(page, (2, 2))
        if probe.sof is not None:
            hv = [c[1] for c in probe.sof[3]]
            sampling = (hv[0] >> 4, hv[0] & 15)
            if (set(hv[1:]) != {0x11} or sampling[0] not in (1, 2, 4)
                    or sampling[1] not in (1, 2, 4)):
                raise NotImplementedError(
                    f"{tf.path}: an old-style JPEG page sampled "
                    f"{[divmod(v, 16) for v in hv]}, which libjpeg "
                    "upsamples itself: ROADMAP M17")
    if length < page.height:
        hs, vs = sampling
        if hs not in (1, 2, 4) or vs not in (1, 2, 4) or length % (8 * vs):
            raise FallbackError(
                f"strips or tiles of {length} "
                f"rows at subsampling {sampling}: libtiff refuses them")
        restart = -(-width // (8 * hs)) * (length // (8 * vs))
    head = _OJpegHeader(restart)
    start = _ojpeg_header(flat, head, page.samples, sampling)
    if head.sof is None:  # the table form
        ids = _ojpeg_tables(tf, page, head, page.samples)
        hv = [(sampling[0] << 4) | sampling[1]] + [0x11] * (page.samples - 1)
        head.sof = (0xC0, total, width, [(m, hv[m], ids[m][0])
                                         for m in range(page.samples)])
        head.sos = [(m, (ids[m][1] << 4) | ids[m][2])
                    for m in range(page.samples)]
    marker, height, frame_w, comps = head.sof
    if (height < min(page.height, total) or frame_w > width
            or frame_w < min(page.width, width)):
        raise FallbackError(
            f"the stream is {height}x{frame_w}, the "
            f"page {page.height}x{page.width}: libtiff refuses it")
    if marker == 0xC3:
        raise NotImplementedError(f"{tf.path}: a lossless (SOF3) old-style"
                                  " JPEG page: ROADMAP M17")
    ns = len(head.sos)
    out = [b"\xff\xd8"]
    for tables in (head.q, head.dc, head.ac):
        out += [tables[i] for i in sorted(tables)]
    if head.restart:
        out.append(struct.pack(">BBHH", 0xFF, _DRI, 4, head.restart))
    out.append(struct.pack(">BBHBHHB", 0xFF, marker, 8 + 3 * len(comps), 8,
                           height, frame_w, len(comps))
               + b"".join(bytes(c) for c in comps))
    out.append(struct.pack(">BBHB", 0xFF, _SOS, 6 + 2 * ns, ns)
               + b"".join(bytes(c) for c in head.sos) + b"\x00\x3f\x00")
    at, rst = 0, 0
    for i, src in enumerate(sources):
        piece = src[max(start - at, 0):]
        at += len(src)
        if not piece:
            continue
        out.append(piece)
        if i and i < len(sources) - 1:  # a strip or tile with more after
            out.append(bytes((0xFF, 0xD0 + rst)))
            rst = (rst + 1) % 8
    out.append(b"\xff\xd9")
    return b"".join(out)


def _ojpeg_page(tf: TiffFile, page: TiffPage) -> np.ndarray:
    """An old-style JPEG page (compression 6) as libtiff's ``tif_ojpeg.c``
    reads it under PIL (:func:`_ojpeg_stream`): baseline or extended
    sequential frames, the JPEGInterchangeFormat form (tags 513/514) and
    the table form (JPEGQTables, JPEGDCTables, JPEGACTables and bare
    scans), in one strip or several, or in one column of tiles.  Gray
    pages come back as decoded, whatever their photometric.  Colour pages
    (photometric 2, which libtiff takes for 6, or 6) from libjpeg's raw
    component samples, chroma repeated to the full size and converted by
    libtiff's own YCbCr tables at the page's YCbCrCoefficients and
    ReferenceBlackWhite; their sampling is the stream's where it has a
    SOF, the ``YCbCrSubsampling`` tag's (2x2 by default) in the table
    form.  Tiles in more than one column are ROADMAP M17: libtiff's frame
    is one tile wide there."""
    from unmicst_tpu_torch.io import jpeg

    where = f"{tf.path}: old-style JPEG page"
    colour = (page.samples == 3 and page.photometric in (2, 6)
              and page.planar == 1)
    if not colour and (page.samples != 1 or page.photometric not in (
            None, 0, 1)):
        raise NotImplementedError(
            f"{where} of {page.samples} samples, photometric "
            f"{page.photometric}, planar configuration {page.planar}: "
            "ROADMAP M17")
    if page.tiled and page.tile_width < page.width:
        raise NotImplementedError(
            f"{where} in {-(-page.width // page.tile_width)} columns of "
            "tiles: ROADMAP M17")
    if colour:
        luma, ref = _ycc_params(tf, page)
    try:
        frame, planes = jpeg.decode_planes(_ojpeg_stream(tf, page, colour))
    except (ValueError, FallbackError) as e:  # JpegError, libtiff's checks
        raise FallbackError(f"{where}: {e}") from None
    if not colour:
        return np.ascontiguousarray(planes[0][: page.height, : page.width])
    sizes = [(frame.hmax // c.h, frame.vmax // c.v) for c in frame.components]
    return _tiff_ycc_to_rgb(*_replicate(planes, sizes, page.height,
                                        page.width), luma, ref)


# the sample widths the fallback unpacks, with PIL's scale to 8 bits
_PACKED_SCALE = {1: None, 2: 85, 4: 17, 12: None}
_CCITT = (COMPRESSION_CCITT_RLE, COMPRESSION_CCITT_T4, COMPRESSION_CCITT_T6)
# each byte's bits reversed (FillOrder 2)
_BIT_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                         np.uint8)


def _unpack(rows: np.ndarray, bits: int, cols: int) -> np.ndarray:
    """Byte-padded rows ``[n, ceil(cols * bits / 8)]`` of samples packed
    most significant bit first -> ``[n, cols]`` (uint8, or uint16 for
    12 bits)."""
    if bits == 12:
        n = rows.shape[0]
        trio = np.zeros((n, 3 * (-(-cols // 2))), np.uint16)
        trio[:, : rows.shape[1]] = rows
        trio = trio.reshape(n, -1, 3)
        out = np.empty((n, trio.shape[1], 2), np.uint16)
        out[..., 0] = (trio[..., 0] << 4) | (trio[..., 1] >> 4)
        out[..., 1] = ((trio[..., 1] & 15) << 8) | trio[..., 2]
        return out.reshape(n, -1)[:, :cols]
    flat = np.unpackbits(rows, axis=1)
    if bits == 1:
        return flat[:, :cols]
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (flat[:, : cols * bits].reshape(len(rows), cols, bits)
            * weights).sum(axis=2, dtype=np.uint8)


def _ccitt_segment(data: bytes, cols: int, rows: int,
                   page: TiffPage) -> np.ndarray:
    """One CCITT-coded strip or tile: natively where the library loads
    (a failure there raises), else :mod:`~unmicst_tpu_torch.io.ccitt`."""
    from unmicst_tpu_torch.io import ccitt

    options = int(page.fallback_tags.get(TAG_T4_OPTIONS, [0])[0])
    out = _native.ccitt_decode(data, cols, rows, page.compression, options)
    if out is not None:
        return out
    return ccitt.decode(data, cols, rows, page.compression, options)


def _packed_page(tf: TiffFile, page: TiffPage) -> np.ndarray:
    """A gray or palette page of 1-, 2-, 4- or 12-bit samples, as PIL
    reads it: each row unpacked most significant bit first, rows
    byte-padded, under the codecs :func:`_decode` speaks or CCITT (1-bit
    only); FillOrder 2 reverses each stored byte's bits first.  Gray
    1-bit pages come back ``bool``, 2- and 4-bit pages ``uint8`` at 85 and
    17 a step, 12-bit pages ``uint16`` as stored; WhiteIsZero pages, and
    pages without the tag (PIL's default), are inverted.  Palette pages
    (photometric 3, PIL's mode ``P``) come back as their ``uint8``
    indices, 1-bit ones too.  Where PIL has no mode for the page (12-bit
    pages other than little-endian BlackIsZero at FillOrder 1,
    uncompressed palette pages at FillOrder 2, which libtiff does not
    decode for PIL, signed or float samples) or
    libtiff refuses it (predictor 2 under a codec that applies it),
    :class:`FallbackError`."""
    fill = int(page.fallback_tags.get(TAG_FILL_ORDER, [1])[0])
    ccitt_coded = page.compression in _CCITT
    palette = page.photometric == 3
    where = f"{tf.path}: {page.bits}-bit {'palette ' if palette else ''}" \
        "page" + (f" under CCITT compression {page.compression}"
                  if ccitt_coded else "")
    if ccitt_coded and page.bits != 1:
        raise FallbackError(f"{where}: libtiff codes 1-bit pages only")
    if page.sample_format != 1 or page.bits not in _PACKED_SCALE or (
            page.bits == 12 and (tf.byteorder != "<" or fill != 1
                                 or page.photometric != 1)) or (
            palette and fill != 1 and page.compression == COMPRESSION_NONE):
        raise FallbackError(
            f"{where} of format {page.sample_format}, byte order "
            f"{tf.byteorder}, FillOrder {fill}, photometric "
            f"{page.photometric}: PIL has no mode for it")
    if page.predictor == 2 and page.compression in _PREDICTED:
        raise FallbackError(f"{where} with predictor 2: libtiff takes "
                            "8-bit and wider samples only")
    bits = page.bits
    out = np.empty((page.height, page.width),
                   np.uint16 if bits == 12 else np.uint8)
    for k, r0, c0, rows, cols in _segment_grid(page):
        row_bytes = (cols * bits + 7) // 8
        try:
            data = tf._stored(page, k)
            if fill == 2:
                data = _BIT_REVERSED[np.frombuffer(data, np.uint8)].tobytes()
            if ccitt_coded:
                packed = _ccitt_segment(data, cols, rows, page)
            else:
                nbytes = rows * row_bytes
                buf = _decode(data, page.compression, nbytes)
                if len(buf) < nbytes:
                    raise FallbackError(f"segment {k} decodes to {len(buf)}"
                                        f" of {nbytes} bytes")
                packed = np.frombuffer(buf, np.uint8, nbytes).reshape(
                    rows, row_bytes)
        except ValueError as e:
            raise FallbackError(f"{where}: segment {k}: {e}") from None
        b, d = min(rows, page.height - r0), min(cols, page.width - c0)
        out[r0 : r0 + b, c0 : c0 + d] = _unpack(packed, bits, cols)[:b, :d]
    if palette:
        return out
    if page.photometric != 1:
        np.subtract((1 << bits) - 1, out, out=out)
    if bits == 1:
        return out.view(bool)
    if _PACKED_SCALE[bits]:
        out *= _PACKED_SCALE[bits]
    return out


def _segment_bytes(tf: TiffFile, page: TiffPage, k: int, nbytes: int,
                   where: str) -> np.ndarray:
    """Segment ``k`` decoded by :func:`_decode` to exactly ``nbytes``
    uint8."""
    try:
        buf = _decode(tf._stored(page, k), page.compression, nbytes)
    except ValueError as e:
        raise FallbackError(f"{where}: segment {k}: {e}") from None
    if len(buf) < nbytes:
        raise FallbackError(f"{where}: segment {k} decodes to {len(buf)} "
                            f"of {nbytes} bytes")
    return np.frombuffer(buf, np.uint8, nbytes)


def _planar_page(tf: TiffFile, page: TiffPage) -> np.ndarray:
    """An 8-bit page stored plane by plane (PlanarConfiguration 2), as PIL
    reads it: the planes' strips or tiles one plane after another, each
    under the codecs :func:`_decode` speaks (predictor 2 undone per plane
    where libtiff applies it) or one 1-component JPEG stream
    (compression 7, :func:`_jpeg_segment`).

    * RGB (3 samples) comes back ``[H, W, 3]`` as stored.
    * RGBA (4 samples) comes back ``[H, W, 4]`` as stored where its
      ExtraSamples tag says unassociated alpha, or where it has none and
      is uncompressed.  libtiff takes a compressed page without the tag,
      or with associated alpha, as premultiplied, and PIL divides the
      alpha out (``c * 255 // a``, clipped; 0 where ``a`` is 0).  PIL
      refuses the other kinds (:class:`FallbackError`).
    * YCbCr (photometric 6): PIL's own reader returns an uncompressed
      page's stored planes as RGB, whatever its subsampling tag.
      libtiff converts a compressed one by ``TIFFYCbCrtoRGB`` (at the
      page's coefficients and reference black and white) where its
      ``YCbCrSubsampling`` tag says 1x1, and refuses it otherwise."""
    where = f"{tf.path}: planar page"
    compressed = page.compression != COMPRESSION_NONE
    extra = page.fallback_tags.get(TAG_EXTRA_SAMPLES)
    extra = None if extra is None else [int(v) for v in extra]
    premultiplied = page.samples == 4 and compressed and extra in (None, [1])
    if page.samples == 4 and extra not in (None, [2]) and not premultiplied:
        raise FallbackError(f"{where} with ExtraSamples {extra}: PIL has no "
                            "mode for it")
    ycbcr = page.photometric == 6 and compressed
    if ycbcr:
        luma, ref = _ycc_params(tf, page)
        if _sampling(page, (2, 2)) != (1, 1):
            raise FallbackError(f"{where}: YCbCr planes subsampled "
                                f"{_sampling(page, (2, 2))}, which libtiff "
                                "refuses")
    jpeg_coded = page.compression == COMPRESSION_JPEG
    if jpeg_coded:
        _check_jpeg_bits(tf, page)
        tables = _jpeg_tables(tf, page)
    grid = list(_segment_grid(page))
    out = np.empty((page.height, page.width, page.samples), np.uint8)
    for plane in range(page.samples):
        for k, r0, c0, rows, cols in grid:
            seg = plane * len(grid) + k
            if jpeg_coded:
                px = _jpeg_segment(tf, page, seg, r0, rows, cols, tables,
                                   1)[0]
            else:
                px = _segment_bytes(tf, page, seg, rows * cols,
                                    where).reshape(rows, cols, 1)
                if page.predictor == 2 and page.compression in _PREDICTED:
                    px = _undo_predictor(px.copy())
                px = px[..., 0]
            b, d = min(rows, page.height - r0), min(cols, page.width - c0)
            out[r0 : r0 + b, c0 : c0 + d, plane] = px[:b, :d]
    if ycbcr:
        return _tiff_ycc_to_rgb(out[..., 0], out[..., 1], out[..., 2], luma,
                                ref)
    if premultiplied:  # PIL's "RGBa" unpacker: c * 255 // a, clipped
        a = out[..., 3:].astype(np.int32)
        rgb = np.minimum(out[..., :3].astype(np.int32) * 255
                         // np.maximum(a, 1), 255)
        out[..., :3] = np.where(a > 0, rgb, 0)
    return out


# the subsamplings libtiff's RGBA interface converts (putcontig8bitYCbCr*)
_YCC_SAMPLINGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))


def _ycbcr_page(tf: TiffFile, page: TiffPage) -> np.ndarray:
    """An 8-bit YCbCr page stored interleaved and subsampled (photometric
    6, ``YCbCrSubsampling`` h x v, 2x2 without the tag), as PIL reads a
    compressed one through libtiff's RGBA interface: each strip or tile
    a run of data units (h * v luma samples, row by row, then Cb and Cr)
    over its blocks, edge blocks whole; each luma sample converted with
    its block's chroma by ``TIFFYCbCrtoRGB`` at the page's coefficients
    and reference black and white.  Predictor 2 is undone as libtiff
    undoes it, with a stride of 3 bytes over rows of a strip's block row
    bytes / v, or of a tile's width times 3 (a row that is not a multiple
    of 3 bytes is ROADMAP M17).  libtiff refuses other subsamplings
    (:class:`FallbackError`).  ROADMAP M17 holds two kinds PIL returns
    garbage for: uncompressed pages, which PIL's own reader reads as
    samples that are not subsampled, and strips at v = 4 whose block row
    is not a multiple of 4 bytes, which libtiff reads short."""
    where = f"{tf.path}: subsampled YCbCr page"
    hs, vs = _sampling(page, (2, 2))
    if page.compression == COMPRESSION_NONE:
        raise NotImplementedError(
            f"{where}, uncompressed: PIL's own reader reads its bytes as "
            "samples that are not subsampled, past each strip's end: "
            "ROADMAP M17")
    if (hs, vs) not in _YCC_SAMPLINGS:
        raise FallbackError(f"{where} at {hs}x{vs}: libtiff cannot handle "
                            "it")
    unit = hs * vs + 2
    if not page.tiled and -(-page.width // hs) * unit % vs:
        raise NotImplementedError(
            f"{where} at {hs}x{vs}, {page.width} wide, in strips: libtiff "
            "reads each strip short (its scanline size rounds down) and "
            "PIL returns what its buffer held: ROADMAP M17")
    luma, ref = _ycc_params(tf, page)
    y = np.empty((-(-page.height // vs) * vs, -(-page.width // hs) * hs),
                 np.uint8)
    cb = np.empty((y.shape[0] // vs, y.shape[1] // hs), np.uint8)
    cr = np.empty_like(cb)
    for k, r0, c0, rows, cols in _segment_grid(page):
        brows, bcols = -(-rows // vs), -(-cols // hs)
        data = _segment_bytes(tf, page, k, brows * bcols * unit, where)
        if page.predictor == 2 and page.compression in _PREDICTED:
            # libtiff's predictor row: a tile's width in samples, or a
            # strip's block row over v
            line = 3 * cols if page.tiled else bcols * unit // vs
            if line % 3 or len(data) % line:
                raise NotImplementedError(
                    f"{where}: predictor 2 over {line}-byte rows of 3 "
                    "bytes, where libtiff fails and PIL returns its buffer:"
                    " ROADMAP M17")
            data = _undo_predictor(data.reshape(-1, line // 3, 3).copy())
        units = data.reshape(brows, bcols, unit)
        lum = units[..., : hs * vs].reshape(brows, bcols, vs, hs)
        lum = lum.transpose(0, 2, 1, 3).reshape(brows * vs, bcols * hs)
        b = min(brows * vs, y.shape[0] - r0)
        d = min(bcols * hs, y.shape[1] - c0)
        y[r0 : r0 + b, c0 : c0 + d] = lum[:b, :d]
        cb[r0 // vs : (r0 + b) // vs, c0 // hs : (c0 + d) // hs] = units[
            : b // vs, : d // hs, -2]
        cr[r0 // vs : (r0 + b) // vs, c0 // hs : (c0 + d) // hs] = units[
            : b // vs, : d // hs, -1]
    y = y[: page.height, : page.width]
    cb, cr = _replicate([cb, cr], [(hs, vs)] * 2, page.height, page.width)
    return _tiff_ycc_to_rgb(y, cb, cr, luma, ref)


def _undo_float_predictor(rows: np.ndarray, itemsize: int) -> np.ndarray:
    """Undo the floating-point predictor (TIFF Technote 3) in place on the
    C-contiguous uint8 ``[n, cols * itemsize]`` ``rows``: each row summed
    back byte by byte, then its byte planes (most significant first)
    interleaved into native-order samples; natively where the library
    loads."""
    if _native.fp_predictor_undo(rows, itemsize) is not None:
        return rows
    n, m = rows.shape
    acc = np.cumsum(rows, axis=1, dtype=np.uint8)
    big = acc.reshape(n, itemsize, m // itemsize).transpose(0, 2, 1)
    rows[:] = (big[..., ::-1] if sys.byteorder == "little" else big).reshape(
        n, m)
    return rows


def _float_predictor_page(tf: TiffFile, page: TiffPage) -> np.ndarray:
    """A float32 page with the floating-point predictor (3), as PIL reads
    it through libtiff: the predictor undone where libtiff applies one
    (LZW, Deflate, LZMA, zstd), the stored samples as they are under
    compression none and PackBits.  PIL refuses other sample widths and
    formats with predictor 3, and several samples a pixel.  Unlike PIL
    (which swaps libtiff's native-order samples again), a big-endian
    ("MM") file reads as the floats it holds."""
    where = f"{tf.path}: predictor-3 page"
    if page.sample_format != 3 or page.bits != 32 or page.samples != 1:
        raise FallbackError(
            f"{where} of {page.samples} sample(s) of {page.bits} bits, "
            f"format {page.sample_format}: PIL reads only one float32 "
            "sample a pixel there")
    if page.compression not in _PREDICTED + (COMPRESSION_NONE,
                                             COMPRESSION_PACKBITS):
        raise NotImplementedError(
            f"{where} under compression {page.compression}: ROADMAP M17")
    grid = list(_segment_grid(page))
    out = np.empty((page.height, page.width), np.float32)
    for k, r0, c0, rows, cols in grid:
        raw = _segment_bytes(tf, page, k, rows * cols * 4, where).reshape(
            rows, cols * 4)
        if page.compression in _PREDICTED:
            px = _undo_float_predictor(raw.copy(), 4).view(np.float32)
        else:
            px = raw.view(np.dtype("f4").newbyteorder(tf.byteorder))
        b, d = min(rows, page.height - r0), min(cols, page.width - c0)
        out[r0 : r0 + b, c0 : c0 + d] = px[:b, :d]
    return out


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8\xff"  # PIL's JPEG _accept
_BMP_MAGIC = b"BM"
_GIF_MAGICS = (b"GIF87a", b"GIF89a")
# PIL's PPM ``_accept``: "P" and one of 0-6, f and y
_PNM_MAGICS = tuple(b"P" + bytes([c]) for c in b"0123456fy")


def _single_frame(path: str, index: int, magic: bytes) -> np.ndarray:
    """A PNG, JPEG (or MPO), BMP, GIF or Netpbm file under a TIFF name, as
    PIL opens it by content: frame ``index`` (a GIF's,
    :func:`gif.read_frame`; an MPO's, :func:`mpo.read_frame`; the others
    have one), ``EOFError`` past the last."""
    if magic.startswith(_GIF_MAGICS):
        from unmicst_tpu_torch.io import gif

        with open(path, "rb") as f:
            data = f.read()
        try:
            return gif.read_frame(data, index)
        except (ValueError, OSError) as e:  # corrupt; M17 refusals pass
            raise FallbackError(f"{path}: GIF file: {e}") from None
    if magic.startswith(_JPEG_MAGIC):
        from unmicst_tpu_torch.io import mpo

        with open(path, "rb") as f:
            data = f.read()
        try:  # EOFError, and seek's ValueError and SyntaxError, pass
            return mpo.read_frame(data, index)
        except mpo.MpoError as e:
            raise FallbackError(f"{path}: JPEG file: {e}") from None
    if magic.startswith(_PNM_MAGICS):
        from unmicst_tpu_torch.io import pnm

        return pnm.read_frame(path, index)  # PIL's classes, PIL's way
    if index > 0:
        raise EOFError("attempt to seek outside sequence")
    if magic.startswith(_PNG_MAGIC):
        from unmicst_tpu_torch.io import png

        read, kind = png.read_png, "PNG"
    else:
        from unmicst_tpu_torch.io import bmp

        read, kind = bmp.read_bmp, "BMP"
    try:
        return read(path)
    except ValueError as e:  # corrupt; NotImplementedError names M17
        raise FallbackError(f"{path}: {kind} file: {e}") from None


def _by_plugin_order(path: str, index: int, magic: bytes,
                     cause: Exception) -> np.ndarray:
    """A file no magic bytes above take, as ``Image.open`` tries its other
    plugins (:mod:`identify`): frame ``index`` of a format in
    ``identify.READ`` (PIL's exceptions pass, ``EOFError`` past the last
    frame), PIL's ``OSError`` for a stub PIL opens and cannot load,
    ``NotImplementedError`` naming ROADMAP M17 for a format PIL opens and
    the port does not read; where no plugin opens it, ``cause`` again
    (:class:`FallbackError` for a file that starts with "P": PFM, PAM)."""
    from unmicst_tpu_torch.io import identify

    with open(path, "rb") as f:
        px = identify.read(f.read(), index, path)
    if px is not None:
        return px
    if magic.startswith(b"P"):
        raise FallbackError(f"cannot identify image file {path!r}")
    raise cause


def _fallback_reader(page: TiffPage):
    """The decoder of :func:`read_page_fallback` that takes ``page``, or
    None."""
    if page.compression == COMPRESSION_JPEG and (page.planar == 1
                                                 or page.samples == 1):
        return _jpeg_page
    if page.compression == COMPRESSION_OJPEG:
        return _ojpeg_page
    if page.predictor == 3:
        return _float_predictor_page
    if page.samples == 1 and page.photometric in (None, 0, 1, 3) and (
            page.compression in _CCITT or page.bits in _PACKED_SCALE):
        return _packed_page
    if page.bits != 8 or page.sample_format != 1:
        return None
    if page.planar == 2 and (
            (page.samples == 3 and page.photometric in (2, 6))
            or (page.samples == 4 and page.photometric == 2)):
        return _planar_page
    if page.planar == 1 and page.samples == 3 and page.photometric == 6:
        return _ycbcr_page
    return None


def read_page_fallback(path: str, index: int, cause: Exception
                       ) -> np.ndarray:
    """Page ``index`` of the page chain, decoded whole, where
    :class:`TiffFile` refused it with ``cause``: the JAX package's PIL
    fallback (``unmicst_tpu/io/tiff.py:1285-1291``,
    ``io/slides.py:77-97``) without PIL, for the pages of ROADMAP M17.
    The file is opened by content, as PIL opens it: a PNG, JPEG, BMP or
    Netpbm file under a TIFF name gives its one frame, a GIF or an MPO its
    frame ``index`` (:func:`_single_frame`); any other file goes through
    PIL's other plugins in their order (:func:`_by_plugin_order`): a PCX,
    SGI, TGA, DIB, MSP, XBM, QOI, DDS (block-compressed too, through
    :mod:`bcn`) or JPEG 2000 file (a J2K codestream or a JP2 file,
    :mod:`jpeg2000`), a FITS, McIDAS, Sun raster, PIXAR, XV thumbnail,
    XPM, IMT, GBR, IPTC or PhotoCD file, an ICO or CUR (:mod:`ico`), an
    ICNS, a BLP or an FTEX file gives its one frame, a DCX or IM file its
    frame ``index``, an FLI or FLC animation its frame ``index`` (frames
    0 to ``index`` replayed, :mod:`fli`), a SPIDER stack its image
    ``index`` and a PSD PIL's ``seek(index)`` (1 the composite; see
    :mod:`psd`).
    A TIFF's chain is walked by index, as PIL's ``seek`` walks it, so no
    OME mapping applies.  It reads JPEG pages, gray or colour
    (:func:`_jpeg_page`), old-style JPEG pages (:func:`_ojpeg_page`),
    float32 pages with the floating-point predictor
    (:func:`_float_predictor_page`), gray and palette 1-, 2- and 4-bit
    pages and gray 12-bit ones, CCITT-coded ones among them
    (:func:`_packed_page`), subsampled YCbCr pages (:func:`_ycbcr_page`)
    and 8-bit pages stored plane by plane, JPEG-coded ones among them
    (:func:`_planar_page`).  Past the chain's
    end it raises ``EOFError``; where PIL refuses such a page too, or its
    data does not decode, :class:`FallbackError` (an ``OSError``); for
    the pages of these kinds still queued ``NotImplementedError`` naming
    ROADMAP M17, as do files PIL opens as a format the port does not
    read.  Any other page or file raises ``cause`` again: the reader's own
    refusal.  Streamed and pyramid reads have no such
    fallback in either package."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith((_PNG_MAGIC, _JPEG_MAGIC, _BMP_MAGIC) + _GIF_MAGICS
                        + _PNM_MAGICS):
        return _single_frame(path, index, magic)
    if magic[:2] not in (b"II", b"MM"):
        return _by_plugin_order(path, index, magic, cause)
    with TiffFile(path, chain=False) as tf:
        page = tf.page_at(index)
        reader = _fallback_reader(page)
        if reader is None:
            raise cause
        if max(page.height * page.width,
               page.tile_length * page.tile_width) > _PIL_MAX_PIXELS:
            raise PageTooLargeError(
                f"{path}: page {index} ({page.height}x{page.width}, tiles "
                f"{page.tile_length}x{page.tile_width}) is beyond PIL's "
                f"decompression-bomb limit ({_PIL_MAX_PIXELS} pixels)")
        return reader(tf, page)


def _box_downsample2(img: np.ndarray) -> np.ndarray:
    """A 2x2 box-mean pyramid level (``unmicst_tpu/io/tiff.py:919-946``):
    odd edges average the pixels there are (edge-replicate pad), integers
    round half up (``(sum + 2) >> 2``), floats take the float64 mean.  Row
    bands keep the temporaries bounded."""
    h, w = img.shape
    ph, pw = h + (h & 1), w + (w & 1)
    out = np.empty((ph // 2, pw // 2), img.dtype)
    integer = np.issubdtype(img.dtype, np.integer)
    band = 4096  # even
    for r0 in range(0, ph, band):
        r1 = min(r0 + band, ph)
        blk = img[r0 : min(r1, h)]
        pad_r = (r1 - r0) - blk.shape[0]
        if pad_r or pw != w:
            blk = np.pad(blk, ((0, pad_r), (0, pw - w)), mode="edge")
        q = blk.reshape((r1 - r0) // 2, 2, pw // 2, 2)
        if integer:
            sums = q.astype(np.int64).sum(axis=(1, 3))
            out[r0 // 2 : r1 // 2] = ((sums + 2) >> 2).astype(img.dtype)
        else:
            out[r0 // 2 : r1 // 2] = q.astype(np.float64).mean(
                axis=(1, 3)).astype(img.dtype)
    return out


class TiffWriter:
    """Grayscale multi-page TIFF/BigTIFF writer with append semantics:
    little-endian, strips of about 1 MB or tiles, uncompressed, Deflate
    (tag 8) or zstd (tag 50000, one frame per strip or tile).
    ``compression_level`` is 1..9, 3 by default as in the JAX writer:
    Deflate's 1-3 take the native greedy encoder and 4-9 the native
    chain-search one (:func:`_encode_deflate`); zstd's levels map one to
    one."""

    def __init__(self, path: str, bigtiff: bool = True, append: bool = False,
                 compression: Optional[str] = None,
                 compression_level: Optional[int] = None):
        if compression not in (None, "deflate", "zstd"):
            raise ValueError(f"unsupported output compression {compression!r}")
        if compression_level is None:
            compression_level = 3
        if not 1 <= int(compression_level) <= 9:
            raise ValueError(
                f"compression_level must be 1..9, got {compression_level}")
        if compression == "zstd" and not _zstd.available():
            raise _zstd.unavailable()
        self.path, self.big = path, bigtiff
        self._compression = compression
        self._level = int(compression_level)
        if append and os.path.exists(path) and os.path.getsize(path) > 0:
            self._fh = open(path, "r+b")
            self._find_chain_end()
        else:
            self._fh = open(path, "w+b")
            if self.big:
                self._fh.write(struct.pack("<2sHHHQ", b"II", 43, 8, 0, 0))
            else:
                self._fh.write(struct.pack("<2sHI", b"II", 42, 0))
            self._last_ptr = 8 if self.big else 4

    def _find_chain_end(self) -> None:
        fh = self._fh
        header = fh.read(16)
        if header[:2] != b"II":
            raise NotImplementedError("append to big-endian TIFF not supported")
        self.big = struct.unpack("<H", header[2:4])[0] == 43
        ptr_fmt = "<Q" if self.big else "<I"
        ptr_pos = 8 if self.big else 4
        fh.seek(ptr_pos)
        (offset,) = struct.unpack(ptr_fmt, fh.read(struct.calcsize(ptr_fmt)))
        seen = set()
        while offset:
            if offset in seen:
                raise ValueError(f"{self.path}: IFD chain cycles at {offset:#x}")
            seen.add(offset)
            fh.seek(offset)
            if self.big:
                (n,) = struct.unpack("<Q", fh.read(8))
                ptr_pos = offset + 8 + 20 * n
            else:
                (n,) = struct.unpack("<H", fh.read(2))
                ptr_pos = offset + 2 + 12 * n
            fh.seek(ptr_pos)
            (offset,) = struct.unpack(ptr_fmt,
                                      fh.read(struct.calcsize(ptr_fmt)))
        self._last_ptr = ptr_pos

    def write(self, image: np.ndarray, description: Optional[str] = None,
              tile: Optional[Tuple[int, int]] = None) -> None:
        """Append one grayscale page (any 8/16/32/64-bit numeric dtype);
        ``tile=(th, tw)``, multiples of 16, writes it tiled."""
        self._write_page(image, description, tile=tile)

    def write_pyramid(self, image: np.ndarray,
                      description: Optional[str] = None,
                      tile: Tuple[int, int] = (256, 256),
                      min_size: int = 256) -> int:
        """Append a pyramidal page (``unmicst_tpu/io/tiff.py:1048-1077``):
        the full-resolution page and a SubIFD chain of 2x box-mean levels,
        every level tiled, halving while the short edge stays at least
        ``2 * min_size``.  The page chain stays flat: a reader that
        ignores SubIFDs sees the usual full-resolution page.  Returns the
        number of reduced levels."""
        image = np.ascontiguousarray(image)
        if image.ndim != 2:
            raise ValueError("TiffWriter writes single-sample 2D pages")
        levels, cur = [], image
        while min(cur.shape) >= 2 * min_size:
            cur = _box_downsample2(cur)
            levels.append(cur)
        subs = [self._write_page(lv, None, tile=tile, subfile_type=1,
                                 chain=False) for lv in levels]
        self._write_page(image, description, tile=tile,
                         subifds=subs or None)
        return len(levels)

    def _encode(self, data: bytes) -> bytes:
        if self._compression == "deflate":
            return _encode_deflate(data, self._level)
        if self._compression == "zstd":
            return _zstd.compress(data, self._level)
        return data

    def _write_page(self, image: np.ndarray, description: Optional[str],
                    tile: Optional[Tuple[int, int]] = None, subifds=None,
                    subfile_type: Optional[int] = None,
                    chain: bool = True) -> int:
        """One page's data and IFD, linked into the page chain unless
        ``chain=False`` (a pyramid level).  Returns the IFD's offset."""
        image = np.ascontiguousarray(image)
        if image.ndim != 2:
            raise ValueError("TiffWriter writes single-sample 2D pages")
        image = image.astype(image.dtype.newbyteorder("<"))
        h, w = image.shape
        item = image.dtype.itemsize
        fmt = {"f": 3, "i": 2}.get(image.dtype.kind, 1)
        fh = self._fh
        fh.seek(0, os.SEEK_END)

        def align():
            if fh.tell() % 2:
                fh.write(b"\0")

        align()
        offsets, counts = [], []

        def put(data):
            data = self._encode(data)
            offsets.append(fh.tell())
            counts.append(len(data))
            fh.write(data)

        if tile is not None:
            th, tw = int(tile[0]), int(tile[1])
            if th <= 0 or tw <= 0 or th % 16 or tw % 16:
                raise ValueError(f"tile dims must be positive multiples of "
                                 f"16, got ({th}, {tw})")
            for r0 in range(0, h, th):
                for c0 in range(0, w, tw):
                    blk = image[r0 : r0 + th, c0 : c0 + tw]
                    if blk.shape != (th, tw):  # edge tiles are full tiles
                        full = np.zeros((th, tw), image.dtype)
                        full[: blk.shape[0], : blk.shape[1]] = blk
                        blk = full
                    put(blk.tobytes())
        else:
            rps = max(1, min(h, (1 << 20) // max(1, w * item)))
            for r0 in range(0, h, rps):
                put(image[r0 : r0 + rps].tobytes())
        slot, off_type, off_char = (8, 16, "Q") if self.big else (4, 4, "I")

        def out_of_line(values):
            """Pointer to ``values`` written after the data, or None when
            they fit the entry's value slot."""
            if len(values) == 1:
                return None
            align()
            pos = fh.tell()
            fh.write(struct.pack(f"<{len(values)}{off_char}", *values))
            return pos

        def offset_field(values):
            """(type, count, values or [pointer], is_pointer) of an
            offset-sized array field."""
            ptr = out_of_line(values)
            return (off_type, len(values),
                    values if ptr is None else [ptr], ptr is not None)

        seg_offsets, seg_counts = offset_field(offsets), offset_field(counts)
        sub = offset_field(subifds) if subifds is not None else None
        desc = None
        if description is not None:
            desc = description.encode("utf-8") + b"\0"
            desc_ptr = None
            if len(desc) > slot:
                align()
                desc_ptr = fh.tell()
                fh.write(desc)
        compression = {"deflate": COMPRESSION_DEFLATE_ADOBE,
                       "zstd": COMPRESSION_ZSTD}.get(self._compression,
                                                     COMPRESSION_NONE)
        # (tag, type, count, values, is_pointer) in ascending tag order
        entries = []
        if subfile_type is not None:  # bit 0: a reduced-resolution level
            entries.append((TAG_NEW_SUBFILE_TYPE, 4, 1, [subfile_type],
                            False))
        entries += [
            (TAG_IMAGE_WIDTH, 4, 1, [w], False),
            (TAG_IMAGE_LENGTH, 4, 1, [h], False),
            (TAG_BITS_PER_SAMPLE, 3, 1, [item * 8], False),
            (TAG_COMPRESSION, 3, 1, [compression], False),
            (TAG_PHOTOMETRIC, 3, 1, [1], False),
        ]
        if desc is not None:
            entries.append((TAG_IMAGE_DESCRIPTION, 2, len(desc),
                            desc if desc_ptr is None else [desc_ptr],
                            desc_ptr is not None))
        if tile is None:
            entries += [
                (TAG_STRIP_OFFSETS, *seg_offsets),
                (TAG_SAMPLES_PER_PIXEL, 3, 1, [1], False),
                (TAG_ROWS_PER_STRIP, 4, 1, [rps], False),
                (TAG_STRIP_BYTE_COUNTS, *seg_counts),
            ]
        else:
            entries += [
                (TAG_SAMPLES_PER_PIXEL, 3, 1, [1], False),
                (TAG_TILE_WIDTH, 4, 1, [tw], False),
                (TAG_TILE_LENGTH, 4, 1, [th], False),
                (TAG_TILE_OFFSETS, *seg_offsets),
                (TAG_TILE_BYTE_COUNTS, *seg_counts),
            ]
        if sub is not None:
            entries.append((TAG_SUBIFDS, *sub))
        entries.append((TAG_SAMPLE_FORMAT, 3, 1, [fmt], False))
        align()
        ifd = fh.tell()
        count_fmt, entry_fmt, ptr_fmt = (
            ("<Q", "<HHQ", "<Q") if self.big else ("<H", "<HHI", "<I")
        )
        buf = struct.pack(count_fmt, len(entries))
        for tag, ftype, count, values, is_ptr in entries:
            if isinstance(values, bytes):
                payload = values.ljust(slot, b"\0")
            elif is_ptr:
                payload = struct.pack(ptr_fmt, values[0])
            else:
                ch = _FIELD_TYPES[ftype][0]
                payload = struct.pack(f"<{len(values)}{ch}",
                                      *values).ljust(slot, b"\0")
            buf += struct.pack(entry_fmt, tag, ftype, count) + payload
        buf += struct.pack(ptr_fmt, 0)
        fh.write(buf)
        if chain:
            fh.seek(self._last_ptr)
            fh.write(struct.pack(ptr_fmt, ifd))
            self._last_ptr = ifd + (8 + 20 * len(entries) if self.big
                                    else 2 + 12 * len(entries))
        fh.flush()
        return ifd

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def imread(path: str, page: int = 0) -> np.ndarray:
    """Read one TIFF page, in native byte order; where the reader refuses
    it (``NotImplementedError`` or ``ValueError``, not
    :class:`PageTooLargeError`), :func:`read_page_fallback`, whose
    exceptions pass through as PIL's do in the JAX package
    (``unmicst_tpu/io/tiff.py:1274-1291``)."""
    try:
        with TiffFile(path) as tf:
            arr = tf.read_page(page)
    except PageTooLargeError:
        raise
    except (NotImplementedError, ValueError) as e:
        return read_page_fallback(path, page, e)
    if arr.dtype.byteorder not in ("=", "|"):
        arr = arr.astype(arr.dtype.newbyteorder("="))
    return arr


def num_pages(path: str) -> int:
    with TiffFile(path) as tf:
        return len(tf.pages)


def imwrite(path: str, image: np.ndarray, bigtiff: bool = True,
            append: bool = False, compression: Optional[str] = None,
            pyramid: bool = False) -> None:
    """Write or append one grayscale page (``UnMicst1-5.py:852-862``);
    ``pyramid=True`` writes it tiled, 256², with a SubIFD pyramid."""
    with TiffWriter(path, bigtiff=bigtiff, append=append,
                    compression=compression) as tw:
        if pyramid:
            tw.write_pyramid(image)
        else:
            tw.write(image)
