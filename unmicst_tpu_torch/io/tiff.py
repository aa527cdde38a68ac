"""TIFF reading and writing for slide IO, in numpy and the standard library.

A subset of ``unmicst_tpu/io/tiff.py`` with no native codec and no PIL:

* :class:`TiffFile` reads classic and BigTIFF files in either byte order,
  strip- or tile-organised pages, uncompressed, Deflate (zlib), LZW,
  PackBits or LZMA (xz), with horizontal predictor 2, 8/16/32/64-bit
  samples; zstd strips raise, naming ROADMAP M14;
* :class:`TiffWriter` writes grayscale pages, classic or BigTIFF,
  uncompressed or Deflate, appending to an existing file by re-chaining
  the IFD list — the reference's output contract (``UnMicst1-5.py:
  834-843``: bigtiff, no metadata, per-page append).

``imread``, ``num_pages`` and ``imwrite`` keep the JAX package's names.
"""

from __future__ import annotations

import lzma
import os
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

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
TAG_SAMPLE_FORMAT = 339

COMPRESSION_NONE = 1
COMPRESSION_LZW = 5
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


def _decode(data: bytes, compression: int, max_out: int) -> bytes:
    if compression == COMPRESSION_NONE:
        return data
    if compression in (COMPRESSION_DEFLATE, COMPRESSION_DEFLATE_ADOBE):
        try:
            # bounded: a crafted strip must not decompression-bomb the host
            return zlib.decompressobj().decompress(data, max_out + 65536)
        except zlib.error as exc:
            raise ValueError(f"corrupt deflate strip: {exc}") from None
    if compression == COMPRESSION_LZW:
        return _unpack_lzw(data, max_out)
    if compression == COMPRESSION_PACKBITS:
        return _unpack_packbits(data)
    if compression == COMPRESSION_LZMA:
        try:
            # bounded like deflate
            return lzma.LZMADecompressor().decompress(data, max_out + 65536)
        except lzma.LZMAError as exc:
            raise ValueError(f"corrupt LZMA strip: {exc}") from None
    if compression == COMPRESSION_ZSTD:
        raise NotImplementedError(
            "zstd TIFF strips are not read by unmicst_tpu_torch yet (ROADMAP "
            "M14: zstd through a host libzstd); use unmicst_tpu for them"
        )
    raise NotImplementedError(
        f"TIFF compression {compression} is not read by unmicst_tpu_torch "
        "(none, deflate, LZW, PackBits and LZMA are)"
    )


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
    """Random-access TIFF reader (classic + BigTIFF)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        try:
            self._parse()
        except Exception:
            self._fh.close()
            raise

    def _parse(self) -> None:
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
        return page, next_ifd

    def _segment(self, page: TiffPage, k: int, rows: int, cols: int
                 ) -> np.ndarray:
        """Decode strip/tile ``k`` as ``rows x cols x samples``."""
        if k >= len(page.offsets):
            raise ValueError(f"TIFF page holds {len(page.offsets)} segments, "
                             f"needs segment {k}")
        off, cnt = int(page.offsets[k]), int(page.counts[k])
        if off < 0 or cnt < 0 or off + cnt > self._fsize:
            raise ValueError(f"TIFF segment at {off} extends past EOF")
        nbytes = rows * cols * page.samples * (page.bits // 8)
        self._fh.seek(off)
        buf = _decode(self._fh.read(cnt), page.compression, nbytes)
        if len(buf) < nbytes:
            raise ValueError(f"TIFF segment {k} decodes to {len(buf)} of "
                             f"{nbytes} bytes")
        dtype = page.dtype.newbyteorder(self.byteorder)
        arr = np.frombuffer(buf, dtype=dtype, count=rows * cols * page.samples)
        arr = arr.reshape(rows, cols, page.samples).astype(page.dtype)
        if page.predictor == 2:
            np.cumsum(arr, axis=1, dtype=arr.dtype, out=arr)
        return arr

    def _check_readable(self, page: TiffPage) -> None:
        if page.planar != 1 and page.samples > 1:
            raise NotImplementedError("planar TIFF not supported")
        if page.predictor not in (1, 2):
            raise NotImplementedError(f"TIFF predictor {page.predictor}")

    def read_page(self, index: int = 0) -> np.ndarray:
        """Decode a full page to ``(H, W)`` or ``(H, W, S)``."""
        page = self.pages[index]
        self._check_readable(page)
        if page.height * page.width * page.samples > 1 << 31:
            raise PageTooLargeError(
                f"TIFF page {page.height}x{page.width} is too large to read "
                "whole"
            )
        return self.read_region(index, 0, 0, page.height, page.width)

    def read_region(self, index: int, r0: int, c0: int, nrows: int,
                    ncols: int) -> np.ndarray:
        """Decode only the strips or tiles under a window: rows
        ``[r0, r0 + nrows)``, columns ``[c0, c0 + ncols)``, zero outside
        the page (``unmicst_tpu/io/tiff.py:805``).  The streaming engine
        reads a slide this way, so it never sits whole in host RAM."""
        page = self.pages[index]
        self._check_readable(page)
        if r0 < 0 or c0 < 0 or nrows < 0 or ncols < 0:
            raise ValueError(f"bad region ({r0}, {c0}, {nrows}, {ncols})")
        out = np.zeros((nrows, ncols, page.samples), page.dtype)
        r1 = min(r0 + nrows, page.height)
        c1 = min(c0 + ncols, page.width)
        if page.tiled:
            th, tw = page.tile_length, page.tile_width
            across = -(-page.width // tw)
            for ti in range(r0 // th, -(-r1 // th)):
                for tj in range(c0 // tw, -(-c1 // tw)):
                    arr = self._segment(page, ti * across + tj, th, tw)
                    tr0, tc0 = ti * th, tj * tw
                    a, b = max(r0, tr0), min(r1, tr0 + th)
                    c, d = max(c0, tc0), min(c1, tc0 + tw)
                    out[a - r0 : b - r0, c - c0 : d - c0] = arr[
                        a - tr0 : b - tr0, c - tc0 : d - tc0]
        else:
            rps = max(1, min(page.rows_per_strip, page.height))
            for st in range(r0 // rps, -(-r1 // rps)):
                sr0 = st * rps
                rows = min(rps, page.height - sr0)
                arr = self._segment(page, st, rows, page.width)
                a, b = max(r0, sr0), min(r1, sr0 + rows)
                out[a - r0 : b - r0, : max(0, c1 - c0)] = arr[
                    a - sr0 : b - sr0, c0:c1]
        return out[:, :, 0] if page.samples == 1 else out


class TiffWriter:
    """Grayscale multi-page TIFF/BigTIFF writer with append semantics:
    little-endian, strips of about 1 MB, uncompressed or Deflate."""

    def __init__(self, path: str, bigtiff: bool = True, append: bool = False,
                 compression: Optional[str] = None, compression_level: int = 6):
        if compression not in (None, "deflate"):
            raise ValueError(f"unsupported output compression {compression!r}")
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

    def write(self, image: np.ndarray, description: Optional[str] = None
              ) -> None:
        """Append one grayscale page (any 8/16/32/64-bit numeric dtype)."""
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
        rps = max(1, min(h, (1 << 20) // max(1, w * item)))
        offsets, counts = [], []
        for r0 in range(0, h, rps):
            data = image[r0 : r0 + rps].tobytes()
            if self._compression == "deflate":
                data = zlib.compress(data, self._level)
            offsets.append(fh.tell())
            counts.append(len(data))
            fh.write(data)
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

        so_ptr, sc_ptr = out_of_line(offsets), out_of_line(counts)
        desc = None
        if description is not None:
            desc = description.encode("utf-8") + b"\0"
            desc_ptr = None
            if len(desc) > slot:
                align()
                desc_ptr = fh.tell()
                fh.write(desc)
        compression = (COMPRESSION_DEFLATE_ADOBE
                       if self._compression == "deflate" else COMPRESSION_NONE)
        # (tag, type, count, values, is_pointer) in ascending tag order
        entries = [
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
        entries += [
            (TAG_STRIP_OFFSETS, off_type, len(offsets),
             offsets if so_ptr is None else [so_ptr], so_ptr is not None),
            (TAG_SAMPLES_PER_PIXEL, 3, 1, [1], False),
            (TAG_ROWS_PER_STRIP, 4, 1, [rps], False),
            (TAG_STRIP_BYTE_COUNTS, off_type, len(counts),
             counts if sc_ptr is None else [sc_ptr], sc_ptr is not None),
            (TAG_SAMPLE_FORMAT, 3, 1, [fmt], False),
        ]
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
        fh.seek(self._last_ptr)
        fh.write(struct.pack(ptr_fmt, ifd))
        self._last_ptr = ifd + (8 + 20 * len(entries) if self.big
                                else 2 + 12 * len(entries))
        fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def imread(path: str, page: int = 0) -> np.ndarray:
    """Read one TIFF page, in native byte order."""
    with TiffFile(path) as tf:
        arr = tf.read_page(page)
    if arr.dtype.byteorder not in ("=", "|"):
        arr = arr.astype(arr.dtype.newbyteorder("="))
    return arr


def num_pages(path: str) -> int:
    with TiffFile(path) as tf:
        return len(tf.pages)


def imwrite(path: str, image: np.ndarray, bigtiff: bool = True,
            append: bool = False, compression: Optional[str] = None) -> None:
    """Write or append one grayscale page (``UnMicst1-5.py:852-862``)."""
    with TiffWriter(path, bigtiff=bigtiff, append=append,
                    compression=compression) as tw:
        tw.write(image)
