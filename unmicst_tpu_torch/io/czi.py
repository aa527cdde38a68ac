"""CZI (Zeiss ZISRAW) reader in numpy and ``struct``: the port of
``unmicst_tpu/io/czi.py``.

The reference reads ``czi.asarray()[0, 0, channel, 0, 0, :, :, 0]``
through ``czifile`` (``UnMicst1-5.py:798-801``): one channel plane of the
first scene, timepoint and Z.  This reader parses the segment stream and
assembles exactly that plane, mosaics included:

* the file is a sequence of 32-byte-aligned segments, each headed by a
  16-byte ASCII id, an int64 allocated size and an int64 used size;
* ``ZISRAWFILE`` carries the sub-block directory's offset at payload
  offset 52 and the metadata segment's at 60;
* ``ZISRAWDIRECTORY`` holds ``DirectoryEntryDV`` records: pixel type,
  file position, compression, pyramid type and per-dimension start and
  stored size;
* each ``ZISRAWSUBBLOCK`` repeats its entry, then metadata, then the
  pixels at ``max(256, entry_size + 16)``.

Sub-blocks decode uncompressed (0), "zstd0" (5, a bare frame) and "zstd1"
(6, a small header that may declare hi-lo byte packing, then the frame),
both through :mod:`unmicst_tpu_torch.io.zstd`, and plain JPEG (2, Gray8)
through :mod:`unmicst_tpu_torch.io.jpeg` (the JAX reader uses PIL).  JPEG
XR (4) has no decoder under the port's import rule (the JAX reader uses
``imagecodecs``): a plane that needs one raises ``NotImplementedError``
when it is opened, before any pixel is returned.  Pyramid levels and
downsampled sub-blocks are skipped.  Every header-driven size is bounded,
and a corrupt file raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Tuple

import numpy as np

from unmicst_tpu_torch.io import jpeg, jxr
from unmicst_tpu_torch.io import zstd as _zstd

_SEG_HEADER = struct.Struct("<16sqq")
COMP_NONE = 0
COMP_JPEG = 2  # JPEG, Gray8 (io/jpeg.py)
COMP_JXR = 4  # JPEG XR: refused (io/jxr.py)
COMP_ZSTD0 = 5
COMP_ZSTD1 = 6
_SUPPORTED_COMPRESSIONS = (
    COMP_NONE, COMP_JPEG, COMP_JXR, COMP_ZSTD0, COMP_ZSTD1,
)
# decompressed sub-blocks kept for windowed (streaming) reads
_BLOCK_CACHE_BYTES = 256 << 20
_PIXEL_DTYPES = {
    0: np.dtype(np.uint8),  # Gray8
    1: np.dtype(np.uint16),  # Gray16
    12: np.dtype(np.float32),  # Gray32Float
}


@dataclasses.dataclass
class SubBlockEntry:
    pixel_type: int
    file_position: int
    compression: int
    pyramid_type: int
    dims: Dict[str, Tuple[int, int]]  # dim -> (start, stored size)
    downsampled: bool = False  # any dim with StoredSize != Size

    def dim(self, name: str, default: int = 0) -> int:
        return self.dims.get(name, (default, 1))[0]

    def size(self, name: str) -> int:
        """Stored size of a REQUIRED dimension (ValueError when absent —
        a KeyError from a corrupt entry must stay a clean parse error)."""
        try:
            return self.dims[name][1]
        except KeyError:
            raise ValueError(
                f"CZI sub-block entry lacks the {name} dimension"
            ) from None

    @property
    def full_resolution(self) -> bool:
        return self.pyramid_type == 0 and not self.downsampled


def _parse_directory_entry(buf: bytes, pos: int) -> Tuple[SubBlockEntry, int]:
    # every length is validated before unpacking: serve.py feeds
    # uploaded bytes here, and a truncated/crafted entry must raise
    # ValueError — never struct.error or UnicodeDecodeError
    if pos + 32 > len(buf):
        raise ValueError("truncated CZI directory entry")
    schema = buf[pos : pos + 2]
    if schema != b"DV":
        raise ValueError(f"unsupported CZI directory entry schema {schema!r}")
    pixel_type, = struct.unpack_from("<i", buf, pos + 2)
    file_position, = struct.unpack_from("<q", buf, pos + 6)
    # FilePart int32 at +14
    compression, = struct.unpack_from("<i", buf, pos + 18)
    pyramid_type = buf[pos + 22]  # + 5 reserved bytes
    dim_count, = struct.unpack_from("<i", buf, pos + 28)
    # ZISRAW defines single-char dimension ids; 64 is far beyond any
    # real entry and bounds the scan against a crafted count
    if not 0 <= dim_count <= 64 or pos + 32 + 20 * dim_count > len(buf):
        raise ValueError(
            f"corrupt CZI directory entry: {dim_count} dimensions"
        )
    dims: Dict[str, Tuple[int, int]] = {}
    downsampled = False
    p = pos + 32
    for _ in range(dim_count):
        name = buf[p : p + 4].rstrip(b"\x00").decode("ascii", "replace")
        start, size = struct.unpack_from("<ii", buf, p + 4)
        # +12 StartCoordinate float32, +16 StoredSize int32
        stored, = struct.unpack_from("<i", buf, p + 16)
        if stored and stored != size and name in ("X", "Y"):
            downsampled = True
        dims[name] = (start, stored or size)
        p += 20
    entry = SubBlockEntry(
        pixel_type, file_position, compression, pyramid_type, dims,
        downsampled,
    )
    return entry, p


def _parse_zstd1_header(data: bytes) -> Tuple[int, bool]:
    """Parse a "zstd1" payload header -> (frame offset, hi-lo packed).

    Layout (libCZI's documented format): byte 0 is the total header size
    (>= 1, includes itself); the remaining header bytes are chunks of
    [1-byte id, payload].  The only defined chunk id is 1, a 1-byte
    bitfield whose bit 0 signals hi-lo byte-packing preprocessing.
    """
    if not data:
        raise ValueError("empty zstd1 payload")
    hsize = data[0]
    if hsize < 1 or hsize > len(data):
        raise ValueError(f"corrupt zstd1 header size {hsize}")
    hilo = False
    p = 1
    while p < hsize:
        chunk = data[p]
        if chunk == 1:
            if p + 1 >= hsize:
                raise ValueError("truncated zstd1 parameter chunk")
            hilo = bool(data[p + 1] & 1)
            p += 2
        else:
            raise ValueError(f"unknown zstd1 header chunk {chunk}")
    return hsize, hilo


def _decode_pixels(raw: bytes, entry: SubBlockEntry,
                   dtype: np.dtype, path: str = "") -> bytes:
    """Raw sub-block payload -> uncompressed little-endian pixel bytes."""
    if entry.compression == COMP_NONE:
        return raw
    h = entry.size("Y")
    w = entry.size("X")
    # untrusted-header allocation guard (zstd output size is header-derived)
    if not (0 < h <= 1 << 20 and 0 < w <= 1 << 20 and h * w <= 1 << 30):
        raise ValueError(f"implausible CZI sub-block {h}x{w}")
    nbytes = h * w * dtype.itemsize
    if entry.compression == COMP_ZSTD0:
        return _zstd.decompress(raw, nbytes)
    if entry.compression == COMP_ZSTD1:
        try:
            off, hilo = _parse_zstd1_header(raw)
        except ValueError as e:
            # name the file and sub-block so a future-libCZI chunk id is
            # triageable from the traceback alone
            raise ValueError(
                f"{path or '<czi>'}: sub-block at "
                f"{entry.file_position:#x}: {e}"
            ) from None
        out = _zstd.decompress(raw[off:], nbytes)
        return _zstd.unpack_hilo(out, dtype.itemsize) if hilo else out
    if entry.compression == COMP_JPEG:
        where = (f"{path or '<czi>'}: JPEG sub-block at "
                 f"{entry.file_position:#x}")
        if dtype != np.uint8:
            # an 8-bit JPEG in a Gray16 block would land 256x dim
            raise ValueError(f"{where} decodes to uint8, directory "
                             f"declares {dtype}")
        try:
            # the directory's size caps every allocation the header
            # drives; PIL reads the sub-block in its 64 KiB reads
            img = jpeg.decode(raw, (h, w), feed=jpeg.PIL_FEED)
        except ValueError as e:
            raise ValueError(f"{where} failed to decode: {e}") from None
        if img.shape != (h, w):  # a colour frame, as JAX refuses it
            raise ValueError(f"{where} decoded to {img.shape}, directory "
                             f"declares {(h, w)}")
        return img.tobytes()
    raise NotImplementedError(
        f"compressed CZI sub-blocks (compression="
        f"{entry.compression}) are not supported"
    )


def _read_seg_header(f, path: str):
    """Checked 32-byte segment header read (short read / corrupt file ->
    ValueError, never struct.error — serve maps ValueError to HTTP 400)."""
    head = f.read(32)
    if len(head) != 32:
        raise ValueError(f"{path}: truncated CZI segment header")
    return _SEG_HEADER.unpack(head)


class CziFile:
    """Windowless plane reader over the sub-block directory."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            import os as _os

            self._file_size = _os.fstat(self._f.fileno()).st_size
            sid, _alloc, used = _read_seg_header(self._f, path)
            if not sid.startswith(b"ZISRAWFILE"):
                raise ValueError(f"{path}: not a CZI file")
            header = self._read_payload(used)
            if len(header) < 60:
                raise ValueError(f"{path}: truncated CZI file header")
            dir_pos, = struct.unpack_from("<q", header, 52)
            # MetadataPosition sits right after DirectoryPosition in the
            # FileHeaderSegment; absent/zero in minimal writers
            self._meta_pos = (
                struct.unpack_from("<q", header, 60)[0]
                if len(header) >= 68 else 0
            )
            self.entries = self._read_directory(dir_pos)
            self._layouts = {}
            self._block_cache: Dict[int, bytes] = {}  # LRU by insertion
            self._block_cache_bytes = 0
        except Exception:
            self._f.close()
            raise

    def metadata_xml(self):
        """Raw XML of the ZISRAWMETADATA segment, or None.

        Segment payload layout (public spec): XmlSize int32,
        AttachmentSize int32, 248 spare bytes, then XmlSize bytes of
        XML.  Minimal/foreign writers leave MetadataPosition 0; corrupt
        headers fail soft (names are a convenience, not pixels)."""
        if not 32 <= self._meta_pos < self._file_size:
            return None
        self._f.seek(self._meta_pos)
        try:
            sid, _alloc, used = _read_seg_header(self._f, self.path)
            if not sid.startswith(b"ZISRAWMETADATA"):
                return None
            payload = self._read_payload(used)
        except ValueError:
            return None
        if len(payload) < 256:
            return None
        xml_size, = struct.unpack_from("<i", payload, 0)
        if not 0 < xml_size <= len(payload) - 256:
            return None
        return payload[256 : 256 + xml_size].decode("utf-8", "replace")

    def channel_names(self):
        """Ordered channel names from Image/Dimensions/Channels, or None.

        Only the Dimensions block is consulted (DisplaySetting repeats
        the channels with display, not acquisition, identity).  A
        Channel without a Name attribute or <Name> child becomes None —
        same placeholder convention as ``io/ome.py::channel_names``."""
        xml = self.metadata_xml()
        if not xml:
            return None
        import xml.etree.ElementTree as ET

        try:
            root = ET.fromstring(xml)
        except ET.ParseError:
            return None
        dims = next(
            (el for el in root.iter()
             if el.tag == "Dimensions" or el.tag.endswith("}Dimensions")),
            None,
        )
        if dims is None:
            return None
        names = []
        for el in dims.iter():
            if not (el.tag == "Channel" or el.tag.endswith("}Channel")):
                continue
            name = el.get("Name")
            if name is None:
                child = next(
                    (c for c in el
                     if c.tag == "Name" or c.tag.endswith("}Name")),
                    None,
                )
                name = child.text if child is not None else None
            names.append(name)
        return names or None

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_payload(self, used: int) -> bytes:
        # corrupt files can declare multi-GB segment sizes; bound every
        # header-driven read by the actual file size
        if not 0 <= used <= self._file_size:
            raise ValueError(f"{self.path}: corrupt segment size {used}")
        return self._f.read(used)

    def _read_directory(self, dir_pos: int) -> List[SubBlockEntry]:
        self._f.seek(dir_pos)
        sid, _alloc, used = _read_seg_header(self._f, self.path)
        if not sid.startswith(b"ZISRAWDIRECTORY"):
            raise ValueError("CZI sub-block directory segment not found")
        buf = self._read_payload(used)
        if len(buf) < 128:
            raise ValueError(
                f"{self.path}: truncated CZI sub-block directory"
            )
        count, = struct.unpack_from("<i", buf, 0)
        # each entry is >= 32 bytes: a count beyond that is a lie
        if not 0 <= count <= (len(buf) - 128) // 32 + 1:
            raise ValueError(
                f"{self.path}: corrupt CZI directory count {count}"
            )
        entries = []
        pos = 128  # 4-byte count + 124 reserved
        for _ in range(count):
            entry, pos = _parse_directory_entry(buf, pos)
            entries.append(entry)
        return entries

    def _c_base(self) -> int:
        """Minimum C start — czifile indexes every axis relative to its
        minimum, so channel 0 is the lowest C value present."""
        return min((e.dim("C") for e in self.entries), default=0)

    def channels(self) -> int:
        if not self.entries:
            return 0
        base = self._c_base()
        return 1 + max(e.dim("C") for e in self.entries) - base

    def _picks(self, channel: int) -> List[SubBlockEntry]:
        want = channel + self._c_base()  # min-start-relative (czifile)
        picks = [
            e for e in self.entries
            if e.dim("C") == want and e.full_resolution
        ]
        if not picks:
            raise IndexError(
                f"channel {channel} not present (file has "
                f"{self.channels()} channels)"
            )
        for axis in ("S", "T", "Z", "B"):
            first = min(e.dim(axis) for e in picks)
            picks = [e for e in picks if e.dim(axis) == first]
        return picks

    def channel_shape(self, channel: int) -> Tuple[int, int]:
        picks = self._picks(channel)
        y0 = min(e.dim("Y") for e in picks)
        x0 = min(e.dim("X") for e in picks)
        h = max(e.dim("Y") + e.size("Y") for e in picks) - y0
        w = max(e.dim("X") + e.size("X") for e in picks) - x0
        # allocation-bomb guard: the plane is materialized from header
        # values of a possibly untrusted file (serve.py exposure)
        if not (0 < h <= 1 << 20 and 0 < w <= 1 << 20 and h * w <= 1 << 34):
            raise ValueError(
                f"{self.path}: implausible CZI plane {h}x{w}"
            )
        return h, w

    def _payload_span(self, entry: SubBlockEntry) -> Tuple[int, int]:
        """Absolute file offset and byte size of a sub-block's payload."""
        if entry.compression not in _SUPPORTED_COMPRESSIONS:
            raise NotImplementedError(
                f"compressed CZI sub-blocks (compression="
                f"{entry.compression}) are not supported"
            )
        self._f.seek(entry.file_position)
        sid, _alloc, used = _read_seg_header(self._f, self.path)
        if not sid.startswith(b"ZISRAWSUBBLOCK"):
            raise ValueError("directory entry does not point at a sub-block")
        head = self._f.read(528)
        if len(head) < 16:
            raise ValueError(f"{self.path}: truncated sub-block segment")  # 16 fixed + entry (32 + 20/dim, <=24 dims)
        meta_size, _attach, data_size = struct.unpack_from("<iiq", head, 0)
        _, entry_end = _parse_directory_entry(head, 16)
        if meta_size < 0:
            raise ValueError(
                f"{self.path}: corrupt sub-block meta size {meta_size}"
            )
        pos = entry.file_position + 32 + max(256, entry_end) + meta_size
        if not 0 <= data_size <= self._file_size or pos + data_size > self._file_size:
            raise ValueError(f"{self.path}: corrupt sub-block size {data_size}")
        return pos, data_size

    def _decoded_block(self, entry: SubBlockEntry, data_pos: int,
                       data_size: int, dtype: np.dtype) -> bytes:
        """Pixel bytes of one compressed sub-block, via a bounded LRU —
        streaming stripes revisit the same block across adjacent windows."""
        cached = self._block_cache.pop(data_pos, None)
        if cached is not None:
            self._block_cache[data_pos] = cached  # refresh recency
            return cached
        self._f.seek(data_pos)
        raw = _decode_pixels(
            self._f.read(data_size), entry, dtype, self.path
        )
        self._block_cache[data_pos] = raw
        self._block_cache_bytes += len(raw)
        while self._block_cache_bytes > _BLOCK_CACHE_BYTES and len(
            self._block_cache
        ) > 1:
            oldest = next(iter(self._block_cache))
            self._block_cache_bytes -= len(self._block_cache.pop(oldest))
        return raw

    def _channel_layout(self, channel: int):
        """Cached per-channel geometry: (picks+payload offsets, y0, x0,
        h, w, dtype) — read_rows is the streaming hot path and must not
        re-scan the directory per window."""
        cached = self._layouts.get(channel)
        if cached is not None:
            return cached
        picks = self._picks(channel)
        y0 = min(e.dim("Y") for e in picks)
        x0 = min(e.dim("X") for e in picks)
        h, w = self.channel_shape(channel)
        ptypes = {e.pixel_type for e in picks}
        if len(ptypes) != 1:
            raise ValueError(
                f"{self.path}: channel {channel} mixes pixel types "
                f"{sorted(ptypes)}"
            )
        dtype = _PIXEL_DTYPES.get(picks[0].pixel_type)
        if dtype is None:
            raise NotImplementedError(
                f"CZI pixel type {picks[0].pixel_type} not supported"
            )
        for e in picks:
            # no decoder under the import rule: refuse the plane at open
            where = f"{self.path} sub-block at {e.file_position:#x}"
            if e.compression == COMP_JXR:
                raise jxr.refuse(where)
            if (e.compression in (COMP_ZSTD0, COMP_ZSTD1)
                    and not _zstd.available()):
                raise _zstd.unavailable()
        spans = []
        for e in picks:
            data_pos, data_size = self._payload_span(e)
            if e.compression == COMP_NONE:
                need = e.size("Y") * e.size("X") * dtype.itemsize
                if data_size < need:
                    # windowed reads seek inside the payload; a short
                    # declared size would silently read neighbor bytes
                    raise ValueError(
                        f"{self.path}: sub-block at "
                        f"{e.file_position:#x} declares {data_size} B for "
                        f"{need} B of pixels"
                    )
            spans.append((e, data_pos, data_size))
        layout = (spans, y0, x0, h, w, dtype)
        self._layouts[channel] = layout
        return layout

    def read_rows(self, channel: int, r0: int, nrows: int) -> np.ndarray:
        """Rows [r0, r0+nrows) of the channel plane (windowed; mosaics
        assembled per intersecting sub-block) — the streaming-engine
        entry point for whole-slide CZI inputs."""
        picks, y0, x0, h, w, dtype = self._channel_layout(channel)
        out = np.zeros((nrows, w), dtype)
        lo, hi = max(r0, 0), min(r0 + nrows, h)
        for e, data_pos, data_size in picks:
            ty, th = e.dim("Y") - y0, e.size("Y")
            a, b = max(lo, ty), min(hi, ty + th)
            if b <= a:
                continue
            tw = e.size("X")
            row_bytes = tw * dtype.itemsize
            if e.compression == COMP_NONE:
                self._f.seek(data_pos + (a - ty) * row_bytes)
                raw = self._f.read((b - a) * row_bytes)
            else:
                block = self._decoded_block(e, data_pos, data_size, dtype)
                raw = block[(a - ty) * row_bytes : (b - ty) * row_bytes]
            rows = np.frombuffer(
                raw, dtype.newbyteorder("<"), count=(b - a) * tw
            ).reshape(b - a, tw).astype(dtype)
            c = e.dim("X") - x0
            out[a - r0 : b - r0, c : c + tw] = rows
        return out

    def read_channel(self, channel: int) -> np.ndarray:
        """One channel plane of the first scene/time/Z — the
        ``asarray()[0, 0, c, 0, 0, :, :, 0]`` plane the reference extracts.

        Mosaic sub-blocks (M dimension) are placed at their X/Y starts.
        Pyramid/downsampled levels (PyramidType != 0 or StoredSize < Size)
        are skipped — they share the full-res tiles' C/S/T/Z coordinates
        and would otherwise overwrite real pixels with downsampled data.
        """
        h, _w = self.channel_shape(channel)
        # one mosaic-assembly implementation: the windowed path (which
        # also validates payload coverage and pixel-type agreement)
        return self.read_rows(channel, 0, h)


def read_czi_channel(path: str, channel: int) -> np.ndarray:
    with CziFile(path) as czi:
        return czi.read_channel(channel)
