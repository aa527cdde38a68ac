"""ND2 (Nikon) reader in numpy and ``struct``, modern chunk-map
container: the port of ``unmicst_tpu/io/nd2.py``.

The reference reads ``.nd2`` through ``nd2reader`` (``UnMicst1-5.py:
802-804``, where the solo tool's path raises a NameError); the contract
here is the working read: one channel plane.

Modern ND2 layout (as parsed by the public nd2reader/nd2 packages):

* the file is a sequence of chunks: ``u32 magic (0x0ABECEDA), u32 name
  length, u64 data length, name bytes, data``;
* the last 8 bytes of the file give the offset of the chunk-map chunk,
  preceded by the signature ``ND2 CHUNK MAP SIGNATURE 0000001!``; the
  chunk-map data is a list of ``name! + u64 offset + u64 size`` records
  terminated by the signature name;
* pixel payloads live in ``ImageDataSeq|N!`` chunks: an 8-byte timestamp
  followed by component-interleaved little-endian pixels;
* geometry lives in ``ImageAttributesLV!`` (a "Lim Variant" tree).  Rather
  than reproduce the whole LV grammar, the attribute values are located by
  scanning for their UTF-16LE key names (``uiWidth``/``uiHeight``/
  ``uiComp``/``uiBpcInMemory``) and reading the little-endian integer that
  follows — LV encodes each value immediately after its name, so the scan
  is layout-robust.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np

CHUNK_MAGIC = 0x0ABECEDA
CHUNK_MAP_SIGNATURE = b"ND2 CHUNK MAP SIGNATURE 0000001!"


def _lv_scan_uint(blob: bytes, key: str,
                  valid=lambda v: 0 < v < 1 << 20) -> Optional[int]:
    """First plausible little-endian u32 following the UTF-16LE ``key``.

    Some LV writers store the name with a UTF-16 NUL terminator, some
    without; both offsets are tried and disambiguated by the validity
    predicate (image dims < 2^20, components/bit-depths small).
    """
    needle = key.encode("utf-16-le")
    pos = blob.find(needle)
    while pos >= 0:
        base = pos + len(needle)
        if blob[base : base + 2] == b"\x00\x00":
            # NUL right after the name: almost certainly a UTF-16
            # terminator (a value that is a multiple of 65536 is
            # implausible); prefer the post-terminator read
            candidates = [base + 2, base]
        else:
            # may be the value, or the continuation of a longer key
            # (uiWidth inside uiWidthBytes — reads as ASCII UTF-16 units,
            # fails the validity predicate, and the scan moves on)
            candidates = [base]
        for off in candidates:
            if off + 4 <= len(blob):
                v = struct.unpack_from("<I", blob, off)[0]
                if valid(v):
                    return v
        pos = blob.find(needle, pos + 1)
    return None


class Nd2File:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            import os as _os

            self._file_size = _os.fstat(self._f.fileno()).st_size
            self.chunks = self._read_chunk_map()
            attrs = self._read_chunk("ImageAttributesLV!")
            if attrs is None:
                raise ValueError(
                    f"{path}: no ImageAttributesLV chunk (legacy/JPEG2000 "
                    "ND2 files are not supported)"
                )
            self.width = _lv_scan_uint(attrs, "uiWidth")
            self.height = _lv_scan_uint(attrs, "uiHeight")
            self.components = _lv_scan_uint(
                attrs, "uiComp", valid=lambda v: 0 < v <= 1024
            ) or 1
            self.bits = _lv_scan_uint(attrs, "uiBpcInMemory") or 16
            if not self.width or not self.height:
                raise ValueError(f"{path}: image dimensions missing")
            if self.bits not in (8, 16, 32):
                raise NotImplementedError(
                    f"{self.bits}-bit ND2 not supported"
                )
            self.dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32}[self.bits]
            self.n_frames = sum(
                1 for name in self.chunks
                if name.startswith(b"ImageDataSeq|")
            )
        except Exception:
            self._f.close()
            raise

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_chunk_map(self) -> Dict[bytes, Tuple[int, int]]:
        if self._file_size < 8 + len(CHUNK_MAP_SIGNATURE):
            raise ValueError(f"{self.path}: not an ND2 file (too small)")
        self._f.seek(-8, 2)
        map_pos, = struct.unpack("<Q", self._f.read(8))
        self._f.seek(-8 - len(CHUNK_MAP_SIGNATURE), 2)
        if self._f.read(len(CHUNK_MAP_SIGNATURE)) != CHUNK_MAP_SIGNATURE:
            raise ValueError(f"{self.path}: ND2 chunk-map signature missing")
        data = self._chunk_data_at(map_pos)
        chunks: Dict[bytes, Tuple[int, int]] = {}
        pos = 0
        while True:
            end = data.find(b"!", pos)
            if end < 0:
                break
            name = data[pos : end + 1]
            if name == CHUNK_MAP_SIGNATURE:
                break
            if end + 17 > len(data):
                raise ValueError(
                    f"{self.path}: truncated ND2 chunk-map record"
                )
            offset, size = struct.unpack_from("<QQ", data, end + 1)
            chunks[name] = (offset, size)
            pos = end + 1 + 16
        return chunks

    def _chunk_header_at(self, pos: int) -> Tuple[int, int]:
        """Checked chunk header -> (data_start, data_len).

        Every header-driven quantity is bounded by the file size and
        short reads raise ValueError (never struct.error — serve maps
        ValueError to HTTP 400)."""
        self._f.seek(pos)
        head = self._f.read(16)
        if len(head) != 16:
            raise ValueError(f"{self.path}: truncated chunk header at {pos:#x}")
        magic, name_len, data_len = struct.unpack("<IIQ", head)
        if magic != CHUNK_MAGIC:
            raise ValueError(f"{self.path}: bad chunk magic at {pos:#x}")
        data_start = pos + 16 + name_len
        if (not 0 <= data_len <= self._file_size
                or not 0 <= name_len <= self._file_size
                or data_start + data_len > self._file_size):
            raise ValueError(
                f"{self.path}: corrupt chunk at {pos:#x} "
                f"(name_len={name_len}, data_len={data_len})"
            )
        return data_start, data_len

    def _chunk_data_at(self, pos: int) -> bytes:
        data_start, data_len = self._chunk_header_at(pos)
        self._f.seek(data_start)
        data = self._f.read(data_len)
        if len(data) != data_len:
            raise ValueError(
                f"{self.path}: chunk at {pos:#x} truncated by EOF"
            )
        return data

    def _read_chunk(self, name: str) -> Optional[bytes]:
        entry = self.chunks.get(name.encode("ascii"))
        if entry is None:
            return None
        return self._chunk_data_at(entry[0])

    def _frame_span(self, seq: int) -> Tuple[int, int]:
        """(pixel payload offset, payload bytes) of frame ``seq`` — the
        8-byte timestamp header is skipped and excluded from the size."""
        entry = self.chunks.get(f"ImageDataSeq|{seq}!".encode("ascii"))
        if entry is None:
            raise IndexError(
                f"frame {seq} not present ({self.n_frames} frames)"
            )
        data_start, data_len = self._chunk_header_at(entry[0])
        if data_len < 8:
            raise ValueError(
                f"{self.path}: frame {seq} chunk smaller than its "
                "timestamp header"
            )
        return data_start + 8, data_len - 8

    def read_rows(self, channel: int, r0: int, nrows: int) -> np.ndarray:
        """Rows [r0, r0+nrows) of one channel plane, windowed (seeks into
        the frame payload; de-interleaves components on the fly) — the
        streaming-engine entry point for whole-slide ND2 inputs."""
        if self.components > 1:
            if not 0 <= channel < self.components:
                raise IndexError(
                    f"channel {channel} out of range "
                    f"({self.components} components)"
                )
            seq, comp = 0, channel
        else:
            seq, comp = channel, 0
        out = np.zeros((nrows, self.width), self.dtype)
        a, b = max(r0, 0), min(r0 + nrows, self.height)
        if b > a:
            item = np.dtype(self.dtype).itemsize
            row_bytes = self.width * self.components * item
            data_pos, data_len = self._frame_span(seq)
            if self.height * row_bytes > data_len:
                # a short declared payload would otherwise read the next
                # chunk's bytes as pixels (mirrors the CZI guard)
                raise ValueError(
                    f"{self.path}: frame {seq} payload {data_len} B < "
                    f"{self.height * row_bytes} B of declared pixels"
                )
            self._f.seek(data_pos + a * row_bytes)
            raw = self._f.read((b - a) * row_bytes)
            px = np.frombuffer(
                raw, np.dtype(self.dtype).newbyteorder("<"),
                count=(b - a) * self.width * self.components,
            ).reshape(b - a, self.width, self.components)
            out[a - r0 : b - r0] = px[:, :, comp]
        return out

    def read_channel(self, channel: int) -> np.ndarray:
        """One 2-D channel plane.

        Multi-component files de-interleave component ``channel`` of the
        first frame; single-component files treat ``channel`` as the frame
        index (the nd2reader iteration the reference indexes into).
        """
        # the windowed path holds the payload-coverage validation and
        # the only de-interleave implementation; it also avoids
        # materializing the full interleaved frame for one plane
        return np.ascontiguousarray(self.read_rows(channel, 0, self.height))


def read_nd2_channel(path: str, channel: int) -> np.ndarray:
    with Nd2File(path) as nd2:
        return nd2.read_channel(channel)
