"""Pure-Python reader for TF1 ``tf.train.Saver`` checkpoints (tensor bundles).

The reference model zoo ships TF1 checkpoints (``models/*/model.ckpt.{index,
data-00000-of-00001}``, restored at ``UnMicst.py:510-515``).  TensorFlow is
not a dependency of this framework, so this module parses the on-disk
"tensor bundle" format directly:

* ``model.ckpt.index`` — a LevelDB-style SSTable mapping tensor names to
  serialized ``BundleEntryProto`` messages (dtype, shape, shard, offset,
  size).  Block format: prefix-compressed key/value entries + restart array,
  each block followed by a 1-byte compression type (0 raw, 1 snappy) and a
  crc32c; file footer = two BlockHandles + magic ``0xdb4775248b80fb57``.
* ``model.ckpt.data-NNNNN-of-MMMMM`` — raw little-endian tensor bytes at
  the offsets recorded in the index.

Only the protobuf fields the bundle actually uses are decoded (hand-rolled
varint walker — no protobuf dependency either).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

_TABLE_MAGIC = 0xDB4775248B80FB57

# tensorflow/core/framework/types.proto DataType -> numpy
_DTYPES = {
    1: np.float32,
    2: np.float64,
    3: np.int32,
    4: np.uint8,
    5: np.int16,
    6: np.int8,
    7: np.bytes_,  # string (unsupported for data read)
    9: np.int64,
    10: np.bool_,
    14: "bfloat16",  # decoded through torch (numpy has no bfloat16)
    17: np.uint16,
    19: np.float16,
    22: np.uint32,
    23: np.uint64,
}


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            # a truncated/corrupt table file must fail as a parse error,
            # not an IndexError internal (fuzz: scripts/fuzz_native_codec
            # --mode ckpt — half-copied model dirs are the realistic hit)
            raise ValueError("truncated varint in checkpoint table")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _snappy_decompress(data: bytes) -> bytes:
    """Minimal snappy block-format decompressor (no framing)."""
    length, pos = _varint(data, 0)
    if length > 1 << 31:
        raise ValueError(f"implausible snappy decoded length {length}")
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nbytes = ln - 59
                ln = int.from_bytes(data[pos : pos + nbytes], "little")
                pos += nbytes
            ln += 1
            out += data[pos : pos + ln]
            pos += ln
        else:
            if kind == 1:
                if pos >= n:
                    raise ValueError("truncated snappy copy tag")
                ln = ((tag >> 2) & 0x7) + 4
                offset = ((tag & 0xE0) << 3) | data[pos]
                pos += 1
            elif kind == 2:
                ln = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 2], "little")
                pos += 2
            else:
                ln = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 4], "little")
                pos += 4
            if offset == 0 or offset > len(out):
                raise ValueError(
                    "corrupt snappy stream (copy offset outside output)"
                )
            for _ in range(ln):  # may self-overlap; copy byte-wise
                out.append(out[-offset])
    if len(out) != length:
        raise ValueError("snappy length mismatch")
    return bytes(out)


def _read_block(blob: bytes, offset: int, size: int) -> bytes:
    """Fetch block contents, honoring the 1-byte type + crc32c trailer."""
    if offset < 0 or size < 0 or offset + size >= len(blob):
        raise ValueError(
            f"corrupt table block handle ({offset}+{size} past "
            f"{len(blob)}-byte file)"
        )
    contents = blob[offset : offset + size]
    ctype = blob[offset + size]
    if ctype == 0:
        return contents
    if ctype == 1:
        return _snappy_decompress(contents)
    raise NotImplementedError(f"table block compression {ctype}")


def _iter_block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (key, value) pairs from a prefix-compressed table block."""
    if len(block) < 4:
        return
    (num_restarts,) = struct.unpack("<I", block[-4:])
    data_end = len(block) - 4 * (num_restarts + 1)
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        value_len, pos = _varint(block, pos)
        key = key[:shared] + block[pos : pos + unshared]
        pos += unshared
        value = block[pos : pos + value_len]
        pos += value_len
        yield key, value


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    """TensorShapeProto: repeated field 2 = Dim{1: size varint}."""
    dims = []
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 2 and wire == 2:  # Dim message
            ln, pos = _varint(buf, pos)
            sub = buf[pos : pos + ln]
            pos += ln
            spos = 0
            size = 0
            while spos < len(sub):
                stag, spos = _varint(sub, spos)
                sfield, swire = stag >> 3, stag & 7
                if sfield == 1 and swire == 0:
                    size, spos = _varint(sub, spos)
                elif swire == 2:
                    sl, spos = _varint(sub, spos)
                    spos += sl
                elif swire == 0:
                    _, spos = _varint(sub, spos)
                elif swire == 5:
                    spos += 4
                elif swire == 1:
                    spos += 8
            dims.append(size)
        elif wire == 0:
            _, pos = _varint(buf, pos)
        elif wire == 2:
            ln, pos = _varint(buf, pos)
            pos += ln
        elif wire == 5:
            pos += 4
        elif wire == 1:
            pos += 8
    return tuple(dims)


class BundleEntry:
    __slots__ = ("dtype", "shape", "shard_id", "offset", "size", "crc32c")

    def __init__(self):
        self.dtype = 0
        self.shape: Tuple[int, ...] = ()
        self.shard_id = 0
        self.offset = 0
        self.size = 0
        self.crc32c = 0  # masked CRC32C of the tensor bytes (proto field 6)

    @classmethod
    def parse(cls, buf: bytes) -> "BundleEntry":
        e = cls()
        pos = 0
        while pos < len(buf):
            tag, pos = _varint(buf, pos)
            field, wire = tag >> 3, tag & 7
            if field == 1 and wire == 0:
                e.dtype, pos = _varint(buf, pos)
            elif field == 2 and wire == 2:
                ln, pos = _varint(buf, pos)
                e.shape = _parse_shape(buf[pos : pos + ln])
                pos += ln
            elif field == 3 and wire == 0:
                e.shard_id, pos = _varint(buf, pos)
            elif field == 4 and wire == 0:
                e.offset, pos = _varint(buf, pos)
            elif field == 5 and wire == 0:
                e.size, pos = _varint(buf, pos)
            elif field == 6 and wire == 5:
                if pos + 4 > len(buf):
                    raise ValueError("truncated BundleEntryProto crc32c")
                e.crc32c = struct.unpack_from("<I", buf, pos)[0]
                pos += 4
            elif wire == 0:
                _, pos = _varint(buf, pos)
            elif wire == 2:
                ln, pos = _varint(buf, pos)
                pos += ln
            elif wire == 5:
                pos += 4
            elif wire == 1:
                pos += 8
            else:
                raise ValueError(f"unsupported wire type {wire}")
        return e


def _parse_header_num_shards(buf: bytes) -> Optional[int]:
    """num_shards (field 1) from the BundleHeaderProto stored under key ''."""
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 0:
            n, _ = _varint(buf, pos)
            return n or None
        if wire == 0:
            _, pos = _varint(buf, pos)
        elif wire == 2:
            ln, pos = _varint(buf, pos)
            pos += ln
        elif wire == 5:
            pos += 4
        elif wire == 1:
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return None


class TF1Checkpoint:
    """Random access to a TF1 tensor-bundle checkpoint.

    >>> ckpt = TF1Checkpoint('/path/model.ckpt')
    >>> ckpt.keys()
    ['downsampling/ld0/kernel1', ...]
    >>> ckpt.get_tensor('lt/kernel').shape
    (1, 1, 16, 3)
    """

    def __init__(self, prefix: str):
        self.prefix = prefix
        index_path = prefix + ".index"
        with open(index_path, "rb") as f:
            blob = f.read()
        if len(blob) < 48:
            raise ValueError(f"{index_path}: truncated table file")
        footer = blob[-48:]
        magic = struct.unpack("<Q", footer[-8:])[0]
        if magic != _TABLE_MAGIC:
            raise ValueError(f"{index_path}: bad table magic {magic:#x}")
        # footer: metaindex handle, index handle (varint64 pairs), padding
        pos = 0
        _, pos = _varint(footer, pos)  # metaindex offset
        _, pos = _varint(footer, pos)  # metaindex size
        idx_off, pos = _varint(footer, pos)
        idx_size, pos = _varint(footer, pos)

        self.entries: Dict[str, BundleEntry] = {}
        header_num_shards = None
        index_block = _read_block(blob, idx_off, idx_size)
        for _, handle in _iter_block_entries(index_block):
            hoff, hpos = _varint(handle, 0)
            hsize, _ = _varint(handle, hpos)
            for key, value in _iter_block_entries(_read_block(blob, hoff, hsize)):
                if not key:
                    header_num_shards = _parse_header_num_shards(value)
                    continue  # BundleHeaderProto
                self.entries[key.decode("utf-8")] = BundleEntry.parse(value)

        # The header is authoritative: shard filenames carry num_shards in
        # their -of-NNNNN suffix, and a trailing shard may hold no tensors
        # (so inferring from max shard_id would name the files wrong).
        self._num_shards = header_num_shards or (
            1 + max((e.shard_id for e in self.entries.values()), default=0)
        )
        self._shard_files = {}

    def keys(self):
        return sorted(self.entries)

    def _shard(self, shard_id: int):
        if shard_id not in self._shard_files:
            path = f"{self.prefix}.data-{shard_id:05d}-of-{self._num_shards:05d}"
            self._shard_files[shard_id] = np.memmap(path, dtype=np.uint8, mode="r")
        return self._shard_files[shard_id]

    def get_tensor(self, name: str) -> np.ndarray:
        e = self.entries[name]
        if e.dtype not in _DTYPES:
            raise ValueError(
                f"{self.prefix}: tensor {name!r} has unsupported/corrupt "
                f"dtype enum {e.dtype}"
            )
        raw = self._shard(e.shard_id)[e.offset : e.offset + e.size].tobytes()
        if e.crc32c and _masked_crc32c(raw) != e.crc32c:
            raise ValueError(
                f"{self.prefix}: tensor {name!r} fails its stored CRC32C "
                "(corrupt data shard)"
            )
        if _DTYPES[e.dtype] == "bfloat16":
            # bfloat16 bit patterns -> float32 through a torch view; the
            # values are exact (bfloat16 is the top half of a float32)
            import torch

            bits = np.frombuffer(raw, dtype="<i2").copy()
            t = torch.from_numpy(bits).view(torch.bfloat16).float()
            return t.numpy().reshape(e.shape)
        dtype = np.dtype(_DTYPES[e.dtype])
        arr = np.frombuffer(raw, dtype=dtype.newbyteorder("<"))
        return arr.reshape(e.shape).astype(dtype)


_CRC32C_TABLE = None


def _masked_crc32c(data: bytes) -> int:
    """CRC32-C (Castagnoli), masked per the LevelDB/TF convention —
    ``((crc >> 15) | (crc << 17)) + 0xa282ead8`` — used by both the table
    block trailers and BundleEntryProto.crc32c."""
    crc = _crc32c_compute(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _crc32c_compute(data: bytes) -> int:
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
            table.append(crc)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF
