"""Pure-Python reader and writer for TF1 ``tf.train.Saver`` checkpoints
(tensor bundles).

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
varint walker — no protobuf dependency either).  The writer half
(:func:`write_tf1_checkpoint`) produces the same bytes as the JAX
package's: one data block, no compression, masked CRC32-C trailers.
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

    def has_tensor(self, name: str) -> bool:
        return name in self.entries

    def get_shape(self, name: str) -> Tuple[int, ...]:
        """The tensor's shape from its index entry; no data is read."""
        return self.entries[name].shape

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


# -- CRC32-C ---------------------------------------------------------------------

_POLY = 0x82F63B78  # Castagnoli, reflected


def _crc_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, (table >> 1) ^ np.uint32(_POLY),
                         table >> 1).astype(np.uint32)
    return table


_TABLE = _crc_table()
_TABLE_LIST = [int(v) for v in _TABLE]


def _update(reg: int, data) -> int:
    """The CRC register after ``data`` (bytes), from ``reg``, one byte at a
    time."""
    table = _TABLE_LIST
    for b in data:
        reg = table[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def _apply(cols, v: int) -> int:
    """A GF(2)-linear map of 32-bit registers (its images of the 32 unit
    vectors, ``cols``) applied to ``v``."""
    out, k = 0, 0
    while v:
        if v & 1:
            out ^= cols[k]
        v >>= 1
        k += 1
    return out


def _zeros_operator(n: int) -> list:
    """The register map of feeding ``n`` zero bytes, by squaring the one
    byte map."""
    step = [_update(1 << k, b"\0") for k in range(32)]
    result = [1 << k for k in range(32)]  # identity
    while n:
        if n & 1:
            result = [_apply(step, c) for c in result]
        step = [_apply(step, c) for c in step]
        n >>= 1
    return result


def _crc32c_compute(data: bytes) -> int:
    """CRC32-C of ``data``.  Long inputs run as ``L`` equal lanes at once in
    numpy (the table step on a vector of lane registers, each lane from a
    zero register), then fold the lanes in order: the update is linear
    over GF(2), so ``crc(A + B) = Z^len(B)(crc(A)) ^ crc0(B)`` with
    ``Z^n`` the map of ``n`` zero bytes, applied here through four byte
    tables.  The same value as the byte loop, at numpy speed."""
    n = len(data)
    if n < 1 << 16:
        return _update(0xFFFFFFFF, data) ^ 0xFFFFFFFF
    lanes = 1 << min(16, max(8, (n // 512).bit_length() - 1))
    m = n // lanes
    body = np.frombuffer(data, np.uint8, lanes * m).reshape(lanes, m)
    cols = np.ascontiguousarray(body.T)  # [m, lanes]: step j reads row j
    regs = np.zeros(lanes, np.uint32)
    for j in range(m):
        regs = _TABLE[(regs ^ cols[j]) & 0xFF] ^ (regs >> 8)
    op = _zeros_operator(m)
    byte_tables = [[_apply(op, x << (8 * b)) for x in range(256)]
                   for b in range(4)]
    t0, t1, t2, t3 = byte_tables
    reg = 0xFFFFFFFF
    for r in regs.tolist():
        reg = (t0[reg & 0xFF] ^ t1[(reg >> 8) & 0xFF]
               ^ t2[(reg >> 16) & 0xFF] ^ t3[reg >> 24]) ^ r
    return _update(reg, memoryview(data)[lanes * m:]) ^ 0xFFFFFFFF


def _masked_crc32c(data: bytes) -> int:
    """CRC32-C (Castagnoli), masked per the LevelDB/TF convention,
    ``((crc >> 15) | (crc << 17)) + 0xa282ead8``: the table blocks'
    trailers and ``BundleEntryProto.crc32c``."""
    crc = _crc32c_compute(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# -- writer ----------------------------------------------------------------------


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _encode_tag(field: int, wire: int) -> bytes:
    out = bytearray()
    _write_varint(out, (field << 3) | wire)
    return bytes(out)


def _encode_entry_proto(e: BundleEntry) -> bytes:
    """A serialized ``BundleEntryProto``: dtype, shape, shard, offset, size
    and the tensor bytes' masked crc32c."""
    out = bytearray()
    out += _encode_tag(1, 0)
    _write_varint(out, e.dtype)
    # TensorShapeProto { repeated Dim dim = 2 { int64 size = 1 } }
    shape_buf = bytearray()
    for d in e.shape:
        dim_buf = bytearray()
        dim_buf += _encode_tag(1, 0)
        _write_varint(dim_buf, d)
        shape_buf += _encode_tag(2, 2)
        _write_varint(shape_buf, len(dim_buf))
        shape_buf += dim_buf
    out += _encode_tag(2, 2)
    _write_varint(out, len(shape_buf))
    out += shape_buf
    if e.shard_id:
        out += _encode_tag(3, 0)
        _write_varint(out, e.shard_id)
    if e.offset:
        out += _encode_tag(4, 0)
        _write_varint(out, e.offset)
    out += _encode_tag(5, 0)
    _write_varint(out, e.size)
    # fixed32 crc32c = 6: TF's Saver.restore checks it (DataLossError)
    out += _encode_tag(6, 5)
    out += struct.pack("<I", e.crc32c)
    return bytes(out)


def _encode_header_proto(num_shards: int = 1) -> bytes:
    """``BundleHeaderProto``: num_shards, endianness LITTLE (0, the
    default, so not written), version { producer 1 }."""
    out = bytearray()
    out += _encode_tag(1, 0)
    _write_varint(out, num_shards)
    version = bytearray()
    version += _encode_tag(1, 0)
    _write_varint(version, 1)
    out += _encode_tag(3, 2)
    _write_varint(out, len(version))
    out += version
    return bytes(out)


class _TableBuilder:
    """A minimal LevelDB-style table (one data block, no compression, no
    prefix sharing) that TF's table reader accepts."""

    def __init__(self):
        self._blob = bytearray()

    def _emit_block(self, entries) -> Tuple[int, int]:
        """Append a block of (key, value) pairs; returns (offset, size)."""
        block = bytearray()
        restarts = []
        for key, value in entries:
            restarts.append(len(block))  # no prefix compression
            _write_varint(block, 0)  # shared
            _write_varint(block, len(key))
            _write_varint(block, len(value))
            block += key
            block += value
        for r in restarts:
            block += struct.pack("<I", r)
        block += struct.pack("<I", len(restarts))
        offset = len(self._blob)
        contents = bytes(block)
        trailer = bytes([0]) + struct.pack(
            "<I", _masked_crc32c(contents + b"\x00"))
        self._blob += contents + trailer
        return offset, len(contents)

    def build(self, entries) -> bytes:
        """``entries``: sorted (key bytes, value bytes) pairs."""
        data_off, data_size = self._emit_block(entries)
        meta_off, meta_size = self._emit_block([])  # empty metaindex
        data_handle = bytearray()
        _write_varint(data_handle, data_off)
        _write_varint(data_handle, data_size)
        last_key = entries[-1][0] if entries else b""
        index_off, index_size = self._emit_block(
            [(last_key + b"\x00", bytes(data_handle))])
        footer = bytearray()
        _write_varint(footer, meta_off)
        _write_varint(footer, meta_size)
        _write_varint(footer, index_off)
        _write_varint(footer, index_size)
        footer += b"\x00" * (40 - len(footer))
        footer += struct.pack("<Q", _TABLE_MAGIC)
        return bytes(self._blob) + bytes(footer)


# numpy dtype -> TF DataType (bfloat16 tensors are not written here)
_NP_TO_DT = {np.dtype(np.float32): 1, np.dtype(np.float64): 2,
             np.dtype(np.int32): 3, np.dtype(np.int64): 9}


def write_tf1_checkpoint(prefix: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write a ``tf.train.Saver`` tensor bundle: ``<prefix>.index`` and
    ``<prefix>.data-00000-of-00001``, readable by TF1 ``Saver.restore``
    and :class:`TF1Checkpoint` (``unmicst_tpu/core/tf1_ckpt.py:501``)."""
    data = bytearray()
    entries = [(b"", _encode_header_proto())]
    for name, arr in sorted(tensors.items()):
        arr = np.ascontiguousarray(arr)
        dt = _NP_TO_DT.get(arr.dtype)
        if dt is None:
            raise TypeError(f"{name}: unsupported dtype {arr.dtype}")
        e = BundleEntry()
        e.dtype = dt
        e.shape = arr.shape
        e.offset = len(data)
        raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        e.size = len(raw)
        e.crc32c = _masked_crc32c(raw)
        data += raw
        entries.append((name.encode("utf-8"), _encode_entry_proto(e)))
    blob = _TableBuilder().build(entries)
    with open(prefix + ".index", "wb") as f:
        f.write(blob)
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(bytes(data))
