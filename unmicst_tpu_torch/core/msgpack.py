"""msgpack in the standard library: the subset that flax writes.

The JAX package's native checkpoint (``model.unmicst-tpu.msgpack``) is
``flax.serialization.msgpack_serialize`` of a tree of dicts, strings and
numpy arrays.  This module encodes and decodes that format with
``struct`` and numpy, so the port reads and writes it without the
``msgpack`` or ``flax`` packages:

* every msgpack type but timestamps and other ext types: nil, booleans,
  integers, floats, strings, bin, arrays and maps (the packer picks the
  shortest encoding, as ``msgpack.packb`` does, so the bytes are the
  package's);
* flax's ext types: 1, an ndarray (a nested msgpack array ``[shape,
  dtype name, raw bytes]``, C order), and 3, a numpy scalar packed the
  same way;
* flax's chunked arrays: a leaf above 2**30 bytes is written as
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
  of flat pieces, and joined back on read.

:func:`serialize` and :func:`restore` are ``msgpack_serialize`` and
``msgpack_restore``: dict keys are written in sorted order (flax copies
the tree with ``jax.tree_util``, which sorts them).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30  # flax's limit for one array leaf, in bytes
_CHUNKED = "__msgpack_chunked_array__"


# -- packing ------------------------------------------------------------------


def _pack_int(n: int, out: list) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -0x20 <= n < 0:
        out.append(struct.pack("b", n))
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"integer {n} does not fit in 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)),
                               (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if n >= low:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"integer {n} does not fit in 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: list) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit
    (``codes`` lists the codes for the widths the type has)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} is too long for msgpack")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32))


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``[shape, dtype name, raw bytes]``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be packed")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):  # before float: np.float64 is one
        _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, _STR, out)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), None, 0, _BIN, out)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, _ARRAY, out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, _MAP, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_ext(code: int, data: bytes, out: list) -> None:
    if len(data) in _FIXEXT:
        out.append(bytes([_FIXEXT[len(data)]]))
    else:
        _pack_len(len(data), None, 0, _EXT, out)
    out.append(struct.pack("b", code) + data)


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``, with numpy arrays and
    scalars as flax's ext types."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# -- unpacking ----------------------------------------------------------------


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {  # code: struct format of the value that follows
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_LEN = {  # code: (kind, struct format of the length)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}


def _ndarray_from(data) -> np.ndarray:
    shape, name, raw = unpackb(data)
    if isinstance(name, (bytes, bytearray)):
        name = name.decode("ascii")
    return np.frombuffer(raw, np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray_from(data)
    if code == EXT_NPSCALAR:
        return _ndarray_from(data)[()]
    raise ValueError(f"msgpack ext type {code} is not one flax writes")


def _read(r: _Reader):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if 0xD4 <= b <= 0xD8:
        code = r.unpack("b")
        return _ext(code, r.take(1 << (b - 0xD4)))
    if b in _LEN:
        kind, fmt = _LEN[b]
        n = r.unpack(fmt)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return str(r.take(n), "utf-8")
        if kind == "array":
            return [_read(r) for _ in range(n)]
        if kind == "map":
            return _read_map(r, n)
        code = r.unpack("b")
        return _ext(code, r.take(n))
    raise ValueError(f"byte 0x{b:02x} starts no msgpack value")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    return out


def unpackb(data):
    """``msgpack.unpackb(data, raw=False)`` with flax's ext types as numpy
    arrays (ext 1) and numpy scalars (ext 3); other ext types raise."""
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack value")
    return obj


# -- flax's tree format -------------------------------------------------------


def _chunk(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: a flat array in pieces of at most 2**30 bytes."""
    size = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    pieces = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(pieces)}}


def _prepare(tree):
    """The tree as flax writes it: dict keys sorted, big arrays chunked."""
    if isinstance(tree, dict):
        return {k: _prepare(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_prepare(v) for v in tree]
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    return tree


def serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a tree of dicts, lists,
    scalars and numpy arrays."""
    return packb(_prepare(tree))


def restore(data):
    """``flax.serialization.msgpack_restore``."""
    return _unchunk(unpackb(data))
