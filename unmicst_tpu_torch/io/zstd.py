"""Zstandard frames through the host's ``libzstd``, by ctypes.

The port of ``unmicst_tpu/io/zstd.py`` without its first choice, the
``zstandard`` package, which the port's import rule leaves out: the
decoder and the encoder are ``ZSTD_decompress`` and ``ZSTD_compress`` of
``libzstd.so.1`` (or ``libzstd.so``).  Three readers and one writer use
it: zstd TIFF strips and tiles (tag 50000), CZI's "zstd0" and "zstd1"
sub-blocks, and ``TiffWriter(compression="zstd")``.

Without the library every zstd path raises ``NotImplementedError`` naming
ROADMAP M14b and the missing library; nothing carries on without it.

Output is bounded: :func:`decompress` writes into a buffer of ``max_out``
bytes, which the caller takes from the geometry it trusts (strip or
sub-block height x width x item size), and a frame that needs more, by
its declared size or as it streams, is a ``ValueError``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

_LIBS = ("libzstd.so.1", "libzstd.so")
_lock = threading.Lock()
_lib = None
_checked = False


def _library() -> Optional[ctypes.CDLL]:
    global _lib, _checked
    if _checked:
        return _lib
    with _lock:
        if not _checked:
            for name in _LIBS:
                try:
                    lib = ctypes.CDLL(name)
                except OSError:
                    continue
                lib.ZSTD_decompress.restype = ctypes.c_size_t
                lib.ZSTD_decompress.argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t,
                    ctypes.c_char_p, ctypes.c_size_t]
                lib.ZSTD_compressBound.restype = ctypes.c_size_t
                lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
                lib.ZSTD_compress.restype = ctypes.c_size_t
                lib.ZSTD_compress.argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t,
                    ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
                lib.ZSTD_isError.restype = ctypes.c_uint
                lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
                _lib = lib
                break
            _checked = True
    return _lib


def unavailable() -> NotImplementedError:
    """The error every zstd path raises without the library."""
    return NotImplementedError(
        "zstd needs the host's libzstd (libzstd.so.1 or libzstd.so), and "
        "none was found (ROADMAP M14b: zstd through a host libzstd); "
        "install libzstd or convert the slide"
    )


def available() -> bool:
    """True when the host's libzstd loads; it both decodes and encodes."""
    return _library() is not None


def decompress(data: bytes, max_out: int) -> bytes:
    """One zstd frame, at most ``max_out`` bytes of output."""
    lib = _library()
    if lib is None:
        raise unavailable()
    buf = ctypes.create_string_buffer(max(int(max_out), 1))
    n = lib.ZSTD_decompress(buf, int(max_out), bytes(data), len(data))
    if lib.ZSTD_isError(n):
        raise ValueError("corrupt zstd stream (or larger than its "
                         f"{max_out}-byte bound)")
    return buf.raw[:n]


def compress(data: bytes, level: int = 3) -> bytes:
    """One zstd frame of ``data`` at ``level``."""
    lib = _library()
    if lib is None:
        raise unavailable()
    data = bytes(data)
    cap = lib.ZSTD_compressBound(len(data))
    buf = ctypes.create_string_buffer(cap)
    n = lib.ZSTD_compress(buf, cap, data, len(data), int(level))
    if lib.ZSTD_isError(n):
        raise ValueError("zstd compression failed")
    return buf.raw[:n]


def unpack_hilo(buf: bytes, itemsize: int) -> bytes:
    """Undo CZI's hi-lo byte packing of 16-bit samples: all low bytes,
    then all high bytes (libCZI's ``LoHiBytePack``, bit 0 of a zstd1
    header's chunk-1 flags).  Other item sizes pass through, as in
    libCZI."""
    if itemsize != 2 or len(buf) < 2:
        return buf
    half = len(buf) // 2
    arr = np.frombuffer(buf, np.uint8, count=2 * half)
    out = np.empty((half, 2), np.uint8)
    out[:, 0] = arr[:half]
    out[:, 1] = arr[half:]
    return out.tobytes()
