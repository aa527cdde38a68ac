"""ctypes binding to the port's native host codec library.

The counterpart of ``unmicst_tpu/io/_native.py`` over the port's own copy
of the C++ source, ``unmicst_tpu_torch/native/tiffcodec.cpp``: LZW and
PackBits decode (with and without the overrun flag), inflate, predictor-2
and floating-point predictor (3) undo, one-call strip decode, the
greedy and chain deflate encoders, and the CCITT bilevel decode (TIFF
compressions 2-4; ``io/ccitt.py`` is its plain version);
and, in the same library, the entropy decode of a JPEG scan
(``native/jpegdec.cpp``, for ``io/jpeg.py``), the PNG row filters' undo
(``native/pngfilter.cpp``, for ``io/png.py``), GIF's LZW and the JPEG
Huffman encode (``native/gifcodec.cpp``, ``native/jpegenc.cpp``) and the
PCX, TGA, SGI, PSD (PackBits) and Sun raster run-length codings
(``native/rlecodec.cpp``, for ``io/pcx.py``, ``io/tga.py``, ``io/sgi.py``,
``io/psd.py``, ``io/sun.py``), the QOI coding
(``native/qoicodec.cpp``, for ``io/qoi.py``), Pillow's quantizers
(``native/quant.cpp``, for ``io/quant.py``), JPEG 2000's tier 1 and
inverse wavelets (``native/j2kdec.cpp``, for ``io/jpeg2000.py``), the
BCn texture blocks (``native/bcndec.cpp``, for ``io/bcn.py``) and the FLI
frame chunks (``native/flidec.cpp``, for ``io/fli.py``).  Every
codec function returns None when the library is absent, and the callers
then take their pure-Python versions: correct, only slow.  The
quantizers raise instead: their plain versions are for the tests.

The library builds at first use with the host's ``g++ -O3 -shared -fPIC
-ffp-contract=off`` (portable flags, no ``-march=native``: a build
directory copied to an older CPU must not trap on an instruction) into
``build/torch_host/<hash>/`` at the repository root, the hash covering
the source and the flags.  The compiler writes a per-process temporary
name that ``os.replace`` puts in place, so processes building at the same
time never interleave their writes.  ``UNMICST_NO_AUTOBUILD`` set to
anything but ``""`` or ``"0"`` turns the build off.  Where there is no
compiler, or the build fails, one line on stderr says so.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(os.path.join(_PKG, "native", name)
                for name in ("tiffcodec.cpp", "jpegdec.cpp", "pngfilter.cpp",
                             "gifcodec.cpp", "jpegenc.cpp", "rlecodec.cpp",
                             "quant.cpp", "qoicodec.cpp", "j2kdec.cpp",
                             "bcndec.cpp", "flidec.cpp", "resample.cpp"))
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_host")
# no FMA contraction: the 9/7 wavelet is openjpeg's float32 arithmetic op
# for op, and BC6H's scaling Pillow's, on every host
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")
LIB_NAME = "libunmicst_tiffcodec.so"

_lock = threading.Lock()
_lib = None
_build_attempted = False
_load_failed = False


def _autobuild_disabled() -> bool:
    # value-sensitive: UNMICST_NO_AUTOBUILD=0 means "autobuild enabled"
    return os.environ.get("UNMICST_NO_AUTOBUILD", "") not in ("", "0")


def lib_path() -> str:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for source in SOURCES:
        with open(source, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], LIB_NAME)


def _note(msg: str) -> None:
    print(f"unmicst_tpu_torch: {msg}; using the pure-Python codecs "
          "(slow LZW and JPEG)", file=sys.stderr)


def _try_build(path: str) -> None:
    """Compile the library to ``path``, once per process."""
    global _build_attempted
    if _build_attempted or _autobuild_disabled():
        return
    _build_attempted = True
    cxx = shutil.which("g++")
    if cxx is None:
        _note("no g++ to build the native TIFF codec")
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *SOURCES], check=True,
                       timeout=300, stdout=subprocess.DEVNULL,
                       stderr=subprocess.PIPE)
        os.replace(tmp, path)
    except (OSError, subprocess.SubprocessError):
        _note(f"building {' '.join(SOURCES)} with g++ failed")
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    for name in ("unmicst_lzw_decode", "unmicst_packbits_decode",
                 "unmicst_inflate", "unmicst_deflate"):
        fn = getattr(lib, name)
        fn.restype = ll
        fn.argtypes = [ctypes.c_char_p, ll, vp, ll]
    for name in ("unmicst_lzw_decode_ex", "unmicst_packbits_decode_ex"):
        fn = getattr(lib, name)
        fn.restype = ll
        fn.argtypes = [ctypes.c_char_p, ll, vp, ll,
                       ctypes.POINTER(ctypes.c_int)]  # overrun out-flag
    for name in ("unmicst_predictor_undo", "unmicst_fp_predictor_undo"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [vp, ll, ll, ctypes.c_int]  # data, rows, cols, bytes
    fn = lib.unmicst_deflate_chain
    fn.restype = ll
    # src, src_len, dst, dst_cap, max_chain, nice_len, good_len, max_lazy
    fn.argtypes = [ctypes.c_char_p, ll, vp, ll, ll, ll, ll, ll]
    fn = lib.unmicst_decode_strips
    fn.restype = ll
    # span, src offsets, src lengths, dst offsets, dst lengths (int64[n]),
    # n, codec (TIFF tag value), dst, dst_cap
    fn.argtypes = [ctypes.c_char_p, vp, vp, vp, vp, ll, ll, vp, ll]
    fn = lib.unmicst_ccitt_decode
    fn.restype = ll
    # src, len, dst, width, rows, compression, T4Options, err row
    fn.argtypes = [ctypes.c_char_p, ll, vp, ll, ll, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ll)]
    fn = lib.unmicst_g4_encode
    fn.restype = ll
    fn.argtypes = [vp, ll, ll, vp, ll]  # rows, width, row count, dst, cap
    fn = lib.unmicst_png_unfilter
    fn.restype = ll
    fn.argtypes = [vp, ll, ll, ll, vp]  # src, rows, stride, bpp, dst
    fn = lib.unmicst_jpeg_scan
    fn.restype = ll
    # src, len, pos, coef, order, slots, nblocks, blocks per MCU, dc bits,
    # dc values, ac bits, ac values (4 tables each), dc mask, ac mask, ss,
    # se, ah, al, progressive, restart interval (MCUs)
    it = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ll, ll, vp, vp, vp, ll, ll,
                   ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                   ctypes.c_char_p, it, it, it, it, it, it, it, ll]
    fn = lib.unmicst_jpeg_arith_scan
    fn.restype = ll
    # src, len, pos, limit, coef, order, slots, nblocks, blocks per MCU,
    # each slot's DC and AC conditioning table, L, U and Kx (4 bytes
    # each), ss, se, ah, al, progressive, restart interval (MCUs)
    cp = ctypes.c_char_p
    fn.argtypes = [cp, ll, ll, ll, vp, vp, vp, ll, ll, cp, cp, cp, cp, cp,
                   it, it, it, it, it, ll]
    fn = lib.unmicst_jpeg_lossless_scan
    fn.restype = ll
    # src, len, pos, diffs, scan components, h, w, dc bits, dc values,
    # dc mask, restart interval (MCUs)
    fn.argtypes = [ctypes.c_char_p, ll, ll, vp, it, ll, ll, ctypes.c_char_p,
                   ctypes.c_char_p, it, ll]
    fn = lib.unmicst_jpeg_undifference
    fn.restype = None
    # diff, out, h, w, predictor, point transform, restart rows
    fn.argtypes = [vp, vp, ll, ll, it, it, ll]
    fn = lib.unmicst_gif_lzw_decode
    fn.restype = ll
    # file, len, first sub-block, bits, out, stride, xsize, ysize,
    # interlace, transparency, read chunk
    fn.argtypes = [ctypes.c_char_p, ll, ll, it, vp, ll, ll, ll, it, it, ll]
    fn = lib.unmicst_gif_lzw_encode
    fn.restype = ll
    fn.argtypes = [ctypes.c_char_p, ll, it, vp, ll]  # src, n, bits, dst, cap
    fn = lib.unmicst_jpeg_huff_encode
    fn.restype = ll
    # coef, slots, n, dc codes, dc sizes, ac codes, ac sizes, slots, dst, cap
    fn.argtypes = [vp, vp, ll, vp, vp, vp, vp, it, vp, ll]
    fn = lib.unmicst_pcx_rle_decode
    fn.restype = ll
    fn.argtypes = [ctypes.c_char_p, ll, ll, vp, ll, ll]  # src, len, pos,
    # out, rows, row bytes
    fn = lib.unmicst_tga_rle_decode
    fn.restype = ll
    fn.argtypes = [ctypes.c_char_p, ll, ll, vp, ll, ll, it]  # ..., depth
    fn = lib.unmicst_sgi_rle_decode
    fn.restype = ll
    # file, len, out, ysize, zsize, xsize, bytes a sample
    fn.argtypes = [ctypes.c_char_p, ll, vp, ll, ll, ll, it]
    for name in ("unmicst_packbits_rows", "unmicst_sun_rle_rows"):
        fn = getattr(lib, name)
        fn.restype = ll
        # src, len, pos, out, rows, row bytes, state[2]
        fn.argtypes = [ctypes.c_char_p, ll, ll, vp, ll, ll, vp]
    fn = lib.unmicst_pcx_rle_encode
    fn.restype = ll
    fn.argtypes = [vp, ll, ll, it, vp, ll]  # rows, h, row bytes, planes,
    # dst, cap
    fn = lib.unmicst_qoi_encode
    fn.restype = ll
    fn.argtypes = [vp, ll, it, vp, ll]  # pixels, n, bands, dst, cap
    fn = lib.unmicst_qoi_decode
    fn.restype = ll
    fn.argtypes = [ctypes.c_char_p, ll, ll, vp, ll, it]  # src, len, pos,
    # out, n, bands
    fn = lib.unmicst_quant_median_cut
    fn.restype = ll
    fn.argtypes = [vp, ll, it, vp, vp]  # pixels, n, colours, idx, palette
    fn = lib.unmicst_quant_octree
    fn.restype = ll
    fn.argtypes = [vp, ll, it, it, vp, vp]  # ..., with alpha, idx, palette
    fn = lib.unmicst_j2k_t1
    fn.restype = ll
    fn.argtypes = [ctypes.c_char_p, vp, ll, vp, vp]  # data, blocks, n,
    # segments, out
    for name in ("unmicst_j2k_idwt53", "unmicst_j2k_idwt97"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [vp, ll, vp, ll]  # plane, row stride, bounds, levels+1
    fn = lib.unmicst_bcn_decode
    fn.restype = ll
    fn.argtypes = [vp, ll, it, it, vp]  # blocks, n, decoder, signed, out
    fn = lib.unmicst_fli_decode
    fn.restype = ll
    fn.argtypes = [ctypes.c_char_p, ll, vp, ll, ll]  # frame, bytes, image,
    # ysize, xsize
    fn = lib.unmicst_resample_pass
    fn.restype = ll
    # src, w, c, kind, axis, xmin, xmax, taps, ksize, out, offset, rows, dst
    fn.argtypes = [vp, ll, ll, it, it, vp, vp, vp, ll, ll, ll, ll, vp]
    fn = lib.unmicst_alpha_multiply
    fn.restype = None
    fn.argtypes = [vp, ll, ll, it]  # pixels (in place), count, channels,
    # inverse
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None when there is none."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = lib_path()
        if not os.path.exists(path):
            _try_build(path)
        if not os.path.exists(path):
            return None
        try:
            _lib = _load(path)
        except (OSError, AttributeError):
            # a truncated or stale artifact: rebuild once if allowed, else
            # fall back for good (a bad library must degrade to the Python
            # codecs, never crash every TIFF decode)
            if not _build_attempted and not _autobuild_disabled():
                try:
                    os.remove(path)
                except OSError:
                    pass
                _try_build(path)
                try:
                    _lib = _load(path)
                except (OSError, AttributeError):
                    _load_failed = True
            else:
                _load_failed = True
        return _lib


def _ptr(buf: np.ndarray) -> ctypes.c_void_p:
    return buf.ctypes.data_as(ctypes.c_void_p)


def lzw_decode(data: bytes, max_out: int) -> Optional[np.ndarray]:
    """TIFF LZW into at most ``max_out`` bytes: a uint8 view of the
    decoded bytes (no zeroing, no copy of the whole strip), or None
    without the library.  A corrupt stream raises ``ValueError``."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.empty(max_out, np.uint8)
    n = lib.unmicst_lzw_decode(data, len(data), _ptr(buf), max_out)
    if n < 0:
        raise ValueError("native LZW: corrupt stream or undersized buffer")
    return buf[:n]


def inflate(data: bytes, max_out: int) -> Optional[np.ndarray]:
    """zlib-stream (RFC 1950) decode into at most ``max_out`` bytes,
    adler32-verified as zlib does; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.empty(max_out, np.uint8)
    n = lib.unmicst_inflate(data, len(data), _ptr(buf), max_out)
    if n < 0:
        raise ValueError("native inflate: corrupt stream or undersized buffer")
    return buf[:n]


def deflate(data: bytes) -> Optional[bytes]:
    """zlib-stream compress with the greedy single-probe encoder and
    per-block dynamic Huffman (the writer's levels 1-3); None without
    the library (callers use zlib)."""
    lib = get_lib()
    if lib is None:
        return None
    cap = len(data) + (len(data) >> 6) + 1024
    buf = np.empty(cap, np.uint8)
    n = lib.unmicst_deflate(data, len(data), _ptr(buf), cap)
    if n < 0:
        raise ValueError("native deflate: output buffer undersized")
    return buf[:n].tobytes()


# zlib's deflate_slow configuration_table rows (good, lazy, nice, chain)
# for levels 4..9: the speed/ratio trade each level names
_CHAIN_PARAMS = {
    4: (4, 4, 16, 16),
    5: (8, 16, 32, 32),
    6: (8, 16, 128, 128),
    7: (8, 32, 128, 256),
    8: (32, 128, 258, 1024),
    9: (32, 258, 258, 4096),
}


def deflate_chain(data: bytes, level: int) -> Optional[bytes]:
    """zlib-stream compress with hash-chain and lazy matching at zlib's
    good/lazy/nice/chain parameters for ``level`` (clamped to 4..9); None
    without the library (callers use zlib)."""
    lib = get_lib()
    if lib is None:
        return None
    good, lazy, nice, chain = _CHAIN_PARAMS[max(4, min(9, level))]
    cap = len(data) + (len(data) >> 6) + 1024
    buf = np.empty(cap, np.uint8)
    n = lib.unmicst_deflate_chain(data, len(data), _ptr(buf), cap,
                                  chain, nice, good, lazy)
    if n < 0:
        raise ValueError("native deflate: output buffer undersized")
    return buf[:n].tobytes()


def decode_strips(span: bytes, src_offs: np.ndarray, src_lens: np.ndarray,
                  dst_offs: np.ndarray, dst_lens: np.ndarray, codec: int,
                  out: np.ndarray) -> Optional[bool]:
    """Decode every segment of a page in one native call, straight into
    the C-contiguous ``out`` (viewed as bytes).  ``codec`` is the TIFF
    compression tag value (8 deflate, 5 LZW, 32773 PackBits); offsets are
    within ``span`` and ``out``; each segment must decode to exactly its
    ``dst_lens`` entry.  None without the library; a bad segment raises
    ``ValueError`` naming the first one."""
    lib = get_lib()
    if lib is None:
        return None
    arrs = [np.ascontiguousarray(a, np.int64)
            for a in (src_offs, src_lens, dst_offs, dst_lens)]
    rc = lib.unmicst_decode_strips(span, *(_ptr(a) for a in arrs),
                                   len(src_offs), codec, _ptr(out),
                                   out.nbytes)
    if rc < 0:
        raise ValueError(
            f"native strip decode: strip {-rc - 1} corrupt or wrong length")
    return True


def packbits_decode(data: bytes, max_out: int) -> Optional[np.ndarray]:
    """PackBits into at most ``max_out`` bytes; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.empty(max_out, np.uint8)
    n = lib.unmicst_packbits_decode(data, len(data), _ptr(buf), max_out)
    if n < 0:
        raise ValueError("native PackBits: corrupt stream")
    return buf[:n]


def _decode_ex(fn, data: bytes, max_out: int, what: str):
    buf = np.empty(max_out, np.uint8)
    overrun = ctypes.c_int(0)
    n = fn(data, len(data), _ptr(buf), max_out, ctypes.byref(overrun))
    if n < 0:
        raise ValueError(f"native {what}")
    return buf[:n], bool(overrun.value)


def lzw_decode_ex(data: bytes, max_out: int):
    """:func:`lzw_decode` and an overrun flag: ``(array, overrun)``, where
    ``overrun`` is True when ``max_out`` was reached while the stream
    encoded more (mid-chain truncation, or an exact fill followed by a
    data code other than EOI; trailing EOI, zero bits or byte padding
    leave it False).  None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    return _decode_ex(lib.unmicst_lzw_decode_ex, data, max_out,
                      "LZW: corrupt stream or undersized buffer")


def packbits_decode_ex(data: bytes, max_out: int):
    """:func:`packbits_decode` with the overrun flag of
    :func:`lzw_decode_ex` (trailing 0x80 no-op padding leaves it False)."""
    lib = get_lib()
    if lib is None:
        return None
    return _decode_ex(lib.unmicst_packbits_decode_ex, data, max_out,
                      "PackBits: corrupt stream")


def predictor_undo(arr: np.ndarray) -> Optional[np.ndarray]:
    """Undo horizontal differencing in place on a C-contiguous
    ``(rows, cols)`` uint8/uint16 array; returns it, or None without the
    library or for wider samples (the C function takes 1- and 2-byte
    samples only, and handing back difference values as pixels would be
    silent corruption)."""
    if arr.dtype.itemsize not in (1, 2):
        return None
    if not arr.flags["C_CONTIGUOUS"]:
        raise ValueError("predictor_undo needs a C-contiguous array")
    lib = get_lib()
    if lib is None:
        return None
    lib.unmicst_predictor_undo(_ptr(arr), arr.shape[0],
                               int(np.prod(arr.shape[1:])),
                               arr.dtype.itemsize)
    return arr


def fp_predictor_undo(rows: np.ndarray, itemsize: int) -> Optional[np.ndarray]:
    """Undo the floating-point predictor (TIFF predictor 3) in place on the
    C-contiguous uint8 ``[n, cols * itemsize]`` ``rows``, leaving each row
    ``cols`` native-order samples; returns it, or None without the
    library."""
    if rows.dtype != np.uint8 or rows.ndim != 2 or itemsize < 1 \
            or rows.shape[1] % itemsize or not rows.flags["C_CONTIGUOUS"]:
        raise ValueError("fp_predictor_undo needs a C-contiguous uint8 "
                         "[rows, cols * itemsize] array")
    lib = get_lib()
    if lib is None:
        return None
    lib.unmicst_fp_predictor_undo(_ptr(rows), rows.shape[0],
                                  rows.shape[1] // itemsize, itemsize)
    return rows


_CCITT_ERRORS = {
    -1: "data ends early",
    -2: "no code",
    -3: "runs that do not add up to the row's width",
    -4: "a vertical mode outside the row",
    -5: "bad arguments",
}


def ccitt_decode(data: bytes, width: int, rows: int, compression: int,
                 options: int = 0) -> Optional[np.ndarray]:
    """``rows`` rows of ``width`` pixels from one CCITT-coded strip or
    tile (TIFF compression 2, 3 or 4, ``options`` the page's T4Options,
    the bytes in FillOrder 1): ``[rows, ceil(width / 8)]`` uint8,
    packed MSB first, 1 = black, as :func:`io.ccitt.decode` returns; None
    without the library.  Data that does not decode raises
    ``ValueError`` naming the row."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((rows, (width + 7) // 8), np.uint8)
    err_row = ctypes.c_longlong(0)
    rc = lib.unmicst_ccitt_decode(data, len(data), _ptr(out), width, rows,
                                  compression, options,
                                  ctypes.byref(err_row))
    if rc < 0:
        raise ValueError(f"CCITT row {err_row.value}: "
                         f"{_CCITT_ERRORS.get(rc, f'error {rc}')}")
    return out


def g4_encode(rows: np.ndarray, width: int) -> Optional[bytes]:
    """One Group 4 strip of ``rows`` (``[n, ceil(width / 8)]`` uint8,
    packed MSB first, a set bit black), as :func:`io.ccitt.encode_g4`
    returns it; None without the library."""
    if rows.dtype != np.uint8 or rows.ndim != 2 or width <= 0 or \
            rows.shape[1] != (width + 7) // 8:
        raise ValueError("g4_encode: [n, ceil(width / 8)] uint8")
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows)
    cap = len(rows) * (width + 7) * 2 + 16  # 16 bits a pixel: past G4's worst
    while True:
        dst = np.empty(cap, np.uint8)
        n = lib.unmicst_g4_encode(_ptr(rows), width, len(rows), _ptr(dst),
                                  cap)
        if n >= 0:
            return dst[:n].tobytes()
        if n != -1:
            raise ValueError(f"g4_encode: error {n}")
        cap *= 2


_JPEG_ERRORS = {
    -1: "entropy-coded data ends early",
    -2: "corrupt Huffman code",
    -3: "restart marker missing, out of order or stray",
    -4: "Huffman table missing",
    -5: "truncated stream (no marker after a scan)",
    -6: "arithmetic-coded scan needs data past the 65536-byte read of the "
        "stream that holds its SOS header: libjpeg's arithmetic decoder "
        "cannot wait for the next read, and PIL raises 'broken data stream'",
}


def _huff_tables(ts):
    """Up to four Huffman tables (``io/jpeg.py`` ``HuffTable`` or None) as
    the native decoders take them: BITS, HUFFVAL and a mask of slots."""
    bits, vals, mask = bytearray(64), bytearray(1024), 0
    for k, t in enumerate(ts):
        if t is not None:
            bits[16 * k : 16 * k + 16] = t.bits
            vals[256 * k : 256 * k + len(t.values)] = t.values
            mask |= 1 << k
    return bytes(bits), bytes(vals), mask


def jpeg_scan(data: bytes, scan, progressive: bool, coef: np.ndarray,
              order: np.ndarray, slots: np.ndarray,
              per_mcu: int) -> Optional[int]:
    """Entropy-decode one scan of ``io/jpeg.py`` (a ``Scan``) into the
    C-contiguous int16 ``[blocks, 64]`` ``coef``, in place: the scan's
    blocks are the rows ``order`` (int64) of ``coef``, each of the scan
    component ``slots`` (uint8), ``per_mcu`` to an MCU.  Returns the
    offset of the marker after the scan, or None without the library.  A
    corrupt or truncated scan raises ``ValueError``."""
    if coef.dtype != np.int16 or coef.ndim != 2 or coef.shape[1] != 64 \
            or not coef.flags["C_CONTIGUOUS"]:
        raise ValueError("jpeg_scan needs a C-contiguous int16 [n, 64] array")
    order = np.ascontiguousarray(order, np.int64)
    slots = np.ascontiguousarray(slots, np.uint8)
    if len(order) != len(slots) or (len(order) and (
            order.min() < 0 or order.max() >= coef.shape[0])):
        raise ValueError("jpeg_scan: block order outside the coefficients")
    if not 0 <= scan.pos <= len(data):
        raise ValueError("jpeg_scan: scan offset outside the stream")
    lib = get_lib()
    if lib is None:
        return None

    dc_bits, dc_vals, dc_mask = _huff_tables(scan.dc)
    ac_bits, ac_vals, ac_mask = _huff_tables(scan.ac)
    rc = lib.unmicst_jpeg_scan(
        data, len(data), scan.pos, _ptr(coef), _ptr(order), _ptr(slots),
        len(order), per_mcu, dc_bits, dc_vals, ac_bits, ac_vals, dc_mask,
        ac_mask, scan.ss, scan.se, scan.ah, scan.al, int(progressive),
        scan.restart_interval)
    if rc < 0:
        raise ValueError(f"JPEG {_JPEG_ERRORS.get(rc, f'error {rc}')}")
    return rc


def jpeg_arith_scan(data: bytes, scan, progressive: bool, coef: np.ndarray,
                    order: np.ndarray, slots: np.ndarray, per_mcu: int,
                    limit: int) -> Optional[int]:
    """Decode one arithmetic-coded scan of ``io/jpeg.py`` (a ``Scan``
    with its ``cond``) into ``coef`` as ``jpeg_scan`` does, reading no
    byte at or past ``limit``; as its ``arith_scan_py``.  Returns the
    offset of the marker after the scan, or None without the library.  A
    scan that needs a byte past ``limit`` raises ``ValueError``."""
    if coef.dtype != np.int16 or coef.ndim != 2 or coef.shape[1] != 64 \
            or not coef.flags["C_CONTIGUOUS"]:
        raise ValueError("jpeg_arith_scan needs a C-contiguous int16 [n, 64] "
                         "array")
    order = np.ascontiguousarray(order, np.int64)
    slots = np.ascontiguousarray(slots, np.uint8)
    if len(order) != len(slots) or (len(order) and (
            order.min() < 0 or order.max() >= coef.shape[0])) \
            or per_mcu < 1 or len(scan.cond) > 4:
        raise ValueError("jpeg_arith_scan: block order outside the "
                         "coefficients")
    if not 0 <= scan.pos <= len(data):
        raise ValueError("jpeg_arith_scan: scan offset outside the stream")
    lib = get_lib()
    if lib is None:
        return None
    cond = list(scan.cond) + [scan.cond[0]] * (4 - len(scan.cond))
    dc, ac, lows, ups, kxs = (bytes(x[k] for x in cond) for k in range(5))
    rc = lib.unmicst_jpeg_arith_scan(
        data, len(data), scan.pos, limit, _ptr(coef), _ptr(order),
        _ptr(slots), len(order), per_mcu, dc, ac, lows, ups, kxs, scan.ss,
        scan.se, scan.ah, scan.al, int(progressive), scan.restart_interval)
    if rc < 0:
        raise ValueError(f"JPEG {_JPEG_ERRORS.get(rc, f'error {rc}')}")
    return rc


def png_unfilter(rows: np.ndarray, bpp: int) -> Optional[np.ndarray]:
    """Undo the PNG row filters of the C-contiguous uint8 ``[h, 1 +
    stride]`` ``rows`` (a filter-type byte before each row): ``[h,
    stride]`` uint8, or None without the library.  A filter type other
    than 0-4 raises ``ValueError``."""
    if rows.dtype != np.uint8 or rows.ndim != 2 or rows.shape[1] < 1 \
            or not rows.flags["C_CONTIGUOUS"]:
        raise ValueError("png_unfilter needs a C-contiguous uint8 [h, 1 + "
                         "stride] array")
    lib = get_lib()
    if lib is None:
        return None
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    rc = lib.unmicst_png_unfilter(_ptr(rows), h, stride, bpp, _ptr(out))
    if rc:
        raise ValueError(f"corrupt PNG: row filter type {rows[rc - 1, 0]}")
    return out


def gif_lzw_decode(data: bytes, offset: int, bits: int, out: np.ndarray,
                   interlace: bool, transparency: int,
                   chunk: int) -> Optional[int]:
    """Decode one GIF frame whose sub-blocks start at ``data[offset]``
    into ``out`` (``[ysize, xsize]`` uint8 with unit column stride, a view
    of the screen), as ``io/gif.py``'s ``lzw_decode_py``: 0 once its last
    pixel is written, else a negative error code; None without the
    library."""
    if out.dtype != np.uint8 or out.ndim != 2 or out.strides[1] != 1 \
            or 0 in out.shape:
        raise ValueError("gif_lzw_decode needs a 2-D uint8 view with unit "
                         "column stride")
    if not 0 <= offset <= len(data):
        raise ValueError("gif_lzw_decode: offset outside the file")
    lib = get_lib()
    if lib is None:
        return None
    return lib.unmicst_gif_lzw_decode(
        data, len(data), offset, bits, out.ctypes.data_as(ctypes.c_void_p),
        out.strides[0], out.shape[1], out.shape[0], int(interlace),
        transparency, chunk)


def gif_lzw_encode(pixels: bytes, bits: int) -> Optional[bytes]:
    """Pillow's GIF LZW code stream for ``pixels`` (``io/gif.py``'s
    ``lzw_encode_py``); None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    # codes of at most 12 bits for at least one byte each, plus clears
    cap = 2 * len(pixels) + 64
    buf = np.empty(cap, np.uint8)
    n = lib.unmicst_gif_lzw_encode(pixels, len(pixels), bits, _ptr(buf), cap)
    if n < 0:
        raise ValueError("native GIF encode: output buffer undersized")
    return buf[:n].tobytes()


def jpeg_huff_encode(coef: np.ndarray, slots: np.ndarray, dc_tables,
                     ac_tables) -> Optional[bytes]:
    """Huffman-code a baseline scan (``io/jpegenc.py``'s
    ``encode_blocks_py``): ``coef`` C-contiguous int16 ``[n, 64]`` in
    natural order and scan order, ``slots`` the scan component of each
    block, ``dc_tables`` / ``ac_tables`` a (codes, sizes) pair of 256
    entries per component; None without the library."""
    if coef.dtype != np.int16 or coef.ndim != 2 or coef.shape[1] != 64 \
            or not coef.flags["C_CONTIGUOUS"] or len(slots) != len(coef):
        raise ValueError("jpeg_huff_encode needs C-contiguous int16 [n, 64] "
                         "blocks and one slot each")
    lib = get_lib()
    if lib is None:
        return None
    slots = np.ascontiguousarray(slots, np.uint8)
    tabs = [np.ascontiguousarray(np.stack([t[k] for t in ts]), np.int32)
            for ts in (dc_tables, ac_tables) for k in (0, 1)]
    cap = coef.shape[0] * 64 * 8 + 64
    buf = np.empty(cap, np.uint8)
    n = lib.unmicst_jpeg_huff_encode(_ptr(coef), _ptr(slots), len(coef),
                                     *(_ptr(t) for t in tabs), len(dc_tables),
                                     _ptr(buf), cap)
    if n < 0:
        raise ValueError("native JPEG Huffman encode: a slot without tables "
                         "or an undersized buffer")
    return buf[:n].tobytes()


def jpeg_lossless_scan(data: bytes, scan, diffs: np.ndarray) -> Optional[int]:
    """Entropy-decode one lossless scan of ``io/jpeg.py`` into the
    C-contiguous int32 ``[scan components, h, w]`` ``diffs``, as its
    ``lossless_scan_py``; returns the offset of the marker after the scan,
    or None without the library.  A corrupt or truncated scan raises
    ``ValueError``."""
    if diffs.dtype != np.int32 or diffs.ndim != 3 \
            or not diffs.flags["C_CONTIGUOUS"] \
            or diffs.shape[0] != len(scan.comps):
        raise ValueError("jpeg_lossless_scan needs a C-contiguous int32 "
                         "[components, h, w] array")
    if not 0 <= scan.pos <= len(data):
        raise ValueError("jpeg_lossless_scan: scan offset outside the stream")
    lib = get_lib()
    if lib is None:
        return None
    bits, vals, mask = _huff_tables(scan.dc)
    rc = lib.unmicst_jpeg_lossless_scan(
        data, len(data), scan.pos, _ptr(diffs), diffs.shape[0],
        diffs.shape[1], diffs.shape[2], bits, vals, mask,
        scan.restart_interval)
    if rc < 0:
        raise ValueError(f"JPEG {_JPEG_ERRORS.get(rc, f'error {rc}')}")
    return rc


def jpeg_undifference(diff: np.ndarray, predictor: int, pt: int,
                      restart_rows: int) -> Optional[np.ndarray]:
    """One lossless component's samples from its ``[h, w]`` differences,
    as ``io/jpeg.py``'s ``undifference_py``: ``[h, w]`` uint8, or None
    without the library."""
    if not 1 <= predictor <= 7 or not 0 <= pt <= 7 or diff.ndim != 2:
        raise ValueError("jpeg_undifference: predictor 1-7, pt 0-7, [h, w]")
    lib = get_lib()
    if lib is None:
        return None
    diff = np.ascontiguousarray(diff, np.int32)
    out = np.empty(diff.shape, np.uint8)
    lib.unmicst_jpeg_undifference(_ptr(diff), _ptr(out), diff.shape[0],
                                  diff.shape[1], predictor, pt, restart_rows)
    return out


def _rows_view(out: np.ndarray, name: str) -> None:
    if out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"] \
            or 0 in out.shape:
        raise ValueError(f"{name} needs a C-contiguous uint8 array")


def pcx_rle_decode(data: bytes, pos: int, out: np.ndarray) -> Optional[int]:
    """PCX's RLE from ``data[pos]`` into ``out`` (``[rows, row_bytes]``),
    as ``io/pcx.py``'s ``rle_decode_py``: its result code, or None without
    the library."""
    _rows_view(out, "pcx_rle_decode")
    if out.ndim != 2 or pos < 0:
        raise ValueError("pcx_rle_decode: [rows, row_bytes] and an offset "
                         "of 0 or more")
    lib = get_lib()
    if lib is None:
        return None
    return lib.unmicst_pcx_rle_decode(data, len(data), pos, _ptr(out),
                                      out.shape[0], out.shape[1])


def tga_rle_decode(data: bytes, pos: int, out: np.ndarray,
                   depth: int) -> Optional[int]:
    """TGA's RLE from ``data[pos]`` into ``out`` (``[rows, row_bytes]``),
    ``depth`` bytes a pixel, as ``io/tga.py``'s ``rle_decode_py``: its
    result code, or None without the library."""
    _rows_view(out, "tga_rle_decode")
    if out.ndim != 2 or pos < 0 or not 0 <= depth <= 4:
        raise ValueError("tga_rle_decode: [rows, row_bytes], an offset of 0 "
                         "or more and 0-4 bytes a pixel")
    lib = get_lib()
    if lib is None:
        return None
    return lib.unmicst_tga_rle_decode(data, len(data), pos, _ptr(out),
                                      out.shape[0], out.shape[1], depth)


def sgi_rle_decode(data: bytes, out: np.ndarray, bpc: int) -> Optional[int]:
    """SGI's RLE over the file ``data`` into ``out`` (``[ysize, zsize,
    xsize * bpc]``), as ``io/sgi.py``'s ``rle_decode_py``: its result
    code, or None without the library."""
    _rows_view(out, "sgi_rle_decode")
    if out.ndim != 3 or bpc not in (1, 2) or out.shape[2] % bpc:
        raise ValueError("sgi_rle_decode: [ysize, zsize, xsize * bpc] and 1 "
                         "or 2 bytes a sample")
    lib = get_lib()
    if lib is None:
        return None
    return lib.unmicst_sgi_rle_decode(data, len(data), _ptr(out),
                                      out.shape[0], out.shape[1],
                                      out.shape[2] // bpc, bpc)


def _rows_state(fn_name: str, data: bytes, pos: int, out: np.ndarray):
    _rows_view(out, fn_name)
    if out.ndim != 2 or pos < 0:
        raise ValueError(f"{fn_name}: [rows, row_bytes] and an offset of 0 "
                         "or more")
    lib = get_lib()
    if lib is None:
        return None
    state = np.zeros(2, np.int64)
    rc = getattr(lib, f"unmicst_{fn_name}")(data, len(data), pos, _ptr(out),
                                           out.shape[0], out.shape[1],
                                           _ptr(state))
    return int(rc), int(state[0]), int(state[1])


def packbits_rows(data: bytes, pos: int, out: np.ndarray):
    """PSD's PackBits from ``data[pos]`` into ``out`` (``[rows,
    row_bytes]``), as ``io/psd.py``'s ``packbits_rows_py``: ``(code, rows
    stored, position of the first byte not consumed)``, or None without
    the library."""
    return _rows_state("packbits_rows", data, pos, out)


def sun_rle_rows(data: bytes, pos: int, out: np.ndarray):
    """Sun raster's RLE from ``data[pos]`` into ``out`` (``[rows,
    row_bytes]``), as ``io/sun.py``'s ``rle_decode_py``: ``(code,
    position of the first byte not consumed)``, or None without the
    library."""
    got = _rows_state("sun_rle_rows", data, pos, out)
    return None if got is None else (got[0], got[2])


def pcx_rle_encode(rows: np.ndarray, planes: int) -> Optional[bytes]:
    """PCX's RLE of ``rows`` (``[h, planes * plane_bytes]``), as
    ``io/pcx.py``'s ``rle_encode_py``; None without the library."""
    _rows_view(rows, "pcx_rle_encode")
    if rows.ndim != 2 or planes < 1 or rows.shape[1] % planes:
        raise ValueError("pcx_rle_encode: [h, planes * plane_bytes]")
    lib = get_lib()
    if lib is None:
        return None
    # at worst two bytes a byte, and a pad byte a plane
    cap = 2 * rows.size + rows.shape[0] * planes
    buf = np.empty(cap, np.uint8)
    n = lib.unmicst_pcx_rle_encode(_ptr(rows), rows.shape[0], rows.shape[1],
                                   planes, _ptr(buf), cap)
    if n < 0:
        raise ValueError("native PCX encode: output buffer undersized")
    return buf[:n].tobytes()


def qoi_encode(px: np.ndarray) -> Optional[bytes]:
    """QOI's chunks and end marker for ``px`` (``[n, 3 or 4]`` uint8), as
    ``io/qoi.py``'s ``encode_py``; None without the library."""
    _rows_view(px, "qoi_encode")
    if px.ndim != 2 or px.shape[1] not in (3, 4):
        raise ValueError("qoi_encode: [n, 3 or 4] pixels")
    lib = get_lib()
    if lib is None:
        return None
    cap = 5 * len(px) + 9
    buf = np.empty(cap, np.uint8)
    n = lib.unmicst_qoi_encode(_ptr(px), len(px), px.shape[1], _ptr(buf),
                               cap)
    if n < 0:
        raise ValueError("native QOI encode: output buffer undersized")
    return buf[:n].tobytes()


def qoi_decode(data: bytes, pos: int, n: int,
               bands: int) -> Optional[np.ndarray]:
    """QOI's chunks from ``data[pos]`` as ``n * bands`` bytes, as
    ``io/qoi.py``'s ``decode_py``; None without the library, or where
    the data ends first (the plain version then raises PIL's error)."""
    if bands not in (3, 4) or n <= 0 or pos < 0:
        raise ValueError("qoi_decode: 3 or 4 bands, n > 0, pos >= 0")
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(n * bands, np.uint8)
    if lib.unmicst_qoi_decode(data, len(data), pos, _ptr(out), n, bands):
        return None
    return out


def _quant_lib(name: str) -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            f"{name}: the native host library (native/quant.cpp) did not "
            "build or load, and the quantizers have no fallback")
    return lib


def _quant_pixels(px: np.ndarray, colors: int, name: str) -> np.ndarray:
    if px.dtype != np.uint8 or px.ndim != 2 or px.shape[1] != 4 \
            or not len(px):
        raise ValueError(f"{name} needs n x 4 uint8 pixels, n > 0")
    if not 1 <= colors <= 256:
        raise ValueError("bad number of colors")
    return np.ascontiguousarray(px)


def quant_median_cut(px: np.ndarray, colors: int):
    """Pillow's median cut of ``px`` (n x 4 uint8): (indices, palette
    ``[entries, 3]``), as ``io/quant.py``'s ``median_cut_py``.  Raises
    ``RuntimeError`` without the library."""
    px = _quant_pixels(px, colors, "quant_median_cut")
    lib = _quant_lib("quant_median_cut")
    idx = np.empty(len(px), np.uint8)
    pal = np.zeros((256, 4), np.uint8)
    k = lib.unmicst_quant_median_cut(_ptr(px), len(px), colors, _ptr(idx),
                                     _ptr(pal))
    return idx, pal[:k, :3].copy()


def quant_octree(px: np.ndarray, colors: int, with_alpha: bool):
    """Pillow's fast octree of ``px`` (n x 4 uint8): (indices, palette
    ``[colors, 4]``), as ``io/quant.py``'s ``octree_py``.  Raises
    ``RuntimeError`` without the library."""
    px = _quant_pixels(px, colors, "quant_octree")
    lib = _quant_lib("quant_octree")
    idx = np.empty(len(px), np.uint8)
    pal = np.zeros((256, 4), np.uint8)
    k = lib.unmicst_quant_octree(_ptr(px), len(px), colors, int(with_alpha),
                                 _ptr(idx), _ptr(pal))
    return idx, pal[:k].copy()


def j2k_t1(data: bytes, blocks: np.ndarray, segs: np.ndarray,
           out: np.ndarray) -> Optional[int]:
    """JPEG 2000 tier 1 of the code-blocks ``blocks`` (int64 rows of 8)
    from the segments ``segs`` (int64 rows of 3) of ``data`` into the
    flat int32 ``out``, as ``io/jpeg2000.py``'s ``t1_decode_py``: 0, or
    -1 where a block has 31 or more bit-planes; None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    blocks = np.ascontiguousarray(blocks, np.int64).reshape(-1, 8)
    segs = np.ascontiguousarray(segs, np.int64).reshape(-1, 3)
    if out.dtype != np.int32 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError("j2k_t1 needs a C-contiguous int32 output")
    return lib.unmicst_j2k_t1(data, _ptr(blocks), len(blocks), _ptr(segs),
                              _ptr(out))


def j2k_idwt(plane: np.ndarray, bounds: np.ndarray) -> Optional[bool]:
    """The inverse 5/3 (int32 ``plane``) or 9/7 (float32) wavelet of a
    JPEG 2000 tile-component in place, as ``io/jpeg2000.py``'s
    ``idwt53_py`` / ``idwt97_py``; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    fn = {np.dtype(np.int32): lib.unmicst_j2k_idwt53,
          np.dtype(np.float32): lib.unmicst_j2k_idwt97}[plane.dtype]
    if plane.ndim != 2 or not plane.flags["C_CONTIGUOUS"]:
        raise ValueError("j2k_idwt needs a C-contiguous 2-D plane")
    bounds = np.ascontiguousarray(bounds, np.int64).reshape(-1, 4)
    fn(_ptr(plane), plane.shape[1], _ptr(bounds), len(bounds))
    return True


def fli_decode(buf: bytes, img: np.ndarray) -> Optional[int]:
    """``FliDecode.c`` over one feed ``buf`` onto ``img`` (``[ysize,
    xsize]`` uint8), as ``io/fli.py``'s ``decode_py``: its result, or
    None without the library."""
    _rows_view(img, "fli_decode")
    if img.ndim != 2:
        raise ValueError("fli_decode: [ysize, xsize]")
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.unmicst_fli_decode(buf, len(buf), _ptr(img), img.shape[0],
                                      img.shape[1]))


def bcn_decode(blocks: np.ndarray, n: int,
               signed: bool) -> Optional[np.ndarray]:
    """``[k, 16, 4]`` uint8: the pixels of ``k`` blocks (``[k, size]``
    uint8) of BCn decoder ``n`` (``signed``: BC5S, BC6HS), as
    ``io/bcn.py``'s ``decode_blocks_py``; None without the library."""
    if n not in range(1, 8) or blocks.dtype != np.uint8 or blocks.ndim != 2 \
            or blocks.shape[1] != (8 if n in (1, 4) else 16):
        raise ValueError("bcn_decode: decoder 1-7 and [k, block bytes] "
                         "uint8")
    lib = get_lib()
    if lib is None:
        return None
    blocks = np.ascontiguousarray(blocks)
    out = np.empty((len(blocks), 16, 4), np.uint8)
    lib.unmicst_bcn_decode(_ptr(blocks), len(blocks), n, int(signed),
                           _ptr(out))
    return out


_RESAMPLE_TYPES = ({np.dtype(np.uint8)}, {np.dtype("<u2")},
                   {np.dtype(np.int32)}, {np.dtype(np.float32)})


def resample_pass(src: np.ndarray, axis: int, xmin: np.ndarray,
                  xmax: np.ndarray, k: np.ndarray, kind: int, offset: int = 0,
                  rows: Optional[int] = None) -> Optional[np.ndarray]:
    """One pass of ``Resample.c`` (``native/resample.cpp``), as
    ``io/resample.py``'s ``pass_py`` takes and returns it; None without
    the library."""
    if src.ndim != 3 or src.dtype not in _RESAMPLE_TYPES[kind] or \
            axis not in (0, 1):
        raise ValueError("resample_pass: [h, w, c] of the kind's type, "
                         "axis 0 or 1")
    lib = get_lib()
    if lib is None:
        return None
    h, w, c = src.shape
    rows = h - offset if rows is None else rows
    out = len(xmin)
    if axis == 1 and (offset < 0 or offset + rows > h):
        raise ValueError("resample_pass: rows outside the image")
    if out and int((xmin + np.maximum(xmax, 0)).max()) > (w if axis else h):
        raise ValueError("resample_pass: taps outside the image")
    src = np.ascontiguousarray(src)
    xmin = np.ascontiguousarray(xmin, np.int64)
    xmax = np.ascontiguousarray(xmax, np.int64)
    k = np.ascontiguousarray(k, np.int32 if kind == 0 else np.float64)
    dst = np.empty((rows, out, c) if axis else (out, w, c), src.dtype)
    lib.unmicst_resample_pass(_ptr(src), w, c, kind, axis, _ptr(xmin),
                              _ptr(xmax), _ptr(k), k.shape[1], out, offset,
                              rows, _ptr(dst))
    return dst


def alpha_multiply(px: np.ndarray, inverse: bool) -> Optional[np.ndarray]:
    """``io/resample.py``'s premultiply (or, ``inverse``, its undoing) of
    ``px`` (uint8, alpha last; ``native/resample.cpp``), as a new array;
    None without the library."""
    if px.dtype != np.uint8 or px.ndim < 1 or px.shape[-1] < 1:
        raise ValueError("alpha_multiply: uint8 channels, alpha last")
    lib = get_lib()
    if lib is None:
        return None
    out = np.array(px, np.uint8, order="C")
    lib.unmicst_alpha_multiply(_ptr(out), out.size // out.shape[-1],
                               out.shape[-1], int(inverse))
    return out
