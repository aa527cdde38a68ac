"""Slide IO facade: one channel plane of a TIFF or OME-TIFF.

The ``ome.tif / ome.tiff / btf / tif / tiff`` branch of
``unmicst_tpu/io/slides.py`` (``UnMicst1-5.py:794-806``): page == channel,
or the OME-XML plane (C=c, Z=0, T=0) when the first page carries
consistent OME metadata (:mod:`unmicst_tpu_torch.io.ome`).  Whole planes
(:func:`read_channel`) feed the whole-slide engine; windowed sources
(:func:`open_channel_source`), the streamed statistics and the streamed
preview feed the streaming engine, so a slide never sits whole in host
RAM.  CZI and ND2 are not read yet (ROADMAP: "CZI and ND2").
"""

from __future__ import annotations

import numpy as np

from unmicst_tpu_torch.io import ome
from unmicst_tpu_torch.io.tiff import TiffFile

TIFF_LIKE = ("ome.tif", "ome.tiff", "btf", "tif", "tiff")


def tiff_plane(tf: TiffFile, channel: int) -> int:
    """channel -> IFD page of an open TIFF (OME-aware)."""
    desc = tf.pages[0].description if tf.pages else ""
    return ome.plane_index(desc, channel, len(tf.pages))


def _check_file_type(file_type: str) -> None:
    if file_type in ("czi", "nd2"):
        raise NotImplementedError(
            f".{file_type} input is not ported to unmicst_tpu_torch yet "
            "(ROADMAP: CZI and ND2); convert to OME-TIFF or use unmicst_tpu"
        )
    if file_type not in TIFF_LIKE:
        raise NotImplementedError(
            f"Don't know how to read image with extension .{file_type}"
        )


def read_channel(image_path: str, file_type: str, channel: int) -> np.ndarray:
    if channel < 0:
        raise IndexError(f"channel {channel} out of range")
    _check_file_type(file_type)
    with TiffFile(image_path) as tf:
        page = tiff_plane(tf, channel)
        if page >= len(tf.pages):
            raise IndexError(f"channel {channel} out of range")
        arr = tf.read_page(page)
    if arr.dtype.byteorder not in ("=", "|"):
        arr = arr.astype(arr.dtype.newbyteorder("="))
    return arr


def channel_names(image_path: str):
    """Declared OME-XML channel names of a TIFF, or None."""
    with TiffFile(image_path) as tf:
        desc = tf.pages[0].description if tf.pages else ""
    return ome.channel_names(desc)


def resolve_channel_names(image_path: str, file_type: str, names):
    """Channel names -> 0-based indexes, through the OME-XML
    ``<Channel Name=...>`` elements of a TIFF/OME-TIFF
    (``unmicst_tpu/io/slides.py:424``).  ValueError when the file declares
    no names or a name does not resolve (the message lists the declared
    ones)."""
    _check_file_type(file_type)
    declared = channel_names(image_path)
    if declared is None:
        raise ValueError(
            f"this .{file_type} input carries no channel names; use a "
            "channel index instead"
        )
    return [ome.resolve_name(declared, n) for n in names]


def _streamed_int_stats(read_rows, height: int, width: int, dtype,
                        outlier: float, with_max: bool = False):
    """Exact ``(min, max | percentile[, max])`` of a windowed integer plane
    (``unmicst_tpu/io/slides.py:187``).

    A 64k-bin histogram over row chunks; the percentile is
    ``np.percentile``'s linear interpolation on the exact order statistics
    (integer values make the histogram lossless).  ``with_max`` appends
    the true max, so one pass serves the rescale range and the preview.
    """
    dtype = np.dtype(dtype)
    if outlier != -1 and not 0 <= outlier <= 100:
        raise ValueError(
            f"outlier percentile {outlier} not in [0, 100] (or -1)"
        )
    if dtype == np.int16:
        offset = 32768
    elif dtype in (np.dtype(np.uint8), np.dtype(np.uint16)):
        offset = 0
    else:
        raise NotImplementedError(f"streamed stats for dtype {dtype}")
    hist = np.zeros(65536, np.int64)
    chunk = max(1, (64 << 20) // max(1, width * 2))
    for r0 in range(0, height, chunk):
        rows = read_rows(r0, min(chunk, height - r0))
        if offset:
            # int16 -> shifted uint16 (monotonic, == value + 32768)
            rows = rows.view(np.uint16) ^ 0x8000
        hist += np.bincount(rows.ravel(), minlength=65536)[:65536]
    nz = np.nonzero(hist)[0]
    if nz.size == 0:
        raise ValueError("zero-area plane (corrupt or empty source)")
    lo = float(nz[0]) - offset
    vmax = float(nz[-1]) - offset
    if outlier == -1:
        hi = vmax
    else:
        n = int(hist.sum())
        pos = (n - 1) * outlier / 100.0
        k = int(np.floor(pos))
        frac = pos - k
        cum = np.cumsum(hist)
        v_k = float(np.searchsorted(cum, k + 1))
        v_k1 = float(np.searchsorted(cum, k + 2)) if frac > 0 else v_k
        hi = v_k + frac * (v_k1 - v_k) - offset
    return (lo, hi, vmax) if with_max else (lo, hi)


class ChannelSource:
    """Windowed view of one channel plane: ``height``, ``width``,
    ``dtype``, ``read_rows(r0, n)`` (zero outside the plane) and
    ``stats(outlier)``.  float32 planes arrive parity-cast to uint16
    (``UnMicst1-5.py:807-808``); ``raw_dtype`` keeps the stored type."""

    def __init__(self, height: int, width: int, dtype, read_rows_fn,
                 closer=None):
        self.height, self.width = int(height), int(width)
        self.raw_dtype = np.dtype(dtype)
        self._cast = self.raw_dtype == np.float32
        self.dtype = np.dtype(np.uint16) if self._cast else self.raw_dtype
        self._read = read_rows_fn
        self._closer = closer

    def read_rows(self, r0: int, nrows: int) -> np.ndarray:
        out = np.zeros((nrows, self.width), self.dtype)
        a, b = max(r0, 0), min(r0 + nrows, self.height)
        if b > a:
            rows = self._read(a, b - a)
            if self._cast:
                rows = rows.astype(np.uint16)
            if rows.dtype.byteorder not in ("=", "|"):
                rows = rows.astype(rows.dtype.newbyteorder("="))
            out[a - r0 : b - r0] = rows[: b - a]
        return out

    def stats(self, outlier: float = -1, with_max: bool = False):
        return _streamed_int_stats(self.read_rows, self.height, self.width,
                                   self.dtype, outlier, with_max=with_max)

    def close(self) -> None:
        if self._closer:
            self._closer()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_channel_source(image_path: str, file_type: str,
                        channel: int) -> ChannelSource:
    """Windowed streaming source for one channel of a TIFF or OME-TIFF.
    The file closes if setup fails after the open."""
    if channel < 0:
        raise IndexError(f"channel {channel} out of range")
    _check_file_type(file_type)
    tf = TiffFile(image_path)
    try:
        plane = tiff_plane(tf, channel)
        if plane >= len(tf.pages):
            raise IndexError(f"channel {channel} out of range")
        page = tf.pages[plane]
        # a one-row probe: an unsupported codec or layout fails here, not
        # mid-stream
        tf.read_region(plane, 0, 0, 1, page.width)
        return ChannelSource(
            page.height, page.width, page.dtype,
            lambda r0, n: tf.read_region(plane, r0, 0, n, page.width),
            closer=tf.close,
        )
    except Exception:
        tf.close()
        raise


def preview_u8(src: ChannelSource, vmax: float = None) -> np.ndarray:
    """The qc preview page ``uint8(255 * raw / max)`` built chunk-wise
    (``unmicst_tpu/io/slides.py:289``); integer planes go through a value
    lookup table.  ``vmax``: the raw max when known (skips a pass)."""
    h, w = src.height, src.width
    chunk = max(1, (64 << 20) // max(1, w * 2))
    if vmax is None:
        vmax = 0.0
        for r0 in range(0, h, chunk):
            vmax = max(vmax,
                       float(src.read_rows(r0, min(chunk, h - r0)).max()))
    dt = np.dtype(src.dtype)
    lut, lut_off = None, 0
    if dt in (np.dtype(np.uint8), np.dtype(np.uint16), np.dtype(np.int16)):
        lut_off = 32768 if dt == np.dtype(np.int16) else 0
        n = 256 if dt == np.dtype(np.uint8) else 65536
        values = np.arange(n, dtype=np.float32) - lut_off
        lut = np.uint8(255 * np.clip(values / max(vmax, 1e-12), 0.0, 1.0))
    out = np.empty((h, w), np.uint8)
    for r0 in range(0, h, chunk):
        rows = src.read_rows(r0, min(chunk, h - r0))
        if lut is not None:
            idx = rows.astype(np.int32) + lut_off if lut_off else rows
            out[r0 : r0 + rows.shape[0]] = lut[idx]
        else:
            out[r0 : r0 + rows.shape[0]] = np.uint8(255 * np.clip(
                rows.astype(np.float32) / max(vmax, 1e-12), 0.0, 1.0))
    return out
