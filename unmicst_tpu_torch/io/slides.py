"""Slide IO facade: one channel plane of a TIFF, OME-TIFF, CZI or ND2.

The port of ``unmicst_tpu/io/slides.py`` (``UnMicst1-5.py:794-806``):
``ome.tif / ome.tiff / btf / tif / tiff`` through the TIFF reader, page ==
channel, or the OME-XML plane (C=c, Z=0, T=0) when the first page carries
consistent OME metadata (:mod:`unmicst_tpu_torch.io.ome`); ``czi`` and
``nd2`` through :mod:`unmicst_tpu_torch.io.czi` and
:mod:`unmicst_tpu_torch.io.nd2`.  Whole planes (:func:`read_channel`)
feed the whole-slide engine; windowed sources (:func:`open_channel_source`),
the streamed statistics and the streamed preview feed the streaming
engine, so a slide never sits whole in host RAM.  A pyramidal TIFF's
stored levels (:func:`pyramid_plan`, :func:`read_channel_level`) feed
``--usePyramid``.  :func:`sniff_format` names an upload's container by
its magic bytes.
"""

from __future__ import annotations

import numpy as np

from unmicst_tpu_torch.io import ome
from unmicst_tpu_torch.io.tiff import (PageTooLargeError, TiffFile,
                                       read_page_fallback)

TIFF_LIKE = ("ome.tif", "ome.tiff", "btf", "tif", "tiff")


def sniff_format(path: str) -> str:
    """The container of ``path`` from its magic bytes, whatever its name
    (``unmicst_tpu/io/slides.py:22-37``): classic TIFF and BigTIFF in
    either byte order are ``"tif"``, ``ZISRAWFILE`` is ``"czi"``, the ND2
    chunk magic ``0x0ABECEDA`` is ``"nd2"``; anything else is a
    ValueError."""
    with open(path, "rb") as f:
        head = f.read(16)
    if head.startswith((b"II*\x00", b"II+\x00", b"MM\x00*", b"MM\x00+")):
        return "tif"
    if head.startswith(b"ZISRAWFILE"):
        return "czi"
    if head[:4] == b"\xda\xce\xbe\x0a":
        return "nd2"
    raise ValueError(
        "unrecognized container (expected TIFF/BigTIFF, CZI, or ND2)"
    )


def tiff_plane(tf: TiffFile, channel: int) -> int:
    """channel -> IFD page of an open TIFF (OME-aware)."""
    desc = tf.pages[0].description if tf.pages else ""
    return ome.plane_index(desc, channel, len(tf.pages))


def _unknown(file_type: str) -> NotImplementedError:
    return NotImplementedError(
        f"Don't know how to read image with extension .{file_type}")


def _native_order(arr: np.ndarray) -> np.ndarray:
    if arr.dtype.byteorder not in ("=", "|"):
        arr = arr.astype(arr.dtype.newbyteorder("="))
    return arr


def read_channel(image_path: str, file_type: str, channel: int) -> np.ndarray:
    """One channel's plane, whole.  A TIFF page the reader refuses
    (``NotImplementedError`` or ``ValueError``, not
    :class:`~unmicst_tpu_torch.io.tiff.PageTooLargeError`) goes to
    :func:`~unmicst_tpu_torch.io.tiff.read_page_fallback` at page ==
    channel, not the OME plane, as the JAX package's PIL fallback reads it
    (``unmicst_tpu/io/slides.py:66-97``): past the page chain's end
    ``IndexError``, any other failure there ``ValueError``; a page the
    fallback does not take keeps the reader's own exception."""
    if channel < 0:
        raise IndexError(f"channel {channel} out of range")
    if file_type in TIFF_LIKE:
        try:
            with TiffFile(image_path) as tf:
                page = tiff_plane(tf, channel)
                if page >= len(tf.pages):
                    raise IndexError(f"channel {channel} out of range")
                return _native_order(tf.read_page(page))
        except PageTooLargeError:
            raise
        except (NotImplementedError, ValueError) as e:
            try:
                return read_page_fallback(image_path, channel, e)
            except EOFError:
                raise IndexError(f"channel {channel} out of range") from None
            except Exception as e2:  # noqa: BLE001 -- one contract, as JAX
                if e2 is e:  # a page the fallback does not take
                    raise
                raise ValueError(
                    f"{image_path}: unreadable by both the TIFF reader and "
                    f"its fallback decoder ({type(e2).__name__}: {e2})"
                ) from e2
    if file_type == "czi":
        from unmicst_tpu_torch.io.czi import read_czi_channel

        return read_czi_channel(image_path, channel)
    if file_type == "nd2":
        from unmicst_tpu_torch.io.nd2 import read_nd2_channel

        return read_nd2_channel(image_path, channel)
    raise _unknown(file_type)


def pyramid_plan(image_path: str, file_type: str, channel: int,
                 scaling_factor: float):
    """The deepest stored SubIFD level usable at ``scaling_factor``
    (``unmicst_tpu/io/slides.py:102-149``), header-only: ``(level,
    divisor, full_shape, level_shape)``, or None when the input is not a
    TIFF, the channel's page has no SubIFDs, the factor is above 0.5, or
    no level has an integer downscale ``divisor <= 1 / scaling_factor``
    (a coarser level would lose what the full-resolution run keeps)."""
    if file_type not in TIFF_LIKE:
        return None
    if not scaling_factor or scaling_factor > 0.5:
        return None
    try:
        with TiffFile(image_path) as tf:
            pidx = tiff_plane(tf, channel)
            page = tf.pages[pidx]
            if page.subifds is None or not len(page.subifds):
                return None
            target = 1.0 / float(scaling_factor)
            best = None
            for lvl in range(len(page.subifds)):
                sub = tf.subifd_page(pidx, lvl)
                d = round(page.height / sub.height)
                if d < 2:
                    continue
                # mild odd-edge rounding passes; anisotropic or
                # non-integer level geometry does not
                if (abs(page.height / sub.height - d) > 0.02 * d
                        or abs(page.width / sub.width - d) > 0.02 * d):
                    continue
                if d <= target * (1 + 1e-6) and (best is None
                                                 or d > best[1]):
                    best = (lvl, d, (page.height, page.width),
                            (sub.height, sub.width))
            return best
    except (ValueError, NotImplementedError, OSError, IndexError):
        return None


def pyramid_plan_multi(image_path: str, file_type: str, channels,
                       scaling_factor: float, max_level_px=None):
    """One ``(level, divisor, full_shape, level_shape)`` plan for every
    channel's page, or None (``unmicst_tpu/io/slides.py:152-173``): every
    channel needs a usable level at the same (level, divisor), and with
    ``max_level_px`` the level itself must not exceed it (such a level
    would have to stream, which a whole-decoded level defeats)."""
    plans = [pyramid_plan(image_path, file_type, c, scaling_factor)
             for c in channels]
    if not plans or any(p is None for p in plans):
        return None
    if len({(p[0], p[1]) for p in plans}) != 1:
        return None
    p = plans[0]
    if max_level_px is not None and p[3][0] * p[3][1] > max_level_px:
        return None
    return p


def read_channel_level(image_path: str, file_type: str, channel: int,
                       level: int) -> np.ndarray:
    """One stored pyramid level of a channel's page, whole, in native
    byte order."""
    with TiffFile(image_path) as tf:
        return _native_order(tf.read_subifd(tiff_plane(tf, channel), level))


def channel_names(image_path: str, file_type: str = "tif"):
    """Declared channel names, or None: OME-XML ``<Channel Name=...>`` of
    a TIFF, ``Image/Dimensions/Channels`` of a CZI's metadata XML; ND2
    carries none here."""
    if file_type in TIFF_LIKE:
        with TiffFile(image_path) as tf:
            desc = tf.pages[0].description if tf.pages else ""
        return ome.channel_names(desc)
    if file_type == "czi":
        from unmicst_tpu_torch.io.czi import CziFile

        with CziFile(image_path) as cz:
            return cz.channel_names()
    return None


def resolve_channel_names(image_path: str, file_type: str, names):
    """Channel names -> 0-based indexes (``unmicst_tpu/io/slides.py:
    424-437``).  ValueError when the file declares no names or a name does
    not resolve (the message lists the declared ones)."""
    declared = channel_names(image_path, file_type)
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
    """Windowed streaming source for one channel of any supported format.
    A one-row probe makes an unsupported codec or sub-block fail here,
    not mid-stream; the file closes if setup fails after the open."""
    if channel < 0:
        raise IndexError(f"channel {channel} out of range")
    if file_type in TIFF_LIKE:
        tf = TiffFile(image_path)
        try:
            plane = tiff_plane(tf, channel)
            if plane >= len(tf.pages):
                raise IndexError(f"channel {channel} out of range")
            page = tf.pages[plane]
            tf.read_region(plane, 0, 0, 1, page.width)
            return ChannelSource(
                page.height, page.width, page.dtype,
                lambda r0, n: tf.read_region(plane, r0, 0, n, page.width),
                closer=tf.close,
            )
        except Exception:
            tf.close()
            raise
    if file_type == "czi":
        from unmicst_tpu_torch.io.czi import CziFile

        czi = CziFile(image_path)
        try:
            h, w = czi.channel_shape(channel)
            probe = czi.read_rows(channel, 0, 1)
            return ChannelSource(
                h, w, probe.dtype,
                lambda r0, n: czi.read_rows(channel, r0, n),
                closer=czi.close,
            )
        except Exception:
            czi.close()
            raise
    if file_type == "nd2":
        from unmicst_tpu_torch.io.nd2 import Nd2File

        nd2 = Nd2File(image_path)
        try:
            nd2.read_rows(channel, 0, 1)
            return ChannelSource(
                nd2.height, nd2.width, nd2.dtype,
                lambda r0, n: nd2.read_rows(channel, r0, n),
                closer=nd2.close,
            )
        except Exception:
            nd2.close()
            raise
    raise _unknown(file_type)


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
