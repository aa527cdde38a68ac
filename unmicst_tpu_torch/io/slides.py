"""Slide IO facade: one channel plane of a TIFF or OME-TIFF.

The ``ome.tif / ome.tiff / btf / tif / tiff`` branch of
``unmicst_tpu/io/slides.py`` (``UnMicst1-5.py:794-806``): page == channel,
or the OME-XML plane (C=c, Z=0, T=0) when the first page carries
consistent OME metadata (:mod:`unmicst_tpu_torch.io.ome`).  CZI and ND2
are not read yet (ROADMAP: "CZI and ND2").
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


def read_channel(image_path: str, file_type: str, channel: int) -> np.ndarray:
    if channel < 0:
        raise IndexError(f"channel {channel} out of range")
    if file_type in ("czi", "nd2"):
        raise NotImplementedError(
            f".{file_type} input is not ported to unmicst_tpu_torch yet "
            "(ROADMAP: CZI and ND2); convert to OME-TIFF or use unmicst_tpu"
        )
    if file_type not in TIFF_LIKE:
        raise NotImplementedError(
            f"Don't know how to read image with extension .{file_type}"
        )
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
