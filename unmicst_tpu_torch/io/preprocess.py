"""Host-side pre/post-processing the slide path keeps (numpy).

``im2double`` is ``toolbox/imtools.py:42-53``; :func:`preview_u8_from_raw`
is the QC preview page of ``unmicst_tpu/io/preprocess.py:514-536``.  The
rescale and quantisation of the net input and the maps run on the device
(``unmicst_tpu_torch/infer.py``).
"""

from __future__ import annotations

import numpy as np


def im2double(image: np.ndarray) -> np.ndarray:
    """uint16 / 65535, uint8 / 255, float32 -> float64; other dtypes pass
    through."""
    if image.dtype == np.uint16:
        return image.astype(np.float64) / 65535
    if image.dtype == np.uint8:
        return image.astype(np.float64) / 255
    if image.dtype == np.float32:
        return image.astype(np.float64)
    return image


def preview_u8_from_raw(raw: np.ndarray) -> np.ndarray:
    """The QC preview page ``uint8(255 * im2double(raw) / max)``.

    uint8/uint16 rasters run the float64 math over a 256/65536-entry
    lookup table (bit-identical per value); float32 takes the parity cast
    to uint16 first (``UnMicst1-5.py:807-808``).
    """
    if raw.dtype == np.float32:
        raw = raw.astype(np.uint16)
    if raw.dtype in (np.dtype(np.uint8), np.dtype(np.uint16)):
        values = np.arange(65536 if raw.dtype == np.uint16 else 256,
                           dtype=raw.dtype)
        d = im2double(values)
        vmax = d[int(raw.max())]
        lut = np.uint8(255 * (d / vmax)) if vmax > 0 else np.uint8(d)
        return lut[raw]
    raw_d = im2double(raw)
    vmax = raw_d.max()
    return np.uint8(255 * (raw_d / vmax if vmax > 0 else raw_d))
