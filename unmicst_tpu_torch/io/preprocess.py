"""Host-side pre/post-processing (numpy, float64).

``im2double`` is ``toolbox/imtools.py:42-53``; :func:`preview_u8_from_raw`
is the QC preview page of ``unmicst_tpu/io/preprocess.py:514-536``.  For
8/16-bit slides the rescale and quantisation of the net input and the maps
run on the device (``unmicst_tpu_torch/infer.py``), and so does the whole
engine's resize (``core/resize_dev.py``).  The CLI's host float path
(other dtypes, mixed duo dtypes, ``--check-numerics``) runs the reference
chain here instead: :func:`preprocess_channel` (``UnMicst1-5.py:807-825``)
before the net and :func:`postprocess_pm` after it.

For ``--scalingFactor`` on the stream, this module keeps the host resize
of ``unmicst_tpu/io/preprocess.py:86-388,539-554``: :func:`resize` is
``skimage.transform.resize`` (img_as_float, a gaussian anti-alias with
sigma ``(f - 1) / 2`` on downscale, mirror boundary, then a bilinear
resample at half-pixel centres), :func:`resize_rows` a block of its rows
computed exactly, :class:`ResampledSource` the virtual resized slide the
streaming engine reads, and :func:`upscale_pm` / :func:`postprocess_pm`
the maps' way back to the raw size with the reference's double
quantisation (``UnMicst1-5.py:848-854``).  The gaussian is scipy's
``gaussian_filter(mode="mirror")`` as a float64 tap-sum in scipy's own
order, without scipy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from unmicst_tpu_torch.core.resize_dev import mirror_index


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


# img_as_float divisor per integer dtype (float passes through, scale 1)
_IMG_AS_FLOAT_SCALE = {
    np.dtype(np.uint8): 255.0,
    np.dtype(np.uint16): 65535.0,
    np.dtype(np.uint32): 4294967295.0,
    np.dtype(np.int16): 32767.0,
    np.dtype(np.int32): 2147483647.0,
}

# value-collection bound of the streamed exact percentile (~32 MB of
# float64); tests shrink it to exercise the refinement passes
_PERCENTILE_CAP = 1 << 22


def img_as_float(image: np.ndarray) -> np.ndarray:
    """``skimage.img_as_float`` for the dtypes slides come in; other
    integer widths raise rather than feed raw magnitudes to the net."""
    scale = _IMG_AS_FLOAT_SCALE.get(image.dtype)
    if scale is not None:
        return image.astype(np.float64) / scale
    if image.dtype.kind in "ui":
        raise NotImplementedError(
            f"img_as_float for dtype {image.dtype} not supported")
    return image.astype(np.float64)


def pinned_to_source_units(pairs, source):
    """Raw-unit pinned ``(lo, hi)`` pairs -> the units ``source.read_rows``
    yields.  A :class:`ResampledSource` streams unit-scale rows (the
    integer full scale divided out), so its pins divide by it; integer
    sources pass through.  Takes ``None``, one pair or a sequence of pairs
    and keeps that structure."""
    scale = getattr(source, "raw_units_scale", None)
    if pairs is None or scale is None or scale == 1.0:
        return pairs
    arr = np.asarray(pairs, dtype=np.float64) / scale
    if arr.ndim == 1:
        return tuple(arr.tolist())
    return [tuple(p) for p in arr.tolist()]


# -- the gaussian anti-alias ----------------------------------------------------


def _gaussian_taps(sigma: float) -> np.ndarray:
    """``scipy.ndimage._gaussian_kernel1d(sigma, 0, radius)``, truncate 4.0
    (the same float64 expression, so the same values)."""
    radius = int(4.0 * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (float(sigma) * float(sigma)) * x ** 2)
    return phi / phi.sum()


def _gaussian_axis(img: np.ndarray, sigma: float, axis: int) -> np.ndarray:
    """``gaussian_filter1d(img, sigma, axis, mode="mirror")`` on float64.
    The taps are symmetric, so scipy's correlate1d sums
    ``x[0] * w[0] + (x[-r] + x[r]) * w[r] + ... + (x[-1] + x[1]) * w[1]``;
    this sum keeps that order."""
    w = _gaussian_taps(sigma)
    r = (len(w) - 1) // 2
    n = img.shape[axis]
    xp = np.take(img, mirror_index(np.arange(-r, n + r), n), axis=axis)

    def at(k):
        return xp[(slice(None),) * axis + (slice(r + k, r + k + n),)]

    out = at(0) * w[r]
    for k in range(r, 0, -1):
        out += (at(-k) + at(k)) * w[r - k]
    return out


def gaussian_filter(img: np.ndarray, sigmas: Sequence[float]) -> np.ndarray:
    """``scipy.ndimage.gaussian_filter(img, sigmas, mode="mirror")`` on a
    float64 plane: axis after axis, axes with sigma 0 skipped."""
    for axis, s in enumerate(sigmas):
        if s > 1e-15:
            img = _gaussian_axis(img, s, axis)
    return img


# -- the bilinear resample --------------------------------------------------------


def _fold_coords(coords: np.ndarray, n: int):
    """Mirror-fold sample coordinates into ``[0, n - 1]`` and split them
    into (lo index, lerp fraction): scipy's ``mirror`` for the one
    reflection that resize coordinates can reach."""
    c = np.abs(coords)
    c = np.where(c > n - 1, 2.0 * (n - 1) - c, c)
    lo = np.floor(c).astype(np.intp)
    np.clip(lo, 0, n - 2, out=lo)
    return lo, c - lo


def _lerp_axis(img: np.ndarray, coords: np.ndarray, axis: int) -> np.ndarray:
    """Order-1 resample of one axis at ``coords``, ``a + (b - a) * frac``
    in place (two large buffers, the gathers)."""
    n = img.shape[axis]
    if n == 1:
        return np.repeat(img, len(coords), axis=axis)
    lo, frac = _fold_coords(coords, n)
    b = np.take(img, lo + 1, axis=axis)
    a = np.take(img, lo, axis=axis)
    np.subtract(b, a, out=b)
    np.multiply(b, frac[:, None] if axis == 0 else frac[None, :], out=b)
    np.add(b, a, out=b)
    return b


def resize(image: np.ndarray, output_shape: Tuple[int, int]) -> np.ndarray:
    """``skimage.transform.resize`` work-alike: float64 in [0, 1]; a copy
    of ``img_as_float(image)`` when the shape is unchanged."""
    img = img_as_float(image)
    in_h, in_w = img.shape[:2]
    out_h, out_w = output_shape
    if (in_h, in_w) == (out_h, out_w):
        return img.copy()
    factors = (in_h / out_h, in_w / out_w)
    sigmas = [max(0.0, (f - 1.0) / 2.0) for f in factors]
    if any(s > 0 for s in sigmas):
        img = gaussian_filter(img, sigmas)
    rows = (np.arange(out_h) + 0.5) * factors[0] - 0.5
    cols = (np.arange(out_w) + 0.5) * factors[1] - 0.5
    return _lerp_axis(_lerp_axis(img, rows, 0), cols, 1)


def resize_rows(read_fn, in_shape: Tuple[int, int],
                out_shape: Tuple[int, int], r0: int,
                nrows: int) -> np.ndarray:
    """Rows ``[r0, r0 + nrows)`` of ``resize(image, out_shape)``, exactly.

    ``read_fn(a, b)`` returns source rows ``[a, b)`` at full width.  The
    block read covers the gaussian's support and the lerp's footprint, so
    the rows equal the whole-image resize bit for bit; at the image's top
    and bottom the block edge is the image edge, where the mirror boundary
    agrees by construction."""
    in_h, in_w = in_shape
    out_h, out_w = out_shape
    if nrows <= 0:
        return np.zeros((0, out_w), np.float64)
    fr, fc = in_h / out_h, in_w / out_w
    sr, sc = max(0.0, (fr - 1.0) / 2.0), max(0.0, (fc - 1.0) / 2.0)
    radius = int(4.0 * sr + 0.5) if sr > 0 else 0
    ys = (np.arange(r0, r0 + nrows) + 0.5) * fr - 0.5
    # the footprint of y < 0 lies at -y (and likewise at the bottom)
    ys_fold = np.abs(ys)
    ys_fold = np.where(ys_fold > in_h - 1, 2 * (in_h - 1) - ys_fold, ys_fold)
    lo = max(int(np.floor(ys_fold.min())) - radius, 0)
    hi = min(int(np.floor(ys_fold.max())) + 1 + radius, in_h - 1)
    block = img_as_float(read_fn(lo, hi + 1))
    if sr > 0 or sc > 0:
        block = gaussian_filter(block, (sr, sc))
    cols = (np.arange(out_w) + 0.5) * fc - 0.5
    # ys_fold - lo is exact, so every later float op matches the whole
    # image's
    return _lerp_axis(_lerp_axis(block, ys_fold - lo, 0), cols, 1)


class ResampledSource:
    """A virtual resized slide for the streaming engine (``--scalingFactor``).

    ``height``, ``width``, ``dtype`` (float32), ``read_rows`` and ``stats``
    over ``resize(raw, (int(H * sf), int(W * sf)))``, computed
    row-block-exactly on demand, so a slide at another scale streams in
    bounded memory and matches the whole-image resize
    (``UnMicst1-5.py:813-815``).  float32 planes take the uint16 parity
    cast first.  ``source``: a 2-D array, a ``(TiffFile, page)`` pair or a
    windowed source with ``height``/``width``/``dtype``/``read_rows`` (a
    :class:`unmicst_tpu_torch.io.slides.ChannelSource`)."""

    def __init__(self, source, scaling_factor: float):
        if isinstance(source, np.ndarray):
            raw = source.astype(np.uint16) if source.dtype == np.float32 \
                else source
            in_h, in_w = raw.shape
            read_dtype = raw.dtype
            self._read = lambda a, b: raw[a:b]
        elif hasattr(source, "read_rows"):
            in_h, in_w = source.height, source.width
            read_dtype = np.dtype(source.dtype)  # already parity-cast
            self._read = lambda a, b: source.read_rows(a, b - a)
        else:
            tf, page = source
            in_h, in_w = tf.pages[page].height, tf.pages[page].width
            cast = np.dtype(tf.pages[page].dtype) == np.float32
            read_dtype = (np.dtype(np.uint16) if cast
                          else np.dtype(tf.pages[page].dtype))

            def _read(a, b, _tf=tf, _page=page, _w=in_w, _cast=cast):
                rows = _tf.read_region(_page, a, 0, b - a, _w)
                return rows.astype(np.uint16) if _cast else rows

            self._read = _read
        # resize_rows divides integer rows by their full scale: pins given
        # in raw units divide by this (pinned_to_source_units)
        self.raw_units_scale = _IMG_AS_FLOAT_SCALE.get(read_dtype, 1.0)
        self.raw_shape = (in_h, in_w)
        self.height = int(float(in_h) * float(scaling_factor))
        self.width = int(float(in_w) * float(scaling_factor))
        if self.height <= 0 or self.width <= 0:
            raise ValueError(
                f"scalingFactor {scaling_factor} shrinks the {in_h}x{in_w} "
                f"slide to {self.height}x{self.width}")
        self.dtype = np.dtype(np.float32)

    def read_rows(self, r0: int, nrows: int) -> np.ndarray:
        """Resized rows ``[r0, r0 + nrows)``, float32 in [0, 1], zero
        outside the virtual image (the engine's edge fill)."""
        out = np.zeros((nrows, self.width), np.float32)
        a, b = max(r0, 0), min(r0 + nrows, self.height)
        if b > a:
            out[a - r0 : b - r0] = resize_rows(
                self._read, self.raw_shape, (self.height, self.width),
                a, b - a)
        return out

    def _blocks(self, block: int = 1024):
        # float64 rows: the stats match the whole-image path, which takes
        # them before any narrowing to float32
        for r0 in range(0, self.height, block):
            yield resize_rows(self._read, self.raw_shape,
                              (self.height, self.width), r0,
                              min(block, self.height - r0))

    def stats(self, outlier: float = -1) -> Tuple[float, float]:
        """(min, max | exact percentile) over the virtual resized image.

        The percentile streams: min/max, then 64k-bin histograms that
        locate the order statistics (refined while too many values share
        the covering bins), then the values of those bins alone, which
        give ``np.percentile``'s linear interpolation exactly."""
        vmin, vmax = np.inf, -np.inf
        for rows in self._blocks():
            vmin = min(vmin, float(rows.min()))
            vmax = max(vmax, float(rows.max()))
        if outlier == -1 or vmax <= vmin:
            return vmin, vmax
        n = self.height * self.width
        pos = (n - 1) * outlier / 100.0
        k, frac = int(np.floor(pos)), pos - int(np.floor(pos))
        nbins = 65536
        # each refinement selects by the bins of every earlier grid (the
        # same clip formula in the count and the collect passes), so ranks
        # stay exact at float bin edges
        grids = []  # (lo, scale, b_lo, b_hi)

        def _mask(rows):
            m = np.ones(rows.shape, bool)
            for lo, sc, blo, bhi in grids:
                idx = np.clip(((rows - lo) * sc).astype(np.int64), 0,
                              nbins - 1)
                m &= (idx >= blo) & (idx <= bhi)
            return m

        lo_v, hi_v, below = vmin, vmax, 0
        for _depth in range(4):
            scale = nbins / max(hi_v - lo_v, 1e-300)
            hist = np.zeros(nbins, np.int64)
            for rows in self._blocks():
                sel = rows[_mask(rows)]
                if sel.size:
                    idx = np.clip(((sel - lo_v) * scale).astype(np.int64), 0,
                                  nbins - 1)
                    hist += np.bincount(idx, minlength=nbins)
            cum = np.cumsum(hist) + below  # global ranks
            b_lo = int(np.searchsorted(cum, k + 1))
            b_hi = int(np.searchsorted(cum, k + 2)) if frac > 0 else b_lo
            count_in = int(cum[b_hi]) - (int(cum[b_lo - 1]) if b_lo > 0
                                         else below)
            grids.append((lo_v, scale, b_lo, b_hi))
            below = int(cum[b_lo - 1]) if b_lo > 0 else below
            if count_in <= _PERCENTILE_CAP:
                break
            new_lo = lo_v + b_lo / scale
            new_hi = lo_v + (b_hi + 1) / scale
            if not new_hi - new_lo < hi_v - lo_v:
                # the range is exhausted: the candidates are one value
                return vmin, float(lo_v)
            lo_v, hi_v = new_lo, new_hi
        else:
            # still dense: the candidates span less than
            # (vmax - vmin) / 65536**3, and any of them is the percentile
            return vmin, float(lo_v)
        picked = []
        for rows in self._blocks():
            sel = rows[_mask(rows)]
            if sel.size:
                picked.append(np.asarray(sel, np.float64))
        vals = np.sort(np.concatenate(picked))
        v_k = vals[k - below]
        v_k1 = vals[k + 1 - below] if frac > 0 else v_k
        return vmin, float(v_k + frac * (v_k1 - v_k))


def upscale_pm(pm_u8: np.ndarray, raw_shape: Tuple[int, int],
               block: int = 2048) -> np.ndarray:
    """A scaled uint8 map -> the raw-size uint8 page, in row blocks: the
    resize back and the second ``uint8(255 * x)`` of
    :func:`postprocess_pm`, without a whole-slide float64 plane."""
    out_h, out_w = raw_shape
    out = np.empty((out_h, out_w), np.uint8)
    for r0 in range(0, out_h, block):
        n = min(block, out_h - r0)
        rows = resize_rows(lambda a, b: pm_u8[a:b], pm_u8.shape, raw_shape,
                           r0, n)
        out[r0 : r0 + n] = np.uint8(255 * rows)
    return out


def postprocess_pm(pm: np.ndarray, raw_shape: Tuple[int, int]) -> np.ndarray:
    """A float probability map -> its uint8 page (``UnMicst1-5.py:848-854``):
    ``uint8(255 * pm)``, resized to the raw size, ``uint8(255 * x)`` again
    (``np.uint8`` truncates toward zero)."""
    q = np.uint8(255 * pm)
    if q.shape == tuple(raw_shape):
        lut = np.uint8(255 * img_as_float(np.arange(256, dtype=np.uint8)))
        return lut[q]
    return np.uint8(255 * resize(q, raw_shape))


def rescale_intensity(image: np.ndarray, in_range: Tuple[float, float],
                      out_range: Tuple[float, float]) -> np.ndarray:
    """``skimage.exposure.rescale_intensity`` for float input.  A
    degenerate ``in_range`` clips to ``out_range`` (skimage >= 0.18, the
    reference's era): a constant slide passes through."""
    imin, imax = float(in_range[0]), float(in_range[1])
    omin, omax = float(out_range[0]), float(out_range[1])
    image = np.clip(image, imin, imax)
    if imax == imin:
        return np.clip(image, omin, omax).astype(np.float64)
    return ((image - imin) / (imax - imin)) * (omax - omin) + omin


@dataclass
class PreprocessedChannel:
    net_input: np.ndarray  # float64 [H*, W*]: what the net sees
    raw_norm: np.ndarray  # float64 [H, W]: the preview plane (raw / max)
    raw_shape: Tuple[int, int]


def preprocess_channel(plane: np.ndarray, scaling_factor: float = 1.0,
                       outlier: float = -1, use_rescaled: bool = True,
                       cast_float32: bool = True,
                       in_range=None) -> PreprocessedChannel:
    """The CLI's host front half (``UnMicst1-5.py:807-825``): parity cast,
    resize by ``scaling_factor``, rescale to [0, 0.983] by (min, max |
    percentile(outlier)) or a pinned range, im2double.

    ``use_rescaled=False``: the v2-solo quirk, the net sees the resized
    plane un-rescaled.  ``cast_float32=False``: UnMicstCyto2, which alone
    has no float32 -> uint16 parity cast.  ``in_range``: a pinned
    ``(lo, hi)`` in raw units (after the cast), divided by 255 or 65535
    for 8/16-bit planes; ``outlier`` is then ignored.  At scale 1 an
    8/16-bit plane runs the float64 chain over a table of its values and
    gathers, bit-equal to the whole-plane chain."""
    if cast_float32 and plane.dtype == np.float32:
        plane = plane.astype(np.uint16)  # UnMicst1-5.py:807-808
    raw_shape = plane.shape
    if in_range is not None:
        lo_r, hi_r = (float(v) for v in in_range)
        if not (np.isfinite(lo_r) and np.isfinite(hi_r) and lo_r < hi_r):
            raise ValueError(
                f"in_range must be finite with lo < hi, got {in_range}")
        div = {np.dtype(np.uint8): 255.0,
               np.dtype(np.uint16): 65535.0}.get(plane.dtype)
        if div is not None:
            lo_r, hi_r = lo_r / div, hi_r / div
    h = int(float(raw_shape[0]) * float(scaling_factor))
    w = int(float(raw_shape[1]) * float(scaling_factor))
    if (h, w) == tuple(raw_shape) and plane.dtype in (
            np.dtype(np.uint8), np.dtype(np.uint16)):
        # scale 1: every per-pixel op is a function of the 8/16-bit value
        values = np.arange(256 if plane.dtype == np.uint8 else 65536,
                           dtype=plane.dtype)
        lut_f = img_as_float(values)
        vmin, vmax = int(plane.min()), int(plane.max())
        resized = None
        if in_range is not None:
            min_limit, max_limit = lo_r, hi_r
        elif outlier == -1:
            min_limit, max_limit = lut_f[vmin], lut_f[vmax]
        else:
            resized = lut_f[plane]
            min_limit, max_limit = lut_f[vmin], np.percentile(resized,
                                                              outlier)
        lut_net = im2double(rescale_intensity(
            lut_f, (min_limit, max_limit), (0, 0.983)))
        lut_raw = lut_f / lut_f[vmax] if lut_f[vmax] > 0 else lut_f
        if use_rescaled:
            net_input = lut_net[plane]
        else:
            net_input = resized if resized is not None else lut_f[plane]
        return PreprocessedChannel(net_input, lut_raw[plane], raw_shape)
    resized = resize(plane, (h, w))  # float64
    if in_range is not None:
        min_limit, max_limit = lo_r, hi_r
    elif outlier == -1:
        min_limit, max_limit = resized.min(), resized.max()
    else:
        min_limit, max_limit = resized.min(), np.percentile(resized, outlier)
    rescaled = im2double(rescale_intensity(resized, (min_limit, max_limit),
                                           (0, 0.983)))
    raw_d = im2double(plane)
    raw_norm = raw_d / raw_d.max() if raw_d.max() > 0 else raw_d
    return PreprocessedChannel(rescaled if use_rescaled else resized,
                               raw_norm, raw_shape)


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
