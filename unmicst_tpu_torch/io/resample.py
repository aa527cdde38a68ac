"""Pillow 12's ``Image.resize`` and ``Image.thumbnail`` for the images the
toolbox's ICO and ICNS writes resize (``PIL/Image.py`` ``resize`` and
``thumbnail`` at ``reducing_gap=None``; the compiled ``Resample.c`` and
``Geometry.c``), pinned by probes against PIL, whose C source is not
here.

Images are arrays as :func:`unmicst_tpu_torch.io.png.array_mode` gives
them, with PIL's mode beside them: ``1`` (0/1 uint8), ``L``, ``LA``,
``RGB``, ``RGBA`` (uint8, ``[H, W]`` or ``[H, W, C]``), ``I;16`` and
``I;16B`` (uint16, native or big-endian), ``I`` (int32 values) and ``F``
(float32).  Sizes are PIL's ``(width, height)``.

* **NEAREST**, which ``resize`` forces for mode ``1``: the affine scale
  of ``ImagingScaleAffine``, whose source position starts at half a step
  and adds the step (``in / out`` in double) once per pixel, truncated.
* **BICUBIC** (``a = -0.5``, support 2) and **LANCZOS** (``a = 3``):
  ``precompute_coeffs`` in double (the window's first and last source
  pixel rounded by truncation, the taps normalised by their sum, the
  sine from the C library through ``math.sin``), then a horizontal pass
  over only the rows the vertical pass reads, then the vertical pass,
  each skipped where its side keeps its size:

  - 8 bits a channel (``L``, ``RGB``, ``La``, ``RGBa``): the taps as
    22-bit fixed point rounded away from zero, a start of ``1 << 21``,
    the sum shifted down and clipped to 0..255;
  - 16 bits (``I;16``, ``I;16B``): a sum in double of the two bytes of
    each sample read little-endian whatever the mode (so ``I;16B``
    resamples its byte-swapped values, as Pillow does on a little-endian
    host), rounded half away from zero, its low byte ``n % 256`` and its
    high byte ``n >> 8`` each clipped to 0..255;
  - 32 bits (``I``, ``F``): a sum in double, ``I`` rounded half away
    from zero (a sum outside int32 gives ``-2**31``, as the C cast does
    on x86-64), ``F`` stored as float32.
* **LA and RGBA** resample premultiplied (``convert("La"/"RGBa")``:
  ``c * a`` divided by 255 with Pillow's rounding) and divide back
  (``255 * c // a`` clipped, where ``a`` is neither 0 nor 255).

The passes and the premultiply run in the port's native host library
(``native/resample.cpp``) when it loads, else in :func:`pass_py`,
:func:`premultiply_py` and :func:`unpremultiply_py`, the plain versions
the tests hold them to; both take the same coefficients.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from unmicst_tpu_torch.io import _native

# PIL's ``Resampling`` values of the two filters ported (mode ``1`` is
# resized NEAREST whatever the filter, as ``resize`` forces it)
LANCZOS, BICUBIC = 1, 3
_SUPPORT = {BICUBIC: 2.0, LANCZOS: 3.0}
PRECISION_BITS = 32 - 8 - 2
# the pass kinds of the native library and of pass_py
U8, U16, I32, F32 = 0, 1, 2, 3
_sin = np.frompyfunc(math.sin, 1, 1)  # the C library's sin, as Pillow's


def _sinc(x: np.ndarray) -> np.ndarray:
    out = np.ones_like(x)
    nz = x != 0.0
    y = x[nz] * math.pi
    out[nz] = _sin(y).astype(np.float64) / y
    return out


def _filter(kind: int, x: np.ndarray) -> np.ndarray:
    """``bicubic_filter`` / ``lanczos_filter`` of each double in ``x``."""
    out = np.zeros_like(x)
    if kind == BICUBIC:
        x = np.abs(x)
        near, far = x < 1.0, (x >= 1.0) & (x < 2.0)
        xn, xf = x[near], x[far]
        out[near] = (1.5 * xn - 2.5) * xn * xn + 1
        out[far] = (((xf - 5) * xf + 8) * xf - 4) * -0.5
    else:
        inside = (-3.0 <= x) & (x < 3.0)
        xi = x[inside]
        out[inside] = _sinc(xi) * _sinc(xi / 3)
    return out


def coeffs(in_size: int, out_size: int,
           kind: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``precompute_coeffs`` over the whole input: ``(xmin, xmax, k)``,
    each output's first source pixel and tap count (int64 ``[out]``) and
    its normalised taps (float64 ``[out, ksize]``, 0 past ``xmax``)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT[kind] * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    t = np.arange(ksize)
    used = t[None, :] < xmax[:, None]
    arg = ((t[None, :] + xmin[:, None]).astype(np.float64) - center[:, None]
           + 0.5) * (1.0 / filterscale)
    w = np.zeros((out_size, ksize))
    w[used] = _filter(kind, arg[used])
    ww = np.zeros(out_size)
    for j in range(ksize):  # the C loop's order of the sum
        ww += w[:, j]
    norm = np.divide(w, ww[:, None], out=w.copy(), where=ww[:, None] != 0.0)
    return xmin, xmax, np.where(used, norm, 0.0)


def fixed_point(k: np.ndarray) -> np.ndarray:
    """``normalize_coeffs_8bpc``: the taps as int32 in 22-bit fixed
    point, rounded half away from zero."""
    s = k * float(1 << PRECISION_BITS)
    return np.trunc(np.where(k < 0, -0.5 + s, 0.5 + s)).astype(np.int32)


def _round_up(ss: np.ndarray) -> np.ndarray:
    """``ROUND_UP`` to int64 (``(int)(ss +- 0.5)``), out of int32's range
    as x86-64's truncating conversion gives it (``-2**31``)."""
    r = np.trunc(np.where(ss >= 0.0, ss + 0.5, ss - 0.5))
    ok = (r >= -2.0**31) & (r < 2.0**31)
    return np.where(ok, np.nan_to_num(r), -2.0**31).astype(np.int64)


def _clip8(v: np.ndarray) -> np.ndarray:
    return np.clip(v, 0, 255)


def pass_py(src: np.ndarray, axis: int, xmin: np.ndarray, xmax: np.ndarray,
            k: np.ndarray, kind: int, offset: int = 0,
            rows: int = None) -> np.ndarray:
    """One pass of ``Resample.c`` along ``axis`` (1 horizontal, 0
    vertical) of ``src`` (``[H, W, C]``: uint8 for ``U8``, little-endian
    uint16 for ``U16``, int32 for ``I32``, float32 for ``F32``);
    ``k`` is :func:`fixed_point`'s int32 for ``U8``, else the doubles.
    The horizontal pass reads rows ``offset`` to ``offset + rows``.  The
    plain version of ``native/resample.cpp``, tap by tap over every
    output at once: no ``[rows, out, taps]`` gather."""
    if axis == 1:
        rows = src.shape[0] - offset if rows is None else rows
        src = src[offset : offset + rows].transpose(1, 0, 2)
    if kind == U16:
        src = src.astype(np.int64)
    out_n = len(xmin)
    if kind == U8:
        acc = np.full((out_n,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                      np.int64)
        k = k.astype(np.int64)
    else:
        acc = np.zeros((out_n,) + src.shape[1:], np.float64)
    every = int(xmax.min()) if out_n else 0
    for t in range(k.shape[1]):
        if t < every:
            acc += src[xmin + t] * k[:, t, None, None]
            continue
        sel = xmax > t
        if not sel.any():
            break
        acc[sel] += src[xmin[sel] + t] * k[sel, t, None, None]
    if kind == U8:
        out = _clip8(acc >> PRECISION_BITS).astype(np.uint8)
    elif kind == U16:
        n = _round_up(acc)
        lo = _clip8(np.fmod(n, 256))  # C's %: negative below zero
        out = (lo | _clip8(n >> 8) << 8).astype("<u2")
    elif kind == I32:
        out = _round_up(acc).astype(np.int32)
    else:
        out = acc.astype(np.float32)
    return out.transpose(1, 0, 2) if axis == 1 else out


def _pass(src, axis, xmin, xmax, k, kind, offset=0, rows=None):
    src = np.ascontiguousarray(src)
    out = _native.resample_pass(src, axis, xmin, xmax, k, kind, offset, rows)
    if out is None:
        out = pass_py(src, axis, xmin, xmax, k, kind, offset, rows)
    return out


def resample(px: np.ndarray, kind: int, size: Tuple[int, int],
             filt: int) -> np.ndarray:
    """``ImagingResampleInner`` of ``px`` (``[H, W, C]`` in pass kind
    ``kind``'s layout) to ``size`` = (width, height) with ``filt``."""
    h, w = px.shape[:2]
    xsize, ysize = size
    need_h, need_v = xsize != w, ysize != h
    hx = coeffs(w, xsize, filt)
    vy = coeffs(h, ysize, filt)
    if kind == U8:
        hx = hx[:2] + (fixed_point(hx[2]),)
        vy = vy[:2] + (fixed_point(vy[2]),)
    ymin, ymax = vy[0], vy[1]
    first, last = int(ymin[0]), int(ymin[-1] + ymax[-1])
    out = px
    if need_h:
        out = _pass(px, 1, *hx, kind, first, last - first)
        vy = (ymin - first,) + vy[1:]
    if need_v:
        out = _pass(out, 0, *vy, kind)
    return out if need_h or need_v else px.copy()


def _scale_nearest(px: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``ImagingScaleAffine`` (the affine transform ``_resize`` makes for
    NEAREST): positions accumulated in double, truncated; a position
    outside the source leaves 0."""
    h, w = px.shape[:2]
    xsize, ysize = size

    def table(n_in, n_out):
        step = float(n_in) / n_out
        pos, idx = 0.0 + step * 0.5, np.empty(n_out, np.int64)
        for i in range(n_out):
            idx[i] = -1 if pos < 0.0 else int(pos)
            pos += step
        return idx

    xi, yi = table(w, xsize), table(h, ysize)
    xok, yok = (xi >= 0) & (xi < w), (yi >= 0) & (yi < h)
    out = np.zeros((ysize, xsize) + px.shape[2:], px.dtype)
    out[np.ix_(yok, xok)] = px[np.ix_(yi[yok], xi[xok])]
    return out


def premultiply_py(px: np.ndarray) -> np.ndarray:
    """``convert("La"/"RGBa")``: each colour times alpha over 255, with
    Pillow's rounding (alpha last, uint8)."""
    a = px[..., -1:].astype(np.uint32)
    t = px[..., :-1].astype(np.uint32) * a + 128
    return np.concatenate([(((t >> 8) + t) >> 8).astype(np.uint8),
                           px[..., -1:]], -1)


def unpremultiply_py(px: np.ndarray) -> np.ndarray:
    """``convert("LA"/"RGBA")`` of a premultiplied image: ``255 * c //
    a`` clipped, where ``a`` is neither 0 nor 255."""
    a = px[..., -1:].astype(np.int64)
    c = px[..., :-1].astype(np.int64)
    div = np.minimum(255 * c // np.maximum(a, 1), 255)
    keep = (a == 0) | (a == 255)
    return np.concatenate([np.where(keep, c, div).astype(np.uint8),
                           px[..., -1:]], -1)


def _alpha(px: np.ndarray, inverse: bool) -> np.ndarray:
    out = _native.alpha_multiply(px, inverse)
    if out is None:
        out = (unpremultiply_py if inverse else premultiply_py)(px)
    return out


_KINDS = {"L": U8, "LA": U8, "RGB": U8, "RGBA": U8, "I;16": U16,
          "I;16B": U16, "I": I32, "F": F32}


def resize(px: np.ndarray, mode: str, size: Tuple[int, int],
           resample_filter: int = BICUBIC) -> np.ndarray:
    """``Image.resize(size, resample_filter)`` (no box, no reducing gap)
    of ``px`` in PIL's ``mode``: an array in the same layout, but for
    ``I`` and ``F``, which come back as PIL holds them (int32, float32)."""
    if mode in ("I", "F"):
        px = px.astype(np.int32 if mode == "I" else np.float32)
    h, w = px.shape[:2]
    size = (int(size[0]), int(size[1]))
    if size == (w, h):
        return px.copy()
    if size[0] < 1 or size[1] < 1:
        raise ValueError("height and width must be > 0")
    if mode == "1":  # resize forces NEAREST
        return _scale_nearest(px, size)
    kind = _KINDS[mode]
    planes = px if px.ndim == 3 else px[..., None]
    if mode in ("LA", "RGBA"):
        planes = _alpha(planes, False)
    if kind == U16:  # the samples' bytes read little-endian, as stored
        planes = planes.view("<u2")
    out = resample(planes, kind, size, resample_filter)
    if kind == U16:
        out = out.view(px.dtype)
    if mode in ("LA", "RGBA"):
        out = _alpha(out, True)
    return out if px.ndim == 3 else out[..., 0]


def thumbnail_size(w: int, h: int, size: Tuple[float, float]):
    """``thumbnail``'s ``preserve_aspect_ratio``: the size it resizes to,
    or None where the image already fits."""
    x, y = (math.floor(s) for s in size)
    if x >= w and y >= h:
        return None
    aspect = w / h

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect,
                         key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def thumbnail(px: np.ndarray, mode: str, size: Tuple[float, float],
              resample_filter: int = BICUBIC) -> np.ndarray:
    """``Image.thumbnail(size, resample_filter, reducing_gap=None)`` of
    ``px``: the resized copy, or a copy of ``px`` where it already fits,
    in :func:`resize`'s layout."""
    h, w = px.shape[:2]
    final = thumbnail_size(w, h, size)
    return resize(px, mode, (w, h) if final is None else final,
                  resample_filter)
