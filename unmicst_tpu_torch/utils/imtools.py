"""Image-processing toolbox: the port of ``unmicst_tpu/utils/imtools.py``
(the reference's ``toolbox/imtools.py``), with its names and signatures.

The JAX toolbox builds on ``scipy.ndimage``, PIL and matplotlib, none of
which the port imports.  Here the filters, the morphology, the feature
stacks and :func:`imresize3_double` compute in torch on ``device``
(default ``cuda``, raising without a card; ``"cpu"`` when asked for), in
float64, and return numpy arrays in scipy's output dtypes:

* Gaussian filters follow ``gaussian_filter``: the taps of scipy's
  ``_gaussian_kernel1d`` (radius ``int(truncate * sigma + 0.5)``,
  derivative orders by its polynomial recurrence, correlated reversed),
  the axes in order 0..n-1, each pass summed in ``correlate1d``'s order
  and stored in the input's dtype (integers truncate);
* boundary modes ``reflect`` (scipy's default, ``d c b a | a b c d``),
  ``mirror``, ``nearest``, ``wrap`` and ``constant`` fold the sample
  indices, periodically where the radius exceeds the axis;
* the rank filters gather the disk or ball footprint under ``reflect``
  and select scipy's rank exactly, a block of rows at a time;
* binary erosion and dilation treat outside pixels as 0
  (``border_value=0``).

The index-only helpers (the nearest-neighbour resizes, ``normalize``,
``snormalize``, ``cat``, ``size``, ``stack2list``) stay in numpy.
:func:`imread` opens a file by content, as PIL does for the JAX package:
TIFFs through :mod:`unmicst_tpu_torch.io.tiff`, PNGs through
:mod:`unmicst_tpu_torch.io.png`, JPEGs and MPOs through
:mod:`unmicst_tpu_torch.io.mpo`, BMPs through
:mod:`unmicst_tpu_torch.io.bmp`, GIFs through
:mod:`unmicst_tpu_torch.io.gif`, Netpbm files through
:mod:`unmicst_tpu_torch.io.pnm`, and the files PIL tells apart by trying
its other plugins in turn (PCX, DCX, SGI, TGA, DIB, IM, MSP, XBM, QOI,
DDS, JPEG 2000, ICO, CUR, ICNS, BLP, FTEX, FLI and the other raster
plugins PIL decodes itself, through :mod:`unmicst_tpu_torch.io.identify`;
JPEG 2000 J2K codestreams and JP2 files through
:mod:`unmicst_tpu_torch.io.jpeg2000`);
:func:`imwrite` writes TIFF and every format PIL 12 saves (RGB and RGBA
GIFs through :mod:`unmicst_tpu_torch.io.quant`; ICO and ICNS through
Pillow's resampler, :mod:`unmicst_tpu_torch.io.resample`; PDF through the
JPEG and Group 4 encoders) but WebP, JPEG 2000 and AVIF, which raise
``NotImplementedError`` (ROADMAP M17), as reads of other formats (WebP
among them) do; so does a PDF of an ``LA`` or ``RGBA`` image, which PIL
writes through its JPEG 2000 encoder.
:func:`imshow` and :func:`imshowlist` keep the JAX package's headless
contract without matplotlib: they write a PNG and return its path.

On an integer image the feature stacks and :func:`imgradmag` give what
numpy gives: the derivatives are stored in the image's dtype, their
squares and sums wrap in it, and the root takes numpy's float type for
it (float16 for 8 bits, float32 for 16, float64 wider).  On a bool image
the filters keep scipy's stored bytes (see :func:`_cast`), numpy reads
each as 0 or 1, and the Laplacian's negation raises ``TypeError``, as
numpy's ``-`` does for the JAX package.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from unmicst_tpu_torch.io import (bmp, dds, eps, gif, icns, ico, identify,
                                  im, jpegenc, mpo, msp, palm, pcx, pdf, png,
                                  pnm, qoi, sgi, tga, xbm)
from unmicst_tpu_torch.io.preprocess import im2double, resize  # noqa: F401
from unmicst_tpu_torch.io.tiff import imread as _tiff_read
from unmicst_tpu_torch.io.tiff import imwrite as _tiff_write
from unmicst_tpu_torch.runtime.devices import resolve_device

# values gathered per block of a rank filter (footprint size x rows x
# the rest): about 256 MB of float64, and the sort's as much again
_RANK_BLOCK = 1 << 25
_MODES = ("reflect", "mirror", "nearest", "wrap", "constant")
_GAUSS_KWARGS = ("order", "mode", "cval", "truncate")


def tifread(path: str) -> np.ndarray:
    return _tiff_read(path)


def tifwrite(image: np.ndarray, path: str) -> None:
    _tiff_write(path, image, bigtiff=False)


def size(image: np.ndarray) -> List[int]:
    return list(image.shape)


# magic bytes -> the reader of a file opened by content, as PIL's
# ``Image.open`` tells them apart (TIFF, by the prefixes PIL's _accept
# takes, is the port's own reader; a JPEG
# is an MPO's frame 0, or its one frame); any other file goes through
# PIL's other plugins in their order (io/identify.py)
_TIFF_MAGICS = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
                b"MM\x00\x2b", b"II\x2b\x00")
_BY_CONTENT = (
    tuple((head, _tiff_read) for head in _TIFF_MAGICS)
    + ((b"\x89PNG\r\n\x1a\n", png.read_png), (b"\xff\xd8\xff", mpo.read_mpo),
       (b"BM", bmp.read_bmp), (b"GIF87a", gif.read_gif),
       (b"GIF89a", gif.read_gif))
    + tuple((b"P" + bytes([c]), pnm.read_frame) for c in b"0123456fy"))


# extension -> the writer of ``Image.fromarray(image).save(path)``
_BY_EXTENSION = {".png": png.write_png, ".apng": png.write_png,
                 ".bmp": bmp.write_bmp, ".dib": bmp.write_dib,
                 ".gif": gif.write_gif, ".jpg": jpegenc.write_jpeg,
                 ".jpeg": jpegenc.write_jpeg, ".jpe": jpegenc.write_jpeg,
                 ".jfif": jpegenc.write_jpeg, ".mpo": jpegenc.write_jpeg,
                 ".pcx": pcx.write_pcx, ".im": im.write_im,
                 ".msp": msp.write_msp, ".palm": palm.write_palm,
                 ".xbm": xbm.write_xbm, ".qoi": qoi.write_qoi,
                 ".eps": eps.write_eps, ".ps": eps.write_eps,
                 ".dds": dds.write_dds, ".ico": ico.write_ico,
                 ".icns": icns.write_icns, ".pdf": pdf.write_pdf,
                 **dict.fromkeys((".pbm", ".pgm", ".ppm", ".pnm", ".pfm"),
                                 pnm.write_pnm),
                 **dict.fromkeys(tga.EXTENSIONS, tga.write_tga),
                 **dict.fromkeys(sgi.EXTENSIONS, sgi.write_sgi)}
# extensions of PIL's formats without a save handler (``Image.save``'s
# KeyError), of save handlers that refuse every image ``fromarray`` makes
# or are stubs, and of the writers still queued (ROADMAP M17)
_NO_SAVE = {".cur": "CUR", ".dcx": "DCX", ".fit": "FITS", ".fits": "FITS",
            ".flc": "FLI", ".fli": "FLI", ".ftc": "FTEX", ".ftu": "FTEX",
            ".gbr": "GBR", ".iim": "IPTC", ".mpeg": "MPEG", ".mpg": "MPEG",
            ".pcd": "PCD", ".psd": "PSD", ".pxr": "PIXAR", ".ras": "SUN",
            ".xpm": "XPM"}
_STUBS = {".bufr": "BUFR", ".grib": "GRIB", ".h5": "HDF5", ".hdf": "HDF5",
          ".wmf": "WMF", ".emf": "WMF"}
QUEUED = (".webp", ".j2c", ".j2k", ".jp2", ".jpc", ".jpf", ".jpx", ".avif",
          ".avifs")


def imread(path: str) -> np.ndarray:
    """Generic image read, as the JAX toolbox's: a ``.tif``/``.tiff``
    name goes to the TIFF reader (whose fallback opens a PNG, JPEG, BMP,
    GIF, Netpbm, PCX, DCX, SGI, TGA, DIB, IM, MSP, XBM, QOI, DDS, JPEG
    2000, SPIDER, FITS, McIDAS, PSD, Sun raster, PIXAR, XV thumbnail,
    XPM, IMT, GBR, IPTC, PhotoCD, ICO, CUR, ICNS, BLP, FTEX or FLI file
    under that name by content, at ``seek(0)``); any other file is opened
    by content, as ``Image.open``
    opens it, each as PIL's ``np.asarray`` gives it without a seek: a
    TIFF, PNG, JPEG, BMP, Netpbm, PCX, SGI, TGA, DIB, MSP, XBM, QOI,
    DDS (block-compressed ones through :mod:`unmicst_tpu_torch.io.bcn`),
    ICO (its largest entry, RGBA or a PNG's own mode), CUR, ICNS, BLP,
    FTEX or JPEG 2000 file (a J2K codestream or a JP2 file:
    ``.jp2``, ``.j2k``, ``.jpc``, ``.jpf``, ``.jpx``, ``.j2c`` or any
    other name; ``I;16`` as uint16, a palette file's indices) whatever its
    name, a GIF, an MPO, a DCX, an FLI or FLC, or an IM file its first
    frame (IM's
    ``I;16`` as uint16, ``F`` as float32; MSP's and XBM's mode ``1`` as
    bool), a SPIDER image or a stack's first image, a PSD's composite, and
    the formats :mod:`unmicst_tpu_torch.io.identify` reads by PIL's plugin
    order, with PIL's exceptions (a JPEG that does not decode raises
    ``OSError``; a file no plugin of PIL opens, PFM and PAM among them,
    ``OSError``, as do the stubs PIL opens and cannot load: BUFR, GRIB,
    HDF5, WMF, MPEG).  Files PIL opens as
    other formats (WebP, AVIF and EPS among them) and the JPEG 2000 files
    PIL's encoder cannot write (see :mod:`unmicst_tpu_torch.io.jpeg2000`)
    raise ``NotImplementedError`` (ROADMAP M17)."""
    if path.lower().endswith((".tif", ".tiff")):
        return _tiff_read(path)
    with open(path, "rb") as f:
        magic = f.read(8)
    for head, read in _BY_CONTENT:
        if magic.startswith(head):
            return read(path)
    with open(path, "rb") as f:
        px = identify.read(f.read(), None,  # no seek, as PIL's
                           f"imread: {os.path.basename(path)}")
    if px is None:
        raise pnm.UnidentifiedImageError(
            f"cannot identify image file {path!r}")
    return px


def imwrite(image: np.ndarray, path: str) -> None:
    """Generic image write, as the JAX toolbox's: a ``.tif``/``.tiff``
    name writes a TIFF page; any other is ``Image.fromarray(image)
    .save(path)``, whose format the extension picks (``_BY_EXTENSION``),
    byte for byte with PIL's modes, and its exceptions where it has none:
    PNG and APNG, BMP and DIB (:mod:`unmicst_tpu_torch.io.bmp`), GIF (RGB
    by Pillow's median cut, RGBA by its fast octree:
    :mod:`unmicst_tpu_torch.io.gif`), JPEG and MPO at PIL's defaults
    (:mod:`unmicst_tpu_torch.io.jpegenc`), Netpbm (``.pbm``, ``.pgm``,
    ``.ppm``, ``.pnm``, ``.pfm``), PCX, TGA (``.tga``, ``.icb``, ``.vda``,
    ``.vst``), SGI (``.sgi``, ``.bw``, ``.rgb``, ``.rgba``), IM, MSP,
    Palm, XBM, QOI, EPS (``.eps``, ``.ps``), uncompressed DDS, ICO and
    ICNS (their entries resized by Pillow's resampler,
    :mod:`unmicst_tpu_torch.io.resample`) and PDF (``1`` as Group 4,
    ``L`` and ``RGB`` as JPEG; the date from ``time.gmtime()``), each
    through its module of :mod:`unmicst_tpu_torch.io`.  PNG and APNG are
    PIL's pixels, not its bytes (the port's deflate is its own), and so
    are the PNG entries of ICO and ICNS, whose other bytes are PIL's.
    Where PIL has no writer (``.dcx``, ``.psd`` ...) its ``KeyError``;
    where its handler is a stub (``.bufr``, ``.grib``, ``.h5``, ``.hdf``,
    ``.wmf``, ``.emf``) its ``OSError``; ``.blp`` its ``ValueError``; an
    unknown extension its ``ValueError``.  WebP, JPEG 2000 and AVIF
    (``QUEUED``), and a PDF of an ``LA`` or ``RGBA`` image, raise
    ``NotImplementedError`` (ROADMAP M17)."""
    if path.lower().endswith((".tif", ".tiff")):
        _tiff_write(path, image, bigtiff=False)
        return
    ext = os.path.splitext(path)[1].lower()
    writer = _BY_EXTENSION.get(ext)
    if writer is not None:
        writer(path, image)
        return
    png.array_mode(image)  # fromarray's TypeError comes first in PIL
    if ext in _NO_SAVE:
        raise KeyError(_NO_SAVE[ext])
    if ext in _STUBS:
        raise OSError(f"{_STUBS[ext]} save handler not installed")
    if ext == ".blp":
        raise ValueError("Unsupported BLP image mode")
    if ext not in QUEUED:
        raise ValueError(f"unknown file extension: {ext}")
    raise NotImplementedError(
        f"imwrite: {ext} files are not written by unmicst_tpu_torch (the "
        "JAX package writes them through PIL: ROADMAP M17)")


def _display_u8(image: np.ndarray) -> np.ndarray:
    """A plane (or RGB image) min-max normalised to uint8 for display."""
    img = np.asarray(image, np.float64)
    lo, hi = img.min(), img.max()
    scaled = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    return np.round(scaled * 255).astype(np.uint8)


def imshow(image: np.ndarray, out: str = None, **kwargs) -> str:
    """Display for a headless process: the min-max normalised image as a
    PNG at ``out`` (default ``imshow.png``); returns the path.  ``kwargs``
    (matplotlib's display options in the JAX package) are accepted and
    not used: there is no colour map here."""
    del kwargs
    out = out or "imshow.png"
    png.write_png(out, _display_u8(image))
    return out


def imshowlist(images: Sequence[np.ndarray], out: str = None,
               **kwargs) -> str:
    """Side-by-side panels, each min-max normalised, as one PNG at
    ``out`` (default ``imshowlist.png``); returns the path."""
    del kwargs
    out = out or "imshowlist.png"
    panels = [_display_u8(im) for im in images]
    rgb = any(p.ndim == 3 for p in panels)
    if rgb:
        panels = [np.repeat(p[..., None], 3, 2) if p.ndim == 2 else p[..., :3]
                  for p in panels]
    height = max(p.shape[0] for p in panels)
    gap = np.zeros((height, 4) + panels[0].shape[2:], np.uint8)
    row = []
    for p in panels:
        pad = np.zeros((height - p.shape[0],) + p.shape[1:], np.uint8)
        row += [np.concatenate([p, pad]), gap]
    png.write_png(out, np.concatenate(row[:-1], 1))
    return out


def normalize(image: np.ndarray) -> np.ndarray:
    """Min-max normalize; identity for constant images (``:70-76``)."""
    lo, hi = np.min(image), np.max(image)
    if hi > lo:
        return (image - lo) / (hi - lo)
    return image


def snormalize(image: np.ndarray) -> np.ndarray:
    """Z-score normalize; identity for constant images (``:78-84``)."""
    m, s = np.mean(image), np.std(image)
    if s > 0:
        return (image - m) / s
    return image


def cat(axis: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.concatenate((a, b), axis=axis)


def imresize_double(image: np.ndarray, size_out: Sequence[int]) -> np.ndarray:
    return resize(image, (size_out[0], size_out[1]))


def imresize3_double(volume: np.ndarray, size_out: Sequence[int],
                     device=None) -> np.ndarray:
    """Trilinear volume resize on the half-pixel grid: scipy's order-1
    ``map_coordinates(mode="nearest")`` at the clipped coordinates
    ``(i + 0.5) * n_in / n_out - 0.5``, one axis at a time."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(volume, np.float64), device=dev)
    for axis, (n_out, n_in) in enumerate(zip(size_out, volume.shape)):
        c = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0,
                    n_in - 1)
        lo = np.minimum(np.floor(c).astype(np.int64), max(n_in - 2, 0))
        hi = np.minimum(lo + 1, n_in - 1)
        shape = [1] * x.ndim
        shape[axis] = n_out
        t = torch.as_tensor(c - lo, device=dev).reshape(shape)
        a = x.index_select(axis, torch.as_tensor(lo, device=dev))
        b = x.index_select(axis, torch.as_tensor(hi, device=dev))
        x = a * (1 - t) + b * t
    return x.cpu().numpy()


def imresize3_uint8(volume: np.ndarray, size_out: Sequence[int]) -> np.ndarray:
    """Nearest-neighbour uint8 volume resize (order 0): index
    ``floor((i + 0.5) * n_in / n_out)``, clamped."""
    idx = [
        np.minimum(((np.arange(n_out) + 0.5) * n_in / n_out).astype(int),
                   n_in - 1)
        for n_out, n_in in zip(size_out, volume.shape)
    ]
    return np.uint8(volume[np.ix_(*idx)])


def imresize_uint8(image: np.ndarray, size_out: Sequence[int]) -> np.ndarray:
    """Nearest-neighbour uint8 resize (order 0), the index math of
    :func:`imresize3_uint8` on two axes."""
    in_h, in_w = image.shape[:2]
    out_h, out_w = size_out[0], size_out[1]
    rows = np.minimum(((np.arange(out_h) + 0.5) * in_h / out_h).astype(int),
                      in_h - 1)
    cols = np.minimum(((np.arange(out_w) + 0.5) * in_w / out_w).astype(int),
                      in_w - 1)
    return np.uint8(image[np.ix_(rows, cols)])


# -- index folds and dtype casts ---------------------------------------------------


def _fold(idx: np.ndarray, n: int, mode: str) -> np.ndarray:
    """Sample indices outside ``[0, n)`` folded back in by a boundary
    mode, periodically (scipy extends its line buffers so)."""
    if mode == "reflect":
        m = idx % (2 * n)
        return np.where(m < n, m, 2 * n - 1 - m)
    if mode == "mirror":
        if n == 1:
            return np.zeros_like(idx)
        m = idx % (2 * n - 2)
        return np.where(m < n, m, 2 * n - 2 - m)
    if mode == "wrap":
        return idx % n
    return np.clip(idx, 0, n - 1)  # nearest (and constant's gather)


def _pad_axis(x: torch.Tensor, axis: int, r: int, mode: str,
              cval: float = 0.0) -> torch.Tensor:
    """``x`` extended by ``r`` samples on both ends of ``axis``."""
    n = x.shape[axis]
    idx = np.arange(-r, n + r)
    out = x.index_select(axis, torch.as_tensor(_fold(idx, n, mode),
                                               device=x.device))
    if mode == "constant" and r:
        shape = [1] * x.ndim
        shape[axis] = len(idx)
        inside = torch.as_tensor((idx >= 0) & (idx < n), device=x.device)
        out = torch.where(inside.reshape(shape), out,
                          torch.full((), cval, dtype=x.dtype,
                                     device=x.device))
    return out


_FLOAT_DTYPES = {np.dtype(np.float16): torch.float16,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def _cast(x: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    """The values a float64 result takes when scipy stores it in
    ``dtype``: floats round to it (and stay float64 for the next pass);
    integers truncate and wrap, as C's cast does.  A bool result is C's
    cast of the double into the bool's byte, as x86 compiles it for
    scipy: truncated to a 32-bit integer (0 where it is out of range or
    NaN), then its low 8 bits, so -1 stores 255 and 300.7 stores 44; a
    later pass reads that byte back as a number."""
    if dtype in _FLOAT_DTYPES:
        return x.to(_FLOAT_DTYPES[dtype]).to(torch.float64)
    if dtype == np.bool_:
        t = torch.trunc(x)
        return torch.where((t >= -2.0**31) & (t < 2.0**31),
                           torch.remainder(t, 256.0), 0.0)
    info = np.iinfo(dtype)
    span = float(info.max) - float(info.min) + 1
    return torch.remainder(torch.trunc(x) - float(info.min), span) + float(
        info.min)


def _to_numpy(x: torch.Tensor, dtype: np.dtype) -> np.ndarray:
    """A result in ``dtype``; a bool one keeps its stored bytes (0-255),
    as scipy's output array does."""
    if dtype == np.bool_:
        return x.cpu().numpy().astype(np.uint8).view(np.bool_)
    return x.cpu().numpy().astype(dtype)


def _as_tensor(image, dev) -> torch.Tensor:
    """``image`` as float64; a bool image as its bytes, which scipy's
    filters read as numbers."""
    image = np.asarray(image)
    if image.dtype == np.bool_:
        image = image.view(np.uint8)
    return torch.as_tensor(image.astype(np.float64), device=dev)


def _numpy_value(x: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    """What numpy reads from a stored result: a bool's byte as 0 or 1
    (its ``**``, ``+`` and casts to float), anything else as it is."""
    return (x != 0).to(torch.float64) if dtype == np.bool_ else x


def _negate_check(dtype: np.dtype) -> None:
    """The JAX package negates the Laplacian with numpy's unary ``-``,
    which raises ``TypeError`` on bool arrays."""
    np.negative(np.zeros((), dtype))


def _per_axis(value, ndim: int, name: str) -> list:
    """scipy's ``_normalize_sequence``: a scalar for every axis, or one
    value per axis."""
    if isinstance(value, (str, int, float, np.integer, np.floating)):
        return [value] * ndim
    value = list(value)
    if len(value) != ndim:
        raise RuntimeError(f"sequence argument must have length equal to "
                           f"input rank ({name})")
    return value


# -- gaussian filters -------------------------------------------------------------


def _gaussian_kernel1d(sigma: float, order: int, radius: int) -> np.ndarray:
    """``scipy.ndimage._filters._gaussian_kernel1d``, the same float64
    expressions (so the same taps)."""
    if order < 0:
        raise ValueError("order must be non-negative")
    exponent_range = np.arange(order + 1)
    sigma2 = sigma * sigma
    x = np.arange(-radius, radius + 1)
    phi_x = np.exp(-0.5 / sigma2 * x ** 2)
    phi_x = phi_x / phi_x.sum()
    if order == 0:
        return phi_x
    q = np.zeros(order + 1)
    q[0] = 1
    D = np.diag(exponent_range[1:], 1)  # D @ q(x) = q'(x)
    P = np.diag(np.ones(order) / -sigma2, -1)  # P @ q(x) = q(x) * p'(x)
    Q_deriv = D + P
    for _ in range(order):
        q = Q_deriv.dot(q)
    q = (x[:, None] ** exponent_range).dot(q)
    return q * phi_x


def _correlate1d(x: torch.Tensor, weights: np.ndarray, axis: int,
                 mode: str, cval: float) -> torch.Tensor:
    """scipy's ``correlate1d`` on a float64 tensor, summing in the order
    of its C loop (symmetric and antisymmetric taps paired about the
    centre, outermost first)."""
    size = len(weights)
    size1 = size // 2
    size2 = size - size1 - 1
    n = x.shape[axis]
    xp = _pad_axis(x, axis, max(size1, size2), mode, cval)
    base = max(size1, size2)

    def at(k):
        return xp.narrow(axis, base + k, n)

    eps = np.finfo(np.float64).eps
    fw = [float(v) for v in weights]
    c = size1
    symmetric = 0
    if size & 1:
        if all(abs(fw[c + i] - fw[c - i]) <= eps for i in range(1, c + 1)):
            symmetric = 1
        elif all(abs(fw[c + i] + fw[c - i]) <= eps
                 for i in range(1, c + 1)):
            symmetric = -1
    if symmetric:
        out = at(0) * fw[c]
        for j in range(-size1, 0):
            pair = at(j) + at(-j) if symmetric > 0 else at(j) - at(-j)
            out = out + pair * fw[c + j]
        return out
    out = at(size2) * fw[c + size2]
    for j in range(-size1, size2):
        out = out + at(j) * fw[c + j]
    return out


def _gauss(x: torch.Tensor, dtype: np.dtype, sigma, order=0,
           mode="reflect", cval=0.0, truncate=4.0) -> torch.Tensor:
    """``scipy.ndimage.gaussian_filter`` on a float64 tensor holding an
    image of ``dtype``: each pass's result takes ``dtype``'s values."""
    nd = x.ndim
    sigmas = _per_axis(sigma, nd, "sigma")
    orders = _per_axis(order, nd, "order")
    modes = _per_axis(mode, nd, "mode")
    for axis in range(nd):
        s = float(sigmas[axis])
        if s <= 1e-15:
            continue
        if modes[axis] not in _MODES:
            raise RuntimeError("boundary mode not supported")
        lw = int(float(truncate) * s + 0.5)
        weights = _gaussian_kernel1d(s, int(orders[axis]), lw)[::-1]
        x = _cast(_correlate1d(x, weights, axis, modes[axis], float(cval)),
                  dtype)
    return x


def imgaussfilt(image: np.ndarray, sigma, device=None,
                **kwargs) -> np.ndarray:
    """``scipy.ndimage.gaussian_filter(image, sigma, **kwargs)``; the
    keywords are ``order``, ``mode``, ``cval`` and ``truncate``."""
    bad = sorted(set(kwargs) - set(_GAUSS_KWARGS))
    if bad:
        raise TypeError(f"imgaussfilt got unexpected keyword arguments "
                        f"{bad}; it takes {list(_GAUSS_KWARGS)}")
    image = np.asarray(image)
    x = _as_tensor(image, resolve_device(device))
    return _to_numpy(_gauss(x, image.dtype, sigma, **kwargs), image.dtype)


def _laplace(x: torch.Tensor, dtype: np.dtype, sigma) -> torch.Tensor:
    """``scipy.ndimage.gaussian_laplace``: the second derivative along
    each axis in turn, summed in ``dtype``."""
    out = None
    for axis in range(x.ndim):
        order = [0] * x.ndim
        order[axis] = 2
        d2 = _gauss(x, dtype, sigma, order)
        out = d2 if out is None else _cast(out + d2, dtype)
    return out


def imlogfilt(image: np.ndarray, sigma, device=None) -> np.ndarray:
    """Negated Laplacian-of-Gaussian (blob enhancer)."""
    image = np.asarray(image)
    x = _as_tensor(image, resolve_device(device))
    _negate_check(image.dtype)
    return _to_numpy(_cast(-_laplace(x, image.dtype, sigma), image.dtype),
                     image.dtype)


def _root_dtype(dtype: np.dtype) -> Tuple[np.dtype, np.dtype]:
    """numpy's dtypes for ``np.sqrt(a**2 + b**2 ...)`` of arrays in
    ``dtype``: (the squares' and sums', the root's)."""
    sq = (np.zeros(1, dtype) ** 2).dtype  # bool squares to int8
    return sq, np.sqrt(np.zeros(1, sq)).dtype


def _wrapped_int64(x: torch.Tensor) -> torch.Tensor:
    """Integer values held in float64 -> int64 with the same low 64 bits
    (uint64's upper half wraps negative)."""
    return torch.where(x >= 2.0**63, x - 2.0**64, x).to(torch.int64)


def _norm(dtype: np.dtype, *parts: torch.Tensor) -> torch.Tensor:
    """``np.sqrt(a**2 + b**2 ...)`` of ``parts`` stored in ``dtype``, as
    float64 holding the root's numpy dtype.  Float: each step in float64,
    rounded to ``dtype`` (exact emulation of float32 arithmetic).
    Integer: the squares and sums wrap in numpy's integer dtype (int64
    products wrap mod 2**64, which keeps every narrower dtype's low
    bits), and the root is taken of that value."""
    sq, root = _root_dtype(dtype)
    parts = [_numpy_value(p, dtype) for p in parts]
    if dtype in _FLOAT_DTYPES:
        total = _cast(parts[0] * parts[0], dtype)
        for p in parts[1:]:
            total = _cast(total + _cast(p * p, dtype), dtype)
        return _cast(torch.sqrt(total), root)
    total = None
    for p in map(_wrapped_int64, parts):
        total = p * p if total is None else total + p * p
    bits = 8 * sq.itemsize
    if bits < 64:
        total = total & ((1 << bits) - 1)
        if sq.kind == "i":
            total = torch.where(total >= 1 << (bits - 1), total - (1 << bits),
                                total)
        value = total.to(torch.float64)
    elif sq.kind == "u":  # one rounding of the unsigned 64-bit value
        value = (((total >> 32) & 0xFFFFFFFF).to(torch.float64) * 2.0**32
                 + (total & 0xFFFFFFFF).to(torch.float64))
    else:
        value = total.to(torch.float64)
    return _cast(torch.sqrt(value), root)


def imgradmag(image: np.ndarray, sigma, device=None) -> np.ndarray:
    image = np.asarray(image)
    x = _as_tensor(image, resolve_device(device))
    if image.ndim == 2:
        orders = ([0, 1], [1, 0])
    else:
        orders = ([0, 0, 1], [0, 1, 0], [1, 0, 0])
    parts = [_gauss(x, image.dtype, sigma, o) for o in orders]
    return _to_numpy(_norm(image.dtype, *parts), _root_dtype(image.dtype)[1])


# -- morphology --------------------------------------------------------------------


def _disk(radius: int) -> np.ndarray:
    r = int(radius)
    y, x = np.ogrid[-r : r + 1, -r : r + 1]
    return (x * x + y * y) <= r * r


def _ball(radius: int) -> np.ndarray:
    r = int(radius)
    z, y, x = np.ogrid[-r : r + 1, -r : r + 1, -r : r + 1]
    return (x * x + y * y + z * z) <= r * r


def _structural_element(shape, radius):
    return _disk(radius) if len(shape) == 2 else _ball(radius)


def _shifted(xp: torch.Tensor, offset, r: int, shape) -> torch.Tensor:
    """The window of the ``r``-padded ``xp`` shifted by ``offset``."""
    return xp[tuple(slice(r + o, r + o + n) for o, n in zip(offset, shape))]


def _binary(image, footprint: np.ndarray, erode: bool, device):
    """scipy's ``binary_erosion`` / ``binary_dilation`` with
    ``border_value=0``: outside the image counts as 0 for both."""
    img = np.asarray(image)
    if img.ndim != footprint.ndim:
        raise RuntimeError("structure and input must have same "
                           "dimensionality")
    dev = resolve_device(device)
    x = torch.as_tensor(img != 0, device=dev)
    r = footprint.shape[0] // 2
    xp = torch.zeros(tuple(n + 2 * r for n in x.shape), dtype=torch.bool,
                     device=dev)
    xp[tuple(slice(r, r + n) for n in x.shape)] = x
    offsets = np.argwhere(footprint) - r
    if not erode:  # dilation: the reflected structure
        offsets = -offsets
    out = torch.full(x.shape, erode, dtype=torch.bool, device=dev)
    for off in offsets.tolist():
        win = _shifted(xp, off, r, x.shape)
        out = out & win if erode else out | win
    return out.cpu().numpy()


def imerode(image: np.ndarray, radius: int, device=None) -> np.ndarray:
    return _binary(image, _disk(radius), True, device)


def imdilate(image: np.ndarray, radius: int, device=None) -> np.ndarray:
    return _binary(image, _disk(radius), False, device)


def imerode3(image: np.ndarray, radius: int, device=None) -> np.ndarray:
    return _binary(image, _ball(radius), True, device)


def imdilate3(image: np.ndarray, radius: int, device=None) -> np.ndarray:
    return _binary(image, _ball(radius), False, device)


# -- rank filters -------------------------------------------------------------------


def _percentile_rank(percentile: float, size: int) -> int:
    """scipy's ``_rank_filter`` rank of a percentile."""
    if percentile < 0.0:
        percentile += 100.0
    if percentile < 0 or percentile > 100:
        raise RuntimeError("invalid percentile")
    if percentile == 100.0:
        return size - 1
    return int(float(size) * percentile / 100.0)


def _rank_select(image, footprint: np.ndarray, ranks: Sequence[int],
                 device) -> torch.Tensor:
    """The ``ranks``-th smallest values (0-based) of every pixel's
    footprint neighbourhood under ``reflect``: ``[*shape, len(ranks)]``,
    exact (floats as float64, integers as int64)."""
    img = np.asarray(image)
    if img.ndim != footprint.ndim:
        raise RuntimeError("footprint array has incorrect shape")
    dev = resolve_device(device)
    kind = np.float64 if img.dtype.kind in "fc" else np.int64
    x = torch.as_tensor(img.astype(kind), device=dev)
    r = footprint.shape[0] // 2
    xp = x
    for axis in range(x.ndim):
        xp = _pad_axis(xp, axis, r, "reflect")
    offsets = (np.argwhere(footprint) - r).tolist()
    k = len(offsets)
    rest = int(np.prod(x.shape[1:]))
    rows = max(1, _RANK_BLOCK // max(1, k * rest))
    out = torch.empty(tuple(x.shape) + (len(ranks),), dtype=x.dtype,
                      device=dev)
    for a in range(0, x.shape[0], rows):
        b = min(a + rows, x.shape[0])
        block = (b - a,) + tuple(x.shape[1:])
        vals = torch.stack([_shifted(xp[a:], off, r, block)
                            for off in offsets])
        if len(ranks) == 1 and ranks[0] in (0, k - 1):
            picked = [vals.amin(0) if ranks[0] == 0 else vals.amax(0)]
        elif len(ranks) == 1:
            picked = [torch.kthvalue(vals, ranks[0] + 1, dim=0).values]
        else:
            srt = torch.sort(vals, dim=0).values
            picked = [srt[q] for q in ranks]
        out[a:b] = torch.stack(picked, -1)
    return out


def _rank_filter(image, footprint, rank: int, device) -> np.ndarray:
    image = np.asarray(image)
    got = _rank_select(image, footprint, [rank], device)[..., 0]
    return got.cpu().numpy().astype(image.dtype)


def medfilt(image: np.ndarray, radius: int, device=None) -> np.ndarray:
    fp = _structural_element(np.shape(image), radius)
    return _rank_filter(image, fp, int(fp.sum()) // 2, device)


def maxfilt(image: np.ndarray, radius: int, device=None) -> np.ndarray:
    fp = _structural_element(np.shape(image), radius)
    return _rank_filter(image, fp, int(fp.sum()) - 1, device)


def minfilt(image: np.ndarray, radius: int, device=None) -> np.ndarray:
    return _rank_filter(image, _structural_element(np.shape(image), radius),
                        0, device)


def ptlfilt(image: np.ndarray, percentile: float, radius: int,
            device=None) -> np.ndarray:
    fp = _structural_element(np.shape(image), radius)
    return _rank_filter(image, fp, _percentile_rank(percentile,
                                                    int(fp.sum())), device)


# -- feature stacks ----------------------------------------------------------------

_DERIV_NAMES_2D = ["d0", "dx", "dy", "dxx", "dxy", "dyy", "normGrad", "normHessDiag"]
_DERIV_NAMES_3D = [
    "d0", "dx", "dy", "dz", "dxx", "dxy", "dxz", "dyy", "dyz", "dzz",
    "normGrad", "normHessDiag",
]
_LOCAL_PTLS = [10, 30, 50, 70, 90]


def _localstats(image, radius, device) -> torch.Tensor:
    """The five local percentiles, from one sort per block: float64."""
    fp = _structural_element(np.shape(image), radius)
    ranks = [_percentile_rank(p, int(fp.sum())) for p in _LOCAL_PTLS]
    # the values are the image's own, so float64 holds them exactly
    return _rank_select(image, fp, ranks, device).to(torch.float64)


def localstats(image, radius, justfeatnames=False, device=None):
    names = [f"locPtl{p}" for p in _LOCAL_PTLS]
    if justfeatnames:
        return names
    return _localstats(image, radius, device).cpu().numpy()


def _derivatives(x, dtype, sigmas, ndim) -> List[torch.Tensor]:
    """The derivative planes of :func:`imderivatives` (2D) or
    :func:`imderivatives3` (3D), in their order, as float64."""
    planes = []
    for sigma in sigmas:
        def g(order):
            return _numpy_value(_gauss(x, dtype, sigma, order), dtype)

        if ndim == 2:
            dx, dy = g([0, 1]), g([1, 0])
            dxx, dyy = g([0, 2]), g([2, 0])
            planes += [g(0), dx, dy, dxx, g([1, 1]), dyy, _norm(dtype, dx, dy),
                       _norm(dtype, dxx, dyy)]
        else:
            dx, dy, dz = g([0, 0, 1]), g([0, 1, 0]), g([1, 0, 0])
            dxx, dyy, dzz = g([0, 0, 2]), g([0, 2, 0]), g([2, 0, 0])
            planes += [g(0), dx, dy, dz, dxx, g([0, 1, 1]), g([1, 0, 1]),
                       dyy, g([1, 1, 0]), dzz, _norm(dtype, dx, dy, dz),
                       _norm(dtype, dxx, dyy, dzz)]
    return planes


def _stack(planes: List[torch.Tensor]) -> np.ndarray:
    return torch.stack(planes, -1).cpu().numpy()


def imderivatives(image, sigmas: Union[float, list], justfeatnames=False,
                  device=None):
    """Gaussian-derivative feature stack (``:163-195``)."""
    if not isinstance(sigmas, list):
        sigmas = [sigmas]
    if justfeatnames:
        return [
            f"derivSigma{int(s)}{n}" for s in sigmas for n in _DERIV_NAMES_2D
        ]
    image = np.asarray(image)
    x = _as_tensor(image, resolve_device(device))
    return _stack(_derivatives(x, image.dtype, sigmas, 2))


def imderivatives3(image, sigmas: Union[float, list], justfeatnames=False,
                   device=None):
    if not isinstance(sigmas, list):
        sigmas = [sigmas]
    if justfeatnames:
        return [
            f"derivSigma{int(s)}{n}" for s in sigmas for n in _DERIV_NAMES_3D
        ]
    image = np.asarray(image)
    x = _as_tensor(image, resolve_device(device))
    return _stack(_derivatives(x, image.dtype, sigmas, 3))


def _features(image, sigma_deriv, sigma_log, loc_stats_rad, device,
              ndim: int) -> np.ndarray:
    image = np.asarray(image)
    dev = resolve_device(device)
    x = _as_tensor(image, dev)
    planes = _derivatives(x, image.dtype, sigma_deriv, ndim)
    if sigma_log:
        _negate_check(image.dtype)
    planes += [_cast(-_laplace(x, image.dtype, s), image.dtype)
               for s in sigma_log]
    if loc_stats_rad > 1:
        planes += list(_localstats(image, loc_stats_rad, dev).unbind(-1))
    return _stack(planes)


def imfeatures(
    image=None, sigma_deriv=1, sigma_log=1, loc_stats_rad=0,
    justfeatnames=False, device=None,
):
    """Full feature stack: derivatives + LoG + local stats (``:243-268``)."""
    if not isinstance(sigma_deriv, list):
        sigma_deriv = [sigma_deriv]
    if not isinstance(sigma_log, list):
        sigma_log = [sigma_log]
    if justfeatnames:
        return (imderivatives(None, sigma_deriv, justfeatnames=True)
                + [f"logSigma{int(s)}" for s in sigma_log]
                + (localstats(None, loc_stats_rad, True)
                   if loc_stats_rad > 1 else []))
    return _features(image, sigma_deriv, sigma_log, loc_stats_rad, device, 2)


def localstats3(volume, radius, justfeatnames=False, device=None):
    """3D local percentile stack (``:149-161``)."""
    return localstats(volume, radius, justfeatnames, device)


def imfeatures3(
    volume=None, sigma_deriv=2, sigma_log=2, loc_stats_rad=0,
    justfeatnames=False, device=None,
):
    """3D feature stack: derivatives3 + LoG + local stats (``:270-296``)."""
    if not isinstance(sigma_deriv, list):
        sigma_deriv = [sigma_deriv]
    if not isinstance(sigma_log, list):
        sigma_log = [sigma_log]
    if justfeatnames:
        return (imderivatives3(None, sigma_deriv, justfeatnames=True)
                + [f"logSigma{int(s)}" for s in sigma_log]
                + (localstats3(None, loc_stats_rad, True)
                   if loc_stats_rad > 1 else []))
    return _features(volume, sigma_deriv, sigma_log, loc_stats_rad, device,
                     3)


def stack2list(stack: np.ndarray) -> List[np.ndarray]:
    return [stack[..., i] for i in range(stack.shape[-1])]


def thrsegment(image: np.ndarray, ws_blr: float, ws_thr: float,
               device=None) -> np.ndarray:
    """Blur-threshold segmentation (``:306-309``)."""
    blurred = imgaussfilt(image, sigma=(1 - ws_blr) + ws_blr * 5,
                          device=device)
    return blurred > ws_thr
