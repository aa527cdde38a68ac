"""Pillow's resampler in the port (``unmicst_tpu_torch/io/resample.py``,
``native/resample.cpp``), which the toolbox's ICO and ICNS writes reach,
against PIL 12's ``Image.resize`` and ``Image.thumbnail`` (the JAX
package reaches them through ``Image.fromarray(x).save``): NEAREST on
mode ``1``, BICUBIC and LANCZOS on every other mode ``fromarray`` gives,
0 levels apart; the native passes and premultiply equal to their numpy
versions, also where the library is missing; the 4096^2 shapes of
``chip_smoke.py`` once in a band."""

import numpy as np
import pytest
from PIL import Image

from unmicst_tpu_torch.io import _native, png
from unmicst_tpu_torch.io import resample as R

KINDS = ("bool", "uint8", "la", "rgb", "rgba", "uint16", "uint16be",
         "int16", "int32", "float32", "float64")


def _array(kind: str, rng, h: int, w: int) -> np.ndarray:
    if kind == "bool":
        return rng.rand(h, w) < 0.5
    if kind in ("uint8", "la", "rgb", "rgba"):
        bands = {"uint8": (), "la": (2,), "rgb": (3,), "rgba": (4,)}[kind]
        return rng.randint(0, 256, (h, w) + bands).astype(np.uint8)
    if kind in ("uint16", "uint16be"):
        return rng.randint(0, 65536, (h, w)).astype(
            np.uint16 if kind == "uint16" else ">u2")
    if kind == "int16":
        return rng.randint(-999, 999, (h, w)).astype(np.int16)
    if kind == "int32":
        return rng.randint(-2**31, 2**31, (h, w)).astype(np.int32)
    return rng.standard_normal((h, w)).astype(kind)


def _same(want: np.ndarray, got: np.ndarray) -> bool:
    """PIL's array and the port's hold the same values in the same dtype
    (mode ``1`` in :func:`png.array_mode`'s layout: 0/1 uint8)."""
    if want.dtype == bool:
        if got.dtype != np.uint8:
            return False
        want, got = want != 0, got != 0
    return got.dtype == want.dtype and want.shape == got.shape and \
        np.array_equal(want, got, equal_nan=want.dtype.kind == "f")


def _sizes(rng, n: int):
    """``n`` (input (h, w), output (width, height)) pairs: sides of 1 to
    300 in and 1 to 1024 out, up and down, with the extremes once."""
    out = [((1, 1), (1, 1)), ((300, 1), (7, 1024)), ((1, 300), (1024, 2)),
           ((17, 23), (23, 17))]
    while len(out) < n:
        h, w = (int(v) for v in rng.randint(1, 301, 2))
        ow = int(rng.choice([rng.randint(1, 40), rng.randint(1, 1025)]))
        oh = int(rng.randint(1, 1 + max(1, 30_000 // ow)))
        out.append(((h, w), (ow, oh)))
    return out


@pytest.mark.parametrize("filt", [R.BICUBIC, R.LANCZOS])
@pytest.mark.parametrize("kind", KINDS)
def test_resize_is_pils(kind, filt, monkeypatch):
    """``Image.fromarray(x).resize(size, filt)`` (NEAREST for mode ``1``,
    as ``resize`` forces): the same dtype, shape and values, through the
    native library and without it."""
    rng = np.random.RandomState(KINDS.index(kind) * 7 + filt)
    cases = _sizes(rng, 10)
    for native in (True, False):
        if not native:
            monkeypatch.setattr(_native, "get_lib", lambda: None)
        for (h, w), size in cases:
            x = _array(kind, rng, h, w)
            want = np.asarray(Image.fromarray(x).resize(size, filt))
            mode, px = png.array_mode(x)
            got = R.resize(px, mode, size, filt)
            assert _same(want, got), \
                (kind, (h, w), size, native)


@pytest.mark.parametrize("kind", ["float32", "uint8"])
def test_resize_of_odd_values_and_empty_images(kind):
    """Infinities and NaN in mode ``F`` spread as in PIL; an image with no
    rows or columns resizes to PIL's array."""
    rng = np.random.RandomState(5)
    x = _array(kind, rng, 20, 30)
    if kind == "float32":
        x[3, 4], x[7, 9], x[10, :] = np.inf, np.nan, -np.inf
    for filt in (R.BICUBIC, R.LANCZOS):
        for size in ((7, 5), (60, 41), (30, 9)):
            want = np.asarray(Image.fromarray(x).resize(size, filt))
            mode, px = png.array_mode(x)
            assert _same(want, R.resize(px, mode, size, filt)), size
    for shape in ((0, 14), (9, 0)):
        e = np.zeros(shape, x.dtype)
        want = np.asarray(Image.fromarray(e).resize((32, 32)))
        mode, px = png.array_mode(e)
        assert _same(want, R.resize(px, mode, (32, 32))), shape


@pytest.mark.parametrize("kind", ["bool", "uint8", "la", "rgba", "uint16",
                                  "int32", "float32"])
def test_thumbnail_is_pils(kind):
    """``thumbnail(size, LANCZOS, reducing_gap=None)``, as ICO's save
    calls it: the aspect kept by ``round_aspect``, images that already
    fit left as they are."""
    rng = np.random.RandomState(len(kind))
    shapes = [(9, 14), (40, 300), (300, 40), (257, 260), (16, 16),
              (24, 100), (15, 200), (128, 129), (3, 250), (250, 3)]
    for h, w in shapes:
        x = _array(kind, rng, h, w)
        mode, px = png.array_mode(x)
        for side in (16, 24, 48, 256):
            im = Image.fromarray(x)
            im.thumbnail((side, side), Image.Resampling.LANCZOS,
                         reducing_gap=None)
            want = np.asarray(im)
            got = R.thumbnail(px, mode, (side, side), R.LANCZOS)
            assert _same(want, got), \
                (kind, (h, w), side)


@pytest.mark.parametrize("kind", [R.U8, R.U16, R.I32, R.F32])
@pytest.mark.parametrize("axis", [0, 1])
def test_native_pass_equals_numpy(kind, axis):
    """``native/resample.cpp``'s pass equals :func:`resample.pass_py`
    bit for bit, with the same coefficients, over random channels and
    row windows."""
    rng = np.random.RandomState(kind * 2 + axis)
    dtype = {R.U8: np.uint8, R.U16: "<u2", R.I32: np.int32,
             R.F32: np.float32}[kind]
    for _ in range(12):
        h, w = (int(v) for v in rng.randint(1, 90, 2))
        c = int(rng.choice([1, 2, 3, 4]))
        if kind in (R.U8, R.U16):
            top = 256 if kind == R.U8 else 65536
            src = rng.randint(0, top, (h, w, c)).astype(dtype)
        elif kind == R.I32:
            src = rng.randint(-2**31, 2**31, (h, w, c)).astype(dtype)
        else:
            src = (rng.standard_normal((h, w, c)) * 1e3).astype(dtype)
        out = int(rng.randint(1, 120))
        xmin, xmax, k = R.coeffs(w if axis else h, out,
                                 int(rng.choice([R.BICUBIC, R.LANCZOS])))
        if kind == R.U8:
            k = R.fixed_point(k)
        offset = int(rng.randint(0, h)) if axis else 0
        rows = int(rng.randint(1, h - offset + 1)) if axis else None
        got = _native.resample_pass(src, axis, xmin, xmax, k, kind, offset,
                                    rows)
        want = R.pass_py(src, axis, xmin, xmax, k, kind, offset, rows)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), (h, w, c, out)


@pytest.mark.parametrize("channels", [2, 4])
def test_native_premultiply_equals_numpy(channels):
    """The premultiply around LA and RGBA resizes and its undoing, native
    and numpy, over every (colour, alpha) pair."""
    c, a = np.meshgrid(np.arange(256), np.arange(256))
    px = np.zeros((256, 256, channels), np.uint8)
    px[..., :-1] = c[..., None]
    px[..., -1] = a
    for inverse, plain in ((False, R.premultiply_py),
                           (True, R.unpremultiply_py)):
        got = _native.alpha_multiply(px, inverse)
        assert np.array_equal(got, plain(px)), inverse


def test_slide_shapes_in_a_band(monkeypatch):
    """The card's 4096^2 runs: LANCZOS to 16^2 and BICUBIC to 1024^2 of a
    gray plane, native, numpy (in bands of taps, no ``[rows, out, taps]``
    gather) and PIL equal."""
    rng = np.random.RandomState(25)
    x = rng.randint(0, 256, (4096, 4096)).astype(np.uint8)
    for size, filt in (((16, 16), R.LANCZOS), ((1024, 1024), R.BICUBIC)):
        want = np.asarray(Image.fromarray(x).resize(size, filt))
        assert np.array_equal(R.resize(x, "L", size, filt), want), size
        with monkeypatch.context() as m:
            m.setattr(_native, "get_lib", lambda: None)
            assert np.array_equal(R.resize(x, "L", size, filt), want), size


def test_coefficients_are_pils_at_every_scale():
    """The 8-bit taps at scales from 1/300 to 1024: each row's integers
    sum to within its tap count of ``1 << 22`` and PIL's resize of a
    one-hot row picks them out (0 levels at every output)."""
    for n_in, n_out in ((1, 1024), (3, 1000), (300, 1), (300, 7), (97, 300)):
        for filt in (R.BICUBIC, R.LANCZOS):
            xmin, xmax, k = R.coeffs(n_in, n_out, filt)
            k8 = R.fixed_point(k)
            assert np.all(np.abs(k8.sum(1) - (1 << 22)) <= xmax + 1)
            x = np.zeros((1, n_in), np.uint8)
            x[0, n_in // 2] = 255
            want = np.asarray(Image.fromarray(x).resize((n_out, 1), filt))
            assert np.array_equal(R.resize(x, "L", (n_out, 1), filt), want)
