"""The port's toolbox (``unmicst_tpu_torch/utils/imtools.py``, ROADMAP
M14e) against ``unmicst_tpu.utils.imtools`` (scipy, PIL) on the same
seeded inputs, on the CPU: rank filters, morphology and nearest resizes
bit-equal; float64 filters, features and ``imresize3_double`` at rtol
1e-10, atol 1e-12; uint8, uint16 and float32 gaussians equal."""

import inspect
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch.io import _native, png
from unmicst_tpu_torch.utils import imtools as T

CPU = "cpu"
MODES = ["reflect", "mirror", "nearest", "wrap", "constant"]
ORDERS = [0, [0, 1], [1, 0], [2, 0], [1, 1], [0, 3]]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def rng():
    return np.random.RandomState(11)


def test_every_name_with_its_signature():
    """The JAX toolbox's public functions all exist, their parameters
    first and in order; the one addition is ``device``."""
    names = sorted(n for n, f in vars(J).items()
                   if inspect.isfunction(f) and not n.startswith("_"))
    assert len(names) == 35
    for name in names:
        want = list(inspect.signature(getattr(J, name)).parameters.values())
        got = list(inspect.signature(getattr(T, name)).parameters.values())
        plain = [p for p in got if p.name != "device"]
        assert [(p.name, p.kind, p.default) for p in plain] == [
            (p.name, p.kind, p.default) for p in want], name
        if len(got) > len(plain):
            assert got[[p.name for p in got].index("device")].default is None


@pytest.mark.parametrize("mode", MODES)
def test_gaussian_modes_orders_sigmas(rng, mode):
    """Every boundary mode, derivative order and sigma (6 makes the radius
    24, wider than the 23-row axis: repeated folds)."""
    x = rng.rand(23, 31)
    for sigma in (0.7, 2.5, 6):
        for order in ORDERS:
            kw = dict(order=order, mode=mode, cval=0.3)
            _close(T.imgaussfilt(x, sigma, device=CPU, **kw),
                   J.imgaussfilt(x, sigma, **kw))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_gaussian_keeps_the_input_dtype(rng, dtype):
    """scipy stores each pass in the input's dtype (integers truncate):
    the port's results are equal, not close."""
    top = {np.uint8: 255, np.uint16: 65535, np.float32: 1}[dtype]
    x = (rng.rand(40, 50) * top).astype(dtype)
    for sigma in (0.8, 1.5, (2.5, 0.5)):
        _equal(T.imgaussfilt(x, sigma, device=CPU), J.imgaussfilt(x, sigma))
    _equal(T.imlogfilt(x, 2, device=CPU), J.imlogfilt(x, 2))


def test_gaussian_3d_per_axis_and_truncate(rng):
    v = rng.rand(9, 10, 11)
    for sigma, mode in (((1.0, 0.0, 2.0), ["reflect", "wrap", "nearest"]),
                        (1.5, "mirror")):
        _close(T.imgaussfilt(v, sigma, device=CPU, mode=mode, truncate=2.5),
               J.imgaussfilt(v, sigma, mode=mode, truncate=2.5))
    _close(T.imlogfilt(v, 1.5, device=CPU), J.imlogfilt(v, 1.5))


def test_gaussian_derivative_sign_on_a_ramp():
    """``gaussian_filter1d`` correlates with the kernel reversed: on a
    ramp rising along columns, dx is positive in both packages."""
    ramp = np.tile(np.arange(40, dtype=np.float64), (30, 1))
    got = T.imgaussfilt(ramp, 2, device=CPU, order=[0, 1])
    _close(got, J.imgaussfilt(ramp, 2, order=[0, 1]))
    # the taps, truncated at 4 sigma, sum to 0.99965
    np.testing.assert_allclose(got[:, 10:30], 1.0, atol=1e-3)
    dy = T.imgaussfilt(ramp.T.copy(), 2, device=CPU, order=[1, 0])
    np.testing.assert_allclose(dy[10:30], 1.0, atol=1e-3)


def test_gaussian_refuses_other_keywords(rng):
    x = rng.rand(8, 8)
    with pytest.raises(TypeError, match="radius"):
        T.imgaussfilt(x, 1, device=CPU, radius=3)
    with pytest.raises(RuntimeError, match="boundary mode"):
        T.imgaussfilt(x, 1, device=CPU, mode="bogus")


def test_gradmag_float(rng):
    x, v = rng.rand(30, 26), rng.rand(8, 9, 10)
    _close(T.imgradmag(x, 2, device=CPU), J.imgradmag(x, 2))
    _close(T.imgradmag(v, 1, device=CPU), J.imgradmag(v, 1))


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.uint16, np.int16,
                                   np.int32, np.uint32])
def test_gradmag_and_features_on_integer_images(rng, dtype):
    """Integer images as numpy and scipy treat them: derivatives stored in
    the dtype, squares and sums wrapping, numpy's float type for the
    root (NaN where a signed sum went negative).  float16 and float32
    roots are equal; float64 ones (32-bit images, and every stack) are
    held at the float64 bar, since torch's CPU ``sqrt`` may differ from
    the correctly rounded one by an ulp."""
    info = np.iinfo(dtype)
    top = min(int(info.max), 1 << 20)
    x = rng.randint(max(int(info.min), -top), top + 1, (20, 18)).astype(dtype)
    v = x[:9, :9].reshape(9, 9, 1).repeat(6, 2)

    def same(got, want):
        (_close if want.dtype == np.float64 else _equal)(got, want)

    with np.errstate(invalid="ignore"):
        for img, sigma in ((x, 2), (v, 1)):
            got = T.imgradmag(img, sigma, device=CPU)
            want = J.imgradmag(img, sigma)
            assert want.dtype == np.sqrt(np.zeros(1, dtype)).dtype
            same(got, want)
        same(T.imfeatures(x, [1, 2], [1], 3, device=CPU),
             J.imfeatures(x, [1, 2], [1], 3))
        same(T.imfeatures3(v, 1, 1, device=CPU), J.imfeatures3(v, 1, 1))


@pytest.mark.parametrize("name", ["medfilt", "maxfilt", "minfilt"])
def test_rank_filters_bit_equal(rng, name, monkeypatch):
    """Disk and ball footprints under reflect, float64 and uint16, on a
    plane smaller than the radius, and in blocks of a few rows."""
    x = rng.rand(23, 31)
    u16 = (rng.rand(20, 24) * 65535).astype(np.uint16)
    v = rng.rand(9, 10, 11)
    tiny = rng.rand(3, 4)
    ours, theirs = getattr(T, name), getattr(J, name)
    for img, r in ((x, 3), (u16, 2), (v, 2), (tiny, 5)):
        _equal(ours(img, r, device=CPU), theirs(img, r))
    monkeypatch.setattr(T, "_RANK_BLOCK", 29 * 31 * 4)
    _equal(ours(x, 3, device=CPU), theirs(x, 3))


def test_percentiles_and_local_stats(rng, monkeypatch):
    x = rng.rand(23, 31)
    for p in (0, 10, 37.5, 50, 90, 100, -20):
        _equal(T.ptlfilt(x, p, 3, device=CPU), J.ptlfilt(x, p, 3))
    _equal(T.localstats(x, 3, device=CPU), J.localstats(x, 3))
    v = rng.rand(9, 10, 11)
    _equal(T.localstats3(v, 2, device=CPU), J.localstats3(v, 2))
    monkeypatch.setattr(T, "_RANK_BLOCK", 1000)
    _equal(T.localstats(x, 3, device=CPU), J.localstats(x, 3))
    assert T.localstats(None, 3, True) == J.localstats(None, 3, True)


def test_morphology_bit_equal(rng):
    """``border_value=0``: a footprint reaching outside erodes the pixel
    (the border rows), and dilation sees nothing outside."""
    b = rng.rand(30, 34) > 0.4
    for r in (1, 3, 6):
        _equal(T.imerode(b, r, device=CPU), J.imerode(b, r))
        _equal(T.imdilate(b, r, device=CPU), J.imdilate(b, r))
    assert not T.imerode(np.ones((9, 9), bool), 2, device=CPU)[0].any()
    bv = rng.rand(9, 10, 11) > 0.5
    for r in (1, 2):
        _equal(T.imerode3(bv, r, device=CPU), J.imerode3(bv, r))
        _equal(T.imdilate3(bv, r, device=CPU), J.imdilate3(bv, r))
    u8 = (rng.rand(20, 20) * 3).astype(np.uint8)  # nonzero counts as set
    _equal(T.imdilate(u8, 2, device=CPU), J.imdilate(u8, 2))


def test_resizes(rng):
    img = (rng.rand(37, 41) * 255).astype(np.uint8)
    for shape in ((10, 4), (80, 90), (37, 41), (5, 129)):
        _equal(T.imresize_uint8(img, shape), J.imresize_uint8(img, shape))
        _close(T.imresize_double(img, shape), J.imresize_double(img, shape))
    vol = (rng.rand(9, 12, 7) * 255).astype(np.uint8)
    _equal(T.imresize3_uint8(vol, (5, 6, 3)), J.imresize3_uint8(vol, (5, 6,
                                                                      3)))
    volf = rng.rand(6, 8, 5)
    for shape in ((12, 4, 10), (6, 8, 5), (1, 17, 2)):
        _close(T.imresize3_double(volf, shape, device=CPU),
               J.imresize3_double(volf, shape))
    flat = rng.rand(1, 4, 3)  # an axis of one sample
    _close(T.imresize3_double(flat, (3, 2, 6), device=CPU),
           J.imresize3_double(flat, (3, 2, 6)))


def test_feature_stacks(rng):
    x = rng.rand(24, 28)
    _close(T.imderivatives(x, [1, 2], device=CPU), J.imderivatives(x, [1,
                                                                       2]))
    _close(T.imfeatures(x, [1, 2], [1, 2], 3, device=CPU),
           J.imfeatures(x, [1, 2], [1, 2], 3))
    _close(T.imfeatures(x, device=CPU), J.imfeatures(x))
    _equal(T.imfeatures(x.astype(np.float32), 2, 2, 2, device=CPU),
           J.imfeatures(x.astype(np.float32), 2, 2, 2))
    v = rng.rand(8, 9, 10)
    _close(T.imderivatives3(v, [1, 2], device=CPU), J.imderivatives3(v, [1,
                                                                        2]))
    _close(T.imfeatures3(v, 2, 2, 2, device=CPU), J.imfeatures3(v, 2, 2, 2))
    for kw in (dict(loc_stats_rad=2), dict(sigma_deriv=[1, 3], sigma_log=4)):
        assert T.imfeatures(justfeatnames=True, **kw) == J.imfeatures(
            justfeatnames=True, **kw)
        assert T.imfeatures3(justfeatnames=True, **kw) == J.imfeatures3(
            justfeatnames=True, **kw)
    assert T.imderivatives3(None, 2, True) == J.imderivatives3(None, 2, True)


def test_small_helpers(rng):
    x = rng.rand(10, 12) * 5 + 2
    _equal(T.normalize(x), J.normalize(x))
    _equal(T.snormalize(x), J.snormalize(x))
    const = np.ones((4, 4))
    assert T.normalize(const) is const and T.snormalize(const) is const
    _equal(T.cat(1, x, x), J.cat(1, x, x))
    assert T.size(x) == J.size(x)
    stack = rng.rand(5, 6, 3)
    for a, b in zip(T.stack2list(stack), J.stack2list(stack)):
        _equal(a, b)
    u8 = (rng.rand(30, 30) * 255).astype(np.uint8)
    _equal(T.im2double(u8), J.im2double(u8))
    blob = np.zeros((20, 20))
    blob[8:12, 8:12] = 1.0
    for img in (blob, (blob * 200).astype(np.uint8)):
        _equal(T.thrsegment(img, 0.1, 0.3, device=CPU),
               J.thrsegment(img, 0.1, 0.3))


# -- files -------------------------------------------------------------------------


def _png_with_filters(path, img):
    """A gray 8-bit PNG whose rows cycle through filter types 0-4 (PIL
    never writes type 3)."""
    h, w = img.shape
    prior = np.zeros(w, np.int32)
    rows = b""
    for y in range(h):
        kind = y % 5
        cur = img[y].astype(np.int32)
        left = np.concatenate([[0], cur[:-1]])
        upleft = np.concatenate([[0], prior[:-1]])
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - prior
        elif kind == 3:
            f = cur - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
            f = cur - pred
        rows += bytes([kind]) + (f % 256).astype(np.uint8).tobytes()
        prior = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_png_unfilter_native_equals_python(rng, bpp):
    """The native row-filter undo and the Python one: the same bytes for
    every filter type, in random order, and the same refusal of type 5."""
    assert _native.get_lib() is not None, "the native library did not load"
    rows = rng.randint(0, 256, (40, 1 + 13 * bpp)).astype(np.uint8)
    rows[:, 0] = rng.randint(0, 5, 40)
    _equal(_native.png_unfilter(rows, bpp), png._unfilter_py(rows, bpp))
    rows[17, 0] = 5
    for undo in (_native.png_unfilter, png._unfilter_py):
        with pytest.raises(ValueError, match="row filter type 5"):
            undo(rows, bpp)


@pytest.mark.parametrize("library", [True, False])
def test_png_read_and_write(tmp_path, rng, monkeypatch, library):
    if not library:
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    cases = {
        "g8": (rng.rand(37, 53) * 255).astype(np.uint8),
        "g16": (rng.rand(37, 53) * 65535).astype(np.uint16),
        "rgb": (rng.rand(21, 17, 3) * 255).astype(np.uint8),
        "rgba": (rng.rand(21, 17, 4) * 255).astype(np.uint8),
    }
    for name, img in cases.items():
        path = str(tmp_path / f"{name}.png")
        Image.fromarray(img).save(path)  # PIL's adaptive row filters
        _equal(T.imread(path), J.imread(path))
        if img.ndim == 2 or img.shape[2] == 3:
            ours = str(tmp_path / f"{name}_port.png")
            T.imwrite(img, ours)
            _equal(J.imread(ours), img)
    path = str(tmp_path / "filters.png")
    img = (rng.rand(23, 29) * 255).astype(np.uint8)
    _png_with_filters(path, img)
    _equal(T.imread(path), J.imread(path))
    _equal(T.imread(path), img)
    blob = open(path, "rb").read()  # the same header, interlaced
    ihdr = bytearray(blob[12:29])
    ihdr[-1] = 1
    with open(str(tmp_path / "i.png"), "wb") as f:
        f.write(blob[:12] + bytes(ihdr) + struct.pack(
            ">I", zlib.crc32(bytes(ihdr)) & 0xFFFFFFFF) + blob[33:])
    Image.fromarray(img).convert("P").save(str(tmp_path / "p.png"))
    p_png = str(tmp_path / "p.png")
    _equal(T.imread(p_png), J.imread(p_png))
    with pytest.raises(OSError):  # not interlaced data under the flag
        J.imread(str(tmp_path / "i.png"))
    with pytest.raises(ValueError, match="corrupt PNG"):
        T.imread(str(tmp_path / "i.png"))


def test_tiff_jpeg_and_refused_formats(tmp_path, rng):
    x = (rng.rand(30, 40) * 65535).astype(np.uint16)
    p = str(tmp_path / "x.tif")
    T.tifwrite(x, p)
    _equal(J.tifread(p), x)
    _equal(T.tifread(p), x)
    T.imwrite(x, str(tmp_path / "y.tiff"))
    _equal(J.imread(str(tmp_path / "y.tiff")), x)
    jp = str(tmp_path / "g.jpg")
    Image.fromarray((x >> 8).astype(np.uint8)).save(jp, quality=90)
    got, want = T.imread(jp), J.imread(jp)
    assert got.dtype == want.dtype and np.abs(
        got.astype(int) - want.astype(int)).max() <= 1
    for name in ("g.bmp", "g.gif", "g.webp"):
        Image.fromarray((x >> 8).astype(np.uint8)).save(str(tmp_path / name))
        if name in ("g.bmp", "g.gif"):  # BMP and GIF read and write as PIL's
            _equal(T.imread(str(tmp_path / name)),
                   J.imread(str(tmp_path / name)))
            T.imwrite((x >> 8).astype(np.uint8), str(tmp_path / f"o{name}"))
            J.imwrite((x >> 8).astype(np.uint8), str(tmp_path / f"j{name}"))
            _equal(J.imread(str(tmp_path / f"o{name}")),
                   J.imread(str(tmp_path / f"j{name}")))
            if name == "g.bmp":  # a GIF reads back as its palette's ranks
                _equal(J.imread(str(tmp_path / f"o{name}")),
                       (x >> 8).astype(np.uint8))
            continue
        with pytest.raises(NotImplementedError, match=name[1:]):
            T.imread(str(tmp_path / name))
        with pytest.raises(NotImplementedError, match="M17"):
            T.imwrite((x >> 8).astype(np.uint8), str(tmp_path / f"o{name}"))


def test_imshow_writes_a_png(tmp_path, rng, monkeypatch):
    """The JAX package's headless contract: the figure goes to ``out``
    (default ``imshow.png`` / ``imshowlist.png``) and the path returns."""
    x = rng.rand(8, 10) * 7 - 3
    p1 = T.imshow(x, out=str(tmp_path / "a.png"), cmap="gray")
    shown = png.read_png(p1)
    assert shown.shape == (8, 10) and shown.min() == 0 and shown.max() == 255
    np.testing.assert_array_equal(np.argsort(shown, None, "stable"),
                                  np.argsort(np.round(T.normalize(x) * 255),
                                             None, "stable"))
    p2 = T.imshowlist([x, x[:5], np.zeros((3, 3))],
                      out=str(tmp_path / "b.png"))
    assert png.read_png(p2).shape == (8, 10 + 4 + 10 + 4 + 3)
    monkeypatch.chdir(tmp_path)
    assert T.imshow(x) == "imshow.png" and os.path.getsize("imshow.png") > 0
    assert T.imshowlist([x, np.stack([x] * 3, -1)]) == "imshowlist.png"
    assert png.read_png("imshowlist.png").shape == (8, 24, 3)
