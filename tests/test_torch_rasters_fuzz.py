"""Files built from each raster format's header, with fields drawn from the
values PIL 12.1 tells apart, and whole files with a byte changed or the
end cut (``tests/fixtures/torch_rasters/make.py``'s writers): the format
``identify.open_image`` names is ``Image.open``'s (or the same exception
escapes), and where PIL opens a format the port reads, or a stub it
cannot load, ``identify.read`` after no seek and after ``seek(0)``,
``seek(1)`` and ``seek(2)`` gives PIL's array (dtype, shape, values) or
its exception class; PSD and Sun raster files also without the native
library.  The examples are derandomized and bounded."""

import importlib.util
import os
import struct
import tempfile
import warnings

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from unmicst_tpu_torch.io import _native, identify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "rasters_make", os.path.join(REPO, "tests", "fixtures", "torch_rasters",
                                 "make.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)
_DIR = tempfile.mkdtemp(prefix="unmicst-rasters-")
_SETTINGS = settings(derandomize=True, deadline=None, max_examples=200,
                     database=None, suppress_health_check=list(HealthCheck))
_NAMES = {"XVThumb": "XVTHUMB"}  # PIL's format name -> its Image.ID key


def _outcome(fn):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = fn()
        return ("ok", r.dtype.str, r.shape,
                (r != 0 if r.dtype == bool else r).tobytes())
    except OSError:
        return "OSError"
    except Exception as e:  # noqa: BLE001
        return type(e).__name__


def _pil(path: str, k):
    def read():
        with Image.open(path) as im:
            if k is not None:
                im.seek(k)
            return np.asarray(im)
    return read


def _agrees(data: bytes):
    """PIL's format (None where it identifies none), after checking the
    port against it (see the module docstring)."""
    path = os.path.join(_DIR, "x.dat")
    with open(path, "wb") as f:
        f.write(data)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(path) as im:
                fmt = _NAMES.get(im.format, im.format)
    except Exception as e:  # noqa: BLE001
        fmt = None if type(e).__name__ == "UnidentifiedImageError" else \
            type(e).__name__
    if fmt in ("BMP", "GIF", "JPEG", "MPO", "PNG", "PPM"):
        return fmt  # the callers' own readers take these by magic bytes
    try:
        mine = identify.open_image(data)
    except Exception as e:  # noqa: BLE001
        mine = type(e).__name__
    assert mine == fmt, (mine, fmt)
    if fmt in identify.READ or fmt in identify.NO_LOADER:
        runs = [None]
        if fmt in ("PSD", "SUN"):
            runs.append(lambda: None)
        for lib in runs:
            saved = _native.get_lib
            if lib is not None:
                _native.get_lib = lib
            try:
                for k in (None, 0, 1, 2):
                    got = _outcome(lambda: identify.read(data, k, "x"))
                    assert got == _outcome(_pil(path, k)), (fmt, k, got)
            finally:
                _native.get_lib = saved
    return fmt


def _changed(draw, data: bytes) -> bytes:
    change = draw(st.sampled_from(["none", "byte", "byte", "cut"]))
    if change == "none" or not data:
        return data
    at = draw(st.integers(0, len(data) - 1))
    if change == "cut":
        return data[:at]
    return data[:at] + bytes([draw(st.integers(0, 255))]) + data[at + 1 :]


_BODY = st.one_of(st.binary(max_size=300),
                  st.lists(st.sampled_from([0x80, 0, 1, 2, 3, 0xFE, 0xFF,
                                            0x81, 9]), max_size=300
                           ).map(bytes))


@st.composite
def _spider_files(draw):
    h, w = draw(st.integers(1, 6)), draw(st.integers(1, 6))
    order = draw(st.sampled_from([">", "<"]))
    frames = [np.arange(h * w, dtype=np.float32).reshape(h, w) * (k + 1)
              for k in range(draw(st.integers(1, 3)))]
    data = mk.spider(frames, order, stack=len(frames) > 1 or draw(
        st.booleans()))
    if draw(st.booleans()):  # one label word drawn
        word = draw(st.sampled_from([5, 24, 26, 27, 12, 2, 13]))
        head = mk.spider_header(h, w, order, **{f"w{word}": draw(
            st.sampled_from([0, 1, 2, 3, -11, 5, 0.5]))})
        data = head + data[len(head) :]
    return _changed(draw, data)


_FITS_CARDS = [("BITPIX", [8, 16, 32, -32, -64, 12, 0]), ("NAXIS", [0, 1, 2,
                                                                    3]),
               ("NAXIS1", [1, 3, 0, -1]), ("NAXIS2", [1, 2, 0]),
               ("ZIMAGE", ["T", "F"]), ("XTENSION", ["'BINTABLE'",
                                                     "'IMAGE   '"]),
               ("ZCMPTYPE", ["'GZIP_1  '", "'RICE_1  '"]),
               ("ZBITPIX", [8, 16, 32, -32]), ("ZNAXIS", [2, 0]),
               ("ZNAXIS1", [2, 3]), ("ZNAXIS2", [2, 1])]


@st.composite
def _fits_files(draw):
    kind = draw(st.sampled_from(["plain", "gzip", "cards"]))
    x = np.arange(6, dtype=np.int32).reshape(2, 3) * 300
    if kind == "plain":
        data = mk.fits(x, draw(st.sampled_from([8, 16, 32, -32, -64])),
                       draw(st.booleans()))
    elif kind == "gzip":
        data = mk.fits_gzip(x, draw(st.sampled_from([8, 16, 32, -32])))
    else:
        cards = [mk.card("SIMPLE", draw(st.sampled_from(["T", "F"])))]
        for _ in range(draw(st.integers(0, 6))):
            key, values = draw(st.sampled_from(_FITS_CARDS))
            cards.append(mk.card(key, draw(st.sampled_from(values))))
        data = b"".join(cards) + (mk.card("END") if draw(st.booleans())
                                  else b"")
        data += b" " * draw(st.sampled_from([0, 2880 - len(data) % 2880]))
        data += draw(_BODY)
    return _changed(draw, data)


@st.composite
def _mcidas_files(draw):
    h, w = draw(st.integers(1, 4)), draw(st.integers(1, 5))
    dt = draw(st.sampled_from([np.uint8, np.uint16, np.int32]))
    data = mk.mcidas(np.arange(h * w, dtype=dt).reshape(h, w) * 3,
                     prefix=draw(st.integers(0, 3)),
                     data_at=draw(st.sampled_from([256, 260])))
    if draw(st.booleans()):
        word = draw(st.sampled_from([10, 14, 33, 8, 9]))
        value = draw(st.sampled_from([0, 1, 2, 3, 4, -1, 300]))
        data = data[: 4 * word] + struct.pack(">i", value) + \
            data[4 * word + 4 :]
    return _changed(draw, data)


@st.composite
def _psd_files(draw):
    h, w = draw(st.integers(1, 5)), draw(st.integers(1, 5))
    mode = draw(st.sampled_from([1, 3, 4, 9, 2, 0, 7, 8, 5]))
    n = {1: 1, 3: draw(st.sampled_from([3, 4])), 4: 4, 9: 3, 2: 1, 0: 1,
         7: 2, 8: 1, 5: 1}[mode]
    depth = 1 if mode == 0 else draw(st.sampled_from([8, 8, 16]))
    row = (w + 7) // 8 if depth == 1 else w
    planes = [(np.arange(h * row, dtype=np.uint8).reshape(h, row) * (k + 3))
              for k in range(n)]
    layers = []
    for k in range(draw(st.integers(0, 3))):
        ids = draw(st.sampled_from([[0], [0, 1, 2], [-1, 0, 1, 2], [1],
                                    [0, 1]]))
        lh, lw = draw(st.integers(1, 3)), draw(st.integers(1, 3))
        # a box above or left of the canvas makes PIL write outside its
        # image (undefined; it may crash the process): not drawn
        top, left = draw(st.integers(0, 4)), draw(st.integers(0, 4))
        layers.append((top, left, ids, [np.full((lh, lw), 40 + k, np.uint8)
                                        ^ np.uint8(c) for c in
                                        range(len(ids))], b"L%d" % k))
    data = mk.psd(planes, mode, depth, draw(st.sampled_from([0, 1, 1, 2])),
                  layers=layers, palette=draw(st.sampled_from(
                      [b"", bytes(768)])), resources=draw(st.sampled_from(
                          [b"", mk.psd_resource(1039, b"icc", b"xyz")])))
    return _changed(draw, data)


@st.composite
def _sun_files(draw):
    h, w = draw(st.integers(1, 4)), draw(st.integers(1, 9))
    depth = draw(st.sampled_from([1, 4, 8, 24, 32, 2, 16]))
    ftype = draw(st.sampled_from([0, 1, 2, 2, 3, 4, 5, 6]))
    rows = np.arange(h * ((w * depth + 7) // 8), dtype=np.uint8).reshape(
        h, -1) * 37
    rle = draw(st.one_of(st.none(), _BODY)) if ftype == 2 else None
    palette = draw(st.sampled_from([b"", bytes(range(12)), bytes(1100)]))
    data = mk.sun(rows, w, depth, ftype, palette, rle)
    if palette and draw(st.booleans()):  # the colour map's type
        data = data[:24] + struct.pack(">I", 2) + data[28:]
    return _changed(draw, data)


@st.composite
def _small_files(draw, kind):
    """A PIXAR, XV thumbnail, XPM, IMT, GBR or IPTC file (``kind``)."""
    h, w = draw(st.integers(1, 4)), draw(st.integers(1, 5))
    x = np.arange(h * w * 4, dtype=np.uint8).reshape(h, w, 4) * 11
    if kind == "pixar":
        data = mk.pixar(x[..., :3], draw(st.sampled_from([(14, 2),
                                                          (14, 1)])))
    elif kind == "xvthumb":
        data = mk.xvthumb(x[..., 0], draw(st.sampled_from(
            [(), (b"#a",), (b"#x", b"#y")])))
    elif kind == "xpm":
        n = draw(st.sampled_from([2, 3, 300]))
        cols = ["#%06x" % (k * 7919) for k in range(n)]
        if draw(st.booleans()):
            cols[0] = draw(st.sampled_from(["None", "red"]))
        data = mk.xpm(x[..., 0].astype(int) % n, cols, cpp=2 if n > 90 else
                      draw(st.sampled_from([1, 2])),
                      pixels_comment=draw(st.booleans()))
    elif kind == "imt":
        data = mk.imt(x[..., 0], draw(st.sampled_from(
            [b"", b"* c\n", b"bad line!\n", b"pixel n16\n"])))
    elif kind == "gbr":
        data = mk.gbr(x if draw(st.booleans()) else x[..., 0],
                      draw(st.sampled_from([1, 2])),
                      draw(st.sampled_from([b"b", b""])))
    else:
        data = mk.iptc(x[..., 0].tobytes(), w, h,
                       *draw(st.sampled_from([(1, 0), (3, 1), (4, 1),
                                              (2, 0)])),
                       band=draw(st.sampled_from([None, 1, 3, 0])),
                       compression=draw(st.sampled_from([1, 1, 2])),
                       chunk=draw(st.sampled_from([0, 5])))
    return _changed(draw, data)


@st.composite
def _stub_files(draw):
    """BUFR, GRIB, HDF5 and MPEG heads, and placeable WMF and EMF headers
    with their fields drawn."""
    kind = draw(st.sampled_from(["stub", "wmf", "emf"]))
    if kind == "stub":
        head = draw(st.sampled_from([b"BUFR", b"ZCZC", b"GRIB\0\0\0\x01",
                                     b"GRIB\0\0\0\x02",
                                     b"\x89HDF\r\n\x1a\n",
                                     b"\0\0\1\xb3\x10\x01\x00"]))
        return head + draw(st.binary(max_size=20))
    if kind == "wmf":
        x0, x1 = draw(st.sampled_from([(0, 100), (100, 0), (0, 1)]))
        s = b"\xd7\xcd\xc6\x9a\0\0" + struct.pack(
            "<hhhhH", x0, 0, x1, 50, draw(st.sampled_from([72, 0, 1440])))
        s += bytes(6) + draw(st.sampled_from([b"\x01\x00\t\x00",
                                              b"\x02\x00\t\x00"]))
        return _changed(draw, s + bytes(30))
    frame = draw(st.sampled_from([(0, 0, 100, 90), (0, 0, 0, 90),
                                  (0, 0, 50, 50)]))
    s = b"\x01\0\0\0" + bytes(4) + struct.pack(
        "<8i", 0, 0, draw(st.sampled_from([10, 0, -3])), 12, *frame)
    s += draw(st.sampled_from([b" EMF", b" XYZ"])) + bytes(8)
    return _changed(draw, s)


_STRATEGIES = {"spider": _spider_files(), "fits": _fits_files(),
               "mcidas": _mcidas_files(), "psd": _psd_files(),
               "sun": _sun_files(), "stubs": _stub_files(),
               **{k: _small_files(k) for k in ("pixar", "xvthumb", "xpm",
                                               "imt", "gbr", "iptc")}}
_REACHES = {"stubs": {"BUFR", "GRIB", "HDF5", "MPEG", "WMF"}}


@pytest.mark.parametrize("strategy", sorted(_STRATEGIES))
def test_readers_match_pil(strategy):
    """See the module docstring; each strategy reaches its formats."""
    assert _native.get_lib() is not None, "the native library did not load"

    @_SETTINGS
    @given(_STRATEGIES[strategy])
    def check(data):
        seen.add(_agrees(data))

    seen = set()
    check()
    reach = _REACHES.get(strategy, {strategy.upper()})
    assert reach <= seen, reach - seen
