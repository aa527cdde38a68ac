"""Icons and textures PIL 12.1 reads itself (``unmicst_tpu_torch/io/
ico.py``, ``icns.py``, ``blp.py``, ``ftex.py``, ``dds.py`` through
``bcn.py``, ``fli.py``; EPS's header checks in ``eps.py``; IPTC records
that hold a colour JPEG or an image of another size in ``iptc.py``)
against PIL, which the JAX package reaches for them: the TIFF
fallback's ``Image.open`` and ``seek(channel)``
(``unmicst_tpu/io/slides.py:66-89``, ``io/tiff.py:1273-1291``) and the
toolbox's ``imread`` without a seek (``utils/imtools.py:48-56``).

The committed fixtures (``tests/fixtures/torch_icons/make.py``) read as
PIL's recorded arrays after no seek and after every seek, or raise its
recorded exception classes, with and without the native library; the
entry points of both packages agree on every fixture under a TIFF name
and under its own; files PIL itself writes (ICO, ICNS, BLP, DDS in its
block formats) read as PIL reads them; the 4096^2 recipe of
``chip_smoke.py`` reads as PIL at 512^2.  EPS: PIL needs Ghostscript
for the pixels, so where PIL opens a file as EPS the port refuses its
frame 0 naming ROADMAP M17 (PIL's ``EOFError`` past it).
"""

import importlib.util
import io
import json
import os
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch.io import _native, _pil, identify, slides, tiff
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_icons")
_spec = importlib.util.spec_from_file_location(
    "icons_make", os.path.join(FIXTURES, "make.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)
_rspec = importlib.util.spec_from_file_location(
    "rasters_make", os.path.join(REPO, "tests", "fixtures", "torch_rasters",
                                 "make.py"))
rk = importlib.util.module_from_spec(_rspec)
_rspec.loader.exec_module(rk)
CASES = sorted(mk.small_cases())
READS = np.load(os.path.join(FIXTURES, "reads.npz"))
with open(os.path.join(FIXTURES, "errors.json")) as _f:
    ERRORS = json.load(_f)
# the fixtures whose decode has a native version (bcn, FLI, PNG filters)
NATIVE = ("dds", "ftex", "fli", "ico_png", "icns")


def _outcome(fn):
    """``("ok", dtype, shape, values)`` or the exception's class name (any
    ``OSError`` as ``OSError``)."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = fn()
        if r is None:  # identify.read: no plugin opens it
            return "OSError"
        return ("ok", r.dtype.str, r.shape,
                (r != 0 if r.dtype == bool else r).tobytes())
    except OSError:
        return "OSError"
    except Exception as e:  # noqa: BLE001
        return type(e).__name__


def _recorded(name: str, k):
    key = name if k is None else f"{name}@{k}"
    if key in ERRORS:
        err = ERRORS[key]
        return "OSError" if err in ("OSError", "UnidentifiedImageError") \
            else err
    r = READS[key]
    return ("ok", r.dtype.str, r.shape,
            (r != 0 if r.dtype == bool else r).tobytes())


def _data(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _is_eps(data: bytes) -> bool:
    try:
        return identify.open_image(data) == "EPS"
    except Exception:  # noqa: BLE001 -- refused at open
        return False


def test_fixtures_are_make_pys_cases():
    """The committed files are :func:`make.small_cases`, byte for byte,
    and every read PIL made of them is recorded."""
    on_disk = sorted(f for f in os.listdir(FIXTURES)
                     if f not in ("make.py", "reads.npz", "errors.json",
                                  "slides.json", "__pycache__"))
    assert on_disk == CASES
    for name, data in mk.small_cases().items():
        assert _data(name) == data, name
        for k in mk.SEEKS:
            key = name if k is None else f"{name}@{k}"
            assert (key in ERRORS) != (key in READS.files), key


@pytest.mark.parametrize("name,codecs", [(n, "native") for n in CASES] + [
    (n, "python") for n in CASES if n.startswith(NATIVE)])
def test_fixture_reads_as_pil(name, codecs, monkeypatch):
    """After no seek and after each ``seek(k)``: PIL's array (dtype,
    shape, values) or its exception class, through ``identify.read``;
    the files with a native decoder also without the library.  An EPS
    file's frame 0: PIL's read needs Ghostscript, the port refuses it
    naming M17."""
    data = _data(name)
    assert _native.get_lib() is not None, "the native library did not load"
    if codecs == "python":
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    eps = _is_eps(data)
    for k in mk.SEEKS:
        got = _outcome(lambda: identify.read(data, k, name))
        if eps and not k:
            with pytest.raises(NotImplementedError, match="M17"):
                identify.read(data, k, name)
            continue
        assert got == _recorded(name, k), (name, k)


def _rename(name: str) -> str:
    return os.path.splitext(name)[0] + ".tif"


@pytest.mark.parametrize("name", CASES)
def test_entry_points_agree_with_jax(name, tmp_path):
    """The fixture under its own name through both toolboxes' ``imread``
    (no seek), and under a TIFF name through both ``tiff.imread``s (pages
    0 and 1) and both ``read_channel``s (channels 0-3: ``EOFError`` is
    ``IndexError`` there, any other failure ``ValueError``); an EPS
    file's frame 0 is refused naming M17 (``ValueError`` through
    ``read_channel``, as PIL's failing read is in JAX)."""
    data = _data(name)
    raw, tif = tmp_path / name, tmp_path / _rename(name)
    raw.write_bytes(data)
    tif.write_bytes(data)
    eps = _is_eps(data)
    # a file no plugin opens keeps the TIFF reader's own error under a
    # TIFF name (test_torch_tiff_bilevel's neither-kind test)
    try:
        unidentified = identify.open_image(data) is None
    except Exception:  # noqa: BLE001 -- an error PIL lets escape too
        unidentified = False
    if eps:
        with pytest.raises(NotImplementedError, match="M17"):
            T.imread(str(raw))
    else:
        assert _outcome(lambda: T.imread(str(raw))) == \
            _outcome(lambda: J.imread(str(raw)))
    for page in (None, 0, 1):
        if eps and not page:
            continue
        port = (lambda: T.imread(str(tif))) if page is None else (
            lambda: tiff.imread(str(tif), page))
        jax = (lambda: J.imread(str(tif))) if page is None else (
            lambda: jax_tiff.imread(str(tif), page))
        if unidentified:
            assert _outcome(jax) == "OSError"
            with pytest.raises(ValueError, match="not a TIFF file"):
                port()
        else:
            assert _outcome(port) == _outcome(jax), page
    for ch in range(4):
        assert _outcome(lambda: slides.read_channel(str(tif), "tif", ch)) == \
            _outcome(lambda: jax_slides.read_channel(str(tif), "tif", ch)), ch


@pytest.mark.parametrize("name", CASES)
def test_identification_is_pils(name, tmp_path):
    """``identify.open_image`` names the format ``Image.open`` names (None
    where PIL identifies nothing), or lets the same exception escape."""
    data = _data(name)
    path = tmp_path / name
    path.write_bytes(data)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = Image.open(str(path)).format
    except Exception as e:  # noqa: BLE001
        want = type(e).__name__
    want = None if want == "UnidentifiedImageError" else want
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = identify.open_image(data)
    except OSError:
        got = "OSError"
    except Exception as e:  # noqa: BLE001
        got = type(e).__name__
    if want == "OSError" or (isinstance(want, str) and want.endswith(
            "Error") and got == "OSError"):
        assert got == "OSError" or got == want, (got, want)
    else:
        assert got == want, (got, want)


def _pil_bytes(image: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, fmt, **kw)
    return buf.getvalue()


def _pil_written():
    """name -> the bytes PIL writes: ICO (PNG entries at several sizes,
    BMP entries), ICNS (PNG entries), BLP1 and BLP2 (palette), DDS in
    each block format PIL's encoder writes."""
    rng = np.random.RandomState(2401)
    rgba = Image.fromarray(rng.randint(0, 256, (64, 64, 4)).astype(np.uint8),
                           "RGBA")
    rgb = rgba.convert("RGB")
    pal = rgb.quantize(64)
    out = {
        "ico_png": _pil_bytes(rgba, "ICO", sizes=[(16, 16), (32, 32),
                                                   (48, 48)]),
        "ico_bmp": _pil_bytes(rgba, "ICO", sizes=[(16, 16), (32, 32)],
                              bitmap_format="bmp"),
        "ico_bmp_rgb": _pil_bytes(rgb, "ICO", sizes=[(24, 24)],
                                  bitmap_format="bmp"),
        "ico_bmp_palette": _pil_bytes(pal, "ICO", sizes=[(16, 16)],
                                      bitmap_format="bmp"),
        "icns": _pil_bytes(rgba.resize((256, 256)), "ICNS"),
        "blp1": _pil_bytes(pal, "BLP", blp_version="BLP1"),
        "blp2": _pil_bytes(pal, "BLP"),
    }
    for fmt in ("DXT1", "DXT3", "DXT5", "BC2", "BC3", "BC5"):
        image = rgb if fmt == "BC5" else rgba
        out[f"dds_{fmt.lower()}"] = _pil_bytes(image, "DDS", pixel_format=fmt)
    return out


_WRITTEN = sorted(_pil_written())


@pytest.mark.parametrize("name", _WRITTEN)
def test_files_pil_writes_read_as_pil(name, tmp_path):
    """Files PIL itself writes, as a real exporter's: both toolboxes'
    ``imread`` give the same array, and under a TIFF name both
    ``read_channel``s at channels 0 and 1."""
    data = _pil_written()[name]
    raw, tif = tmp_path / f"{name}.bin", tmp_path / f"{name}.tif"
    raw.write_bytes(data)
    tif.write_bytes(data)
    want = _outcome(lambda: J.imread(str(raw)))
    assert want[0] == "ok", want
    assert _outcome(lambda: T.imread(str(raw))) == want
    for ch in (0, 1):
        assert _outcome(lambda: slides.read_channel(str(tif), "tif", ch)) == \
            _outcome(lambda: jax_slides.read_channel(str(tif), "tif", ch))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_icns_jpeg2000_entries_read_as_pil(mode):
    """A 16^2 JPEG 2000 entry (``icp4``, as PIL's encoder writes it) of
    each mode PIL converts to RGBA, as a codestream and in a JP2 box: the
    RGBA array PIL gives."""
    rng = np.random.RandomState(len(mode))
    shape = (16, 16) + ((len(mode),) if len(mode) > 1 else ())
    image = Image.fromarray(rng.randint(0, 256, shape).astype(np.uint8),
                            mode)
    for kind in ("j2k", "jp2"):
        stream = _pil_bytes(image, "JPEG2000", no_jp2=kind == "j2k")
        data = mk.icns([(b"icp4", stream)])
        want = np.asarray(Image.open(io.BytesIO(data)))
        got = identify.read(data, None, "x.icns")
        assert got.dtype == want.dtype and np.array_equal(got, want), kind


def _jpeg(array: np.ndarray, mode: str, **kw) -> bytes:
    return _pil_bytes(Image.fromarray(array, mode), "JPEG", **kw)


@pytest.mark.parametrize("mode,transform", [("L", 0), ("RGB", 0),
                                            ("CMYK", 0), ("CMYK", 2)])
def test_blp1_jpeg_reads_as_pil(mode, transform, monkeypatch):
    """BLP1 JPEG textures: gray, colour, CMYK (read as PIL's ``CMYK;I``,
    converted by ``cmyk2rgb``) and a YCCK-marked one (which PIL's
    ``jpegmode`` still takes as CMYK), 4:2:0 and 4:4:4, with and without
    the alpha flag and the native library."""
    rng = np.random.RandomState(transform + len(mode))
    bands = {"L": (), "RGB": (3,), "CMYK": (4,)}[mode]
    for sub in (0, 2):
        jpg = _jpeg(rng.randint(0, 256, (13, 17) + bands).astype(np.uint8),
                    mode, subsampling=sub, quality=85)
        if transform:
            at = jpg.index(b"\xff\xee") + 4 + 11
            jpg = jpg[:at] + bytes([transform]) + jpg[at + 1 :]
        sos = jpg.index(b"\xff\xda")
        for alpha in (0, 8):
            data = mk.blp(b"BLP1", 17, 13, jpg[sos:], 0, 0, alpha,
                          jpeg_header=jpg[:sos])
            want = np.asarray(Image.open(io.BytesIO(data)))
            for lib in (True, False):
                with monkeypatch.context() as m:
                    if not lib:
                        m.setattr(_native, "get_lib", lambda: None)
                    got = identify.read(data, None, "x.blp")
                assert got.dtype == want.dtype and np.array_equal(got, want)


def _blp1_rgb_stream(kind: str, sub: int) -> bytes:
    """A colour JPEG that libjpeg takes as RGB, or (``lossless_jfif``)
    as YCbCr that it cannot convert."""
    import chip_smoke

    rng = np.random.RandomState(sub + len(kind))
    img = rng.randint(0, 256, (13, 17, 3)).astype(np.uint8)
    if kind.startswith("lossless"):
        return chip_smoke.lossless_jpeg(img, 1 + sub, jfif=kind.endswith(
            "jfif"))
    jpg = _jpeg(img, "RGB", subsampling=sub, quality=85)
    assert jpg[2:4] == b"\xff\xe0"  # the JFIF APP0 goes
    jpg = jpg[:2] + jpg[4 + struct.unpack(">H", jpg[4:6])[0] :]
    if kind == "adobe0":
        return jpg[:2] + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" \
            b"\x00" + jpg[2:]
    out = bytearray(jpg)  # component ids 'R', 'G', 'B', no marker
    sof, sos = out.index(b"\xff\xc0"), out.index(b"\xff\xda")
    for k, cid in enumerate(b"RGB"):
        out[sof + 10 + 3 * k] = cid
        out[sos + 5 + 2 * k] = cid
    return bytes(out)


@pytest.mark.parametrize("kind", ["adobe0", "rgb_ids", "lossless",
                                  "lossless_jfif"])
def test_blp1_rgb_jpeg_reads_as_pil(kind, monkeypatch):
    """BLP1 JPEG textures of three components that libjpeg takes as RGB
    (an Adobe marker of transform 0, component ids 'R', 'G', 'B', a
    lossless frame without markers) keep their samples unconverted, as
    PIL sets no ``jpegmode`` for them; a lossless frame under a JFIF
    marker fails as PIL's libjpeg fails it."""
    for sub in (0, 2):
        jpg = _blp1_rgb_stream(kind, sub)
        sos = jpg.index(b"\xff\xda")
        for alpha in (0, 8):
            data = mk.blp(b"BLP1", 17, 13, jpg[sos:], 0, 0, alpha,
                          jpeg_header=jpg[:sos])
            want = _outcome(lambda: np.asarray(Image.open(io.BytesIO(data))))
            assert (want[0] == "ok") == (kind != "lossless_jfif"), want
            for lib in (True, False):
                with monkeypatch.context() as m:
                    if not lib:
                        m.setattr(_native, "get_lib", lambda: None)
                    got = _outcome(lambda: identify.read(data, None, "x.blp"))
                assert got == want, (kind, sub, alpha, lib)


def test_ico_loads_once_and_warns_as_pil():
    """An ICO whose PNG entry is not the directory's size: PIL loads it
    while it opens the file and warns once; ``identify.read`` decodes it
    once, with the same warnings, and gives the same array."""
    with open(os.path.join(FIXTURES, "ico_png_size_mismatch.ico"), "rb") as f:
        data = f.read()
    with warnings.catch_warnings(record=True) as pil:
        warnings.simplefilter("always")
        want = np.asarray(Image.open(io.BytesIO(data)))
    with warnings.catch_warnings(record=True) as port:
        warnings.simplefilter("always")
        got = identify.read(data, None, "x.ico")
    assert [str(w.message) for w in port] == [str(w.message) for w in pil]
    assert [str(w.message) for w in pil] == ["Image was not the expected size"]
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_cmyk_to_rgb_is_pils():
    """Every (C, K) pair and a sweep of M and Y through PIL's CMYK to RGB
    conversion and :func:`_pil.cmyk_to_rgb`."""
    v = np.arange(256, dtype=np.uint8)
    px = np.stack([np.repeat(v, 256), np.tile(v, 256)[::-1],
                   np.tile(v, 256), np.repeat(v, 256)[::-1]], 1).reshape(
        256, 256, 4)
    want = np.asarray(Image.fromarray(px, "CMYK").convert("RGB"))
    assert np.array_equal(_pil.cmyk_to_rgb(px), want)


# -- IPTC records of a colour JPEG, or of an image of another size ------------

_IPTC = [("gray_larger", "L", (9, 8), 1, 0, None),
         ("gray_wider", "L", (20, 3), 1, 0, None),
         ("gray_smaller", "L", (5, 4), 1, 0, None),
         ("colour_same", "RGB", (7, 6), 1, 0, None),
         ("colour_larger", "RGB", (9, 9), 1, 0, None),
         ("colour_wide", "RGB", (30, 2), 1, 0, None),
         ("colour_in_band0", "RGB", (7, 6), 3, 1, 1),
         ("colour_in_band2", "RGB", (7, 6), 3, 1, 3),
         ("colour_in_last_cmyk", "RGB", (7, 6), 4, 1, 0),
         ("gray_band2_larger", "L", (9, 8), 3, 1, 2),
         ("gray_band1_larger_cmyk", "L", (11, 9), 4, 1, 1),
         ("gray_band0_is_last", "L", (8, 7), 3, 1, 0)]


@pytest.mark.parametrize("case", _IPTC, ids=[c[0] for c in _IPTC])
def test_iptc_records_of_other_jpegs_read_as_pil(case, tmp_path):
    """A 7 x 6 record whose JPEG is colour, or of another size: PIL's
    array (the image's own bytes in the record's shape), or its
    ``ValueError`` where ``Image.merge`` refuses a colour band; where the
    image is smaller than the record PIL's array reads memory past the
    image's bytes, and the port raises ``ValueError``."""
    name, mode, size, layers, component, band = case
    rng = np.random.RandomState(len(name))
    shape = size[::-1] + ((3,) if mode == "RGB" else ())
    jpg = _jpeg(rng.randint(0, 256, shape).astype(np.uint8), mode,
                quality=90)
    kw = {} if band is None else {"band": band}
    data = rk.iptc(jpg, 7, 6, layers=layers, component=component,
                   compression=5, **kw)
    bands = {1: 1, 3: 3, 4: 4}[layers]
    got = _outcome(lambda: identify.read(data, None, name))
    if size[0] * size[1] < 7 * 6 and mode == "L":
        assert got == "ValueError"
        with pytest.raises(ValueError, match="past the image"):
            identify.read(data, None, name)
        return
    want = _outcome(lambda: np.asarray(Image.open(io.BytesIO(data))))
    assert got == want, (got if isinstance(got, str) else got[:3], bands)
    path = tmp_path / "r.iim"
    path.write_bytes(data)
    assert _outcome(lambda: T.imread(str(path))) == \
        _outcome(lambda: J.imread(str(path)))


def test_small_slides_hash_as_pil():
    """:func:`make.slide_files` at 512^2 (the recipe ``chip_smoke.py``
    runs at 4096^2): each read the card makes equals PIL's, with and
    without the native library."""
    files = mk.slide_files(side=512)
    assert sorted(files) == sorted(json.load(open(os.path.join(
        FIXTURES, "slides.json"))))
    for name, (data, seeks) in files.items():
        for k in seeks:
            im = Image.open(io.BytesIO(data))
            im.seek(k)
            want = np.asarray(im)
            got = identify.read(data, k, name)
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (name, k)


def test_eps_headers_open_as_pils(tmp_path):
    """DSC headers PIL's ``_open`` takes, hands on or lets escape: the
    format ``Image.open`` names (or its exception class) from
    ``identify.open_image``, and the size PIL opens."""
    head = b"%!PS-Adobe-3.0\n"
    cases = {
        "ok": head + b"%%BoundingBox: 0 0 5 4\n",
        "float_box": head + b"%%BoundingBox: 0.5 0 5.9 4\n",
        "bad_box": head + b"%%BoundingBox: a b c d\n%%EndComments\n",
        "short_box": head + b"%%BoundingBox: 0 0 5\n%%EndComments\n",
        "zero_box": head + b"%%BoundingBox: 0 0 0 4\n%%EndComments\n",
        "no_adobe": b"%!PS\n%%BoundingBox: 0 0 5 4\n",
        "imagedata_1bit": head + b"%%BoundingBox: 0 0 5 4\n%%EndComments\n"
                          b"%ImageData: 9 8 1 1 0 1 1 \"x\"\n",
        "imagedata_mode9": head + b"%%BoundingBox: 0 0 5 4\n%%EndComments\n"
                           b"%ImageData: 9 8 8 9 0 1 1 \"x\"\n",
        "imagedata_16bit": head + b"%%BoundingBox: 0 0 5 4\n%%EndComments\n"
                           b"%ImageData: 9 8 16 3 0 1 1 \"x\"\n",
        "imagedata_text": head + b"%%BoundingBox: 0 0 5 4\n%%EndComments\n"
                          b"%ImageData: x 8 8 3\n",
        "imagedata_short": head + b"%%BoundingBox: 0 0 5 4\n"
                           b"%%EndComments\n%ImageData: 9 8\n",
        "after_endcomments": head + b"%%BoundingBox: 0 0 5 4\n"
                             b"%%EndComments\r\n%ImageData: 9 8 8 3\n",
        "long_comment": head + b"%" + b"x" * 300 + b"\n",
        "long_binary": head + b"%%BoundingBox: 0 0 5 4\n" + b"y" * 300,
        "begin_binary": head + b"%%BoundingBox: 0 0 5 4\n%%EndComments\n"
                        b"%%BeginBinary: 5\nxxxxx%%EOF\n",
        "begin_binary_back": head + b"%%BoundingBox: 0 0 5 4\n"
                             b"%%EndComments\n%%BeginBinary: -900\n",
        "trailer_box": head + b"%%BoundingBox: (atend)\n%%EndComments\n"
                       b"%%Trailer\n%%BoundingBox: 0 0 3 2\n",
        "dos_cut": struct.pack("<I", 0xC6D3D0C5) + b"\x05",
        "dos_far": struct.pack("<III", 0xC6D3D0C5, 4000, 10),
    }
    for name, data in cases.items():
        path = tmp_path / f"{name}.eps"
        path.write_bytes(data)
        try:
            im = Image.open(str(path))
            want = (im.format, im.size)
        except Exception as e:  # noqa: BLE001
            want = type(e).__name__
        try:
            fmt = identify.open_image(data)
            got = (fmt, identify.eps.open_header(data)) if fmt == "EPS" \
                else fmt
        except Exception as e:  # noqa: BLE001
            got = type(e).__name__
        if want == "UnidentifiedImageError":
            want = None
        assert got == want, (name, got, want)
