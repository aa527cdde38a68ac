"""The raster formats PIL 12.1 decodes itself (``unmicst_tpu_torch/io/
spider.py``, ``fits.py``, ``mcidas.py``, ``psd.py``, ``sun.py``,
``pixar.py``, ``xvthumb.py``, ``xpm.py``, ``imt.py``, ``gbr.py``,
``iptc.py``, ``pcd.py``) against PIL, which the JAX package reaches for
them: the TIFF fallback's ``Image.open`` and ``seek(channel)``
(``unmicst_tpu/io/slides.py:66-89``, ``io/tiff.py:1273-1291``) and the
toolbox's ``imread`` without a seek (``utils/imtools.py:48-56``).

The committed fixtures (``tests/fixtures/torch_rasters/make.py``) read as
PIL's recorded arrays after no seek and after every seek, or raise its
recorded exception classes, with and without the native library (PSD's
PackBits and Sun raster's RLE); the native decoders are bit-equal to
their plain versions and to PIL's own C decoders on random streams; the
identification of the stubs and of WMF/EMF is PIL's; ``identify.read``
gives the same for no seek and ``seek(0)`` for every format but SPIDER
and PSD, as PIL does; the entry points of both packages agree on every
fixture under a TIFF name and under its own; and small slides run through
both CLIs.
"""

import importlib.util
import io
import json
import os
import warnings

import numpy as np
import pytest
from PIL import Image

from unmicst_tpu import cli as jax_cli
from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch import cli
from unmicst_tpu_torch.io import _native, identify, pcd, psd, slides, sun, tiff
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_rasters")
MODELS = os.path.join(REPO, "models")
_spec = importlib.util.spec_from_file_location(
    "rasters_make", os.path.join(FIXTURES, "make.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)
CASES = sorted(mk.small_cases())
READS = np.load(os.path.join(FIXTURES, "reads.npz"))
with open(os.path.join(FIXTURES, "errors.json")) as _f:
    ERRORS = json.load(_f)


def _outcome(fn):
    """``("ok", dtype, shape, values)`` or the exception's class name (any
    ``OSError`` as ``OSError``)."""
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
    (n, "python") for n in CASES if n.startswith(("psd", "sun"))])
def test_fixture_reads_as_pil(name, codecs, monkeypatch):
    """After no seek and after each ``seek(k)``: PIL's array (dtype,
    shape, values) or its exception class, through ``identify.read``;
    PSD and Sun raster files also without the native library."""
    data = _data(name)
    assert _native.get_lib() is not None, "the native library did not load"
    if codecs == "python":
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    for k in mk.SEEKS:
        got = _outcome(lambda: identify.read(data, k, name))
        assert got == _recorded(name, k), (name, k)


@pytest.mark.parametrize("orientation", [0, 1, 2, 3])
def test_photocd_reads_as_pil(orientation):
    """The 768 x 512 base image of seeded samples at each orientation,
    and cut short, as PIL's ``PcdDecode.c`` and ``YCC;P`` unpack it."""
    rng = np.random.RandomState(orientation)
    data = mk.pcd(rng.randint(0, 256, (512, 768)),
                  rng.randint(0, 256, (256, 384)),
                  rng.randint(0, 256, (256, 384)), orientation)
    for body in (data, data[: -1000 - orientation]):
        want = _outcome(lambda: np.asarray(Image.open(io.BytesIO(body))))
        assert _outcome(lambda: identify.read(body, None, "x")) == want
        assert identify.open_image(body) == "PCD"


def test_photocd_tables_sweep_every_value():
    """Every (y, cr), (y, cb) and (cb, cr) pair through PIL and through
    :func:`pcd.ycc_to_rgb`: the port's tables are PIL's."""
    v = np.arange(256)
    y = np.repeat(v, 256).reshape(256, 256)
    for pairs in ((y, y.T, np.full_like(y, 137)), (y, np.full_like(y, 156),
                                                   y.T),
                  (np.full_like(y, 100), y, y.T)):
        yy, cb, cr = (np.broadcast_to(p, (256, 256)).ravel() for p in pairs)
        # one sample a 2 x 2 block: luma repeated, chroma per block
        cells = 384 * 256
        ys = np.zeros(cells, np.uint8)
        cbs, crs = np.zeros(cells, np.uint8), np.zeros(cells, np.uint8)
        ys[: yy.size], cbs[: yy.size], crs[: yy.size] = yy, cb, cr
        ys, cbs, crs = (a.reshape(256, 384) for a in (ys, cbs, crs))
        luma = np.repeat(np.repeat(ys, 2, 0), 2, 1)
        data = mk.pcd(luma, cbs, crs)
        want = np.asarray(Image.open(io.BytesIO(data)))
        assert np.array_equal(pcd.read_frame(data, None), want)
        assert np.array_equal(pcd.ycc_to_rgb(luma, np.repeat(np.repeat(
            cbs, 2, 0), 2, 1), np.repeat(np.repeat(crs, 2, 0), 2, 1)), want)


def _pil_decode(codec: str, data: bytes, w: int, h: int):
    """PIL's C decoder ``codec`` over ``data`` into an ``L`` image."""
    img = Image.new("L", (w, h))
    d = Image._getdecoder("L", codec, "L")
    d.setimage(img.im, (0, 0, w, h))
    n, err = d.decode(data)
    d.cleanup()
    return n, err, np.asarray(img)


def test_rle_decoders_are_pils_and_native_equals_plain():
    """Random streams (random bytes, and bytes dense in 0x80 and short
    counts) through PIL's ``packbits`` and ``sun_rle`` decoders, the plain
    versions and the native ones: the same rows, the same bytes consumed
    where the data end first, done where PIL is done."""
    assert _native.get_lib() is not None
    rng = np.random.RandomState(23)
    for _ in range(1500):
        w, h = rng.randint(1, 20), rng.randint(1, 5)
        n = rng.randint(0, 60)
        pool = [np.arange(256), [0x80, 0, 1, 2, 0xFE, 0xFF, 5, 0x81],
                [0x80, 0, 3, 7, 1]][rng.randint(3)]
        data = rng.choice(pool, n).astype(np.uint8).tobytes()
        for codec in ("packbits", "sun_rle"):
            pn, perr, want = _pil_decode(codec, data, w, h)
            assert perr == 0
            outs = [np.zeros((h, w), np.uint8) for _ in range(2)]
            if codec == "packbits":
                plain = psd.packbits_rows_py(data, 0, outs[0])
                native = _native.packbits_rows(data, 0, outs[1])
                code, pos = plain[0], plain[2]
            else:
                plain = sun.rle_decode_py(data, 0, outs[0])
                native = _native.sun_rle_rows(data, 0, outs[1])
                code, pos = plain
            assert native == plain, (codec, data.hex(), w, h)
            assert (pn == -1) == (code == psd.OK)
            if code == psd.OK:
                assert np.array_equal(outs[0], want)
                assert np.array_equal(outs[1], want)
            else:
                assert pn == pos


def test_none_is_seek0_but_for_spider_and_psd():
    """``identify.read`` without a seek equals ``seek(0)`` for every
    format it reads (a fixture of each from the rasters' set and the
    other slices' sets, the icons' among them); for a single SPIDER image
    and a PSD they differ as
    PIL's do: pixels without a seek, ``EOFError`` at ``seek(0)``."""
    roots = {"torch_rasters": CASES}
    for sub in ("torch_rle", "torch_write", "torch_j2k", "torch_gif",
                "torch_icons"):
        d = os.path.join(REPO, "tests", "fixtures", sub)
        roots[sub] = sorted(f for f in os.listdir(d) if not f.endswith(
            (".py", ".npz", ".json", ".npy")))
    files = [(name, os.path.join(REPO, "tests", "fixtures", sub, name))
             for sub, names in roots.items() for name in names]
    seen = set()
    for name, path in files + [("photocd", None)]:
        if path is None:
            data = mk.pcd_case()
        else:
            with open(path, "rb") as f:
                data = f.read()
        try:
            fmt = identify.open_image(data)
        except Exception:  # noqa: BLE001 -- refused at open
            continue
        if fmt not in identify.READ:
            continue
        seen.add(fmt)
        a = _outcome(lambda: identify.read(data, None, name))
        b = _outcome(lambda: identify.read(data, 0, name))
        if fmt == "PSD" or (fmt == "SPIDER" and "stack" not in name):
            assert b == "EOFError" != a, (name, a)
        else:
            assert a == b, name
    assert seen == set(identify.READ), set(identify.READ) - seen


def test_identification_of_stubs_and_metafiles_is_pils(tmp_path):
    """BUFR, GRIB, HDF5, MPEG and WMF/EMF files: the format ``Image.open``
    names (or its escaping exception), and the ``OSError`` of
    ``np.asarray`` (``EOFError`` past frame 0) through every entry point;
    ``MAGIC_ONLY`` holds only the plugins still checked by magic alone:
    AVIF and WebP, whose ``_open`` is their codec's parser, and TIFF, the
    port's own reader (BLP, EPS, FTEX, ICNS, ICO and FLI now run PIL's
    checks: ``tests/test_torch_icons.py``)."""
    assert set(identify.MAGIC_ONLY) == {"AVIF", "TIFF", "WEBP"}
    assert not hasattr(identify, "PARTLY_CHECKED")
    emf = (b"\x01\0\0\0" + bytes(4)
           + np.array([0, 0, 10, 12, 0, 0, 100, 90], "<i4").tobytes()
           + b" EMF" + bytes(8))
    wmf = (b"\xd7\xcd\xc6\x9a\0\0" + bytes([0, 0, 0, 0, 100, 0, 50, 0, 72,
                                            0]) + bytes(6) + b"\x01\x00\t\x00"
           + bytes(30))
    files = {"bufr": b"BUFR" + bytes(30), "zczc": b"ZCZC" + bytes(3),
             "grib": b"GRIB\0\0\0\x01" + bytes(30),
             "grib2": b"GRIB\0\0\0\x02" + bytes(30),
             "hdf5": b"\x89HDF\r\n\x1a\n" + bytes(30),
             "mpeg": b"\0\0\1\xb3\x10\x01\x00" + bytes(30), "emf": emf,
             "wmf": wmf, "wmf_inch0": wmf[:14] + b"\0\0" + wmf[16:],
             "wmf_bad": wmf[:22] + b"\0\0\0\0" + wmf[26:],
             "emf_flat": emf[:24] + bytes(16) + emf[40:],
             "not_emf": b"\x01\0\0\0" + bytes(60)}
    for name, data in files.items():
        raw = tmp_path / f"{name}.dat"
        raw.write_bytes(data)
        try:
            want = Image.open(str(raw)).format
        except Exception as e:  # noqa: BLE001
            want = type(e).__name__
        try:
            got = identify.open_image(data)
        except Exception as e:  # noqa: BLE001
            got = type(e).__name__
        assert got == (None if want == "UnidentifiedImageError" else want), \
            name
        tif = tmp_path / f"{name}.tif"
        tif.write_bytes(data)
        assert _outcome(lambda: T.imread(str(raw))) == \
            _outcome(lambda: J.imread(str(raw))), name
        for ch in (0, 1):
            assert _outcome(lambda: slides.read_channel(str(tif), "tif", ch)) \
                == _outcome(lambda: jax_slides.read_channel(str(tif), "tif",
                                                            ch)), (name, ch)


def _rename(name: str) -> str:
    return os.path.splitext(name)[0] + ".tif"


@pytest.mark.parametrize("name", CASES)
def test_entry_points_agree_with_jax(name, tmp_path):
    """The fixture under its own name through both toolboxes' ``imread``
    (no seek), and under a TIFF name through both ``tiff.imread``s (pages
    0 and 1) and both ``read_channel``s (channels 0-3: ``EOFError`` is
    ``IndexError`` there, any other failure ``ValueError``)."""
    data = _data(name)
    raw, tif = tmp_path / name, tmp_path / _rename(name)
    raw.write_bytes(data)
    tif.write_bytes(data)
    assert _outcome(lambda: T.imread(str(raw))) == \
        _outcome(lambda: J.imread(str(raw)))
    assert _outcome(lambda: T.imread(str(tif))) == \
        _outcome(lambda: J.imread(str(tif)))
    for page in (0, 1):
        assert _outcome(lambda: tiff.imread(str(tif), page)) == \
            _outcome(lambda: jax_tiff.imread(str(tif), page)), page
    for ch in range(4):
        assert _outcome(lambda: slides.read_channel(str(tif), "tif", ch)) == \
            _outcome(lambda: jax_slides.read_channel(str(tif), "tif", ch)), ch


def test_small_slides_hash_as_pil():
    """:func:`make.slide_files` at 128^2 (the recipe ``chip_smoke.py``
    runs at 4096^2): each read the card makes equals PIL's, the PSD's
    second layer (seek 2) among them, and that layer is the one written."""
    for name, (data, seeks) in mk.slide_files(side=128).items():
        for k in seeks:
            want = np.asarray(_pil_seek(data, k))
            got = identify.read(data, k, name)
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (name, k)
    data, _ = mk.slide_files(side=128)["psd_layers.tif"]
    rng = np.random.RandomState(23)  # slide_files' draws: the stack, the
    for _ in range(3):  # gray composite, then the layer
        mk.blob_slide(rng, 128, 128, 20)
    mk.blob_slide(rng, 128, 128, 20, 0.1)
    layer = (mk.blob_slide(rng, 128, 128, 20, 0.05) * 255).astype(np.uint8)
    assert np.array_equal(identify.read(data, 2, "psd"), layer)


def _pil_seek(data: bytes, k):
    im = Image.open(io.BytesIO(data))
    if k is not None:
        im.seek(k)
    return im


@pytest.mark.parametrize("kind", ["spider", "fits", "psd"])
def test_cli_on_each_kind_under_a_tiff_name(kind, tmp_path):
    """A 256 x 256 slide with nuclei as a big-endian SPIDER stack of 3
    (``--channel 2``: its second image, the host float path), a 16-bit
    FITS and a gray PackBits PSD (``--channel 2``: the composite) under
    ``.tif`` through both CLIs on blobDemo: the same files, pages within
    1 uint8 level."""
    import chip_smoke

    rng = np.random.RandomState(256)
    x = chip_smoke.blob_slide(rng, 256, 256, 12, 0.1)
    if kind == "spider":
        data = mk.spider([x * 0.5, x, x * 2.0], ">", stack=True)
        channel = "2"
    elif kind == "fits":
        data = mk.fits((x * 20000).astype(np.int16), 16)
        channel = "1"
    else:
        g = (x * 255).astype(np.uint8)
        data = mk.psd([g], 1, compression=1, layers=[
            (0, 0, [0], [g[:8, :8]], b"a")])
        channel = "2"
    path = tmp_path / "s" / "slide.tif"
    path.parent.mkdir()
    path.write_bytes(data)
    common = [str(path), "--tool", "unmicst-legacy", "--model", "blobDemo",
              "--modelRoot", MODELS, "--stackOutput", "--channel", channel]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main(common + ["--outputPath", out_j]) == 0
    assert cli.main(common + ["--outputPath", out_t], device="cpu") == 0
    files = sorted(os.path.relpath(os.path.join(d, f), out_j)
                   for d, _, fs in os.walk(out_j) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), out_t)
                           for d, _, fs in os.walk(out_t) for f in fs)
    assert any(f.endswith(".tif") for f in files)
    for rel in files:
        if not rel.endswith(".tif"):
            continue
        a, b = os.path.join(out_j, rel), os.path.join(out_t, rel)
        n = jax_tiff.num_pages(a)
        assert n == tiff.num_pages(b) and n >= 1
        for k in range(n):
            pa, pb = jax_tiff.imread(a, k), tiff.imread(b, k)
            assert pa.dtype == pb.dtype and pa.shape == pb.shape
            assert np.abs(pa.astype(int) - pb.astype(int)).max() <= 1
