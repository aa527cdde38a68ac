"""The port's PIL-free TIFF fallback (``unmicst_tpu_torch/io/tiff.py``
``read_page_fallback``) against the JAX package's PIL fallback
(``unmicst_tpu/io/tiff.py:1274-1291``, ``io/slides.py:66-97``) on the
same files: a PNG or JPEG under a TIFF name, gray 1-, 2-, 4- and 12-bit
pages under every codec the port decodes, CCITT bilevel pages
(compressions 2, 3 and 4, strips and tiles), old-style JPEG pages
(compression 6), each with the native library and without it; the CCITT
decoder's two versions against each other; and both CLIs on a Group 4, a
12-bit and a PNG-as-TIFF slide."""

import io
import os

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from unmicst_tpu import cli as jax_cli
from unmicst_tpu.io import preprocess as jax_pp
from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu_torch import cli
from unmicst_tpu_torch.io import _native, ccitt, slides, tiff
from unmicst_tpu_torch.io import preprocess as pp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_tiff_bilevel")
BILEVEL = sorted(f[:-4] for f in os.listdir(FIXTURES)
                 if f.startswith(("pil_", "tiles_")) and f.endswith(".tif"))
OJPEG = sorted(f[:-4] for f in os.listdir(FIXTURES)
               if f.startswith("ojpeg_") and f.endswith(".tif"))
CODECS = {"none": 1, "packbits": 32773, "lzw": 5, "deflate": 8,
          "lzma": 34925, "zstd": 50000}


@pytest.fixture(params=["native", "python"])
def codecs(request, monkeypatch):
    """Each test once with the native library and once without it (the
    Python CCITT, LZW, PackBits and JPEG scan decoders)."""
    assert _native.get_lib() is not None, "the native library did not load"
    if request.param == "python":
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    return request.param


def _outcome(fn):
    """``(array, None)`` or ``(None, exception type)``."""
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001
        return None, type(e)


def _assert_reads_match(path, page=0):
    """JAX's ``imread`` and ``read_channel`` against the port's: the same
    dtype, shape and values, or both refusing (``read_channel``'s
    ``ValueError`` in both, an ``OSError`` from each ``imread``).
    Returns the port's ``imread``, or None where both refuse."""
    got = []
    for jax_read, port_read in (
            (lambda: jax_tiff.imread(path, page),
             lambda: tiff.imread(path, page)),
            (lambda: jax_slides.read_channel(path, "tif", page),
             lambda: slides.read_channel(path, "tif", page))):
        (want, jax_err), (have, port_err) = (_outcome(jax_read),
                                             _outcome(port_read))
        if jax_err is not None:
            assert port_err is not None, f"JAX refuses ({jax_err})"
            assert issubclass(port_err, OSError if jax_err is not ValueError
                              else ValueError), (jax_err, port_err)
            assert issubclass(jax_err, OSError) or jax_err is ValueError
            got.append(None)
            continue
        assert port_err is None, f"the port raises {port_err}"
        assert have.dtype == want.dtype and have.shape == want.shape
        np.testing.assert_array_equal(have, want)
        got.append(have)
    assert (got[0] is None) == (got[1] is None)
    return got[0]


# -- fixtures --------------------------------------------------------------------


def test_fixtures_are_the_listed_kinds():
    assert len(BILEVEL) == 19 and len(OJPEG) == 7
    total = sum(os.path.getsize(os.path.join(FIXTURES, f))
                for f in os.listdir(FIXTURES))
    assert total < 500 << 10
    kinds = set()
    for name in BILEVEL:
        with tiff.TiffFile(os.path.join(FIXTURES, name + ".tif")) as tf:
            page = tf.pages[0]
            assert page.bits == 1 and page.samples == 1
            kinds.add((page.compression, page.tiled,
                       int(page.fallback_tags.get(292, [0])[0]),
                       int(page.fallback_tags.get(266, [1])[0]),
                       page.photometric))
            if not page.tiled and page.compression != 1:
                assert len(page.offsets) == 3  # strips of 16 rows, then 8
    # every codec, CCITT in strips and tiles, T4Options 0/1/4/5,
    # FillOrder 2 and WhiteIsZero
    assert {k[0] for k in kinds} == {1, 2, 3, 4, 5, 8, 32773}
    assert {k[2] for k in kinds if k[0] == 3} == {0, 1, 4, 5}
    assert {(k[0], k[3]) for k in kinds if k[3] == 2} == {(2, 2), (3, 2),
                                                          (4, 2)}
    assert {k[0] for k in kinds if k[1]} == {2, 3, 4}
    assert {k[4] for k in kinds} == {0, 1, None}


@pytest.mark.parametrize("name", BILEVEL)
def test_bilevel_pages_read_as_jax_reads_them(name, codecs):
    """PIL's bilevel saves under every codec and CCITT mode, FillOrder 2,
    WhiteIsZero, and CCITT tiles assembled by hand: the port's reads are
    JAX's (PIL's) ``bool`` pages, equal to the committed read."""
    path = os.path.join(FIXTURES, name + ".tif")
    with pytest.raises(NotImplementedError):
        with tiff.TiffFile(path) as tf:  # the reader itself still refuses
            tf.read_page(0)
    got = _assert_reads_match(path)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, np.load(path[:-4] + ".npy"))


# -- packed samples ------------------------------------------------------------------


PACKED = [(bits, codec, fill, photometric)
          for bits in (1, 2, 4, 12) for codec in CODECS for fill in (1, 2)
          for photometric in (1, 0, None)]


@pytest.mark.parametrize(
    "bits,codec,fill,photometric", PACKED,
    ids=[f"{b}bit-{c}-fill{f}-photo{p}" for b, c, f, p in PACKED])
def test_packed_pages_read_as_jax_reads_them(bits, codec, fill, photometric,
                                             tmp_path, codecs):
    """1-, 2-, 4- and 12-bit gray pages, odd widths, strips of 5 rows,
    under each codec, FillOrder 1 and 2, BlackIsZero, WhiteIsZero and no
    Photometric tag: 1-bit ``bool``, 2- and 4-bit ``uint8`` scaled, 12-bit
    ``uint16`` as stored; where PIL has no mode for a 12-bit page (other
    than BlackIsZero at FillOrder 1) both refuse."""
    rng = np.random.RandomState(bits * 1000 + CODECS[codec] % 997 + fill)
    plane = rng.randint(0, 1 << bits, (23, 13))
    path = str(tmp_path / "p.tif")
    chip_smoke.packed_tiff(path, plane, bits, CODECS[codec], 5, photometric,
                           fill_order=fill)
    got = _assert_reads_match(path)
    readable = bits != 12 or (fill == 1 and photometric == 1)
    assert (got is not None) == readable
    if readable:
        top = (1 << bits) - 1
        want = plane if photometric == 1 else top - plane
        if bits in (2, 4):
            want = want * (255 // top)
        np.testing.assert_array_equal(got.astype(int), want)


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_predictor_2_on_packed_samples(codec, tmp_path, codecs):
    """Predictor 2 on 4-bit samples: libtiff refuses it under the codecs
    that apply a predictor (LZW, Deflate, LZMA, zstd), and PIL reads the
    stored samples under none and PackBits; the port does the same."""
    plane = np.random.RandomState(2).randint(0, 16, (9, 11))
    path = str(tmp_path / "p.tif")
    chip_smoke.packed_tiff(path, plane, 4, CODECS[codec], 4, predictor=2)
    got = _assert_reads_match(path)
    if codec in ("none", "packbits"):
        np.testing.assert_array_equal(got, plane * 17)
    else:
        assert got is None


@pytest.mark.parametrize("bits", [1, 2, 4, 12])
def test_big_endian_packed_pages(bits, tmp_path):
    """An "MM" file: 1-, 2- and 4-bit pages read as "II" ones; PIL has no
    mode for 12-bit "MM" pages, and both refuse them."""
    plane = np.random.RandomState(bits).randint(0, 1 << bits, (7, 9))
    path = str(tmp_path / "mm.tif")
    chip_smoke.packed_tiff(path, plane, bits, 5, 3, byteorder=">")
    got = _assert_reads_match(path)
    assert (got is None) == (bits == 12)
    if bits == 12:
        with pytest.raises(tiff.FallbackError, match="no mode"):
            tiff.imread(path)


def test_pages_the_fallback_does_not_take_keep_the_reader_s_error(tmp_path):
    """A 4-bit page of two samples (gray and alpha) and a 10-bit gray page
    are not the fallback's: the port re-raises its reader's
    ``NotImplementedError``.  (A 4-bit palette page, once here, is the
    fallback's now: ``tests/test_torch_tiff_pages.py``.)"""
    path = str(tmp_path / "la.tif")
    tags = {256: (4, [8]), 257: (4, [6]), 258: (3, [4, 4]), 259: (3, [1]),
            262: (3, [1]), 277: (3, [2]), 338: (3, [2])}
    chip_smoke.write_segment_tiff(path, [(tags, [bytes(48)])])
    with pytest.raises(NotImplementedError, match="4-bit samples"):
        tiff.imread(path)
    tags = {256: (4, [8]), 257: (4, [6]), 258: (3, [10]), 259: (3, [1]),
            262: (3, [1]), 277: (3, [1])}
    chip_smoke.write_segment_tiff(path, [(tags, [bytes(60)])])
    with pytest.raises(NotImplementedError, match="10-bit samples"):
        tiff.imread(path)
    with pytest.raises(NotImplementedError, match="10-bit samples"):
        slides.read_channel(path, "tif", 0)


# -- CCITT ----------------------------------------------------------------------------


def _pil_ccitt(plane, compression, info=None):
    """The strips of a one-page TIFF PIL writes, and their rows."""
    buf = io.BytesIO()
    Image.fromarray(plane).save(buf, "TIFF", compression=compression,
                                tiffinfo=info or {})
    data = buf.getvalue()
    with Image.open(io.BytesIO(data)) as im:
        return data, [data[o:o + n] for o, n in zip(im.tag_v2[273],
                                                     im.tag_v2[279])]


RANDOM_MODES = [("group3", 3, 0), ("group3", 3, 1), ("group3", 3, 5),
                ("group4", 4, 0), ("tiff_ccitt", 2, 0)]


@pytest.mark.parametrize("compression,code,options", RANDOM_MODES,
                         ids=[f"{c}-t4opts{o}" for c, _, o in RANDOM_MODES])
def test_random_bilevel_streams(compression, code, options, tmp_path,
                                codecs):
    """Seeded random 33 x 47 planes of every density, and rows of long
    runs (make-up codes up to 2560), saved by Pillow under each CCITT
    mode: the port's reads are JAX's, and the decoders' two versions give
    the same rows."""
    rng = np.random.RandomState(code * 10 + options)
    path = str(tmp_path / "r.tif")
    planes = [rng.rand(33, 47) < p for p in (0.02, 0.3, 0.5, 0.7, 0.98)]
    runs = np.zeros((4, 3000), bool)
    for r in range(4):
        ends = np.cumsum(rng.randint(1, 2700, 8))
        for a, b in zip(ends[::2], ends[1::2]):
            runs[r, a:b] = True
    for plane in planes + [runs]:
        info = {292: options} if code == 3 else {}
        data, strips = _pil_ccitt(plane, compression, info)
        with open(path, "wb") as f:
            f.write(data)
        got = _assert_reads_match(path)
        np.testing.assert_array_equal(got, plane)
        h, w = plane.shape
        native = _native.ccitt_decode(strips[0], w, h, code, options)
        if native is not None:
            np.testing.assert_array_equal(
                native, ccitt.decode(strips[0], w, h, code, options))


def test_ccitt_decoders_agree_on_corrupt_streams():
    """Flipped bits and cut strips: the native and the Python decoder
    fail on the same inputs, and agree where they decode."""
    rng = np.random.RandomState(7)
    failed = 0
    for trial in range(120):
        plane = rng.rand(rng.randint(1, 9), rng.randint(1, 60)) < 0.5
        comp, code, options = RANDOM_MODES[trial % len(RANDOM_MODES)]
        _, strips = _pil_ccitt(plane, comp,
                               {292: options} if code == 3 else {})
        seg = bytearray(strips[0])
        seg[rng.randint(len(seg))] ^= 1 << rng.randint(8)
        if trial % 3 == 0:
            seg = seg[:rng.randint(len(seg))]
        h, w = plane.shape
        native, n_err = _outcome(lambda: _native.ccitt_decode(
            bytes(seg), w, h, code, options))
        python, p_err = _outcome(lambda: ccitt.decode(bytes(seg), w, h, code,
                                                      options))
        assert (n_err is None) == (p_err is None), trial
        if n_err is None:
            np.testing.assert_array_equal(native, python)
        else:
            assert issubclass(n_err, ValueError) and issubclass(p_err,
                                                                ValueError)
            failed += 1
    assert failed > 20


def test_corrupt_g4_strip(tmp_path, codecs):
    """A Group 4 strip of zero bytes: both packages refuse it
    (``ValueError`` from ``read_channel``, an ``OSError`` from
    ``imread``).  The strip's first byte then zero bytes: libtiff decodes
    what rows it can and conceals the rest (PIL returns pixels), and the
    port refuses it: a difference listed in ROADMAP M17."""
    plane = np.random.RandomState(4).rand(12, 40) < 0.5
    data, strips = _pil_ccitt(plane, "group4")
    off, n = data.index(strips[0]), len(strips[0])
    path = str(tmp_path / "c.tif")
    for head, pil_reads in ((b"", False), (strips[0][:1], True)):
        with open(path, "wb") as f:
            f.write(data[:off] + head + bytes(n - len(head))
                    + data[off + n:])
        assert (_outcome(lambda: jax_tiff.imread(path))[1] is None) == pil_reads
        if not pil_reads:
            assert _outcome(lambda: jax_slides.read_channel(path, "tif", 0)
                            )[1] is ValueError
        with pytest.raises(tiff.FallbackError, match="CCITT"):
            tiff.imread(path)
        with pytest.raises(ValueError, match="unreadable by both"):
            slides.read_channel(path, "tif", 0)


# -- old-style JPEG -------------------------------------------------------------------


@pytest.mark.parametrize("name", OJPEG)
def test_old_jpeg_pages_read_as_jax_reads_them(name, codecs):
    """Compression 6 with JPEGInterchangeFormat, or the strip alone: gray
    pages as libjpeg decodes them (WhiteIsZero too), colour pages at
    h1v1, h2v1 and h2v2 from the raw samples and libtiff's YCbCr tables:
    0 levels from JAX's (PIL's) reads and the committed read."""
    path = os.path.join(FIXTURES, name + ".tif")
    got = _assert_reads_match(path)
    want = np.load(path[:-4] + ".npy")
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _ojpeg_tags(h, w):
    return {256: (4, [w]), 257: (4, [h]), 258: (3, [8]), 259: (3, [6]),
            262: (3, [1]), 277: (3, [1]), 278: (4, [h]), 284: (3, [1])}


def test_old_jpeg_refusals(tmp_path):
    """A progressive stream and one of another size: ``FallbackError``
    (PIL refuses both).  The table form with the SOS segment, but no
    frame, before the scan in its strip: PIL refuses it too (libtiff
    finds a corrupt SOS marker).  A page of two strips, each
    the whole stream: libtiff joins the strips with a restart marker where
    the stream has no restart interval, and both refuse it.  Both forms
    were ROADMAP M17 before the port read them
    (``tests/test_torch_tiff_pages.py``)."""
    img = np.random.RandomState(5).randint(0, 255, (32, 40)).astype(np.uint8)
    path = str(tmp_path / "o.tif")
    for kwargs, h in ((dict(progressive=True), 32), ({}, 24)):
        buf = io.BytesIO()
        Image.fromarray(img[:h]).save(buf, "JPEG", **kwargs)
        chip_smoke.write_segment_tiff(path, [(_ojpeg_tags(32, 40),
                                              [buf.getvalue()])])
        assert issubclass(_outcome(lambda: jax_tiff.imread(path))[1], OSError)
        with pytest.raises(tiff.FallbackError):
            tiff.imread(path)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG")
    tables, scan = chip_smoke.jpeg_split(buf.getvalue())
    sos = scan.index(b"\xff\xda")
    chip_smoke.write_segment_tiff(path, [({**_ojpeg_tags(32, 40), 512: (
        3, [1]), 519: (4, [0]), 520: (4, [0]), 521: (4, [0])},
        [scan[sos:]])])
    assert issubclass(_outcome(lambda: jax_tiff.imread(path))[1], OSError)
    with pytest.raises(tiff.FallbackError, match="corrupt SOS marker"):
        tiff.imread(path)
    with pytest.raises(ValueError, match="unreadable by both"):
        slides.read_channel(path, "tif", 0)
    chip_smoke.write_segment_tiff(path, [({**_ojpeg_tags(32, 40), 278: (
        4, [16])}, [buf.getvalue(), buf.getvalue()])])
    assert issubclass(_outcome(lambda: jax_tiff.imread(path))[1], OSError)
    with pytest.raises(tiff.FallbackError, match="restart marker"):
        tiff.imread(path)


# -- a PNG or JPEG under a TIFF name (F4) ----------------------------------------


@pytest.mark.parametrize("name", ["png_as", "jpeg_as"])
def test_png_and_jpeg_under_a_tiff_name(name, codecs):
    """PIL opens by content: both packages read the PNG's or JPEG's one
    frame, and past it ``read_channel`` raises ``IndexError`` and
    ``imread`` ``EOFError`` in both."""
    path = os.path.join(FIXTURES, name + ".tif")
    got = _assert_reads_match(path)
    assert got.dtype == np.uint8 and got.ndim == 2
    for read in (jax_slides.read_channel, slides.read_channel):
        with pytest.raises(IndexError, match="channel 1 out of range"):
            read(path, "tif", 1)
    for read in (jax_tiff.imread, tiff.imread):
        with pytest.raises(EOFError):
            read(path, 1)


def test_a_tile_beyond_the_bomb_limit_is_refused(tmp_path):
    """A 64 x 64 CCITT page claiming 2^20 x 2^20 tiles: refused before any
    buffer of that size is made."""
    path = str(tmp_path / "t.tif")
    tags = chip_smoke.ccitt_tags(64, 64, 4, tile=(1 << 20, 1 << 20))
    chip_smoke.write_segment_tiff(path, [(tags, [b"\xff" * 16])])
    with pytest.raises(tiff.PageTooLargeError, match="tiles 1048576x"):
        tiff.imread(path)


def test_a_file_of_neither_kind_keeps_the_reader_s_error(tmp_path):
    path = str(tmp_path / "text.tif")
    with open(path, "w") as f:
        f.write("not an image at all\n")
    with pytest.raises(ValueError, match="not a TIFF file"):
        tiff.imread(path)
    for read in (jax_slides.read_channel, slides.read_channel):
        with pytest.raises(ValueError):
            read(path, "tif", 0)


# -- the bool plane in preprocessing, and both CLIs -------------------------------


def test_a_bool_plane_takes_the_host_float_path():
    """As in JAX (``cli.py:306-320``, ``io/preprocess.py:73``): a bool
    plane is not a device slide, and ``img_as_float`` passes it through
    as float64 0 / 1."""
    plane = np.random.RandomState(6).rand(8, 9) < 0.5
    args = cli.build_parser().parse_args(["x.tif"])
    assert not cli._device_slide_ok(args, [plane])
    assert not jax_cli._device_slide_ok(args, [plane])
    got, want = pp.img_as_float(plane), jax_pp.img_as_float(plane)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plane.astype(np.float64))


def _outputs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("name", ["slide_g4", "slide_12bit_lzw", "png_as"])
def test_cli_matches_jax_cli(name, tmp_path):
    """Both CLIs on a Group 4 bilevel slide (the host float path), a
    12-bit LZW slide and a PNG under a TIFF name: the same files, pages
    within 1 uint8 level."""
    root = tmp_path / "s"
    root.mkdir()
    src = str(root / f"{name}.tif")
    with open(os.path.join(FIXTURES, f"{name}.tif"), "rb") as f:
        data = f.read()
    with open(src, "wb") as f:
        f.write(data)
    common = [src, "--tool", "unmicst-legacy", "--model", "blobDemo",
              "--modelRoot", MODELS, "--stackOutput"]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main(common + ["--outputPath", out_j]) == 0
    assert cli.main(common + ["--outputPath", out_t], device="cpu") == 0
    files = _outputs(out_j)
    assert files and files == _outputs(out_t)
    for rel in files:
        a, b = os.path.join(out_j, rel), os.path.join(out_t, rel)
        if not rel.endswith(".tif"):
            continue
        assert jax_tiff.num_pages(a) == tiff.num_pages(b)
        for k in range(jax_tiff.num_pages(a)):
            pa, pb = jax_tiff.imread(a, k), tiff.imread(b, k)
            assert pa.dtype == pb.dtype and pa.shape == pb.shape
            assert np.abs(pa.astype(int) - pb.astype(int)).max() <= 1
