"""The port's PIL-free TIFF fallback (``unmicst_tpu_torch/io/tiff.py``
``read_page_fallback``) against the JAX package's PIL fallback
(``unmicst_tpu/io/tiff.py:1274-1291``, ``io/slides.py:66-97``) on the same
files: gray JPEG-compressed pages (compression 7) 0 levels apart,
floating-point-predictor pages (predictor 3) bit-equal, the fallback's
page == channel read, its exceptions, the reads that have no fallback
(streamed, pyramid) and both CLIs on such slides."""

import lzma
import os
import zlib

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from unmicst_tpu import cli as jax_cli
from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu_torch import cli
from unmicst_tpu_torch.io import _native, slides, tiff, zstd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_tiff_jpeg")
TIFS = sorted(f[:-4] for f in os.listdir(FIXTURES) if f.endswith(".tif"))


@pytest.fixture(params=["native", "python"])
def codecs(request, monkeypatch):
    """Each test once with the native library and once without it (the
    Python scan decoder and predictor undo)."""
    assert _native.get_lib() is not None, "the native library did not load"
    if request.param == "python":
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    return request.param


def _reads(path, page=0):
    """(JAX imread, JAX read_channel, port imread, port read_channel)."""
    return (jax_tiff.imread(path, page),
            jax_slides.read_channel(path, "tif", page),
            tiff.imread(path, page), slides.read_channel(path, "tif", page))


def _raises(fn):
    """The exception type ``fn`` raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return type(e)
    return None


def _gray(rng, h, w):
    yy, xx = np.mgrid[:h, :w]
    return np.clip(110 + 80 * np.sin(yy / 5.0) * np.cos(xx / 7.0)
                   + rng.randn(h, w) * 15, 0, 255).astype(np.uint8)


def _jpeg(block, **kwargs):
    import io

    buf = io.BytesIO()
    Image.fromarray(block).save(buf, "JPEG", **kwargs)
    return buf.getvalue()


def _jpeg_page(img, rows=16):
    """``(tags, segments)`` of a gray JPEG page in abbreviated strips of
    ``rows`` after a JPEGTables tag."""
    segs, tables = [], None
    for r0 in range(0, img.shape[0], rows):
        tables, data = chip_smoke.jpeg_split(_jpeg(img[r0:r0 + rows],
                                                   quality=90))
        segs.append(data)
    return chip_smoke.gray_jpeg_tags(*img.shape, None, tables, rows), segs


def _ome_xml(order, c, z):
    return ('<?xml version="1.0"?><OME xmlns="http://www.openmicroscopy.org/'
            'Schemas/OME/2016-06"><Image ID="Image:0"><Pixels ID="Pixels:0" '
            f'DimensionOrder="{order}" SizeC="{c}" SizeZ="{z}" SizeT="1" '
            'SizeX="24" SizeY="16" Type="uint8"></Pixels></Image></OME>')


# -- JPEG pages -------------------------------------------------------------------


def test_fixtures_are_the_listed_kinds():
    assert TIFS == ["pil_strips", "strips_miniswhite", "strips_tall_last",
                    "tiles_complete", "tiles_progressive", "tiles_restart",
                    "tiles_tables"]
    total = sum(os.path.getsize(os.path.join(FIXTURES, f))
                for f in os.listdir(FIXTURES))
    assert total < 400 << 10
    with tiff.TiffFile(os.path.join(FIXTURES, "pil_strips.tif")) as tf:
        page = tf.pages[0]
        assert page.compression == 7 and not page.tiled
        assert len(page.offsets) == 4 and page.jpeg_tables is not None
    with tiff.TiffFile(os.path.join(FIXTURES, "tiles_complete.tif")) as tf:
        assert tf.pages[0].tiled and tf.pages[0].jpeg_tables is None
        assert tf.pages[0].width % tf.pages[0].tile_width  # edge tiles
    with open(os.path.join(FIXTURES, "tiles_restart.tif"), "rb") as f:
        assert b"\xff\xdd" in f.read()
    with open(os.path.join(FIXTURES, "tiles_progressive.tif"), "rb") as f:
        assert b"\xff\xc2" in f.read()


@pytest.mark.parametrize("name", TIFS)
def test_jpeg_pages_read_as_jax_reads_them(name, codecs):
    """Strips and tiles, JPEGTables present or absent, restart markers,
    progressive tiles, a last strip coded taller, WhiteIsZero: the port's
    ``imread`` and ``read_channel`` 0 levels from the JAX package's (PIL's)
    reads, which equal the committed decode."""
    path = os.path.join(FIXTURES, name + ".tif")
    want = np.load(os.path.join(FIXTURES, name + ".npy"))
    with pytest.raises(NotImplementedError):
        with tiff.TiffFile(path) as tf:  # the reader itself still refuses
            tf.read_page(0)
    for got in _reads(path):
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_page_is_channel_not_the_ome_plane(tmp_path, rng):
    """An OME JPEG TIFF of 2 channels x 2 z-planes in XYZCT order: channel
    1's OME plane is page 2, but the fallback reads page 1 in both
    packages; the same pixels uncompressed read page 2 in both."""
    planes = [_gray(rng, 16, 24) for _ in range(4)]
    xml = _ome_xml("XYZCT", 2, 2)
    pages = [_jpeg_page(p) for p in planes]
    pages[0][0][270] = (2, xml.encode() + b"\0")
    path = str(tmp_path / "s.ome.tif")
    chip_smoke.write_segment_tiff(path, pages)
    decoded = [tiff.imread(path, k) for k in range(4)]
    for channel in (0, 1):
        got = [jax_slides.read_channel(path, "ome.tif", channel),
               slides.read_channel(path, "ome.tif", channel)]
        for g in got:
            np.testing.assert_array_equal(g, decoded[channel])
    flat = str(tmp_path / "f.ome.tif")
    with jax_tiff.TiffWriter(flat, bigtiff=False) as tw:
        for k, d in enumerate(decoded):
            tw.write(d, description=xml if k == 0 else None)
    for read in (jax_slides.read_channel, slides.read_channel):
        np.testing.assert_array_equal(read(flat, "ome.tif", 1), decoded[2])
    with pytest.raises(IndexError):  # SizeC says there is no channel 2
        slides.read_channel(path, "ome.tif", 2)


def _corrupt_second_ifd(tmp_path, rng):
    """A JPEG page, then a page whose width is 0: the reader refuses the
    file at open, PIL's seek walks past the second IFD."""
    img = _gray(rng, 16, 24)
    bad = _jpeg_page(img)
    bad[0][256] = (4, [0])
    path = str(tmp_path / "c.tif")
    chip_smoke.write_segment_tiff(path, [_jpeg_page(img), bad])
    return path, img


def test_exceptions_are_jax_s(tmp_path, rng):
    """Past the chain's end: ``IndexError`` from ``read_channel`` and
    ``EOFError`` from ``imread``, as PIL's ``seek`` raises it; a segment
    that is no JPEG stream: ``ValueError`` from ``read_channel``,
    ``OSError`` from ``imread``; a page the reader refuses as too large
    stays ``PageTooLargeError``, with no fallback."""
    path, img = _corrupt_second_ifd(tmp_path, rng)
    assert _raises(lambda: tiff.TiffFile(path)) is ValueError
    want = jax_tiff.imread(path, 0)
    np.testing.assert_array_equal(tiff.imread(path, 0), want)
    np.testing.assert_array_equal(slides.read_channel(path, "tif", 0), want)
    for read in (jax_slides.read_channel, slides.read_channel):
        with pytest.raises(IndexError, match="channel 2 out of range"):
            read(path, "tif", 2)
    for read in (jax_tiff.imread, tiff.imread):
        with pytest.raises(EOFError):
            read(path, 2)

    t, segs = _jpeg_page(img)
    segs[0] = b"\0\0" + segs[0][2:]  # no SOI
    bad = str(tmp_path / "b.tif")
    chip_smoke.write_segment_tiff(bad, [(t, segs)])
    for read in (jax_slides.read_channel, slides.read_channel):
        with pytest.raises(ValueError, match="unreadable by both"):
            read(bad, "tif", 0)
    assert issubclass(_raises(lambda: jax_tiff.imread(bad)), OSError)
    with pytest.raises(tiff.FallbackError, match="no SOI"):
        tiff.imread(bad)

    big = str(tmp_path / "big.tif")
    t[256], t[257] = (4, [50000]), (4, [50000])
    chip_smoke.write_segment_tiff(big, [(t, segs)])
    for fn in (lambda: jax_tiff.imread(big), lambda: tiff.imread(big),
               lambda: jax_slides.read_channel(big, "tif", 0),
               lambda: slides.read_channel(big, "tif", 0)):
        assert _raises(fn).__name__ == "PageTooLargeError"
    # 20000^2 reaches the fallback, beyond PIL's decompression-bomb limit
    t[256], t[257] = (4, [20000]), (4, [20000])
    chip_smoke.write_segment_tiff(big, [(t, segs)])
    for read in (jax_slides.read_channel, slides.read_channel):
        with pytest.raises(ValueError, match="unreadable by both"):
            read(big, "tif", 0)
    with pytest.raises(tiff.PageTooLargeError, match="decompression-bomb"):
        tiff.imread(big)


def _colour_jpeg_page(tmp_path, rng) -> str:
    """An RGB page saved by PIL (a colour JPEG page)."""
    root = tmp_path / "s"
    root.mkdir()
    path = str(root / "rgb.tif")
    Image.fromarray(np.stack([_gray(rng, 32, 40)] * 3, -1)).save(
        path, compression="jpeg")
    return path


def test_colour_jpeg_pages_read_as_jax_reads(tmp_path, rng):
    """Both packages' ``imread`` and ``read_channel`` read a colour JPEG
    page as the same [H, W, 3] uint8."""
    path = _colour_jpeg_page(tmp_path, rng)
    for got in _reads(path):
        assert got.shape == (32, 40, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_tiff.imread(path))


def test_colour_jpeg_pages_stay_refused(tmp_path, rng):
    """Both CLIs still refuse a colour JPEG page, the port's naming the
    plane's shape."""
    path = _colour_jpeg_page(tmp_path, rng)
    argv = [path, "--tool", "unmicst-legacy", "--model", "blobDemo",
            "--modelRoot", MODELS, "--outputPath", str(tmp_path / "out")]
    with pytest.raises(ValueError):
        jax_cli.main(argv)
    with pytest.raises(ValueError, match=r"\(32, 40, 3\)"):
        cli.main(argv, device="cpu")


# -- floating-point predictor pages ---------------------------------------------------


def _packbits(data: bytes) -> bytes:
    """PackBits of literal runs only."""
    return b"".join(bytes([len(data[i:i + 128]) - 1]) + data[i:i + 128]
                    for i in range(0, len(data), 128))


def _float_page(plane, compression, byteorder="<", tile=None, rows=8,
                sample_format=3):
    """A one-page predictor-3 TIFF's ``(tags, segments)``, strips of
    ``rows`` rows or tiles ``(th, tw)``."""
    h, w = plane.shape
    blocks = []
    if tile is None:
        blocks = [plane[r:r + rows] for r in range(0, h, rows)]
    else:
        for r in range(0, h, tile[0]):
            for c in range(0, w, tile[1]):
                b = np.zeros(tile, plane.dtype)
                src = plane[r:r + tile[0], c:c + tile[1]]
                b[:src.shape[0], :src.shape[1]] = src
                blocks.append(b)
    enc = {1: lambda b: b, 8: zlib.compress, 32946: zlib.compress,
           5: chip_smoke.lzw_encode, 32773: _packbits,
           34925: lambda b: lzma.compress(b, format=lzma.FORMAT_XZ),
           50000: zstd.compress}[compression]
    predicted = compression not in (1, 32773)
    segs = [enc(chip_smoke.float_predictor_rows(b) if predicted else
                b.astype(b.dtype.newbyteorder(byteorder)).tobytes())
            for b in blocks]
    tags = {256: (4, [w]), 257: (4, [h]),
            258: (3, [plane.dtype.itemsize * 8]), 259: (3, [compression]),
            262: (3, [1]), 277: (3, [1]), 284: (3, [1]), 317: (3, [3]),
            339: (3, [sample_format])}
    if tile is None:
        tags[278] = (4, [rows])
    else:
        tags[322], tags[323] = (4, [tile[1]]), (4, [tile[0]])
    return tags, segs


FLOAT_CASES = {
    "deflate_strips": dict(compression=8),
    "deflate_tiles": dict(compression=32946, tile=(16, 32)),
    "lzw": dict(compression=5),
    "lzma": dict(compression=34925, tile=(32, 16)),
    "zstd": dict(compression=50000),
    "none": dict(compression=1),  # libtiff applies no predictor here
    "packbits": dict(compression=32773),
}


@pytest.mark.parametrize("case", sorted(FLOAT_CASES))
def test_float_predictor_pages_bit_equal(case, tmp_path, rng, codecs):
    """float32 pages with predictor 3, encoded here by hand (Pillow writes
    the tag but not the predictor): the JAX package reads the source back
    exactly, and the port equals it bit for bit."""
    plane = (rng.randn(50, 70) * 1e3).astype(np.float32)
    plane[3, :5] = [np.inf, -np.inf, 0.0, -0.0, 1e-40]
    path = str(tmp_path / "f.tif")
    chip_smoke.write_segment_tiff(path, [_float_page(plane,
                                                     **FLOAT_CASES[case])])
    for got in _reads(path):
        assert got.dtype == np.float32 and got.shape == plane.shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      plane.view(np.uint32))


def test_float_predictor_big_endian(tmp_path, rng, codecs):
    """An "MM" file: the port reads the floats it holds; PIL swaps
    libtiff's native-order samples a second time, so the JAX package reads
    them byte-swapped (a PIL defect the port does not copy)."""
    plane = (rng.randn(20, 30) * 10).astype(np.float32)
    path = str(tmp_path / "mm.tif")
    for tile in (None, (16, 16)):
        chip_smoke.write_segment_tiff(
            path, [_float_page(plane, 8, ">", tile=tile)], ">")
        jax_i, jax_c, port_i, port_c = _reads(path)
        for got in (port_i, port_c):
            np.testing.assert_array_equal(got, plane)
        for got in (jax_i, jax_c):
            np.testing.assert_array_equal(got.view(np.uint32),
                                          plane.view(np.uint32).byteswap())


@pytest.mark.parametrize("dtype,fmt", [(np.float64, 3), (np.float16, 3),
                                       (np.uint32, 1)])
def test_float_predictor_refusals_are_pil_s(dtype, fmt, tmp_path, rng):
    """PIL has no mode for float64 or float16 pages and libtiff refuses
    predictor 3 on integers: ``ValueError`` from ``read_channel`` and an
    ``OSError`` from ``imread`` in both packages."""
    plane = (rng.rand(10, 12) * 100).astype(dtype)
    path = str(tmp_path / "r.tif")
    chip_smoke.write_segment_tiff(path, [_float_page(plane, 8,
                                                     sample_format=fmt)])
    for read in (jax_slides.read_channel, slides.read_channel):
        with pytest.raises(ValueError, match="unreadable by both"):
            read(path, "tif", 0)
    for read in (jax_tiff.imread, tiff.imread):
        assert issubclass(_raises(lambda: read(path)), OSError)


def test_float_predictor_undo_native_equals_python(rng):
    rows = rng.randint(0, 256, (7, 8 * 33)).astype(np.uint8)
    for itemsize in (2, 4, 8):
        a = _native.fp_predictor_undo(rows.copy(), itemsize)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(_native, "get_lib", lambda: None)
            b = tiff._undo_float_predictor(rows.copy(), itemsize)
        np.testing.assert_array_equal(a, b)


# -- the reads with no fallback, and the CLIs -----------------------------------------


def _blob_u8(rng, h=200, w=160):
    img = np.full((h, w), 20.0)
    rr, cc = np.ogrid[:h, :w]
    for _ in range(10):
        r, c = rng.randint(15, h - 15), rng.randint(15, w - 15)
        img[(rr - r) ** 2 + (cc - c) ** 2 < rng.randint(25, 80)] = 200
    return np.clip(img + rng.randn(h, w) * 6, 0, 255).astype(np.uint8)


def _slides(tmp_path, rng):
    """A JPEG TIFF (64^2 tiles after JPEGTables) and a predictor-3 float32
    TIFF of a blob slide, and a JPEG pyramid of it (one SubIFD level)."""
    img = _blob_u8(rng)
    root = tmp_path / "s" / "registration"
    root.mkdir(parents=True)
    segs, tables = [], None
    for r in range(0, 200, 64):
        for c in range(0, 160, 64):
            blk = np.pad(img[r:r + 64, c:c + 64],
                         ((0, max(0, r + 64 - 200)), (0, max(0, c + 64 - 160))),
                         mode="edge")
            tables, data = chip_smoke.jpeg_split(_jpeg(blk, quality=92))
            segs.append(data)
    jpg = str(root / "j.tif")
    tags = chip_smoke.gray_jpeg_tags(200, 160, (64, 64), tables)
    chip_smoke.write_segment_tiff(jpg, [(tags, segs)])
    flt = str(root / "f.tif")
    chip_smoke.write_segment_tiff(flt, [_float_page(img.astype(np.float32)
                                                    / 255, 8, rows=16)])
    pyr = str(root / "p.tif")
    half = _jpeg_page(img[::2, ::2], rows=100)
    chip_smoke.write_segment_tiff(pyr, [(tags, segs, [half])])
    return jpg, flt, pyr


def test_streamed_and_pyramid_reads_have_no_fallback(tmp_path, rng):
    jpg, flt, pyr = _slides(tmp_path, rng)
    for path in (jpg, flt):
        for open_source in (jax_slides.open_channel_source,
                            slides.open_channel_source):
            with pytest.raises(NotImplementedError):
                open_source(path, "tif", 0)
    assert slides.pyramid_plan(pyr, "tif", 0, 0.5) == jax_slides.pyramid_plan(
        pyr, "tif", 0, 0.5) == (0, 2, (200, 160), (100, 80))
    for read_level in (jax_slides.read_channel_level,
                       slides.read_channel_level):
        with pytest.raises(NotImplementedError):
            read_level(pyr, "tif", 0, 0)


def _cli_fails(fn):
    try:
        rc = fn()
    except SystemExit as e:
        return e.code not in (0, None)
    except (NotImplementedError, ValueError):
        return True
    return rc != 0


def _outputs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_cli_on_fallback_slides_matches_jax_cli(tmp_path, rng, monkeypatch):
    """Both CLIs on a JPEG TIFF and a predictor-3 float32 TIFF: the same
    files, pages within 1 level.  The port's run has its streaming bound
    cut to 1000 pixels: ``--engine auto`` still takes the whole engine
    (the probe's streamed read refuses), while the same pixels
    uncompressed stream.  ``--engine streaming`` and ``--usePyramid`` fail
    in both."""
    jpg, flt, pyr = _slides(tmp_path, rng)
    monkeypatch.setattr(cli, "MAX_WHOLE_SLIDE_PX", 1000)
    streamed = []
    monkeypatch.setattr(cli, "_run_streaming",
                        lambda *a, **k: streamed.append(a[5]) or 0)
    for src in (jpg, flt):
        common = [src, "--tool", "unmicst-legacy", "--model", "blobDemo",
                  "--modelRoot", MODELS, "--stackOutput"]
        out_j = str(tmp_path / "jax" / os.path.basename(src))
        out_t = str(tmp_path / "torch" / os.path.basename(src))
        assert jax_cli.main(common + ["--outputPath", out_j]) == 0
        assert cli.main(common + ["--outputPath", out_t], device="cpu") == 0
        assert not streamed
        files = _outputs(out_j)
        assert files and files == _outputs(out_t)
        for rel in files:
            a, b = os.path.join(out_j, rel), os.path.join(out_t, rel)
            assert jax_tiff.num_pages(a) == tiff.num_pages(b)
            for k in range(jax_tiff.num_pages(a)):
                pa, pb = jax_tiff.imread(a, k), tiff.imread(b, k)
                assert pa.dtype == pb.dtype and pa.shape == pb.shape
                assert np.abs(pa.astype(int) - pb.astype(int)).max() <= 1
        argv = common + ["--engine", "streaming", "--outputPath",
                         str(tmp_path / "streaming")]
        assert _cli_fails(lambda: jax_cli.main(argv))
        monkeypatch.undo()  # the port's real stream, which must refuse
        assert _cli_fails(lambda: cli.main(argv, device="cpu"))
        monkeypatch.setattr(cli, "MAX_WHOLE_SLIDE_PX", 1000)
        monkeypatch.setattr(cli, "_run_streaming",
                            lambda *a, **k: streamed.append(a[5]) or 0)
    flat = str(tmp_path / "s" / "registration" / "u.tif")
    tiff.imwrite(flat, tiff.imread(jpg))
    assert cli.main([flat, "--model", "blobDemo", "--modelRoot", MODELS,
                     "--stackOutput", "--outputPath", str(tmp_path / "u")],
                    device="cpu") == 0
    assert streamed == ["tif"]  # the uncompressed slide streams
    argv = [pyr, "--model", "blobDemo", "--modelRoot", MODELS, "--usePyramid",
            "--scalingFactor", "0.5", "--outputPath", str(tmp_path / "p")]
    assert _cli_fails(lambda: jax_cli.main(argv))
    assert _cli_fails(lambda: cli.main(argv, device="cpu"))
