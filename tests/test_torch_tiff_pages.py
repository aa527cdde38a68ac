"""The TIFF pages the port's fallback (``unmicst_tpu_torch/io/tiff.py``
``read_page_fallback``) reads as the JAX package reads them through PIL
(``unmicst_tpu/io/tiff.py:1274-1291``, ``io/slides.py:66-97``), on the
fixtures of ``tests/fixtures/torch_tiff_pages`` and on pages built here:
old-style JPEG in the table form, in several strips or tiles and with its
own YCbCr coefficients; subsampled and planar YCbCr; planar RGBA and
JPEG; 1/2/4-bit palette pages.  Each read through ``tiff.imread`` and
``slides.read_channel``, bit-exact, with the native library and without
it; the refusals against PIL's; and both CLIs on the new gray kinds."""

import io
import os

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from unmicst_tpu import cli as jax_cli
from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu_torch import cli
from unmicst_tpu_torch.io import _native, slides, tiff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_tiff_pages")
PAGES = sorted(f[:-4] for f in os.listdir(FIXTURES) if f.endswith(".tif")
               and not f.startswith("slide_"))


@pytest.fixture(params=["native", "python"])
def codecs(request, monkeypatch):
    """Each test once with the native library and once without it (the
    Python LZW, PackBits and JPEG scan decoders)."""
    assert _native.get_lib() is not None, "the native library did not load"
    if request.param == "python":
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    return request.param


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001
        return None, type(e)


def _assert_reads_match(path, page=0):
    """JAX's ``imread`` and ``read_channel`` against the port's: the same
    dtype, shape and values, or both refusing (``read_channel``'s
    ``ValueError`` in both; from ``imread`` an ``OSError`` in the port,
    PIL's ``OSError`` or ``ValueError`` in JAX).  Returns the port's
    ``imread``, or None where both refuse."""
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
            assert issubclass(jax_err, (OSError, ValueError)), jax_err
            assert issubclass(port_err, (OSError, ValueError)), port_err
            got.append(None)
            continue
        assert port_err is None, f"the port raises {port_err}"
        assert have.dtype == want.dtype and have.shape == want.shape
        np.testing.assert_array_equal(have, want)
        got.append(have)
    assert (got[0] is None) == (got[1] is None)
    return got[0]


# -- the fixtures -------------------------------------------------------------


def test_fixtures_are_the_listed_kinds():
    kinds = set()
    for name in PAGES:
        with tiff.TiffFile(os.path.join(FIXTURES, name + ".tif")) as tf:
            p = tf.pages[0]
            kinds.add((p.compression, p.photometric, p.planar, p.samples,
                       p.bits, p.tiled))
    assert {k[0] for k in kinds} == {1, 4, 5, 6, 7, 8, 32773}
    assert {(k[1], k[4]) for k in kinds if k[1] == 3} == {(3, 1), (3, 2),
                                                          (3, 4)}
    assert {k[:4] for k in kinds if k[2] == 2} >= {
        (1, 6, 2, 3), (5, 6, 2, 3), (1, 2, 2, 4), (7, 2, 2, 3),
        (7, 6, 2, 3), (7, 2, 2, 4)}
    total = sum(os.path.getsize(os.path.join(FIXTURES, f))
                for f in os.listdir(FIXTURES))
    assert len(PAGES) == 39 and total < 700 << 10


@pytest.mark.parametrize("name", PAGES)
def test_pages_read_as_jax_reads_them(name, codecs):
    """Every fixture: both packages' reads equal PIL's committed read."""
    path = os.path.join(FIXTURES, name + ".tif")
    got = _assert_reads_match(path)
    want = np.load(path[:-4] + ".npy")
    assert got is not None and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_the_reader_refuses_each_kind_first():
    """The fallback is reached only where the reader refuses the page:
    every fixture makes ``TiffFile`` raise."""
    for name in PAGES:
        with tiff.TiffFile(os.path.join(FIXTURES, name + ".tif")) as tf:
            with pytest.raises((NotImplementedError, ValueError)):
                tf.read_page(0)


# -- old-style JPEG built here ------------------------------------------------


def _waves(rng, h, w, channels=0):
    yy, xx = np.mgrid[:h, :w]
    layers = [120 + 90 * np.sin(yy / 4.0 + c) * np.cos(xx / 6.0 - c)
              + rng.randn(h, w) * 18 for c in range(max(channels, 1))]
    out = np.clip(np.stack(layers, -1), 0, 255).astype(np.uint8)
    return out if channels else out[..., 0]


def _jpeg(img, **kwargs):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kwargs)
    return buf.getvalue()


@pytest.mark.parametrize("sub", [0, 1, 2])
@pytest.mark.parametrize("form", ["tables", "jif"])
def test_old_jpeg_strips_every_sampling(sub, form, tmp_path):
    """YCbCr pages at h1v1, h2v1 and h2v2 in strips of one MCU row, in
    both forms, with and without the YCbCrSubsampling tag (the table form
    then takes 2x2, the JPEGInterchangeFormat form the stream's)."""
    rng = np.random.RandomState(sub)
    hv = ((1, 1), (2, 1), (2, 2))[sub]
    parts = chip_smoke.jpeg_parts(_jpeg(_waves(rng, 48, 56, 3), quality=88,
                                        subsampling=sub,
                                        restart_marker_rows=1))
    path = str(tmp_path / "o.tif")
    for tags in ({530: (3, list(hv))}, {}):
        if form == "tables" and not tags and hv != (2, 2):
            continue  # a stream PIL takes for 2x2 and corrupt
        chip_smoke.ojpeg_tiff(path, 48, 56, parts, parts["intervals"],
                              photometric=6, rows_per_strip=8 * hv[1],
                              form=form, tags=tags)
        assert _assert_reads_match(path).shape == (48, 56, 3)


def test_old_jpeg_restart_interval_and_tiles(tmp_path):
    """Strips shorter than the page make libtiff's restart interval one
    strip's MCUs whatever tag 515 says; a page in one strip keeps the
    tag's; tiles in one column are one frame; a taller frame is
    cropped."""
    rng = np.random.RandomState(3)
    img = _waves(rng, 64, 80)
    parts = chip_smoke.jpeg_parts(_jpeg(img, quality=90,
                                        restart_marker_rows=2))
    path = str(tmp_path / "o.tif")
    for kwargs in (dict(rows_per_strip=16, tags={515: (3, [3])}),
                   dict(tile=(16, 80)), dict(tile=(32, 80))):
        if kwargs.get("tile") == (32, 80):
            parts = chip_smoke.jpeg_parts(_jpeg(img, quality=90,
                                                restart_marker_rows=4))
        chip_smoke.ojpeg_tiff(path, 64, 80, parts, parts["intervals"],
                              **kwargs)
        assert _assert_reads_match(path).shape == (64, 80)
    one = chip_smoke.jpeg_parts(_jpeg(img, quality=90,
                                      restart_marker_rows=2))
    chip_smoke.ojpeg_tiff(path, 64, 80, one, [b"".join(
        p + bytes((0xFF, 0xD0 + k % 8)) for k, p in enumerate(
            one["intervals"][:-1])) + one["intervals"][-1]])
    assert _assert_reads_match(path).shape == (64, 80)  # DRI by tag 515
    tall = chip_smoke.jpeg_parts(_jpeg(_waves(rng, 48, 80), quality=90,
                                       restart_marker_rows=2))
    chip_smoke.ojpeg_tiff(path, 40, 80, tall, tall["intervals"],
                          tile=(16, 80))
    assert _assert_reads_match(path).shape == (40, 80)


def test_old_jpeg_refusals_and_queued(tmp_path):
    """Refused where libtiff refuses: no tables, strips of a height that
    is not a multiple of the MCU's.  Tiles in more than one column (where
    libtiff decodes a frame one tile wide and PIL returns what it holds):
    ``NotImplementedError`` naming ROADMAP M17."""
    img = _waves(np.random.RandomState(4), 64, 80)
    parts = chip_smoke.jpeg_parts(_jpeg(img, quality=90,
                                        restart_marker_rows=2))
    path = str(tmp_path / "o.tif")
    chip_smoke.ojpeg_tiff(path, 64, 80, parts, parts["intervals"],
                          rows_per_strip=16, tags={519: (4, [0])})
    assert _assert_reads_match(path) is None
    with pytest.raises(tiff.FallbackError, match="missing JPEG tables"):
        tiff.imread(path)
    chip_smoke.ojpeg_tiff(path, 64, 80, parts, parts["intervals"] * 2,
                          rows_per_strip=12)
    assert _assert_reads_match(path) is None
    quad = np.concatenate([img[:32, :40], img[:32, 40:], img[32:, :40],
                           img[32:, 40:]])
    parts = chip_smoke.jpeg_parts(_jpeg(quad, quality=90,
                                        restart_marker_rows=4))
    chip_smoke.ojpeg_tiff(path, 64, 80, parts, parts["intervals"],
                          tile=(32, 40))
    assert jax_tiff.imread(path).shape == (64, 80)
    with pytest.raises(NotImplementedError, match="2 columns of tiles.*M17"):
        tiff.imread(path)


# -- subsampled YCbCr, planar pages and palettes built here -------------------


def _ycbcr_tiff(path, rng, hs, vs, comp, h=19, w=27, rows=8, tags=None):
    y = rng.randint(0, 256, (h, w))
    bh, bw = -(-rows // vs), -(-w // hs)
    segs = []
    for r in range(0, h, rows):
        block = np.pad(y[r:r + rows], ((0, bh * vs - min(rows, h - r)),
                                       (0, bw * hs - w)), mode="edge")
        lum = block.reshape(bh, vs, bw, hs).transpose(0, 2, 1, 3).reshape(
            bh, bw, vs * hs)
        units = np.concatenate([lum, rng.randint(0, 256, (bh, bw, 2))], -1)
        segs.append(chip_smoke.segment_encoder(comp)(
            units.astype(np.uint8).tobytes()))
    base = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * 3),
            259: (3, [comp]), 262: (3, [6]), 277: (3, [3]), 278: (4, [rows]),
            284: (3, [1]), 530: (3, [hs, vs])}
    chip_smoke.write_segment_tiff(path, [({**base, **(tags or {})}, segs)])


@pytest.mark.parametrize("sampling", [(2, 1), (2, 2), (4, 1), (4, 2),
                                      (4, 4), (1, 2), (2, 4)])
@pytest.mark.parametrize("comp", [5, 8, 32773, 34925])
def test_subsampled_ycbcr(sampling, comp, tmp_path):
    """Every subsampling under every codec, 30 wide (8 blocks of 4): pages
    converted as libtiff's RGBA interface converts them, 2x4 refused by
    both."""
    path = str(tmp_path / "y.tif")
    _ycbcr_tiff(path, np.random.RandomState(sum(sampling) + comp), *sampling,
                comp, w=30)
    got = _assert_reads_match(path)
    assert (got is None) == (sampling == (2, 4))


def test_subsampled_ycbcr_queued(tmp_path):
    """Where PIL returns garbage, the port raises ``NotImplementedError``
    naming ROADMAP M17: an uncompressed page (PIL's own reader takes its
    bytes for samples that are not subsampled) and strips at 4x4 whose
    block row is not a multiple of 4 bytes (libtiff reads them short)."""
    path = str(tmp_path / "y.tif")
    for sampling, comp, w in (((2, 2), 1, 27), ((2, 1), 1, 27),
                              ((4, 4), 5, 27)):
        _ycbcr_tiff(path, np.random.RandomState(5), *sampling, comp, w=w)
        jax_tiff_outcome = _outcome(lambda: jax_tiff.imread(path))
        assert jax_tiff_outcome[1] in (None, OSError)
        with pytest.raises(NotImplementedError, match="M17"):
            tiff.imread(path)


def test_ycbcr_coefficients_and_reference(tmp_path):
    """YCbCrCoefficients and ReferenceBlackWhite of several kinds, from
    Rec. 709 to a reference beyond 255; a tag of another count is
    ignored, as libtiff ignores it; a zero green coefficient is
    refused."""
    path = str(tmp_path / "y.tif")
    rng = np.random.RandomState(7)
    for luma, ref in (((2125, 7154, 721), None), (None, (16, 235, 128, 240,
                                                         128, 240)),
                      ((2500, 5000, 2500), (10, 250, 100, 200, 120, 230)),
                      (None, (0, 300, 128, 255, 3, 255)),
                      ((2990, 5870), None)):
        tags = {}
        if luma:
            tags[529] = (5, [v for x in luma for v in (x, 10000)])
        if ref:
            tags[532] = (5, [v for x in ref for v in (x, 1)])
        _ycbcr_tiff(path, rng, 2, 2, 5, tags=tags)
        assert _assert_reads_match(path) is not None
    _ycbcr_tiff(path, rng, 2, 2, 5, tags={529: (5, [1, 3, 0, 1, 1, 9])})
    assert _assert_reads_match(path) is None


@pytest.mark.parametrize("extra", [None, [0], [1], [2]])
@pytest.mark.parametrize("comp", [1, 5, 8, 7])
def test_planar_rgba_every_alpha(extra, comp, tmp_path):
    """Planar RGBA under ExtraSamples absent, unspecified, associated and
    unassociated, uncompressed (PIL's reader), compressed and as JPEG
    planes (libtiff): stored, premultiplied and divided out, or refused,
    as PIL does."""
    rng = np.random.RandomState(comp)
    img = _waves(rng, 21, 30, 4)
    img[0, :5, 3], img[1, :5, 3] = 0, 255
    segs = [_jpeg(np.ascontiguousarray(img[..., c]), quality=90) if comp == 7
            else chip_smoke.segment_encoder(comp)(img[..., c].tobytes())
            for c in range(4)]
    tags = {256: (4, [30]), 257: (4, [21]), 258: (3, [8] * 4),
            259: (3, [comp]), 262: (3, [2]), 277: (3, [4]), 278: (4, [21]),
            284: (3, [2])}
    if extra is not None:
        tags[338] = (3, extra)
    path = str(tmp_path / "p.tif")
    chip_smoke.write_segment_tiff(path, [(tags, segs)])
    got = _assert_reads_match(path)
    assert (got is None) == (extra == [0] or (extra == [1] and comp == 1))


@pytest.mark.parametrize("sub", [None, (1, 1), (2, 1)])
@pytest.mark.parametrize("comp", [1, 5, 7])
def test_planar_ycbcr(sub, comp, tmp_path):
    """Planar YCbCr: stored planes as RGB uncompressed, whatever the tag;
    converted at 1x1 compressed, refused at other subsamplings."""
    rng = np.random.RandomState(11)
    img = _waves(rng, 24, 30, 3)
    segs = [_jpeg(np.ascontiguousarray(img[..., c]), quality=90) if comp == 7
            else chip_smoke.segment_encoder(comp)(img[..., c].tobytes())
            for c in range(3)]
    tags = {256: (4, [30]), 257: (4, [24]), 258: (3, [8] * 3),
            259: (3, [comp]), 262: (3, [6]), 277: (3, [3]), 278: (4, [24]),
            284: (3, [2])}
    if sub:
        tags[530] = (3, list(sub))
    path = str(tmp_path / "p.tif")
    chip_smoke.write_segment_tiff(path, [(tags, segs)])
    got = _assert_reads_match(path)
    assert (got is None) == (comp != 1 and sub != (1, 1))


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("fill", [1, 2])
def test_palette_pages(bits, fill, tmp_path):
    """Palette pages: the indices as stored (PIL's mode ``P``), 1-bit
    ones as uint8 too, under LZW and uncompressed; at FillOrder 2 libtiff
    reverses a compressed page's bits, and PIL's own reader refuses an
    uncompressed one."""
    rng = np.random.RandomState(bits)
    idx = rng.randint(0, 1 << bits, (17, 23))
    path = str(tmp_path / "p.tif")
    for comp in (5, 1):
        chip_smoke.packed_tiff(path, idx, bits, comp, 8, photometric=3,
                               fill_order=fill,
                               colormap=rng.randint(0, 65536, 3 << bits))
        got = _assert_reads_match(path)
        if fill == 2 and comp == 1:
            assert got is None
            continue
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, idx)


# -- the CLIs -----------------------------------------------------------------


def _outputs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("name", ["slide_ojpeg_table", "slide_ojpeg_jif",
                                  "slide_palette4"])
def test_cli_matches_jax_cli(name, tmp_path):
    """Both CLIs on the new gray kinds: an old-style JPEG slide in the
    table form and in the JPEGInterchangeFormat form in strips, and a
    4-bit palette slide: the same files, pages within 1 uint8 level."""
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
