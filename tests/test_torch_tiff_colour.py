"""The port's PIL-free TIFF fallback on colour pages
(``unmicst_tpu_torch/io/tiff.py`` ``read_page_fallback``) against the JAX
package's PIL fallback (``unmicst_tpu/io/tiff.py:1274-1291``,
``io/slides.py:66-97``): JPEG pages of 3 samples (compression 7,
photometric 2 and 6, h1v1, h2v1 and h2v2, strips and tiles) and 8-bit RGB
pages stored plane by plane (PlanarConfiguration 2) under every codec the
port decodes, each ``[H, W, 3] uint8`` as JAX's ``imread`` returns them,
with the native library and without it; the refusals both share; and
both CLIs refusing such a slide."""

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
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_tiff_bilevel")
COLOUR = sorted(f[:-4] for f in os.listdir(FIXTURES)
                if f.startswith(("jpeg_rgb", "jpeg_ycbcr", "planar_"))
                and f.endswith(".tif"))
CODECS = {"none": 1, "packbits": 32773, "lzw": 5, "deflate": 8,
          "adobe_deflate": 32946, "lzma": 34925, "zstd": 50000}


@pytest.fixture(params=["native", "python"])
def codecs(request, monkeypatch):
    """Each test once with the native library and once without it."""
    assert _native.get_lib() is not None, "the native library did not load"
    if request.param == "python":
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    return request.param


def _reads(path):
    """(JAX imread, JAX read_channel, port imread, port read_channel)."""
    return (jax_tiff.imread(path), jax_slides.read_channel(path, "tif", 0),
            tiff.imread(path), slides.read_channel(path, "tif", 0))


def _rgb(rng, h=45, w=70):
    yy, xx = np.mgrid[:h, :w]
    return np.clip(np.stack([120 + 90 * np.sin(yy / 4.0 + c)
                             * np.cos(xx / 6.0 - c) + rng.randn(h, w) * 18
                             for c in range(3)], -1), 0, 255).astype(np.uint8)


def _jpeg(block, **kwargs):
    buf = io.BytesIO()
    Image.fromarray(block).save(buf, "JPEG", **kwargs)
    return buf.getvalue()


def test_fixtures_are_the_listed_kinds():
    assert COLOUR == ["jpeg_rgb_pil", "jpeg_ycbcr_h1v1_strips",
                      "jpeg_ycbcr_h2v1_strips", "jpeg_ycbcr_h2v2_strips",
                      "jpeg_ycbcr_h2v2_tiles", "jpeg_ycbcr_notag",
                      "planar_deflate_tiles", "planar_lzw_pred2"]
    for name in COLOUR:
        with tiff.TiffFile(os.path.join(FIXTURES, name + ".tif")) as tf:
            page = tf.pages[0]
            assert page.samples == 3 and page.bits == 8
            if name.startswith("planar"):
                assert page.planar == 2 and page.photometric == 2
            else:
                assert page.compression == 7 and page.planar == 1
                assert page.photometric == (2 if "rgb" in name else 6)


@pytest.mark.parametrize("name", COLOUR)
def test_colour_pages_read_as_jax_reads_them(name, codecs):
    """PIL's own RGB JPEG save (photometric 2), YCbCr JPEG pages at h1v1,
    h2v1 and h2v2 in strips (the last coded taller), in tiles and without
    the YCbCrSubsampling tag, and planar RGB pages: each of the port's
    reads is JAX's (PIL's) ``[H, W, 3] uint8`` and the committed read."""
    path = os.path.join(FIXTURES, name + ".tif")
    want = np.load(path[:-4] + ".npy")
    assert want.dtype == np.uint8 and want.shape == (45, 70, 3)
    for got in _reads(path):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


PLANAR = [(codec, predictor, tiled) for codec in CODECS
          for predictor in (1, 2) for tiled in (False, True)]


@pytest.mark.parametrize(
    "codec,predictor,tiled", PLANAR,
    ids=[f"{c}-pred{p}-{'tiles' if t else 'strips'}" for c, p, t in PLANAR])
def test_planar_rgb_pages(codec, predictor, tiled, tmp_path, rng, codecs):
    """8-bit RGB, PlanarConfiguration 2, under each codec, predictor 1 and
    2, in strips of 16 rows or 16 x 32 tiles: the port's reads are JAX's;
    predictor 2 is undone per plane where libtiff applies it (LZW,
    Deflate, LZMA, zstd) and the stored differences come back under none
    and PackBits, as PIL returns them."""
    rgb = _rgb(rng)
    h, w = rgb.shape[:2]
    enc = chip_smoke.segment_encoder(CODECS[codec])
    segs = []
    for c in range(3):
        if tiled:
            blocks = [np.pad(rgb[r:r + 16, k:k + 32, c],
                             ((0, max(0, r + 16 - h)), (0, max(0, k + 32 - w))))
                      for r in range(0, h, 16) for k in range(0, w, 32)]
        else:
            blocks = [rgb[r:r + 16, :, c] for r in range(0, h, 16)]
        for b in blocks:
            b = b.copy()
            if predictor == 2:
                b[:, 1:] = np.diff(b, axis=1)
            segs.append(enc(b.tobytes()))
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]),
            259: (3, [CODECS[codec]]), 262: (3, [2]), 277: (3, [3]),
            284: (3, [2]), 317: (3, [predictor])}
    if tiled:
        tags[322], tags[323] = (4, [32]), (4, [16])
    else:
        tags[278] = (4, [16])
    path = str(tmp_path / "p.tif")
    chip_smoke.write_segment_tiff(path, [(tags, segs)])
    with pytest.raises(NotImplementedError, match="planar"):
        with tiff.TiffFile(path) as tf:  # the reader itself still refuses
            tf.read_page(0)
    jax_i, jax_c, port_i, port_c = _reads(path)
    for got in (port_i, port_c):
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, jax_i)
    np.testing.assert_array_equal(jax_c, jax_i)
    applied = predictor == 1 or codec not in ("none", "packbits")
    assert np.array_equal(port_i, rgb) == applied


def _colour_jpeg_tiff(path, rgb, photometric, sub, tag=None):
    h, w = rgb.shape[:2]
    segs = [_jpeg(np.pad(rgb[r:r + 16], ((0, max(0, r + 16 - h)), (0, 0),
                                         (0, 0)), mode="edge"),
                  quality=90, subsampling=sub) for r in range(0, h, 16)]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [7]),
            262: (3, [photometric]), 277: (3, [3]), 278: (4, [16]),
            284: (3, [1])}
    if tag is not None:
        tags[530] = (3, list(tag))
    chip_smoke.write_segment_tiff(path, [(tags, segs)])


def test_photometric_2_takes_the_components_as_they_are(tmp_path, rng):
    """A YCbCr-coded stream on a photometric 2 page: libtiff turns libjpeg's
    colour conversion off, so both packages return Y, Cb and Cr as the
    page's R, G and B."""
    rgb = _rgb(rng)
    path = str(tmp_path / "p2.tif")
    _colour_jpeg_tiff(path, rgb, 2, 0)
    jax_i, _, port_i, port_c = _reads(path)
    for got in (port_i, port_c):
        np.testing.assert_array_equal(got, jax_i)
    assert np.abs(port_i.astype(int) - rgb).max() > 50  # not converted


@pytest.mark.parametrize("photometric,sub,tag", [
    (6, 2, (1, 1)), (6, 0, (2, 2)), (6, 1, (2, 2)), (2, 1, None),
    (2, 2, None)])
def test_sampling_libtiff_refuses(photometric, sub, tag, tmp_path, rng):
    """A YCbCr page whose streams are sampled otherwise than its
    YCbCrSubsampling tag, and an RGB page of subsampled streams: libtiff
    refuses them ("Improper JPEG sampling factors"), and so does the
    port (``FallbackError``; ``ValueError`` from ``read_channel``)."""
    path = str(tmp_path / "s.tif")
    _colour_jpeg_tiff(path, _rgb(rng), photometric, sub, tag)
    for read in (jax_tiff.imread, tiff.imread):
        with pytest.raises(OSError):
            read(path)
    for read in (jax_slides.read_channel, slides.read_channel):
        with pytest.raises(ValueError, match="unreadable by both"):
            read(path, "tif", 0)


def test_pages_still_queued(tmp_path, rng):
    """Uncompressed planar YCbCr and planar RGBA pages, and a planar JPEG
    page, once queued here, read as JAX reads them now (the planar JPEG
    page, YCbCr at the default 2x2 subsampling, refused by both, as
    libtiff refuses it; ``tests/test_torch_tiff_pages.py`` holds the
    rest).  An interleaved YCbCr page PIL reads past its strips'
    ends stays ``NotImplementedError`` naming ROADMAP M17."""
    rgb = _rgb(rng, 8, 10)
    path = str(tmp_path / "q.tif")
    for photometric, samples in ((6, 3), (2, 4)):
        tags = {256: (4, [10]), 257: (4, [8]), 258: (3, [8] * samples),
                259: (3, [1]), 262: (3, [photometric]),
                277: (3, [samples]), 284: (3, [2])}
        planes = [rgb[..., c % 3].tobytes() for c in range(samples)]
        chip_smoke.write_segment_tiff(path, [(tags, planes)])
        with pytest.raises(NotImplementedError, match="planar TIFF"):
            with tiff.TiffFile(path) as tf:  # the reader itself refuses
                tf.read_page(0)
        got = tiff.imread(path)
        np.testing.assert_array_equal(got, jax_tiff.imread(path))
        np.testing.assert_array_equal(got, np.stack(
            [rgb[..., c % 3] for c in range(samples)], -1))
    tags = {256: (4, [10]), 257: (4, [8]), 258: (3, [8, 8, 8]),
            259: (3, [7]), 262: (3, [6]), 277: (3, [3]), 284: (3, [2])}
    chip_smoke.write_segment_tiff(path, [(tags, [_jpeg(rgb[..., c])
                                                 for c in range(3)])])
    with pytest.raises(OSError):
        jax_tiff.imread(path)
    with pytest.raises(tiff.FallbackError, match="subsampled"):
        tiff.imread(path)
    tags = {256: (4, [10]), 257: (4, [8]), 258: (3, [8, 8, 8]),
            259: (3, [1]), 262: (3, [6]), 277: (3, [3]), 284: (3, [1]),
            530: (3, [2, 2])}
    chip_smoke.write_segment_tiff(path, [(tags, [bytes(120)])])
    with pytest.raises(NotImplementedError, match="M17"):
        tiff.imread(path)


def test_both_clis_refuse_a_planar_rgb_slide(tmp_path, rng):
    """JAX's CLI unpacks the plane's shape and raises ``ValueError``; the
    port's raises ``ValueError`` naming the shape, as it does for an
    interleaved RGB page."""
    root = tmp_path / "s"
    root.mkdir()
    path = str(root / "planar.tif")
    with open(os.path.join(FIXTURES, "planar_lzw_pred2.tif"), "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data)
    argv = [path, "--tool", "unmicst-legacy", "--model", "blobDemo",
            "--modelRoot", MODELS, "--outputPath", str(tmp_path / "out")]
    with pytest.raises(ValueError):
        jax_cli.main(argv)
    with pytest.raises(ValueError, match=r"\(45, 70, 3\)"):
        cli.main(argv, device="cpu")
