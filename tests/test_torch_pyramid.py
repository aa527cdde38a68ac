"""Pyramid input and output (ROADMAP M14a) in the port, against the JAX
package on the same files: ``_box_downsample2``, ``TiffWriter.write_pyramid``
in every codec, SubIFD reads, ``pyramid_plan(_multi)``, and the CLI's
``--usePyramid`` / ``--pyramidOutput`` / ``--compressOutput zstd``."""

import os
import struct

import numpy as np
import pytest

from unmicst_tpu import cli as jax_cli
from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu_torch import cli
from unmicst_tpu_torch.io import preprocess as pp
from unmicst_tpu_torch.io import slides
from unmicst_tpu_torch.io import tiff as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")


def _blobs(shape, seed):
    rng = np.random.RandomState(seed)
    img = rng.rand(*shape) * 0.25
    rr, cc = np.ogrid[: shape[0], : shape[1]]
    for _ in range(shape[0] * shape[1] // 4000):
        r, c = rng.randint(10, shape[0] - 10), rng.randint(10, shape[1] - 10)
        img[(rr - r) ** 2 + (cc - c) ** 2 < rng.randint(20, 70)] = 0.8
    return (img * 60000).astype(np.uint16)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16,
                                   np.float32])
@pytest.mark.parametrize("shape", [(64, 48), (33, 17), (1, 5)])
def test_box_downsample2_matches_jax(dtype, shape):
    x = np.random.RandomState(4).rand(*shape) * 200
    x = x.astype(dtype)
    got = tt._box_downsample2(x)
    np.testing.assert_array_equal(got, jax_tiff._box_downsample2(x))
    assert got.dtype == x.dtype


@pytest.mark.parametrize("codec", [None, "deflate", "zstd"])
def test_write_pyramid_matches_jax(tmp_path, codec):
    """Every level pixel-equal to the JAX writer's of the same image, read
    by both readers; JAX's reader reads the port's pyramid; a plain page
    appended after it keeps the chain; a corrupt SubIFD offset raises."""
    rng = np.random.RandomState(5)
    for dtype, img in ((np.uint16, (rng.rand(600, 430) * 65535)),
                       (np.float32, rng.rand(300, 260))):
        img = img.astype(dtype)
        ours, theirs = str(tmp_path / "t.tif"), str(tmp_path / "j.tif")
        with tt.TiffWriter(ours, compression=codec) as tw:
            n = tw.write_pyramid(img, tile=(64, 64), min_size=64)
        with jax_tiff.TiffWriter(theirs, compression=codec) as tw:
            assert tw.write_pyramid(img, tile=(64, 64), min_size=64) == n
        assert n == 2
        tt.imwrite(ours, np.full((40, 40), 7, np.uint8), append=True,
                   compression=codec)
        with tt.TiffFile(ours) as tf, jax_tiff.TiffFile(ours) as jf, \
                jax_tiff.TiffFile(theirs) as jj:
            assert len(tf.pages) == 2 and len(jf.pages) == 2
            assert tf.pages[1].subifds is None
            np.testing.assert_array_equal(tf.read_page(0), img)
            np.testing.assert_array_equal(jf.read_page(1), 7)
            assert len(tf.pages[0].subifds) == n
            for k in range(n):
                want = jj.read_subifd(0, k)
                sub = tf.subifd_page(0, k)
                assert sub.tiled and sub.compression == (
                    {None: 1, "deflate": 8, "zstd": 50000}[codec])
                np.testing.assert_array_equal(tf.read_subifd(0, k), want)
                np.testing.assert_array_equal(jf.read_subifd(0, k), want)
            with pytest.raises(ValueError, match="pyramid level"):
                tf.read_subifd(0, n)
            with pytest.raises(ValueError, match="no SubIFDs"):
                tf.read_subifd(1, 0)
            tf.pages[0].subifds = np.array([os.path.getsize(ours) + 7])
            with pytest.raises(ValueError, match="corrupt SubIFD"):
                tf.read_subifd(0, 0)


def test_subifds_of_field_type_13_parse(tmp_path):
    """Tag 330 as TIFF type 13 (IFD, what tifffile writes on classic
    files) reads as the LONG form does."""
    img = (np.random.RandomState(6).rand(256, 256) * 255).astype(np.uint8)
    p = str(tmp_path / "p13.tif")
    with tt.TiffWriter(p, bigtiff=False) as tw:
        assert tw.write_pyramid(img, tile=(64, 64), min_size=64) == 2
    blob = bytearray(open(p, "rb").read())
    (ifd,) = struct.unpack("<I", blob[4:8])
    (n,) = struct.unpack("<H", blob[ifd : ifd + 2])
    for i in range(n):
        ent = ifd + 2 + 12 * i
        if struct.unpack("<H", blob[ent : ent + 2])[0] == 330:
            struct.pack_into("<H", blob, ent + 2, 13)
    open(p, "wb").write(bytes(blob))
    with tt.TiffFile(p) as tf, jax_tiff.TiffFile(p) as jf:
        np.testing.assert_array_equal(tf.read_subifd(0, 1),
                                      jf.read_subifd(0, 1))


@pytest.fixture(scope="module")
def pyramid_file(tmp_path_factory):
    """A 1024 x 768 uint16 slide with stored levels 1/2 and 1/4 (zstd,
    tiled), the 1/2 level as a plain TIFF, and a flat copy."""
    d = tmp_path_factory.mktemp("pyr")
    img = _blobs((1024, 768), 7)
    src = str(d / "pyr.tif")
    with tt.TiffWriter(src, compression="zstd") as tw:
        assert tw.write_pyramid(img, tile=(128, 128), min_size=128) == 2
    with tt.TiffFile(src) as tf:
        level = tf.read_subifd(0, 0)
    lvl = str(d / "lvl.tif")
    tt.imwrite(lvl, level)
    flat = str(d / "flat.tif")
    tt.imwrite(flat, img)
    return img, src, lvl, flat


def test_pyramid_plans_match_jax(pyramid_file, tmp_path):
    img, src, _, flat = pyramid_file
    two = str(tmp_path / "two.tif")  # channel 1 has no levels
    with tt.TiffWriter(two) as tw:
        tw.write_pyramid(img[:512, :512], tile=(128, 128), min_size=128)
        tw.write(img[:512, :512])
    for path, chans in ((src, [0]), (flat, [0]), (two, [0]), (two, [1]),
                        (two, [0, 1]), (src, [0, 0])):
        for sf in (0.5, 0.3, 0.25, 0.2, 0.6, 1.0, 0.0):
            for bound in (None, 100_000, 10_000):
                args = (path, "tif", chans, sf)
                assert (slides.pyramid_plan_multi(*args, max_level_px=bound)
                        == jax_slides.pyramid_plan_multi(
                            *args, max_level_px=bound)), (path, chans, sf)
            assert (slides.pyramid_plan(path, "tif", chans[-1], sf)
                    == jax_slides.pyramid_plan(path, "tif", chans[-1], sf))
    assert slides.pyramid_plan(src, "tif", 0, 0.25)[:2] == (1, 4)
    assert slides.pyramid_plan(src, "czi", 0, 0.5) is None
    np.testing.assert_array_equal(
        slides.read_channel_level(src, "tif", 0, 1),
        jax_slides.read_channel_level(src, "tif", 0, 1))


def _pages(path):
    with tt.TiffFile(path) as tf:
        return [tf.read_page(k) for k in range(len(tf.pages))]


@pytest.mark.parametrize("flags", [
    ["--scalingFactor", "0.5", "--pyramidOutput", "--compressOutput",
     "zstd"],
    ["--scalingFactor", "0.3"],
])
def test_cli_use_pyramid_matches_jax(pyramid_file, tmp_path, flags):
    """``--usePyramid`` reads the stored 1/2 level (the residual scale 1
    or 0.6 on the card's resize path), pages within 1 level of the JAX
    CLI's and equal to the port's own run on the level plane, brought
    back to the full size; ``--pyramidOutput --compressOutput zstd`` pages
    carry zstd SubIFD levels both readers read alike."""
    img, src, lvl, _ = pyramid_file
    common = ["--tool", "unmicst-legacy", "--model", "blobDemo",
              "--modelRoot", MODELS, "--stackOutput", "--usePyramid"]
    out_j, out_t = str(tmp_path / "j"), str(tmp_path / "t")
    assert jax_cli.main([src, *common, *flags, "--outputPath", out_j]) == 0
    assert cli.main([src, *common, *flags, "--outputPath", out_t],
                    device="cpu") == 0
    sf = float(flags[1])
    assert cli.main([lvl, *common[:-1], "--scalingFactor", str(sf * 2),
                     "--outputPath", str(tmp_path / "l")],
                    device="cpu") == 0
    name = "pyr_Probabilities_1.tif"
    got = _pages(os.path.join(out_t, name))
    want = _pages(os.path.join(out_j, name))
    level_run = _pages(str(tmp_path / "l" / "lvl_Probabilities_1.tif"))
    assert len(got) == len(want) == 3
    for a, b, c in zip(got, want, level_run):
        assert a.shape == img.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        np.testing.assert_array_equal(a, pp.upscale_pm(c, img.shape))
    pyramid_out = "--pyramidOutput" in flags
    with tt.TiffFile(os.path.join(out_t, name)) as tf, \
            jax_tiff.TiffFile(os.path.join(out_j, name)) as jf:
        for k in range(3):
            assert tf.pages[k].compression == (50000 if pyramid_out else 1)
            assert (tf.pages[k].subifds is None) == (not pyramid_out)
            if pyramid_out:
                d = (tf.read_subifd(k, 0).astype(int)
                     - jf.read_subifd(k, 0).astype(int))
                assert np.abs(d).max() <= 1
    a, b = (_pages(os.path.join(o, "qc", "pyr_Preview_1.tif"))
            for o in (out_t, out_j))
    assert np.abs(a[1].astype(int) - b[1].astype(int)).max() <= 1


def test_cli_use_pyramid_notes_and_refusals(pyramid_file, tmp_path,
                                            capsys):
    """A flat input reads the full resolution with a note (as in JAX); an
    explicit streaming engine refuses the combination."""
    img, src, _, flat = pyramid_file
    common = ["--model", "blobDemo", "--modelRoot", MODELS,
              "--scalingFactor", "0.5", "--usePyramid", "--stackOutput"]
    assert cli.main([flat, *common, "--outputPath", str(tmp_path / "f")],
                    device="cpu") == 0
    assert "no usable stored level" in capsys.readouterr().err
    for engine in ("streaming", "sharded"):
        with pytest.raises(SystemExit, match="does not combine"):
            cli.main([src, *common, "--engine", engine, "--outputPath",
                      str(tmp_path / "x")], device="cpu")
