"""Port TIFF/OME reading and writing (unmicst_tpu_torch.io) against PIL and
the JAX package's reader and writer."""

import numpy as np
import pytest
from PIL import Image

from tests.test_tiff import _write_predictor2_tiff, _write_strip_tiff
from unmicst_tpu.io import ome as jax_ome
from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu_torch.io import ome, preprocess, slides
from unmicst_tpu_torch.io import tiff as tt


def _image(dtype, shape=(301, 203), seed=0):
    """Smooth ramps plus noise: runs for PackBits/LZW, entropy for deflate."""
    rng = np.random.RandomState(seed)
    top = np.iinfo(dtype).max
    ramp = np.add.outer(np.arange(shape[0]), np.arange(shape[1])) % 97 / 97
    return (0.7 * ramp * top + 0.3 * rng.rand(*shape) * top).astype(dtype)


@pytest.mark.parametrize("codec", ["raw", "tiff_deflate", "tiff_adobe_deflate",
                                   "tiff_lzw", "packbits"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_reads_pil_strips(tmp_path, codec, dtype):
    x = _image(dtype)
    fn = str(tmp_path / "x.tif")
    Image.fromarray(x).save(fn, compression=codec)
    got = tt.imread(fn)
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_reads_predictor2(tmp_path, dtype):
    x = _image(dtype, (64, 77), seed=1)
    fn = str(tmp_path / "p.tif")
    _write_predictor2_tiff(fn, x)
    np.testing.assert_array_equal(tt.imread(fn), x)


@pytest.mark.parametrize("compression", [None, "deflate"])
def test_reads_tiled_pages(tmp_path, compression):
    x = _image(np.uint16, (200, 150), seed=2)
    fn = str(tmp_path / "t.tif")
    with jax_tiff.TiffWriter(fn, compression=compression) as tw:
        tw.write(x, tile=(64, 64))
    with tt.TiffFile(fn) as tf:
        assert tf.pages[0].tiled
        np.testing.assert_array_equal(tf.read_page(0), x)


@pytest.mark.parametrize("bigtiff", [False, True])
@pytest.mark.parametrize("compression", [None, "deflate"])
def test_writer_append_read_by_pil_and_jax(tmp_path, bigtiff, compression):
    pages = [_image(np.uint8, (300, 200)), _image(np.uint8, (300, 200), 3),
             _image(np.uint16, (50, 70), 4)]
    fn = str(tmp_path / "w.tif")
    for i, page in enumerate(pages):
        tt.imwrite(fn, page, bigtiff=bigtiff, append=i > 0,
                   compression=compression)
    assert tt.num_pages(fn) == jax_tiff.num_pages(fn) == 3
    im = Image.open(fn)
    for i, page in enumerate(pages):
        np.testing.assert_array_equal(jax_tiff.imread(fn, i), page)
        np.testing.assert_array_equal(tt.imread(fn, i), page)
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im), page)


def _ome_xml(order, c, z, t, names=None, tiffdata=""):
    chans = "".join(f'<Channel ID="Channel:0:{i}" Name="{n}"/>'
                    for i, n in enumerate(names or []))
    return ('<?xml version="1.0"?><OME xmlns="http://www.openmicroscopy.org/'
            'Schemas/OME/2016-06"><Image ID="Image:0"><Pixels ID="Pixels:0" '
            f'DimensionOrder="{order}" Type="uint16" SizeX="8" SizeY="8" '
            f'SizeC="{c}" SizeZ="{z}" SizeT="{t}">{chans}{tiffdata}'
            '</Pixels></Image></OME>')


@pytest.mark.parametrize("desc,n_pages", [
    (_ome_xml("XYCZT", 3, 1, 1), 3),
    (_ome_xml("XYZCT", 2, 3, 1), 6),
    (_ome_xml("XYTZC", 2, 2, 2), 8),
    (_ome_xml("XYCZT", 2, 1, 1, tiffdata='<TiffData IFD="1" FirstC="0"/>'
              '<TiffData IFD="0" FirstC="1"/>'), 2),
    (_ome_xml("XYCZT", 3, 1, 1), 5),  # inconsistent: page == channel
    ("not xml", 3),
])
def test_ome_plane_index_matches_jax(desc, n_pages):
    for channel in range(2):
        assert ome.plane_index(desc, channel, n_pages) == \
            jax_ome.plane_index(desc, channel, n_pages)


def test_read_channel_follows_ome_order(tmp_path):
    """Channel 1 of an XYZCT stack (SizeZ 2) is page 2, through both
    packages' read_channel; names resolve as in the JAX package."""
    desc = _ome_xml("XYZCT", 2, 2, 1, names=["DNA", "Lamin"])
    planes = [np.full((8, 8), 100 * i, np.uint16) for i in range(4)]
    fn = str(tmp_path / "s.ome.tif")
    with tt.TiffWriter(fn) as tw:
        for i, p in enumerate(planes):
            tw.write(p, description=desc if i == 0 else None)
    got = slides.read_channel(fn, "ome.tif", 1)
    np.testing.assert_array_equal(got, planes[2])
    np.testing.assert_array_equal(got, jax_slides.read_channel(fn, "ome.tif", 1))
    names = slides.channel_names(fn)
    assert names == ["DNA", "Lamin"]
    assert ome.resolve_name(names, "lamin") == 1
    with pytest.raises(ValueError, match="no channel named"):
        ome.resolve_name(names, "CD3")
    with pytest.raises(NotImplementedError, match="CZI and ND2"):
        slides.read_channel(fn, "czi", 0)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_preview_matches_jax(dtype):
    from unmicst_tpu.io import preprocess as jax_pp

    raw = _image(np.uint16 if dtype == np.float32 else dtype, (40, 30), 5)
    raw = raw.astype(dtype)
    np.testing.assert_array_equal(preprocess.preview_u8_from_raw(raw),
                                  jax_pp.preview_u8_from_raw(raw))


def _lzma(data):
    import lzma

    return lzma.compress(data)  # FORMAT_XZ, what libtiff writes


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_reads_lzma_strips_as_jax_does(tmp_path, dtype):
    """LZMA (34925) strips, whole page and a window, equal to the JAX
    reader on the same file."""
    x = _image(dtype, (150, 97), seed=5)
    fn = str(tmp_path / "l.tif")
    _write_strip_tiff(fn, x, 34925, _lzma)
    with jax_tiff.TiffFile(fn) as jf:
        want = jf.read_page(0)
    with tt.TiffFile(fn) as tf:
        np.testing.assert_array_equal(tf.read_page(0), want)
        np.testing.assert_array_equal(tf.read_region(0, 30, 10, 60, 50),
                                      want[30:90, 10:60])
    np.testing.assert_array_equal(want, x)


def test_lzma_bomb_is_bounded(tmp_path):
    """A strip that inflates far past its geometry stops at the bound, as
    deflate does: the page reads its own bytes and no more."""
    x = np.zeros((4, 4), np.uint8)
    bomb = _lzma(bytes(16 << 20))
    fn = str(tmp_path / "bomb.tif")
    _write_strip_tiff(fn, x, 34925, lambda d: bomb, rows_per_strip=4)
    assert len(tt._decode(bomb, tt.COMPRESSION_LZMA, 16)) <= 16 + 65536
    np.testing.assert_array_equal(tt.imread(fn), x)


def test_lzma_corrupt_and_zstd_refused(tmp_path):
    x = _image(np.uint8, (40, 30), seed=6)
    fn = str(tmp_path / "c.tif")
    _write_strip_tiff(fn, x, 34925, _lzma, rows_per_strip=40)
    blob = bytearray(open(fn, "rb").read())
    blob[12] ^= 0xFF  # mid-stream corruption
    open(fn, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="LZMA"):
        tt.imread(fn)
    zs = str(tmp_path / "z.tif")
    _write_strip_tiff(zs, x, 50000, lambda d: b"\x28\xb5\x2f\xfd" + d,
                      rows_per_strip=40)
    with pytest.raises(NotImplementedError, match="M14"):
        tt.imread(zs)
