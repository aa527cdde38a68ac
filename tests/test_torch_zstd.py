"""zstd (ROADMAP M14b) in the port: ``io/zstd.py`` through the host's
libzstd, zstd TIFF strips and tiles on read, ``compression="zstd"`` on
write, held to the JAX package (which decodes through ``zstandard``) on
the same files; and the loud refusal where no libzstd loads."""

import io
import os

import numpy as np
import pytest
import zstandard

from tests.test_tiff import _write_strip_tiff
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu.io import zstd as jax_zstd
from unmicst_tpu_torch.io import tiff as tt
from unmicst_tpu_torch.io import zstd


def _declared(data):
    """A frame that declares its content size (zstandard's one-shot)."""
    return zstandard.ZstdCompressor(level=3).compress(data)


def _streaming(data):
    """A frame with no declared size (a stream writer's)."""
    buf = io.BytesIO()
    with zstandard.ZstdCompressor(level=3).stream_writer(
            buf, closefd=False) as w:
        w.write(data)
    return buf.getvalue()


@pytest.fixture
def no_libzstd(monkeypatch):
    """The port as it runs where the host has no libzstd."""
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd, "_checked", True)


def test_the_host_library_is_found():
    assert zstd.available()


@pytest.mark.parametrize("frame", [_declared, _streaming])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_zstd_strips_read_as_jax_reads_them(tmp_path, frame, dtype):
    """Both frame kinds, several strips, the whole page and a window."""
    hi = np.iinfo(dtype).max
    x = (np.random.RandomState(1).rand(150, 97) * hi).astype(dtype)
    fn = str(tmp_path / "z.tif")
    _write_strip_tiff(fn, x, 50000, frame, rows_per_strip=32)
    with jax_tiff.TiffFile(fn) as jf:
        want = jf.read_page(0)
    np.testing.assert_array_equal(want, x)
    with tt.TiffFile(fn) as tf:
        np.testing.assert_array_equal(tf.read_page(0), want)
        np.testing.assert_array_equal(tf.read_region(0, 30, 10, 60, 50),
                                      want[30:90, 10:60])


@pytest.mark.parametrize("frame", [_declared, _streaming])
def test_zstd_strip_bomb_is_bounded(tmp_path, frame):
    """A strip whose frame holds 100 MB where its geometry says 64 bytes:
    refused by the output bound, as the JAX reader refuses it, whether
    the frame declares its size or streams."""
    bomb = frame(bytes(100 << 20))
    fn = str(tmp_path / "b.tif")
    _write_strip_tiff(fn, np.zeros((8, 8), np.uint8), 50000,
                      lambda _: bomb, rows_per_strip=8)
    with pytest.raises(ValueError):
        jax_tiff.TiffFile(fn).read_page(0)
    with tt.TiffFile(fn) as tf:
        with pytest.raises(ValueError, match="zstd"):
            tf.read_page(0)
    with pytest.raises(ValueError):
        zstd.decompress(bomb, 1 << 20)


@pytest.mark.parametrize("level", [None, 1, 9])
@pytest.mark.parametrize("tile", [None, (64, 48)])
def test_zstd_writer_matches_jax_and_frames_stand_alone(tmp_path, level,
                                                        tile):
    """``TiffWriter(compression="zstd")``, strips or tiles, appended: each
    segment is a zstd frame another decoder takes alone, and both readers
    read the pixels the JAX writer wrote from the same image."""
    rng = np.random.RandomState(2)
    a = (rng.rand(300, 200) * 255).astype(np.uint8)
    b = (rng.rand(130, 70) * 65535).astype(np.uint16)
    ours, theirs = str(tmp_path / "t.tif"), str(tmp_path / "j.tif")
    for img, append in ((a, False), (b, True)):
        with tt.TiffWriter(ours, append=append, compression="zstd",
                           compression_level=level) as tw:
            tw.write(img, tile=tile)
        with jax_tiff.TiffWriter(theirs, append=append, compression="zstd",
                                 compression_level=level or 3) as tw:
            tw.write(img, tile=tile)
    with tt.TiffFile(ours) as tf, jax_tiff.TiffFile(ours) as jf, \
            jax_tiff.TiffFile(theirs) as jj:
        for k, img in enumerate((a, b)):
            page = tf.pages[k]
            assert page.compression == 50000 and page.tiled == bool(tile)
            np.testing.assert_array_equal(tf.read_page(k), img)
            np.testing.assert_array_equal(jf.read_page(k), img)
            np.testing.assert_array_equal(jj.read_page(k), img)
        page = tf.pages[0]
        seg = (tile or (page.rows_per_strip, 200))
        with open(ours, "rb") as f:
            f.seek(int(page.offsets[0]))
            frame = f.read(int(page.counts[0]))
        raw = zstandard.ZstdDecompressor().decompress(
            frame, max_output_size=1 << 22)
        assert raw == a[: seg[0], : seg[1]].tobytes()
        assert jax_zstd.decompress(frame, 1 << 22) == raw


def test_compress_and_unpack_hilo_match_jax():
    rng = np.random.RandomState(3)
    data = (rng.rand(5000) * 300).astype(np.uint16).tobytes()
    for level in (1, 3, 19):
        frame = zstd.compress(data, level)
        assert jax_zstd.decompress(frame, len(data)) == data
        assert zstd.decompress(frame, len(data)) == data
    assert zstd.decompress(jax_zstd.compress(data, 3), len(data)) == data
    packed = data[0::2] + data[1::2]
    for buf, item in ((packed, 2), (packed[:-1], 2), (data, 1), (b"", 2)):
        assert zstd.unpack_hilo(buf, item) == jax_zstd.unpack_hilo(buf, item)
    assert zstd.unpack_hilo(packed, 2) == data
    with pytest.raises(ValueError, match="corrupt zstd"):
        zstd.decompress(b"\x28\xb5\x2f\xfd" + bytes(20), 100)


def test_without_libzstd_every_zstd_path_refuses(tmp_path, no_libzstd):
    """No silent way on: read, write and the codec itself raise naming
    ROADMAP M14b and the missing library."""
    x = np.arange(64, dtype=np.uint8).reshape(8, 8)
    fn = str(tmp_path / "z.tif")
    _write_strip_tiff(fn, x, 50000, _declared, rows_per_strip=8)
    for call in (lambda: tt.imread(fn),
                 lambda: tt.TiffWriter(str(tmp_path / "o.tif"),
                                       compression="zstd"),
                 lambda: zstd.compress(b"x"),
                 lambda: zstd.decompress(_declared(b"x"), 1)):
        with pytest.raises(NotImplementedError, match="M14b.*libzstd|"
                                                      "libzstd.*M14b"):
            call()
    assert not zstd.available() and not os.path.exists(
        str(tmp_path / "o.tif"))
