"""The port's JPEG writer (``unmicst_tpu_torch/io/jpegenc.py``) against
the JAX toolbox's ``imwrite`` (``unmicst_tpu/utils/imtools.py:60-67``:
``Image.fromarray(x).save(path)``, libjpeg-turbo at PIL's defaults) on
the same arrays: the files byte for byte under each JPEG extension, at
sizes that are no multiples of 8 or 16; the errors PIL raises; the
Huffman coder's native and plain versions against each other."""

import os

import numpy as np
import pytest

from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch.io import _native, jpeg, jpegenc
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_jpeg_write")
WRITES = sorted(f[6:-4] for f in os.listdir(FIXTURES)
                if f.startswith("write_") and f.endswith(".npy"))
SIZES = [(1, 1), (13, 17), (257, 300), (37, 45)]


@pytest.fixture(params=["native", "python"])
def codecs(request, monkeypatch):
    """Each test once with the native library and once without it."""
    assert _native.get_lib() is not None, "the native library did not load"
    if request.param == "python":
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    return request.param


def _image(kind, size, rng):
    """A seeded image: noise, or smooth waves with a little noise (where
    the coefficients run long zero runs and small values)."""
    h, w = size
    if kind == "bool":
        return rng.randint(0, 2, size).astype(bool)
    shape = size if kind.startswith("gray") else size + (3,)
    if kind.endswith("smooth"):
        yy, xx = np.mgrid[:h, :w]
        base = 128 + 80 * np.sin(yy / 5.0) * np.cos(xx / 7.0)
        if len(shape) == 3:
            base = np.stack([base, base[::-1], 255 - base], -1)
        return np.clip(base + rng.randint(-6, 6, shape), 0, 255).astype(
            np.uint8)
    return rng.randint(0, 256, shape).astype(np.uint8)


def _jax_bytes(x, path):
    J.imwrite(x, path)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", ["bool", "gray", "gray_smooth", "rgb",
                                  "rgb_smooth"])
def test_imwrite_jpeg_is_byte_equal_to_jax(kind, size, codecs, tmp_path):
    """``imwrite(x, "x.jpg")``: the port's file is the JAX package's
    (PIL's) byte for byte, and both read it back alike."""
    if codecs == "python" and size == (257, 300) and kind != "gray":
        size = (61, 75)  # the plain coder is a Python loop a coefficient
    x = _image(kind, size, np.random.RandomState(sum(size) + len(kind)))
    want = _jax_bytes(x, str(tmp_path / "jax.jpg"))
    path = str(tmp_path / "port.jpg")
    T.imwrite(x, path)
    with open(path, "rb") as f:
        assert f.read() == want
    got = T.imread(path)
    ref = J.imread(str(tmp_path / "jax.jpg"))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ext", [".jpg", ".jpeg", ".jpe", ".jfif", ".JPG"])
def test_every_jpeg_extension(ext, tmp_path):
    x = _image("rgb_smooth", (20, 33), np.random.RandomState(7))
    want = _jax_bytes(x, str(tmp_path / f"jax{ext}"))
    T.imwrite(x, str(tmp_path / f"port{ext}"))
    with open(str(tmp_path / f"port{ext}"), "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("name", WRITES)
def test_committed_writes_are_byte_equal(name):
    x = np.load(os.path.join(FIXTURES, f"write_{name}.npy"))
    with open(os.path.join(FIXTURES, f"write_{name}.jpg"), "rb") as f:
        assert jpegenc.encode_jpeg(x) == f.read()


@pytest.mark.parametrize("shape,dtype", [
    ((5, 6, 4), np.uint8), ((5, 6, 2), np.uint8), ((5, 6), np.uint16),
    ((5, 6), np.int16), ((5, 6), np.int32), ((5, 6), np.float32),
    ((5, 6), np.float64), ((5, 6, 3), np.uint16), ((5, 6, 3), np.float32),
    ((5, 6), np.int64), ((0, 5), np.uint8), ((5, 0, 3), np.uint8),
    ((1, 65501), np.uint8)])
def test_refusals_raise_pil_s_class(shape, dtype, tmp_path):
    """RGBA, LA, I;16, I and F raise ``OSError`` (PIL's "cannot write
    mode ... as JPEG"); a dtype ``fromarray`` has no mode for,
    ``TypeError``; an empty image ``ValueError``; a side past libjpeg's
    65500 ``OSError``: the same class from both packages."""
    x = np.zeros(shape, dtype)
    errors = []
    for write, path in ((J.imwrite, "j.jpg"), (T.imwrite, "t.jpg")):
        with pytest.raises((OSError, TypeError, ValueError)) as e:
            write(x, str(tmp_path / path))
        errors.append(e.type)
    assert errors[0] is errors[1] or issubclass(errors[0], errors[1])


def test_huffman_coders_agree():
    """Random coefficient blocks, large and small, long zero runs (ZRL),
    values that code to 0xFF bytes: native and plain write the same
    bytes, every 0xFF stuffed."""
    rng = np.random.RandomState(5)
    dc = [jpegenc.huff_codes(jpegenc._STD_HUFF[(0, t)]) for t in (0, 1, 1)]
    ac = [jpegenc.huff_codes(jpegenc._STD_HUFF[(1, t)]) for t in (0, 1, 1)]
    for trial in range(20):
        n = int(rng.randint(1, 300))
        blocks = np.zeros((n, 64), np.int16)
        mask = rng.rand(n, 64) < rng.choice([0.02, 0.2, 0.9])
        scale = int(rng.choice([3, 60, 1000]))
        blocks[mask] = rng.randint(-scale, scale + 1, mask.sum())
        blocks[:, 0] = rng.randint(-2000, 2000, n)
        slots = (rng.randint(0, 3, n) if trial % 2 else np.zeros(n)).astype(
            np.uint8)
        plain = jpegenc.encode_blocks_py(blocks, slots, dc, ac)
        assert _native.jpeg_huff_encode(blocks, slots, dc, ac) == plain
        assert b"\xff" not in plain.replace(b"\xff\x00", b"")


def test_a_written_gray_stream_decodes_to_its_coefficients():
    """The port's writer and decoder agree on the quantised coefficients
    (the dummy-free gray frame): the coefficients decoded equal the
    forward DCT's, block for block."""
    x = _image("gray_smooth", (40, 56), np.random.RandomState(3))
    data = jpegenc.encode_jpeg(x)
    _, coef = jpeg.decode_coefficients(data)
    q = jpegenc.quant_table(jpegenc._BASE_LUMA)
    want = jpegenc._component(x, q).reshape(-1, 64)
    np.testing.assert_array_equal(coef, want)


def test_fdct_of_a_flat_block_is_its_dc():
    """A flat block's islow forward DCT: DC = 8 x 8 x (v - 128), no AC
    (the output is scaled up by 8)."""
    for v in (0, 77, 128, 255):
        out = jpegenc.fdct_islow(np.full((1, 8, 8), v, np.uint8))
        assert out[0, 0] == 64 * (v - 128) and not out[0, 1:].any()
