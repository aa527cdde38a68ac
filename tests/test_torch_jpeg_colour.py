"""The port's colour JPEG decode (``unmicst_tpu_torch/io/jpeg.py``: three
components, h1v1/h2v1/h2v2 chroma, libjpeg-turbo's fancy upsampling and
fixed-point YCbCr tables) against PIL, the native scan decoder against the
Python one on interleaved scans, ``utils/imtools.imread`` against the JAX
toolbox's, and a colour CZI block refused as the JAX reader refuses it."""

import glob
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from tests.test_slides_czi_nd2 import _write_czi_blocks
from unmicst_tpu.io import czi as jax_czi
from unmicst_tpu.utils import imtools as jax_imtools
from unmicst_tpu_torch.io import _native, jpeg
from unmicst_tpu_torch.io.czi import CziFile
from unmicst_tpu_torch.utils import imtools

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "torch_tiff_jpeg")
NAMES = sorted(os.path.basename(p)[:-4]
               for p in glob.glob(os.path.join(FIXTURES, "*.jpg")))


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)))


def _encode(img, **kwargs):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kwargs)
    return buf.getvalue()


def _both(data):
    """(native pixels, Python pixels), their coefficients bit-equal."""
    assert _native.get_lib() is not None, "the native library did not load"
    coefs = [jpeg.decode_coefficients(data)[1]]
    pixels = [jpeg.decode(data)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_native, "get_lib", lambda: None)
        coefs.append(jpeg.decode_coefficients(data)[1])
        pixels.append(jpeg.decode(data))
    np.testing.assert_array_equal(*coefs)
    return pixels


def _colour(rng, h, w):
    yy, xx = np.mgrid[:h, :w]
    layers = [120 + 90 * np.sin(yy / 4.0 + c) * np.cos(xx / 6.0 - c)
              + rng.randn(h, w) * 20 for c in range(3)]
    return np.clip(np.stack(layers, -1), 0, 255).astype(np.uint8)


def test_fixtures_are_the_listed_kinds():
    assert NAMES == [f"colour_{s}_{k}" for s in ("420", "422", "444")
                     for k in ("baseline", "progressive")]
    for name in NAMES:
        with open(os.path.join(FIXTURES, name + ".jpg"), "rb") as f:
            frame, scans = jpeg.parse(f.read())
        assert frame.colour == "ycbcr" and len(frame.components) == 3
        sampling = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}[name[7:10]]
        assert (frame.hmax, frame.vmax) == sampling
        assert frame.progressive == name.endswith("progressive")
        assert len(scans) == (1 if name.endswith("baseline") else 10)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_zero_levels_from_pil(name):
    with open(os.path.join(FIXTURES, name + ".jpg"), "rb") as f:
        data = f.read()
    want = np.load(os.path.join(FIXTURES, name + ".npy"))
    np.testing.assert_array_equal(_pil(data), want)
    for got in _both(data):
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


CASES = {
    "1x1_420": ((1, 1), dict(subsampling=2)),
    "2x5_422": ((2, 5), dict(subsampling=1)),  # 3 chroma columns
    "3x4_420": ((3, 4), dict(subsampling=2)),  # 2: plain replication
    "7x9_444_q100": ((7, 9), dict(subsampling=0, quality=100)),
    "17x33_420_progressive": ((17, 33), dict(subsampling=2, progressive=True)),
    "33x17_422_restart": ((33, 17), dict(subsampling=1,
                                         restart_marker_blocks=3)),
    "40x56_420_optimize": ((40, 56), dict(subsampling=2, optimize=True)),
    "64x3_422_progressive_restart": ((64, 3), dict(
        subsampling=1, progressive=True, restart_marker_rows=1)),
    "48x48_444_low_quality": ((48, 48), dict(subsampling=0, quality=5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_more_pil_encodings(case):
    """Sizes down to 1x1 and chroma planes of 1-3 columns, qualities,
    restarts, optimized tables: both decoders 0 levels from PIL."""
    shape, kwargs = CASES[case]
    data = _encode(_colour(np.random.RandomState(sum(map(ord, case))),
                           *shape), **{"quality": 85, **kwargs})
    want = _pil(data)
    for got in _both(data):
        np.testing.assert_array_equal(got, want)


def _adobe_rgb(data):
    """The stream with its JFIF APP0 replaced by an Adobe APP14 whose
    transform is 0: decoders then take the components as R, G, B."""
    assert data[2:4] == b"\xff\xe0"
    n = struct.unpack(">H", data[4:6])[0]
    app14 = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    return data[:2] + app14 + data[4 + n:]


def test_colour_space_markers():
    """JFIF (YCbCr), Adobe transform 0 (RGB, no conversion) and component
    ids 'R', 'G', 'B' without markers, as libjpeg picks the space."""
    img = _colour(np.random.RandomState(3), 24, 40)
    data = _encode(img, quality=90, subsampling=0)
    rgb = _adobe_rgb(data)
    assert jpeg.parse(rgb)[0].colour == "rgb"
    for got in _both(rgb):
        np.testing.assert_array_equal(got, _pil(rgb))
    ids = bytearray(_adobe_rgb(data).replace(
        b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00", b""))
    sof = ids.index(b"\xff\xc0")
    sos = ids.index(b"\xff\xda")
    for k, cid in enumerate(b"RGB"):
        ids[sof + 10 + 3 * k] = cid
        ids[sos + 5 + 2 * k] = cid
    assert jpeg.parse(bytes(ids))[0].colour == "rgb"
    np.testing.assert_array_equal(jpeg.decode(bytes(ids)), _pil(bytes(ids)))


def test_refusals_name_what_is_unsupported():
    buf = io.BytesIO()
    Image.new("CMYK", (16, 8), (10, 20, 30, 40)).save(buf, "JPEG")
    cmyk = buf.getvalue()
    with pytest.raises(ValueError, match="4 components"):
        jpeg.decode(cmyk)
    data = bytearray(_encode(_colour(np.random.RandomState(4), 16, 16),
                             subsampling=0))
    sof = data.index(b"\xff\xc0")
    data[sof + 11] = 0x31  # luma 3x1 against Cb 2x1: a fractional ratio
    data[sof + 14] = 0x21
    with pytest.raises(ValueError, match="sampling factors 3x1/2x1/1x1"):
        jpeg.decode(bytes(data))


def test_corrupt_colour_streams_agree_between_decoders():
    """Byte corruptions of interleaved baseline (with restarts) and
    progressive streams: the native and Python decoders fail together or
    give the same coefficients."""
    rng = np.random.RandomState(8)
    img = _colour(rng, 24, 40)
    fails = 0
    for kwargs in (dict(restart_marker_blocks=2, subsampling=2),
                   dict(progressive=True, subsampling=1)):
        data = _encode(img, quality=80, **kwargs)
        head = data.index(b"\xff\xda")
        for _ in range(60):
            b = bytearray(data)
            for pos in rng.randint(head, len(b) - 2, rng.randint(1, 4)):
                b[pos] = rng.randint(256)
            out = []
            for native in (True, False):
                with pytest.MonkeyPatch.context() as mp:
                    if not native:
                        mp.setattr(_native, "get_lib", lambda: None)
                    try:
                        out.append(jpeg.decode_coefficients(bytes(b))[1])
                    except ValueError:
                        out.append(None)
            if out[0] is None or out[1] is None:
                assert out[0] is None and out[1] is None
                fails += 1
            else:
                np.testing.assert_array_equal(out[0], out[1])
    assert 0 < fails < 120


def test_toolbox_imread_matches_jax(tmp_path):
    """``imtools.imread`` of a colour and a gray ``.jpg``: [H, W, 3] and
    [H, W] uint8, equal to the JAX toolbox's (PIL's)."""
    img = _colour(np.random.RandomState(5), 30, 44)
    for name, arr in (("c.jpg", img), ("g.jpeg", img[..., 1])):
        path = str(tmp_path / name)
        Image.fromarray(arr).save(path, quality=88)
        got, want = imtools.imread(path), jax_imtools.imread(path)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_colour_czi_block_is_refused(tmp_path):
    """A Gray8 CZI whose JPEG sub-block is a colour frame of the
    directory's size: ``ValueError`` in both readers (the JAX one on the
    decoded shape)."""
    data = _encode(_colour(np.random.RandomState(6), 32, 48))
    path = str(tmp_path / "c.czi")
    _write_czi_blocks(path, [(dict(X=(0, 48), Y=(0, 32), C=(0, 1)), data)],
                      pixel_type=0, compression=2)
    with pytest.raises(ValueError, match=r"\(32, 48, 3\)"):
        jax_czi.read_czi_channel(path, 0)
    with CziFile(path) as cz:
        with pytest.raises(ValueError, match=r"decoded to \(32, 48, 3\)"):
            cz.read_channel(0)
