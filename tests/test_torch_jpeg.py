"""The port's JPEG decoder (``unmicst_tpu_torch/io/jpeg.py``, ROADMAP M16)
against PIL, the native scan decoder against the Python one, and the
port's CZI reader on JPEG sub-blocks against ``unmicst_tpu.io.czi``."""

import glob
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from tests.test_slides_czi_nd2 import _write_czi_blocks
from unmicst_tpu.io import czi as jax_czi
from unmicst_tpu_torch.io import _native, jpeg, slides
from unmicst_tpu_torch.io.czi import CziFile

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "torch_jpeg")
NAMES = sorted(os.path.basename(p)[:-4]
               for p in glob.glob(os.path.join(FIXTURES, "*.jpg")))


def _fixture(name):
    with open(os.path.join(FIXTURES, name + ".jpg"), "rb") as f:
        data = f.read()
    return data, np.load(os.path.join(FIXTURES, name + ".npy"))


def _pil_jpeg(plane, **kwargs):
    buf = io.BytesIO()
    Image.fromarray(plane, "L" if plane.ndim == 2 else "RGB").save(
        buf, "JPEG", **kwargs)
    return buf.getvalue()


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)))


def _decoders():
    """Run the body once with the native library and once without it
    (the Python scan decoder), as ``tests/test_torch_native.py`` does."""
    assert _native.get_lib() is not None, "the native library did not load"
    yield
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_native, "get_lib", lambda: None)
        yield


def _both(data, shape=None):
    """Both decoders: (native pixels, Python pixels), after checking that
    their coefficients are bit-equal."""
    coefs, pixels = [], []
    for _ in _decoders():
        coefs.append(jpeg.decode_coefficients(data, shape)[1])
        pixels.append(jpeg.decode(data, shape))
    np.testing.assert_array_equal(*coefs)
    return tuple(pixels)


def _levels(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(int) - b.astype(int))
    return int(d.max()), float((d == 1).mean())


def test_fixtures_are_the_listed_kinds():
    assert NAMES == ["blob_baseline", "blob_optimize", "blob_progressive",
                     "blob_restart", "odd_baseline", "odd_progressive"]
    total = sum(os.path.getsize(p) for p in glob.glob(
        os.path.join(FIXTURES, "*")))
    assert total < 2 << 20
    markers = {n: _fixture(n)[0] for n in NAMES}
    assert b"\xff\xc2" in markers["blob_progressive"]
    assert b"\xff\xdd" in markers["blob_restart"]
    assert b"\xff\xd0" in markers["blob_restart"]


@pytest.mark.parametrize("name", NAMES)
def test_fixture_within_a_level_of_pil(name):
    """Native and Python decoders: the same coefficients, and pixels
    within 1 level of PIL's decode (the islow IDCT gives 0)."""
    data, want = _fixture(name)
    np.testing.assert_array_equal(_pil(data), want)
    nat, py = _both(data)
    for got in (nat, py):
        worst, share_one = _levels(got, want)
        print(f"{name}: max {worst} level(s), {share_one:.3e} of pixels 1 "
              "level off PIL")
        assert worst <= 1


CASES = {
    "tiny_1x1": ((1, 1), dict(quality=90)),
    "ragged_7x9": ((7, 9), dict(quality=75)),
    "block_8x8": ((8, 8), dict(quality=100)),
    "ragged_17x33_progressive": ((17, 33), dict(quality=60,
                                                progressive=True)),
    "low_quality": ((40, 56), dict(quality=5)),
    "optimize_progressive": ((48, 40), dict(quality=85, optimize=True,
                                            progressive=True)),
    "progressive_restart": ((64, 72), dict(quality=80, progressive=True,
                                           restart_marker_blocks=3)),
    "restart_rows": ((50, 70), dict(quality=95, restart_marker_rows=1)),
    "qtable_16bit": ((40, 48), dict(qtables=[[300 + i for i in range(64)]])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_more_pil_encodings(case):
    """Sizes, qualities, 16-bit quantisation tables, progressive with
    restarts: both decoders at 0-1 levels of PIL."""
    shape, kwargs = CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    plane = np.clip(120 + 80 * np.sin(yy / 3.0) * np.cos(xx / 5.0)
                    + rng.randn(*shape) * 20, 0, 255).astype(np.uint8)
    data = _pil_jpeg(plane, **kwargs)
    if case == "qtable_16bit":
        assert b"\xff\xdb\x00\x83\x10" in data  # a 16-bit DQT
    want = _pil(data)
    for got in _both(data):
        assert _levels(got, want)[0] <= 1


def _sof(data, marker=None, precision=None, height=None):
    """``data`` with its SOF marker, precision or height rewritten (no
    pixel decodes then)."""
    b = bytearray(data)
    at = b.index(b"\xff\xc0") if b"\xff\xc0" in b else b.index(b"\xff\xc2")
    if marker is not None:
        b[at + 1] = marker
    if precision is not None:
        b[at + 4] = precision
    if height is not None:
        struct.pack_into(">H", b, at + 5, height)
    return bytes(b)


def test_refusals_name_the_marker():
    plane = (np.arange(16 * 24) % 251).astype(np.uint8).reshape(16, 24)
    data = _pil_jpeg(plane, quality=90)
    cases = {
        "SOF3 (lossless)": _sof(data, marker=0xC3),
        # SOF9 and SOF10 decode since the fifth part of M17
        # (tests/test_torch_jpeg_arith.py)
        "SOF11 (arithmetic coding)": _sof(data, marker=0xCB),
        "DNL": _sof(data, height=0),
        "12-bit": _sof(data, precision=12),
    }
    dnl = bytearray(data)  # a DNL segment before EOI
    dnl[-2:-2] = b"\xff\xdc\x00\x04\x00\x10"
    cases["DNL "] = bytes(dnl)
    for what, blob in cases.items():
        for _ in _decoders():
            with pytest.raises(ValueError, match=what.strip()
                               .replace("(", r"\(").replace(")", r"\)")):
                jpeg.decode(blob)
    cmyk = io.BytesIO()  # colour (3 components) decodes since slice 15
    Image.new("CMYK", (16, 16)).save(cmyk, "JPEG")
    with pytest.raises(ValueError, match="4 components"):
        jpeg.decode(cmyk.getvalue())
    with pytest.raises(ValueError, match=r"\(16, 24\), expected \(16, 25\)"):
        jpeg.decode(data, (16, 25))
    with pytest.raises(ValueError, match="no SOI"):
        jpeg.decode(b"garbage" * 10)


def test_every_prefix_raises_as_pil_refuses():
    data, _ = _fixture("odd_progressive")
    for cut in range(len(data)):
        with pytest.raises(Exception):
            _pil(data[:cut])
        for _ in _decoders():
            with pytest.raises(ValueError):
                jpeg.decode(data[:cut])


def test_corrupt_streams_agree_between_decoders():
    """Byte corruptions of a baseline-with-restarts and a progressive
    stream: the native and Python decoders fail together, or give the
    same coefficients."""
    rng = np.random.RandomState(5)
    plane = np.clip(rng.randn(40, 48) * 40 + 128, 0, 255).astype(np.uint8)
    fails = 0
    for kwargs in (dict(restart_marker_blocks=2), dict(progressive=True)):
        data = _pil_jpeg(plane, quality=80, **kwargs)
        head = data.index(b"\xff\xda")  # corrupt the scans, not the tables
        for _ in range(120):
            b = bytearray(data)
            for pos in rng.randint(head, len(b) - 2, rng.randint(1, 4)):
                b[pos] = rng.randint(256)
            out = []
            for _ in _decoders():
                try:
                    out.append(jpeg.decode_coefficients(bytes(b))[1])
                except ValueError:
                    out.append(None)
            if out[0] is None or out[1] is None:
                assert out[0] is None and out[1] is None
                fails += 1
            else:
                np.testing.assert_array_equal(out[0], out[1])
    assert 0 < fails < 240


# -- CZI sub-blocks --------------------------------------------------------------


def _jpeg_czi(path, tiles, pixel_type=0):
    """A mosaic CZI of JPEG sub-blocks: ``tiles`` is ``{(r0, c0):
    (payload, (h, w))}``."""
    _write_czi_blocks(path, [
        (dict(X=(c0, w), Y=(r0, h), C=(0, 1)), payload)
        for (r0, c0), (payload, (h, w)) in sorted(tiles.items())],
        pixel_type=pixel_type, compression=2)


def test_czi_mosaic_reads_as_jax_reads_it(tmp_path):
    """A 2x2 mosaic of the blob fixtures (baseline, optimize, progressive,
    restarts) whole and windowed, against the JAX reader (PIL)."""
    names = ["blob_baseline", "blob_optimize", "blob_progressive",
             "blob_restart"]
    tiles = {(512 * (i // 2), 512 * (i % 2)): (_fixture(n)[0], (512, 512))
             for i, n in enumerate(names)}
    path = str(tmp_path / "m.czi")
    _jpeg_czi(path, tiles)
    want = jax_czi.read_czi_channel(path, 0)
    got = slides.read_channel(path, "czi", 0)
    assert got.dtype == np.uint8 and got.shape == (1024, 1024)
    worst, share = _levels(got, want)
    print(f"JPEG CZI mosaic: max {worst} level(s), {share:.3e} of pixels 1 "
          "level off the JAX reader")
    assert worst <= 1
    with slides.open_channel_source(path, "czi", 0) as src:
        rows = np.concatenate([src.read_rows(r0, 300)
                               for r0 in range(0, 1024, 300)])[:1024]
    np.testing.assert_array_equal(rows, got)


def test_czi_jpeg_failures_name_file_and_block(tmp_path):
    """Every prefix of the payload, a Gray16 block, a colour JPEG and a
    size unlike the directory's: both readers raise ValueError, and the
    port's names the file and the block."""
    data, _ = _fixture("odd_baseline")
    cases = {f"cut{n}": (data[:n], 0, (100, 130))
             for n in range(0, len(data), 7)}
    cases["cut_eoi"] = (data[:-1], 0, (100, 130))
    cases["gray16"] = (data, 1, (100, 130))
    cases["colour"] = (_pil_jpeg(np.zeros((100, 130, 3), np.uint8)), 0,
                       (100, 130))
    cases["size"] = (data, 0, (100, 128))
    for what, (payload, ptype, shape) in cases.items():
        path = str(tmp_path / f"{what}.czi")
        _jpeg_czi(path, {(0, 0): (payload, shape)}, pixel_type=ptype)
        with pytest.raises(ValueError):
            jax_czi.read_czi_channel(path, 0)
        with CziFile(path) as cz:
            with pytest.raises(ValueError) as e:
                cz.read_channel(0)
        assert f"{what}.czi" in str(e.value) and "sub-block at 0x" in str(
            e.value), what


def test_every_prefix_of_a_jpeg_czi_raises_in_both_readers(tmp_path):
    data, _ = _fixture("odd_progressive")
    path = str(tmp_path / "full.czi")
    _jpeg_czi(path, {(0, 0): (data, (100, 130)), (0, 130): (data, (100,
                                                                   130))})
    blob = open(path, "rb").read()
    assert slides.read_channel(path, "czi", 0).shape == (100, 260)
    # the directory segment comes last; only its alignment padding follows
    dir_pos, = struct.unpack_from("<q", blob, 32 + 52)
    end = dir_pos + 32 + struct.unpack_from("<q", blob, dir_pos + 24)[0]
    cut = str(tmp_path / "cut.czi")
    for n in list(range(0, end, 5)) + [end - 1]:
        with open(cut, "wb") as f:
            f.write(blob[:n])
        with pytest.raises(ValueError):
            jax_czi.read_czi_channel(cut, 0)
        with pytest.raises(ValueError):
            slides.read_channel(cut, "czi", 0)


def test_cli_streams_a_jpeg_czi_as_jax_does(tmp_path):
    """``--engine streaming`` on a mosaic of a baseline and a progressive
    JPEG tile: within 1 level of the JAX CLI's stream (PIL's decode), and
    byte-equal to the port's whole engine on the decoded pixels as a
    TIFF."""
    from tests.test_torch_czi_nd2 import MODELS, _blobs, _cli_pair
    from unmicst_tpu_torch import cli
    from unmicst_tpu_torch.io.tiff import imread, imwrite

    plane = (_blobs((144, 160), 9) >> 8).astype(np.uint8)
    tiles, pixels = {}, np.zeros_like(plane)
    for c0, kwargs in ((0, dict(quality=90)),
                       (80, dict(quality=90, progressive=True))):
        data = _pil_jpeg(np.ascontiguousarray(plane[:, c0:c0 + 80]),
                         **kwargs)
        tiles[(0, c0)] = (data, (144, 80))
        pixels[:, c0:c0 + 80] = jpeg.decode(data)
    src = str(tmp_path / "s.czi")
    _jpeg_czi(src, tiles)
    got = _cli_pair(tmp_path, src, ["--engine", "streaming"])
    tif = str(tmp_path / "s.tif")
    imwrite(tif, pixels)
    assert cli.main([tif, "--tool", "unmicst-legacy", "--model", "blobDemo",
                     "--modelRoot", MODELS, "--stackOutput", "--outputPath",
                     str(tmp_path / "w"), "--engine", "streaming"],
                    device="cpu") == 0
    for k in range(3):
        np.testing.assert_array_equal(
            got[k], imread(str(tmp_path / "w" / "s_Probabilities_1.tif"), k))


def test_chip_smoke_jpeg_mosaic_reads_in_both(tmp_path):
    """``chip_smoke.jpeg_mosaic`` (phase 16's CZI writer) writes a Gray8
    JPEG mosaic that the JAX reader (PIL) reads as the port does."""
    import chip_smoke

    path = str(tmp_path / "m.czi")
    plane, nbytes = chip_smoke.jpeg_mosaic(path, 1024)
    assert plane.shape == (1024, 1024) and nbytes > 4 * 100_000
    np.testing.assert_array_equal(slides.read_channel(path, "czi", 0), plane)
    assert _levels(plane, jax_czi.read_czi_channel(path, 0))[0] <= 1
