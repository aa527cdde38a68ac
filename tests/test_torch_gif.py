"""The port's GIF reader and writer (``unmicst_tpu_torch/io/gif.py``)
against the JAX package, which reaches GIF through PIL: the toolbox's
``imread`` / ``imwrite`` (``unmicst_tpu/utils/imtools.py:49-67``) and the
TIFF fallback that opens a refused file by content, page == frame
(``unmicst_tpu/io/tiff.py:1274-1291``, ``io/slides.py:66-97``).  Every
frame of every fixture and of seeded random files, corrupt ones among
them; the LZW coders' native and plain versions against each other;
``imwrite`` of each dtype byte for byte; both CLIs on a GIF under a TIFF
name."""

import io
import os

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from unmicst_tpu import cli as jax_cli
from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch import cli
from unmicst_tpu_torch.io import _native, gif, slides, tiff
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_gif")
READS = sorted(f[:-4] for f in os.listdir(FIXTURES)
               if f.endswith(".gif") and not f.startswith("write_"))
WRITES = sorted(f[6:-4] for f in os.listdir(FIXTURES)
                if f.startswith("write_") and f.endswith(".npy"))
SIZES = [(1, 1), (13, 17), (257, 300)]


@pytest.fixture(params=["native", "python"])
def codecs(request, monkeypatch):
    """Each test once with the native library and once without it."""
    assert _native.get_lib() is not None, "the native library did not load"
    if request.param == "python":
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    return request.param


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _pil_frame(data: bytes, k: int):
    """``(array, None)`` or ``(None, exception type)`` of PIL's frame k."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            im.seek(k)
            return np.asarray(im), None
    except Exception as e:  # noqa: BLE001
        return None, type(e)


def _port_frame(data: bytes, k: int):
    try:
        return gif.read_frame(data, k), None
    except Exception as e:  # noqa: BLE001
        return None, type(e)


def random_gif(rng, h=None, w=None) -> bytes:
    """A seeded GIF of 1-4 frames: random screen, tables (or none, or the
    identity ramp), offsets, local tables, transparency, disposals 0-7,
    interlace and code sizes."""
    h = h or int(rng.randint(1, 40))
    w = w or int(rng.randint(1, 40))
    ncol = int(rng.choice([2, 4, 16, 256]))
    palette = None
    if rng.rand() < 0.8:
        palette = (bytes(i // 3 for i in range(3 * ncol)) if rng.rand() < 0.15
                   else rng.randint(0, 256, 3 * ncol).astype(
                       np.uint8).tobytes())
    frames = []
    for _ in range(int(rng.randint(1, 5))):
        fh, fw = int(rng.randint(1, h + 1)), int(rng.randint(1, w + 1))
        fr = dict(x=int(rng.randint(0, w - fw + 1)),
                  y=int(rng.randint(0, h - fh + 1)),
                  interlace=bool(rng.rand() < 0.4))
        lcol = ncol
        if rng.rand() < 0.3:
            lcol = int(rng.choice([2, 4, 16, 256]))
            fr["palette"] = rng.randint(0, 256, 3 * lcol).astype(
                np.uint8).tobytes()
        fr["bits"] = max(2, (lcol - 1).bit_length())
        fr["pixels"] = rng.randint(0, lcol, (fh, fw))
        if rng.rand() < 0.4:
            fr["transparency"] = int(rng.randint(0, lcol))
        if rng.rand() < 0.5:
            fr["disposal"] = int(rng.randint(0, 8))
        frames.append(fr)
    return chip_smoke.gif_file(w, h, frames, palette,
                               background=int(rng.randint(0, ncol)))


# -- reading ------------------------------------------------------------------


def test_fixtures_are_the_listed_kinds():
    assert READS == sorted([
        "disposal2_background", "extensions", "gif87a", "gray",
        "identity_palette", "interlaced", "local_palettes", "pil_save_all",
        "transparency_disposal1", "transparency_disposal2",
        "transparency_disposal3"])
    assert WRITES == sorted(["bool", "float32", "float64", "int16", "int32",
                             "uint16", "uint8", "uint8_few"])
    total = sum(os.path.getsize(os.path.join(FIXTURES, f))
                for f in os.listdir(FIXTURES))
    assert total < 300 << 10


@pytest.mark.parametrize("name", READS)
def test_fixture_frames_read_as_jax_reads_them(name, codecs, tmp_path):
    """Every frame of each fixture: the port's ``imread`` (frame 0), its
    ``read_channel`` and ``tiff.imread`` of the file under a TIFF name
    (frame k) equal JAX's (PIL's) and the committed read, dtype and shape
    included; past the last frame ``IndexError`` from ``read_channel``
    and ``EOFError`` from ``tiff.imread``, in both packages."""
    src = os.path.join(FIXTURES, f"{name}.gif")
    ref = np.load(os.path.join(FIXTURES, f"{name}.npz"))
    _equal(T.imread(src), J.imread(src))
    _equal(T.imread(src), ref["frame0"])
    as_tif = str(tmp_path / f"{name}.tif")
    with open(src, "rb") as f, open(as_tif, "wb") as g:
        g.write(f.read())
    n = len(ref.files)
    for k in range(n):
        want = jax_slides.read_channel(as_tif, "tif", k)
        _equal(want, ref[f"frame{k}"])
        _equal(slides.read_channel(as_tif, "tif", k), want)
        _equal(tiff.imread(as_tif, k), jax_tiff.imread(as_tif, k))
    for read in (jax_slides.read_channel, slides.read_channel):
        with pytest.raises(IndexError):
            read(as_tif, "tif", n)
    for read in (jax_tiff.imread, tiff.imread):
        with pytest.raises(EOFError):
            read(as_tif, n)


@pytest.mark.parametrize("seed", range(8))
def test_random_gifs_read_as_pil_reads_them(seed, codecs):
    """Seeded multi-frame files: every frame equals PIL's, and past the
    last both raise ``EOFError``."""
    rng = np.random.RandomState(seed)
    for _ in range(15 if codecs == "native" else 5):
        data = random_gif(rng)
        with Image.open(io.BytesIO(data)) as im:
            n = im.n_frames
        for k in range(n + 1):
            (want, err), (got, err2) = _pil_frame(data, k), _port_frame(
                data, k)
            if err is not None:
                assert err2 is not None and issubclass(err, type(err2)) or (
                    err2 is not None and issubclass(err2, err)), (err, err2)
                continue
            assert err2 is None, err2
            _equal(got, want)


def _grown_gif(screen: str, disposal: int, trans0, trans1) -> bytes:
    """A 5 x 4 logical screen (a global table, the identity ramp, or
    none) whose frame 0 (4 x 3, transparency ``trans0``, disposal
    ``disposal``) fills most of it, frame 1 (3 x 3 at (3, 2), transparency
    ``trans1``, disposal ``disposal``) reaching past it, and frame 2 (2 x 2
    at (4, 3)) inside the grown image."""
    rng = np.random.RandomState(disposal + 7 * (trans0 or 0))
    pal = {"palette": rng.randint(0, 256, 48).astype(np.uint8).tobytes(),
           "ramp": bytes(i // 3 for i in range(48)), "none": None}[screen]
    return chip_smoke.gif_file(5, 4, [
        dict(pixels=rng.randint(0, 16, (3, 4)), transparency=trans0,
             disposal=disposal, bits=4),
        dict(pixels=rng.randint(0, 16, (3, 3)), x=3, y=2,
             transparency=trans1, disposal=disposal, bits=4),
        dict(pixels=rng.randint(0, 16, (2, 2)), x=4, y=3, bits=4)], pal,
        background=3)


@pytest.mark.parametrize("disposal", range(4))
@pytest.mark.parametrize("screen,trans0,trans1", [
    ("palette", None, None), ("palette", 5, 6), ("palette", 5, None),
    ("palette", None, 6), ("ramp", None, None), ("none", None, None),
    ("none", 5, 6)])
def test_frames_past_the_logical_screen_read_as_pil_reads_them(
        screen, trans0, trans1, disposal, codecs, tmp_path):
    """A frame past the logical screen grows the image as PIL's does, at
    frame 0 and at frame 1, under each disposal of the frame before (the
    previous contents as they were before the image grew, zeros past
    them), with and without transparency, on a palette, a gray-ramp and a
    table-less screen: frames 0-2 equal PIL's through ``read_frame``,
    ``imread`` (frame 0) and ``read_channel`` / ``tiff.imread`` under a
    TIFF name.  An RGB screen grown by a transparent frame, where PIL's
    array reads past the end of its bytes, raises ``NotImplementedError``
    naming M17."""
    data = _grown_gif(screen, disposal, trans0, trans1)
    grown0 = chip_smoke.gif_file(2, 2, [dict(pixels=np.arange(12).reshape(
        3, 4) % 4, x=1, transparency=trans0, bits=2)])
    _equal(gif.read_frame(grown0, 0), _pil_frame(grown0, 0)[0])
    as_tif = str(tmp_path / "g.tif")
    with open(as_tif, "wb") as f:
        f.write(data)
    path = str(tmp_path / "g.gif")
    with open(path, "wb") as f:
        f.write(data)
    _equal(T.imread(path), J.imread(path))
    for k in range(3):
        (want, err), (got, err2) = _pil_frame(data, k), _port_frame(data, k)
        if screen == "palette" and trans1 is not None and trans0 is None \
                and k >= 1:
            assert err2 is NotImplementedError
            with pytest.raises(NotImplementedError, match="M17"):
                gif.read_frame(data, k)
            continue
        assert (err is None) == (err2 is None), (k, err, err2)
        if err is not None:
            assert issubclass(err2, err) or issubclass(err, err2)
            continue
        assert want.shape[:2] == (5, 6) or k == 0
        _equal(got, want)
        _equal(slides.read_channel(as_tif, "tif", k),
               jax_slides.read_channel(as_tif, "tif", k))
        _equal(tiff.imread(as_tif, k), jax_tiff.imread(as_tif, k))


@pytest.mark.parametrize("size", SIZES)
def test_sizes_read_as_pil_reads_them(size, codecs):
    """One-frame and two-frame files at 1x1, 13x17 and 257x300, with a
    global table, interlaced."""
    h, w = size
    rng = np.random.RandomState(h + w)
    if codecs == "python" and h * w > 10000:
        h, w = 64, 75  # the plain decoder runs a Python loop a pixel
    pal = rng.randint(0, 256, 768).astype(np.uint8).tobytes()
    data = chip_smoke.gif_file(w, h, [
        dict(pixels=rng.randint(0, 256, (h, w)), interlace=True),
        dict(pixels=rng.randint(0, 256, (h, w)), transparency=7)], pal)
    for k in (0, 1):
        _equal(gif.read_frame(data, k), _pil_frame(data, k)[0])


def test_corrupt_gifs_fail_where_pil_fails():
    """Truncated and byte-flipped files: PIL and the port fail together
    (``OSError`` or ``EOFError``, or a ``ValueError`` where PIL's own
    ``np.asarray`` fails) or give the same pixels; the native and plain
    decoders give the same outcome.  Frames past the logical screen grow
    the image as PIL's do (its decompression-bomb check included), but
    for an RGB screen grown into RGBA, where PIL's array reads past the
    end of its bytes: that raises ``NotImplementedError`` naming M17 and
    is counted apart."""
    rng = np.random.RandomState(11)
    grown = agree = 0
    for _ in range(150):
        data = bytearray(random_gif(rng))
        if rng.rand() < 0.4:
            data = data[: int(rng.randint(13, len(data)))]
        else:
            for _ in range(int(rng.randint(1, 4))):
                data[int(rng.randint(13, len(data)))] = int(rng.randint(256))
        data = bytes(data)
        for k in range(3):
            want, err = _pil_frame(data, k)
            got, err2 = _port_frame(data, k)
            saved = _native.get_lib
            _native.get_lib = lambda: None
            try:
                plain, err3 = _port_frame(data, k)
            finally:
                _native.get_lib = saved
            assert err2 == err3
            if got is not None:
                _equal(plain, got)
            if err2 is NotImplementedError:
                grown += 1
                continue
            assert (err is None) == (err2 is None), (err, err2)
            if err is None:
                _equal(got, want)
            elif issubclass(err, EOFError):
                assert err2 is EOFError
            elif err.__name__ == "DecompressionBombError":
                assert err2.__name__ == "DecompressionBombError"
            else:
                assert issubclass(err2, (OSError, ValueError)), err2
            agree += 1
    assert agree > 300 and grown < agree // 10


def test_lzw_decoders_agree_on_corrupt_streams():
    """Random code streams of every minimum code size 0-13, valid and
    corrupt, with bytes after their terminator: both decoders give the
    same pixels or the same error code."""
    rng = np.random.RandomState(3)
    codes_seen = set()
    for _ in range(300):
        bits = int(rng.randint(0, 14))
        px = rng.randint(0, 1 << min(max(bits, 1), 8),
                         int(rng.randint(1, 400)))
        codes = bytearray(gif.lzw_encode_py(px.astype(np.uint8).tobytes(),
                                            min(max(bits, 1), 12)))
        for _ in range(int(rng.randint(0, 3))):
            codes[int(rng.randint(len(codes)))] = int(rng.randint(256))
        data = b"\0" + gif.sub_blocks(bytes(codes), 64) + b"\0" + bytes(
            rng.randint(0, 256, int(rng.randint(0, 20))).astype(np.uint8))
        h, w = int(rng.randint(1, 20)), int(rng.randint(1, 30))
        interlace, trans = bool(rng.rand() < 0.5), int(rng.randint(-1, 4))
        out_n = np.full((h, w), 9, np.uint8)
        out_p = out_n.copy()
        rc_n = _native.gif_lzw_decode(data, 1, bits, out_n, interlace, trans,
                                      gif.READ_CHUNK)
        rc_p = gif.lzw_decode_py(data, 1, bits, out_p, interlace, trans)
        assert rc_n == rc_p
        if rc_n == 0:
            _equal(out_n, out_p)
        codes_seen.add(rc_n)
    assert codes_seen == {0, gif._BROKEN, gif._CONFIG, gif._TRUNCATED}


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("trans", [-1, 1])
def test_lzw_native_equals_plain(bits, interlace, trans):
    """Valid and corrupt streams of each code size: the native decoder
    and :func:`gif.lzw_decode_py` give the same pixels or error code;
    the native encoder's bytes are :func:`gif.lzw_encode_py`'s."""
    rng = np.random.RandomState(bits * 4 + interlace * 2 + (trans > 0))
    for _ in range(25):
        n = int(rng.randint(1, 6000))
        px = rng.randint(0, 1 << bits, n).astype(np.uint8)
        if rng.rand() < 0.5:  # runs, so that long strings build up
            px = np.repeat(px[: n // 50 + 1], 50)[:n]
        raw = px.tobytes()
        codes = gif.lzw_encode_py(raw, bits)
        assert _native.gif_lzw_encode(raw, bits) == codes
        blob = bytearray(codes)
        if rng.rand() < 0.5:
            blob[int(rng.randint(len(blob)))] ^= 1 << int(rng.randint(8))
        data = b"\0" + gif.sub_blocks(bytes(blob), 64) + b"\0;"
        w = int(rng.randint(1, 80))
        h = max(1, len(raw) // w)
        outs = []
        for native in (True, False):
            out = np.full((h, w), 255, np.uint8)
            rc = (_native.gif_lzw_decode(data, 1, bits, out, interlace, trans,
                                         gif.READ_CHUNK)
                  if native else gif.lzw_decode_py(data, 1, bits, out,
                                                interlace, trans))
            outs.append((rc, out))
        assert outs[0][0] == outs[1][0]
        if outs[0][0] == 0:
            _equal(outs[0][1], outs[1][1])


def _codes9(codes) -> bytes:
    """9-bit codes packed LSB first (a stream that never widens)."""
    acc = sum(c << (9 * i) for i, c in enumerate(codes))
    return acc.to_bytes(-(-9 * len(codes) // 8), "little")


@pytest.mark.parametrize("tail", [0, 300])
def test_an_end_code_before_the_last_pixel(tail, codecs):
    """PIL reads a frame 64 KiB at a time: an end code before the last
    pixel ends the data (the file is truncated) where nothing is left to
    read, and is passed over where the file holds more bytes (here
    ``tail`` sub-blocks of a comment after the frame): the codes after it
    fill the frame."""
    w = 40
    px = np.random.RandomState(4).randint(0, 256, 4 * w).tolist()
    codes = [256] + px[: 2 * w] + [257, 256] + px[2 * w :] + [257]
    pal = bytes(range(256)) * 3
    data = chip_smoke.gif_file(w, 4, [dict(pixels=np.zeros((4, w)))], pal)
    frame = 13 + len(pal)  # after the screen and the global table
    comment = b"!\xfe" + (b"\xff" + bytes(255)) * tail + b"\0"
    data = (data[: frame + 11] + gif.sub_blocks(_codes9(codes), w) + b"\0"
            + comment + b";")
    want, err = _pil_frame(data, 0)
    got, err2 = _port_frame(data, 0)
    if tail:
        assert err is None and err2 is None
        _equal(want, np.array(px, np.uint8).reshape(4, w))
        _equal(got, want)
    else:
        assert issubclass(err, OSError) and err2 is gif.GifError


# -- writing ------------------------------------------------------------------


def _write_case(kind, size, rng):
    h, w = size
    return {"bool": lambda: rng.randint(0, 2, size).astype(bool),
            "uint8": lambda: rng.randint(0, 256, size).astype(np.uint8),
            "uint8_few": lambda: (rng.randint(0, 3, size) * 100).astype(
                np.uint8),
            "uint16": lambda: rng.randint(0, 600, size).astype(np.uint16),
            "int16": lambda: rng.randint(-300, 400, size).astype(np.int16),
            "int32": lambda: rng.randint(-300, 400, size).astype(np.int32),
            "float32": lambda: (rng.rand(h, w) * 300 - 20).astype(
                np.float32),
            "float64": lambda: rng.rand(h, w) * 300 - 20,
            "la": lambda: rng.randint(0, 256, size + (2,)).astype(
                np.uint8)}[kind]()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", ["bool", "uint8", "uint8_few", "uint16",
                                  "int16", "int32", "float32", "float64",
                                  "la"])
def test_imwrite_gif_is_byte_equal_to_jax(kind, size, tmp_path):
    """``imwrite(x, "x.gif")``: the port's file is the JAX package's
    (PIL's) byte for byte, and both ``imread`` it back alike."""
    x = _write_case(kind, size, np.random.RandomState(sum(size) + len(kind)))
    a, b = str(tmp_path / "jax.gif"), str(tmp_path / "port.gif")
    J.imwrite(x, a)
    T.imwrite(x, b)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    _equal(T.imread(b), J.imread(a))


def test_plain_encoder_writes_the_same_file(monkeypatch):
    """Without the native library the writer's bytes are the same."""
    x = np.random.RandomState(1).randint(0, 256, (257, 300)).astype(np.uint8)
    native = gif.encode_gif(x)
    monkeypatch.setattr(_native, "get_lib", lambda: None)
    assert gif.encode_gif(x) == native


def test_wide_frames_split_sub_blocks_where_pil_s_buffer_ends(tmp_path):
    """Past 16384 columns ``ImageFile._save``'s buffer is 4 bytes a
    column, and the encoder closes a sub-block where each buffer ends."""
    x = np.random.RandomState(2).randint(0, 256, (3, 20000)).astype(np.uint8)
    b = io.BytesIO()
    Image.fromarray(x).save(b, "GIF")
    assert gif.encode_gif(x) == b.getvalue()


@pytest.mark.parametrize("name", WRITES)
def test_committed_writes_are_byte_equal(name):
    x = np.load(os.path.join(FIXTURES, f"write_{name}.npy"))
    with open(os.path.join(FIXTURES, f"write_{name}.gif"), "rb") as f:
        assert gif.encode_gif(x) == f.read()


@pytest.mark.parametrize("shape,dtype,port_error", [
    ((5, 6, 3), np.uint8, None),
    ((5, 6, 4), np.uint8, None),
    ((5, 6, 3), np.uint16, TypeError),
    ((5, 6, 3), np.float32, TypeError),
    ((5, 6), np.int64, TypeError),
    ((5, 6), np.complex64, TypeError),
    ((0, 6), np.uint8, SystemError)])
def test_imwrite_gif_refusals(shape, dtype, port_error, tmp_path):
    """A dtype PIL has no mode for raises ``TypeError`` in both, an empty
    image ``SystemError``; RGB and RGBA (Pillow's median cut and fast
    octree, ``tests/test_torch_gif_rgb.py``) write PIL's bytes."""
    x = np.zeros(shape, dtype)
    if port_error is None:
        T.imwrite(x, str(tmp_path / "p.gif"))
        J.imwrite(x, str(tmp_path / "j.gif"))
        assert (tmp_path / "p.gif").read_bytes() == (
            tmp_path / "j.gif").read_bytes()
        return
    with pytest.raises(port_error):
        T.imwrite(x, str(tmp_path / "p.gif"))
    with pytest.raises(port_error):
        J.imwrite(x, str(tmp_path / "j.gif"))


# -- the CLI ------------------------------------------------------------------


def _outputs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def gif_slide(tmp_path_factory):
    """A two-frame 48 x 64 GIF under a TIFF name: frame 0 palette indices,
    frame 1 (RGB, as Pillow loads frames after the first)."""
    rng = np.random.RandomState(48)
    pal = rng.randint(0, 256, 768).astype(np.uint8).tobytes()
    data = chip_smoke.gif_file(64, 48, [
        dict(pixels=rng.randint(0, 256, (48, 64))),
        dict(pixels=rng.randint(0, 256, (20, 30)), x=5, y=9)], pal)
    root = tmp_path_factory.mktemp("gifslide")
    path = root / "s" / "m.tif"
    path.parent.mkdir()
    path.write_bytes(data)
    return str(path)


def test_cli_on_a_gif_under_a_tiff_name(gif_slide, tmp_path):
    """Channel 1 (frame 0) through both CLIs: the same files, pages
    within 1 uint8 level."""
    common = [gif_slide, "--tool", "unmicst-legacy", "--model", "blobDemo",
              "--modelRoot", MODELS, "--stackOutput", "--channel", "1"]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main(common + ["--outputPath", out_j]) == 0
    assert cli.main(common + ["--outputPath", out_t], device="cpu") == 0
    files = _outputs(out_j)
    assert files and files == _outputs(out_t)
    for rel in files:
        if not rel.endswith(".tif"):
            continue
        a, b = os.path.join(out_j, rel), os.path.join(out_t, rel)
        n = jax_tiff.num_pages(a)
        assert n == tiff.num_pages(b) and n >= 1
        for k in range(n):
            pa, pb = jax_tiff.imread(a, k), tiff.imread(b, k)
            assert pa.dtype == pb.dtype and pa.shape == pb.shape
            assert np.abs(pa.astype(int) - pb.astype(int)).max() <= 1


@pytest.mark.parametrize("channel,error", [("2", ValueError),
                                           ("3", IndexError)])
def test_cli_on_a_gif_s_rgb_frame_and_past_its_end(gif_slide, channel,
                                                   error, tmp_path):
    """Channel 2 is frame 1, an RGB plane: the JAX CLI fails unpacking
    its shape and the port's raises the same class naming it; channel 3
    is past the last frame: ``IndexError`` from both."""
    common = [gif_slide, "--tool", "unmicst-legacy", "--model", "blobDemo",
              "--modelRoot", MODELS, "--channel", channel]
    assert slides.read_channel(gif_slide, "tif", 1).shape == (48, 64, 3)
    with pytest.raises(error):
        jax_cli.main(common + ["--outputPath", str(tmp_path / "j")])
    with pytest.raises(error, match=r"\(48, 64, 3\)" if error is ValueError
                       else None):
        cli.main(common + ["--outputPath", str(tmp_path / "t")],
                 device="cpu")
