"""Arithmetic-coded JPEG frames (SOF9 sequential, SOF10 progressive, DAC)
in ``unmicst_tpu_torch/io/jpeg.py`` against the JAX package, which reads
them through PIL (libjpeg-turbo's ``jdarith.c``): the toolbox's
``imread`` (``unmicst_tpu/utils/imtools.py:49-57``), a JPEG under a TIFF
name and JPEG-compressed TIFF pages (``io/slides.py:66-97``,
``io/tiff.py:1274-1291``), and CZI JPEG sub-blocks (``io/czi.py:177-207``).
The streams come from the test-side encoder of
``tests/fixtures/torch_jpeg_arith/make.py`` (``jcarith.c``); the native
and plain scan decoders are held to each other bit for bit.  Also: PIL's
64 KiB reads (a scan that needs more raises there), the frames PIL
refuses (SOF11, SOF13-15), libjpeg-turbo's SIMD inverse DCT on
coefficients far outside an image's range, and the progressive block
smoothing the port refuses."""

import importlib.util
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from unmicst_tpu.io import czi as jax_czi
from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch.io import _native, czi, jpeg, slides, tiff
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_jpeg_arith")
_spec = importlib.util.spec_from_file_location(
    "arith_make", os.path.join(FIXTURES, "make.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)
STREAMS = sorted(f[:-4] for f in os.listdir(FIXTURES) if f.endswith(".jpg"))


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


def _pil(data: bytes):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im)


def _reads_match(data: bytes, tmp_path):
    """JAX's and the port's ``imread`` of ``data`` as a ``.jpg``, their
    ``read_channel`` and ``tiff.imread`` of it under a TIFF name: the same
    arrays, and ``IndexError`` at channel 1.  Returns the port's read."""
    jpg, tif = str(tmp_path / "x.jpg"), str(tmp_path / "x.tif")
    for path in (jpg, tif):
        with open(path, "wb") as f:
            f.write(data)
    got = T.imread(jpg)
    _equal(got, J.imread(jpg))
    _equal(slides.read_channel(tif, "tif", 0),
           jax_slides.read_channel(tif, "tif", 0))
    _equal(tiff.imread(tif), jax_tiff.imread(tif))
    for read in (jax_slides.read_channel, slides.read_channel):
        with pytest.raises(IndexError):
            read(tif, "tif", 1)
    return got


def _both_decoders(data: bytes, monkeypatch, **kw):
    """``decode_coefficients`` with and without the native library."""
    out = []
    for native in (True, False):
        with monkeypatch.context() as m:
            if not native:
                m.setattr(_native, "get_lib", lambda: None)
            try:
                out.append(jpeg.decode_coefficients(data, **kw)[1])
            except ValueError as e:
                out.append(ValueError)
    return out


# -- the committed fixtures ---------------------------------------------------


def test_fixtures_are_the_listed_cases():
    assert STREAMS == sorted(mk.CASES)


@pytest.mark.parametrize("name", STREAMS)
def test_fixtures_read_as_pil_read_them(name, codecs, tmp_path):
    """Every fixture, random entropy-coded data and streams cut short
    before EOI among them: the committed PIL read, the JAX package's
    reads live, 0 levels apart; the encoder still writes the file."""
    with open(os.path.join(FIXTURES, name + ".jpg"), "rb") as f:
        data = f.read()
    assert mk.case(name, **mk.CASES[name]) == data
    want = np.load(os.path.join(FIXTURES, name + ".npy"))
    _equal(jpeg.decode(data, feed=jpeg.PIL_FEED), want)
    _equal(_reads_match(data, tmp_path), want)


# -- seeded streams at odd sizes ----------------------------------------------


@pytest.mark.parametrize("size", [(1, 1), (13, 17), (257, 300)])
@pytest.mark.parametrize("sampling", ["gray", "h1v1", "h2v1", "h2v2"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sof9", "sof10"])
def test_streams_read_as_jax_reads_them(progressive, sampling, size,
                                        tmp_path):
    h, w = size
    data = mk.case(f"{sampling}{h}x{w}", h, w, sampling, progressive)
    assert (b"\xff\xca" if progressive else b"\xff\xc9") in data
    got = _reads_match(data, tmp_path)
    assert got.shape == ((h, w) if sampling == "gray" else (h, w, 3))


@pytest.mark.parametrize("restart", [1, 2, 7])
@pytest.mark.parametrize("dac", [None, {"dc": {0: (0, 0), 1: (5, 9)},
                                        "ac": {0: 1, 1: 63}},
                                 {"dc": {0: (3, 15)}, "ac": {0: 30}}],
                         ids=["defaults", "dac_a", "dac_b"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sof9", "sof10"])
def test_restarts_and_conditioning(progressive, dac, restart, codecs):
    """Restart intervals (statistics, contexts and decoder reset) and DAC
    conditioning (L, U, Kx), gray and h2v2: 0 levels from PIL."""
    for sampling in ("gray", "h2v2"):
        data = mk.case(f"r{restart}{sampling}", 27, 35, sampling,
                       progressive, restart, dac)
        _equal(jpeg.decode(data, feed=jpeg.PIL_FEED), _pil(data))


@pytest.mark.parametrize("seed", range(12))
def test_random_entropy_decoders_agree_and_match_pil(seed, monkeypatch):
    """Random entropy-coded bytes (libjpeg's quiet recovery: zeros past a
    marker, ``ct = -1`` on an overflow, resynchronised restarts): native
    and plain coefficients bit-equal, pixels 0 levels from PIL."""
    rng = np.random.RandomState(seed)
    sampling = ("gray", "h1v1", "h2v1", "h2v2")[seed % 4]
    progressive, restart = bool(seed & 1), (0, 1, 3)[seed % 3]
    comps = mk.SAMPLINGS[sampling]
    n = len(comps)
    scans = (mk.progressive_scans(n) if progressive
             else mk.sequential_scans(n))
    q = {0: mk.QTABLES[0], 1: mk.QTABLES[1]}
    data = mk.random_entropy(rng, comps, 30, 41, q if n > 1 else {0: q[0]},
                             scans, restart, int(rng.randint(4, 60)),
                             progressive)
    native, plain = _both_decoders(data, monkeypatch)
    _equal(native, plain)
    _equal(jpeg.decode(data), _pil(data))


def test_decoders_fail_alike_on_cut_streams(monkeypatch):
    """Each fixture cut short (no EOI): PIL raises, and both decoders
    raise ``ValueError``; cut and closed by EOI in the last scan, the
    decode reads zeros past the cut as libjpeg does.  The scan decoders
    themselves, on the last scan's header and 3 bytes of its data: the
    same message from both, naming the data's end where the stream ends
    there and PIL's 65536-byte read where only the read does."""
    for name in ("seq_h2v2_restart1_dac", "prog_h2v1_restart3_dac",
                 "random_prog_h2v2_restart1"):
        with open(os.path.join(FIXTURES, name + ".jpg"), "rb") as f:
            data = f.read()
        for cut in (len(data) // 3, len(data) // 2, len(data) - 3):
            with pytest.raises(OSError):
                _pil(data[:cut])
            assert _both_decoders(data[:cut], monkeypatch) == [ValueError] * 2
        for keep in (0.2, 0.6, 0.95):
            closed = mk.cut_before_eoi(data, keep)
            native, plain = _both_decoders(closed, monkeypatch)
            _equal(native, plain)
            _equal(jpeg.decode(closed), _pil(closed))
        frame, scans = jpeg.parse(data)
        scan = scans[-1]
        order, slots, per_mcu = jpeg.scan_blocks(frame, scan)
        cut = data[:scan.pos + 3]
        for stream, says in ((cut, "JPEG entropy-coded data ends early"),
                             (data, "the 65536-byte read")):
            said = []
            for native in (True, False):
                coef = np.zeros((frame.offsets[-1], 64), np.int16)
                with pytest.raises(ValueError) as e:
                    if native:
                        _native.jpeg_arith_scan(
                            stream, scan, frame.progressive, coef, order,
                            slots, per_mcu, len(cut))
                    else:
                        jpeg.arith_scan_py(stream, frame, scan, coef, order,
                                           slots, per_mcu, len(cut))
                said.append(str(e.value))
            assert said[0] == said[1] and says in said[0], said


def test_a_huffman_stream_relabelled_sof9():
    """PIL's baseline stream with its SOF0 marked SOF9: libjpeg decodes
    the Huffman-coded bytes as arithmetic-coded data, and so does the
    port."""
    rng = np.random.RandomState(9)
    for img in (rng.randint(0, 256, (16, 24)).astype(np.uint8),
                rng.randint(0, 256, (21, 30, 3)).astype(np.uint8)):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=90)
        data = bytearray(buf.getvalue())
        data[data.index(b"\xff\xc0") + 1] = 0xC9
        _equal(jpeg.decode(bytes(data)), _pil(bytes(data)))


# -- PIL's 64 KiB reads -------------------------------------------------------


def _padded(data: bytes, pad: int) -> bytes:
    """``data`` with an APP15 segment of ``pad`` bytes after SOI."""
    seg = b"\xff\xef" + struct.pack(">H", pad + 2) + bytes(pad)
    return data[:2] + seg + data[2:]


@pytest.fixture(scope="module")
def big_streams():
    """A sequential, a progressive and a restart-interval stream of
    about 31 KB each."""
    rng = np.random.RandomState(3)
    comps, q = mk.SAMPLINGS["gray"], {0: mk.QTABLES[0]}
    coef = mk.random_coefficients(rng, comps, 400, 400)
    return {"seq": mk.encode(coef, comps, 400, 400, q),
            "prog": mk.encode(coef, comps, 400, 400, q,
                              mk.progressive_scans(1), progressive=True),
            "restart": mk.encode(coef, comps, 400, 400, q, restart=50)}


@pytest.mark.parametrize("kind", ["seq", "prog", "restart"])
def test_a_scan_past_pil_s_read_raises_as_in_pil(kind, big_streams,
                                                 monkeypatch, tmp_path):
    """PIL hands libjpeg 65536 bytes a call, and the arithmetic decoder
    cannot wait for more: with the stream moved across that boundary 4
    bytes at a time, the port decodes exactly where PIL does (0 levels)
    and raises where PIL raises (both decoders on either side of the
    edge); under a TIFF name both
    ``read_channel``s raise ``ValueError``, ``imread`` ``OSError``."""
    base = big_streams[kind]
    pads = [0] + list(range(65536 - len(base) - 12, 65536 - len(base) + 12,
                            4))
    wants = []
    for pad in pads:
        try:
            wants.append(_pil(_padded(base, pad) if pad else base))
        except OSError:
            wants.append(None)
    flip = [w is None for w in wants].index(True)
    assert flip > 1 and all(w is None for w in wants[flip:])
    for k, (pad, want) in enumerate(zip(pads, wants)):
        data = _padded(base, pad) if pad else base
        for native in (True, False) if k in (flip - 1, flip) else (True,):
            with monkeypatch.context() as m:
                if not native:
                    m.setattr(_native, "get_lib", lambda: None)
                if want is None:
                    with pytest.raises(ValueError, match="65536"):
                        jpeg.decode(data, feed=jpeg.PIL_FEED)
                else:
                    _equal(jpeg.decode(data, feed=jpeg.PIL_FEED), want)
    data = _padded(base, 40000)
    tif, jpg = str(tmp_path / "p.tif"), str(tmp_path / "p.jpg")
    for path in (tif, jpg):
        with open(path, "wb") as f:
            f.write(data)
    for read in (jax_slides.read_channel, slides.read_channel):
        with pytest.raises(ValueError):
            read(tif, "tif", 0)
    for read in (J.imread, T.imread):
        with pytest.raises(OSError):
            read(jpg)
    _equal(jpeg.decode(data), _pil(base))  # no read limit: the whole scan


def test_tiff_pages_have_no_read_limit(big_streams, tmp_path):
    """A JPEG-compressed TIFF page (compression 7) whose strip is a SOF9
    stream: libtiff hands libjpeg the strip whole, so PIL reads a 31 KB
    scan past the 64 KiB boundary, and so does the port."""
    for kind in ("seq", "prog"):
        stream = _padded(big_streams[kind], 40000)
        path = str(tmp_path / f"{kind}.tif")
        chip_smoke.write_segment_tiff(path, [(chip_smoke.gray_jpeg_tags(
            400, 400, rows_per_strip=400), [stream])])
        want = jax_tiff.imread(path)
        _equal(tiff.imread(path), want)
        _equal(slides.read_channel(path, "tif", 0), want)
        _equal(want, _pil(big_streams[kind]))


def test_czi_sub_blocks(big_streams, tmp_path):
    """A CZI JPEG sub-block that is a SOF9 stream: read as JAX reads it
    through PIL; past PIL's first 64 KiB read, ``ValueError`` from both."""
    small = mk.case("czi", 24, 40)
    for stream, shape in ((small, (24, 40)),
                          (_padded(big_streams["seq"], 40000), (400, 400))):
        path = str(tmp_path / f"{shape[0]}.czi")
        chip_smoke.write_czi_blocks(path, [(dict(
            X=(0, shape[1]), Y=(0, shape[0]), C=(0, 1)), stream)],
            compression=2, pixel_type=0)
        if stream is small:
            _equal(czi.read_czi_channel(path, 0),
                   jax_czi.read_czi_channel(path, 0))
        else:
            for read in (czi.read_czi_channel, jax_czi.read_czi_channel):
                with pytest.raises(ValueError):
                    read(path, 0)


# -- what PIL refuses, and the inverse DCT ------------------------------------


@pytest.mark.parametrize("marker", [0xCB, 0xCD, 0xCE, 0xCF])
def test_frames_libjpeg_refuses(marker, tmp_path):
    """SOF11 (lossless) and SOF13-15 (hierarchical), arithmetic coded:
    ``OSError`` from both ``imread``s and both ``tiff.imread``s,
    ``ValueError`` from both ``read_channel``s."""
    data = bytearray(mk.case("refused", 16, 24))
    data[data.index(b"\xff\xc9") + 1] = marker
    jpg, tif = str(tmp_path / "r.jpg"), str(tmp_path / "r.tif")
    for path in (jpg, tif):
        with open(path, "wb") as f:
            f.write(bytes(data))
    for read in (J.imread, T.imread):
        with pytest.raises(OSError):
            read(jpg)
    for read in (jax_tiff.imread, tiff.imread):
        with pytest.raises(OSError):
            read(tif)
    for read in (jax_slides.read_channel, slides.read_channel):
        with pytest.raises(ValueError):
            read(tif, "tif", 0)


@pytest.mark.parametrize("seed", range(6))
def test_the_simd_inverse_dct_on_extreme_coefficients(seed):
    """Coefficients up to +-32767 under 8- and 16-bit quantisers: PIL's
    libjpeg-turbo runs its SIMD islow IDCT, which keeps the dequantised
    terms and each pass in 16 bits and saturates; 0 levels from it."""
    rng = np.random.RandomState(seed)
    coef = np.zeros((24, 64), np.int64)
    for b in range(24):
        kind = rng.randint(4)
        if kind == 0:
            coef[b, 0] = rng.randint(-32767, 32768)
        elif kind == 1:
            coef[b, :8] = rng.randint(-32767, 32768, 8)
        elif kind == 2:
            coef[b] = rng.randint(-32767, 32768, 64) * (rng.rand(64) < 0.2)
        else:
            coef[b] = rng.randint(-3000, 3000, 64)
    q = rng.randint(1, 65536 if seed % 2 else 256, 64)
    data = mk.encode(coef.astype(np.int16), [(1, 1, 1, 0)], 24, 64, {0: q})
    _equal(jpeg.decode(data), _pil(data))


def _dc_scans_only(stream: bytes) -> bytes:
    """``stream`` cut after its first scan (a progressive frame's DC
    scan), then EOI."""
    sos = [k for k in range(len(stream) - 1) if stream[k:k + 2] == b"\xff\xda"]
    return stream[:sos[1]] + b"\xff\xd9"


def test_progressive_smoothing_is_refused(tmp_path):
    """A progressive frame whose scans leave its first ten coefficients
    short of full precision (here: the DC scans only, arithmetic and
    Huffman coded): libjpeg smooths the blocks and PIL returns pixels;
    the port raises ``NotImplementedError`` naming ROADMAP M17.  The same
    streams with every scan are not smoothed, and read as PIL reads them.
    A gray one as a ``.jpg``, under a TIFF name and as a CZI sub-block:
    the JAX package reads it; the port's ``imread``, ``tiff.imread`` and
    CZI reader pass the refusal on, and ``read_channel`` wraps it in
    ``ValueError`` as it wraps every failure of the fallback."""
    full = mk.case("smooth", 24, 32, "h2v2", True)
    rng = np.random.RandomState(4)
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)).save(
        buf, "JPEG", progressive=True)
    for stream in (full, buf.getvalue()):
        _equal(jpeg.decode(stream), _pil(stream))
        dc_only = _dc_scans_only(stream)
        assert _pil(dc_only).shape == (24, 32, 3)
        with pytest.raises(NotImplementedError, match="M17"):
            jpeg.decode(dc_only)
    gray = _dc_scans_only(mk.case("smooth_gray", 24, 32, "gray", True))
    jpg, tif, czi_path = (str(tmp_path / f"s.{e}") for e in ("jpg", "tif",
                                                              "czi"))
    for path in (jpg, tif):
        with open(path, "wb") as f:
            f.write(gray)
    chip_smoke.write_czi_blocks(czi_path, [(dict(X=(0, 32), Y=(0, 24),
                                                 C=(0, 1)), gray)],
                                compression=2, pixel_type=0)
    want = _pil(gray)
    _equal(J.imread(jpg), want)
    _equal(jax_tiff.imread(tif), want)
    _equal(jax_slides.read_channel(tif, "tif", 0), want)
    _equal(jax_czi.read_czi_channel(czi_path, 0), want)
    for read in (lambda: T.imread(jpg), lambda: tiff.imread(tif),
                 lambda: czi.read_czi_channel(czi_path, 0)):
        with pytest.raises(NotImplementedError, match="M17"):
            read()
    with pytest.raises(ValueError, match="NotImplementedError.*M17"):
        slides.read_channel(tif, "tif", 0)


@pytest.mark.parametrize("seed", range(4))
def test_the_exact_inverse_dct_is_the_simd_one_within_its_bounds(
        seed, monkeypatch):
    """Chunks of blocks whose first pass reaches nearly +-16383: DC-only
    blocks and blocks with only a first row (which take the SIMD pass 1
    shortcut) at dequantised terms up to +-4095, single AC terms up to
    +-2900, and busy blocks.  ``idct_islow`` runs ``jidctint.c``'s exact
    arithmetic on them, which gives the SIMD lanes' result bit for bit."""
    rng = np.random.RandomState(seed)
    q = rng.randint(1, 9, 64)
    coef = np.zeros((3000, 64), np.int64)
    for b in range(len(coef)):
        kind = rng.randint(4)
        if kind == 0:  # dequantised terms: truncated toward zero
            coef[b, 0] = int(rng.randint(-4095, 4096) / q[0])
        elif kind == 1:
            coef[b, :8] = (rng.randint(-4095, 4096, 8) / q[:8]).astype(int)
        elif kind == 2:
            k = rng.randint(8, 64)
            coef[b, k] = int(rng.randint(-2900, 2901) / q[k])
        else:
            coef[b] = rng.randint(-60, 61, 64) * (rng.rand(64) < 0.3)
    assert np.abs(coef * q).max() >= 4000
    coef = coef.astype(np.int16)
    calls, lanes = [], jpeg._idct_lanes
    monkeypatch.setattr(jpeg, "_idct_lanes",
                        lambda *a: calls.append(1) or lanes(*a))
    exact = jpeg.idct_islow(coef, q)
    assert not calls
    monkeypatch.setattr(jpeg, "_EXACT_TERMS", -1)  # every chunk: the lanes
    _equal(exact, jpeg.idct_islow(coef, q))
    assert calls
