"""The JPEG frames the port reads since the fourth part of ROADMAP M17
(``unmicst_tpu_torch/io/jpeg.py``): lossless (SOF3) frames, predictors
1-7 with and without a point transform and restart intervals, gray and
RGB, and the samplings libjpeg-turbo upsamples beyond h2v1 and h2v2;
each against the JAX package, which reads them through PIL: the
toolbox's ``imread`` (``unmicst_tpu/utils/imtools.py:49-57``), a JPEG
under a TIFF name and JPEG-compressed TIFF pages (``io/slides.py:66-97``,
``io/tiff.py:1274-1291``).  The native and plain lossless decoders
against each other; the frames PIL refuses; and the evidence behind
queue 1's last bullet (the TIFF kinds where PIL's read was thought
garbage are functions of the file's bytes)."""

import io
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch.io import _native, jpeg, slides, tiff
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_jpeg_write")
STREAMS = sorted(f[:-4] for f in os.listdir(FIXTURES)
                 if f.startswith(("lossless_", "sampled_"))
                 and f.endswith(".jpg"))


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
    """JAX's and the port's ``imread`` of ``data`` as a ``.jpg``, and
    their ``read_channel`` and ``tiff.imread`` of it under a TIFF name:
    the same arrays.  Returns the port's read."""
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


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("pt", [0, 3])
@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("colour", ["gray", "rgb"])
def test_lossless_frames_read_as_jax_reads_them(colour, predictor, pt,
                                                restart, codecs, tmp_path):
    """Seeded 13 x 17 planes: 0 levels from PIL (through JAX), and the
    point transform's samples exactly."""
    rng = np.random.RandomState(predictor * 8 + pt + restart)
    shape = (13, 17) if colour == "gray" else (13, 17, 3)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    data = chip_smoke.lossless_jpeg(img, predictor, pt, restart)
    got = _reads_match(data, tmp_path)
    _equal(got, (img >> pt) << pt)


@pytest.mark.parametrize("size", [(1, 1), (257, 300)])
@pytest.mark.parametrize("predictor", [1, 4, 7])
def test_lossless_sizes(size, predictor, tmp_path):
    """1x1 and 257 x 300, the larger with restarts every 16 rows."""
    rng = np.random.RandomState(sum(size) + predictor)
    img = rng.randint(0, 256, size).astype(np.uint8)
    data = chip_smoke.lossless_jpeg(img, predictor, 1,
                                    16 if size[0] > 1 else 0)
    _equal(_reads_match(data, tmp_path), (img >> 1) << 1)


@pytest.mark.parametrize("rows", [40, 16])
@pytest.mark.parametrize("predictor", [1, 5])
def test_lossless_jpeg_tiff_pages(rows, predictor, tmp_path):
    """JPEG-compressed TIFF pages (compression 7) whose strips are
    lossless streams: the port's fallback equals JAX's (libtiff's)."""
    rng = np.random.RandomState(rows + predictor)
    img = rng.randint(0, 256, (40, 33)).astype(np.uint8)
    segs = [chip_smoke.lossless_jpeg(img[r:r + rows], predictor, 1)
            for r in range(0, 40, rows)]
    tags = {256: (3, [33]), 257: (3, [40]), 258: (3, [8]), 259: (3, [7]),
            262: (3, [1]), 277: (3, [1]), 278: (3, [rows])}
    path = str(tmp_path / "l.tif")
    chip_smoke.write_segment_tiff(path, [(tags, segs)])
    got = slides.read_channel(path, "tif", 0)
    _equal(got, jax_slides.read_channel(path, "tif", 0))
    _equal(got, (img >> 1) << 1)


@pytest.mark.parametrize("name", STREAMS)
def test_committed_streams_read_as_pil_read_them(name, codecs):
    with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as f:
        data = f.read()
    _equal(jpeg.decode(data), np.load(os.path.join(FIXTURES, f"{name}.npy")))


def test_lossless_decoders_agree_on_corrupt_streams():
    """Byte corruptions of lossless scans (with restarts): the native and
    plain entropy decoders fail together or give the same differences,
    and the undifferencing's two versions the same samples."""
    rng = np.random.RandomState(9)
    img = rng.randint(0, 256, (24, 20, 3)).astype(np.uint8)
    failures = 0
    for predictor in range(1, 8):
        data = chip_smoke.lossless_jpeg(img, predictor, 0, restart_rows=6)
        frame, scans = jpeg.parse(data)
        head = scans[0].pos
        for _ in range(25):
            b = bytearray(data)
            for pos in rng.randint(head, len(b) - 2, rng.randint(1, 4)):
                b[pos] = rng.randint(256)
            b = bytes(b)
            outs = []
            for native in (True, False):
                diffs = np.zeros((3, 24, 20), np.int32)
                try:
                    frame, scans = jpeg.parse(b)
                    if native:
                        _native.jpeg_lossless_scan(b, scans[0], diffs)
                    else:
                        jpeg.lossless_scan_py(b, frame, scans[0], diffs)
                    outs.append(diffs)
                except ValueError:
                    outs.append(None)
            assert (outs[0] is None) == (outs[1] is None)
            if outs[0] is None:
                failures += 1
                continue
            _equal(outs[0], outs[1])
            for k in range(3):
                _equal(_native.jpeg_undifference(outs[0][k], predictor, 0, 6),
                       jpeg.undifference_py(outs[0][k], predictor, 0, 6))
    assert 20 < failures < 170


def test_undifferencing_wraps_modulo_2_16():
    """Differences that leave 0..65535 wrap, and the stored byte is the
    sample's low 8 bits after the shift, in both versions."""
    rng = np.random.RandomState(2)
    diff = rng.randint(-40000, 40000, (9, 11)).astype(np.int32)
    for predictor in range(1, 8):
        for pt in (0, 5):
            _equal(_native.jpeg_undifference(diff, predictor, pt, 4),
                   jpeg.undifference_py(diff, predictor, pt, 4))


def _patch_sos(data, ss=None, se=None, ahal=None):
    b = bytearray(data)
    at = b.index(b"\xff\xda")
    base = at + 5 + 2 * b[at + 4]
    for k, v in enumerate((ss, se, ahal)):
        if v is not None:
            b[base + k] = v
    return bytes(b)


def _patch_sof(data, precision=None, sampling=None, marker=None):
    b = bytearray(data)
    at = b.index(b"\xff\xc3")
    if precision is not None:
        b[at + 4] = precision
    if sampling is not None:
        b[at + 11] = sampling
    if marker is not None:
        b[at + 1] = marker
    return bytes(b)


def _refusals():
    rng = np.random.RandomState(1)
    gray = rng.randint(0, 256, (13, 17)).astype(np.uint8)
    rgb = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    base = chip_smoke.lossless_jpeg(gray, 1)
    dri = bytearray(chip_smoke.lossless_jpeg(gray, 1, 0, restart_rows=3))
    at = dri.index(b"\xff\xdd")
    dri[at + 4 : at + 6] = struct.pack(">H", 5)
    return {
        "predictor 0": _patch_sos(base, ss=0),
        "predictor 8": _patch_sos(base, ss=8),
        "Se 5": _patch_sos(base, se=5),
        "Ah 1": _patch_sos(base, ahal=0x10),
        "Al 8": _patch_sos(base, ahal=8),
        "restart interval of 5": bytes(dri),
        "JFIF colour": chip_smoke.lossless_jpeg(rgb, 1, jfif=True),
        "12-bit": _patch_sof(base, precision=12),
        "16-bit": _patch_sof(base, precision=16),
        "SOF5 (hierarchical)": _patch_sof(base, marker=0xC5),
        "SOF6 (hierarchical)": _patch_sof(base, marker=0xC6),
        "SOF7 (hierarchical)": _patch_sof(base, marker=0xC7),
        "SOF11 (arithmetic coding)": _patch_sof(base, marker=0xCB),
    }


@pytest.mark.parametrize("what", sorted(_refusals()))
def test_frames_pil_refuses_raise_in_the_port(what, tmp_path):
    """Each kind PIL refuses, through both packages' ``read_channel`` of
    it under a TIFF name (``ValueError`` from both) and ``imread`` (an
    ``OSError`` from PIL, a ``ValueError`` from the port's decoder)."""
    data = _refusals()[what]
    with pytest.raises(OSError):
        _pil(data)
    tif = str(tmp_path / "x.tif")
    with open(tif, "wb") as f:
        f.write(data)
    for read in (jax_slides.read_channel, slides.read_channel):
        with pytest.raises(ValueError):
            read(tif, "tif", 0)
    with pytest.raises(ValueError):
        jpeg.decode(data)


def test_subsampled_lossless_colour_stays_queued(tmp_path):
    """A lossless colour frame whose luma is sampled 2x2 (4:2:0, here
    over a stream coded 1x1): PIL returns pixels, the port raises
    ``NotImplementedError`` naming M17 (not the ``ValueError`` of a
    corrupt stream), through the decoder, the toolbox's ``imread`` and,
    under a TIFF name, ``tiff.imread``; ``read_channel`` reports it as
    its one failure class, naming M17, where JAX returns the pixels."""
    rgb = np.random.RandomState(1).randint(0, 256, (9, 11, 3)).astype(
        np.uint8)
    data = _patch_sof(chip_smoke.lossless_jpeg(rgb), sampling=0x22)
    assert _pil(data).shape == (9, 11, 3)
    with pytest.raises(NotImplementedError, match="M17"):
        jpeg.decode(data)
    raw, tif = tmp_path / "s.jpg", tmp_path / "s.tif"
    raw.write_bytes(data)
    tif.write_bytes(data)
    for read in (lambda: T.imread(str(raw)), lambda: T.imread(str(tif)),
                 lambda: tiff.imread(str(tif))):
        with pytest.raises(NotImplementedError, match="M17"):
            read()
    assert jax_slides.read_channel(str(tif), "tif", 0).shape == (9, 11, 3)
    with pytest.raises(ValueError, match="M17"):
        slides.read_channel(str(tif), "tif", 0)


def test_a_lossless_old_style_jpeg_page_stays_queued(tmp_path):
    """An old-style JPEG TIFF page whose stream is lossless raises
    ``NotImplementedError`` naming M17, as before."""
    img = np.random.RandomState(3).randint(0, 256, (16, 24)).astype(np.uint8)
    stream = chip_smoke.lossless_jpeg(img, 1)
    tags = {256: (3, [24]), 257: (3, [16]), 258: (3, [8]), 259: (3, [6]),
            262: (3, [1]), 277: (3, [1]), 278: (3, [16]),
            513: (4, [0]), 514: (4, [len(stream)])}
    path = str(tmp_path / "o.tif")
    chip_smoke.write_segment_tiff(path, [(tags, [stream])])
    with open(path, "r+b") as f:  # point tag 513 at the strip itself
        raw = bytearray(f.read())
        strip = raw.index(stream)
        k = raw.index(struct.pack("<HHI", 513, 4, 1))
        raw[k + 8 : k + 12] = struct.pack("<I", strip)
        f.seek(0)
        f.write(raw)
    with pytest.raises(NotImplementedError, match="M17"):
        tiff.imread(path)


# -- samplings ----------------------------------------------------------------


@pytest.mark.parametrize("hv", [
    [(1, 2), (1, 1), (1, 1)], [(4, 1), (1, 1), (1, 1)],
    [(1, 4), (1, 1), (1, 1)], [(4, 2), (1, 1), (1, 1)],
    [(3, 1), (1, 1), (1, 1)], [(2, 3), (1, 1), (1, 1)],
    [(2, 2), (1, 2), (2, 1)], [(1, 1), (2, 2), (1, 1)],
    [(2, 4), (1, 1), (1, 1)]])
@pytest.mark.parametrize("size", [(1, 1), (13, 17), (40, 3), (33, 65)])
def test_samplings_read_as_jax_reads_them(hv, size, tmp_path):
    """Colour frames at each integral sampling libjpeg-turbo upsamples
    (h1v2 fancy, the rest replicated): 0 levels from PIL."""
    h, w = size
    hmax, vmax = max(a for a, _ in hv), max(b for _, b in hv)
    rng = np.random.RandomState(h * w + hmax * 7 + vmax)
    planes = [rng.randint(0, 256, (-(-h * v // vmax), -(-w * a // hmax)))
              .astype(np.uint8) for a, v in hv]
    data = chip_smoke.sampled_jpeg(h, w, planes, hv)
    _equal(_reads_match(data, tmp_path), _pil(data))


@pytest.mark.parametrize("hv", [[(3, 3), (1, 1), (1, 1)],
                                [(4, 4), (1, 1), (1, 1)],
                                [(2, 2), (3, 1), (1, 1)]])
def test_samplings_libjpeg_refuses(hv, tmp_path):
    """More than 10 blocks in an MCU, or a fractional factor: PIL and the
    port both refuse."""
    h, w = 16, 24
    hmax, vmax = max(a for a, _ in hv), max(b for _, b in hv)
    planes = [np.zeros((-(-h * v // vmax), -(-w * a // hmax)), np.uint8)
              for a, v in hv]
    data = chip_smoke.sampled_jpeg(h, w, planes, hv)
    with pytest.raises(OSError):
        _pil(data)
    with pytest.raises(ValueError):
        jpeg.decode(data)


# -- queue 1's last bullet: the TIFF kinds where PIL returns "garbage" --------


def _ycbcr_tiff(path, rng, hs, vs, comp, h=19, w=27, rows=8, tags=None):
    """Interleaved subsampled YCbCr strips (data units of h x v luma
    samples, then Cb and Cr)."""
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


def _queued_kinds(root):
    """The files of the queued kinds: old-style JPEG tiles in two columns,
    uncompressed subsampled YCbCr (followed by bytes PIL reads on into),
    4x4 YCbCr strips whose block row is no multiple of 4 bytes, and
    predictor 2 over rows that are no multiple of 3 bytes."""
    rng = np.random.RandomState(4)
    yy, xx = np.mgrid[:64, :80]
    img = np.clip(128 + 90 * np.sin(yy / 6) * np.cos(xx / 9)
                  + rng.randint(-9, 9, (64, 80)), 0, 255).astype(np.uint8)
    quad = np.concatenate([img[:32, :40], img[:32, 40:], img[32:, :40],
                           img[32:, 40:]])
    b = io.BytesIO()
    Image.fromarray(quad).save(b, "JPEG", quality=90, restart_marker_rows=4)
    parts = chip_smoke.jpeg_parts(b.getvalue())
    paths = {k: os.path.join(root, f"{k}.tif") for k in (
        "ojpeg_tiles", "ycbcr_none", "ycbcr_v4", "ycbcr_pred2")}
    chip_smoke.ojpeg_tiff(paths["ojpeg_tiles"], 64, 80, parts,
                          parts["intervals"], tile=(32, 40))
    _ycbcr_tiff(paths["ycbcr_none"], np.random.RandomState(5), 2, 2, 1)
    with open(paths["ycbcr_none"], "ab") as f:
        f.write(bytes(range(256)))
    _ycbcr_tiff(paths["ycbcr_v4"], np.random.RandomState(5), 4, 4, 5)
    _ycbcr_tiff(paths["ycbcr_pred2"], np.random.RandomState(6), 2, 1, 5,
                tags={317: (3, [2])})
    return paths


_READER = """
import hashlib, sys
import numpy as np
from PIL import Image
for p in sys.argv[1:]:
    with Image.open(p) as im:
        print(hashlib.sha256(np.asarray(im).tobytes()).hexdigest())
"""


def test_queued_tiff_kinds_read_from_the_file_s_bytes(tmp_path):
    """The decision on queue 1's last bullet: PIL's read of each kind is
    the same in fresh processes, also when ``MALLOC_PERTURB_`` fills the
    heap memory each one allocates with other bytes, so it is a function
    of the file's bytes and no uninitialised memory: the kinds stay
    queued.  The port keeps raising ``NotImplementedError`` naming M17
    for each."""
    paths = _queued_kinds(str(tmp_path))
    runs = []
    for perturb in ("", "1", "170"):
        env = {k: v for k, v in os.environ.items() if k != "MALLOC_PERTURB_"}
        if perturb:
            env["MALLOC_PERTURB_"] = perturb
        out = subprocess.run([sys.executable, "-c", _READER,
                              *paths.values()], capture_output=True,
                             text=True, env=env, timeout=120)
        assert out.returncode == 0, out.stderr
        runs.append(out.stdout.split())
    assert len(runs[0]) == 4 and runs[0] == runs[1] == runs[2]
    for path in paths.values():
        with pytest.raises(NotImplementedError, match="M17"):
            tiff.imread(path)
