"""JPEG 2000 read (``unmicst_tpu_torch/io/jpeg2000.py``, tier 1 and the
wavelets in ``native/j2kdec.cpp``) against the JAX package, which reaches
JPEG 2000 through PIL and openjpeg: the toolbox's ``imread``
(``unmicst_tpu/utils/imtools.py:48-56``) and the TIFF fallback that opens
a file under a TIFF name by content (``unmicst_tpu/io/slides.py:66-89``).
Every committed fixture (``tests/fixtures/torch_j2k``) and the two
4096^2 slides read as PIL reads them, 0 levels, with the native library
and without it; files PIL's encoder cannot make are refused naming M17;
truncated files raise where openjpeg conceals; header faults raise PIL's
exception classes; the native tier 1 and wavelets equal their plain
versions bit for bit; a JP2 under a TIFF name through both CLIs."""

import hashlib
import importlib.util
import io
import json
import os
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

from unmicst_tpu import cli as jax_cli
from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch import cli
from unmicst_tpu_torch.io import _native, identify, jpeg2000, slides, tiff
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_j2k")
MODELS = os.path.join(REPO, "models")
_spec = importlib.util.spec_from_file_location(
    "j2k_make", os.path.join(FIXTURES, "make.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)
NAMES = sorted(f for f in os.listdir(FIXTURES)
               if f.endswith((".jp2", ".j2k")) and not f.startswith("slide"))


@pytest.fixture(params=["native", "python"])
def codecs(request, monkeypatch):
    """Each test once with the native library and once without it."""
    assert _native.get_lib() is not None, "the native library did not load"
    if request.param == "python":
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    return request.param


def _outcome(fn):
    """``("ok", dtype, shape, bytes)`` or the exception's class name (any
    ``OSError`` as ``OSError``; an M17 refusal marked)."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = fn()
        return ("ok", r.dtype, r.shape, r.tobytes())
    except OSError:
        return "OSError"
    except Exception as e:  # noqa: BLE001
        return type(e).__name__ + (" M17" if "M17" in str(e) else "")


def _read(data: bytes, tmp_path, name="x.jp2"):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def test_fixtures_are_make_pys_cases():
    """The committed small fixtures are ``make.small_cases()`` byte for
    byte, each at most 8 KB, under 150 KB in all with PIL's reads, and
    ``reads.npz`` holds a read of each."""
    cases = mk.small_cases()
    assert NAMES == sorted(name + ext for name, (ext, _) in cases.items())
    assert sorted(np.load(os.path.join(FIXTURES, "reads.npz")).files) == \
        NAMES
    for name, (ext, data) in cases.items():
        assert _cs(name + ext) == data, name
    sizes = [os.path.getsize(os.path.join(FIXTURES, n)) for n in NAMES]
    assert max(sizes) <= 8192 and sum(sizes) + os.path.getsize(
        os.path.join(FIXTURES, "reads.npz")) <= 150 * 1024


@pytest.mark.parametrize("name", NAMES)
def test_fixture_reads_as_pil(name, codecs, tmp_path):
    """Each fixture through the toolbox's ``imread`` (its own name) and
    through ``read_channel`` under a TIFF name: the array the JAX
    package's reads give through PIL and the committed read, same dtype
    and shape, 0 levels; channel 1 ``IndexError`` in both packages."""
    path = os.path.join(FIXTURES, name)
    want = np.load(os.path.join(FIXTURES, "reads.npz"))[name]
    live = J.imread(path)
    assert live.dtype == want.dtype and live.shape == want.shape
    np.testing.assert_array_equal(live, want)
    got = T.imread(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    with open(path, "rb") as f:
        tif = _read(f.read(), tmp_path, "z.tif")
    a = jax_slides.read_channel(tif, "tif", 0)
    b = slides.read_channel(tif, "tif", 0)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    for read in (jax_slides.read_channel, slides.read_channel):
        with pytest.raises(IndexError):
            read(tif, "tif", 1)


@pytest.mark.parametrize("name", ["slide_lossy.jp2", "slide_lossless.j2k"])
def test_slides_hash_as_pil(name):
    """The 4096^2 slides the card decodes: the native decode's sha256 is
    the committed one of PIL's read, and PIL's read live is that array;
    the decode's stage times are reported."""
    with open(os.path.join(FIXTURES, "slides.json")) as f:
        ref = json.load(f)[name]
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    times = {}
    got = jpeg2000.load(data, jpeg2000.open_header(data), times)
    assert str(got.dtype) == ref["dtype"] and list(got.shape) == ref["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == ref["sha256"]
    assert set(times) == {"tier2", "tier1", "wavelet", "rest"}
    np.testing.assert_array_equal(
        np.asarray(Image.open(os.path.join(FIXTURES, name))), got)


# -- refusals, concealment and PIL's exceptions -------------------------------


def _cs(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _with_marker(cs: bytes, marker: int, body: bytes) -> bytes:
    segs, rest = mk.markers(cs)
    return mk.join(segs + [(marker, body)], rest)


def _edit_cod(cs: bytes, at: int, value: int) -> bytes:
    segs, rest = mk.markers(cs)
    segs = [(m, b[:at] + bytes([value]) + b[at + 1 :] if m == 0xFF52 else b)
            for m, b in segs]
    return mk.join(segs, rest)


def _edit_siz(cs: bytes, at: int, value: int) -> bytes:
    i = cs.index(b"\xff\x51") + 4
    return cs[: i + at] + bytes([value]) + cs[i + at + 1 :]


def _tile_marker(cs: bytes, marker: int, body: bytes) -> bytes:
    """``cs`` (one tile-part) with a marker segment in its tile-part
    header."""
    segs, rest = mk.markers(cs)
    seg = struct.pack(">HH", marker, len(body) + 2) + body
    psot = struct.unpack_from(">I", rest, 6)[0] + len(seg)
    sod = rest.index(b"\xff\x93")
    return mk.join(segs, rest[:6] + struct.pack(">I", psot) + rest[10:sod]
                   + seg + rest[sod:])


def _refused():
    """name -> a file PIL's encoder cannot write, which the port refuses
    naming M17 (PIL decodes some of them, refuses others)."""
    g, rgb = _cs("l_rlcp_layers.j2k"), _cs("rgb_97_nomct.j2k")
    cod = dict(mk.markers(g)[0])[0xFF52]
    return {
        "sycc": mk.jp2(rgb, mk.ihdr(40, 36, 3, 7) + mk.colr(18)),
        "subsampled": _edit_siz(rgb, 40, 2),
        "bypass": _edit_cod(g, 8, 1),
        "reset": _edit_cod(g, 8, 2),
        "termall": _edit_cod(g, 8, 4),
        "vertically_causal": _edit_cod(g, 8, 8),
        "predictable": _edit_cod(g, 8, 16),
        "segmentation_symbols": _edit_cod(g, 8, 32),
        "ht": _edit_cod(g, 8, 64),
        "sop": _edit_cod(g, 0, 2),
        "eph": _edit_cod(g, 0, 4),
        "poc": _with_marker(g, 0xFF5F, bytes([0, 0, 0, 1, 6, 0])),
        "rgn": _with_marker(g, 0xFF5E, bytes([0, 0, 2])),
        "ppm": _with_marker(g, 0xFF60, bytes([0])),
        "cap": _with_marker(g, 0xFF50, bytes(6)),
        "tile_cod": _tile_marker(g, 0xFF52, cod),
        "tile_ppt": _tile_marker(g, 0xFF61, bytes([0])),
        "prec_20": mk.set_precision(g, 19),
        "mixed_wavelets_mct": _with_marker(
            _cs("rgb_53_mct_layers.jp2")[
                _cs("rgb_53_mct_layers.jp2").index(b"jp2c") + 4 :],
            0xFF53, bytes([1, 0]) + dict(mk.markers(_cs(
                "rgb_53_mct_layers.jp2")[_cs("rgb_53_mct_layers.jp2")
                                         .index(b"jp2c") + 4 :])[0])[
                0xFF52][5:9] + bytes([0])),
    }


@pytest.mark.parametrize("name", sorted(_refused()))
def test_refused_naming_m17(name, tmp_path):
    """Code-block styles other than 0 (HT among them), SOP and EPH, POC,
    RGN, PPM, PPT, CAP, coding styles in a tile-part header, subsampled
    components, components above 16 bits, an sYCC JP2, a component
    transform over mixed wavelets: ``NotImplementedError`` naming M17
    from the toolbox and the TIFF fallback (channel 0; ``read_channel``
    wraps it in its ``ValueError``, as it wraps every failure there),
    whatever PIL does with the file."""
    data = _refused()[name]
    path = _read(data, tmp_path, "x.jp2")
    with pytest.raises(NotImplementedError, match="M17"):
        T.imread(path)
    tif = _read(data, tmp_path, "x.tif")
    with pytest.raises(NotImplementedError, match="M17"):
        tiff.read_page_fallback(tif, 0, ValueError("not a TIFF"))
    with pytest.raises(ValueError, match="M17"):
        slides.read_channel(tif, "tif", 0)


def _cuts():
    out = {}
    for name in ("l_lrcp.jp2", "rgb_pcrl_tiles_mct.jp2", "i16_97_layers.jp2",
                 "l_tile_parts.j2k"):
        data = _cs(name)
        for k in (len(data) // 5, len(data) // 2, len(data) - 40,
                  len(data) - 2, len(data) - 1):
            out[f"{name}-{k}"] = data[:k]
    return out


@pytest.mark.parametrize("case", sorted(_cuts()))
def test_truncated_files_never_differ(case, tmp_path):
    """A file cut short: where openjpeg conceals the missing data and
    PIL returns pixels the port raises ``OSError``; where PIL raises, the
    port raises the same class; never other pixels."""
    path = _read(_cuts()[case], tmp_path, "x.jp2")
    want, got = _outcome(lambda: J.imread(path)), _outcome(
        lambda: T.imread(path))
    assert got == want or (got == "OSError" and want[0] == "ok"), (got[:3],
                                                                   want[:3])


def _header_faults():
    g, lrcp = _cs("l_rlcp_layers.j2k"), _cs("l_lrcp.jp2")
    siz = g.index(b"\xff\x51")
    qcd = dict(mk.markers(g)[0])[0xFF5C]
    com = g.index(b"\xff\x64")
    return {
        "csiz_5": g[: siz + 38] + b"\x00\x05" + g[siz + 40 :],
        "lsiz_0": g[: siz + 2] + b"\x00\x00" + g[siz + 4 :],
        "lsiz_1": g[: siz + 2] + b"\x00\x01" + g[siz + 4 :],
        "siz_cut": g[:30],
        "size_zero": _edit_siz(g, 5, 0),
        "bomb": g[:siz + 6] + struct.pack(">II", 60000, 60000)
        + g[siz + 14 :],
        "com_length_0": g[: com + 2] + b"\x00\x00" + g[com + 4 :],
        "com_length_1": g[: com + 2] + b"\x00\x01" + g[com + 4 :],
        "jp2_signature_only": lrcp[:12],
        "jp2_no_jp2h": lrcp[:32] + mk.box(b"jp2c", g),
        "jp2_ihdr_short": mk.jp2(g, mk.box(b"ihdr", bytes(10)) + mk.colr(17)),
        "jp2_ihdr_nc_5": mk.jp2(g, mk.ihdr(37, 29, 5, 7) + mk.colr(17)),
        "jp2_ihdr_size_differs": mk.jp2(g, mk.ihdr(37, 30, 1, 7)
                                        + mk.colr(17)),
        "jp2_pclr_257": mk.jp2(g, mk.ihdr(37, 29, 1, 7) + mk.colr(16)
                               + mk.pclr([(k % 256, k // 256, 0)
                                          for k in range(300)], [7, 7, 7])
                               + mk.cmap(3)),
        "jp2_cmap_without_pclr": mk.jp2(g, mk.ihdr(37, 29, 1, 7)
                                        + mk.colr(17) + mk.cmap(3)),
        "jp2_gray_palette": mk.jp2(g, mk.ihdr(37, 29, 1, 7) + mk.colr(17)
                                   + mk.pclr([(1, 2, 3)], [7, 7, 7])
                                   + mk.cmap(3)),
        "jp2_box_length_0": lrcp[:12] + b"\x00\x00\x00\x00" + lrcp[16:],
        "jp2_eycc": mk.jp2(_cs("rgb_97_nomct.j2k"), mk.ihdr(40, 36, 3, 7)
                           + mk.colr(24)),
        "j2k_no_cod": mk.join([s for s in mk.markers(g)[0]
                               if s[0] != 0xFF52], mk.markers(g)[1]),
        "j2k_tlm_short": _with_marker(g, 0xFF55, b"\x00"),
        "j2k_crg_size": _with_marker(g, 0xFF63, bytes(5)),
        "j2k_tile_index": g[: g.index(b"\xff\x90") + 4] + b"\x00\x07"
        + g[g.index(b"\xff\x90") + 6 :],
        "j2k_guard_bits_7": g.replace(qcd, b"\xe0" + qcd[1:], 1),
        "j2k_exponents_31": g.replace(qcd, qcd[:1] + b"\xf8" * (len(qcd) - 1),
                                   1),
    }


@pytest.mark.parametrize("case", sorted(_header_faults()))
def test_header_faults_raise_pils_classes(case, tmp_path):
    """Headers PIL's plugin or openjpeg refuse, or that PIL hands to its
    next plugin: the same outcome (array or exception class) from both
    toolboxes' ``imread`` and both ``read_channel`` at channel 0 under a
    TIFF name."""
    data = _header_faults()[case]
    path = _read(data, tmp_path, "x.jp2")
    want = _outcome(lambda: J.imread(path))
    got = _outcome(lambda: T.imread(path))
    assert got == want or (got == "OSError" and want[0] == "ok"), (got[:3],
                                                                   want[:3])
    tif = _read(data, tmp_path, "x.tif")
    want = _outcome(lambda: jax_slides.read_channel(tif, "tif", 0))
    got = _outcome(lambda: slides.read_channel(tif, "tif", 0))
    assert got == want or (got == "ValueError" and want[0] == "ok"), (
        got[:3], want[:3])


def test_identification_hands_on_and_escapes_as_pil():
    """``identify.open_image``: a J2K whose SIZ PIL cannot parse goes to
    the next plugin (none: None), a JP2 that ends inside its boxes lets
    PIL's ``OSError`` escape, a readable one is ``JPEG2000``."""
    g = _cs("l_rlcp_layers.j2k")
    assert identify.open_image(g) == "JPEG2000"
    assert identify.open_image(g[:30]) is None
    with pytest.raises(OSError):
        identify.open_image(_cs("l_lrcp.jp2")[:12])
    assert "JPEG2000" in identify.READ and \
        "JPEG2000" not in identify.MAGIC_ONLY


# -- the native library against the plain versions ----------------------------


def test_native_tier1_is_bit_equal_to_plain():
    """Random bytes as code-block segments (every orientation, block
    shape, bit-plane count and pass count, several segments), through
    the native and the plain tier 1: the same result code and samples."""
    assert _native.get_lib() is not None
    rng = np.random.RandomState(22)
    for trial in range(60):
        blocks, segs, chunks, pos, off = [], [], [], 0, 0
        for _ in range(int(rng.randint(1, 4))):
            w, h = int(rng.randint(1, 20)), int(rng.randint(1, 20))
            first = len(segs)
            for _ in range(int(rng.randint(1, 3))):
                blob = rng.randint(0, 256, int(rng.randint(0, 40))).astype(
                    np.uint8).tobytes()
                segs.append((pos, len(blob), int(rng.randint(1, 30))))
                chunks.append(blob)
                pos += len(blob)
            numbps = int(rng.choice([0, 1, 5, 9, 14, 30, 31, 2**32 - 3]))
            blocks.append((off, w, h, w + 3, int(rng.randint(0, 4)), numbps,
                           first, len(segs) - first))
            off += h * (w + 3)
        blocks = np.array(blocks, np.int64)
        segs = np.array(segs, np.int64)
        data = b"".join(chunks)
        a, b = np.zeros(off, np.int32), np.zeros(off, np.int32)
        assert _native.j2k_t1(data, blocks, segs, a) == \
            jpeg2000.t1_decode_py(data, blocks, segs, b), trial
        np.testing.assert_array_equal(a, b)


def test_native_wavelets_are_bit_equal_to_plain():
    """Random tile-components (odd and even origins, one-sample rows and
    columns, up to 6 levels) through the native and the plain inverse
    5/3 (int32) and 9/7 (float32): the same bits."""
    rng = np.random.RandomState(23)
    for trial in range(80):
        x0, y0 = int(rng.randint(0, 9)), int(rng.randint(0, 9))
        x1, y1 = x0 + int(rng.randint(1, 40)), y0 + int(rng.randint(1, 40))
        nres = int(rng.randint(1, 7))
        bounds = np.array([[-(-v >> (nres - 1 - r)) for v in (x0, y0, x1, y1)]
                           for r in range(nres)], np.int64)
        h, w = y1 - y0, x1 - x0
        ints = rng.randint(-300, 300, (h, w)).astype(np.int32)
        a, b = ints.copy(), ints.copy()
        _native.j2k_idwt(a, bounds)
        jpeg2000.idwt53_py(b, bounds)
        np.testing.assert_array_equal(a, b)
        floats = (rng.randn(h, w) * 50).astype(np.float32)
        a, b = floats.copy(), floats.copy()
        _native.j2k_idwt(a, bounds)
        jpeg2000.idwt97_py(b, bounds)
        assert a.tobytes() == b.tobytes(), trial


# -- the CLI ------------------------------------------------------------------


def _outputs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_cli_on_a_jp2_under_a_tiff_name(tmp_path):
    """A 256 x 256 slide with nuclei as a lossy JP2 under ``.tif`` through
    both CLIs: the same files, pages within 1 uint8 level."""
    import chip_smoke

    rng = np.random.RandomState(256)
    x = (chip_smoke.blob_slide(rng, 256, 256, 12, 0.1) * 255).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(x).save(buf, "JPEG2000", irreversible=True,
                            quality_layers=[40], tile_size=(128, 128))
    path = tmp_path / "s" / "slide.tif"
    path.parent.mkdir()
    path.write_bytes(buf.getvalue())
    common = [str(path), "--tool", "unmicst-legacy", "--model", "blobDemo",
              "--modelRoot", MODELS, "--stackOutput"]
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
