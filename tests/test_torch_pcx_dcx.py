"""PCX and DCX read and PCX write (``unmicst_tpu_torch/io/pcx.py``), and
the order in which PIL tries its plugins (``io/identify.py``), against
the JAX package, which reaches these formats through PIL
(``PIL/PcxImagePlugin.py``, ``DcxImagePlugin.py``): the toolbox's
``imread`` / ``imwrite`` (``unmicst_tpu/utils/imtools.py:48-66``) and the
TIFF fallback that opens a file under a TIFF name by content
(``unmicst_tpu/io/tiff.py:1274-1291``, ``io/slides.py:66-97``).  The F7
repair first (a PCX, TGA, SGI or DCX file under a TIFF name, through
``read_channel``, ``tiff.imread`` and both CLIs), then every PCX layout
and DCX frame, the faults with PIL's exception classes, ``imwrite`` of
every dtype to ``.pcx`` byte for byte, the native RLE against its plain
versions, and files built from each format's header (and random bytes)
opened as PIL opens them."""

import importlib.util
import io
import os
import shutil
import struct
import tempfile
import warnings

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image, UnidentifiedImageError

from unmicst_tpu import cli as jax_cli
from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch import cli
from unmicst_tpu_torch.io import (_native, bmp, dds, identify, im, msp, pcx,
                                  qoi, slides, tiff, xbm)
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_rle")
_spec = importlib.util.spec_from_file_location(
    "rle_make", os.path.join(FIXTURES, "make.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)
MODELS = os.path.join(REPO, "models")
READS = sorted(k for k in mk.read_cases() if k.startswith(("pcx", "dcx")))
WRITES = sorted(k for k in mk.write_arrays() if k.startswith("pcx"))


@pytest.fixture(params=["native", "python"])
def codecs(request, monkeypatch):
    """Each test once with the native library and once without it."""
    assert _native.get_lib() is not None, "the native library did not load"
    if request.param == "python":
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    return request.param


def _outcome(fn):
    """``("ok", dtype, shape, values)`` or the exception's class name (any
    ``OSError`` as ``OSError``; PIL's ``DecompressionBombError`` and the
    port's by name)."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = fn()
        return ("ok", r.dtype, r.shape,
                (r != 0 if r.dtype == bool else r).tobytes())
    except OSError:
        return "OSError"
    except Exception as e:  # noqa: BLE001
        return type(e).__name__


def _all_entry_points_match(data: bytes, tmp_path, name="x.pcx",
                            channels=(0, 1)):
    """Both ``imread``s of ``data`` under a PCX name, both ``tiff.imread``s
    and both ``read_channel``s at ``channels`` of it under a TIFF name:
    the same arrays or exception classes, but where no plugin of PIL's
    opens the file (``UnidentifiedImageError``), which the port's
    ``tiff.imread`` answers with its TIFF reader's ``ValueError``.
    Returns JAX's ``imread`` outcome."""
    raw, tif = str(tmp_path / name), str(tmp_path / "x.tif")
    for path in (raw, tif):
        with open(path, "wb") as f:
            f.write(data)
    want = _outcome(lambda: J.imread(raw))
    assert _outcome(lambda: T.imread(raw)) == want
    try:
        Image.open(raw).close()
        unidentified = False
    except UnidentifiedImageError:
        unidentified = True
    except Exception:  # noqa: BLE001 -- a plugin's error escapes
        unidentified = False
    assert _outcome(lambda: tiff.imread(tif)) == (
        "ValueError" if unidentified else _outcome(
            lambda: jax_tiff.imread(tif)))
    for ch in channels:
        assert _outcome(lambda: slides.read_channel(tif, "tif", ch)) == \
            _outcome(lambda: jax_slides.read_channel(tif, "tif", ch))
    return want



def _pil_file(x: np.ndarray, ext: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(x).save(buf, format=ext)
    return buf.getvalue()


# -- F7: a PCX, TGA, SGI or DCX file under a TIFF name ------------------------


def _f7_file(kind: str, x: np.ndarray):
    """``(bytes, frames)``: ``x`` (gray uint8) as PIL writes a PCX or TGA,
    as an uncompressed 2-byte SGI (``x`` the high bytes, seeded low
    bytes) or as a 3-frame DCX of PIL's PCX files (frame 1 is ``x``)."""
    if kind in ("pcx", "tga"):
        return _pil_file(x, kind), 1
    if kind == "sgi":
        low = np.random.RandomState(7).randint(0, 256, x.shape)
        return mk.sgi((x.astype(np.uint16) << 8) | low.astype(np.uint16),
                      bpc=2), 1
    frames = [_pil_file(f, "pcx") for f in (255 - x, x, x // 2)]
    return mk.dcx(frames), 3


@pytest.mark.parametrize("kind", ["pcx", "tga", "sgi", "dcx"])
def test_f7_files_under_a_tiff_name_read_as_jax_reads_them(kind, tmp_path):
    """F7: the JAX fallback opens a file its TIFF reader refuses with
    ``Image.open``, which takes a PCX, TGA, SGI or DCX by content; the
    port re-raised its reader's refusal.  Each channel gives the JAX
    package's plane (a DCX's channel 1 its frame 1, an SGI's 2-byte
    samples their high bytes), through ``read_channel`` and
    ``tiff.imread``; past the last frame both raise ``IndexError``."""
    x = np.random.RandomState(12).randint(0, 256, (12, 10)).astype(np.uint8)
    data, frames = _f7_file(kind, x)
    path = str(tmp_path / "z.tif")
    with open(path, "wb") as f:
        f.write(data)
    for ch in range(frames):
        want = jax_slides.read_channel(path, "tif", ch)
        got = slides.read_channel(path, "tif", ch)
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == want.shape == (12, 10)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tiff.imread(path, ch),
                                      jax_tiff.imread(path, ch))
    np.testing.assert_array_equal(
        slides.read_channel(path, "tif", frames // 2), x)
    for read in (jax_slides.read_channel, slides.read_channel):
        with pytest.raises(IndexError):
            read(path, "tif", frames)


def _outputs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("kind", ["pcx", "tga", "sgi", "dcx"])
def test_f7_cli_on_each_kind_under_a_tiff_name(kind, tmp_path):
    """A 256 x 256 slide with nuclei as each kind under ``.tif`` (a DCX at
    ``--channel 2``, its frame 1) through both CLIs: the same files,
    pages within 1 uint8 level."""
    import chip_smoke

    rng = np.random.RandomState(256)
    x = (chip_smoke.blob_slide(rng, 256, 256, 12, 0.1) * 255).astype(
        np.uint8)
    data, frames = _f7_file(kind, x)
    path = tmp_path / "s" / "slide.tif"
    path.parent.mkdir()
    path.write_bytes(data)
    common = [str(path), "--tool", "unmicst-legacy", "--model", "blobDemo",
              "--modelRoot", MODELS, "--stackOutput", "--channel",
              str(frames // 2 + 1)]
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


# -- reads --------------------------------------------------------------------


def test_fixtures_are_the_listed_cases():
    names = sorted(f[:-4] for f in os.listdir(FIXTURES)
                   if f.endswith((".pcx", ".dcx"))
                   and not f.startswith("write_"))
    assert names == READS


@pytest.mark.parametrize("name", READS)
def test_committed_reads(name, codecs, tmp_path):
    """Every PCX and DCX fixture: each frame the port reads equals PIL's
    committed read (what the card checks) with the native and the plain
    decoder, and the JAX package's reads live; a DCX frame PIL refuses
    the port refuses."""
    ext, data = mk.read_cases()[name]
    with open(os.path.join(FIXTURES, f"{name}.{ext}"), "rb") as f:
        assert f.read() == data
    ref = np.load(os.path.join(FIXTURES, name + ".npz"))
    frames = 3 if ext == "dcx" else 1
    for k in range(frames):
        if f"frame{k}" not in ref.files:
            with pytest.raises(ValueError):
                pcx.read_frame(data, k)
            continue
        want, got = ref[f"frame{k}"], pcx.read_frame(data, k)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if codecs == "native":
        assert _all_entry_points_match(data, tmp_path, f"x.{ext}",
                                       range(frames + 1))[0] == "ok"


def _kinds():
    """(version, bits, planes, header stride, size)."""
    out = []
    for size in ((1, 1), (3, 5), (13, 17), (64, 129)):
        for version, bits, planes in ((5, 8, 1), (5, 8, 3), (2, 1, 1),
                                      (0, 1, 2), (3, 1, 4), (5, 1, 4)):
            for pad in (0, 1):
                out.append((version, bits, planes, pad, size))
    return out


@pytest.mark.parametrize("kind", _kinds(), ids=lambda k: "-".join(
    str(v) for v in (k[0], k[1], k[2], k[3], f"{k[4][0]}x{k[4][1]}")))
def test_kinds_read_as_jax_reads_them(kind, tmp_path):
    """Gray, RGB, bilevel and 2- and 4-plane palette images, each at the
    stride PIL computes and at a header stride it distrusts (an odd
    width's plane then padded), runs and literals, as a PCX and as frame
    1 of a DCX: the same dtype, shape and values from every entry
    point."""
    version, bits, planes, pad, (h, w) = kind
    rng = np.random.RandomState(version + bits + planes + pad + h)
    stride = (w * bits + 7) // 8
    stride += (stride % 2) if pad else 0
    if bits == 8:
        x = np.repeat(rng.randint(0, 256, (h, (w + 2) // 3) + (
            (3,) if planes == 3 else ())), 3, 1)[:, :w].astype(np.uint8)
    else:
        x = rng.randint(0, 1 << planes, (h, w)).astype(np.uint8)
    rows = mk._planes(x, bits, planes, stride)
    if pad and stride % 2 == 0:
        rows[:, stride - 1 :: stride] = 0xAB  # a padding byte PIL may read
    data = mk.pcx(rows, w, h, bits, planes, version=version,
                  stride=stride + 1 if pad else stride,
                  tail=mk.GRAY_TAIL if bits == 8 and planes == 1 else b"")
    want = _all_entry_points_match(data, tmp_path)
    assert want[0] == "ok" and want[2][:2] == (h, w)
    frames = mk.dcx([mk.read_cases()["pcx_gray"][1], data])
    assert _all_entry_points_match(frames, tmp_path, "x.dcx", (1,))[0] == "ok"


def _faults():
    """name -> a PCX or DCX file PIL reads with a quirk or refuses."""
    g = np.arange(12, dtype=np.uint8).reshape(3, 4)
    gray = mk.pcx(mk._planes(g, 8, 1, 4), 4, 3, 8, 1, tail=mk.GRAY_TAIL)
    short = mk.pcx(mk._planes(g, 8, 1, 4), 4, 3, 8, 1)
    return {
        "rle_truncated": gray[:130],
        "rle_run_past_row": gray[:128] + bytes([0xC6, 9]) + bytes(8)
        + mk.GRAY_TAIL,
        "rle_run_cut_at_end": gray[:128] + bytes(11) + bytes([0xC1])
        + mk.GRAY_TAIL[:0],
        "gray_shorter_than_a_palette": short,
        "version_4": gray[:1] + b"\x04" + gray[2:],
        "version_2_gray": gray[:1] + b"\x02" + gray[2:],
        "bits_4_one_plane": mk.pcx(mk._planes(g & 15, 1, 4, 2)[:, :2], 4, 3,
                                   4, 1),
        "box_empty": gray[:8] + struct.pack("<H", 0) + gray[10:],
        "header_short": gray[:60],
        "dcx_empty_table": struct.pack("<II", 0x3ADE68B1, 0) + gray,
        "dcx_table_cut": struct.pack("<II", 0x3ADE68B1, 12),
        "dcx_frame0_not_pcx": mk.dcx([b"\x0b" + gray[1:]]),
        "dcx_frame1_not_pcx": mk.dcx([gray, b"\x0b" + gray[1:]]),
        "dcx_frame1_offset_past_end": struct.pack("<IIII", 0x3ADE68B1, 16,
                                                  9999, 0) + gray,
        "dcx_frame1_unknown_mode": mk.dcx([gray, gray[:1] + b"\x04"
                                           + gray[2:]]),
        "dcx_frame1_rgb_after_palette": mk.read_cases()["dcx_mixed"][1],
        "bomb": gray[:8] + struct.pack("<HH", 65535, 65535) + gray[12:],
    }


@pytest.mark.parametrize("case", sorted(_faults()))
def test_faults_and_quirks_as_pil(case, tmp_path):
    """RLE cut short or past a row (``OSError``), the modes PIL refuses
    (``OSError``), a gray image in a file too short to seek for its
    palette, DCX tables PIL hands on and frames its ``seek`` refuses: the
    same outcome from every entry point, at channels 0 to 2."""
    data = _faults()[case]
    name = "x.dcx" if case.startswith("dcx") else "x.pcx"
    _all_entry_points_match(data, tmp_path, name, (0, 1, 2))


# -- writes -------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (13, 17), (257, 300),
                                   (13, 17, 2), (13, 17, 3), (13, 17, 4),
                                   (13,), (0, 4)])
def test_imwrite_is_byte_equal_to_jax(shape, tmp_path):
    """``imwrite`` of every dtype ``fromarray`` takes (and some it does
    not) at each shape to a ``.pcx`` name: PIL's file byte for byte (runs
    past 63 bytes and bytes of 0xC0 and up among them), or PIL's
    exception class; a ``.dcx`` name PIL's ``KeyError``."""
    rng = np.random.RandomState(len(shape) + shape[0])
    for dt in ("bool", "uint8", "runs", "int8", "uint16", "int32",
               "float32", "int64"):
        if dt == "bool":
            x = rng.rand(*shape) < 0.5
        elif dt == "runs":
            x = (rng.rand(*shape) < 0.02).astype(np.uint8) * 200
        else:
            x = (rng.randn(*shape) * 200).astype(dt)
        for ext in (".pcx", ".dcx"):
            pj, pt = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
            for p in (pj, pt):
                if os.path.exists(p):
                    os.remove(p)
            try:
                J.imwrite(x, pj)
            except Exception as e:  # noqa: BLE001
                with pytest.raises(type(e)):
                    T.imwrite(x, pt)
                continue
            T.imwrite(x, pt)
            with open(pj, "rb") as f, open(pt, "rb") as g:
                assert f.read() == g.read(), (dt, shape, ext)


@pytest.mark.parametrize("name", WRITES)
def test_committed_writes(name, codecs):
    """Every PCX write fixture: the port's bytes equal PIL's committed
    file (what the card checks) with the native and the plain encoder,
    and it reads back as PIL reads it."""
    x, ext = mk.write_arrays()[name]
    np.testing.assert_array_equal(
        np.load(os.path.join(FIXTURES, f"write_{name}.npy")), x)
    path = os.path.join(FIXTURES, f"write_{name}{ext}")
    with open(path, "rb") as f:
        assert pcx.encode_pcx(x) == f.read()
    got, want = T.imread(path), J.imread(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- the native RLE against the plain one -------------------------------------


def test_native_rle_is_bit_equal_to_plain():
    """Random byte streams (runs, literals, runs past a row), whole and
    cut short, through both decoders; random rows with long runs and
    bytes of 0xC0 and up through both encoders: the same result codes,
    rows and bytes."""
    assert _native.get_lib() is not None
    rng = np.random.RandomState(11)
    for trial in range(300):
        rows, row = int(rng.randint(1, 6)), int(rng.randint(1, 9))
        data = rng.randint(0, 256, int(rng.randint(0, 60))).astype(np.uint8)
        if trial % 2:
            data[data >= 0xC0] &= 0xC3  # short runs, so that rows fill
        data = data.tobytes()
        pos = int(rng.randint(0, 3))
        a = np.zeros((rows, row), np.uint8)
        b = np.zeros((rows, row), np.uint8)
        assert _native.pcx_rle_decode(data, pos, a) == pcx.rle_decode_py(
            data, pos, b), trial
        np.testing.assert_array_equal(a, b)
        planes = int(rng.choice([1, 3]))
        src = np.repeat(rng.randint(0, 256, (rows, planes * row, 1)), int(
            rng.choice([1, 40, 70])), 2).reshape(rows, -1)[:, : planes * 70]
        src = np.ascontiguousarray(src[:, : src.shape[1] // planes * planes],
                                   np.uint8)
        assert _native.pcx_rle_encode(src, planes) == pcx.rle_encode_py(
            src, planes), trial


# -- identification: which plugin of PIL's opens a file -----------------------


_DIR = tempfile.mkdtemp(prefix="unmicst-identify-")


def _pil_outcome(path: str):
    """``(format, outcome)`` of PIL's ``Image.open`` and ``np.asarray``
    of frame 0, the format None where ``Image.open`` raises."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            im = Image.open(path)
    except Exception:  # noqa: BLE001
        return None, _outcome(lambda: Image.open(path))
    with im:
        return im.format, _outcome(lambda: np.asarray(im))


def _identified_as_pil(data: bytes):
    """The port reads ``data`` exactly where PIL opens it as a PCX, DCX,
    SGI or TGA, with the same array (and the same exception class where
    the pixels fail), as for every format of ``identify.READ`` (the
    icons and textures among them); where PIL opens it as JPEG 2000,
    PIL's array or
    exception class, or ``NotImplementedError`` naming M17 (a layout
    PIL's encoder cannot write), or ``OSError`` where PIL returns pixels
    that openjpeg concealed; where PIL opens it as one of the raster
    formats PIL decodes itself (SPIDER, FITS, McIDAS, PSD, Sun raster,
    PIXAR, XV thumbnail, XPM, IMT, GBR, IPTC, PhotoCD) or as a stub it
    cannot load (BUFR, GRIB, HDF5, WMF, MPEG), PIL's array or exception
    class; a file PIL opens as a format the port does not read raises
    ``NotImplementedError`` naming M17; a file PIL does not open
    is not read: through the plugin order, the same exception class, or
    ``NotImplementedError`` where a plugin the port checks by magic alone
    (``identify.MAGIC_ONLY``: AVIF, WebP, TIFF) would refuse it;
    through a reader the port picks by magic bytes (TIFF, PNG, JPEG, BMP,
    GIF, Netpbm: earlier slices' readers, with their own error classes)
    an exception.  All through ``imread`` under a name PIL does not know;
    under a TIFF name, ``read_channel`` of channels 0 and 1 as JAX's
    where the classes are compared."""
    path = os.path.join(_DIR, "x.dat")
    with open(path, "wb") as f:
        f.write(data)
    fmt, want = _pil_outcome(path)
    fmt = {"XVThumb": "XVTHUMB"}.get(fmt, fmt)  # Image.ID's key
    got = _outcome(lambda: T.imread(path))
    # the readers the port picks by magic bytes, before the plugin order
    by_magic = data.startswith(tuple(head for head, _ in T._BY_CONTENT))
    compare = fmt in identify.READ or fmt in identify.NO_LOADER or (
        fmt is None and not by_magic)
    if fmt == "JPEG2000":
        # PIL's array or exception class; the port refuses what PIL's
        # encoder cannot write (M17) and raises where openjpeg conceals a
        # fault and returns pixels, never other pixels
        if got == "NotImplementedError":
            with pytest.raises(NotImplementedError, match="M17"):
                T.imread(path)
        else:
            assert got == want or (got == "OSError" and isinstance(
                want, tuple)), (fmt, got, want)
        compare = got == want
    elif fmt in identify.READ or fmt in identify.NO_LOADER:
        assert got == want, (fmt, got, want)
    elif fmt is None:
        assert not isinstance(got, tuple), (got, want)
        if got == "NotImplementedError" != want:  # a plugin PIL's _open
            # refuses (PIL's own NotImplementedError escapes Image.open)
            assert identify.open_image(data) in identify.MAGIC_ONLY
            compare = False
        elif not by_magic:
            assert got == want, (got, want)
    elif fmt not in ("BMP", "GIF", "JPEG", "MPO", "PPM", "PNG", "TIFF"):
        with pytest.raises(NotImplementedError, match="M17"):
            T.imread(path)
    tif = os.path.join(_DIR, "x.tif")
    shutil.copy(path, tif)
    for ch in (0, 1):
        got = _outcome(lambda: slides.read_channel(tif, "tif", ch))
        want = _outcome(lambda: jax_slides.read_channel(tif, "tif", ch))
        if compare:
            assert got == want, (fmt, ch, got, want)
    return fmt


_SETTINGS = settings(derandomize=True, deadline=None, max_examples=150,
                     database=None,
                     suppress_health_check=list(HealthCheck))
# random bytes, or bytes PIL's RLE decoders take as short packets
_BODY = st.one_of(st.binary(max_size=400),
                  st.lists(st.integers(0, 0x83), max_size=300).map(bytes),
                  st.lists(st.integers(0, 0xC1), max_size=300).map(bytes))


@st.composite
def _tga_headers(draw):
    sizes = st.sampled_from([1, 2, 3, 5, 6, 0])
    head = struct.pack(
        "<BBBHHBHHHHBB", draw(st.sampled_from([0, 0, 3, 28, 12])),
        draw(st.sampled_from([0, 0, 0, 1, 1, 2])),
        draw(st.sampled_from([3, 11, 2, 10, 1, 9, 0, 32])),
        draw(st.sampled_from([0, 0, 1, 250])), draw(st.integers(0, 20)),
        draw(st.sampled_from([24, 16, 32, 0, 15])), 0, 0, draw(sizes),
        draw(sizes), draw(st.sampled_from([8, 24, 16, 32, 1, 15])),
        draw(st.sampled_from([0, 0x20, 0x10, 0x30, 0x08, 0x28])))
    return head + draw(st.one_of(_BODY, st.binary(min_size=200,
                                                  max_size=400)))


@st.composite
def _sgi_headers(draw):
    head = struct.pack(">hBBHHHH", 474, draw(st.sampled_from([0, 0, 1, 2])),
                       draw(st.sampled_from([1, 2, 1, 3])),
                       draw(st.sampled_from([1, 2, 3, 3, 0])),
                       draw(st.integers(0, 6)), draw(st.integers(0, 4)),
                       draw(st.sampled_from([1, 3, 4, 1, 2])))
    return head + bytes(draw(st.sampled_from([500, 500, 0]))) + draw(_BODY)


@st.composite
def _pcx_headers(draw):
    x0, y0 = draw(st.integers(0, 3)), draw(st.integers(0, 3))
    head = (struct.pack("<BBBBHHHH", 10,
                        draw(st.sampled_from([5, 5, 0, 2, 3, 1])), 1,
                        draw(st.sampled_from([8, 8, 1, 2, 4])), x0, y0,
                        (x0 + draw(st.integers(-1, 9))) % 65536,
                        (y0 + draw(st.integers(-1, 5))) % 65536)
            + bytes(4 + 48 + 1)
            + struct.pack("<BH", draw(st.sampled_from([1, 3, 1, 2, 4])),
                          draw(st.integers(0, 6))) + bytes(60))
    return head + draw(_BODY) + draw(st.sampled_from(
        [b"", mk.GRAY_TAIL, b"\x0c" + bytes(range(256)) * 3]))


@st.composite
def _dcx_files(draw):
    frames = draw(st.lists(_pcx_headers(), max_size=3))
    data = mk.dcx(frames)
    return data[: draw(st.integers(4, len(data)))] if draw(
        st.booleans()) else data


@st.composite
def _built_files(draw):
    """A whole TGA, SGI, PCX or DCX file of drawn pixels, then maybe one
    byte changed or its end cut."""
    h, w = draw(st.integers(1, 6)), draw(st.integers(1, 9))
    seed = draw(st.integers(0, 2**16))
    rng = np.random.RandomState(seed)
    kind = draw(st.sampled_from(["tga", "tga_rle", "sgi", "sgi_rle", "pcx",
                                 "dcx"]))
    x = np.repeat(rng.randint(0, 256, (h, w, 3)), 2, 1)[:, :w].astype(
        np.uint8)
    if kind.startswith("tga"):
        itype, depth = draw(st.sampled_from([(3, 8), (2, 24), (2, 16),
                                             (3, 16), (2, 32)]))
        px = np.repeat(rng.randint(0, 256, (h, w, depth // 8)), 2, 1)[
            :, :w].astype(np.uint8)
        body = mk.tga_rle(px) if kind == "tga_rle" else px.tobytes()
        data = mk.tga(itype | (8 if kind == "tga_rle" else 0), depth, w, h,
                      body, flags=draw(st.sampled_from([0, 0x20, 0x30])))
    elif kind.startswith("sgi"):
        data = mk.sgi(x[..., 0] if seed % 2 else x, bpc=1 + seed % 3 // 2,
                      rle=kind == "sgi_rle")
    else:
        frame = mk.pcx(mk._planes(x, 8, 3, w + w % 2), w, h, 8, 3)
        data = frame if kind == "pcx" else mk.dcx([frame, frame])
    change = draw(st.sampled_from(["none", "byte", "cut"]))
    if change == "byte":
        k = draw(st.integers(0, len(data) - 1))
        data = data[:k] + bytes([draw(st.integers(0, 255))]) + data[k + 1 :]
    elif change == "cut":
        data = data[: draw(st.integers(0, len(data)))]
    return data


def _changed(draw, data: bytes) -> bytes:
    """``data`` as it is, with one byte changed, or cut."""
    change = draw(st.sampled_from(["none", "byte", "cut"]))
    if change == "byte" and data:
        k = draw(st.integers(0, len(data) - 1))
        data = data[:k] + bytes([draw(st.integers(0, 255))]) + data[k + 1 :]
    elif change == "cut":
        data = data[: draw(st.integers(0, len(data)))]
    return data


def _drawn_image(draw, modes):
    h, w = draw(st.integers(1, 5)), draw(st.integers(1, 12))
    rng = np.random.RandomState(draw(st.integers(0, 2**16)))
    mode = draw(st.sampled_from(modes))
    shape = {"1": (h, w), "L": (h, w), "LA": (h, w, 2), "RGB": (h, w, 3),
             "RGBA": (h, w, 4), "I;16": (h, w), "F": (h, w), "I": (h, w)}
    x = rng.randint(0, 256, shape[mode])
    return {"1": x > 127, "I;16": (x * 257).astype(np.uint16),
            "F": (x / 7).astype(np.float32), "I": x.astype(np.int32) - 99
            }.get(mode, x.astype(np.uint8))


@st.composite
def _msp_files(draw):
    """A written MSP file, or a version 1 or 2 header of drawn fields
    (checksum right or not) and a drawn body."""
    if draw(st.booleans()):
        return _changed(draw, msp.encode_msp(_drawn_image(draw, ["1"])))
    words = [draw(st.integers(0, 4)) for _ in range(16)]
    words[:2] = struct.unpack("<2H", draw(st.sampled_from([b"DanM",
                                                           b"LinS"])))
    words[2], words[3] = draw(st.integers(0, 12)), draw(st.integers(0, 5))
    words[12] = 0
    check = 0
    for v in words:
        check ^= v
    words[12] = check ^ draw(st.sampled_from([0, 0, 0, 1]))
    return struct.pack("<16H", *words) + draw(_BODY)


@st.composite
def _qoi_files(draw):
    """A written QOI file, or a header of drawn fields and a drawn body
    of chunks."""
    if draw(st.booleans()):
        return _changed(draw, qoi.encode_qoi(_drawn_image(draw, ["RGB",
                                                                 "RGBA"])))
    head = qoi.MAGIC + struct.pack(
        ">IIBB", draw(st.integers(0, 6)), draw(st.integers(0, 4)),
        draw(st.sampled_from([3, 4, 0, 5])), draw(st.integers(0, 1)))
    return draw(st.sampled_from([head, head[:12], head[:9]])) + draw(_BODY)


@st.composite
def _dds_files(draw):
    """A written DDS file, or a header of drawn flags, bit count, masks
    and FourCC (DX10 among them) and a drawn body."""
    if draw(st.booleans()):
        return _changed(draw, dds.encode_dds(_drawn_image(
            draw, ["L", "LA", "RGB", "RGBA"])))
    flags = draw(st.sampled_from([0x40, 0x41, 0x20000, 0x20001, 0x20, 0x4,
                                  0]))
    fourcc = draw(st.sampled_from([0, 0x31545844, 0x30315844, 0x12345678]))
    masks = draw(st.sampled_from([(0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                                  (0xF800, 0x7E0, 0x1F, 0),
                                  (0x7C00, 0x3E0, 0x1F, 0x8000),
                                  (0xFF, 0xFF, 0xFF, 0xFF00)]))
    head = (dds.MAGIC + struct.pack(
        "<7I", draw(st.sampled_from([124, 124, 100])), 0x100F,
        draw(st.integers(0, 4)), draw(st.integers(0, 6)), 0, 0, 0)
        + bytes(44) + struct.pack("<4I", 32, flags, fourcc, draw(
            st.sampled_from([8, 16, 24, 32, 0]))) + struct.pack("<4I", *masks)
        + bytes(20))
    dx10 = struct.pack("<5I", draw(st.sampled_from([28, 71, 2])), 3, 0, 0, 1)
    return head + (dx10 if fourcc == 0x30315844 else b"") + draw(
        st.sampled_from([b"", bytes(range(256)) * 4])) + draw(_BODY)


@st.composite
def _xbm_files(draw):
    """A written XBM file, or a header of drawn sizes (and hotspot) and
    a body of hex bytes, some of them cut or odd."""
    if draw(st.booleans()):
        return _changed(draw, xbm.encode_xbm(_drawn_image(draw, ["1"])))
    head = b"#define t_width %d\n#define t_height %d\n" % (
        draw(st.integers(0, 12)), draw(st.integers(0, 4)))
    if draw(st.booleans()):
        head += b"#define t_x_hot 1\n#define t_y_hot 2\n"
    cells = draw(st.lists(st.sampled_from([b"0x1f,", b"0xA0, ", b"0xx3,",
                                           b"0x", b"x9,", b"\n", b"0xG7,"]),
                          max_size=20))
    return draw(st.sampled_from([b"", b"  ", b"\n"])) + head + \
        b"static char t_bits[] = {\n" + b"".join(cells) + b"};\n"


@st.composite
def _im_files(draw):
    """A written IM file, or a header of drawn keys (image type, size,
    frames, Lut) and a drawn body."""
    if draw(st.booleans()):
        return _changed(draw, im.encode_im(_drawn_image(
            draw, ["1", "L", "LA", "RGB", "RGBA", "I;16", "F", "I"]),
            "t.im"))
    kind = draw(st.sampled_from(sorted(im.OPEN) + ["Foo image"]))
    lines = [b"Image type: " + kind.encode()]
    lines.append(b"Image size (x*y): %d*%d" % (draw(st.integers(0, 6)),
                                               draw(st.integers(0, 3))))
    if draw(st.booleans()):
        lines.append(b"File size (no of images): %d" % draw(
            st.integers(1, 3)))
    if draw(st.booleans()):
        lines.append(b"Lut: 1")
    if draw(st.booleans()):
        lines.insert(0, draw(st.sampled_from([b"Bad line", b"x" * 120])))
    head = b"\r\n".join(lines) + b"\r\n"
    head += bytes(draw(st.sampled_from([0, 40]))) + b"\x1a"
    return head + draw(st.sampled_from([b"", bytes(range(256)) * 3])) + \
        draw(_BODY)


@st.composite
def _dib_files(draw):
    """A written DIB file, or a BITMAPINFOHEADER of drawn depth,
    compression and palette size and a drawn body."""
    if draw(st.booleans()):
        return _changed(draw, bmp.encode_bmp(_drawn_image(
            draw, ["1", "L", "RGB", "RGBA"]), file_header=False))
    bits = draw(st.sampled_from([1, 4, 8, 16, 24, 32, 2]))
    head = struct.pack("<IiiHHIIiiII", draw(st.sampled_from([40, 40, 12,
                                                             108])),
                       draw(st.integers(1, 9)), draw(st.sampled_from(
                           [1, 3, -2])), 1, bits, draw(st.sampled_from(
                               [0, 0, 1, 2, 3])), 0, 0, 0,
                       draw(st.sampled_from([0, 2, 3])), 0)
    return head + draw(_BODY)


_RASTERS = importlib.util.spec_from_file_location(
    "rasters_make", os.path.join(REPO, "tests", "fixtures", "torch_rasters",
                                 "make.py"))
rk = importlib.util.module_from_spec(_RASTERS)
_RASTERS.loader.exec_module(rk)


@st.composite
def _raster_files(draw, kind):
    """A SPIDER, FITS, PSD, Sun raster or XPM file from the slice-23
    writers (``tests/fixtures/torch_rasters/make.py``), one header field
    drawn from the values PIL tells apart, then a byte changed or the end
    cut."""
    h, w = draw(st.integers(1, 5)), draw(st.integers(1, 6))
    x = (np.arange(h * w, dtype=np.uint8).reshape(h, w) * 29)
    if kind == "spider":
        order = draw(st.sampled_from([">", "<"]))
        n = draw(st.integers(1, 3))
        data = rk.spider([x.astype(np.float32)] * n, order,
                         stack=n > 1 or draw(st.booleans()))
        word = draw(st.sampled_from([5, 24, 27, 13, 22]))
        head = rk.spider_header(h, w, order, **{f"w{word}": draw(
            st.sampled_from([1, 0, 2, -11, 3]))})
        if draw(st.booleans()):
            data = head + data[len(head) :]
    elif kind == "fits":
        data = rk.fits(x, draw(st.sampled_from([8, 16, 32, -32, -64])),
                       draw(st.booleans())) if draw(st.booleans()) else \
            rk.fits_gzip(x, draw(st.sampled_from([8, 16, 32])))
        at = draw(st.sampled_from([0, 10, 89, 169, 249]))
        data = data[:at] + draw(st.sampled_from([b"S", b"X", b"1", b"E"])) + \
            data[at + 1 :]
    elif kind == "psd":
        mode = draw(st.sampled_from([1, 3, 4, 9, 2, 6]))
        n = {1: 1, 3: 3, 4: 4, 9: 3, 2: 1, 6: 1}[mode]
        data = rk.psd([x] * n, mode, 8, draw(st.sampled_from([0, 1])),
                      layers=[(0, 0, draw(st.sampled_from([[0], [0, 1, 2]])),
                               [x[:2, :2]] * 3, b"a")][: draw(
                                   st.integers(0, 1))])
    elif kind == "sun":
        depth = draw(st.sampled_from([1, 4, 8, 24, 32, 16]))
        rows = np.repeat(x, 4, 1)[:, : (w * depth + 7) // 8]
        data = rk.sun(rows, w, depth, draw(st.sampled_from([1, 2, 3, 7])),
                      draw(st.sampled_from([b"", bytes(6), bytes(2000)])))
    else:
        cols = ["#%06x" % (k * 99991) for k in range(3)]
        if draw(st.booleans()):
            cols[1] = draw(st.sampled_from(["None", "blue"]))
        data = rk.xpm(x % 3, cols, cpp=draw(st.sampled_from([1, 2])))
    return _changed(draw, data)


@st.composite
def _metafile_and_stub_files(draw):
    """A placeable WMF or an EMF header with its fields drawn, or the head
    of a BUFR, GRIB, HDF5 or MPEG file, each with a drawn body."""
    kind = draw(st.sampled_from(["wmf", "emf", "stub"]))
    if kind == "wmf":
        s = b"\xd7\xcd\xc6\x9a\0\0" + struct.pack(
            "<hhhhH", 0, 0, draw(st.sampled_from([100, 0, -5])), 50,
            draw(st.sampled_from([72, 0, 96]))) + bytes(6) + draw(
                st.sampled_from([b"\x01\x00\t\x00", b"\x01\x00\x00\x00"]))
    elif kind == "emf":
        s = b"\x01\0\0\0" + bytes(4) + struct.pack(
            "<8i", 0, 0, draw(st.sampled_from([10, 0])), 12, 0, 0,
            draw(st.sampled_from([100, 0])), 90) + draw(
                st.sampled_from([b" EMF", b"EMF "]))
    else:
        s = draw(st.sampled_from([b"BUFR", b"ZCZC", b"GRIB\0\0\0\x01",
                                  b"GRIB\0\0\0\x00", b"\x89HDF\r\n\x1a\n",
                                  b"\0\0\1\xb3\x01\x00\x10"]))
    return _changed(draw, s + draw(st.binary(max_size=40)))


_ICONS = importlib.util.spec_from_file_location(
    "icons_make", os.path.join(REPO, "tests", "fixtures", "torch_icons",
                               "make.py"))
ik = importlib.util.module_from_spec(_ICONS)
_ICONS.loader.exec_module(ik)
_ICON_CASES = ik.small_cases()
# the fixtures whose payload is a JPEG or JPEG 2000 stream: only the
# header bytes that leave the stream whole are drawn here (the JPEG and
# JPEG 2000 strategies hold those decoders to PIL, with openjpeg's
# concealment of a cut stream exempt)
_CODEC_PAYLOADS = {"blp1_jpeg": list(range(28)),
                   "icns_ic09": [0, 1, 2, 3, 8, 9, 10, 11]}
_EPS_LINES = [b"%!PS-Adobe-3.0", b"%!PS-Adobe-3.0 EPSF-3.0", b"%!PS",
              b"%%BoundingBox: 0 0 5 4", b"%%BoundingBox: 1 1 1 9",
              b"%%BoundingBox: (atend)", b"%%BoundingBox: 0 0 x 4",
              b"%%EndComments", b"%%Trailer", b"%%EOF", b"%%Creator: x",
              b"%ImageData: 7 3 8 3 0 1 1 \"b\"", b"%ImageData: 7 3 1 1",
              b"%ImageData: 7 3 8 7", b"%ImageData: 7 3 4 3",
              b"%ImageData: 0 3 8 1", b"%%BeginBinary: 3", b"showpage",
              b"% a comment", b"%" + b"z" * 260, b"q" * 260, b""]


@st.composite
def _icon_files(draw, kind):
    """A fixture of ``tests/fixtures/torch_icons`` of the kind (ICO, CUR,
    ICNS, BLP, FTEX) with a header byte drawn from the values the plugins
    tell apart, any byte changed, or its end cut; FLI: a random file of
    every chunk type (:func:`make.fli_random`); EPS: DSC lines drawn,
    behind ``%!PS`` or a DOS EPS header."""
    if kind == "fli":
        return ik.fli_random(np.random.RandomState(draw(st.integers(
            0, 2**16))))
    if kind == "eps":
        lines = draw(st.lists(st.sampled_from(_EPS_LINES), max_size=8))
        body = draw(st.sampled_from([b"\n", b"\r\n", b"\r"])).join(
            [draw(st.sampled_from(_EPS_LINES[:3]))] + lines)
        if draw(st.booleans()):
            body = struct.pack("<III", 0xC6D3D0C5, draw(st.sampled_from(
                [12, 30, 0, 9999])), len(body)) + bytes(18) + body
        return body
    names = sorted(n for n in _ICON_CASES if n.startswith(kind))
    name = draw(st.sampled_from(names))
    data = _ICON_CASES[name]
    edit = draw(st.sampled_from(["none", "head", "byte", "cut"]))
    heads = list(range(min(len(data), 40)))
    for prefix, at in _CODEC_PAYLOADS.items():
        if name.startswith(prefix):
            edit, heads = "head" if edit != "none" else edit, at
    if edit == "head":
        k = draw(st.sampled_from(heads))
        v = draw(st.sampled_from([0, 1, 2, 3, 4, 7, 8, 16, 24, 32, 40, 128,
                                  255, 0x7F, 0x80]))
        data = data[:k] + bytes([v]) + data[k + 1 :]
    elif edit == "byte":
        k = draw(st.integers(0, len(data) - 1))
        data = data[:k] + bytes([draw(st.integers(0, 255))]) + data[k + 1 :]
    elif edit == "cut":
        data = data[: draw(st.integers(0, len(data)))]
    return data


_J2K = os.path.join(REPO, "tests", "fixtures", "torch_j2k")
_J2K_BASES = [open(os.path.join(_J2K, f), "rb").read() for f in (
    "l_rlcp_layers.j2k", "l_lrcp.jp2", "rgb_97_nomct.j2k", "p_palette.jp2",
    "la_offsets.jp2")]


@st.composite
def _j2k_files(draw):
    """A J2K or JP2 fixture with its SIZ fields, one box header, its JP2
    header boxes or one byte drawn, or its end cut: PIL's ``_open``
    refuses some (``SyntaxError`` and ``struct.error``: the next plugin;
    ``OSError``, ``ValueError``: escape), openjpeg others."""
    data = draw(st.sampled_from(_J2K_BASES))
    kind = draw(st.sampled_from(["siz", "box", "jp2h", "byte", "cut"]))
    if kind == "siz":
        at = data.index(b"\xff\x51") + draw(st.sampled_from(
            [2, 3, 9, 13, 17, 39, 40, 41, 42]))
        return data[:at] + bytes([draw(st.sampled_from(
            [0, 1, 2, 5, 0x80, 0xFF]))]) + data[at + 1 :]
    if kind == "box":
        at = draw(st.sampled_from([0, 3, 4, 7, 12, 15, 16, 20, 32, 35, 36,
                                   40]))
        return data[:at] + bytes([draw(st.sampled_from(
            [0, 1, 8, 0x14, 0x2D, 0x6A, 0xFF]))]) + data[at + 1 :]
    if kind == "jp2h":
        cs = _J2K_BASES[0]
        boxes = b""
        for _ in range(draw(st.integers(0, 3))):
            typ = draw(st.sampled_from([b"ihdr", b"colr", b"pclr", b"res ",
                                        b"cmap", b"xml "]))
            if typ == b"ihdr":
                body = struct.pack(">IIHBBBB", draw(st.sampled_from(
                    [37, 0, 1])), draw(st.sampled_from([29, 0, 2])),
                    draw(st.integers(0, 5)), draw(st.sampled_from(
                        [7, 15, 0x87])), 7, 0, 0)
            elif typ == b"colr":
                body = struct.pack(">BBBI", draw(st.integers(0, 3)), 0, 0,
                                   draw(st.sampled_from([12, 16, 17, 18,
                                                         99])))
            elif typ == b"pclr":
                n = draw(st.integers(0, 3))
                body = struct.pack(">HB", draw(st.integers(0, 3)), n) + \
                    bytes([7] * n) + bytes(draw(st.integers(0, 12)))
            else:
                body = bytes(draw(st.integers(0, 12)))
            boxes += struct.pack(">I4s", 8 + len(body), typ) + body
        data = (b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
                + struct.pack(">I4s", 20, b"ftyp") + b"jp2 \0\0\0\0jp2 "
                + struct.pack(">I4s", 8 + len(boxes), b"jp2h") + boxes
                + struct.pack(">I4s", 8 + len(cs), b"jp2c") + cs)
    return _changed(draw, data) if kind != "jp2h" or draw(
        st.booleans()) else data


_ICON_KINDS = ("ico", "cur", "icns", "blp", "ftex", "fli", "eps")


@pytest.mark.parametrize("strategy", ["tga", "sgi", "pcx", "dcx", "built",
                                      "random", "msp", "qoi", "dds", "xbm",
                                      "im", "dib", "jpeg2000", "spider",
                                      "fits", "psd", "sun", "xpm",
                                      "metafiles", *_ICON_KINDS])
def test_identification_and_reads_match_pil(strategy):
    """Byte strings that start with each format's header (fields drawn
    from the values PIL tells apart), whole files of each format with a
    byte changed or the end cut, or random bytes: where each plugin of
    PIL's takes the file, hands it on or lets its error escape, the port
    agrees (see ``_identified_as_pil``).  The MSP, QOI, DDS, XBM, IM and
    DIB strategies reach the plugins the port reads since slice 21 in
    full, the JPEG 2000 one JPEG 2000, the SPIDER, FITS, PSD, Sun raster
    and XPM ones those formats, the metafile one WMF and the stubs (read,
    or refused as PIL refuses them), and the ICO, CUR, ICNS, BLP, FTEX,
    FLI and EPS ones those formats, with PIL's full header checks (EPS
    opened, its pixels refused naming M17), and check that they do."""
    strategies = {"tga": _tga_headers(), "sgi": _sgi_headers(),
                  "pcx": _pcx_headers(), "dcx": _dcx_files(),
                  "built": _built_files(), "random": st.binary(max_size=64),
                  "msp": _msp_files(), "qoi": _qoi_files(),
                  "dds": _dds_files(), "xbm": _xbm_files(),
                  "im": _im_files(), "dib": _dib_files(),
                  "jpeg2000": _j2k_files(),
                  "metafiles": _metafile_and_stub_files(),
                  **{k: _raster_files(k) for k in ("spider", "fits", "psd",
                                                   "sun", "xpm")},
                  **{k: _icon_files(k) for k in _ICON_KINDS}}

    @_SETTINGS
    @given(strategies[strategy])
    def check(data):
        seen.add(_identified_as_pil(data))

    seen = set()
    check()
    if strategy in ("msp", "qoi", "dds", "xbm", "im", "dib", "jpeg2000",
                    "spider", "fits", "psd", "sun", "xpm", *_ICON_KINDS):
        assert strategy.upper() in seen, seen
    if strategy == "metafiles":
        assert {"WMF", "BUFR", "GRIB", "HDF5", "MPEG"} <= seen, seen
