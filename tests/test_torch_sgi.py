"""SGI read and write (``unmicst_tpu_torch/io/sgi.py``) against the JAX
package, which reaches them through PIL (``PIL/SgiImagePlugin.py``): the
toolbox's ``imread`` / ``imwrite`` (``unmicst_tpu/utils/imtools.py:48-66``)
and the TIFF fallback that opens a file under a TIFF name by content
(``unmicst_tpu/io/tiff.py:1274-1291``, ``io/slides.py:66-97``).  Gray,
RGB and RGBA, 1 and 2 bytes a sample (2-byte samples with random high
and low bytes, read as their high byte), verbatim and RLE, at odd sizes;
the faults with PIL's exception classes; ``imwrite`` of every dtype to
every SGI name, the image name included, byte for byte; the native RLE
decode against its plain version."""

import importlib.util
import os
import struct
import warnings

import numpy as np
import pytest
from PIL import Image, UnidentifiedImageError

from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch.io import _native, sgi, slides, tiff
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_rle")
_spec = importlib.util.spec_from_file_location(
    "rle_make", os.path.join(FIXTURES, "make.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)
READS = sorted(k for k in mk.read_cases() if k.startswith("sgi"))
WRITES = sorted(k for k in mk.write_arrays() if k.startswith("sgi"))


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


def _all_entry_points_match(data: bytes, tmp_path, name="x.sgi"):
    """Both ``imread``s of ``data`` under an SGI name, both ``tiff.imread``s
    and both ``read_channel``s at channels 0 and 1 of it under a TIFF
    name: the same arrays or exception classes, but where no plugin of
    PIL's opens the file (``UnidentifiedImageError``), which the port's
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
    for ch in (0, 1):
        assert _outcome(lambda: slides.read_channel(tif, "tif", ch)) == \
            _outcome(lambda: jax_slides.read_channel(tif, "tif", ch))
    return want



# -- reads --------------------------------------------------------------------


def test_fixtures_are_the_listed_cases():
    names = sorted(f[:-4] for f in os.listdir(FIXTURES) if f.endswith(".sgi")
                   and not f.startswith("write_"))
    assert names == READS


@pytest.mark.parametrize("name", READS)
def test_committed_reads(name, codecs, tmp_path):
    """Every SGI fixture: the port's read equals PIL's committed read
    (what the card checks) with the native and the plain decoder, and the
    JAX package's reads live."""
    data = mk.read_cases()[name][1]
    with open(os.path.join(FIXTURES, name + ".sgi"), "rb") as f:
        assert f.read() == data
    want = np.load(os.path.join(FIXTURES, name + ".npz"))["frame0"]
    got = sgi.read_frame(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if codecs == "native":
        assert _all_entry_points_match(data, tmp_path)[0] == "ok"


def _kinds():
    """(channels, bytes a sample, RLE, size)."""
    return [(z, bpc, rle, size)
            for size in ((1, 1), (1, 9), (13, 17), (130, 257))
            for z in (1, 3, 4) for bpc in (1, 2) for rle in (False, True)]


@pytest.mark.parametrize("kind", _kinds(), ids=lambda k: "-".join(
    str(v) for v in (k[0], k[1], "rle" if k[2] else "raw",
                     f"{k[3][0]}x{k[3][1]}")))
def test_kinds_read_as_jax_reads_them(kind, tmp_path):
    """Each channel count, sample size and storage, runs and copies in
    the RLE, one-row images (dimension 1): the same dtype, shape and
    values from every entry point; a 2-byte sample reads as its high
    byte."""
    z, bpc, rle, (h, w) = kind
    rng = np.random.RandomState(z * 10 + bpc * 3 + rle + h)
    top = 256 if bpc == 1 else 65536
    x = np.repeat(rng.randint(0, top, (h, (w + 3) // 4, z)), 4, 1)[:, :w]
    x[:, 2::7] = rng.randint(0, top, x[:, 2::7].shape)
    x = x[..., 0] if z == 1 else x
    data = mk.sgi(x.astype(np.uint16 if bpc == 2 else np.uint8), bpc=bpc,
                  rle=rle)
    want = _all_entry_points_match(data, tmp_path)
    assert want[0] == "ok" and want[2][:2] == (h, w)
    assert np.array_equal(np.frombuffer(want[3], np.uint8).reshape(want[2]),
                          x >> 8 if bpc == 2 else x)


def _rle(rows, bpc=1, starts=None, lengths=None, h=1, w=3, z=1, dim=2):
    """An RLE SGI file of the packet bytes ``rows`` (one a row and
    channel), with its own start and length tables unless given."""
    head = struct.pack(">hBBHHHH", 474, 1, bpc, dim if z == 1 else 3, w, h, z)
    head += bytes(512 - len(head))
    pos = 512 + 8 * len(rows)
    if starts is None:
        starts = []
        for r in rows:
            starts.append(pos)
            pos += len(r)
    if lengths is None:
        lengths = [len(r) for r in rows]
    return (head + struct.pack(f">{len(rows)}I", *starts)
            + struct.pack(f">{len(rows)}I", *lengths) + b"".join(rows))


def _faults():
    """name -> an SGI file PIL reads with a quirk or refuses."""
    raw = struct.pack(">hBBHHHH", 474, 0, 1, 2, 3, 2, 1)
    raw += bytes(512 - len(raw))
    return {
        "raw_short_mapped": raw + bytes(5),
        "raw_short_rgb": raw.replace(b"\0\x02\0\x03\0\x02\0\x01",
                                     b"\0\x03\0\x03\0\x02\0\x03") + bytes(17),
        "raw_short_16bit": raw.replace(b"\x00\x01\x00\x02",
                                       b"\x00\x02\x00\x02", 1) + bytes(11),
        "header_short": raw[:300],
        "header_cut_in_fields": raw[:7],
        "mode_2d_rgb": raw.replace(b"\0\x02\0\x03\0\x02\0\x01",
                                   b"\0\x02\0\x03\0\x02\0\x03") + bytes(18),
        "bpc_3": raw.replace(b"\x00\x01\x00\x02", b"\x00\x03\x00\x02", 1),
        "size_zero": raw.replace(b"\0\x03\0\x02\0\x01", b"\0\x00\0\x02\0\x01"),
        "storage_2": raw.replace(b"\x01\xda\x00", b"\x01\xda\x02") + bytes(6),
        "rle_tables_short": _rle([b"\x83\x01\x02\x03\x00"])[:515],
        "rle_start_in_header": _rle([b"\x03\x07\x00"], starts=[100]),
        "rle_start_past_end": _rle([b"\x00"], starts=[9000], lengths=[0]),
        "rle_start_past_end_read": _rle([b"\x00"], starts=[9000]),
        "rle_row_past_width": _rle([b"\x04\x07\x00"]),
        "rle_copy_to_last_byte": _rle([b"\x83\x01\x02\x03"]),
        "rle_one_count_left": _rle([b"\x03\x07\x00", b"\x01\x05"], h=2,
                                   lengths=[3, 1]),
        "rle_length_stops_early": _rle([b"\x01\x05\x02\x06\x00"],
                                       lengths=[2]),
        "rle_no_end_packet": _rle([b"\x03\x07", b"\x03\x09\x00"], h=2),
        "rle_16bit_odd_end": _rle([b"\x00\x03\x01\x02\x00"], bpc=2),
        "bomb": struct.pack(">hBBHHHH", 474, 0, 1, 2, 65535, 65535, 1),
    }


@pytest.mark.parametrize("case", sorted(_faults()))
def test_faults_and_quirks_as_pil(case, tmp_path):
    """Data cut short (``ValueError`` where PIL maps the file or builds
    the planes from bytes, ``OSError`` where it reads them), the modes and
    sizes PIL refuses, RLE tables and packets that overrun, a length that
    stops the decode early: the same outcome from every entry point."""
    _all_entry_points_match(_faults()[case], tmp_path)


# -- writes -------------------------------------------------------------------


@pytest.mark.parametrize("ext", list(sgi.EXTENSIONS))
@pytest.mark.parametrize("shape", [(1, 1), (1, 13), (13, 17), (257, 300),
                                   (13, 17, 2), (13, 17, 3), (13, 17, 4),
                                   (13,), (0, 4)])
def test_imwrite_is_byte_equal_to_jax(shape, ext, tmp_path):
    """``imwrite`` of every dtype ``fromarray`` takes (and some it does
    not) at each shape to each SGI name: PIL's file byte for byte (its
    base name in the header), or PIL's exception class."""
    rng = np.random.RandomState(len(shape) + shape[0])
    for dt in ("bool", "uint8", "int8", "uint16", "int32", "float32",
               "int64"):
        x = (rng.rand(*shape) < 0.5 if dt == "bool"
             else (rng.randn(*shape) * 200).astype(dt))
        pj, pt = tmp_path / "j", tmp_path / "t"
        for d in (pj, pt):
            d.mkdir(exist_ok=True)
        name = "slide \u00e9 " + "n" * 90 + ext
        pj, pt = str(pj / name), str(pt / name)
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
def test_committed_writes(name):
    """Every SGI write fixture: the port's bytes equal PIL's committed
    file (what the card checks), and it reads back as PIL reads it."""
    x, ext = mk.write_arrays()[name]
    np.testing.assert_array_equal(
        np.load(os.path.join(FIXTURES, f"write_{name}.npy")), x)
    path = os.path.join(FIXTURES, f"write_{name}{ext}")
    with open(path, "rb") as f:
        assert sgi.encode_sgi(x, path) == f.read()
    got, want = T.imread(path), J.imread(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- the native decode against the plain one ----------------------------------


def test_native_rle_decode_is_bit_equal_to_plain():
    """Random tables and packet streams, whole and cut short, at 1 and 2
    bytes a sample: the native and plain decoders give the same result
    code and rows."""
    assert _native.get_lib() is not None
    rng = np.random.RandomState(10)
    for trial in range(300):
        bpc = int(rng.choice([1, 2]))
        h, z, w = int(rng.randint(1, 4)), int(rng.choice([1, 3])), int(
            rng.randint(1, 6))
        rows = []
        for _ in range(h * z):
            n = int(rng.randint(0, 6))
            packets = rng.randint(0, 256, n * (1 + bpc)).astype(np.uint8)
            if trial % 2:  # short counts, so that rows fit
                packets &= 0x83
            rows.append(packets.tobytes() + bytes(bpc * (trial % 3 > 0)))
        lengths = [len(r) if rng.rand() < 0.8 else int(rng.randint(0, 9))
                   for r in rows]
        data = _rle(rows, bpc=bpc, lengths=lengths, h=h, w=w, z=z)
        if trial % 5 == 0:
            data = data[: int(rng.randint(512, len(data) + 1))]
        a = np.zeros((h, z, w * bpc), np.uint8)
        b = np.zeros((h, z, w * bpc), np.uint8)
        rc_native = _native.sgi_rle_decode(data, a, bpc)
        rc_plain = sgi.rle_decode_py(data, b, bpc)
        assert rc_native == rc_plain, (trial, rc_native, rc_plain)
        np.testing.assert_array_equal(a, b)
