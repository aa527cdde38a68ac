"""TGA read and write (``unmicst_tpu_torch/io/tga.py``) against the JAX
package, which reaches them through PIL (``PIL/TgaImagePlugin.py``): the
toolbox's ``imread`` / ``imwrite`` (``unmicst_tpu/utils/imtools.py:48-66``)
and the TIFF fallback that opens a file under a TIFF name by content
(``unmicst_tpu/io/tiff.py:1274-1291``, ``io/slides.py:66-97``).  Every
image type and depth, raw and RLE, both orientations and the mirror, the
colour maps and the id section, at odd sizes; the faults with PIL's
exception classes; ``imwrite`` of every dtype to every TGA name, byte for
byte; the native RLE decode against its plain version."""

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
from unmicst_tpu_torch.io import _native, slides, tga, tiff
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_rle")
_spec = importlib.util.spec_from_file_location(
    "rle_make", os.path.join(FIXTURES, "make.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)
READS = sorted(k for k in mk.read_cases() if k.startswith("tga"))
WRITES = sorted(k for k in mk.write_arrays() if k.startswith("tga"))


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


def _all_entry_points_match(data: bytes, tmp_path, name="x.tga"):
    """Both ``imread``s of ``data`` under a TGA name, both ``tiff.imread``s
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
    names = sorted(f[:-4] for f in os.listdir(FIXTURES) if f.endswith(".tga")
                   and not f.startswith("write_"))
    assert names == READS


@pytest.mark.parametrize("name", READS)
def test_committed_reads(name, codecs, tmp_path):
    """Every TGA fixture: the port's read equals PIL's committed read
    (what the card checks) with the native and the plain decoder, and the
    JAX package's reads live."""
    data = mk.read_cases()[name][1]
    with open(os.path.join(FIXTURES, name + ".tga"), "rb") as f:
        assert f.read() == data
    want = np.load(os.path.join(FIXTURES, name + ".npz"))["frame0"]
    got = tga.read_frame(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if codecs == "native":
        assert _all_entry_points_match(data, tmp_path)[0] == "ok"


def _kinds():
    """(image type, depth, colour-map depth, flags, size)."""
    out = []
    for size in ((1, 1), (13, 17), (130, 257)):
        for itype, depth, cmap in ((3, 8, 0), (3, 1, 0), (3, 16, 0),
                                   (2, 24, 0), (2, 32, 0), (2, 16, 0),
                                   (1, 8, 16), (1, 8, 24)):
            for rle in (0, 8):
                if depth == 1 and rle:
                    continue
                for flags in (0x00, 0x20, 0x10, 0x30):
                    if size[0] == 130 and flags in (0x10, 0x30):
                        continue
                    out.append((itype | rle, depth, cmap, flags, size))
    return out


@pytest.mark.parametrize("kind", _kinds(), ids=lambda k: "-".join(
    str(v) for v in (k[0], k[1], k[2], hex(k[3]), f"{k[4][0]}x{k[4][1]}")))
def test_kinds_read_as_jax_reads_them(kind, tmp_path):
    """Types 1-3 and 9-11 at every depth PIL reads, colour maps of 16 and
    24 bits, each orientation and the mirror, RLE whose raw packets run on
    across rows: the same dtype, shape and values from every entry
    point."""
    itype, depth, cmap_depth, flags, (h, w) = kind
    rng = np.random.RandomState(itype * 7 + depth + flags + h)
    nbytes = max(1, depth // 8)
    if depth == 1:
        body = np.packbits(rng.rand(h, w) < 0.5, axis=1).tobytes()
    else:
        px = rng.randint(0, 256, (h, (w + 2) // 3, nbytes)).astype(np.uint8)
        if cmap_depth:
            px %= 16
        px = np.ascontiguousarray(np.repeat(px, 3, 1)[:, :w])
        px[:, 1::5] = rng.randint(0, 16 if cmap_depth else 256,
                                  px[:, 1::5].shape)
        body = mk.tga_rle(px) if itype & 8 else px.tobytes()
    cmap = rng.randint(0, 256, 16 * cmap_depth // 8).astype(
        np.uint8).tobytes() if cmap_depth else b""
    data = mk.tga(itype, depth, w, h, body, flags=flags, cmap=cmap,
                  cmap_depth=cmap_depth, idsec=b"id" if h == 13 else b"")
    want = _all_entry_points_match(data, tmp_path)
    assert want[0] == "ok" and want[2][:2] == (h, w)


def _faults():
    """name -> a TGA file PIL reads with a quirk or refuses."""
    g = bytes(range(6))
    return {
        "raw_short_mapped": mk.tga(3, 8, 3, 2, g[:5], footer=False),
        "raw_short_read": mk.tga(2, 24, 2, 1, g[:5], footer=False),
        "raw_short_la": mk.tga(3, 16, 3, 1, g[:5], footer=False),
        "rle_truncated": mk.tga(11, 8, 3, 2, bytes([0x82, 7]), footer=False),
        "rle_packet_cut": mk.tga(11, 8, 3, 1, bytes([0x02, 7, 8]),
                                 footer=False),
        "rle_run_past_row": mk.tga(11, 8, 3, 2, bytes([0x83, 7, 0x81, 9])),
        "rle_raw_past_image": mk.tga(11, 8, 2, 2, bytes([0x06]) + bytes(7)),
        "rle_bilevel": mk.tga(11, 1, 8, 1, bytes([0x80, 0xFF]) * 8),
        "type1_without_map": mk.tga(1, 8, 3, 2, g),
        "type9_without_map": mk.tga(9, 8, 2, 1, bytes([0x81, 3])),
        "map_32": mk.tga(1, 8, 3, 2, g, cmap=bytes(8), cmap_depth=32),
        "map_15": mk.tga(1, 8, 3, 2, g, cmap=bytes(4), cmap_depth=15),
        "map_257": mk.tga(1, 8, 3, 2, g, cmap=bytes(3 * 257), cmap_depth=24),
        "map_first_past_256": mk.tga(1, 8, 3, 2, g, cmap=bytes(30),
                                     cmap_depth=24, cmap_first=250),
        "map_on_gray": mk.tga(3, 8, 3, 2, g, cmap=bytes(6), cmap_depth=24),
        "map_on_rgb": mk.tga(2, 24, 2, 1, g, cmap=bytes(6), cmap_depth=24),
        "map_on_bilevel": mk.tga(3, 1, 8, 2, g[:2], cmap=bytes(6),
                                 cmap_depth=24),
        "map_32_rle_overrun": mk.tga(9, 8, 2, 1, bytes([0x83, 1]),
                                     cmap=bytes(8), cmap_depth=32),
        "type1_depth16": mk.tga(1, 16, 2, 1, bytes(4), cmap=bytes(6),
                                cmap_depth=24),
        "type3_depth24": mk.tga(3, 24, 2, 1, bytes(6)),
        "type2_depth8": mk.tga(2, 8, 2, 1, bytes(2)),
        "depth15": mk.tga(2, 15, 2, 1, bytes(4)),
        "type0": mk.tga(0, 8, 2, 1, bytes(2)),
        "size_zero": mk.tga(3, 8, 0, 1, bytes(2)),
        "header_short": mk.tga(3, 8, 2, 1, b"", footer=False)[:17],
        "id_past_end": mk.tga(3, 8, 2, 1, b"", footer=False)[:18].replace(
            b"\0", b"\x40", 1),
        "bomb": mk.tga(3, 8, 65535, 65535, b""),
    }


@pytest.mark.parametrize("case", sorted(_faults()))
def test_faults_and_quirks_as_pil(case, tmp_path):
    """Data cut short (``ValueError`` where PIL maps the file, ``OSError``
    where it reads it), RLE faults, colour maps PIL puts on the image and
    refuses, types and depths it opens and does not load, and headers no
    plugin takes: the same outcome from every entry point."""
    _all_entry_points_match(_faults()[case], tmp_path)


# -- writes -------------------------------------------------------------------


@pytest.mark.parametrize("ext", list(tga.EXTENSIONS))
@pytest.mark.parametrize("shape", [(1, 1), (13, 17), (257, 300), (13, 17, 2),
                                   (13, 17, 3), (13, 17, 4), (13,), (0, 4)])
def test_imwrite_is_byte_equal_to_jax(shape, ext, tmp_path):
    """``imwrite`` of every dtype ``fromarray`` takes (and some it does
    not) at each shape to each TGA name: PIL's file byte for byte, or
    PIL's exception class."""
    rng = np.random.RandomState(len(shape) + shape[0])
    for dt in ("bool", "uint8", "int8", "uint16", "int32", "float32",
               "float64", "int64"):
        x = (rng.rand(*shape) < 0.5 if dt == "bool"
             else (rng.randn(*shape) * 200).astype(dt))
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
def test_committed_writes(name):
    """Every TGA write fixture: the port's bytes equal PIL's committed
    file (what the card checks), and it reads back as PIL reads it."""
    x, ext = mk.write_arrays()[name]
    np.testing.assert_array_equal(
        np.load(os.path.join(FIXTURES, f"write_{name}.npy")), x)
    path = os.path.join(FIXTURES, f"write_{name}{ext}")
    with open(path, "rb") as f:
        assert tga.encode_tga(x) == f.read()
    got, want = T.imread(path), J.imread(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- the native decode against the plain one ----------------------------------


def test_native_rle_decode_is_bit_equal_to_plain():
    """Random packet streams, whole and cut short, at each depth: the
    native and plain decoders give the same result code and rows."""
    assert _native.get_lib() is not None
    rng = np.random.RandomState(9)
    for trial in range(300):
        depth = int(rng.choice([0, 1, 2, 3, 4]))
        rows, row = int(rng.randint(1, 6)), int(rng.randint(1, 5)) * max(
            depth, 1)
        data = rng.randint(0, 256, int(rng.randint(0, 80))).astype(
            np.uint8).tobytes()
        if trial % 3 == 0:  # mostly short packets, so that rows fill
            data = bytes(b & 0x83 for b in data)
        pos = int(rng.randint(0, 3))
        a = np.zeros((rows, row), np.uint8)
        b = np.zeros((rows, row), np.uint8)
        rc_native = _native.tga_rle_decode(data, pos, a, depth)
        rc_plain = tga.rle_decode_py(data, pos, b, depth)
        assert rc_native == rc_plain, (trial, rc_native, rc_plain)
        np.testing.assert_array_equal(a, b)


def test_header_fields_reach_the_decoder():
    """The header's offsets after an id section and a colour map, and
    the depth in bytes, as the decoder sees them."""
    body = mk.tga_rle(np.arange(6, dtype=np.uint8).reshape(2, 3, 1))
    data = mk.tga(9, 8, 3, 2, body, idsec=b"abc", cmap=bytes(6),
                  cmap_depth=24, cmap_first=1)
    hdr = tga.open_header(data)
    assert hdr.offset == 18 + 3 + 6 and hdr.palette_entries == 3
    assert struct.unpack_from("<H", data, 5)[0] == 2
    np.testing.assert_array_equal(tga.read_frame(data),
                                  np.arange(6).reshape(2, 3)[::-1])
