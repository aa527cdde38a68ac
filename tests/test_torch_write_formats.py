"""The toolbox's remaining PIL writes and the reads beside them
(``unmicst_tpu_torch/io/bmp.py``'s DIB, ``io/im.py``, ``io/msp.py``,
``io/palm.py``, ``io/xbm.py``, ``io/qoi.py``, ``io/eps.py``,
``io/dds.py``; ``utils/imtools.py``'s extension table), against the JAX
package, which reaches them through PIL: the toolbox's ``imwrite``
(``unmicst_tpu/utils/imtools.py:59-66``, ``Image.fromarray(x).save``)
byte for byte, or the same exception class, for every extension PIL 12
saves and every mode ``fromarray`` gives; the toolbox's ``imread`` and,
under a TIFF name, ``tiff.imread`` and ``slides.read_channel``
(``unmicst_tpu/io/tiff.py:1273-1291``, ``io/slides.py:66-97``) of DIB,
IM, MSP, XBM, QOI and uncompressed DDS files; the native QOI coding
against its plain versions; and the committed fixtures of
``tests/fixtures/torch_write`` (PIL's files and reads), which
``chip_smoke.py`` checks on the card."""

import importlib.util
import os
import warnings

import numpy as np
import pytest
from PIL import Image

from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch.io import (_native, bmp, dds, identify, im, qoi,
                                  slides, tiff)
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_write")
_spec = importlib.util.spec_from_file_location(
    "write_make", os.path.join(FIXTURES, "make.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)
READABLE = (".dib", ".im", ".msp", ".xbm", ".qoi", ".dds")


def _arrays(seed: int, h: int = 9, w: int = 14):
    """One seeded array of each dtype and shape ``fromarray`` takes (and
    a few it refuses)."""
    rng = np.random.RandomState(seed)
    u8 = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
    return {
        "bool": rng.rand(h, w) < 0.5,
        "uint8": u8[..., 0],
        "la": u8[..., :2],
        "rgb": u8[..., :3],
        "rgba": u8,
        "uint16": rng.randint(0, 65536, (h, w)).astype(np.uint16),
        "uint16be": rng.randint(0, 65536, (h, w)).astype(">u2"),
        "int16": rng.randint(-999, 999, (h, w)).astype(np.int16),
        "int32": rng.randint(-2**31, 2**31, (h, w)).astype(np.int32),
        "uint32": rng.randint(0, 2**32, (h, w)).astype(np.uint32),
        "float32": rng.standard_normal((h, w)).astype(np.float32),
        "float64": rng.standard_normal((h, w)),
        "int64": rng.randint(0, 9, (h, w)).astype(np.int64),
        "rgb16": rng.randint(0, 9, (h, w, 3)).astype(np.uint16),
    }


def _outcome(fn):
    """``("ok", dtype, shape, values)`` or the exception's class name
    (bool values as 0 and 1: PIL's arrays of mode ``1`` hold 0 and 255)."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = np.asarray(fn())
        return ("ok", r.dtype.str, r.shape,
                (r != 0 if r.dtype == bool else r).tobytes())
    except OSError:
        return "OSError"
    except Exception as e:  # noqa: BLE001
        return type(e).__name__


def _write_both(x, ext, tmp_path):
    """Both packages' ``imwrite(x, "<dir>/w<ext>")``: (bytes or the
    exception, for JAX and the port), the same base name in both (IM
    files hold it)."""
    out = []
    for pkg, sub in ((J, "jax"), (T, "port")):
        d = tmp_path / sub
        d.mkdir(exist_ok=True)
        path = str(d / f"w{ext}")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                pkg.imwrite(x, path)
            with open(path, "rb") as f:
                out.append(f.read())
        except Exception as e:  # noqa: BLE001
            out.append(e)
    return out


WRITTEN = (".dib", ".apng", ".mpo", ".im", ".msp", ".palm", ".xbm", ".qoi",
           ".eps", ".ps", ".dds", ".gif")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ext", WRITTEN)
def test_imwrite_is_byte_equal_to_jax(ext, seed, tmp_path):
    """Every mode ``fromarray`` gives, also of empty images: the port's
    file is PIL's byte for byte, or both raise the same exception class
    (and PIL's message);
    PNG (and so APNG) the port writes with its own deflate, so those are
    held to the port's PNG and to PIL's read of them."""
    arrays = _arrays(seed, 9 + seed, 14 + 3 * seed)
    arrays.update({f"empty_{k}": v[:0] for k, v in _arrays(seed).items()})
    for name, x in arrays.items():
        want, got = _write_both(x, ext, tmp_path)
        if isinstance(want, Exception) or isinstance(got, Exception):
            assert type(got) is type(want), (ext, name, want, got)
            assert str(got) == str(want), (ext, name)
            continue
        if ext != ".apng":
            assert got == want, (ext, name)
            continue
        png = tmp_path / "port" / "w.png"
        T.imwrite(x, str(png))
        assert got == png.read_bytes(), name
        assert want == _write_both(x, ".png", tmp_path)[0], name
        np.testing.assert_array_equal(
            np.asarray(Image.open(str(tmp_path / "port" / "w.apng"))),
            np.asarray(Image.open(str(tmp_path / "jax" / "w.apng"))))


@pytest.mark.parametrize("ext,error", [
    (".blp", ValueError), (".bufr", OSError), (".grib", OSError),
    (".h5", OSError), (".hdf", OSError), (".wmf", OSError), (".emf", OSError),
    (".fits", KeyError), (".psd", KeyError), (".xyz", ValueError),
    ("", ValueError)])
def test_imwrite_refuses_as_pil_refuses(ext, error, tmp_path):
    """Extensions whose save PIL refuses for every image ``fromarray``
    makes (BLP), whose handlers are stubs, that PIL reads and cannot
    write, or that it does not know: its exception class and message."""
    x = _arrays(3)["uint8"]
    want, got = _write_both(x, ext, tmp_path)
    assert type(want) is error and type(got) is error
    assert str(got) == str(want)


@pytest.mark.parametrize("ext", T.QUEUED)
def test_queued_writes_name_m17(ext, tmp_path):
    """WebP, JPEG 2000 and AVIF, which PIL writes through its codecs,
    raise ``NotImplementedError`` naming ROADMAP M17; a dtype
    ``fromarray`` refuses raises its ``TypeError`` first."""
    with pytest.raises(NotImplementedError, match="M17"):
        T.imwrite(_arrays(4)["uint8"], str(tmp_path / f"q{ext}"))
    with pytest.raises(TypeError):
        T.imwrite(_arrays(4)["int64"], str(tmp_path / f"q{ext}"))


def _pil_files(seed: int, tmp_path):
    """name -> bytes: PIL's files of every mode each readable format
    writes, and the read fixtures' other layouts."""
    out = {}
    for name, x in _arrays(seed, 7 + seed, 11 + seed).items():
        for ext in READABLE:
            path = str(tmp_path / f"pil{ext}")
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    Image.fromarray(x).save(path)
            except Exception:  # noqa: BLE001 -- PIL does not write it
                continue
            with open(path, "rb") as f:
                out[f"{name}{ext}"] = f.read()
    for name, (ext, data) in mk.read_cases().items():
        out[f"read_{name}{ext}"] = data
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_reads_match_jax(seed, tmp_path):
    """DIB, IM, MSP, XBM, QOI and DDS files: the port's ``imread`` is the
    JAX toolbox's; under a TIFF name its ``tiff.imread`` and
    ``read_channel`` of channels 0 and 1 are JAX's (an IM file of two
    frames: channel 1 is frame 1)."""
    for name, data in _pil_files(seed, tmp_path).items():
        ext = os.path.splitext(name)[1]
        raw, tif = str(tmp_path / f"x{ext}"), str(tmp_path / "x.tif")
        for path in (raw, tif):
            with open(path, "wb") as f:
                f.write(data)
        want = _outcome(lambda: J.imread(raw))
        assert want[0] == "ok", (name, want)
        assert _outcome(lambda: T.imread(raw)) == want, name
        assert _outcome(lambda: tiff.imread(tif)) == _outcome(
            lambda: jax_tiff.imread(tif)), name
        for ch in (0, 1):
            assert _outcome(lambda: slides.read_channel(tif, "tif", ch)) \
                == _outcome(lambda: jax_slides.read_channel(tif, "tif",
                                                            ch)), (name, ch)


@pytest.mark.parametrize("seed", range(4))
def test_written_files_read_back(seed, tmp_path):
    """Each format the port both writes and reads gives back what was
    written (IM's ``I;16``, ``F`` and ``I`` among them; MSP's and XBM's
    bool), as PIL's ``np.asarray`` reads the same file."""
    arrays = _arrays(10 + seed, 5 + 3 * seed, 8 + 5 * seed)
    takes = {".dib": ("bool", "uint8", "rgb"), ".msp": ("bool",),
             ".xbm": ("bool",), ".qoi": ("rgb", "rgba"),
             ".dds": ("uint8", "la", "rgb", "rgba"),
             ".im": ("bool", "uint8", "la", "rgb", "rgba", "uint16",
                     "uint16be", "int32", "float32")}
    for ext, names in takes.items():
        for name in names:
            path = str(tmp_path / f"r{ext}")
            T.imwrite(arrays[name], path)
            got = T.imread(path)
            np.testing.assert_array_equal(got, arrays[name])
            pil = np.asarray(Image.open(path))
            assert got.dtype == pil.dtype and got.shape == pil.shape
            np.testing.assert_array_equal(got, pil)


def test_refused_headers_go_on_as_in_pil(tmp_path):
    """A QOI, MSP or DDS header that PIL's ``_open`` refuses hands the
    file to the next plugin (here none opens it: ``OSError`` from both
    ``imread``s); a DDS header of another size lets PIL's ``OSError``
    escape, an unknown pixel format its ``NotImplementedError``, and a
    block-compressed one (DXT1) reads as PIL reads it
    (``tests/test_torch_bcn.py`` holds every block format)."""
    cases = {
        "qoi_zero": qoi.MAGIC + bytes(10),
        "qoi_short": qoi.MAGIC + b"\0\0",
        "msp_checksum": b"DanM" + bytes([3, 0, 2, 0]) + bytes(24),
        "msp_short": b"LinS" + bytes(10),
        "dds_short": b"DDS \x7c",
        "dds_size": b"DDS " + bytes([100, 0, 0, 0]) + bytes(120),
        "dds_flags": mk.dds_file(2, 2, 0, 8, (0, 0, 0, 0), bytes(4)),
    }
    for name, data in cases.items():
        path = str(tmp_path / "x.dat")
        with open(path, "wb") as f:
            f.write(data)
        want = _outcome(lambda: J.imread(path))
        assert want != "ok" and _outcome(lambda: T.imread(path)) == want, (
            name, want)
    dxt1 = mk.dds_file(4, 4, 0x4, 0, (0, 0, 0, 0), bytes(8),
                       fourcc=0x31545844)
    path = str(tmp_path / "b.dds")
    with open(path, "wb") as f:
        f.write(dxt1)
    want = J.imread(path)
    assert want.shape == (4, 4, 4)
    got = T.imread(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_native_qoi_matches_plain(seed):
    """``native/qoicodec.cpp`` against ``io/qoi.py``'s plain loops:
    the same chunks for runs, index hits, diffs, lumas and full pixels,
    the same pixels back; data cut short: no native result, and the plain
    decode raises what PIL's decoder raises."""
    assert _native.get_lib() is not None, "the native library did not load"
    rng = np.random.RandomState(seed)
    bands = 3 + seed % 2
    base = rng.randint(0, 256, (1, bands))
    steps = rng.randint(-3, 4, (300, bands)) * rng.randint(0, 2, (300, 1))
    px = ((base + np.cumsum(steps, 0)) % 256).astype(np.uint8)
    px[rng.rand(300) < 0.2] = px[0]
    px = np.repeat(px, rng.randint(1, 70, 300), 0)
    coded = _native.qoi_encode(px)
    assert coded == qoi.encode_py(px, bands)
    back = _native.qoi_decode(coded, 0, len(px), bands)
    np.testing.assert_array_equal(back.reshape(-1, bands), px)
    np.testing.assert_array_equal(qoi.decode_py(coded, 0, len(px), bands),
                                  back)
    cut = coded[: len(coded) // 2]
    assert _native.qoi_decode(cut, 0, len(px), bands) is None
    with pytest.raises((IndexError, ValueError)):
        qoi.decode_py(cut, 0, len(px), bands)


def test_im_bit_layouts_and_frames_match_pil(tmp_path):
    """IM's odd-width ``F`` layouts through PIL's bit decoder (its buffer
    kept across rows), the planar RGB3 and 2-bit palette layouts, and
    ``seek`` past frame 0 with PIL's frame size."""
    rng = np.random.RandomState(9)
    for kind, w, h, n in (("L*12", 7, 3, 40), ("L*5", 9, 4, 30),
                          ("L*23", 3, 3, 40), ("RGB3", 5, 2, 30),
                          ("B2", 6, 3, 30), ("L 16", 4, 3, 48)):
        data = mk.im_file(kind, w, h, rng.randint(0, 256, n).astype(
            np.uint8).tobytes(), frames=2)
        path = str(tmp_path / "bits.im")
        with open(path, "wb") as f:
            f.write(data)
        for k in (0, 1):
            def pil():
                with Image.open(path) as f:
                    f.seek(k)
                    return np.asarray(f)
            assert _outcome(lambda: im.read_frame(data, k)) == \
                _outcome(pil), (kind, k)


def test_dib_start_is_where_pil_reads():
    """A DIB's pixels start after the header, the BITFIELDS masks of a
    40-byte header and the palette: as PIL's reads leave the file."""
    x = _arrays(5)["uint8"]
    data = bmp.encode_bmp(x, file_header=False)
    assert bmp.dib_start(data) == 40 + 1024
    np.testing.assert_array_equal(bmp.read_frame(data), x)
    with pytest.raises(EOFError):
        bmp.read_frame(data, 1)
    assert dds.open_header(dds.encode_dds(x)).offset == 128


def test_fixtures_written_and_read_as_pil(tmp_path):
    """Every committed fixture: the port's write of each seeded array is
    PIL's file, byte for byte; the port's read of each file of a format
    it reads is PIL's array (``reads.npz``)."""
    reads = np.load(os.path.join(FIXTURES, "reads.npz"))
    for name, (x, ext) in mk.write_arrays().items():
        fname = f"write_{name}{ext}"
        with open(os.path.join(FIXTURES, fname), "rb") as f:
            want = f.read()
        if ext == ".apng":  # PIL's deflate: held by its pixels
            np.testing.assert_array_equal(
                np.asarray(Image.open(os.path.join(FIXTURES, fname))), x)
            continue
        path = str(tmp_path / fname)  # IM files hold their base name
        T._BY_EXTENSION[ext](path, x)
        with open(path, "rb") as f:
            assert f.read() == want, fname
    for key in reads.files:
        fname, _, frame = key.partition("#")
        with open(os.path.join(FIXTURES, fname), "rb") as f:
            data = f.read()
        got = identify.read(data, int(frame or 0), fname)
        assert got.dtype == reads[key].dtype, key
        np.testing.assert_array_equal(got, reads[key])
