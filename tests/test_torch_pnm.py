"""Netpbm read and write (``unmicst_tpu_torch/io/pnm.py``) against the JAX
package, which reaches them through PIL (``PIL/PpmImagePlugin.py``): the
toolbox's ``imread`` / ``imwrite`` (``unmicst_tpu/utils/imtools.py:49-67``)
and the TIFF fallback that opens a file under a TIFF name by content
(``unmicst_tpu/io/tiff.py:1274-1291``, ``io/slides.py:66-97``).  P1-P6
plain and binary across maxvals, ``Pf`` in both byte orders and PIL's
own kinds, at odd sizes; the header's and the data's faults with PIL's
exception classes; ``imwrite`` of every dtype to every Netpbm name, byte
for byte; both CLIs on a 16-bit PGM under a TIFF name."""

import importlib.util
import os
import warnings

import numpy as np
import pytest

from unmicst_tpu import cli as jax_cli
from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch import cli
from unmicst_tpu_torch.io import pnm, slides, tiff
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_pnm")
_spec = importlib.util.spec_from_file_location(
    "pnm_make", os.path.join(FIXTURES, "make.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)
READS = sorted(mk.read_cases())
WRITES = sorted(mk.write_arrays())


def _outcome(fn):
    """``("ok", dtype, shape, values)`` or the exception's class (any
    ``OSError`` as ``OSError``: PIL's ``UnidentifiedImageError`` and the
    port's are both)."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = fn()
        return ("ok", r.dtype, r.shape,
                (r != 0 if r.dtype == bool else r).tobytes())
    except OSError:
        return OSError
    except Exception as e:  # noqa: BLE001
        return type(e)


def _all_entry_points_match(data: bytes, tmp_path):
    """Both ``imread``s of ``data`` under a Netpbm name, both
    ``read_channel``s at channels 0 and 1 and both ``tiff.imread``s of it
    under a TIFF name: the same arrays or exception classes.  Returns the
    JAX ``imread`` outcome."""
    raw, tif = str(tmp_path / "x.pnm"), str(tmp_path / "x.tif")
    for path in (raw, tif):
        with open(path, "wb") as f:
            f.write(data)
    want = _outcome(lambda: J.imread(raw))
    assert _outcome(lambda: T.imread(raw)) == want
    assert _outcome(lambda: tiff.imread(tif)) == _outcome(
        lambda: jax_tiff.imread(tif))
    for ch in (0, 1):
        assert _outcome(lambda: slides.read_channel(tif, "tif", ch)) == \
            _outcome(lambda: jax_slides.read_channel(tif, "tif", ch))
    return want


# -- reads --------------------------------------------------------------------


def test_fixtures_are_the_listed_cases():
    names = sorted(f[:-4] for f in os.listdir(FIXTURES)
                   if f.endswith(".pnm") and not f.startswith("write_"))
    assert names == READS


@pytest.mark.parametrize("name", READS)
def test_committed_reads(name, tmp_path):
    """Every read fixture: the port's read equals PIL's committed read
    (what the card checks) and the JAX package's reads live."""
    data = mk.read_cases()[name]
    with open(os.path.join(FIXTURES, name + ".pnm"), "rb") as f:
        assert f.read() == data
    want = np.load(os.path.join(FIXTURES, name + ".npy"))
    got = pnm.read_frame(os.path.join(FIXTURES, name + ".pnm"))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert _all_entry_points_match(data, tmp_path)[0] == "ok"


def _kinds():
    """(magic, maxval or scale, size): every kind and maxval at 1x1 and
    13x17; at 257x300 the binary kinds at every maxval, the plain ones
    (slow in both packages) at 100 and 65535."""
    out = []
    for size in ((1, 1), (13, 17), (257, 300)):
        for m in ("P2", "P3", "P5", "P6"):
            for v in (1, 100, 255, 1000, 65535):
                if size[0] < 257 or m in ("P5", "P6") or v in (100, 65535):
                    out.append((m, v, size))
        out += [("P1", None, size), ("P4", None, size), ("Pf", -1.0, size),
                ("Pf", 3.0, size)]
    return out


@pytest.mark.parametrize("kind", _kinds(),
                         ids=lambda k: f"{k[0]}-{k[1]}-{k[2][0]}x{k[2][1]}")
def test_kinds_read_as_jax_reads_them(kind, tmp_path):
    """Each kind at maxvals 1, 100, 255, 1000 and 65535 (binary samples
    above maxval among them: PIL clips them), plain and binary, ``Pf``
    both ways round: the same dtype, shape and values as JAX's reads."""
    magic, maxval, size = kind
    rng = np.random.RandomState(size[0] + int(maxval or 0) % 97)
    data = mk.pnm(magic.encode(), mk.samples(rng, magic.encode(), maxval,
                                             *size), maxval)
    want = _all_entry_points_match(data, tmp_path)
    assert want[0] == "ok" and want[2][:2] == size


def _faults():
    """name -> a file PIL reads with a quirk or refuses."""
    px = bytes(range(6))
    return {
        "binary_short_mapped": b"P5\n3 2\n255\n" + px[:5],
        "binary_short_16bit": b"P5\n3 2\n65535\n" + bytes(10),
        "binary_short_rgb": b"P6\n2 1\n255\n" + bytes(5),
        "binary_short_bits": b"P4\n10 2\n" + bytes(3),
        "binary_short_float": b"Pf\n2 2\n-1.0\n" + bytes(15),
        "scaled_short": b"P5\n3 2\n100\n" + px[:5],
        "scaled_short_cmyk": b"P0CMYK\n2 1\n200\n" + bytes(7),
        "plain_short": b"P2\n3 2\n100\n0 50 100 1 99",
        "plain_above_maxval": b"P2\n3 2\n100\n0 50 100 150 1 99\n",
        "plain_negative": b"P2\n1 1\n255\n-1\n",
        "plain_token_too_long": b"P2\n1 1\n255\n12345678901\n",
        "plain_not_a_number": b"P3\n1 1\n255\n1 2 x\n",
        "plain_bits_bad_token": b"P1\n3 2\n101010 x",
        "plain_bits_no_spaces": b"P1\n3 2\n101\n010",
        "plain_bits_short": b"P1\n3 2\n1 0 1",
        "plain_comment_mid_data": b"P2\n3 1\n9\n1 # two\n2 3\n",
        "plain_no_final_space": b"P2 1 1 255 7",
        "size_zero": b"P5\n0 2\n255\n",
        "size_negative": b"P5\n-3 2\n255\n" + px,
        "size_with_sign_and_underscore": b"P5\n+3 1_0\n255\n" + bytes(30),
        "maxval_zero": b"P5\n3 2\n0\n" + px,
        "maxval_65536": b"P5\n3 2\n65536\n" + px,
        "header_token_too_long": b"P5\n12345678901 2\n255\n",
        "header_ends": b"P5\n3 2\n",
        "header_comment_in_a_token": b"P5\n3#x\n 2\n255\n" + px,
        "header_not_a_number": b"P5\nx 2\n255\n" + px,
        "scale_zero": b"Pf\n1 1\n0\n" + bytes(4),
        "scale_nan": b"Pf\n1 1\nnan\n" + bytes(4),
        "scale_not_a_number": b"Pf\n1 1\nabc\n" + bytes(4),
        "pfm_colour": b"PF\n1 1\n-1.0\n" + bytes(12),
        "pam": b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\0",
        "p8": b"P8\n1 1\n255\n\0",
        "magic_run_on": b"P512 2 255\n" + px,
        "pil_palette": b"PyP\n2 1\n255\n\3\4",
        "pil_cmyk": b"PyCMYK\n1 1\n255\n\1\2\3\4",
    }


@pytest.mark.parametrize("case", sorted(_faults()))
def test_faults_and_quirks_as_pil(case, tmp_path):
    """Data cut short (``ValueError`` where PIL maps the file, ``OSError``
    where it reads it, "not enough image data" where it scales), the
    plain decoder's refusals, the header's, the kinds PIL does not open
    (``OSError``), and the quirks it reads: the same outcome from every
    entry point."""
    _all_entry_points_match(_faults()[case], tmp_path)


# -- writes -------------------------------------------------------------------


@pytest.mark.parametrize("ext", ["pbm", "pgm", "ppm", "pnm", "pfm"])
@pytest.mark.parametrize("shape", [(1, 1), (13, 17), (257, 300),
                                   (13, 17, 3), (13, 17, 4), (13, 17, 2),
                                   (13,), (0, 4)])
def test_imwrite_is_byte_equal_to_jax(shape, ext, tmp_path):
    """``imwrite`` of every dtype ``fromarray`` takes (and some it does
    not) at each shape to each Netpbm name: PIL's file byte for byte, or
    PIL's exception class."""
    rng = np.random.RandomState(len(shape) + shape[0])
    for dt in ("bool", "uint8", "int8", "uint16", ">u2", "int16", "uint32",
               "int32", "float32", "float64", "int64", "float16"):
        x = (rng.rand(*shape) < 0.5 if dt == "bool"
             else (rng.randn(*shape) * 40000).astype(dt))
        pj, pt = str(tmp_path / f"j.{ext}"), str(tmp_path / f"t.{ext}")
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
    """Every write fixture: the port's bytes equal PIL's committed file
    (what the card checks), and it reads back as PIL reads it."""
    x = np.load(os.path.join(FIXTURES, f"write_{name}.npy"))
    path = os.path.join(
        FIXTURES, f"write_{name}.{mk.WRITE_EXTENSIONS.get(name, 'pgm')}")
    with open(path, "rb") as f:
        assert pnm.encode_pnm(x) == f.read()
    got, want = T.imread(path), J.imread(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- the CLI ------------------------------------------------------------------


def _outputs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_cli_on_a_16_bit_pgm_under_a_tiff_name(tmp_path):
    """A 48 x 64 P5 at maxval 65535 under ``.tif`` (PIL reads it as
    ``int32``) through both CLIs: the same files, pages within 1 uint8
    level."""
    rng = np.random.RandomState(16)
    path = tmp_path / "s" / "g.tif"
    path.parent.mkdir()
    path.write_bytes(mk.pnm(b"P5", rng.randint(0, 65536, (48, 64)), 65535))
    assert slides.read_channel(str(path), "tif", 0).dtype == np.int32
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
