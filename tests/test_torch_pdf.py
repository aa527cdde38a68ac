"""The toolbox's PDF write (``unmicst_tpu_torch/io/pdf.py``) and the
Group 4 encoder under its mode ``1`` pages (``io/ccitt.py``
``encode_g4``, ``g4_tiff``; ``native/tiffcodec.cpp``
``unmicst_g4_encode``), against the JAX toolbox's ``imwrite``
(``unmicst_tpu/utils/imtools.py:60-66``, PIL 12's ``PdfImagePlugin``
with libtiff's ``group4`` save): with ``time.gmtime`` fixed in both, the
port's file is PIL's byte for byte for every array of
``tests/test_torch_write_formats.py``'s ``_arrays`` and its empty form,
or both raise the same exception class and message and leave the file
alike; ``LA`` and ``RGBA``, which PIL writes through its JPEG 2000
encoder, raise ``NotImplementedError`` naming ROADMAP M17.  The G4 strip
and its TIFF are libtiff's bytes, native and Python alike, and decode
back through the port's CCITT decoder to the input.  Also the recipe of
``tests/fixtures/torch_write25`` whose PIL digests ``chip_smoke.py``
checks on the card."""

import importlib.util
import io
import json
import math
import os
import re
import time
import warnings

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_write_formats import _arrays
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch.io import _native, ccitt, png
from unmicst_tpu_torch.utils import imtools as T

NAMES = sorted(_arrays(0))
FIXED = time.struct_time((2024, 3, 5, 7, 8, 9, 1, 65, 0))
WRITE25 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "torch_write25")
_spec = importlib.util.spec_from_file_location(
    "write25_make", os.path.join(WRITE25, "make.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)


@pytest.fixture
def fixed_gmtime(monkeypatch):
    """Both packages' PDFs dated :data:`FIXED` (``PdfImagePlugin`` and
    ``io/pdf.py`` call ``time.gmtime()`` through the module)."""
    monkeypatch.setattr(time, "gmtime", lambda *a: FIXED)


def _write_both(x, name: str, tmp_path, before: bytes = None):
    """Both toolboxes' ``imwrite(x, "<dir>/<name>")``: for each, the
    file's bytes or ``(exception, the file's bytes or None)``."""
    out = []
    for pkg, sub in ((J, "jax"), (T, "port")):
        d = tmp_path / sub
        d.mkdir(exist_ok=True)
        path = d / name
        if before is not None:
            path.write_bytes(before)
        elif path.exists():
            path.unlink()
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                pkg.imwrite(x, str(path))
            out.append(path.read_bytes())
        except Exception as e:  # noqa: BLE001
            out.append((e, path.read_bytes() if path.exists() else None))
    return out


def _assert_as_pil(want, got, what):
    if isinstance(want, tuple) or isinstance(got, tuple):
        assert isinstance(want, tuple) and isinstance(got, tuple), \
            (what, want, got)
        assert type(got[0]) is type(want[0]), (what, want, got)
        assert str(got[0]) == str(want[0]) and got[1] == want[1], what
    else:
        assert got == want, what


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_pdf_write_is_jax_s(name, seed, tmp_path, fixed_gmtime):
    """Every mode ``fromarray`` gives, at odd sizes and empty: PIL's file
    byte for byte (``1`` through Group 4, ``L`` and ``RGB`` through
    JPEG), or its exception; ``LA`` and ``RGBA`` refused naming M17
    after the bytes PIL writes before the image, the new file removed."""
    x = _arrays(seed, 9 + 7 * seed, 14 + 45 * seed)[name]
    for arr in (x, x[:0]):
        want, got = _write_both(arr, "w.pdf", tmp_path)
        if name in ("la", "rgba") and arr.size:
            assert isinstance(want, bytes)  # PIL writes JPXDecode
            assert isinstance(got[0], NotImplementedError)
            assert "M17" in str(got[0]) and got[1] is None
            continue
        _assert_as_pil(want, got, (name, arr.shape))


@pytest.mark.parametrize("name", ["la", "rgba"])
def test_pdf_of_la_and_rgba_waits_for_the_jpeg2000_encoder(name, tmp_path):
    """``imwrite`` of an LA or RGBA image to ``.pdf`` raises
    ``NotImplementedError`` naming ROADMAP M17 (PIL's JPXDecode stream
    needs the JPEG 2000 encoder); a dtype ``fromarray`` refuses raises
    its ``TypeError`` first."""
    with pytest.raises(NotImplementedError, match="M17"):
        T.imwrite(_arrays(4)[name], str(tmp_path / "q.pdf"))
    assert not (tmp_path / "q.pdf").exists()
    with pytest.raises(TypeError):
        T.imwrite(_arrays(4)["int64"], str(tmp_path / "q.pdf"))


@pytest.mark.parametrize("fname", ["a(b)c\\d.pdf", "é字)(.pdf",
                                   "x.y.pdf", "na me.PDF", ".pdf"])
def test_pdf_title_is_pils(fname, tmp_path, fixed_gmtime):
    """The ``/Info`` title (the base name less its extension, a PDF
    string escaped or UTF-16, none where it is empty) as PIL writes it."""
    x = _arrays(5)["uint8"]
    want, got = _write_both(x, fname, tmp_path)
    _assert_as_pil(want, got, fname)


def test_failed_pdf_writes_leave_the_file_as_pil(tmp_path, fixed_gmtime):
    """``I;16``, ``I`` and ``F`` images: PIL's ``ValueError`` after the
    header and catalog, an existing file left holding them, a new one
    removed."""
    for name in ("uint16", "int32", "float32"):
        for before in (None, b"old contents here"):
            want, got = _write_both(_arrays(6)[name], "e.pdf", tmp_path,
                                    before)
            assert isinstance(want[0], ValueError), want
            _assert_as_pil(want, got, (name, before))


def test_pdf_date_is_the_time_of_writing(tmp_path):
    """Unpatched, both dates are ``time.gmtime()``'s at the write, in
    PIL's ``D:YYYYMMDDHHMMSSZ`` form."""
    t0 = time.gmtime()
    T.imwrite(_arrays(1)["uint8"], str(tmp_path / "d.pdf"))
    t1 = time.gmtime()
    data = (tmp_path / "d.pdf").read_bytes()
    stamps = re.findall(rb"/(?:CreationDate|ModDate) \(D:(\d{14})Z\)", data)
    lo, hi = (time.strftime("%Y%m%d%H%M%S", t).encode() for t in (t0, t1))
    assert len(stamps) == 2 and all(lo <= s <= hi for s in stamps), stamps


def _bilevel(kind: int, rng, h: int, w: int) -> np.ndarray:
    """Noise, rows of long runs (past 2560, 2624 and 64-multiples where
    wide), vertical stripes with flips, or a uniform plane."""
    if kind == 0:
        return rng.rand(h, w) < rng.rand()
    if kind == 1:
        x = np.zeros((h, w), bool)
        for r in range(h):
            cuts = np.sort(rng.randint(0, w + 1, rng.randint(0, 6)))
            v, p = bool(rng.randint(2)), 0
            for c in list(cuts) + [w]:
                x[r, p:c] = v
                v, p = not v, c
        return x
    if kind == 2:
        x = np.repeat(rng.rand(1, w) < 0.5, h, 0)
        x[rng.rand(h, w) < 0.05] ^= True
        return x
    return np.full((h, w), bool(rng.randint(2)))


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_g4_tiff_is_libtiff_s(kind):
    """``g4_tiff`` against PIL's libtiff save (``compression="group4"``,
    one strip) byte for byte, at widths 1 to 3000 around byte and run
    edges; the strip native and Python alike; decoded back to the input
    by ``ccitt.decode``."""
    rng = np.random.RandomState(kind)
    widths = [1, 2, 3, 7, 8, 9, 15, 16, 17, 63, 64, 65, 2560, 2624, 2689,
              int(rng.randint(1, 300)), int(rng.randint(1, 3000))]
    for w in widths:
        h = int(rng.randint(1, 40))
        x = _bilevel(kind, rng, h, w)
        buf = io.BytesIO()
        Image.fromarray(x).save(buf, "TIFF", compression="group4",
                                strip_size=math.ceil(w / 8) * h)
        assert ccitt.g4_tiff(x) == buf.getvalue(), (h, w)
        rows = np.packbits(x.astype(np.uint8), axis=1)
        strip = _native.g4_encode(rows, w)
        assert strip == ccitt.encode_g4_py(rows, w), (h, w)
        back = np.unpackbits(ccitt.decode(strip, w, h, 4), axis=1)[:, :w]
        assert np.array_equal(back, x), (h, w)


@pytest.mark.parametrize("shape", [(1, 65535), (2, 65536), (65536, 1)])
def test_g4_tiff_tags_at_the_16_bit_edge(shape):
    """A side past 65535 goes into its tag as a LONG, as libtiff writes
    it: PIL's TIFF byte for byte."""
    x = np.random.RandomState(shape[0]).rand(*shape) < 0.5
    h, w = shape
    buf = io.BytesIO()
    Image.fromarray(x).save(buf, "TIFF", compression="group4",
                            strip_size=math.ceil(w / 8) * h)
    assert ccitt.g4_tiff(x) == buf.getvalue()


def test_g4_of_a_slide_round_trips():
    """A 1024^2 plane of blobs and noise: the native strip decodes back
    to it, and the Python encoder gives the same bytes."""
    rng = np.random.RandomState(9)
    x = np.zeros((1024, 1024), bool)
    for _ in range(200):
        r, c, rad = rng.randint(0, 1024), rng.randint(0, 1024), \
            rng.randint(3, 40)
        x[max(0, r - rad) : r + rad, max(0, c - rad) : c + rad] ^= True
    x[rng.rand(1024, 1024) < 0.01] ^= True
    rows = np.packbits(x.astype(np.uint8), axis=1)
    strip = ccitt.encode_g4(rows, 1024)
    back = np.unpackbits(ccitt.decode(strip, 1024, 1024, 4), axis=1)
    assert np.array_equal(back, x)
    assert ccitt.encode_g4_py(rows, 1024) == strip


def _pil_read(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def test_write25_recipe_hashes_as_pil(tmp_path):
    """``tests/fixtures/torch_write25/make.py``'s planes at 512^2 (the
    recipe the card writes at 4096^2, dated ``make.FIXED_DATE``): each
    file's record from the port (ICO and ICNS entries read by the port's
    PNG decoder) equals the one from PIL, or both refuse alike (the RGBA
    PDF naming M17 in the port); ``writes.json`` names every plane and
    extension."""
    assert time.struct_time(mk.FIXED_DATE) == FIXED
    ref = json.load(open(os.path.join(WRITE25, "writes.json")))
    planes = mk.planes(side=512)
    assert sorted(ref) == sorted(n + e for n in planes for e in mk.EXTS)
    for name, x in planes.items():
        for ext in mk.EXTS:
            if ext == ".icns" and name != "uint8":
                continue  # every mode's ICNS: test_torch_icon_writes
            with mk.fixed_gmtime():
                want, got = _write_both(x, name + ext, tmp_path)
            if name == "rgba" and ext == ".pdf":
                assert isinstance(got[0], NotImplementedError)
                continue
            if isinstance(want, tuple):
                assert f"{type(got[0]).__name__}: {got[0]}" == \
                    f"{type(want[0]).__name__}: {want[0]}" == \
                    ref[name + ext]["error"]
                continue
            assert mk.record(got, ext, lambda b: png.decode_png(
                b, "entry")) == mk.record(want, ext, _pil_read), (name, ext)
