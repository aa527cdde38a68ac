"""The toolbox's ICO and ICNS writes (``unmicst_tpu_torch/io/ico.py``
``write_ico``, ``io/icns.py`` ``write_icns``), against the JAX toolbox's
``imwrite`` (``unmicst_tpu/utils/imtools.py:60-66``, PIL 12's
``IcoImagePlugin._save`` and ``IcnsImagePlugin._save``) for every array
of ``tests/test_torch_write_formats.py``'s ``_arrays``: the port's PNG
entries are its own deflate, so every byte outside them is held to PIL's
(with the lengths and offsets that depend on them consistent with the
port's streams), each entry's signature and IHDR to PIL's, and each
entry's pixels to PIL's, 0 levels apart; where PIL raises, its class and
message, and the file left as PIL leaves it.  Also ICNS's JPEG 2000
entries of palette and 16-bit images, read as PIL's RGBA, the in-memory
PNG encoder."""

import importlib.util
import io
import os
import warnings

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_write_formats import _arrays
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch.io import icns, png
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"{name}_make", os.path.join(FIXTURES, name, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


mk = _load("torch_write25")
jk = _load("torch_j2k")
ik = _load("torch_icons")
NAMES = sorted(_arrays(0))


def _pil_read(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _write_both(x, name: str, tmp_path, before: bytes = None):
    """Both toolboxes' ``imwrite(x, "<dir>/<name>")``: for each, the
    file's bytes or ``(exception, the file's bytes or None)``; where
    ``before`` is given, the file holds it before the write."""
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


def _assert_icon_as_pil(want, got, ext: str, what) -> int:
    """The rules of the module docstring; returns the entry count."""
    if isinstance(want, tuple) or isinstance(got, tuple):
        assert isinstance(want, tuple) and isinstance(got, tuple), \
            (what, want, got)
        assert type(got[0]) is type(want[0]), (what, want, got)
        assert str(got[0]) == str(want[0]) and got[1] == want[1], what
        return -1
    skel_w, streams_w = mk.split(want, ext)
    skel_g, streams_g = mk.split(got, ext)  # lengths and offsets consistent
    assert skel_g == skel_w, what
    seen = set()  # ICNS repeats its 256^2 and 512^2 streams
    for k, (a, b) in enumerate(zip(streams_w, streams_g)):
        if (a, b) in seen:
            continue
        seen.add((a, b))
        pa, pb = _pil_read(a), _pil_read(b)
        assert pb.dtype == pa.dtype and np.array_equal(pb, pa), (what, k)
        port = png.decode_png(b, "entry")
        assert mk.digest(port) == mk.digest(pa), (what, k)
    return len(streams_g)


ICO_SHAPES = ((9, 14), (15, 200), (16, 16), (40, 300), (300, 40),
              (257, 260))


@pytest.mark.parametrize("name", NAMES)
def test_ico_write_is_jax_s(name, tmp_path):
    """``imwrite`` to ``.ico`` of each array at square, non-square and
    under-16 sizes (no entry), and of its empty form."""
    counts = []
    for i, (h, w) in enumerate(ICO_SHAPES):
        x = _arrays(i, h, w)[name]
        want, got = _write_both(x, "w.ico", tmp_path)
        counts.append(_assert_icon_as_pil(want, got, ".ico", (h, w)))
    want, got = _write_both(_arrays(0)[name][:0], "w.ico", tmp_path)
    _assert_icon_as_pil(want, got, ".ico", "empty")
    if name not in ("int64", "rgb16", "float32", "float64"):
        assert counts[:4] == [0, 0, 1, 3], counts


@pytest.mark.parametrize("name", NAMES)
def test_icns_write_is_jax_s(name, tmp_path):
    """``imwrite`` to ``.icns`` of each array (one 1024^2 file a mode:
    eight entries from six resizes, ``ic07`` ... ``ic14``), and of its
    empty form."""
    x = _arrays(7, 23, 37)[name]
    want, got = _write_both(x, "w.icns", tmp_path)
    n = _assert_icon_as_pil(want, got, ".icns", name)
    assert n in (-1, 8)
    want, got = _write_both(x[:0], "w.icns", tmp_path)
    _assert_icon_as_pil(want, got, ".icns", "empty")


@pytest.mark.parametrize("ext", [".ico", ".icns"])
def test_failed_writes_leave_the_file_as_pil(ext, tmp_path):
    """Mode ``F`` (no PNG for it): PIL's ``OSError`` and message, a new
    file removed, an existing one left with what the save wrote before
    the error; a dtype ``fromarray`` refuses: its ``TypeError``, before
    the file opens."""
    x = _arrays(2, 20, 20)["float32"]
    for before in (None, b"old contents here"):
        want, got = _write_both(x, f"f{ext}", tmp_path, before)
        assert isinstance(want[0], OSError) and want[0].args == (
            "cannot write mode F as PNG",)
        _assert_icon_as_pil(want, got, ext, before)
    want, got = _write_both(_arrays(2)["int64"], f"t{ext}", tmp_path,
                            b"kept")
    assert type(want[0]) is type(got[0]) is TypeError
    assert got[1] == want[1] == b"kept"


def test_encode_png_is_write_png_s(tmp_path):
    """The in-memory encoder ICO and ICNS embed: ``write_png``'s bytes."""
    for name, x in _arrays(3).items():
        path = tmp_path / "p.png"
        try:
            png.write_png(str(path), x)
        except Exception as e:  # noqa: BLE001
            with pytest.raises(type(e)):
                png.encode_png(x)
            continue
        assert png.encode_png(x) == path.read_bytes(), name


def _palette_icns(rng, entries, depths, la: bool) -> bytes:
    idx = rng.randint(0, 256, (16, 16)).astype(np.uint8)
    buf = io.BytesIO()
    if la:
        a = rng.randint(0, 256, (16, 16)).astype(np.uint8)
        Image.fromarray(np.stack([idx, a], -1), "LA").save(
            buf, "JPEG2000", no_jp2=True)
        header = jk.ihdr(16, 16, 2, 7)
    else:
        Image.fromarray(idx, "L").save(buf, "JPEG2000", no_jp2=True)
        header = jk.ihdr(16, 16, 1, 7)
    data = jk.jp2(buf.getvalue(), header + jk.colr(16)
                  + jk.pclr(entries, depths) + jk.cmap(len(depths)))
    return ik.icns([(b"icp4", data)])


def _outcome(fn):
    try:
        r = fn()
        return ("ok", r.dtype.str, r.shape, r.tobytes())
    except Exception as e:  # noqa: BLE001
        return type(e).__name__


@pytest.mark.parametrize("components", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("alpha", [False, True])
def test_icns_palette_jpeg2000_entries_read_as_pil(components, alpha):
    """An ``icp4`` JP2 of an 8-bit index plane (``P``) or index and alpha
    (``PA``) with a ``pclr`` palette of ``components`` columns (RGB and
    RGBA tables, and the short and long ones ``getcolor`` shifts), of 1
    to 300 entries: PIL's RGBA, or its exception class."""
    rng = np.random.RandomState(components * 2 + alpha)
    for n in (1, 5, 40, 200, 300):
        top = int(rng.choice([2, 4, 256]))
        entries = [tuple(v) for v in rng.randint(0, top, (n, components))]
        data = _palette_icns(rng, entries, [7] * components, alpha)
        want = _outcome(lambda: _pil_read(data))
        assert _outcome(lambda: icns.read_frame(data)) == want, n


@pytest.mark.parametrize("jp2", [False, True])
def test_icns_16_bit_jpeg2000_entries_read_as_pil(jp2):
    """An ``icp5`` JPEG 2000 entry of a 16-bit plane (``I;16``), as PIL's
    encoder writes it: PIL's RGBA (each value clipped to 255)."""
    rng = np.random.RandomState(int(jp2))
    for top in (200, 600, 65536):
        x = rng.randint(0, top, (32, 32)).astype(np.uint16)
        buf = io.BytesIO()
        Image.fromarray(x).save(buf, "JPEG2000", no_jp2=not jp2)
        data = ik.icns([(b"icp5", buf.getvalue())])
        want = _outcome(lambda: _pil_read(data))
        assert want[0] == "ok"
        assert _outcome(lambda: icns.read_frame(data)) == want, top
