"""Autodesk FLI and FLC animations (``unmicst_tpu_torch/io/fli.py``, its
native ``native/flidec.cpp``) against PIL 12.1's ``FliImagePlugin`` and
``FliDecode.c``, which the JAX package reaches through ``Image.open``
and ``seek(channel)`` in its TIFF fallback and its toolbox's ``imread``.

Random files of every chunk type (4, 7, 11, 12, 13, 15, 16, 18 and
unknown ones), cut short or with bytes changed, read as PIL reads them
at every frame (``seek`` replays frames 0 to k), with and without the
native library; the native chunk decoder equals the plain one on the
same feeds; the prefix chunk, a missing frame size, channels past the
last frame and the palette walk's failures reach both packages' entry
points alike; the ``chip_smoke.py`` FLC recipe reads as PIL.
"""

import importlib.util
import io
import os
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch.io import _native, _pil, fli, identify, slides
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "icons_make", os.path.join(REPO, "tests", "fixtures", "torch_icons",
                               "make.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)


def _outcome(fn):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = fn()
        return ("ok", r.dtype.str, r.shape, r.tobytes())
    except OSError:
        return "OSError"
    except Exception as e:  # noqa: BLE001
        return type(e).__name__


def _pil_frame(path: str, k: int):
    """PIL's frame ``k``; ``TypeError`` where PIL opens no FLI (every
    error of FLI's ``_open`` hands the file on)."""
    try:
        im = Image.open(path)
    except Exception:  # noqa: BLE001
        raise TypeError("not FLI") from None
    with im:
        if im.format != "FLI":
            raise TypeError("not FLI")
        im.seek(k)
        return np.asarray(im)


def _port(data: bytes, k: int):
    try:
        fli.open_header(data)
    except _pil.PASS:
        raise TypeError("not FLI") from None
    return fli.read_frame(data, k)


@pytest.mark.parametrize("codecs", ["native", "python"])
@pytest.mark.parametrize("seed", range(4))
def test_random_files_read_as_pil(seed, codecs, tmp_path, monkeypatch):
    """60 random FLI and FLC files a seed (:func:`make.fli_random`) at
    frames 0-3: PIL's array or exception class, where PIL opens the file
    as FLI or hands it on."""
    assert _native.get_lib() is not None, "the native library did not load"
    if codecs == "python":
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    rng = np.random.RandomState(2400 + seed)
    path = str(tmp_path / "a.flc")
    seen = set()
    for _ in range(60):
        data = mk.fli_random(rng)
        with open(path, "wb") as f:
            f.write(data)
        for k in range(4):
            want = _outcome(lambda: _pil_frame(path, k))
            got = _outcome(lambda: _port(data, k))
            assert got == want, (data.hex(), k)
            seen.add(want if isinstance(want, str) else "ok")
    assert {"ok", "OSError", "EOFError"} <= seen, seen


def test_native_decoder_equals_plain():
    """``native/flidec.cpp`` against :func:`fli.decode_py` on the frames
    of 300 random files, each fed whole and cut short: the same result
    and the same image."""
    assert _native.get_lib() is not None, "the native library did not load"
    rng = np.random.RandomState(24)
    results = set()
    for _ in range(300):
        data = mk.fli_random(rng)
        w, h = struct.unpack_from("<HH", data, 8)
        if not (w and h):
            continue
        start = rng.randint(0, 2) * rng.randint(0, 64)
        img = rng.randint(0, 256, (h, w)).astype(np.uint8)
        for feed in (data[128 + start :], data[128 + start : -5]):
            a, b = img.copy(), img.copy()
            got = _native.fli_decode(feed, a)
            want = fli.decode_py(feed, b)
            assert got == want and np.array_equal(a, b), feed.hex()
            results.add(want)
    assert {fli.END, fli.OVERRUN, fli.UNKNOWN} <= results, results


def _frames(w: int, h: int, rng):
    img = rng.randint(0, 256, (h, w)).astype(np.uint8)
    return [mk.fli_frame([mk.fli_sub(15, mk.brun(img.copy(), rng))]),
            mk.fli_frame([mk.fli_sub(7, mk.ss2(h, w, rng))]),
            mk.fli_frame([mk.fli_sub(12, mk.lc(h, w, rng))])]


@pytest.mark.parametrize("magic", [0xAF11, 0xAF12])
def test_entry_points_at_every_channel(magic, tmp_path):
    """A three-frame file (BRUN, SS2, LC) under its own name through both
    toolboxes' ``imread`` (frame 0), and under a TIFF name through both
    ``read_channel``s at channels 0-4 (frames 0-2, then ``IndexError``
    past the last); the header's frame count and the frames the file
    holds disagree both ways."""
    rng = np.random.RandomState(magic)
    frames = _frames(10, 7, rng)
    for count, held in ((3, 3), (5, 3), (2, 3)):
        data = mk.fli_header(10, 7, count, magic) + b"".join(frames[:held])
        raw, tif = tmp_path / "a.fli", tmp_path / "a.tif"
        raw.write_bytes(data)
        tif.write_bytes(data)
        assert _outcome(lambda: T.imread(str(raw))) == \
            _outcome(lambda: J.imread(str(raw)))
        for ch in range(5):
            got = _outcome(lambda: slides.read_channel(str(tif), "tif", ch))
            assert got == _outcome(lambda: jax_slides.read_channel(
                str(tif), "tif", ch)), (count, ch)
            if ch >= min(count, held) and count <= held:
                assert got == "IndexError"


def test_prefix_chunk_and_palettes_as_pil(tmp_path):
    """A prefix chunk (``0xF100``) before frame 0: PIL skips it for the
    palette walk but decodes it as frame 0, and refuses it; colour
    chunks (4: 8-bit, 11: 6-bit) whose parse fails hand the file on."""
    rng = np.random.RandomState(11)
    frames = _frames(6, 5, rng)
    good = mk.fli_sub(4, mk.fli_palette(rng))
    cases = {
        "prefix": mk.fli_header(6, 5, 2) + mk.fli_sub(0xF100, bytes(10))
        + frames[0] + frames[1],
        "prefix_palette": mk.fli_header(6, 5, 1) + mk.fli_sub(
            0xF100, bytes(10)) + mk.fli_frame([good]),
        "palette_past_256": mk.fli_header(6, 5, 1) + mk.fli_frame(
            [mk.fli_sub(11, b"\x01\x00\xff\x03" + bytes(9))]),
        "palette_partial": mk.fli_header(6, 5, 1) + mk.fli_frame(
            [mk.fli_sub(4, b"\x01\x00\x00\x02\x01\x02\x03\x04")]),
        "palette_cut": mk.fli_header(6, 5, 1) + mk.fli_frame(
            [mk.fli_sub(4, b"\x01")])[:-1],
        "no_frame_size": mk.fli_header(6, 5, 1),
        "frames_zero": mk.fli_header(6, 5, 0) + frames[0],
    }
    for name, data in cases.items():
        path = tmp_path / f"{name}.flc"
        path.write_bytes(data)
        for k in (None, 0, 1):
            want = _outcome(lambda: _pil_seek(str(path), k))
            got = _outcome(lambda: identify.read(data, k, name))
            if got == "AttributeError":  # None: no plugin opens it
                got = "OSError"
            assert got == want, (name, k)


def _pil_seek(path: str, k):
    with Image.open(path) as im:
        if k is not None:
            im.seek(k)
        return np.asarray(im)


def test_slide_recipe_reads_as_pil():
    """The FLC of ``chip_smoke.py`` at 512^2: frame 0 (BRUN) and frame 1
    (SS2) as PIL reads them, and frame 1 differs from frame 0 where the
    SS2 chunk writes."""
    data, seeks = mk.slide_files(side=512)["flc.tif"]
    got = [identify.read(data, k, "flc") for k in seeks]
    for k, px in zip(seeks, got):
        im = Image.open(io.BytesIO(data))
        im.seek(k)
        assert np.array_equal(px, np.asarray(im)), k
    changed = np.argwhere(got[0] != got[1])
    assert changed[:, 1].min() >= 0 and changed[:, 1].max() < 392
