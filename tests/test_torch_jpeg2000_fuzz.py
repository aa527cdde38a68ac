"""Seeded fuzz of JPEG 2000 read (``unmicst_tpu_torch/io/jpeg2000.py``)
over PIL's save options: images of every mode PIL writes (L, LA, RGB,
RGBA, I;16) at small sizes, saved with drawn tiles and offsets,
resolutions, code-block and precinct sizes, quality layers, progression
orders, the component transform, signed samples, PLT markers, comments,
as J2K or JP2, reversible (5/3) and irreversible (9/7); each read by the
port with the native library and without it must be the array the JAX
toolbox's ``imread`` gives through PIL (0 levels, same dtype and shape),
and so must ``read_channel`` of it under a TIFF name.

The options are drawn only where openjpeg's encoder takes them (every
tile, clipped to the image, at least ``2^(resolutions - 1)`` and 2
samples on a side; an image offset only with tiles that start at or
before it): after a refused save PIL's encoder can corrupt its process.
"""

import io
import os
import tempfile
import warnings

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch.io import _native, slides
from unmicst_tpu_torch.utils import imtools as T

_SETTINGS = settings(derandomize=True, deadline=None, max_examples=150,
                     database=None, suppress_health_check=list(HealthCheck))
_DIR = tempfile.mkdtemp(prefix="unmicst-j2k-fuzz-")
_BANDS = {"L": 0, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": 0}


def _tiles(h, w, kw):
    """The tiles of an ``h`` x ``w`` image under ``kw``, clipped to it."""
    ox, oy = kw.get("offset", (0, 0))
    x1, y1 = ox + w, oy + h
    tw, th = kw.get("tile_size", (x1, y1))
    tx0, ty0 = kw.get("tile_offset", (0, 0))
    out = []
    for q in range(-(-(y1 - ty0) // th)):
        for p in range(-(-(x1 - tx0) // tw)):
            out.append((max(tx0 + p * tw, ox), max(ty0 + q * th, oy),
                        min(tx0 + (p + 1) * tw, x1),
                        min(ty0 + (q + 1) * th, y1)))
    return out


@st.composite
def _saves(draw, irreversible: bool):
    """``(array, save options)`` of a file PIL's encoder writes."""
    mode = draw(st.sampled_from(sorted(_BANDS)))
    h, w = draw(st.integers(1, 24)), draw(st.integers(1, 24))
    rng = np.random.RandomState(draw(st.integers(0, 2**16)))
    bands = _BANDS[mode]
    shape = (h, w, bands) if bands else (h, w)
    if mode == "I;16":
        x = rng.randint(0, 65536, shape).astype(np.uint16)
    else:
        x = rng.randint(0, 256, shape).astype(np.uint8)
    if draw(st.booleans()):  # smooth: long runs of bit-planes
        x = (np.cumsum(x.astype(np.int64), 0) // np.arange(
            1, h + 1).reshape((h,) + (1,) * (x.ndim - 1))).astype(x.dtype)
    kw = {"irreversible": irreversible}
    if draw(st.booleans()):
        kw["tile_size"] = (draw(st.integers(4, 24)), draw(st.integers(4, 24)))
        if draw(st.booleans()):
            ox, oy = draw(st.integers(0, 8)), draw(st.integers(0, 8))
            kw["offset"] = (ox, oy)
            tw, th = kw["tile_size"]
            kw["tile_offset"] = (draw(st.integers(max(0, ox - tw + 1), ox)),
                                 draw(st.integers(max(0, oy - th + 1), oy)))
    side = min(min(x1 - x0, y1 - y0) for x0, y0, x1, y1 in
               _tiles(h, w, kw))
    top = 1
    while top < 6 and 1 << top <= side:
        top += 1
    if "tile_size" in kw or draw(st.booleans()):
        kw["num_resolutions"] = draw(st.integers(1, top))
    if draw(st.booleans()):
        kw["codeblock_size"] = (2 ** draw(st.integers(2, 6)),
                                2 ** draw(st.integers(2, 6)))
    if draw(st.booleans()):
        kw["precinct_size"] = (2 ** draw(st.integers(4, 7)),
                               2 ** draw(st.integers(4, 7)))
    if draw(st.booleans()):
        kw["quality_layers"] = sorted(draw(st.lists(
            st.sampled_from([80, 40, 20, 10, 5]), min_size=1, max_size=3,
            unique=True)), reverse=True)
    kw["progression"] = draw(st.sampled_from(["LRCP", "RLCP", "RPCL",
                                              "PCRL", "CPRL"]))
    if bands >= 3:
        kw["mct"] = draw(st.integers(0, 1))
    for key in ("signed", "plt", "no_jp2"):
        if draw(st.booleans()):
            kw[key] = True
    if draw(st.booleans()):
        kw["comment"] = "unmicst"
    if "tile_size" in kw and min(
            min(x1 - x0, y1 - y0) for x0, y0, x1, y1 in _tiles(h, w, kw)) < \
            max(2, 1 << (kw["num_resolutions"] - 1)):
        kw.pop("offset", None)
        kw.pop("tile_offset", None)
        kw["num_resolutions"] = 1
    return x, kw


def _outcome(fn):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = fn()
        return ("ok", r.dtype, r.shape, r.tobytes())
    except OSError:
        return "OSError"
    except Exception as e:  # noqa: BLE001
        return type(e).__name__


@pytest.mark.parametrize("codecs", ["native", "python"])
@pytest.mark.parametrize("irreversible", [False, True],
                         ids=["5-3", "9-7"])
def test_pil_saves_read_as_pil(irreversible, codecs, monkeypatch):
    """Each drawn save: the port's ``imread`` of the file (its own
    name) is JAX's, 0 levels; under a TIFF name ``read_channel`` of
    channel 0 is JAX's, channel 1 ``IndexError`` in both.  Files openjpeg
    refuses to read (its precinct sizes of 0 at the lowest resolutions)
    raise ``OSError`` in both.  Most examples read."""
    assert _native.get_lib() is not None
    if codecs == "python":
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    read = []

    @_SETTINGS
    @given(_saves(irreversible))
    def check(case):
        x, kw = case
        buf = io.BytesIO()
        Image.fromarray(x).save(buf, "JPEG2000", **kw)
        data = buf.getvalue()
        path = os.path.join(_DIR, f"{os.getpid()}.jp2")
        tif = os.path.join(_DIR, f"{os.getpid()}.tif")
        for p in (path, tif):
            with open(p, "wb") as f:
                f.write(data)
        want = _outcome(lambda: J.imread(path))
        assert _outcome(lambda: T.imread(path)) == want, kw
        read.append(want[0] == "ok")
        if want[0] == "ok":
            got = slides.read_channel(tif, "tif", 0)
            ref = jax_slides.read_channel(tif, "tif", 0)
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)
            for fn in (slides.read_channel, jax_slides.read_channel):
                with pytest.raises(IndexError):
                    fn(tif, "tif", 1)

    check()
    assert sum(read) >= 0.75 * len(read), (sum(read), len(read))
