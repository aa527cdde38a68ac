"""RGB and RGBA GIF writes (``unmicst_tpu_torch/io/gif.py`` through
``io/quant.py``'s ports of Pillow's median cut and fast octree) against
the JAX package, which writes them through PIL: the toolbox's
``imwrite`` (``unmicst_tpu/utils/imtools.py:59-66``; ``GifImagePlugin.
_normalize_mode`` quantizes an RGB image by median cut and an RGBA one by
fast octree) byte for byte, the quantizers against ``Image.quantize``,
the native quantizers (``native/quant.cpp``) against their plain numpy
versions, and an RGB GIF under a TIFF name read as the JAX fallback reads
it."""

import io
import os

import numpy as np
import pytest
from PIL import Image

from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch.io import _native, gif, quant, slides
from unmicst_tpu_torch.utils import imtools as T


def _gradient(h, w, seed):
    """Smooth colours with seeded noise: more than 65 536 distinct ones
    from 257 x 257 on."""
    y, x = np.mgrid[:h, :w]
    rng = np.random.RandomState(seed)
    b = (x // 2 + y // 3 + rng.randint(0, 3, (h, w))) % 256
    return np.stack([x % 256, y % 256, b], -1).astype(np.uint8)


def _rgb(kind, seed, h=None, w=None):
    rng = np.random.RandomState(seed)
    h = h or int(rng.randint(1, 70))
    w = w or int(rng.randint(1, 70))
    if kind == "noise":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "few":  # 256 colours or fewer
        pal = rng.randint(0, 256, (int(rng.randint(1, 257)), 3))
        return pal[rng.randint(0, len(pal), (h, w))].astype(np.uint8)
    if kind == "levels":  # few levels a channel: ties in every split
        return (rng.randint(0, 5, (h, w, 3)) * int(rng.randint(1, 60))
                ).astype(np.uint8)
    if kind == "gray":  # r == g == b
        return np.repeat(rng.randint(0, 256, (h, w, 1)), 3, 2).astype(
            np.uint8)
    return _gradient(h, w, seed)


def _rgba(kind, seed, h=None, w=None):
    rng = np.random.RandomState(100 + seed)
    x = _rgb("noise" if seed % 2 else "levels", seed, h, w)
    a = rng.randint(0, 256, x.shape[:2] + (1,))
    if kind == "clear":
        a[:] = 0
    elif kind == "mixed":
        a = np.where(rng.rand(*a.shape) < 0.3, 0, 255)
    elif kind == "opaque":
        a[:] = 255
    return np.concatenate([x, a.astype(np.uint8)], -1)


KINDS = ("noise", "few", "levels", "gray", "gradient")


@pytest.mark.parametrize("seed", range(10))
def test_native_median_cut_matches_plain(seed):
    """``native/quant.cpp``'s median cut against ``median_cut_py``: the
    same indices and palette."""
    img = _rgb(KINDS[seed % len(KINDS)], seed)
    px = quant.pixels(img)
    got, want = quant.median_cut(px), quant.median_cut_py(px)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_native_median_cut_matches_plain_past_65536_colours():
    """More than 65 536 colours: the hash table coarsens, in both."""
    img = _gradient(257, 260, 1)
    assert len(np.unique(img.reshape(-1, 3), axis=0)) > 65536
    px = quant.pixels(img)
    got, want = quant.median_cut(px), quant.median_cut_py(px)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", range(8))
def test_native_octree_matches_plain(seed):
    """``native/quant.cpp``'s fast octree against ``octree_py``, RGBA
    (clear, mixed and drawn alpha) and RGB cube levels."""
    img = _rgba(("clear", "mixed", "drawn", "opaque")[seed % 4], seed)
    for px, alpha in ((quant.pixels(img), True),
                      (quant.pixels(img[..., :3]), False)):
        got, want = quant.octree(px, with_alpha=alpha), quant.octree_py(
            px, with_alpha=alpha)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", range(10))
def test_median_cut_is_pils(seed):
    """The median cut's indices and palette are ``Image.quantize``'s."""
    img = _rgb(KINDS[seed % len(KINDS)], seed)
    q = Image.fromarray(img).quantize(256)
    idx, pal = quant.median_cut(quant.pixels(img))
    np.testing.assert_array_equal(idx.reshape(img.shape[:2]), np.asarray(q))
    assert pal.tobytes() == bytes(q.getpalette())


@pytest.mark.parametrize("h,w", [(300, 300), (257, 257)])
def test_median_cut_is_pils_past_65536_colours(h, w):
    """Random colours and a gradient, each over 65 536 distinct."""
    img = (np.random.RandomState(h).randint(0, 256, (h, w, 3)).astype(
        np.uint8) if h == 300 else _gradient(h, w, 2))
    q = Image.fromarray(img).quantize(256)
    idx, pal = quant.median_cut(quant.pixels(img))
    np.testing.assert_array_equal(idx.reshape(h, w), np.asarray(q))
    assert pal.tobytes() == bytes(q.getpalette())


@pytest.mark.parametrize("seed", range(8))
def test_octree_is_pils(seed):
    """The fast octree's indices and RGBA palette are ``Image.quantize``'s
    (all transparent, mixed, drawn and opaque alpha)."""
    img = _rgba(("clear", "mixed", "drawn", "opaque")[seed % 4], seed)
    q = Image.fromarray(img).quantize(256)
    idx, pal = quant.octree(quant.pixels(img))
    np.testing.assert_array_equal(idx.reshape(img.shape[:2]), np.asarray(q))
    assert pal.tobytes() == bytes(q.getpalette("RGBA"))


def _both_gifs(x, tmp_path):
    a, b = str(tmp_path / "j.gif"), str(tmp_path / "t.gif")
    J.imwrite(x, a)
    T.imwrite(x, b)
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read(), g.read()


@pytest.mark.parametrize("case", [
    "noise", "few", "levels", "gray", "gradient", "one_colour", "narrow",
    "many_colours", "large"])
def test_imwrite_rgb_gif_is_byte_equal_to_jax(case, tmp_path):
    """``imwrite(x, "x.gif")`` of RGB images: 256 colours or fewer, more
    than 65 536, one colour, under 16 pixels a side (not interlaced), and
    512 x 512 and more (Pillow keeps the whole palette)."""
    sizes = {"one_colour": (20, 30), "narrow": (40, 9),
             "many_colours": (257, 257), "large": (512, 520)}
    h, w = sizes.get(case, (33, 47))
    kind = {"one_colour": "few", "narrow": "noise", "many_colours":
            "gradient", "large": "noise"}.get(case, case)
    x = _rgb(kind, 7, h, w)
    if case == "one_colour":
        x[:] = x[0, 0]
    want, got = _both_gifs(x, tmp_path)
    assert got == want


@pytest.mark.parametrize("case", ["clear", "mixed", "drawn", "opaque",
                                  "large"])
def test_imwrite_rgba_gif_is_byte_equal_to_jax(case, tmp_path):
    """``imwrite(x, "x.gif")`` of RGBA images: every alpha 0 (the first
    transparent entry is the GIF's transparent index), mixed, drawn and
    opaque alpha, and 512 x 512."""
    h, w = (512, 512) if case == "large" else (35, 41)
    x = _rgba("mixed" if case == "large" else case, 3, h, w)
    want, got = _both_gifs(x, tmp_path)
    assert got == want


def test_gif_transparency_follows_the_palette(tmp_path):
    """An RGBA image whose only transparent pixels lie in a palette
    entry the optimisation keeps: a GIF89a with a graphic control
    extension, the same index as PIL's."""
    x = _rgba("opaque", 5, 24, 30)
    x[3:6, 4:9, 3] = 0
    want, got = _both_gifs(x, tmp_path)
    assert got == want and got.startswith(b"GIF89a") and b"!\xf9\x04" in got


def test_quantizers_raise_without_the_library(monkeypatch, tmp_path):
    """A native library that did not build or load: the quantizers (and
    so RGB and RGBA GIF writes) raise, with no plain fallback; gray GIFs
    still write through the plain LZW."""
    monkeypatch.setattr(_native, "get_lib", lambda: None)
    x = _rgb("noise", 1, 8, 9)
    with pytest.raises(RuntimeError, match="quant.cpp"):
        quant.median_cut(quant.pixels(x))
    with pytest.raises(RuntimeError, match="quant.cpp"):
        quant.octree(quant.pixels(x))
    with pytest.raises(RuntimeError, match="quant.cpp"):
        T.imwrite(x, str(tmp_path / "x.gif"))
    T.imwrite(x[..., 0], str(tmp_path / "g.gif"))
    buf = io.BytesIO()
    Image.fromarray(x[..., 0]).save(buf, "GIF")
    assert open(str(tmp_path / "g.gif"), "rb").read() == buf.getvalue()


def test_rgb_gif_under_a_tiff_name_reads_as_jax(tmp_path):
    """The port's RGB GIF under a TIFF name: ``read_channel`` of channel
    0 is the index plane, as the JAX fallback reads it; channel 1 is past
    the last frame in both."""
    x = _gradient(40, 50, 4)
    path = str(tmp_path / "q.tif")
    with open(path, "wb") as f:
        f.write(gif.encode_gif(x))
    got = slides.read_channel(path, "tif", 0)
    want = jax_slides.read_channel(path, "tif", 0)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    idx, _ = quant.median_cut(quant.pixels(x))
    assert len(np.unique(got)) == len(np.unique(idx))
    for read in (slides.read_channel, jax_slides.read_channel):
        with pytest.raises((IndexError, EOFError)):
            read(path, "tif", 1)
    assert os.path.getsize(path) > 0
