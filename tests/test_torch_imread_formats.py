"""The port's toolbox ``imread`` / ``imwrite`` (``unmicst_tpu_torch/
utils/imtools.py``, ``io/png.py``, ``io/bmp.py``) against the JAX
package's (``unmicst_tpu/utils/imtools.py:49-67``: PIL's ``Image.open``
by content, ``Image.fromarray(x).save(path)`` by extension) on the same
files: every PNG kind, interlaced or not; BMP palette, 16/24/32-bit and
RLE images; JPEG and TIFF under any name; the writers' files as PIL reads
them back, and the errors PIL raises."""

import io
import os
import shutil
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch.io import _native, bmp, png
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_image_formats")
FILES = sorted(f for f in os.listdir(FIXTURES) if f.endswith((".png",
                                                              ".bmp")))
WRITES = sorted(f[6:-4] for f in os.listdir(FIXTURES)
                if f.startswith("write_") and f.count("_") == 1)


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(params=["native", "python"])
def codecs(request, monkeypatch):
    assert _native.get_lib() is not None, "the native library did not load"
    if request.param == "python":
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    return request.param


def test_fixtures_are_the_listed_kinds():
    pngs = [f for f in FILES if f.endswith(".png")]
    bmps = [f for f in FILES if f.endswith(".bmp")]
    assert len(pngs) == 33 and len(bmps) == 22
    assert WRITES == sorted(["bool", "gray", "la", "rgb", "rgba", "uint16",
                             "int8", "int16", "int32", "uint32"])
    total = sum(os.path.getsize(os.path.join(FIXTURES, f))
                for f in os.listdir(FIXTURES))
    assert total < 600 << 10


@pytest.mark.parametrize("name", FILES)
def test_files_read_as_jax_reads_them(name, codecs):
    """Each fixture: the port's ``imread`` equals JAX's (PIL's) and the
    committed ``.npy``, dtype and shape included."""
    path = os.path.join(FIXTURES, name)
    got = T.imread(path)
    _equal(got, J.imread(path))
    _equal(got, np.load(path.rsplit(".", 1)[0] + ".npy"))


def test_png_modes_pinned():
    """PIL's modes as the port gives them: gray 1-bit bool, 2/4-bit
    scaled by 85/17, 16-bit colour to its high byte, 16-bit gray+alpha
    as RGBA, palette indices whatever ``tRNS`` or ``PLTE`` say."""
    def read(name):
        return T.imread(os.path.join(FIXTURES, name))
    assert read("png_c0_1.png").dtype == np.bool_
    assert set(np.unique(read("png_c0_2.png"))) <= {0, 85, 170, 255}
    assert set(np.unique(read("png_c0_4.png"))) <= set(range(0, 256, 17))
    assert read("png_c0_16.png").dtype == np.uint16
    assert read("png_c4_16.png").shape == (13, 17, 4)
    la = read("png_c4_16.png")
    _equal(la[..., 0], la[..., 1])
    assert read("png_c2_16.png").dtype == np.uint8
    _equal(read("png_c3_8_trns.png"), read("png_c3_8_noplte.png"))


@pytest.mark.parametrize("name", WRITES)
@pytest.mark.parametrize("ext", ["png", "bmp"])
def test_writes_read_back_as_pil_writes(name, ext, tmp_path):
    """``imwrite`` of each dtype: PIL reads the port's file back to what
    it reads from its own, equal to the committed read; where PIL refuses
    (float, and BMP of any mode but 1, L, RGB and RGBA), the port raises
    PIL's exception with its message."""
    x = np.load(os.path.join(FIXTURES, f"write_{name}.npy"))
    ours, pils = str(tmp_path / f"o.{ext}"), str(tmp_path / f"p.{ext}")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            J.imwrite(x, pils)
    except OSError as e:
        with pytest.raises(OSError, match=str(e)):
            T.imwrite(x, ours)
        assert not os.path.exists(
            os.path.join(FIXTURES, f"write_{name}_{ext}.npy"))
        return
    T.imwrite(x, ours)
    want = np.load(os.path.join(FIXTURES, f"write_{name}_{ext}.npy"))
    _equal(J.imread(ours), want)
    _equal(J.imread(pils), want)
    _equal(T.imread(ours), want)
    if ext == "bmp":  # PIL's BMP header and rows, byte for byte
        assert open(ours, "rb").read() == open(pils, "rb").read()


@pytest.mark.parametrize("dtype", ["int64", "uint64", "float16", "complex64"])
@pytest.mark.parametrize("shape", [(5, 6), (5, 6, 2), (5, 6, 1), (5, 6, 5)])
def test_writes_refuse_as_fromarray_refuses(dtype, shape, tmp_path):
    """A dtype or shape ``Image.fromarray`` has no mode for: its
    ``TypeError`` and message, whatever the extension (PNG, BMP, JPEG);
    float planes: ``cannot write mode F``."""
    x = np.zeros(shape, dtype)
    for ext in ("png", "bmp", "jpg"):
        with pytest.raises(TypeError) as want:
            J.imwrite(x, str(tmp_path / f"p.{ext}"))
        with pytest.raises(TypeError, match=str(want.value).replace(
                "(", r"\(").replace(")", r"\)")):
            T.imwrite(x, str(tmp_path / f"o.{ext}"))
    for dt in ("float32", "float64"):
        for ext in ("png", "bmp"):
            with pytest.raises(OSError, match=f"cannot write mode F as "
                               f"{ext.upper()}"):
                T.imwrite(np.zeros((3, 4), dt), str(tmp_path / f"f.{ext}"))
    for other in (np.zeros((4, 3, 2), np.uint8), np.zeros(5, np.uint8)):
        T.imwrite(other, str(tmp_path / "o.png"))
        _equal(T.imread(str(tmp_path / "o.png")),
               J.imread(str(tmp_path / "o.png")))


def test_imread_opens_by_content(tmp_path):
    """``Image.open`` opens by content: a JPEG as ``.jpe``, ``.jfif`` or
    with no extension, a PNG as ``.bmp``, a BMP and a TIFF under other
    names.  A TIFF name goes to the TIFF reader in both packages, whose
    fallback opens a PNG, JPEG or BMP under it by content."""
    rng = np.random.RandomState(3)
    gray = (rng.rand(20, 24) * 255).astype(np.uint8)
    jpg = io.BytesIO()
    Image.fromarray(np.stack([gray] * 3, -1)).save(jpg, "JPEG", quality=90)
    src = {"jpg": jpg.getvalue()}
    for name in ("x.jpe", "x.jfif", "noext", "jpeg_as.tif"):
        path = str(tmp_path / name)
        open(path, "wb").write(src["jpg"])
        _equal(T.imread(path), J.imread(path))
    Image.fromarray(gray).save(str(tmp_path / "p.png"))
    Image.fromarray(gray).save(str(tmp_path / "b.bmp"))
    T.tifwrite((gray.astype(np.uint16) * 257), str(tmp_path / "t.tif"))
    for src, dst in (("p.png", "png_as.bmp"), ("b.bmp", "bmp_as.png"),
                     ("b.bmp", "bmp_as.tif"), ("t.tif", "tiff_as.dat"),
                     ("p.png", "png_noext")):
        shutil.copy(str(tmp_path / src), str(tmp_path / dst))
        _equal(T.imread(str(tmp_path / dst)), J.imread(str(tmp_path / dst)))


def test_other_formats_stay_queued(tmp_path):
    """WebP read and write raise ``NotImplementedError`` naming ROADMAP
    M17 (PIL reads and writes them); GIF read and JPEG and gray GIF write
    are the JAX package's since the fourth part of M17, RGB GIF write
    (Pillow's median cut) since its seventh."""
    gray = np.arange(48, dtype=np.uint8).reshape(6, 8)
    Image.fromarray(gray).save(str(tmp_path / "g.webp"))
    assert J.imread(str(tmp_path / "g.webp")).shape[:2] == gray.shape
    with pytest.raises(NotImplementedError, match="M17"):
        T.imread(str(tmp_path / "g.webp"))
    with pytest.raises(NotImplementedError, match="M17"):
        T.imwrite(gray, str(tmp_path / "o.webp"))
    rgb = np.stack([gray, gray[::-1], gray.T.reshape(6, 8)], -1)
    J.imwrite(rgb, str(tmp_path / "j_rgb.gif"))
    T.imwrite(rgb, str(tmp_path / "t_rgb.gif"))
    assert (tmp_path / "t_rgb.gif").read_bytes() == (
        tmp_path / "j_rgb.gif").read_bytes()
    Image.fromarray(gray).save(str(tmp_path / "g.gif"))
    _equal(T.imread(str(tmp_path / "g.gif")), J.imread(str(tmp_path /
                                                            "g.gif")))
    for name in ("o.jpg", "o.gif", "o.jpeg"):
        J.imwrite(gray, str(tmp_path / f"j{name}"))
        T.imwrite(gray, str(tmp_path / f"t{name}"))
        with open(str(tmp_path / f"j{name}"), "rb") as f, open(
                str(tmp_path / f"t{name}"), "rb") as g:
            assert f.read() == g.read()


def _bmp(w, h, bits, data, palette, compression=0):
    """A BMP with a 40-byte header: ``palette`` as BGRX entries."""
    info = struct.pack("<IIIHHIIiiII", 40, w, h, 1, bits, compression,
                       len(data), 2835, 2835, len(palette) // 4, 0)
    off = 14 + 40 + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + info
            + palette + data)


def test_bmp_quirks_as_pil(tmp_path):
    """PIL's decoders, quirks included: an RLE8 delta (PIL skips two
    bytes, then reads the step), an RLE4 absolute run of odd length (PIL
    takes ``n // 2`` bytes); a 4-bit image with the identity gray palette
    (PIL reads its rows as 8-bit at the 4-bit stride: on into the next row
    where it maps the file, refused where the file is too short to map);
    RLE under a black/white palette and raw data cut short: refused in
    both."""
    colour = bytes(i % 251 for i in range(4 * 256))
    path = str(tmp_path / "q.bmp")
    rle = (bytes((3, 5, 0, 2, 9, 9, 2, 0, 4, 7, 0, 0)) + bytes(
        (9, 1, 0, 0)) + bytes((0, 3, 1, 2, 3, 0, 6, 4, 0, 0)) + b"\0\1")
    for data, bits, comp in ((rle, 8, 1), (bytes(
            (0, 5, 0x12, 0x34, 0x56, 0, 4, 0x78, 0, 0, 9, 0x9A, 0, 0, 9,
             0xBC, 0, 1)), 4, 2)):
        open(path, "wb").write(_bmp(9, 3, bits, data, colour[:4 << bits],
                                    comp))
        _equal(T.imread(path), J.imread(path))
    ramp = bytes(b for i in range(16) for b in (i, i, i, 0))
    open(path, "wb").write(_bmp(9, 3, 4, bytes(range(1, 25)), ramp))
    _equal(T.imread(path), J.imread(path))  # rows read on into the next
    open(path, "wb").write(_bmp(9, 3, 4, bytes(range(1, 21)), ramp))
    with pytest.raises(OSError, match="codec configuration"):
        with Image.open(path) as im:
            im.load()
    with pytest.raises(OSError, match="codec configuration"):
        T.imread(path)
    bw = b"\0\0\0\0\xff\xff\xff\0"
    open(path, "wb").write(_bmp(9, 3, 8, rle, bw, 1))
    for read in (J.imread, T.imread):
        with pytest.raises(ValueError, match="unknown raw mode"):
            read(path)
    open(path, "wb").write(_bmp(9, 3, 8, bytes(30), colour))
    for read in (J.imread, T.imread):
        with pytest.raises(OSError, match="truncated"):
            read(path)


def test_bmp_read_write_directly(tmp_path):
    """``bmp.read_bmp`` / ``write_bmp`` and ``png.read_png`` /
    ``write_png`` on their own, as the toolbox calls them."""
    x = (np.arange(60) % 256).astype(np.uint8).reshape(6, 10)
    bmp.write_bmp(str(tmp_path / "a.bmp"), x)
    _equal(bmp.read_bmp(str(tmp_path / "a.bmp")), x)
    png.write_png(str(tmp_path / "a.png"), x > 30)
    _equal(png.read_png(str(tmp_path / "a.png")), x > 30)
    with pytest.raises(ValueError, match="not a BMP"):
        bmp.read_bmp(str(tmp_path / "a.png"))
