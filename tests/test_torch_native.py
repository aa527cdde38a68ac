"""The port's native TIFF codec (``unmicst_tpu_torch/io/_native.py`` over
``unmicst_tpu_torch/native/tiffcodec.cpp``) against the JAX package's
(``unmicst_tpu/io/_native.py``): the same payloads give the same bytes or
the same error, function by function, and the port's TIFF reader and
writer read and write as the JAX package's do, with the library and
without it.  The payloads come from ``scripts/fuzz_native_codec.py``."""

import importlib.util
import os
import struct
import zlib

import numpy as np
import pytest

from unmicst_tpu.io import _native as jax_native
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu_torch.io import _native
from unmicst_tpu_torch.io import tiff as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_fuzz():
    spec = importlib.util.spec_from_file_location(
        "fuzz_native_codec", os.path.join(REPO, "scripts",
                                          "fuzz_native_codec.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


fuzz = _load_fuzz()


@pytest.fixture(scope="module", autouse=True)
def libraries():
    """Both libraries loaded (each builds at first use)."""
    assert _native.get_lib() is not None, "the port's codec did not build"
    assert jax_native.get_lib() is not None, "the JAX codec did not build"


def _outcome(fn, *args):
    """What a call gives: its bytes (and flag), or its error's type and
    message."""
    try:
        r = fn(*args)
    except ValueError as exc:
        return ("error", type(exc).__name__, str(exc))
    if isinstance(r, tuple):
        return ("ok", r[0].tobytes(), r[1])
    return ("ok", r.tobytes() if isinstance(r, np.ndarray) else r)


def _streams(kind: str, n: int = 24):
    """(stream, declared output size) pairs of one kind, seeded."""
    rng = np.random.RandomState(sum(map(ord, kind)))
    out = []
    for i in range(n):
        plain = fuzz.gen_payload(rng, i % 4)
        declared = len(plain)
        if kind.startswith("lzw"):
            stream = fuzz.lzw_encode(plain, "lagged" if kind == "lzw_lagged"
                                     else "spec")
        elif kind.startswith("packbits"):
            stream = fuzz.packbits_encode(plain)
        else:
            stream = zlib.compress(plain, int(rng.randint(0, 10)))
        if kind.endswith("truncated") and len(stream) > 2:
            stream = stream[: int(rng.randint(1, len(stream)))]
        if kind.endswith("corrupt"):
            stream = fuzz.mutate(rng, stream)
            declared = max(declared, 4 * len(stream) + 4096)
        out.append((stream, declared))
        if declared >= 2:  # the same stream into half the room
            out.append((stream, declared // 2))
    return out


@pytest.mark.parametrize("kind", [
    "lzw_spec", "lzw_lagged", "lzw_truncated", "lzw_corrupt",
    "packbits", "packbits_truncated", "packbits_corrupt",
    "inflate", "inflate_truncated", "inflate_corrupt"])
def test_decoders_match_jax(kind):
    """Every decoder of the kind, plain and with the overrun flag, gives
    the JAX library's bytes, flag or error on the same stream and room."""
    name = kind.split("_")[0]
    fns = {"lzw": ("lzw_decode", "lzw_decode_ex"),
           "packbits": ("packbits_decode", "packbits_decode_ex"),
           "inflate": ("inflate",)}[name]
    for stream, declared in _streams(kind):
        for fn in fns:
            ours = _outcome(getattr(_native, fn), stream, declared)
            theirs = _outcome(getattr(jax_native, fn), stream, declared)
            assert ours == theirs, (kind, fn, len(stream), declared)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_predictor_undo_matches_jax(dtype):
    rng = np.random.RandomState(3)
    a = (rng.rand(37, 53) * np.iinfo(dtype).max).astype(dtype)
    ours, theirs = a.copy(), a.copy()
    assert _native.predictor_undo(ours) is ours
    jax_native.predictor_undo(theirs)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, np.cumsum(a, axis=1, dtype=dtype))
    assert _native.predictor_undo(a.astype(np.uint32)) is None


@pytest.mark.parametrize("tag", [8, 5, 32773])
def test_decode_strips_matches_jax(tag):
    """One-call strip decode: the same buffer, or the same error naming
    the same strip, on clean spans and spans with one corrupt strip."""
    rng = np.random.RandomState(tag)
    enc = {8: lambda d: zlib.compress(d, 6), 5: fuzz.lzw_encode,
           32773: fuzz.packbits_encode}[tag]
    for case in range(12):
        plains = [fuzz.gen_payload(rng, int(rng.randint(0, 4)))
                  for _ in range(int(rng.randint(1, 6)))]
        encs = [enc(p) for p in plains]
        if case % 2:
            k = int(rng.randint(0, len(encs)))
            encs[k] = fuzz.mutate(rng, encs[k])
        span = b"".join(encs)
        offs = np.cumsum([0] + [len(e) for e in encs[:-1]]).astype(np.int64)
        lens = np.array([len(e) for e in encs], np.int64)
        dlens = np.array([len(p) for p in plains], np.int64)
        doffs = np.cumsum([0] + [len(p) for p in plains[:-1]]).astype(
            np.int64)
        res = []
        for mod in (_native, jax_native):
            out = np.zeros(int(dlens.sum()), np.uint8)
            r = _outcome(mod.decode_strips, span, offs, lens, doffs, dlens,
                         tag, out)
            res.append((r, out.tobytes() if r[0] == "ok" else None))
        assert res[0] == res[1], (tag, case)
        if not case % 2:
            assert res[0][1] == b"".join(plains)


@pytest.mark.parametrize("level", range(1, 10))
def test_deflate_encoders_match_jax(level):
    """The writer's encoder at each level (1-3 greedy, 4-9 chain) gives
    the JAX encoder's bytes, which zlib and the native inflate take back
    to the input."""
    rng = np.random.RandomState(level)
    for kind in range(4):
        plain = fuzz.gen_payload(rng, kind)
        ours = (_native.deflate(plain) if level <= 3
                else _native.deflate_chain(plain, level))
        theirs = (jax_native.deflate(plain) if level <= 3
                  else jax_native.deflate_chain(plain, level))
        assert ours == theirs
        assert zlib.decompress(ours) == plain
        assert _native.inflate(ours, len(plain)).tobytes() == plain
        assert tt._encode_deflate(plain, level) == ours


def _strip_tiff(path, image, rows_per_strip, encode, predictor=2,
                extra_rows=0):
    """A classic TIFF of ``image`` in strips that ``encode`` compresses
    (LZW), horizontal predictor ``predictor``.  ``extra_rows`` > 0 pads
    the last strip's stream with that many zero rows past the page: the
    writer slack a reader truncates."""
    h, w = image.shape
    diff = image.copy()
    if predictor == 2:
        diff[:, 1:] -= image[:, :-1]
    rows = [diff[r : r + rows_per_strip].tobytes()
            for r in range(0, h, rows_per_strip)]
    rows[-1] += bytes(extra_rows * w * image.dtype.itemsize)
    strips = [encode(r) for r in rows]
    n = len(strips)
    offs = list(8 + np.cumsum([0] + [len(s) for s in strips[:-1]]))
    arrays = 8 + sum(len(s) for s in strips)
    entries = [(256, 4, 1, w), (257, 4, 1, h),
               (258, 3, 1, image.dtype.itemsize * 8), (259, 3, 1, 5),
               (262, 3, 1, 1), (273, 4, n, arrays if n > 1 else offs[0]),
               (277, 3, 1, 1), (278, 4, 1, rows_per_strip),
               (279, 4, n, arrays + 4 * n if n > 1 else len(strips[0])),
               (317, 3, 1, predictor)]
    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42,
                            arrays + (8 * n if n > 1 else 0)))
        for s in strips:
            f.write(s)
        if n > 1:
            f.write(struct.pack(f"<{n}I", *offs))
            f.write(struct.pack(f"<{n}I", *(len(s) for s in strips)))
        f.write(struct.pack("<H", len(entries)))
        for tag, ftype, count, value in entries:
            f.write(struct.pack("<HHII", tag, ftype, count, value))
        f.write(struct.pack("<I", 0))


def _reads(path, windows):
    """(whole page, windows) through the port's reader."""
    with tt.TiffFile(path) as tf:
        return tf.read_page(0), [tf.read_region(0, *w) for w in windows]


def _no_library(monkeypatch):
    monkeypatch.setattr(_native, "get_lib", lambda: None)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("case", ["spec", "lagged", "slack"])
def test_lzw_predictor2_tiff_reads_as_jax(tmp_path, monkeypatch, native,
                                          dtype, case):
    """A small LZW predictor-2 TIFF reads equal through the port (with its
    library and without) and through JAX's ``tiff.imread``, whole and
    windowed: spec EOIs, "lagged" EOIs (the classic encoder off-by-one),
    and writer slack past the last row."""
    rng = np.random.RandomState(7)
    img = (rng.rand(150, 97) * np.iinfo(dtype).max).astype(dtype)
    img[40:90, 20:60] = 7  # runs for the table
    path = str(tmp_path / "p2.tif")
    _strip_tiff(path, img, 16,
                lambda b: fuzz.lzw_encode(b, "lagged" if case == "lagged"
                                          else "spec"),
                extra_rows=3 if case == "slack" else 0)
    if not native:
        _no_library(monkeypatch)
    windows = [(5, 3, 40, 50), (140, 90, 30, 30), (0, 0, 150, 97)]
    whole, wins = _reads(path, windows)
    np.testing.assert_array_equal(whole, img)
    np.testing.assert_array_equal(whole, jax_tiff.imread(path))
    with jax_tiff.TiffFile(path) as jf:
        for w, got in zip(windows, wins):
            np.testing.assert_array_equal(got, jf.read_region(0, *w))


def test_truncated_strip_raises_in_both(tmp_path):
    """A strip whose stream ends early decodes short: both readers
    refuse the page rather than hand back uninitialised rows."""
    img = np.arange(64 * 40, dtype=np.uint16).reshape(64, 40)
    path = str(tmp_path / "t.tif")
    _strip_tiff(path, img, 16, lambda b: fuzz.lzw_encode(b[: len(b) // 2]))
    with pytest.raises(ValueError):
        tt.imread(path)
    with jax_tiff.TiffFile(path) as jf, pytest.raises(ValueError):
        jf.read_page(0)


def test_chip_smoke_lzw_writer_reads_in_both(tmp_path):
    """The smoke script's LZW encoder gives the fuzz encoder's bytes, and
    its predictor-2 TIFF reads equal through both packages."""
    import chip_smoke

    rng = np.random.RandomState(11)
    for kind in range(8):
        plain = fuzz.gen_payload(rng, kind % 4)
        assert chip_smoke.lzw_encode(plain) == fuzz.lzw_encode(plain)
    img = (chip_smoke.blob_slide(rng, 200, 160, 20) * 60000).astype(np.uint16)
    path = str(tmp_path / "s.tif")
    chip_smoke.write_lzw_tiff(path, img, 32)
    np.testing.assert_array_equal(tt.imread(path), img)
    np.testing.assert_array_equal(jax_tiff.imread(path), img)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("level", [None, 3, 6])
@pytest.mark.parametrize("tile", [None, (64, 48)])
def test_deflate_writer_reads_in_both(tmp_path, monkeypatch, native, level,
                                      tile):
    """``TiffWriter(compression="deflate")`` through the native encoders
    (or zlib without the library): each segment is a zlib stream, and
    both readers read the pixels back, whole and windowed."""
    if not native:
        _no_library(monkeypatch)
    rng = np.random.RandomState(5)
    img = (rng.rand(300, 200) * 255).astype(np.uint8)
    img[100:200] = 17
    path = str(tmp_path / "d.tif")
    with tt.TiffWriter(path, compression="deflate",
                       compression_level=level) as tw:
        tw.write(img, tile=tile)
    with tt.TiffFile(path) as tf:
        page = tf.pages[0]
        np.testing.assert_array_equal(tf.read_page(0), img)
        np.testing.assert_array_equal(tf.read_region(0, 50, 30, 120, 90),
                                      img[50:170, 30:120])
        with open(path, "rb") as f:
            f.seek(int(page.offsets[0]))
            seg = zlib.decompress(f.read(int(page.counts[0])))
    first = img[:tile[0], :tile[1]] if tile else img[:page.rows_per_strip]
    assert seg == np.ascontiguousarray(first).tobytes()
    np.testing.assert_array_equal(jax_tiff.imread(path), img)


def test_autobuild_switch_and_missing_compiler(monkeypatch, capsys):
    """``UNMICST_NO_AUTOBUILD`` is value-sensitive as in JAX; with no
    compiler there is no library, one line on stderr says so, and LZW
    still reads through the Python codec."""
    for value, off in (("", False), ("0", False), ("1", True),
                       ("yes", True)):
        monkeypatch.setenv("UNMICST_NO_AUTOBUILD", value)
        assert _native._autobuild_disabled() is off
    monkeypatch.delenv("UNMICST_NO_AUTOBUILD")
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_build_attempted", False)
    monkeypatch.setattr(_native, "lib_path",
                        lambda: os.path.join(REPO, "build", "torch_host",
                                             "absent", _native.LIB_NAME))
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    assert _native.get_lib() is None
    assert "no g++" in capsys.readouterr().err
    data = bytes(range(200)) * 30
    assert tt._decode(fuzz.lzw_encode(data), tt.COMPRESSION_LZW,
                      len(data)) == data
