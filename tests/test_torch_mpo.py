"""MPO files (``unmicst_tpu_torch/io/mpo.py``) against the JAX package,
which opens them through PIL (``Image.open`` takes a JPEG whose APP2
``MPF`` index lists more images as an ``MpoImageFile``, and ``seek(k)``
reads frame k): its TIFF fallback at page == channel
(``unmicst_tpu/io/slides.py:74-79``, ``io/tiff.py:1286-1291``), the
toolbox's ``imread`` and the CLI.  F6 was the port reading every JPEG
under a TIFF name as one frame.  Pillow's own MPO writes and
``chip_smoke.mpo_file``'s, in both byte orders, at odd sizes, and MP
indexes PIL reads as a plain JPEG or cannot identify."""

import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from unmicst_tpu import cli as jax_cli
from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io import tiff as jax_tiff
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch import cli
from unmicst_tpu_torch.io import mpo, slides, tiff
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_mpo")
FILES = sorted(f[:-4] for f in os.listdir(FIXTURES) if f.endswith(".mpo"))


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _jpeg(img) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG")
    return buf.getvalue()


def _pil_mpo(frames) -> bytes:
    buf = io.BytesIO()
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(buf, "MPO", save_all=True, append_images=ims[1:])
    return buf.getvalue()


def _outcome(fn):
    """``("ok", dtype, shape, bytes)`` or the exception's class (any
    ``OSError`` as ``OSError``: PIL's ``UnidentifiedImageError`` and the
    port's ``FallbackError`` are both)."""
    try:
        r = fn()
        return ("ok", r.dtype, r.shape, r.tobytes())
    except OSError:
        return OSError
    except Exception as e:  # noqa: BLE001
        return type(e)


def _all_entry_points_match(data: bytes, tmp_path, channels=4):
    """Both ``read_channel``s and both ``tiff.imread``s of ``data`` under
    a TIFF name at each channel, and both ``imread``s of it as ``.mpo``:
    the same arrays or the same exception classes.  Returns the JAX
    ``read_channel`` outcomes."""
    tif, raw = str(tmp_path / "m.tif"), str(tmp_path / "m.mpo")
    for path in (tif, raw):
        with open(path, "wb") as f:
            f.write(data)
    out = []
    for ch in range(channels):
        want = _outcome(lambda: jax_slides.read_channel(tif, "tif", ch))
        assert _outcome(lambda: slides.read_channel(tif, "tif", ch)) == want
        assert _outcome(lambda: tiff.imread(tif, ch)) == _outcome(
            lambda: jax_tiff.imread(tif, ch))
        out.append(want)
    assert _outcome(lambda: T.imread(raw)) == _outcome(lambda: J.imread(raw))
    return out


def test_f6_channel_1_of_a_gray_mpo_under_a_tiff_name(tmp_path):
    """F6: a gray 3-frame MPO (Pillow's ``save_all``) under ``.tif``:
    channel 1 is frame 1 in JAX, and now in the port."""
    rng = np.random.RandomState(6)
    frames = [rng.randint(0, 256, (16, 24)).astype(np.uint8)
              for _ in range(3)]
    path = str(tmp_path / "m_mpo.tif")
    with open(path, "wb") as f:
        f.write(_pil_mpo(frames))
    want = jax_slides.read_channel(path, "tif", 1)
    assert want.shape == (16, 24)
    _equal(slides.read_channel(path, "tif", 1), want)


@pytest.mark.parametrize("kind", ["gray", "rgb"])
def test_frames_read_as_jax_reads_them(kind, tmp_path):
    """Frames 0-2 of a 3-frame MPO through ``read_channel`` and
    ``tiff.imread``, ``IndexError`` (``EOFError``) at 3, ``imread``
    frame 0."""
    rng = np.random.RandomState(7)
    shape = (24, 40) + ((3,) if kind == "rgb" else ())
    frames = [rng.randint(0, 256, shape).astype(np.uint8) for _ in range(3)]
    out = _all_entry_points_match(_pil_mpo(frames), tmp_path)
    assert [o[0] if isinstance(o, tuple) else o for o in out] == [
        "ok", "ok", "ok", IndexError]


@pytest.mark.parametrize("byteorder", ["<", ">"])
def test_hand_built_mpos_at_odd_sizes(byteorder, tmp_path):
    """``chip_smoke.mpo_file`` of JPEGs at 1x1, 13x17 and 257x300, gray and
    RGB, with a little- and a big-endian MP index."""
    rng = np.random.RandomState(8)
    streams = [_jpeg(rng.randint(0, 256, shape).astype(np.uint8))
               for shape in ((1, 1), (13, 17, 3), (257, 300))]
    out = _all_entry_points_match(chip_smoke.mpo_file(streams, byteorder),
                                  tmp_path)
    assert [o[2] for o in out[:3]] == [(1, 1), (13, 17, 3), (257, 300)]


def _patched(data: bytes, field: str, value: int) -> bytes:
    """``chip_smoke.mpo_file``'s little-endian index with one field
    changed: its IFD starts 18 bytes into the file (after SOI, the APP2
    header and the TIFF header), the MP entries 60 bytes in."""
    out = bytearray(data)
    at = {"count_type": 32 + 2, "count": 32 + 8, "entries_type": 44 + 2,
          "header": 10, "offset1": 60 + 16 + 8, "attr1": 60 + 16}[field]
    fmt = {"count_type": "<H", "entries_type": "<H", "header": "<L"}.get(
        field, "<L")
    struct.pack_into(fmt, out, at, value)
    return bytes(out)


def _malformed():
    rng = np.random.RandomState(9)
    streams = [_jpeg(rng.randint(0, 256, (16, 24)).astype(np.uint8))
               for _ in range(3)]
    base = chip_smoke.mpo_file(streams)
    xmp = b'<x:xmpmeta hdrgm:Version="1.0"/>'
    hdr = b"\xff\xe1" + struct.pack(">H", len(xmp) + 2) + xmp
    return {
        "one_image": _patched(base, "count", 1),
        "count_past_the_entries": _patched(base, "count", 5),
        "count_as_short": _patched(base, "count_type", 3),
        "count_of_unknown_type": _patched(base, "count_type", 99),
        "entries_as_longs": _patched(base, "entries_type", 4),
        "not_a_tiff_header": _patched(base, "header", 0x002A5858),
        "offset_past_the_end": _patched(base, "offset1", len(base) + 100),
        "offset_into_a_frame": _patched(base, "offset1", 40),
        "not_a_jpeg_entry": _patched(base, "attr1", 0x01020002),
        "ultra_hdr": base[:2] + hdr + base[2:],
    }


@pytest.mark.parametrize("case", sorted(_malformed()))
def test_mp_indexes_read_as_pil_reads_them(case, tmp_path):
    """An index PIL takes for a plain JPEG (one image, a count or entry
    list of another type, no TIFF header, a frame not JPEG-coded, an
    Ultra HDR APP1), one it cannot identify (entries shorter than the
    count), frames past the file's end or inside another frame: the port
    reads and raises as JAX does at every channel."""
    out = _all_entry_points_match(_malformed()[case], tmp_path)
    plain = ("one_image", "count_of_unknown_type", "entries_as_longs",
             "not_a_tiff_header", "not_a_jpeg_entry", "ultra_hdr")
    if case in plain:
        assert out[0][0] == "ok" and out[1:] == [IndexError] * 3
    elif case == "count_past_the_entries":
        assert out == [ValueError] * 4
    else:
        assert out[0][0] == "ok" and out[3] == IndexError


@pytest.mark.parametrize("name", FILES)
def test_committed_fixtures(name):
    """Every frame of every committed MPO: the port's read equals PIL's
    committed read (what the card checks), and PIL's live read."""
    with open(os.path.join(FIXTURES, name + ".mpo"), "rb") as f:
        data = f.read()
    ref = np.load(os.path.join(FIXTURES, name + ".npz"))
    assert len(mpo.frame_offsets(data)) == len(ref.files) == 3
    for k in range(len(ref.files)):
        _equal(mpo.read_frame(data, k), ref[f"frame{k}"])
        with Image.open(io.BytesIO(data)) as im:
            im.seek(k)
            _equal(np.asarray(im), ref[f"frame{k}"])
    with pytest.raises(EOFError):
        mpo.read_frame(data, 3)


def _outputs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_cli_on_frame_1_of_a_gray_mpo(tmp_path):
    """``--channel 2`` (frame 1) of a gray 3-frame 48 x 64 MPO under a
    TIFF name through both CLIs: the same files, pages within 1 uint8
    level."""
    rng = np.random.RandomState(10)
    frames = [rng.randint(0, 256, (48, 64)).astype(np.uint8)
              for _ in range(3)]
    path = tmp_path / "s" / "m.tif"
    path.parent.mkdir()
    path.write_bytes(_pil_mpo(frames))
    common = [str(path), "--tool", "unmicst-legacy", "--model", "blobDemo",
              "--modelRoot", MODELS, "--stackOutput", "--channel", "2"]
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
