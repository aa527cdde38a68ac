"""CZI and ND2 (ROADMAP item 6) in the port: ``io/czi.py`` and ``io/nd2.py``
against the JAX package's readers on the same hand-built containers
(``tests/test_slides_czi_nd2.py``'s writers), whole and windowed; the
truncation and fuzz inputs; the JPEG XR refusal and an undecodable JPEG
sub-block; and the CLI on CZI and ND2 slides against the JAX CLI."""

import os
import struct

import numpy as np
import pytest

from tests.test_slides_czi_nd2 import (_lv_uint, _nd2_chunk, _segment,
                                       _write_czi_blocks, write_czi,
                                       write_nd2)
from unmicst_tpu import cli as jax_cli
from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io.tiff import imread as jax_imread
from unmicst_tpu_torch import cli
from unmicst_tpu_torch.io import slides
from unmicst_tpu_torch.io.czi import CziFile
from unmicst_tpu_torch.io.nd2 import Nd2File
from unmicst_tpu_torch.io.tiff import TiffWriter, imread, num_pages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
ND2_SIG = b"ND2 CHUNK MAP SIGNATURE 0000001!"


def _u16(rng, h, w, *rest):
    return (rng.rand(h, w, *rest) * 60000).astype(np.uint16)


def _czi_pyramid(path, plane):
    """One full-resolution block and one pyramid block (PyramidType 1,
    stored at half size) sharing its C/S/T/Z coordinates."""
    down = plane[::2, ::2].copy()
    h, w = plane.shape

    def entry(pos, dims, pyramid):
        out = b"DV" + struct.pack("<iqii", 1, pos, 0, 0)
        out += bytes([pyramid]) + b"\x00" * 5 + struct.pack("<i", len(dims))
        for name, (start, size, stored) in dims.items():
            out += struct.pack("<4siifi", name.encode(), start, size,
                               float(start), stored)
        return out

    blocks = [({"X": (0, w, w), "Y": (0, h, h), "C": (0, 1, 1)}, plane, 0),
              ({"X": (0, w, w // 2), "Y": (0, h, h // 2), "C": (0, 1, 1)},
               down, 1)]
    out = bytearray(_segment(b"ZISRAWFILE", struct.pack(
        "<ii8x16s16si", 1, 0, bytes(16), bytes(16), 0)
        + struct.pack("<qqiq", 0, 0, 0, 0)))
    positions = []
    for dims, pix, pyr in blocks:
        positions.append(len(out))
        e = entry(0, dims, pyr)
        head = struct.pack("<iiq", 0, 0, pix.nbytes) + e
        out += _segment(b"ZISRAWSUBBLOCK", head + bytes(
            max(256, len(e) + 16) - len(head)) + pix.astype("<u2").tobytes())
    dir_pos = len(out)
    payload = struct.pack("<i", len(blocks)) + bytes(124)
    for (dims, _, pyr), pos in zip(blocks, positions):
        payload += entry(pos, dims, pyr)
    out += _segment(b"ZISRAWDIRECTORY", payload)
    struct.pack_into("<q", out, 32 + 52, dir_pos)
    open(path, "wb").write(bytes(out))


def _nd2(path, attrs, chunks, map_order=None):
    """An ND2 file of ``chunks`` (name, data) in file order; the chunk map
    lists them in ``map_order`` (indexes) and the attributes chunk is
    ``attrs``."""
    out, offsets = bytearray(), []
    for name, data in [(b"ImageAttributesLV!", attrs)] + chunks:
        offsets.append((name, len(out)))
        out += _nd2_chunk(name, data)
    order = map_order or range(len(offsets))
    map_data = b"".join(offsets[i][0] + struct.pack("<QQ", offsets[i][1], 0)
                        for i in order) + ND2_SIG + struct.pack("<QQ", 0, 0)
    map_pos = len(out)
    out += _nd2_chunk(ND2_SIG, map_data)
    out += ND2_SIG + struct.pack("<Q", map_pos)
    open(path, "wb").write(bytes(out))


def _attrs(w, h, comp, extra=b""):
    return (extra + _lv_uint("uiWidth", w) + _lv_uint("uiHeight", h)
            + _lv_uint("uiComp", comp) + _lv_uint("uiBpcInMemory", 16))


def _frame_chunk(i, frame):
    return (f"ImageDataSeq|{i}!".encode(),
            struct.pack("<d", 0.0) + frame.astype("<u2").tobytes())


def _czi_cases(tmp_path):
    """(path, channels) of every CZI layout the readers must agree on."""
    rng = np.random.RandomState(21)
    planes = [_u16(rng, 41, 53) for _ in range(2)]
    cases = []
    for name, kw in (("none", {}), ("mosaic", {"tile_split": 20}),
                     ("zstd0", {"compression": 5, "tile_split": 17}),
                     ("zstd1", {"compression": 6}),
                     ("hilo", {"compression": 6, "hilo": True,
                               "tile_split": 30}),
                     ("names", {"channel_names": ["DAPI", None]})):
        p = str(tmp_path / f"{name}.czi")
        write_czi(p, planes, **kw)
        cases.append((p, 2))
    s0, s1 = _u16(rng, 30, 40), _u16(rng, 30, 40)
    p = str(tmp_path / "scenes.czi")  # scene 1 listed first, far away
    _write_czi_blocks(p, [
        (dict(X=(500, 40), Y=(700, 30), C=(0, 1), S=(1, 1)),
         s1.astype("<u2").tobytes()),
        (dict(X=(0, 40), Y=(0, 30), C=(0, 1), S=(0, 1)),
         s0.astype("<u2").tobytes())])
    cases.append((p, 1))
    p = str(tmp_path / "timepoints.czi")  # T=1 listed first
    _write_czi_blocks(p, [
        (dict(X=(0, 40), Y=(0, 30), C=(0, 1), T=(1, 1)),
         s1.astype("<u2").tobytes()),
        (dict(X=(0, 40), Y=(0, 30), C=(0, 1), T=(0, 1)),
         s0.astype("<u2").tobytes())])
    cases.append((p, 1))
    p = str(tmp_path / "pyramid.czi")
    _czi_pyramid(p, _u16(rng, 24, 40))
    cases.append((p, 1))
    return cases


def _nd2_cases(tmp_path):
    rng = np.random.RandomState(22)
    cases = []
    p = str(tmp_path / "multi.nd2")
    write_nd2(p, [_u16(rng, 30, 44, 3)])
    cases.append((p, 3))
    p = str(tmp_path / "single.nd2")
    write_nd2(p, [_u16(rng, 20, 25, 1) for _ in range(3)])
    cases.append((p, 3))
    frames = [_u16(rng, 16, 18, 2) for _ in range(3)]
    junk = [(b"CustomJunk|x!", b"\x42" * 17)]
    chunks = []
    for i in reversed(range(3)):  # frames physically reversed
        chunks += junk + [_frame_chunk(i, frames[i])]
    p = str(tmp_path / "shuffled.nd2")
    _nd2(p, _attrs(18, 16, 2), chunks, map_order=[3, 1, 6, 0, 5, 2, 4])
    cases.append((p, 2))
    p = str(tmp_path / "prefix.nd2")  # uiWidthBytes before uiWidth
    _nd2(p, _attrs(26, 18, 1, extra=_lv_uint("uiWidthBytes", 52)),
         [_frame_chunk(0, _u16(rng, 18, 26, 1))])
    cases.append((p, 1))
    return cases


def _same_reads(path, ftype, channels):
    for c in range(channels):
        want = jax_slides.read_channel(path, ftype, c)
        np.testing.assert_array_equal(slides.read_channel(path, ftype, c),
                                      want)
        h = want.shape[0]
        with slides.open_channel_source(path, ftype, c) as src, \
                jax_slides.open_channel_source(path, ftype, c) as jsrc:
            assert (src.height, src.width) == want.shape
            for r0, n in ((-3, 9), (5, 11), (h - 4, 9)):
                np.testing.assert_array_equal(src.read_rows(r0, n),
                                              jsrc.read_rows(r0, n))
            assert src.stats(99.0) == jsrc.stats(99.0)
    with pytest.raises(IndexError):
        slides.read_channel(path, ftype, channels + 4)
    with pytest.raises(IndexError):
        jax_slides.read_channel(path, ftype, channels + 4)


def test_czi_layouts_read_as_jax_reads_them(tmp_path):
    """None, zstd0, zstd1 with and without hi-lo, mosaics, the first of
    several scenes and timepoints, pyramid sub-blocks skipped."""
    for path, n in _czi_cases(tmp_path):
        assert slides.sniff_format(path) == "czi"
        _same_reads(path, "czi", n)
        with CziFile(path) as cz:
            assert cz.channels() == n
    names = str(tmp_path / "names.czi")
    assert (slides.channel_names(names, "czi") == ["DAPI", None]
            == jax_slides.channel_names(names, "czi"))
    assert slides.resolve_channel_names(names, "czi", ["dapi"]) == [0]
    for p in (str(tmp_path / "none.czi"),):
        assert slides.channel_names(p, "czi") is None
        with pytest.raises(ValueError, match="no channel names"):
            slides.resolve_channel_names(p, "czi", ["DAPI"])


def test_nd2_layouts_read_as_jax_reads_them(tmp_path):
    """Multi-component and single-component frames, a chunk map out of
    file order with decoy chunks, a prefix key before its key."""
    for path, n in _nd2_cases(tmp_path):
        assert slides.sniff_format(path) == "nd2"
        _same_reads(path, "nd2", n)
    with Nd2File(str(tmp_path / "prefix.nd2")) as nd:
        assert (nd.width, nd.height) == (26, 18)
    with Nd2File(str(tmp_path / "shuffled.nd2")) as nd:
        assert nd.n_frames == 3
    assert slides.channel_names(str(tmp_path / "multi.nd2"), "nd2") is None


def _outcome(fn, path):
    try:
        return ("ok", fn(path, 0))
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return (type(e).__name__, None)


def test_truncated_and_fuzzed_containers_fail_as_in_jax(tmp_path):
    """Every prefix cut and byte corruption of a zstd1 hi-lo mosaic CZI
    and an ND2: the port raises exactly where the JAX reader raises, with
    the same exception class, and reads the same plane where it reads."""
    rng = np.random.RandomState(23)
    plane = _u16(rng, 24, 31)
    czi = str(tmp_path / "t.czi")
    write_czi(czi, [plane], compression=6, hilo=True, tile_split=11)
    nd2 = str(tmp_path / "t.nd2")
    write_nd2(nd2, [np.repeat(plane[:, :, None], 2, axis=2)])
    fuzz = np.random.RandomState(1234)
    for path, ours, theirs in (
            (czi, slides.read_channel, jax_slides.read_channel),
            (nd2, slides.read_channel, jax_slides.read_channel)):
        ftype = path[-3:]
        blob = open(path, "rb").read()
        variants = [blob[:cut] for cut in sorted(set(
            [0, 1, 7, 40, len(blob) - 1]
            + list(fuzz.randint(2, len(blob), 16))))]
        for _ in range(24):
            b = bytearray(blob)
            for pos in fuzz.randint(0, len(blob), fuzz.randint(1, 9)):
                b[pos] ^= 0xFF
            variants.append(bytes(b))
        bad = str(tmp_path / f"fuzz.{ftype}")
        for v in variants:
            open(bad, "wb").write(v)
            a = _outcome(lambda p, c: ours(p, ftype, c), bad)
            b = _outcome(lambda p, c: theirs(p, ftype, c), bad)
            assert a[0] == b[0], (len(v), a[0], b[0])
            if a[0] == "ok":
                np.testing.assert_array_equal(a[1], b[1])
                assert a[1].nbytes <= 1 << 26


@pytest.mark.parametrize("compression,error,match", [
    (4, NotImplementedError, "JPEG XR.*compression=4"),
    (2, ValueError, "JPEG sub-block at 0x.*failed to decode"),
])
def test_jxr_and_jpeg_sub_blocks_refuse_at_open(tmp_path, compression,
                                                error, match):
    """JPEG XR has no decoder under the import rule: the plane refuses
    when it is opened, before any source is handed out.  A JPEG payload that does not decode raises
    ``ValueError`` when it is read, as in the JAX reader.  Both name the
    file and the block; never a blank plane."""
    path = str(tmp_path / "j.czi")
    _write_czi_blocks(path, [(dict(X=(0, 8), Y=(0, 8), C=(0, 1)),
                              bytes(range(128)))],
                      pixel_type=0, compression=compression)

    def windowed():
        with slides.open_channel_source(path, "czi", 0) as src:
            return src.read_rows(0, 8)

    # JPEG XR must refuse at open itself; the JPEG block once it is read.
    opened = ((lambda: slides.open_channel_source(path, "czi", 0))
              if compression == 4 else windowed)
    for call in (lambda: slides.read_channel(path, "czi", 0), opened):
        with pytest.raises(error, match=match) as e:
            call()
        assert "j.czi" in str(e.value)
    if compression == 2:
        with pytest.raises(ValueError, match="failed to decode"):
            jax_slides.read_channel(path, "czi", 0)


def _outputs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _cli_pair(tmp_path, src, flags):
    """Both CLIs on ``src``: the same files, every page within 1 uint8
    level; returns the port's Probabilities pages."""
    common = [src, "--tool", "unmicst-legacy", "--model", "blobDemo",
              "--modelRoot", MODELS, "--stackOutput", *flags]
    out_j, out_t = str(tmp_path / "j"), str(tmp_path / "t")
    assert jax_cli.main(common + ["--outputPath", out_j]) == 0
    assert cli.main(common + ["--outputPath", out_t], device="cpu") == 0
    files = _outputs(out_t)
    assert len(files) == 2 and files == _outputs(out_j)
    for rel in files:
        a, b = os.path.join(out_j, rel), os.path.join(out_t, rel)
        assert num_pages(a) == num_pages(b)
        for k in range(num_pages(a)):
            x, y = jax_imread(a, k).astype(int), imread(b, k).astype(int)
            assert x.shape == y.shape and np.abs(x - y).max() <= 1, (rel, k)
    prob = os.path.join(out_t, [f for f in files if "Prob" in f][0])
    return [imread(prob, k) for k in range(3)]


def _blobs(shape, seed):
    rng = np.random.RandomState(seed)
    img = rng.rand(*shape) * 0.25
    rr, cc = np.ogrid[: shape[0], : shape[1]]
    for _ in range(10):
        r, c = rng.randint(10, shape[0] - 10), rng.randint(10, shape[1] - 10)
        img[(rr - r) ** 2 + (cc - c) ** 2 < rng.randint(20, 70)] = 0.8
    return (img * 60000).astype(np.uint16)


def test_cli_czi_by_channel_name_matches_jax(tmp_path):
    """A zstd1 hi-lo mosaic CZI, the channel picked by its name in the
    metadata XML; and the same pixels as a TIFF give the same pages."""
    planes = [_blobs((176, 144), 1), _blobs((176, 144), 2)]
    src = str(tmp_path / "n.czi")
    write_czi(src, planes, compression=6, hilo=True, tile_split=64,
              channel_names=["junk", "DNA"])
    got = _cli_pair(tmp_path, src, ["--channelName", "DNA"])
    tif = str(tmp_path / "n.tif")
    with TiffWriter(tif) as tw:
        tw.write(planes[1])
    assert cli.main([tif, "--tool", "unmicst-legacy", "--model", "blobDemo",
                     "--modelRoot", MODELS, "--stackOutput", "--outputPath",
                     str(tmp_path / "tif")], device="cpu") == 0
    for k in range(3):
        np.testing.assert_array_equal(
            got[k], imread(str(tmp_path / "tif" / "n_Probabilities_1.tif"),
                           k))


def test_cli_nd2_matches_jax(tmp_path):
    frame = np.stack([_blobs((160, 128), 3), _blobs((160, 128), 4)], -1)
    src = str(tmp_path / "m.nd2")
    write_nd2(src, [frame])
    _cli_pair(tmp_path, src, ["--channel", "2"])


def test_cli_streams_a_czi_as_jax_does(tmp_path):
    """``--engine streaming`` on a zstd0 mosaic CZI: within 1 level of the
    JAX CLI's stream and of the port's whole engine."""
    src = str(tmp_path / "s.czi")
    plane = _blobs((150, 120), 5)
    write_czi(src, [plane], compression=5, tile_split=64)
    got = _cli_pair(tmp_path, src, ["--engine", "streaming"])
    assert cli.main([src, "--tool", "unmicst-legacy", "--model", "blobDemo",
                     "--modelRoot", MODELS, "--stackOutput", "--outputPath",
                     str(tmp_path / "w"), "--engine", "whole"],
                    device="cpu") == 0
    for k in range(3):
        whole = imread(str(tmp_path / "w" / "s_Probabilities_1.tif"), k)
        assert np.abs(whole.astype(int) - got[k].astype(int)).max() <= 1
