"""Batch sweeps in the port (``unmicst_tpu_torch.batch``) against the JAX
package's (``unmicst_tpu.batch``) on the same slide trees, with the
committed ``models/blobDemo`` (3 classes): discovery, pages within 1 uint8
level, cursors that resume across the two packages, shards, per-slide
failures, pinned ranges, channel names, streamed and sharded slides, the
refusals, and ``deploy_folder``'s PNGs.  The port runs on the CPU."""

import os
import shutil
import struct
import zlib

import numpy as np
import pytest

from unmicst_tpu import batch as jax_batch
from unmicst_tpu.io.tiff import TiffWriter, imwrite
from unmicst_tpu.io.tiff import imread as jax_imread
from unmicst_tpu_torch import batch
from unmicst_tpu_torch.io.tiff import imread, num_pages
from unmicst_tpu_torch.runtime.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "models", "blobDemo")
PAGES = ("slide_ContoursPM_1.tif", "slide_NucleiPM_1.tif")


def _blobs(shape, seed, top=60000):
    rng = np.random.RandomState(seed)
    img = rng.rand(*shape) * 0.3
    rr, cc = np.ogrid[: shape[0], : shape[1]]
    for _ in range(6):
        r, c = rng.randint(8, shape[0] - 8), rng.randint(8, shape[1] - 8)
        img[(rr - r) ** 2 + (cc - c) ** 2 < rng.randint(16, 64)] = 0.85
    return (img * top).astype(np.uint16)


def _make_tree(root, tma=False, shape=(96, 80)):
    """``tests/test_batch.py``'s tree: two samples, a stray dir, and with
    ``tma`` a ``TMA_MAP.tif`` that discovery must leave out."""
    slides = []
    for i, name in enumerate(["exemplar-001", "exemplar-002"]):
        d = os.path.join(root, name, "dearray" if tma else "registration")
        os.makedirs(d)
        fname = "core1.tif" if tma else "slide.ome.tif"
        img = _blobs(shape, i)
        imwrite(os.path.join(d, fname), img, bigtiff=False)
        if tma:
            imwrite(os.path.join(d, "TMA_MAP.tif"), img, bigtiff=False)
        slides.append(os.path.join(d, fname))
    os.makedirs(os.path.join(root, "not-a-sample"))
    return slides


def _same_pages(dir_j, dir_t, names=PAGES, bar=1):
    for name in names:
        a, b = os.path.join(dir_j, name), os.path.join(dir_t, name)
        assert num_pages(a) == num_pages(b) == (2 if "Contours" in name
                                                else 1)
        for page in range(num_pages(a)):
            x, y = jax_imread(a, page), imread(b, page)
            assert x.shape == y.shape and x.dtype == y.dtype == np.uint8
            assert np.abs(x.astype(int) - y.astype(int)).max() <= bar, name


def _sweep(slides, out, **kw):
    return batch.run_sweep(slides, MODEL, out, verbose=False, device="cpu",
                           **kw)


@pytest.mark.parametrize("tma", [False, True])
def test_discovery_matches_jax(tmp_path, tma):
    slides = _make_tree(str(tmp_path), tma=tma)
    found = batch.discover_slides(str(tmp_path), tma=tma)
    assert found == slides == jax_batch.discover_slides(str(tmp_path),
                                                        tma=tma)
    assert not any("TMA_MAP" in s for s in found)


def test_sweep_pages_match_jax_and_the_output_contract(tmp_path):
    slides = _make_tree(str(tmp_path))
    rep_j = jax_batch.run_sweep(slides, MODEL, verbose=False)
    for s in slides:  # the per-sample prob_maps dirs of the reference
        out = os.path.join(os.path.dirname(os.path.dirname(s)), "prob_maps")
        shutil.move(out, out + "_jax")
    rep_t = batch.run_sweep(slides, MODEL, verbose=False, device="cpu")
    assert rep_t.completed == rep_j.completed == slides
    assert not rep_t.failed and rep_t.mpx_total == rep_j.mpx_total
    assert set(rep_t.seconds) == set(rep_t.infer_seconds) == set(slides)
    for s in slides:
        out = os.path.join(os.path.dirname(os.path.dirname(s)), "prob_maps")
        _same_pages(out + "_jax", out)
        # the preview page of ContoursPM is the raw plane's
        np.testing.assert_array_equal(
            imread(os.path.join(out, PAGES[0]), 1),
            jax_imread(os.path.join(out + "_jax", PAGES[0]), 1))


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_cursors_resume_across_packages(tmp_path, first):
    """A sweep one package finished, the other skips: the same cursor file
    names and records.  A resumed run keeps its shard's earlier records."""
    slides = _make_tree(str(tmp_path))
    out = str(tmp_path / "out")
    run_j = lambda s, **kw: jax_batch.run_sweep(  # noqa: E731
        s, MODEL, out, verbose=False, **kw)
    run_t = lambda s, **kw: _sweep(s, out, **kw)  # noqa: E731
    a, b = (run_j, run_t) if first == "jax" else (run_t, run_j)
    assert a(slides[:1]).completed == slides[:1]
    rep = b(slides)
    assert rep.skipped == slides[:1] and rep.completed == slides[1:]
    assert sorted(batch._load_done(out)) == sorted(slides)
    assert a(slides).skipped == slides
    assert b(slides, resume=False).completed == slides


def test_shards_split_the_sweep_and_the_index_is_checked(tmp_path):
    slides = _make_tree(str(tmp_path))
    out = str(tmp_path / "out")
    r0 = _sweep(slides, out, shard_index=0, num_shards=2)
    r1 = _sweep(slides, out, shard_index=1, num_shards=2)
    assert r0.completed == slides[:1] and r1.completed == slides[1:]
    assert os.path.exists(batch._cursor_path(out, 1))
    assert batch._cursor_path(out, 1) == jax_batch._cursor_path(out, 1)
    assert batch._cursor_path(out) == jax_batch._cursor_path(out)
    for bad in (2, -1):
        with pytest.raises(ValueError, match="shard_index"):
            _sweep(slides, out, shard_index=bad, num_shards=2)


def test_a_corrupt_slide_is_recorded_and_batch_main_exits_2(tmp_path):
    slides = _make_tree(str(tmp_path))
    bad = tmp_path / "exemplar-003" / "registration" / "bad.ome.tif"
    bad.parent.mkdir(parents=True)
    bad.write_bytes(open(slides[0], "rb").read()[:300])  # truncated
    rep = _sweep(slides + [str(bad)], str(tmp_path / "o"))
    assert rep.failed == [str(bad)] and rep.completed == slides
    assert batch.batch_main([str(tmp_path), "--modelRoot",
                             os.path.dirname(MODEL), "--model", "blobDemo",
                             "--noResume", "--stats"], device="cpu") == 2
    assert batch.batch_main([str(tmp_path / "nothing"), "--model",
                             "blobDemo", "--modelRoot",
                             os.path.dirname(MODEL)], device="cpu") == 1


def test_pinned_range_matches_jax(tmp_path):
    """One raw-unit range for every slide, as JAX pins it; pinning a
    slide's own (min, max) gives its derived pages."""
    slides = _make_tree(str(tmp_path))
    pin = (1500.0, 42000.0)
    jax_batch.run_sweep(slides, MODEL, str(tmp_path / "j"), verbose=False,
                        in_range=pin)
    _sweep(slides, str(tmp_path / "t"), in_range=pin)
    _same_pages(str(tmp_path / "j"), str(tmp_path / "t"))
    raw = imread(slides[0])
    _sweep(slides[:1], str(tmp_path / "own"),
           in_range=(float(raw.min()), float(raw.max())))
    _sweep(slides[:1], str(tmp_path / "derived"))
    for name in PAGES:
        np.testing.assert_array_equal(imread(str(tmp_path / "own" / name)),
                                      imread(str(tmp_path / "derived" /
                                                 name)))
    with pytest.raises(SystemExit, match="intensityRange"):
        batch.batch_main([str(tmp_path), "--intensityRange", "5"],
                         device="cpu")


def _ome(names):
    chans = "".join(f'<Channel ID="Channel:0:{i}" Name="{n}"/>'
                    for i, n in enumerate(names))
    return ('<?xml version="1.0"?><OME xmlns="http://www.openmicroscopy.org/'
            'Schemas/OME/2016-06"><Image ID="Image:0"><Pixels ID="Pixels:0" '
            f'DimensionOrder="XYCZT" SizeC="{len(names)}" SizeZ="1" '
            'SizeT="1" SizeX="80" SizeY="96" Type="uint16">'
            f"{chans}</Pixels></Image></OME>")


def test_channel_name_resolves_per_slide(tmp_path):
    """The DNA channel sits at index 1 in one file and 0 in the other; a
    file without it fails alone.  Pages and suffixes match JAX's."""
    target, junk = _blobs((96, 80), 5), np.zeros((96, 80), np.uint16)
    slides = []
    for name, order in (("exemplar-001", ["CD3", "DNA"]),
                        ("exemplar-002", ["DNA", "CD3"]),
                        ("exemplar-003", ["CD3", "CD8"])):
        d = tmp_path / name / "registration"
        d.mkdir(parents=True)
        path = str(d / "slide.ome.tif")
        with TiffWriter(path, bigtiff=False) as tw:
            for i, ch in enumerate(order):
                tw.write(target if ch == "DNA" else junk,
                         description=_ome(order) if i == 0 else None)
        slides.append(path)
    rep_j = jax_batch.run_sweep(slides, MODEL, str(tmp_path / "j"),
                                verbose=False, channel_name="dna",
                                resume=False)
    rep_t = _sweep(slides, str(tmp_path / "t"), channel_name="dna",
                   resume=False)
    assert rep_t.failed == rep_j.failed == slides[2:]
    assert rep_t.completed == slides[:2]
    # both slides write into one dir: the second (index 0) wrote _1, the
    # first (index 1) _2
    _same_pages(str(tmp_path / "j"), str(tmp_path / "t"),
                [f"slide_{k}_{c}.tif" for k in ("ContoursPM", "NucleiPM")
                 for c in (1, 2)])
    np.testing.assert_array_equal(
        imread(str(tmp_path / "t" / "slide_NucleiPM_1.tif")),
        imread(str(tmp_path / "t" / "slide_NucleiPM_2.tif")))


@pytest.mark.parametrize("sf", [1.0, 0.5])
def test_streamed_slides_match_jax(tmp_path, sf):
    """The stream threshold lowered below the slides: the port streams as
    JAX does, at scale 1 and through the resampled source at 0.5."""
    slides = _make_tree(str(tmp_path), shape=(140, 100))
    jax_batch.run_sweep(slides, MODEL, str(tmp_path / "j"), verbose=False,
                        stream_above_px=1, scaling_factor=sf)
    rep = _sweep(slides, str(tmp_path / "t"), stream_above_px=1,
                 scaling_factor=sf)
    assert rep.completed == slides
    _same_pages(str(tmp_path / "j"), str(tmp_path / "t"))
    _sweep(slides, str(tmp_path / "w"), scaling_factor=sf)  # whole engine
    for name in PAGES:
        d = np.abs(imread(str(tmp_path / "t" / name)).astype(int)
                   - imread(str(tmp_path / "w" / name)).astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 0.02


def test_sharded_sweep_matches_the_single_rank_sweep(tmp_path):
    """Four ranks sharing the CPU column-shard every stripe (the seams
    through the plain ring copy) and match the one-rank stream."""
    slides = _make_tree(str(tmp_path), shape=(140, 300))
    mesh = make_mesh(devices=["cpu"] * 4)
    rep = _sweep(slides, str(tmp_path / "s"), mesh=mesh)
    _sweep(slides, str(tmp_path / "one"), stream_above_px=1)
    assert rep.completed == slides
    for name in PAGES:
        a = imread(str(tmp_path / "s" / name)).astype(int)
        b = imread(str(tmp_path / "one" / name)).astype(int)
        assert np.abs(a - b).max() <= 1
    assert batch.batch_main([str(tmp_path), "--model", "blobDemo",
                             "--modelRoot", os.path.dirname(MODEL),
                             "--engine", "sharded", "--meshShape", "4",
                             "--outputPath", str(tmp_path / "cli")],
                            device="cpu") == 0
    for name in PAGES:
        np.testing.assert_array_equal(imread(str(tmp_path / "cli" / name)),
                                      imread(str(tmp_path / "s" / name)))


def test_a_two_class_model_is_refused_before_any_read(tmp_path):
    model = tmp_path / "twoClass"
    shutil.copytree(os.path.join(REPO, "tests", "fixtures", "oracle_cyto2"),
                    model)
    import json
    import pickle

    with open(model / "hp.json") as f:
        hp = json.load(f)
    for name, obj in (("hp.data", hp), ("datasetMean.data", 0.2),
                      ("datasetStDev.data", 0.15)):
        with open(model / name, "wb") as f:
            pickle.dump(obj, f)
    missing = str(tmp_path / "exemplar-001" / "registration" / "x.ome.tif")
    with pytest.raises(ValueError, match="3-class model"):
        batch.run_sweep([missing], str(model), device="cpu")
    assert not os.path.exists(os.path.dirname(missing))


@pytest.mark.parametrize("flags,match,kw", [
    (["--usePyramid"], "M14", {"use_pyramid": True}),
    (["--pyramidOutput"], "M14", {"pyramid_output": True}),
    (["--compressOutput", "zstd"], "M14", {"compress_output": "zstd"}),
    (["--engine", "sharded", "--usePyramid"], "does not combine",
     {"use_pyramid": True}),
])
def test_unported_flags_refuse(tmp_path, flags, match, kw):
    _make_tree(str(tmp_path))
    with pytest.raises(SystemExit, match=match):
        batch.batch_main([str(tmp_path), "--model", "blobDemo",
                          "--modelRoot", os.path.dirname(MODEL), *flags],
                         device="cpu")
    with pytest.raises(NotImplementedError, match="M14"):
        batch.run_sweep([], MODEL, device="cpu", **kw)
    assert not any(tmp_path.rglob("prob_maps"))


def test_batch_main_needs_a_card_unless_cpu_is_asked_for(tmp_path,
                                                         monkeypatch):
    import torch

    _make_tree(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.batch_main([str(tmp_path), "--model", "blobDemo",
                          "--modelRoot", os.path.dirname(MODEL)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.run_sweep([], MODEL)
    assert not any(tmp_path.rglob("prob_maps"))


def _read_png(path):
    """An 8-bit grayscale PNG with filter-0 rows (what the port writes),
    decoded with the standard library."""
    blob = open(path, "rb").read()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(blob):
        (n,) = struct.unpack_from(">I", blob, pos)
        kind, body = blob[pos + 4 : pos + 8], blob[pos + 8 : pos + 8 + n]
        assert struct.unpack_from(">I", blob, pos + 8 + n)[0] == (
            zlib.crc32(kind + body) & 0xFFFFFFFF)
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
    w, h, depth, color, _, _, interlace = hdr
    assert (depth, color, interlace) == (8, 0, 0)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    assert not rows[:, 0].any()  # filter type 0 on every row
    return rows[:, 1:]


def test_deploy_folder_pngs_match_jax(tmp_path):
    pil = pytest.importorskip("PIL.Image")  # the JAX side writes with PIL
    im_dir = tmp_path / "corpus"
    im_dir.mkdir()
    for i in range(3):
        imwrite(str(im_dir / f"I{i:05d}_Img.tif"), _blobs((64, 64), 10 + i),
                bigtiff=False)
    jax_batch.deploy_folder(str(im_dir), 3, MODEL, str(tmp_path / "j"))
    batch.deploy_folder(str(im_dir), 3, MODEL, str(tmp_path / "t"),
                        device="cpu")
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    for i in range(1, 4):
        for kind in ("Im", "PM"):
            name = f"I{i:05d}_{kind}.png"
            got = _read_png(str(tmp_path / "t" / name))
            want = np.asarray(pil.open(str(tmp_path / "j" / name)))
            assert got.shape == want.shape == (64, 64)
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            np.testing.assert_array_equal(
                np.asarray(pil.open(str(tmp_path / "t" / name))), got)
