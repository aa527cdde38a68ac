"""Port streaming engine, its column-sharded form and windowed slide IO
against the JAX package on the CPU.

``unmicst_tpu_torch.runtime.pipeline.StreamingEngine`` (``infer``,
``infer_sharded``) against JAX's on the same raw uint16 slides and weights,
and against the port's whole-slide ``infer_slide``; K2's stripe entry (plain
version) against the JAX composition; ``read_region``, the streamed
statistics and the streamed preview against their JAX counterparts; the
CLI's ``--engine streaming|sharded|auto`` against the JAX CLI.  The port
runs on the CPU (ranks share it), where the kernels take their plain
versions.  Bars: float32 at most 1 uint8 level; the bfloat16 default at
tests/test_torch_infer.py's bar (at most 2 levels on at most 5% of
pixels), on trained weights.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmicst_tpu import cli as jax_cli
from unmicst_tpu.core import tiler as jt
from unmicst_tpu.core import unet as junet
from unmicst_tpu.core.checkpoint import load_params_for_bundle as jax_params
from unmicst_tpu.core.hp import HParams as JaxHParams
from unmicst_tpu.core.hp import load_model_dir as jax_model_dir
from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.io.tiff import TiffWriter, imread as jax_imread
from unmicst_tpu.runtime.pipeline import StreamingEngine as JaxStream
from unmicst_tpu_torch import cli, kernels
from unmicst_tpu_torch.core import tiler as tt
from unmicst_tpu_torch.core.checkpoint import load_params_for_bundle, params_from_jax
from unmicst_tpu_torch.core.hp import HParams, load_model_dir
from unmicst_tpu_torch.infer import InferenceEngine
from unmicst_tpu_torch.io import slides
from unmicst_tpu_torch.io import tiff as port_tiff
from unmicst_tpu_torch.runtime.mesh import make_mesh
from unmicst_tpu_torch.runtime.pipeline import StreamingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
# the net of tests/test_pipeline.py
_KW = dict(im_size=32, n_channels=1, n_classes=3, n_out0=6, ks=3,
           n_extra_convs=0, n_layers=2, batch_size=8, std_dev0=0.5)
_NET = {}


def _net():
    """(JAX hp, JAX params, port hp, port state)."""
    if not _NET:
        jhp, hp = JaxHParams(**_KW), HParams(**_KW)
        params = junet.init_params(jax.random.PRNGKey(11), jhp, "legacy")
        state = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                hp, "legacy")
        _NET["net"] = (jhp, params, hp, state)
    return _NET["net"]


def _engines(stripe_rows):
    """float32 (JAX stream, port stream, port whole engine)."""
    jhp, params, hp, state = _net()
    return (JaxStream(jhp, params, "legacy", 0.3, 0.2, compute_dtype=None,
                      stripe_tile_rows=stripe_rows),
            StreamingEngine(hp, state, "legacy", 0.3, 0.2, compute_dtype=None,
                            stripe_tile_rows=stripe_rows, device="cpu"),
            InferenceEngine(hp, state, "legacy", 0.3, 0.2, device="cpu"))


def _raw(shape, seed=0):
    return (np.random.RandomState(seed).rand(*shape) * 60000).astype(
        np.uint16)


def _close(a, b, levels=1):
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= levels, d.max()


# (shape, stripe tile rows): S of 1, 2 and 5 (tests/test_pipeline.py); the
# stripe-coverage edge, height mod sub > sub - margin (sub 24, margin 4:
# 165 mod 24 = 21, and 144 = 6 * 24), where ceil(npr / S) stripes would
# miss the last margin rows; and one stripe taller than the slide
@pytest.mark.parametrize("shape,stripe_rows", [
    ((150, 90), 1), ((150, 90), 2), ((150, 90), 5), ((165, 70), 2),
    ((144, 90), 3), ((90, 70), 16),
])
def test_stream_matches_jax_stream_and_whole(shape, stripe_rows):
    js, ts, whole = _engines(stripe_rows)
    raw = _raw(shape, seed=shape[0] + stripe_rows)
    got = ts.infer(raw)
    _close(got, js.infer(raw))
    _close(got, whole.infer_slide(raw))
    assert kernels.blend_fold_stripe.launches == 0  # plain on the CPU


def test_stream_options_match_jax():
    """outlier, rescale=False (the solo quirk), classes, precomputed stats,
    uint8 and the float32 parity cast."""
    js, ts, _ = _engines(2)
    raw = _raw((130, 80), seed=3)
    for kw in ({"outlier": 99.0}, {"rescale": False}, {"classes": (2, 0)},
               {"stats": (1000.0, 50000.0)}):
        _close(ts.infer(raw, **kw), js.infer(raw, **kw))
    u8 = (raw // 256).astype(np.uint8)
    _close(ts.infer(u8), js.infer(u8))
    f32 = raw.astype(np.float32) + 0.5
    _close(ts.infer(f32), js.infer(f32))
    np.testing.assert_array_equal(ts.infer(raw, classes=(1,))[0],
                                  ts.infer(raw)[1])


def test_stream_bfloat16_default_matches_jax_and_whole():
    """The default compute dtype (bfloat16) on trained weights (blobDemo):
    against the JAX stream's default and the port's bf16 whole engine."""
    demo = os.path.join(MODELS, "blobDemo")
    jb, tb = jax_model_dir(demo), load_model_dir(demo)
    params = load_params_for_bundle(tb)
    js = JaxStream.from_bundle(jb, jax_params(jb), stripe_tile_rows=2)
    ts = StreamingEngine.from_bundle(tb, params, stripe_tile_rows=2,
                                     device="cpu")
    assert ts.compute_dtype == torch.bfloat16
    whole = InferenceEngine.from_bundle(tb, params, device="cpu",
                                        compute_dtype=torch.bfloat16)
    rng = np.random.RandomState(4)
    img = rng.rand(170, 140) * 12000
    rr, cc = np.ogrid[:170, :140]
    for _ in range(8):
        r, c = rng.randint(10, 160), rng.randint(10, 130)
        img[(rr - r) ** 2 + (cc - c) ** 2 < rng.randint(16, 64)] = 40000
    raw = img.astype(np.uint16)
    got = ts.infer(raw, outlier=99.5)
    for other in (js.infer(raw, outlier=99.5),
                  whole.infer_slide(raw, outlier=99.5)):
        d = np.abs(got.astype(int) - other.astype(int))
        assert d.max() <= 2 and (d > 0).mean() <= 0.05, (d.max(),
                                                         (d > 0).mean())


@pytest.mark.parametrize("n", [2, 3, 8])
def test_sharded_matches_jax_sharded_and_stream(n):
    """infer_sharded over n ranks sharing the CPU == JAX's over n CPU
    devices and == the port's single-rank stream (tests/test_pipeline.py:
    278-304), with rescale=False and classes."""
    from jax.sharding import Mesh

    js, ts, _ = _engines(2)
    raw = _raw((155, 230), seed=n)
    jmesh = Mesh(np.array(jax.devices()[:n]), ("d",))
    mesh = make_mesh(devices=["cpu"] * n)
    single = ts.infer(raw)
    got = ts.infer_sharded(raw, mesh)
    _close(got, js.infer_sharded(raw, jmesh, axis="d"))
    _close(got, single)
    _close(ts.infer_sharded(raw, mesh, rescale=False),
           js.infer_sharded(raw, jmesh, axis="d", rescale=False))
    sub = ts.infer_sharded(raw, mesh, classes=(1, 2))
    np.testing.assert_array_equal(sub, got[1:])


@pytest.mark.parametrize("shape,stripe_rows", [((300, 230), 3),
                                               ((130, 70), 2), ((97, 33), 7)])
def test_row_and_column_masks_match_jax(shape, stripe_rows):
    """The stripe's tile-row mask and the sharded ranks' tile-column masks,
    now made on the device, hold the values of the JAX engine's
    ``row_ids``/``col_ids`` masks (``pipeline.py:262-263,658-661``)."""
    from unmicst_tpu_torch.runtime.pipeline import _col_mask

    engine = StreamingEngine(HParams(**_KW), {}, "legacy", 0.3, 0.2,
                             stripe_tile_rows=stripe_rows, device="cpu")
    plan = engine._plan(*shape)
    for s in range(plan.n_stripes):
        row_ids = s * plan.S - 1 + np.arange(plan.S + 1)
        want = ((row_ids >= 0) & (row_ids < plan.grid.npr)).astype(np.float32)
        got = engine._row_mask(plan, s, torch.device("cpu"))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    npc = plan.grid.npc
    for n in (1, 3, 4):
        c_dev = -(-npc // n)
        for d in range(n):
            want = (d * c_dev + np.arange(c_dev) < npc).astype(np.float32)
            got = _col_mask(npc, c_dev, d, "cpu")
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)


def _stripe_jax(w, win, grid, rmask, cmask, addend, cls):
    """The JAX composition of a column-sharded stripe's tail."""
    wt = (win[None, None] * rmask[:, None, None, None]
          * cmask[None, :, None, None])
    jg = jt.make_grid(grid.height, grid.width, grid.patch, grid.margin)
    t5 = w.reshape(grid.npr, grid.npc, 3, grid.patch, grid.patch)
    strip = np.asarray(jt.fold(jnp.asarray(t5.transpose(0, 1, 3, 4, 2)), jg))
    count = np.asarray(jt.fold(jnp.asarray(wt), jg))
    acc = np.concatenate([strip, count[..., None]], -1)
    acc[:, : addend.shape[1]] += addend
    pm = acc[..., :3] / np.maximum(acc[..., 3:], 1e-12)
    return acc, pm[..., cls]


def test_stripe_entry_plain_matches_jax_composition():
    """K2's stripe entry (plain): masked-window count, addend, row/column
    window, every mode, against fold/count/divide in JAX."""
    rng = np.random.RandomState(7)
    g = tt.make_grid(3 * 24, 4 * 24, 32, 4)
    win = tt.ramp_window(32, 4)
    rmask = np.array([0, 1, 1], np.float32)
    cmask = np.array([1, 1, 1, 0], np.float32)
    w = (rng.rand(g.num_tiles, 3, 32, 32) * win
         * np.repeat(rmask[:, None] * cmask[None], 1).reshape(-1)[
             :, None, None, None]).astype(np.float32)
    addend = rng.rand(g.padded_height, 8, 4).astype(np.float32)
    acc, pm = _stripe_jax(w, win, g, rmask, cmask, addend, [2, 0])
    rows, cols = (24, 48), (4, 80)
    kw = dict(row_mask=torch.from_numpy(rmask),
              col_mask=torch.from_numpy(cmask), classes=(2, 0))
    args = (torch.from_numpy(w), torch.from_numpy(win), g, rows, cols)
    # the addend carries the kept classes and the count, in that order
    add = torch.from_numpy(addend[24:72][..., [2, 0, 3]].copy())
    ref = pm[24:72, 4:84]
    got = kernels.blend_fold_stripe(*args, addend=add, mode="f32", **kw)
    np.testing.assert_allclose(got.numpy(), ref.transpose(2, 0, 1), atol=1e-6)
    u8 = kernels.blend_fold_stripe(*args, addend=add, **kw)
    # random tiles are no partition of unity: p can pass 1, and the kernel
    # saturates where numpy's cast would wrap
    np.testing.assert_array_equal(
        u8.numpy(),
        np.clip(ref * 255.0, 0, 255).astype(np.uint8).transpose(2, 0, 1))
    raw = kernels.blend_fold_stripe(*args, addend=add, mode="raw", **kw)
    np.testing.assert_allclose(raw.numpy(), acc[24:72, 4:84][..., [2, 0, 3]],
                               atol=1e-6)
    with pytest.raises(ValueError, match="outside"):
        kernels.blend_fold_stripe(torch.from_numpy(w), torch.from_numpy(win),
                                  g, (0, 200), cols)
    with pytest.raises(ValueError, match="addend"):
        kernels.blend_fold_stripe(*args, addend=add[:, :, :2].contiguous(),
                                  **kw)


def _write(path, x, **kw):
    with TiffWriter(path, bigtiff=False, **kw) as tw:
        tw.write(x, **({"tile": (48, 64)} if kw.pop("tiled", False) else {}))


@pytest.mark.parametrize("layout", ["strips", "tiles", "tiles-deflate"])
def test_read_region_matches_read_page(tmp_path, layout):
    x = _raw((203, 171), seed=9)
    fn = str(tmp_path / "r.tif")
    with TiffWriter(fn, bigtiff=False,
                    compression="deflate" if "deflate" in layout else None,
                    ) as tw:
        if layout == "strips":
            tw.write(x)
        else:
            tw.write(x, tile=(48, 64))
    with port_tiff.TiffFile(fn) as tf:
        assert tf.pages[0].tiled == (layout != "strips")
        whole = tf.read_page(0)
        np.testing.assert_array_equal(whole, x)
        for r0, c0, nr, nc in [(0, 0, 1, 171), (50, 17, 60, 100),
                               (190, 160, 40, 30), (0, 0, 203, 171)]:
            got = tf.read_region(0, r0, c0, nr, nc)
            want = np.zeros((nr, nc), x.dtype)
            want[: max(0, min(nr, 203 - r0)), : max(0, min(nc, 171 - c0))] = \
                x[r0 : r0 + nr, c0 : c0 + nc]
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16])
@pytest.mark.parametrize("outlier", [-1, 99.5])
def test_streamed_stats_match_jax_and_numpy(dtype, outlier):
    rng = np.random.RandomState(2)
    info = np.iinfo(dtype)
    x = rng.randint(info.min, info.max, (97, 61)).astype(dtype)

    def read_rows(r0, n):
        return x[r0 : r0 + n]

    got = slides._streamed_int_stats(read_rows, 97, 61, dtype, outlier,
                                     with_max=True)
    assert got == jax_slides._streamed_int_stats(read_rows, 97, 61, dtype,
                                                 outlier, with_max=True)
    hi = np.percentile(x, outlier) if outlier != -1 else x.max()
    assert got[0] == x.min() and got[2] == x.max()
    assert abs(got[1] - hi) < 1e-9


def test_tiff_sources_stream_like_arrays(tmp_path):
    """(TiffFile, page) and the windowed channel source stream exactly
    like the array, from strips and tiles; stats and preview match JAX."""
    _, ts, _ = _engines(2)
    raw = _raw((120, 77), seed=5)
    ref = ts.infer(raw)
    for name, tile in [("s.tif", None), ("t.tif", (32, 48))]:
        fn = str(tmp_path / name)
        with TiffWriter(fn, bigtiff=False) as tw:
            tw.write(raw, **({"tile": tile} if tile else {}))
        with port_tiff.TiffFile(fn) as tf:
            np.testing.assert_array_equal(ts.infer((tf, 0)), ref)
            assert ts.global_stats((tf, 0), 99.0) == ts.global_stats(raw, 99.0)
        with slides.open_channel_source(fn, "tif", 0) as src:
            np.testing.assert_array_equal(ts.infer(src), ref)
            with jax_slides.open_channel_source(fn, "tif", 0) as jsrc:
                assert src.stats(99.0, with_max=True) == jsrc.stats(
                    99.0, with_max=True)
                np.testing.assert_array_equal(slides.preview_u8(src),
                                              jax_slides.preview_u8(jsrc))


def test_streaming_refuses_unported_paths():
    """Out-of-range classes refuse.  The int8 mode (M11), which refused
    here before, runs now: the quantized stream against the quantized
    whole engine on the stream's own QuantState, at most 1 level apart
    (the bar of ``tests/test_pipeline.py``'s JAX pair; measured 0)."""
    _, _, hp, state = _net()
    qs = StreamingEngine(hp, state, "legacy", 0.3, 0.2, compute_dtype=None,
                         stripe_tile_rows=2, quantized=True, device="cpu")
    raw8 = _raw((110, 90), seed=3)
    got = qs.infer(raw8)
    whole = InferenceEngine(hp, state, "legacy", 0.3, 0.2, quantized=True,
                            device="cpu")
    whole._quant = qs._quant
    _close(got, whole.infer_slide(raw8))
    ts = StreamingEngine(hp, state, "legacy", 0.3, 0.2, device="cpu")
    raw = _raw((40, 40))
    with pytest.raises(ValueError, match="out of range"):
        ts.infer(raw, classes=(3,))


def _cli_source(tmp_path, dtype=np.uint8, name="img.tif"):
    img = (np.random.RandomState(6).rand(180, 220) * 250).astype(dtype)
    src = tmp_path / "s" / "registration" / name
    src.parent.mkdir(parents=True, exist_ok=True)
    with TiffWriter(str(src), bigtiff=False) as tw:
        tw.write(img)
    return str(src)


@pytest.mark.parametrize("tool,engine", [
    ("unmicst-solo", ["--engine", "streaming"]),
    ("unmicst-solo", ["--engine", "sharded", "--meshShape", "4"]),
    ("unmicst-legacy", ["--engine", "streaming", "--outlier", "99.5"]),
    ("unmicst-legacy", ["--engine", "sharded", "--meshShape", "8"]),
])
def test_cli_engines_match_jax_cli(tmp_path, tool, engine):
    """--engine streaming|sharded through both CLIs (as tests/test_cli.py:
    406-448): the same files, page for page within 1 uint8 level."""
    src = _cli_source(tmp_path)
    common = [src, "--tool", tool, "--model", "blobDemo", "--modelRoot",
              MODELS, "--stackOutput", *engine]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main(common + ["--outputPath", out_j]) == 0
    assert cli.main(common + ["--outputPath", out_t], device="cpu") == 0
    for rel in ("img_Probabilities_1.tif", os.path.join(
            "qc", "img_Preview_1.tif")):
        for page in range(3 if "Prob" in rel else 2):
            a = jax_imread(os.path.join(out_j, rel), page).astype(int)
            b = port_tiff.imread(os.path.join(out_t, rel), page).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, rel


def test_cli_auto_streams_above_the_line(tmp_path, monkeypatch):
    """--engine auto streams slides above MAX_WHOLE_SLIDE_PX (lowered here
    so a small slide crosses it), and a stream refuses what it cannot
    take, naming why."""
    src = _cli_source(tmp_path, np.uint16)
    common = [src, "--tool", "unmicst-legacy", "--model", "blobDemo",
              "--modelRoot", MODELS]
    calls = []
    real = StreamingEngine.infer

    def spy(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(StreamingEngine, "infer", spy)
    assert cli.main(common + ["--outputPath", str(tmp_path / "w")],
                    device="cpu") == 0
    assert not calls  # 39.6 kpx: the whole-slide engine
    monkeypatch.setattr(cli, "MAX_WHOLE_SLIDE_PX", 10_000)
    assert cli.main(common + ["--outputPath", str(tmp_path / "a")],
                    device="cpu") == 0
    assert calls == [1]
    for f in ("img_ContoursPM_1.tif", "img_NucleiPM_1.tif"):
        a = port_tiff.imread(str(tmp_path / "w" / f)).astype(int)
        b = port_tiff.imread(str(tmp_path / "a" / f)).astype(int)
        assert np.abs(a - b).max() <= 1
    i16 = _cli_source(tmp_path, np.int16, "i16.tif")
    with pytest.raises(SystemExit, match="sharded"):
        cli.main([i16, "--tool", "unmicst-solo", "--model", "blobDemo",
                  "--modelRoot", MODELS, "--outputPath", str(tmp_path / "x"),
                  "--engine", "sharded"], device="cpu")
