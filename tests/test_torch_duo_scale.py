"""The port's duo stack path and ``--scalingFactor`` against the JAX
package on the CPU.

The whole engine (``infer_slide(scaling_factor=)``, ``infer_slide_stack``),
the stream (``infer_stack``, ``infer_sharded_stack``, and ``infer`` /
``infer_sharded`` on a ``ResampledSource``) and the CLI (``--tool
unmicst-duo``, ``--scalingFactor``) hold the same outputs as their JAX
counterparts on the same seeded numpy inputs and the same weights: the
``oracle_duo`` TF1 checkpoint (each package's own loader) for the duo
net, and a small seeded legacy net through ``params_from_jax``.  The port
runs on the CPU (ranks share it), where the kernels take their plain
versions.  Bars (float32): scale-1 maps within 1 uint8 level; scaled maps
within 1 level on fewer than 2% of pixels (``tests/
test_infer_slide_scale.py`` ``_assert_close``).
"""

import json
import os
import pickle
import shutil

import jax
import numpy as np
import pytest

from unmicst_tpu import cli as jax_cli
from unmicst_tpu.core import unet as junet
from unmicst_tpu.core.checkpoint import load_tf1_params as jax_tf1_params
from unmicst_tpu.core.hp import HParams as JaxHParams
from unmicst_tpu.infer import InferenceEngine as JaxEngine
from unmicst_tpu.io import preprocess as jpp
from unmicst_tpu.io.tiff import TiffWriter
from unmicst_tpu.io.tiff import imread as jax_imread
from unmicst_tpu.runtime.pipeline import StreamingEngine as JaxStream
from unmicst_tpu_torch import cli, kernels
from unmicst_tpu_torch.core.checkpoint import load_tf1_params, params_from_jax
from unmicst_tpu_torch.core.hp import HParams
from unmicst_tpu_torch.infer import InferenceEngine
from unmicst_tpu_torch.io import preprocess as pp
from unmicst_tpu_torch.io import tiff as port_tiff
from unmicst_tpu_torch.runtime.mesh import make_mesh
from unmicst_tpu_torch.runtime.pipeline import StreamingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
DUO = os.path.join(REPO, "tests", "fixtures", "oracle_duo")
DUO_MEAN, DUO_STD = 0.18, 0.17  # nucleiDAPILAMIN's (SURVEY.md section 2.4)
# the legacy net of tests/test_infer_slide_scale.py
_LEGACY = dict(im_size=32, n_channels=1, n_classes=3, n_out0=6, ks=3,
               n_extra_convs=0, n_layers=2, batch_size=8, std_dev0=0.5)
_NETS = {}


def _duo_ref():
    with open(os.path.join(DUO, "hp.json")) as f:
        return json.load(f)


def _duo():
    """(JAX hp, JAX params, port hp, port state) of the oracle_duo net."""
    if "duo" not in _NETS:
        ref = _duo_ref()
        jhp, hp = JaxHParams.from_ref_dict(ref), HParams.from_ref_dict(ref)
        prefix = os.path.join(DUO, "model.ckpt")
        _NETS["duo"] = (jhp, jax_tf1_params(prefix, jhp, "v2"), hp,
                        load_tf1_params(prefix, hp, "v2"))
    return _NETS["duo"]


def _legacy():
    if "legacy" not in _NETS:
        jhp, hp = JaxHParams(**_LEGACY), HParams(**_LEGACY)
        params = junet.init_params(jax.random.PRNGKey(5), jhp, "legacy")
        _NETS["legacy"] = (jhp, params, hp, params_from_jax(
            jax.tree_util.tree_map(np.asarray, params), hp, "legacy"))
    return _NETS["legacy"]


def _whole(net):
    """(JAX engine, port engine), float32, built once."""
    key = net + "-whole"
    if key not in _NETS:
        jhp, jparams, hp, state = _duo() if net == "duo" else _legacy()
        variant, mean, std = (("v2", DUO_MEAN, DUO_STD) if net == "duo"
                              else ("legacy", 0.3, 0.2))
        _NETS[key] = (JaxEngine(jhp, jparams, variant, mean, std),
                      InferenceEngine(hp, state, variant, mean, std,
                                      device="cpu"))
    return _NETS[key]


def _streams(net):
    """(JAX stream, port stream), float32, two tile rows a stripe."""
    jhp, jparams, hp, state = _duo() if net == "duo" else _legacy()
    variant, mean, std = (("v2", DUO_MEAN, DUO_STD) if net == "duo"
                          else ("legacy", 0.3, 0.2))
    kw = dict(compute_dtype=None, stripe_tile_rows=2)
    return (JaxStream(jhp, jparams, variant, mean, std, **kw),
            StreamingEngine(hp, state, variant, mean, std, device="cpu",
                            **kw))


def _plane(shape, seed, top=60000, dtype=np.uint16):
    """Noise with a few bright discs, so the maps are not flat."""
    rng = np.random.RandomState(seed)
    img = rng.rand(*shape) * 0.3 * top
    rr, cc = np.ogrid[: shape[0], : shape[1]]
    for _ in range(6):
        r, c = rng.randint(8, shape[0] - 8), rng.randint(8, shape[1] - 8)
        img[(rr - r) ** 2 + (cc - c) ** 2 < rng.randint(16, 64)] = 0.8 * top
    return img.astype(dtype)


def _close(a, b, scaled):
    """At most 1 level; scaled maps on fewer than 2% of pixels."""
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1, d.max()
    if scaled:
        assert (d > 0).mean() < 0.02, (d > 0).mean()


# -- the whole engine ----------------------------------------------------------


@pytest.mark.parametrize("sf,kw,dtype", [
    (0.5, {}, np.uint16), (0.65, {}, np.uint16), (2.0, {}, np.uint16),
    (0.5, {"outlier": 99.0}, np.uint16), (2.0, {"outlier": 99.0}, np.uint16),
    (0.65, {"rescale": False}, np.uint16), (0.5, {}, np.uint8),
    (0.5, {"in_range": (1000, 40000)}, np.uint16),
    (0.65, {"classes": (2, 0)}, np.uint16), (0.37, {}, np.float32),
])
def test_infer_slide_scaled_matches_jax(sf, kw, dtype):
    jax_engine, port = _whole("legacy")
    raw = _plane((120, 90), int(sf * 100),
                 top=255 if dtype == np.uint8 else 60000,
                 dtype=np.uint8 if dtype == np.uint8 else np.uint16)
    raw = raw.astype(dtype)
    got = port.infer_slide(raw, scaling_factor=sf, **kw)
    assert got.shape[1:] == raw.shape
    _close(got, jax_engine.infer_slide(raw, scaling_factor=sf, **kw), True)


@pytest.mark.parametrize("kw", [
    {}, {"outlier": 99.0}, {"classes": (2, 0)},
    {"in_range": [(1000, 40000), (500, 20000)]},
    {"in_range": (1000, 40000)}, {"scaling_factor": 0.5},
    {"scaling_factor": 0.65, "outlier": 99.5}, {"rescale": False},
], ids=["minmax", "outlier", "classes", "in_range_per_channel",
        "in_range_broadcast", "sf0.5", "sf0.65_outlier", "no_rescale"])
def test_infer_slide_stack_matches_jax(kw):
    """The oracle_duo net: per-channel ranges on the card's path against
    the JAX engine's fused stack program."""
    jax_engine, port = _whole("duo")
    planes = [_plane((110, 90), 1), _plane((110, 90), 2, top=30000)]
    got = port.infer_slide_stack(planes, **kw)
    want = jax_engine.infer_slide_stack(planes, **kw)
    _close(got, want, kw.get("scaling_factor", 1.0) != 1.0)


def test_infer_slide_stack_uint8_and_one_channel_twice():
    jax_engine, port = _whole("duo")
    a = _plane((100, 70), 3, top=255, dtype=np.uint8)
    for planes in ([a, _plane((100, 70), 4, top=255, dtype=np.uint8)],
                   [a, a]):
        _close(port.infer_slide_stack(planes),
               jax_engine.infer_slide_stack(planes), False)


@pytest.mark.parametrize("planes,match", [
    ([np.zeros((40, 40), np.uint16)], "model expects 2 channels, got 1"),
    ([np.zeros((40, 40), np.uint16), np.zeros((40, 40), np.uint8)],
     "disagree on dtype"),
    ([np.zeros((40, 40), np.uint16), np.zeros((40, 41), np.uint16)],
     "one shape"),
])
def test_infer_slide_stack_refuses_what_jax_refuses(planes, match):
    jax_engine, port = _whole("duo")
    with pytest.raises(ValueError, match=match):
        port.infer_slide_stack(planes)
    if "shape" not in match:  # JAX's np.stack raises its own message
        with pytest.raises(ValueError, match=match):
            jax_engine.infer_slide_stack(planes)


def test_stack_in_range_needs_a_pair_per_channel():
    _, port = _whole("duo")
    planes = [_plane((60, 60), 5)] * 2
    with pytest.raises(ValueError, match="one \\(lo, hi\\) pair or 2 pairs"):
        port.infer_slide_stack(planes, in_range=[(0, 1), (0, 2), (0, 3)])
    with pytest.raises(ValueError, match="lo < hi"):
        port.infer_slide_stack(planes, in_range=[(0, 1), (5, 5)])


@pytest.mark.parametrize("value", [0, 255])
@pytest.mark.parametrize("sf", [0.5, 0.65, 2.0])
def test_back_resize_keeps_the_extremes(monkeypatch, value, sf):
    """Maps of all 0 or all 255 come back from the resize and the second
    truncating quantisation unchanged: the lerp of equal values stays at
    them, so the cast needs no clamp."""
    import torch

    _, port = _whole("legacy")

    def flat(planes, classes, quantize):
        _, h, w = planes.shape
        return torch.full((3, h, w), value, dtype=torch.uint8)

    monkeypatch.setattr(port, "_maps", flat)
    got = port.infer_slide(_plane((90, 70), 6), scaling_factor=sf)
    assert got.shape == (3, 90, 70) and np.all(got == value)


# -- the stream ------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"outlier": 99.0}, {"classes": (1, 2)},
                                {"stats": [(1000.0, 50000.0),
                                           (200.0, 20000.0)]}],
                         ids=["minmax", "outlier", "classes", "stats"])
def test_stack_stream_matches_jax_and_whole(kw):
    js, ts = _streams("duo")
    planes = [_plane((150, 110), 7), _plane((150, 110), 8, top=30000)]
    got = ts.infer_stack(planes, **kw)
    _close(got, js.infer_stack(planes, **kw), False)
    if "stats" not in kw:
        _, port = _whole("duo")
        _close(got, port.infer_slide_stack(planes, **kw), False)


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_stack_matches_jax_and_stream(n):
    from jax.sharding import Mesh

    js, ts = _streams("duo")
    planes = [_plane((130, 230), 9), _plane((130, 230), 10, top=30000)]
    got = ts.infer_sharded_stack(planes, make_mesh(devices=["cpu"] * n),
                                 classes=(2, 0))
    jmesh = Mesh(np.array(jax.devices()[:n]), ("d",))
    _close(got, js.infer_sharded_stack(planes, jmesh, axis="d",
                                       classes=(2, 0)), False)
    _close(got, ts.infer_stack(planes, classes=(2, 0)), False)


def test_stack_stream_refusals():
    _, ts = _streams("duo")
    a = _plane((60, 60), 11)
    with pytest.raises(ValueError, match="model expects 2 channels"):
        ts.infer_stack([a])
    with pytest.raises(ValueError, match="1 ranges for 2 channels"):
        ts.infer_stack([a, a], stats=[(0, 1)])
    with pytest.raises(ValueError, match="1 ranges for 2 channels"):
        ts.infer_sharded_stack([a, a], make_mesh(devices=["cpu"]),
                               stats=[(0, 1)])
    with pytest.raises(ValueError, match="disagree on dtype"):
        ts.infer_stack([a, (a // 257).astype(np.uint8)])
    with pytest.raises(ValueError, match="share dimensions"):
        ts.infer_stack([a, a[:50]])


@pytest.mark.parametrize("sf,kw", [(0.5, {}), (0.37, {}),
                                   (0.5, {"outlier": 99.0}),
                                   (0.65, {"rescale": False}),
                                   (2.0, {})])
def test_resampled_stream_matches_jax(tmp_path, sf, kw):
    """infer and infer_sharded on a ResampledSource (unit-scale float32
    rows, stats from the source) against JAX's, and from a TIFF page."""
    from jax.sharding import Mesh

    js, ts = _streams("legacy")
    raw = _plane((150, 90), int(sf * 10))
    got = ts.infer(pp.ResampledSource(raw, sf), **kw)
    _close(got, js.infer(jpp.ResampledSource(raw, sf), **kw), False)
    sharded = ts.infer_sharded(pp.ResampledSource(raw, sf),
                               make_mesh(devices=["cpu"] * 2), **kw)
    _close(sharded, js.infer_sharded(jpp.ResampledSource(raw, sf),
                                     Mesh(np.array(jax.devices()[:2]),
                                          ("d",)), axis="d", **kw), False)
    _close(sharded, got, False)
    if not kw:
        fn = str(tmp_path / "s.tif")
        with TiffWriter(fn, bigtiff=False) as tw:
            tw.write(raw)
        with port_tiff.TiffFile(fn) as tf:
            np.testing.assert_array_equal(
                ts.infer(pp.ResampledSource((tf, 0), sf)), got)


def test_resampled_stream_upscaled_matches_whole_engine():
    """The CLI's stream at a scale (resampled source, upscale_pm at write)
    against the whole engine's fused resize: JAX's bar."""
    _, ts = _streams("legacy")
    _, port = _whole("legacy")
    raw = _plane((150, 90), 12)
    maps = ts.infer(pp.ResampledSource(raw, 0.5))
    up = np.stack([pp.upscale_pm(m, raw.shape) for m in maps])
    _close(up, port.infer_slide(raw, scaling_factor=0.5), True)


def test_resampled_stack_stream_matches_jax():
    """Both stack forms on virtual sources (tests/test_pipeline.py:232)."""
    from jax.sharding import Mesh

    js, ts = _streams("duo")
    a, b = _plane((140, 120), 13), _plane((140, 120), 14, top=30000)
    got = ts.infer_stack([pp.ResampledSource(a, 0.5),
                          pp.ResampledSource(b, 0.5)])
    want = js.infer_stack([jpp.ResampledSource(a, 0.5),
                           jpp.ResampledSource(b, 0.5)])
    _close(got, want, False)
    sharded = ts.infer_sharded_stack(
        [pp.ResampledSource(a, 0.5), pp.ResampledSource(b, 0.5)],
        make_mesh(devices=["cpu"] * 2))
    _close(sharded, js.infer_sharded_stack(
        [jpp.ResampledSource(a, 0.5), jpp.ResampledSource(b, 0.5)],
        Mesh(np.array(jax.devices()[:2]), ("d",)), axis="d"), False)
    assert kernels.blend_fold_stripe.launches == 0  # plain on the CPU


# -- the CLI -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def duo_model_root(tmp_path_factory):
    """A nucleiDAPILAMIN model directory both CLIs load: the oracle_duo TF1
    checkpoint with the reference's pickled sidecars."""
    root = tmp_path_factory.mktemp("zoo")
    d = root / "nucleiDAPILAMIN"
    d.mkdir()
    for f in os.listdir(DUO):
        if f.startswith("model.ckpt"):
            shutil.copy(os.path.join(DUO, f), d / f)
    for name, obj in (("hp.data", _duo_ref()), ("datasetMean.data", DUO_MEAN),
                      ("datasetStDev.data", DUO_STD)):
        with open(d / name, "wb") as f:
            pickle.dump(obj, f)
    return str(root)


def _duo_tiff(tmp_path, dtypes=(np.uint16, np.uint16)):
    src = tmp_path / "s" / "registration" / "duo.tif"
    src.parent.mkdir(parents=True, exist_ok=True)
    with TiffWriter(str(src), bigtiff=False) as tw:
        for i, dt in enumerate(dtypes):
            top = 255 if dt == np.uint8 else 60000 - 25000 * i
            tw.write(_plane((130, 150), 20 + i, top=top, dtype=dt))
    return str(src)


def _pages_match(out_j, out_t):
    files = sorted(os.path.relpath(os.path.join(d, f), out_j)
                   for d, _, fs in os.walk(out_j) for f in fs)
    got = sorted(os.path.relpath(os.path.join(d, f), out_t)
                 for d, _, fs in os.walk(out_t) for f in fs)
    assert files and files == got
    for rel in files:
        a_path, b_path = os.path.join(out_j, rel), os.path.join(out_t, rel)
        page = 0
        while True:
            try:
                a = jax_imread(a_path, page)
            except (IndexError, ValueError):
                break
            b = port_tiff.imread(b_path, page)
            assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, rel
            page += 1
        assert page >= 1


@pytest.mark.parametrize("extra", [
    ["--channel", "1", "2", "--stackOutput"],
    ["--channel", "2", "--stackOutput"],
    ["--channel", "1", "2"],
    ["--channel", "1", "2", "--stackOutput", "--intensityRange", "500,50000",
     "100,30000"],
    ["--channel", "1", "2", "--stackOutput", "--engine", "streaming",
     "--outlier", "99.5"],
    ["--channel", "2", "1", "--stackOutput", "--engine", "sharded",
     "--meshShape", "2", "--scalingFactor", "0.5"],
], ids=["two_channels", "one_channel_twice", "non_stack", "pinned_pairs",
        "streaming", "sharded_scaled"])
def test_duo_cli_matches_jax_cli(tmp_path, duo_model_root, extra):
    src = _duo_tiff(tmp_path)
    common = [src, "--tool", "unmicst-duo", "--modelRoot", duo_model_root,
              *extra]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main(common + ["--outputPath", out_j]) == 0
    assert cli.main(common + ["--outputPath", out_t], device="cpu") == 0
    _pages_match(out_j, out_t)


@pytest.mark.parametrize("engine", ["whole", "streaming"])
def test_scaling_factor_cli_matches_jax_cli(tmp_path, engine):
    """--scalingFactor 0.5 on blobDemo: the whole engine's fused resize and
    the stream's resampled source with upscale_pm at write."""
    src = tmp_path / "s" / "registration" / "blobs.tif"
    src.parent.mkdir(parents=True)
    with TiffWriter(str(src), bigtiff=False) as tw:
        tw.write(_plane((200, 160), 30))
    common = [str(src), "--tool", "unmicst-legacy", "--model", "blobDemo",
              "--modelRoot", MODELS, "--scalingFactor", "0.5",
              "--stackOutput", "--engine", engine]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main(common + ["--outputPath", out_j]) == 0
    assert cli.main(common + ["--outputPath", out_t], device="cpu") == 0
    _pages_match(out_j, out_t)
    assert port_tiff.imread(os.path.join(
        out_t, "blobs_Probabilities_1.tif"), 0).shape == (200, 160)


def test_duo_cli_refuses_mixed_dtypes(tmp_path, duo_model_root):
    """A duo stack of mixed dtypes takes the host float path on the whole
    engine, as in JAX (pages within 1 level of the JAX CLI); the stream,
    which needs one integer dtype for its exact histogram, refuses it."""
    src = _duo_tiff(tmp_path, (np.uint16, np.uint8))
    argv = [src, "--tool", "unmicst-duo", "--modelRoot", duo_model_root,
            "--channel", "1", "2", "--outputPath", str(tmp_path / "o")]
    out_j = str(tmp_path / "jax")
    assert jax_cli.main(argv[:-2] + ["--outputPath", out_j]) == 0
    assert cli.main(argv, device="cpu") == 0
    _pages_match(out_j, str(tmp_path / "o"))
    with pytest.raises(SystemExit, match="one integer dtype across"):
        cli.main(argv + ["--engine", "streaming"], device="cpu")
    with pytest.raises(SystemExit, match="--intensityRange"):
        cli.main(argv[:-2] + ["--intensityRange", "0,1", "0,2", "0,3",
                              "--outputPath", str(tmp_path / "o")],
                 device="cpu")
