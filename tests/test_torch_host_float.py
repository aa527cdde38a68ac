"""The CLI's host float path in the port against the JAX package on the CPU.

``preprocess_channel`` (host float64 on both sides) to 1e-12; the CLI on
the inputs that take the host path (an int16 slide, a duo stack of mixed
dtypes, a float32 Cyto2 slide, ``--check-numerics``) page for page within
1 uint8 level of the JAX CLI; ``check_numerics`` on a state dict and on
maps; and ``--check-numerics`` against the stream.
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from unmicst_tpu import cli as jax_cli
from unmicst_tpu.io import preprocess as jpp
from unmicst_tpu.io.tiff import TiffWriter
from unmicst_tpu.io.tiff import imread as jax_imread
from unmicst_tpu.utils.profiling import check_numerics as jax_check_numerics
from unmicst_tpu_torch import cli
from unmicst_tpu_torch.core.checkpoint import (load_params_for_bundle,
                                               save_tf1_params)
from unmicst_tpu_torch.core.hp import load_model_dir
from unmicst_tpu_torch.io import preprocess as pp
from unmicst_tpu_torch.io import tiff as port_tiff
from unmicst_tpu_torch.utils.profiling import check_numerics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
FIXTURES = os.path.join(REPO, "tests", "fixtures")

# -- preprocess_channel -------------------------------------------------------

# (dtype, low, high) of the seeded planes; float32 "unit" is a [0, 1] plane
_PLANES = {
    "uint8": (np.uint8, 0, 255),
    "uint16": (np.uint16, 0, 60000),
    "int16": (np.int16, -2000, 30000),
    "int32": (np.int32, -100000, 2000000),
    "float32": (np.float32, 0, 60000),
    "float32_unit": (np.float32, 0, 1),
    "float64": (np.float64, 0, 1),
}


def _plane(kind, shape=(61, 47), seed=0):
    dtype, lo, hi = _PLANES[kind]
    rng = np.random.RandomState(seed)
    x = lo + (hi - lo) * rng.rand(*shape) ** 2
    x[rng.rand(*shape) < 0.02] = hi  # a few saturated pixels
    return x.astype(dtype)


def _same_channel(a, b):
    assert a.raw_shape == b.raw_shape
    for f in ("net_input", "raw_norm"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape, f
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("outlier", [-1, 99.9])
@pytest.mark.parametrize("sf", [1.0, 0.5])
@pytest.mark.parametrize("kind", list(_PLANES))
def test_preprocess_channel_matches_jax(kind, sf, outlier):
    plane = _plane(kind)
    cast = kind != "float32_unit"  # the Cyto2 case keeps its floats
    _same_channel(
        pp.preprocess_channel(plane, sf, outlier, cast_float32=cast),
        jpp.preprocess_channel(plane, sf, outlier, cast_float32=cast))


@pytest.mark.parametrize("kind,pin", [
    ("uint8", (10, 200)), ("uint16", (1000, 40000)), ("int16", (-500, 9000)),
    ("float32", (0, 30000)),
])
@pytest.mark.parametrize("sf", [1.0, 0.5])
def test_preprocess_channel_pinned_range_matches_jax(kind, pin, sf):
    plane = _plane(kind, seed=1)
    _same_channel(pp.preprocess_channel(plane, sf, 99.0, in_range=pin),
                  jpp.preprocess_channel(plane, sf, 99.0, in_range=pin))


@pytest.mark.parametrize("kind", ["uint16", "int16"])
@pytest.mark.parametrize("sf", [1.0, 0.5])
def test_preprocess_channel_unrescaled_matches_jax(kind, sf):
    """``use_rescaled=False``: the v2-solo quirk."""
    plane = _plane(kind, seed=2)
    _same_channel(
        pp.preprocess_channel(plane, sf, 99.5, use_rescaled=False),
        jpp.preprocess_channel(plane, sf, 99.5, use_rescaled=False))


def test_preprocess_channel_refuses_bad_pins_and_passes_constants():
    plane = _plane("uint16")
    with pytest.raises(ValueError, match="lo < hi"):
        pp.preprocess_channel(plane, in_range=(5, 5))
    flat = np.full((20, 30), 700, np.int16)
    _same_channel(pp.preprocess_channel(flat),
                  jpp.preprocess_channel(flat))


# -- check_numerics -----------------------------------------------------------


def test_check_numerics_names_the_bad_key():
    state = load_params_for_bundle(load_model_dir(os.path.join(MODELS,
                                                               "blobDemo")))
    check_numerics(state, "params")
    bad = {k: v.clone() for k, v in state.items()}
    bad["down.1.kernel1"].view(-1)[5] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=r"non-finite values in params: "
                             r"\['down.1.kernel1'\]: 1 non-finite"):
        check_numerics(bad, "params")
    # the JAX scan's message for the same tree of numpy leaves
    with pytest.raises(FloatingPointError) as want:
        jax_check_numerics({k: v.numpy() for k, v in bad.items()}, "params")
    with pytest.raises(FloatingPointError) as got:
        check_numerics(bad, "params")
    assert str(got.value) == str(want.value)


def test_check_numerics_on_maps_and_nested_trees():
    maps = np.random.RandomState(0).rand(3, 20, 30).astype(np.float32)
    check_numerics(maps, "probability maps")
    check_numerics({"a": [torch.ones(3), np.arange(4)]}, "ok")
    maps[1, 4, 7] = np.inf
    maps[2, 0, 0] = -np.inf
    with pytest.raises(FloatingPointError, match=": 2 non-finite"):
        check_numerics(maps, "probability maps")
    tree = {"b": [np.zeros(2), torch.tensor([1.0, float("nan")])]}
    with pytest.raises(FloatingPointError, match=r"\['b'\]\[1\]: 1"):
        check_numerics(tree, "tree")


# -- the CLI's host float path ------------------------------------------------


def _model_dir(root, name, fixture, mean, std):
    """A model directory both CLIs load: a TF1 fixture with the
    reference's pickled sidecars."""
    src = os.path.join(FIXTURES, fixture)
    d = os.path.join(root, name)
    os.makedirs(d)
    for f in os.listdir(src):
        if f.startswith("model.ckpt"):
            shutil.copy(os.path.join(src, f), d)
    with open(os.path.join(src, "hp.json")) as f:
        hp = json.load(f)
    for fname, obj in (("hp.data", hp), ("datasetMean.data", mean),
                       ("datasetStDev.data", std)):
        with open(os.path.join(d, fname), "wb") as f:
            pickle.dump(obj, f)
    return d


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zoo"))
    _model_dir(root, "nucleiDAPILAMIN", "oracle_duo", 0.18, 0.17)
    _model_dir(root, "CytoplasmIncell2", "oracle_cyto2", 0.2, 0.15)
    return root


def _slide(tmp_path, planes, name="slide.tif"):
    src = tmp_path / "s" / "registration" / name
    src.parent.mkdir(parents=True, exist_ok=True)
    with TiffWriter(str(src), bigtiff=False) as tw:
        for p in planes:
            tw.write(p)
    return str(src)


def _blobs(shape, seed, lo, hi, dtype):
    """Noise with bright discs, so the maps are not flat."""
    rng = np.random.RandomState(seed)
    img = rng.rand(*shape) * 0.3
    rr, cc = np.ogrid[: shape[0], : shape[1]]
    for _ in range(8):
        r, c = rng.randint(8, shape[0] - 8), rng.randint(8, shape[1] - 8)
        img[(rr - r) ** 2 + (cc - c) ** 2 < rng.randint(16, 64)] = 0.85
    return (lo + (hi - lo) * img).astype(dtype)


def _pages_match(out_j, out_t):
    """Every file and page of both CLIs within 1 uint8 level; returns the
    share of pixels that differ."""
    files = sorted(os.path.relpath(os.path.join(d, f), out_j)
                   for d, _, fs in os.walk(out_j) for f in fs)
    got = sorted(os.path.relpath(os.path.join(d, f), out_t)
                 for d, _, fs in os.walk(out_t) for f in fs)
    assert files and files == got
    flips = []
    for rel in files:
        a_path, b_path = os.path.join(out_j, rel), os.path.join(out_t, rel)
        for page in range(port_tiff.num_pages(b_path)):
            a = jax_imread(a_path, page)
            b = port_tiff.imread(b_path, page)
            assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
            d = np.abs(a.astype(int) - b.astype(int))
            assert d.max() <= 1, rel
            flips.append((d > 0).mean())
    return max(flips)


def _both(tmp_path, argv):
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main(argv + ["--outputPath", out_j]) == 0
    assert cli.main(argv + ["--outputPath", out_t], device="cpu") == 0
    return _pages_match(out_j, out_t)


@pytest.mark.parametrize("extra", [[], ["--stackOutput", "--outlier", "99.5"],
                                   ["--scalingFactor", "0.5",
                                    "--stackOutput"]])
def test_int16_slide_matches_jax_cli(tmp_path, extra):
    src = _slide(tmp_path, [_blobs((120, 100), 1, -300, 30000, np.int16)])
    share = _both(tmp_path, [src, "--tool", "unmicst-legacy", "--model",
                             "blobDemo", "--modelRoot", MODELS, *extra])
    assert share < 0.02


@pytest.mark.parametrize("extra", [["--stackOutput"],
                                   ["--intensityRange", "10,250",
                                    "500,40000"]])
def test_mixed_dtype_duo_matches_jax_cli(tmp_path, zoo, extra):
    src = _slide(tmp_path, [_blobs((96, 112), 2, 0, 255, np.uint8),
                            _blobs((96, 112), 3, 100, 50000, np.uint16)])
    _both(tmp_path, [src, "--tool", "unmicst-duo", "--modelRoot", zoo,
                     "--channel", "1", "2", *extra])


def test_duo_cli_streams_refuse_mixed_dtypes(tmp_path, zoo):
    """The stream's exact histogram needs one integer dtype: an explicit
    stream refuses mixed channels, as in JAX."""
    src = _slide(tmp_path, [_blobs((96, 112), 2, 0, 255, np.uint8),
                            _blobs((96, 112), 3, 100, 50000, np.uint16)])
    with pytest.raises(SystemExit, match="one integer dtype across"):
        cli.main([src, "--tool", "unmicst-duo", "--modelRoot", zoo,
                  "--channel", "1", "2", "--engine", "streaming",
                  "--outputPath", str(tmp_path / "o")], device="cpu")


def test_float32_cyto2_slide_matches_jax_cli(tmp_path, zoo):
    """Cyto2 reads float32 as it is (no parity cast): a [0, 1] slide."""
    src = _slide(tmp_path, [_blobs((90, 110), 4, 0, 1, np.float32)])
    _both(tmp_path, [src, "--tool", "UnMicstCyto2", "--model",
                     "CytoplasmIncell2", "--modelRoot", zoo,
                     "--stackOutput"])


@pytest.mark.parametrize("tool", ["unmicst-legacy", "unmicst-solo"])
def test_check_numerics_on_uint16_matches_jax_cli(tmp_path, tool):
    src = _slide(tmp_path, [_blobs((120, 100), 5, 200, 60000, np.uint16)])
    _both(tmp_path, [src, "--tool", tool, "--model", "blobDemo",
                     "--modelRoot", MODELS, "--check-numerics"])


def test_check_numerics_fails_on_a_nan_weight(tmp_path):
    """A NaN written into one weight of the model dir: the CLI raises
    naming that weight, before writing a page."""
    bundle = load_model_dir(os.path.join(MODELS, "blobDemo"))
    state = load_params_for_bundle(bundle)
    state["up.0.kernel2"].view(-1)[3] = float("nan")
    d = tmp_path / "models" / "blobNaN"
    shutil.copytree(os.path.join(MODELS, "blobDemo"), d)
    for f in d.iterdir():
        if f.name.startswith("model."):
            f.unlink()
    save_tf1_params(str(d / "model.ckpt"), state, bundle.hp, bundle.variant)
    src = _slide(tmp_path, [_blobs((64, 64), 6, 0, 60000, np.uint16)])
    out = tmp_path / "o"
    argv = [src, "--model", "blobNaN", "--modelRoot", str(d.parent),
            "--outputPath", str(out), "--stackOutput"]
    with pytest.raises(FloatingPointError, match=r"\['up.0.kernel2'\]"):
        cli.main(argv + ["--check-numerics"], device="cpu")
    assert not list(out.glob("*.tif"))
    assert cli.main(argv, device="cpu") == 0  # unchecked, it runs


def test_check_numerics_pulls_an_auto_slide_off_the_stream(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """Under ``--engine auto`` a slide above the stream threshold takes the
    whole engine's float path with --check-numerics; under an explicit
    ``--engine streaming`` it streams, and the note says only the params
    are scanned."""
    src = _slide(tmp_path, [_blobs((120, 100), 7, 200, 60000, np.uint16)])
    argv = [src, "--tool", "unmicst-legacy", "--model", "blobDemo",
            "--modelRoot", MODELS, "--stackOutput", "--check-numerics"]
    monkeypatch.setattr(cli, "MAX_WHOLE_SLIDE_PX", 1000)
    streamed = []
    run_streaming = cli._run_streaming
    monkeypatch.setattr(cli, "_run_streaming",
                        lambda *a: streamed.append(1) or run_streaming(*a))
    # JAX's threshold is 64 Mpx: this slide takes its whole engine
    _both(tmp_path, argv)
    assert not streamed
    capsys.readouterr()
    out_s = str(tmp_path / "streamed")
    assert cli.main(argv + ["--engine", "streaming", "--outputPath", out_s],
                    device="cpu") == 0
    assert streamed
    assert "scans params only" in capsys.readouterr().out
    got = port_tiff.imread(os.path.join(out_s, "slide_Probabilities_1.tif"))
    want = port_tiff.imread(os.path.join(str(tmp_path / "torch"),
                                         "slide_Probabilities_1.tif"))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
