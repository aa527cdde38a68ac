"""Port InferenceEngine (unmicst_tpu_torch.infer) against the JAX engine.

The same weights go to both sides: blobDemo (the port reads its TF1 files,
the JAX package its own loader) and the ``oracle_legacy`` TF1 checkpoint.
The slides are drawn with numpy; the port runs on the CPU, where the
kernels take their plain versions.  Bar: at most 1 uint8 level in
float32; in the bfloat16 mode, against the JAX bf16 mode, see
``_assert_maps_match``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmicst_tpu.core.checkpoint import load_params_for_bundle as jax_bundle_params
from unmicst_tpu.core.checkpoint import load_tf1_params as jax_tf1_params
from unmicst_tpu.core.hp import HParams as JaxHParams
from unmicst_tpu.core.hp import load_model_dir as jax_model_dir
from unmicst_tpu.infer import InferenceEngine as JaxEngine
from unmicst_tpu_torch import infer as port_infer
from unmicst_tpu_torch.core.checkpoint import load_params_for_bundle, load_tf1_params
from unmicst_tpu_torch.core.hp import HParams, load_model_dir
from unmicst_tpu_torch.infer import InferenceEngine, percentile_linear

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "models", "blobDemo")
ORACLE = os.path.join(REPO, "tests", "fixtures", "oracle_legacy")
# plausible normalisation for the oracle net (it ships none)
ORACLE_MEAN, ORACLE_STD = 0.2, 0.16


def _dtypes(bf16):
    """(JAX, port) compute dtypes: float32 (None) or the bfloat16 mode."""
    return (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)


def _demo_engines(bf16=False):
    jdt, tdt = _dtypes(bf16)
    jb, tb = jax_model_dir(DEMO), load_model_dir(DEMO)
    return (JaxEngine.from_bundle(jb, jax_bundle_params(jb),
                                  compute_dtype=jdt),
            InferenceEngine.from_bundle(tb, load_params_for_bundle(tb),
                                        compute_dtype=tdt, device="cpu"))


def _oracle_engines(bf16=False):
    jdt, tdt = _dtypes(bf16)
    with open(os.path.join(ORACLE, "hp.json")) as f:
        ref = json.load(f)
    jhp, hp = JaxHParams.from_ref_dict(ref), HParams.from_ref_dict(ref)
    prefix = os.path.join(ORACLE, "model.ckpt")
    return (JaxEngine(jhp, jax_tf1_params(prefix, jhp, "legacy"), "legacy",
                      ORACLE_MEAN, ORACLE_STD, compute_dtype=jdt),
            InferenceEngine(hp, load_tf1_params(prefix, hp, "legacy"),
                            "legacy", ORACLE_MEAN, ORACLE_STD,
                            compute_dtype=tdt, device="cpu"))


_ENGINES = {}


@pytest.fixture(params=["blobDemo", "oracle_legacy", "blobDemo-bfloat16",
                        "oracle_legacy-bfloat16"])
def engines(request):
    """(JAX engine, port engine) on the same weights and in the same
    precision mode, built once."""
    if request.param not in _ENGINES:
        model, _, mode = request.param.partition("-")
        make = _demo_engines if model == "blobDemo" else _oracle_engines
        _ENGINES[request.param] = make(bf16=mode == "bfloat16")
    return _ENGINES[request.param]


def _slide(dtype=np.uint16, shape=(150, 130), seed=0):
    rng = np.random.RandomState(seed)
    top = 255 if dtype == np.uint8 else 40000
    img = rng.rand(*shape) * 0.3 * top
    rr, cc = np.ogrid[: shape[0], : shape[1]]
    for _ in range(6):  # a few bright discs, so the maps are not flat
        r, c = rng.randint(10, shape[0] - 10), rng.randint(10, shape[1] - 10)
        img[(rr - r) ** 2 + (cc - c) ** 2 < rng.randint(16, 64)] = 0.8 * top
    return img.astype(dtype)


def _assert_maps_match(port, a, b):
    """float32: at most 1 level.  bfloat16: both sides round every conv's
    operands to bf16 and accumulate in float32, but in different orders,
    so an activation at a bf16 rounding tie can land one bf16 step apart.
    On these slides that gave at most 2 levels on at most 2.75% of pixels,
    where bf16 against float32 differs by up to 5 levels on 13-24%."""
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    d = np.abs(a.astype(int) - b.astype(int))
    if port.compute_dtype is None:
        assert d.max() <= 1, (d.max(), (d > 0).mean())
    else:
        assert d.max() <= 2 and (d > 0).mean() <= 0.05, (d.max(),
                                                         (d > 0).mean())


@pytest.mark.parametrize("kw", [
    {}, {"outlier": 99.0}, {"classes": (2, 0)}, {"in_range": (1000, 30000)},
    {"rescale": False},
], ids=["minmax", "outlier", "classes", "in_range", "no_rescale"])
def test_infer_slide_matches_jax(engines, kw):
    jax_engine, port = engines
    raw = _slide()
    _assert_maps_match(port, port.infer_slide(raw, **kw),
                       jax_engine.infer_slide(raw, **kw))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_infer_slide_input_dtypes_match_jax(engines, dtype):
    """uint8 (im2double / 255) and float32 (the uint16 parity cast)."""
    jax_engine, port = engines
    raw = _slide(np.uint8 if dtype == np.uint8 else np.uint16, (90, 110), 1)
    raw = raw.astype(dtype)
    _assert_maps_match(port, port.infer_slide(raw, outlier=99.5),
                       jax_engine.infer_slide(raw, outlier=99.5))


def test_infer_float_maps_match_jax():
    jax_engine, port = _ENGINES.get("blobDemo") or _demo_engines()
    img = _slide().astype(np.float32) / 65535
    np.testing.assert_allclose(port.infer(img), jax_engine.infer(img),
                               atol=1e-5)


def test_chunk_padding_is_invisible():
    """A tile batch that leaves phantom tiles in the last chunk (mask 0 in
    K1) gives the same maps as one chunk holding every tile."""
    tb = load_model_dir(DEMO)
    params = load_params_for_bundle(tb)
    raw = _slide(shape=(120, 200), seed=2)
    one = InferenceEngine.from_bundle(tb, params, device="cpu")
    padded = InferenceEngine.from_bundle(tb, params, tile_batch=4,
                                         device="cpu")
    assert padded.tile_batch == 4 and one.tile_batch == 256
    np.testing.assert_array_equal(padded.infer_slide(raw),
                                  one.infer_slide(raw))


@pytest.mark.parametrize("q", [0.0, 37.5, 99.0, 99.99, 100.0])
def test_percentile_linear_matches_jnp(q):
    x = np.random.RandomState(int(q * 100)).rand(257, 31).astype(np.float32)
    got = percentile_linear(torch.from_numpy(x), q).item()
    np.testing.assert_allclose(got, float(jnp.percentile(jnp.asarray(x), q)),
                               rtol=1e-6)


def test_rejects_unported_and_bad_arguments():
    tb = load_model_dir(DEMO)
    port = InferenceEngine.from_bundle(tb, load_params_for_bundle(tb),
                                       device="cpu")
    raw = _slide(shape=(40, 40))
    with pytest.raises(ValueError, match="out of range"):
        port.infer_slide(raw, classes=(3,))
    with pytest.raises(ValueError, match="lo < hi"):
        port.infer_slide(raw, in_range=(5, 5))
    with pytest.raises(ValueError):
        port.infer_slide(raw[None])


@pytest.mark.parametrize("free_tiles,want", [(10**6, 256), (251, 100),
                                             (0, 1)])
def test_tile_batch_follows_free_memory(monkeypatch, free_tiles, want):
    """256 tiles per forward unless 40% of the card's free memory holds
    fewer; the CPU always takes 256."""
    hp = load_model_dir(DEMO).hp
    per_tile = port_infer.tile_bytes(hp)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (free_tiles * per_tile, 0))
    assert port_infer.pick_tile_batch(hp, torch.device("cuda")) == want
    assert port_infer.pick_tile_batch(hp, torch.device("cpu")) == 256


def test_entry_points_need_a_card_unless_cpu_is_asked_for(monkeypatch):
    """With no GPU, the default device raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tb = load_model_dir(DEMO)
    params = load_params_for_bundle(tb)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngine.from_bundle(tb, params, device=device)
    assert port_infer.resolve_device("cpu").type == "cpu"
