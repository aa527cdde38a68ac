"""The port's space-to-depth refold (``unmicst_tpu_torch/core/s2d.py``)
against the JAX package's (``unmicst_tpu/core/s2d.py``) and against the
port's plain forward, on the CPU, at the bars of ``tests/test_s2d.py``:
2e-5 after softmax in float32, 0.02 in bfloat16, one uint8 level for the
engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmicst_tpu.core import s2d as jax_s2d
from unmicst_tpu.core import unet as jax_unet
from unmicst_tpu.core.hp import HParams as JaxHParams
from unmicst_tpu.infer import InferenceEngine as JaxEngine
from unmicst_tpu_torch.core import s2d
from unmicst_tpu_torch.core.checkpoint import params_from_jax
from unmicst_tpu_torch.core.hp import HParams
from unmicst_tpu_torch.core.unet import UNet
from unmicst_tpu_torch.infer import InferenceEngine

_jax_apply = jax.jit(jax_s2d.apply, static_argnums=(3, 4),
                     static_argnames=("compute_dtype",))
_jax_init = jax.jit(jax_unet.init_params, static_argnums=(1, 2))

# nucleiDAPI-shaped (ks 5, one extra conv, the 1x1 shortcut) at test size;
# v2 with no extra conv takes the fused residual kernel
CONFIGS = {
    "legacy": dict(im_size=64, n_channels=1, n_classes=3, n_out0=16, ks=5,
                   n_extra_convs=1, n_layers=2),
    "v2": dict(im_size=32, n_channels=1, n_classes=3, n_out0=8, ks=3,
               n_extra_convs=0, n_layers=3),
}


def _params(variant, seed):
    """JAX params (numpy leaves) with non-trivial BN statistics, and the
    port's state from the same numbers."""
    kw = CONFIGS[variant]
    params = jax.tree_util.tree_map(np.asarray, _jax_init(
        jax.random.PRNGKey(seed), JaxHParams(**kw), variant))
    rs = np.random.RandomState(seed + 7)

    def walk(node):
        if isinstance(node, dict):
            if "bn" in node:
                c = node["bn"]["gamma"].shape[0]
                node["bn"] = {
                    "gamma": (1 + 0.2 * rs.randn(c)).astype(np.float32),
                    "beta": (0.05 * rs.randn(c)).astype(np.float32),
                    "moving_mean": (0.1 * rs.randn(c)).astype(np.float32),
                    "moving_variance": (1 + 0.3 * rs.rand(c)).astype(
                        np.float32)}
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(params)
    return params, params_from_jax(params, HParams(**kw), variant)


def _model(state, variant, compute_dtype=None):
    model = UNet(HParams(**CONFIGS[variant]), variant, compute_dtype)
    model.load_state_dict(state)
    return model.eval()


def test_packing_is_jax_layout():
    x = np.random.RandomState(0).rand(2, 8, 10, 3).astype(np.float32)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    packed = s2d.space_to_depth(nchw)
    np.testing.assert_array_equal(
        packed.permute(0, 2, 3, 1).numpy(),
        np.asarray(jax_s2d.space_to_depth(jnp.asarray(x))))
    assert torch.equal(s2d.depth_to_space(packed), nchw)
    # packed channel (qy*2+qx)*C + c holds pixel (2i+qy, 2j+qx, c)
    assert packed[0, 1 * 3 + 2, 1, 2] == nchw[0, 2, 2, 5]


@pytest.mark.parametrize("ks", [1, 3, 5])
def test_refolds_equal_jax(ks):
    rs = np.random.RandomState(ks)
    k = rs.randn(ks, ks, 3, 5).astype(np.float32)
    np.testing.assert_array_equal(s2d.refold_conv(k), jax_s2d.refold_conv(k))
    if ks > 1:
        kt = rs.randn(ks, ks, 4, 6).astype(np.float32)
        np.testing.assert_array_equal(s2d.refold_conv_transpose(kt),
                                      jax_s2d.refold_conv_transpose(kt))


def _softmax(t: torch.Tensor) -> np.ndarray:
    return torch.softmax(t, dim=-1).numpy()


@pytest.mark.parametrize("variant", ["legacy", "v2"])
def test_apply_matches_jax_and_the_plain_forward(variant):
    params, state = _params(variant, 2)
    kw = CONFIGS[variant]
    hp = JaxHParams(**kw)
    x = np.random.RandomState(3).randn(2, kw["im_size"], kw["im_size"],
                                       1).astype(np.float32)
    model = _model(state, variant)
    packed = s2d.refold_params(model)
    with torch.no_grad():
        got = _softmax(s2d.apply(model, packed, torch.from_numpy(x)))
        plain = _softmax(model(torch.from_numpy(x), return_logits=True))
    want = np.asarray(_jax_apply(params, jax_s2d.refold_params(
        params, hp, variant), jnp.asarray(x), hp, variant))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, plain, rtol=0, atol=2e-5)


def test_apply_bf16_close():
    params, state = _params("legacy", 4)
    hp = JaxHParams(**CONFIGS["legacy"])
    x = np.random.RandomState(5).randn(1, 64, 64, 1).astype(np.float32)
    model = _model(state, "legacy", torch.bfloat16)
    with torch.no_grad():
        got = _softmax(s2d.apply(model, s2d.refold_params(model),
                                 torch.from_numpy(x)))
        plain = _softmax(model(torch.from_numpy(x), return_logits=True))
    want = np.asarray(_jax_apply(params, jax_s2d.refold_params(
        params, hp, "legacy"), jnp.asarray(x), hp, "legacy",
        compute_dtype=jnp.bfloat16))
    assert float(np.abs(got - want).max()) < 0.02
    assert float(np.abs(got - plain).max()) < 0.02


def test_refusals_match_jax():
    _, state = _params("legacy", 6)
    model = _model(state, "legacy")
    packed = s2d.refold_params(model)
    with pytest.raises(ValueError, match="even"):
        s2d.apply(model, packed, torch.zeros((1, 63, 63, 1)))
    for bad, match in ((dict(ks=4), "odd"),
                       (dict(down_samp_fact=3), "down_samp_fact")):
        model.hp = HParams(**{**CONFIGS["legacy"], **bad})
        with pytest.raises(ValueError, match=match):
            s2d.refold_params(model)
    with pytest.raises(ValueError, match="odd"):
        s2d.refold_conv(np.zeros((4, 4, 1, 1), np.float32))
    with pytest.raises(ValueError, match="s2d"):
        InferenceEngine(HParams(**CONFIGS["legacy"]), state, "legacy", 0.2,
                        0.16, quantized=True, s2d=True, device="cpu")


def test_engine_s2d_matches_jax_and_standard():
    params, state = _params("legacy", 8)
    raw = (np.random.RandomState(9).rand(150, 170) * 60000).astype(np.uint16)
    want = JaxEngine(JaxHParams(**CONFIGS["legacy"]), params, "legacy", 0.2,
                     0.16, tile_batch=8, s2d=True).infer_slide(raw)

    def port(**kw):
        return InferenceEngine(HParams(**CONFIGS["legacy"]), state, "legacy",
                               0.2, 0.16, tile_batch=8, device="cpu",
                               **kw).infer_slide(raw)

    got = port(s2d=True)
    for other in (want, port()):
        assert got.shape == other.shape
        assert int(np.abs(got.astype(int) - other.astype(int)).max()) <= 1


def test_level0_override_is_plain_inference_only():
    """The packed level 0 rides ``UNet.forward_nchw(level0=)``, which
    refuses to train, quantize or tap through it."""
    model = _model(_params("legacy", 0)[1], "legacy")
    lv = s2d._Level0(model, s2d.refold_params(model))
    x = torch.zeros((1, 1, 64, 64))
    for kw in ({"train": True}, {"quant": {"kernels": {}, "scales": {}}},
               {"tap": lambda site, h: None}):
        with pytest.raises(ValueError, match="plain inference"):
            model.forward_nchw(x, level0=lv, **kw)
