"""Port UNet (unmicst_tpu_torch.core.unet) against the executed TF graphs
and against the JAX ``unet.apply`` on the same weights, on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmicst_tpu.core import unet as jax_unet
from unmicst_tpu.core.hp import HParams as JaxHParams
from unmicst_tpu.core.tf1_ckpt import write_tf1_checkpoint
from unmicst_tpu_torch.core.checkpoint import load_tf1_params, params_from_jax
from unmicst_tpu_torch.core.hp import HParams
from unmicst_tpu_torch.core.tf1_ckpt import TF1Checkpoint
from unmicst_tpu_torch.core.unet import UNet

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


def _module(state, hp, variant):
    model = UNet(hp, variant)
    model.load_state_dict(state)
    return model.eval()


@pytest.mark.parametrize("variant", ["legacy", "v2", "duo", "cyto2"])
def test_tf1_oracle_fixture(variant):
    """All four executed-TF fixtures, at the bar of test_oracle_parity."""
    d = os.path.join(FIXDIR, f"oracle_{variant}")
    with open(os.path.join(d, "hp.json")) as f:
        hp = HParams.from_ref_dict(json.load(f))
    io = np.load(os.path.join(d, "io.npz"))
    model = _module(load_tf1_params(os.path.join(d, "model.ckpt"), hp,
                                    variant), hp, variant)
    with torch.no_grad():
        got = model(torch.from_numpy(io["x"])).numpy()
    np.testing.assert_allclose(got, io["probs"], atol=5e-5, rtol=1e-4)


# (variant, ks, n_extra, n_channels): with and without the residual fold
# (a 1x1 legacy shortcut embeds at the centre tap when n_extra == 0)
_CONFIGS = [
    ("legacy", 5, 1, 1), ("legacy", 3, 0, 1), ("v2", 3, 0, 1),
    ("v2", 3, 1, 1), ("cyto2", 3, 1, 1), ("duo", 3, 0, 2),
]
_init_params = jax.jit(jax_unet.init_params, static_argnums=(1, 2))
_apply = jax.jit(jax_unet.apply, static_argnums=(2, 3),
                 static_argnames=("return_logits", "compute_dtype"))


def _bn(rng, w):
    return {
        "gamma": rng.uniform(-1.5, 1.5, w).astype(np.float32),
        "beta": rng.normal(0, 0.3, w).astype(np.float32),
        "moving_mean": rng.normal(0, 0.3, w).astype(np.float32),
        "moving_variance": rng.uniform(0.5, 2, w).astype(np.float32),
    }


def _numpy_params(hp, variant, rng):
    """A params tree in the ``unet.init_params`` layout, drawn with numpy."""
    legacy = variant == "legacy"
    w, ks, nx = hp.n_out_x, hp.ks, hp.n_extra_convs
    k = lambda *shape: rng.normal(0, 0.2, shape).astype(np.float32)  # noqa
    params = {"down": [], "up": []}
    for i in range(hp.n_layers):
        sk = 1 if legacy else ks
        params["down"].append({
            "kernel1": k(ks, ks, w[i], w[i + 1]),
            "extra": [k(ks, ks, w[i + 1], w[i + 1]) for _ in range(nx)],
            "shortcut": k(sk, sk, w[i], w[i + 1]),
            "bn": _bn(rng, w[i + 1]),
        })
        up = {"kernel1": k(ks, ks, w[i + 1], w[i + 2]),
              "kernel2": k(ks, ks, w[i] + w[i + 1], w[i + 1]),
              "extra": [k(ks, ks, w[i + 1], w[i + 1]) for _ in range(nx)]}
        if not legacy:
            up["bn"] = _bn(rng, w[i + 1])
        params["up"].append(up)
    params["bottom"] = {"kernel1": k(ks, ks, w[-2], w[-1])}
    params["top"] = {"kernel": k(1, 1, w[1], hp.n_classes)}
    if not legacy:
        params["bottom"]["bn"] = _bn(rng, w[-1])
        params["top"]["bn"] = _bn(rng, hp.n_classes)
    return params


def _case(variant, ks, n_extra, n_ch, from_init, seed=3):
    kw = dict(im_size=32, n_channels=n_ch, n_classes=3, n_out0=4, ks=ks,
              n_extra_convs=n_extra, n_layers=2)
    jhp, hp = JaxHParams(**kw), HParams(**kw)
    rng = np.random.RandomState(seed)
    if from_init:
        params = jax.tree_util.tree_map(
            np.asarray, _init_params(jax.random.PRNGKey(seed), jhp, variant))
    else:
        params = _numpy_params(hp, variant, rng)
    x = rng.normal(0, 1, (2, 32, 32, n_ch)).astype(np.float32)
    return jhp, hp, params, x


_APPLY_CASES = (
    [_CONFIGS[0] + (True, False), _CONFIGS[2] + (True, True)]
    + [c + (False, False) for c in _CONFIGS]
    + [_CONFIGS[3] + (False, True)]
)
# bfloat16 mode: bf16 operands, float32 accumulation and output on both
# sides.  Most cases agree to float32 rounding; where one conv output sits
# at a bf16 rounding tie the two sides may round it apart, which reached
# 2.95e-4 (v2, one extra conv, logits).  bf16 against float32 differs by
# 1e-3 to 0.3 on the same cases.
_BF16_ATOL = 5e-4


def _case_id(case):
    return "-".join(str(v) for v in case)


@pytest.mark.parametrize(
    "variant,ks,n_extra,n_ch,from_init,return_logits,bf16",
    [pytest.param(*c, False, id=_case_id(c)) for c in _APPLY_CASES]
    + [pytest.param(*c, True, id=_case_id(c) + "-bfloat16")
       for c in _APPLY_CASES],
)
def test_matches_jax_apply(variant, ks, n_extra, n_ch, from_init,
                           return_logits, bf16):
    """``init_params`` weights (legacy, v2) and numpy-drawn weights with
    random BN statistics through ``unet.apply`` and the port, in float32
    and in the bfloat16 mode."""
    jhp, hp, params, x = _case(variant, ks, n_extra, n_ch, from_init)
    ref = np.asarray(_apply(params, jnp.asarray(x), jhp, variant,
                            compute_dtype=jnp.bfloat16 if bf16 else None,
                            return_logits=return_logits))
    model = UNet(hp, variant,
                 compute_dtype=torch.bfloat16 if bf16 else None)
    model.load_state_dict(params_from_jax(params, hp, variant))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x),
                           return_logits=return_logits).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=_BF16_ATOL if bf16 else 1e-5)


def test_bfloat16_mode_tracks_float32():
    _, hp, params, x = _case("legacy", 5, 1, 1, from_init=True)
    state = params_from_jax(params, hp, "legacy")
    f32 = _module(state, hp, "legacy")
    bf16 = UNet(hp, "legacy", compute_dtype=torch.bfloat16)
    bf16.load_state_dict(state)
    with torch.no_grad():
        a = f32(torch.from_numpy(x)).numpy()
        b = bf16.eval()(torch.from_numpy(x)).numpy()
    assert b.dtype == np.float32
    # bf16 keeps ~3 significant digits through each conv
    assert np.abs(a - b).max() < 0.05


def test_tf1_loader_validates_shapes():
    d = os.path.join(FIXDIR, "oracle_legacy")
    with open(os.path.join(d, "hp.json")) as f:
        hp = HParams.from_ref_dict(json.load(f))
    wrong = HParams(**{**hp.__dict__, "n_out0": hp.n_out0 * 2})
    with pytest.raises(ValueError, match="shape"):
        load_tf1_params(os.path.join(d, "model.ckpt"), wrong, "legacy")


def test_tf1_reader_decodes_bfloat16(tmp_path):
    import ml_dtypes

    vals = np.array([[1.5, -2.25], [3.0e-3, 7.0]], np.float32)
    prefix = str(tmp_path / "m.ckpt")
    write_tf1_checkpoint(prefix, {"w": vals.astype(ml_dtypes.bfloat16),
                                  "f": vals})
    ck = TF1Checkpoint(prefix)
    got = ck.get_tensor("w")
    assert got.dtype == np.float32 and got.shape == (2, 2)
    np.testing.assert_array_equal(
        got, vals.astype(ml_dtypes.bfloat16).astype(np.float32))
    np.testing.assert_array_equal(ck.get_tensor("f"), vals)
