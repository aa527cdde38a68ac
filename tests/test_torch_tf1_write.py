"""The port's TF1 writer (``core/tf1_ckpt.write_tf1_checkpoint``,
``core/checkpoint.save_tf1_params``) against the JAX package's: the same
tensors give byte-equal ``.index`` and ``.data`` files, and the port's
reader gives back the state it was written from."""

import os

import jax
import numpy as np
import pytest
import torch

from unmicst_tpu.core import tf1_ckpt as jax_tf1
from unmicst_tpu.core import unet as junet
from unmicst_tpu.core.checkpoint import save_tf1_params as jax_save
from unmicst_tpu.core.hp import HParams as JaxHParams
from unmicst_tpu_torch.core import tf1_ckpt
from unmicst_tpu_torch.core.checkpoint import (load_tf1_params,
                                               params_from_jax,
                                               save_tf1_params)
from unmicst_tpu_torch.core.hp import HParams

_HP = dict(im_size=32, n_channels=2, n_classes=3, n_out0=6, ks=3,
           n_extra_convs=1, n_layers=2, batch_size=8, std_dev0=0.5)


def _params(jhp, variant, seed):
    """A JAX-layout params tree of seeded numpy values (the shapes from
    ``init_params`` traced, not run: nothing compiles)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(
        lambda: junet.init_params(jax.random.PRNGKey(0), jhp, variant))
    return jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(s.dtype), shapes)


def _files(prefix):
    return [open(prefix + ext, "rb").read()
            for ext in (".index", ".data-00000-of-00001")]


@pytest.mark.parametrize("n", [0, 1, 9, 4095, 65535, 65536, 65537, 200003,
                               1 << 20])
def test_crc32c_matches_the_byte_loop(n):
    """The lane-parallel CRC32-C equals the JAX package's byte loop at
    every length class: the byte loop below 64 KiB, lanes plus a tail
    above it."""
    data = np.random.RandomState(n).bytes(n)
    assert tf1_ckpt._masked_crc32c(data) == jax_tf1._masked_crc32c(data)


def test_write_tf1_checkpoint_is_byte_equal(tmp_path):
    rng = np.random.RandomState(0)
    tensors = {
        "a/kernel": rng.randn(3, 3, 2, 5).astype(np.float32),
        "b": rng.randn(7).astype(np.float64),
        "c/step": np.asarray(12, np.int32),
        "d/big": rng.randn(300, 300).astype(np.float32),  # > 64 KiB
        "e": np.arange(5, dtype=np.int64),
    }
    jax_tf1.write_tf1_checkpoint(str(tmp_path / "j"), tensors)
    tf1_ckpt.write_tf1_checkpoint(str(tmp_path / "t"), tensors)
    assert _files(str(tmp_path / "j")) == _files(str(tmp_path / "t"))
    ck = tf1_ckpt.TF1Checkpoint(str(tmp_path / "t"))
    for name, arr in tensors.items():
        np.testing.assert_array_equal(ck.get_tensor(name), arr)
    with pytest.raises(TypeError, match="unsupported dtype"):
        tf1_ckpt.write_tf1_checkpoint(str(tmp_path / "x"),
                                      {"u": np.zeros(2, np.uint16)})


@pytest.mark.parametrize("variant", ["legacy", "v2"])
def test_save_tf1_params_is_byte_equal_and_round_trips(tmp_path, variant):
    jhp, hp = JaxHParams(**_HP), HParams(**_HP)
    params = _params(jhp, variant, 3)
    state = params_from_jax(params, hp, variant)
    jax_save(str(tmp_path / "j"), params, jhp, variant, global_step=7)
    save_tf1_params(str(tmp_path / "t"), state, hp, variant, global_step=7)
    assert _files(str(tmp_path / "j")) == _files(str(tmp_path / "t"))
    back = load_tf1_params(str(tmp_path / "t"), hp, variant)
    assert sorted(back) == sorted(state)
    for k in state:
        assert torch.equal(back[k], state[k]), k
    step = tf1_ckpt.TF1Checkpoint(str(tmp_path / "t")).get_tensor("Variable")
    assert step.dtype == np.int32 and step.item() == 7


def test_save_tf1_params_writes_a_bfloat16_state_as_float32(tmp_path):
    """A bfloat16 state is written as float32 in TF's layouts; the reader
    gives back its values."""
    hp = HParams(**_HP)
    jhp = JaxHParams(**_HP)
    params = _params(jhp, "legacy", 4)
    state = params_from_jax(params, hp, "legacy")
    odd = {k: v.to(torch.bfloat16) for k, v in state.items()}
    save_tf1_params(str(tmp_path / "b"), odd, hp, "legacy")
    back = load_tf1_params(str(tmp_path / "b"), hp, "legacy")
    for k in state:
        assert torch.equal(back[k], odd[k].float()), k
    assert os.path.exists(str(tmp_path / "b.data-00000-of-00001"))
