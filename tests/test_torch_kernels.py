"""Port kernels K1 and K2: plain versions against the Pallas kernels
(interpret mode, as tests/test_kernels.py runs them) and the JAX
composition.  The CUDA launches are held against these plain versions in
tests/test_torch_cuda.py, which runs only where there is a card."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmicst_tpu.core import tiler as jt
from unmicst_tpu_torch import kernels
from unmicst_tpu_torch.core import tiler as tt

_EXHIBITS = os.path.join(os.path.dirname(__file__), "..", "exhibits", "pallas")


def _load_exhibit(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_test_exhibit_{name}", os.path.join(_EXHIBITS, f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- K1 ------------------------------------------------------------------------


@pytest.mark.parametrize("t,k,p", [(6, 3, 128), (4, 2, 128), (5, 3, 64)])
def test_k1_plain_matches_pallas(t, k, p):
    fused_tail = _load_exhibit("fused_tail")
    rng = np.random.RandomState(t * k + p)
    logits = rng.randn(t, k, p, p).astype(np.float32) * 3
    win = jt.ramp_window(p, p // 8)
    mask = (rng.rand(t) > 0.3).astype(np.float32)
    ref = np.asarray(fused_tail.softmax_blend_weights(
        jnp.asarray(logits), win, jnp.asarray(mask), interpret=True))
    got = kernels.softmax_blend(torch.from_numpy(logits),
                                torch.from_numpy(win), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    assert kernels.softmax_blend.launches == 0  # the plain path is uncounted


def test_k1_writes_into_out_and_checks_inputs():
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(3, 3, 32, 32).astype(np.float32))
    win = torch.from_numpy(tt.ramp_window(32, 4))
    mask = torch.ones(3)
    buf = torch.zeros(5, 3, 32, 32)
    out = kernels.softmax_blend(logits, win, mask, out=buf[1:4])
    assert out.data_ptr() == buf[1:4].data_ptr()
    np.testing.assert_allclose(
        buf[1:4].numpy(),
        kernels.softmax_blend_plain(logits, win, mask).numpy(), atol=0)
    with pytest.raises(ValueError):
        kernels.softmax_blend(logits, win[:16], mask)
    with pytest.raises(TypeError):
        kernels.softmax_blend(logits.double(), win, mask)
    with pytest.raises(ValueError):
        kernels.softmax_blend(logits.transpose(2, 3), win, mask)


@pytest.mark.parametrize("case", ["four_classes", "odd_side", "unaligned"])
def test_k1_rejects_what_the_kernel_does_not_take(case):
    """The kernel reads four pixels at a time with 16-byte loads and holds
    at most 3 classes; the wrapper refuses anything else on every device."""
    t, k, p = 2, 3, 32
    if case == "four_classes":
        k = 4
    elif case == "odd_side":
        p = 31
    logits = torch.zeros(t * k * p * p + 1)
    logits = (logits[1:] if case == "unaligned" else logits[:-1]).reshape(
        t, k, p, p)
    win = torch.from_numpy(tt.ramp_window(p, 4))
    with pytest.raises(ValueError, match={"four_classes": "classes",
                                          "odd_side": "multiple of 4",
                                          "unaligned": "aligned"}[case]):
        kernels.softmax_blend(logits, win, torch.ones(t))


# -- K2 ------------------------------------------------------------------------

_GEOMS = [((100, 120), 64, 8, 3), ((60, 60), 32, 4, 1), ((200, 90), 64, 8, 2)]


@pytest.mark.parametrize("shape,patch,margin,k", _GEOMS)
def test_k2a_plain_matches_pallas(shape, patch, margin, k):
    blend = _load_exhibit("blend")
    rng = np.random.RandomState(patch + k)
    g = jt.make_grid(shape[0], shape[1], patch, margin)
    tiles = rng.rand(g.npr, g.npc, patch, patch, k).astype(np.float32)
    win = jt.ramp_window(patch, margin)
    ref = np.asarray(blend.blend_fold_pallas(jnp.asarray(tiles), win, g,
                                             interpret=True))
    got = kernels.blend_fold(
        torch.from_numpy(tiles), torch.from_numpy(win),
        tt.make_grid(shape[0], shape[1], patch, margin))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def _weighted_case(shape, patch, margin, k, seed):
    """K1-weighted tiles [T, K, P, P] (softmax of random logits)."""
    rng = np.random.RandomState(seed)
    g = tt.make_grid(shape[0], shape[1], patch, margin)
    logits = rng.randn(g.num_tiles, k, patch, patch).astype(np.float32) * 2
    win = tt.ramp_window(patch, margin)
    return g, logits, win


@pytest.mark.parametrize("shape,patch,margin,k", _GEOMS)
@pytest.mark.parametrize("classes", [None, "subset"])
def test_k2b_plain_matches_jax_composition(shape, patch, margin, k, classes):
    """fold + count + divide + crop + uint8 against the JAX engine's
    composition (``infer.py:299-343,620-624``)."""
    g, logits, win = _weighted_case(shape, patch, margin, k, seed=k + patch)
    gj = jt.make_grid(shape[0], shape[1], patch, margin)
    cls = None if classes is None else tuple(range(k))[::-1][:2]
    probs = jax.nn.softmax(jnp.asarray(logits), axis=1)
    w = jnp.asarray(win)[None, None]
    weighted = probs * w  # mask 1: real tiles only
    t5 = jnp.moveaxis(weighted, 1, -1).reshape(gj.npr, gj.npc, patch, patch, k)
    acc = jt.fold(t5, gj)
    count = jt.count_map(gj, jnp.asarray(win))
    valid = jt.crop_valid(acc / count[..., None], gj)
    if cls is not None:
        valid = valid[..., list(cls)]
    ref = np.moveaxis(np.asarray((valid * 255.0).astype(jnp.uint8)), -1, 0)
    got = kernels.blend_fold_epilogue(
        torch.from_numpy(np.array(weighted)), torch.from_numpy(win), g,
        classes=cls)
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1
    fl = kernels.blend_fold_epilogue(
        torch.from_numpy(np.array(weighted)), torch.from_numpy(win), g,
        classes=cls, quantize=False)
    np.testing.assert_allclose(fl.numpy(), np.moveaxis(np.asarray(valid),
                                                       -1, 0), atol=1e-6)


def test_k2_checks_inputs():
    g, logits, win = _weighted_case((60, 60), 32, 4, 2, seed=1)
    w = torch.from_numpy(win)
    x = torch.from_numpy(logits)
    with pytest.raises(ValueError):
        kernels.blend_fold_epilogue(x[1:], w, g)
    with pytest.raises(ValueError):
        kernels.blend_fold_epilogue(x, w, g, classes=(2,))
    with pytest.raises(ValueError):
        kernels.blend_fold(x, w, g)
