"""The port's 3D tiler (``unmicst_tpu_torch/core/tiler3d.py``, ROADMAP
M14f) against ``unmicst_tpu.core.tiler3d`` at atol 1e-6, with the JAX
tests' own scatter check and guards."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmicst_tpu.core import tiler3d as J
from unmicst_tpu_torch.core import tiler3d as T

SHAPES = [(40, 50, 60), (20, 20, 20), (7, 33, 12)]


@pytest.mark.parametrize("patch,margin", [(16, 2), (12, 1), (24, 5)])
def test_ramp_window3d_bit_for_bit(patch, margin):
    for dtype in (np.float32, np.float64):
        got = T.ramp_window3d(patch, margin, dtype)
        want = np.asarray(J.ramp_window3d(patch, margin, dtype))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_tiling_matches_jax_and_the_scatter(shape):
    """Pad, unfold, fold and count against the JAX tiler, and against the
    JAX test's explicit scatter loop; the blend divides back to the
    volume."""
    z, h, w = shape
    patch, margin = 16, 2
    rng = np.random.RandomState(sum(shape))
    g = T.make_grid3d(z, h, w, patch, margin)
    gj = J.make_grid3d(z, h, w, patch, margin)
    vol = rng.rand(z, h, w).astype(np.float32)
    win = T.ramp_window3d(patch, margin)
    padded = T.pad_canvas3d(torch.from_numpy(vol), g)
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(J.pad_canvas3d(jnp.array(vol), gj)))
    tiles = T.unfold3d(padded, g)
    jt = J.unfold3d(jnp.array(padded.numpy()), gj)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jt))

    pz, pr, pc = g.padded
    out = np.zeros((pz, pr, pc))
    cnt = np.zeros_like(out)
    tn, pn = tiles.numpy(), padded.numpy()
    for iz in range(g.npz):
        for ir in range(g.npr):
            for ic in range(g.npc):
                z0, r0, c0 = iz * g.sub, ir * g.sub, ic * g.sub
                box = (slice(z0, z0 + patch), slice(r0, r0 + patch),
                       slice(c0, c0 + patch))
                np.testing.assert_array_equal(tn[iz, ir, ic], pn[box])
                out[box] += tn[iz, ir, ic] * win
                cnt[box] += win

    wt = torch.from_numpy(win)
    folded = T.fold3d(tiles * wt, g)
    count = T.count_map3d(g, wt)
    np.testing.assert_allclose(folded.numpy(), np.asarray(
        J.fold3d(jt * jnp.array(win), gj)), atol=1e-6)
    np.testing.assert_allclose(count.numpy(), np.asarray(
        J.count_map3d(gj, jnp.array(win))), atol=1e-6)
    np.testing.assert_allclose(folded.numpy(), out, atol=1e-4)
    np.testing.assert_allclose(count.numpy(), cnt, atol=1e-4)
    valid = T.crop_valid3d(folded / count.clamp_min(1e-12), g)
    np.testing.assert_allclose(valid.numpy(), vol, atol=1e-5)
    np.testing.assert_array_equal(
        T.crop_valid3d(padded, g).numpy(), vol)


def test_count_map3d_is_the_fold_of_the_window_stack():
    """Folded one axis at a time, the count equals the fold of the full
    broadcast stack bit for bit (the same pairs added in the same order)."""
    g = T.make_grid3d(30, 41, 22, 12, 2)
    w = torch.from_numpy(T.ramp_window3d(12, 2, np.float64))
    stack = w.expand(g.npz, g.npr, g.npc, 12, 12, 12)
    assert torch.equal(T.count_map3d(g, w), T.fold3d(stack, g))


def test_trailing_channels():
    """A ``[Z, H, W, C]`` volume tiles and folds per channel."""
    rng = np.random.RandomState(3)
    vol = rng.rand(18, 21, 25, 2).astype(np.float32)
    g = T.make_grid3d(18, 21, 25, 12, 2)
    gj = J.make_grid3d(18, 21, 25, 12, 2)
    tiles = T.unfold3d(T.pad_canvas3d(torch.from_numpy(vol), g), g)
    jt = J.unfold3d(J.pad_canvas3d(jnp.array(vol), gj), gj)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jt))
    np.testing.assert_allclose(T.fold3d(tiles, g).numpy(),
                               np.asarray(J.fold3d(jt, gj)), atol=1e-6)


def test_grid3d_validation():
    for args in ((0, 10, 10, 16, 2), (10, 10, 10, 16, 0),
                 (10, 10, 10, 16, -1), (10, 10, 10, 4, 2),
                 (10, 10, 10, 10, 3)):
        with pytest.raises(ValueError):
            J.make_grid3d(*args)
        with pytest.raises(ValueError):
            T.make_grid3d(*args)


def test_shape_guards():
    g = T.make_grid3d(10, 12, 14, 16, 2)
    with pytest.raises(ValueError, match="does not match"):
        T.pad_canvas3d(torch.zeros((10, 12, 15)), g)
    with pytest.raises(ValueError, match="does not match"):
        T.unfold3d(torch.zeros((10, 12, 14)), g)
