"""Port tiler (unmicst_tpu_torch.core.tiler) against unmicst_tpu.core.tiler."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmicst_tpu.core import tiler as jt
from unmicst_tpu_torch.core import tiler as tt

# the geometries of test_tiler.py and test_kernels.py:44-47
GEOMETRIES = [
    ((832, 960), 128, 16), ((96, 96), 64, 8), ((200, 333), 64, 8),
    ((64, 64), 128, 16), ((100, 120), 64, 8), ((60, 60), 32, 4),
    ((200, 90), 64, 8),
]


@pytest.mark.parametrize("shape,patch,margin", GEOMETRIES)
def test_grid_window_pad_unfold_fold_count_crop(shape, patch, margin):
    rng = np.random.RandomState(sum(shape) + patch)
    h, w = shape
    g, gj = tt.make_grid(h, w, patch, margin), jt.make_grid(h, w, patch, margin)
    for attr in ("sub", "npr", "npc", "padded_height", "padded_width",
                 "num_tiles"):
        assert getattr(g, attr) == getattr(gj, attr)
    win = tt.ramp_window(patch, margin)
    np.testing.assert_array_equal(win, jt.ramp_window(patch, margin))

    img = rng.rand(h, w, 2).astype(np.float32)
    canvas = tt.pad_canvas(torch.from_numpy(img), g)
    canvas_j = np.asarray(jt.pad_canvas(jnp.asarray(img), gj))
    np.testing.assert_array_equal(canvas.numpy(), canvas_j)

    tiles = tt.unfold(canvas, g)
    np.testing.assert_array_equal(
        tiles.numpy(), np.asarray(jt.unfold(jnp.asarray(canvas_j), gj)))
    # a view of the canvas, no copy
    assert tiles.untyped_storage().data_ptr() == \
        canvas.untyped_storage().data_ptr()

    t5 = rng.rand(g.npr, g.npc, patch, patch, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tt.fold(torch.from_numpy(t5), g).numpy(),
        np.asarray(jt.fold(jnp.asarray(t5), gj)))
    np.testing.assert_allclose(
        tt.count_map(g, torch.from_numpy(win)).numpy(),
        np.asarray(jt.count_map(gj, jnp.asarray(win))), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tt.crop_valid(canvas, g).numpy(),
        np.asarray(jt.crop_valid(jnp.asarray(canvas_j), gj)))


def test_unfold_fold_roundtrip_identity():
    """fold(unfold(x) * window) / count == x on the valid region."""
    rng = np.random.RandomState(0)
    g = tt.make_grid(150, 170, 64, 8)
    img = torch.from_numpy(rng.rand(150, 170).astype(np.float32))
    win = torch.from_numpy(tt.ramp_window(64, 8))
    acc = tt.fold(tt.unfold(tt.pad_canvas(img, g), g) * win, g)
    out = tt.crop_valid(acc / tt.count_map(g, win), g)
    np.testing.assert_allclose(out.numpy(), img.numpy(), atol=1e-6)


def test_grid_rejects_bad_margin():
    with pytest.raises(ValueError):
        tt.make_grid(100, 100, 64, 32)  # sub == 0
    with pytest.raises(ValueError):
        tt.make_grid(100, 100, 64, 25)  # sub 14 < 2*margin
    with pytest.raises(ValueError):
        tt.make_grid(100, 100, 64, 0)
