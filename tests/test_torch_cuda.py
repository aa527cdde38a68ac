"""The CUDA kernels K1 and K2 against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc (the kernels have no CPU
interpret mode) and skip elsewhere.  They import no JAX, so they also run
on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from unmicst_tpu_torch import kernels
from unmicst_tpu_torch.core import tiler as tt

_GEOMS = [((100, 120), 64, 8, 3), ((60, 60), 32, 4, 1), ((200, 90), 64, 8, 2)]


@pytest.fixture
def cuda():
    """The card, or a skip: CUDA kernels have no CPU interpret mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _weighted_case(shape, patch, margin, k, seed):
    rng = np.random.RandomState(seed)
    g = tt.make_grid(shape[0], shape[1], patch, margin)
    logits = rng.randn(g.num_tiles, k, patch, patch).astype(np.float32) * 2
    return g, logits, tt.ramp_window(patch, margin)


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_card(cuda):
    rng = np.random.RandomState(0)
    for t, k, p in [(37, 3, 128), (5, 2, 64), (3, 1, 32)]:
        logits = torch.from_numpy(rng.randn(t, k, p, p).astype(np.float32))
        win = torch.from_numpy(tt.ramp_window(p, max(1, p // 8)))
        mask = torch.from_numpy((rng.rand(t) > 0.3).astype(np.float32))
        before = kernels.softmax_blend.launches
        got = kernels.softmax_blend(logits.to(cuda), win.to(cuda),
                                    mask.to(cuda))
        torch.cuda.synchronize()
        assert kernels.softmax_blend.launches == before + 1
        ref = kernels.softmax_blend_plain(logits, win, mask)
        np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,patch,margin,k", _GEOMS)
def test_k2_kernels_match_plain_on_card(cuda, shape, patch, margin, k):
    g, logits, win = _weighted_case(shape, patch, margin, k, seed=3)
    w = torch.from_numpy(win)
    x = torch.from_numpy(logits)
    ref = kernels.blend_fold_epilogue(x, w, g)
    got = kernels.blend_fold_epilogue(x.to(cuda), w.to(cuda), g)
    torch.cuda.synchronize()
    assert np.abs(got.cpu().numpy().astype(int)
                  - ref.numpy().astype(int)).max() <= 1
    t5 = x.reshape(g.npr, g.npc, k, patch, patch).permute(0, 1, 3, 4, 2)
    got_a = kernels.blend_fold(t5.to(cuda), w.to(cuda), g)  # strided input
    np.testing.assert_allclose(got_a.cpu().numpy(),
                               kernels.blend_fold(t5, w, g).numpy(),
                               atol=1e-5)
