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


def _ring(n, shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 1 << 15, shape, generator=g).to(dtype).to(device)
            for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("shift", [1, -1])
def test_ring_kernels_match_plain_on_card(cuda, n, shift):
    """K3 and the K4a/K4b pair, ranks sharing the card: bit-equal to the
    plain copy, for an aligned float buffer and one whose byte size is not
    a multiple of 16."""
    for shape, dtype in [((32, 70, 3), torch.float32), ((7, 13), torch.int16)]:
        xs = _ring(n, shape, dtype, cuda, seed=n)
        ref = kernels.ring_shift_plain(xs, shift)
        before = kernels.launch_counts()
        got = kernels.ring_shift(xs, shift, kind="output")
        pair = kernels.ring_shift_wait(kernels.ring_shift_start(xs, shift))
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        for name in ("ring_shift", "ring_shift_start", "ring_shift_wait"):
            assert after[name] == before[name] + n
        for a, b, r in zip(got, pair, ref):
            assert torch.equal(a, r) and torch.equal(b, r)


@pytest.mark.cuda
def test_k2_region_entries_match_plain_on_card(cuda):
    g, logits, win = _weighted_case((100, 120), 64, 8, 3, seed=4)
    x, w = torch.from_numpy(logits), torch.from_numpy(win)
    strip = kernels.blend_fold_strip(x.to(cuda), g)
    np.testing.assert_allclose(strip.cpu().numpy(),
                               kernels.blend_fold_strip(x, g).numpy(),
                               atol=1e-5)
    rmask = torch.tensor([0.0] + [1.0] * (g.npr - 1))
    cmask = torch.tensor([1.0] * (g.npc - 1) + [0.0])
    add = torch.rand(40, 20, 3)
    kw = dict(row_mask=rmask, col_mask=cmask, classes=(2, 0), addend=add)
    for mode in ("u8", "f32", "raw"):
        ref = kernels.blend_fold_stripe(x, w, g, (30, 40), (5, 90), mode=mode,
                                        **kw)
        got = kernels.blend_fold_stripe(
            x.to(cuda), w.to(cuda), g, (30, 40), (5, 90), mode=mode,
            **{k: v.to(cuda) if torch.is_tensor(v) else v
               for k, v in kw.items()})
        diff = (got.cpu().double() - ref.double()).abs().max().item()
        assert diff <= (1 if mode == "u8" else 1e-5), (mode, diff)


def _small_net(seed=0):
    from unmicst_tpu_torch.core.hp import HParams
    from unmicst_tpu_torch.core.unet import UNet

    hp = HParams(im_size=32, n_channels=1, n_classes=3, n_out0=4, ks=3,
                 n_extra_convs=0, n_layers=2, batch_size=8)
    g = torch.Generator().manual_seed(seed)
    state = {k: (0.5 + torch.rand(v.shape, generator=g)
                 if k.endswith(("gamma", "moving_variance"))
                 else 0.2 * torch.randn(v.shape, generator=g))
             for k, v in UNet(hp, "legacy").state_dict().items()}
    return hp, state


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["ppermute", "ring", "ring_overlap"])
def test_spatial_infer_on_card_matches_cpu(cuda, impl):
    from unmicst_tpu_torch.runtime import halo
    from unmicst_tpu_torch.runtime.mesh import make_mesh

    hp, state = _small_net()
    img = np.random.RandomState(1).rand(400, 90).astype(np.float32)
    canvas = halo.build_canvas(img, hp, 4)
    kw = dict(mean=0.3, std=0.2, halo_impl=impl)
    ref = halo.spatial_infer(state, canvas, 400, 90, hp, "legacy",
                             make_mesh(devices=["cpu"] * 4), **kw)
    got = halo.spatial_infer(state, canvas, 400, 90, hp, "legacy",
                             make_mesh(devices=[cuda] * 4), **kw)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=2e-5)


@pytest.mark.cuda
def test_streaming_on_card_matches_cpu(cuda):
    from unmicst_tpu_torch.runtime.mesh import make_mesh
    from unmicst_tpu_torch.runtime.pipeline import StreamingEngine

    hp, state = _small_net()
    raw = (np.random.RandomState(2).rand(300, 230) * 60000).astype(np.uint16)
    on = {d: StreamingEngine(hp, state, "legacy", 0.3, 0.2, compute_dtype=None,
                             stripe_tile_rows=3, in_flight=2, device=d)
          for d in ("cpu", cuda)}
    ref = on["cpu"].infer(raw)
    kernels.reset_launch_counts()
    for got in (on[cuda].infer(raw),
                on[cuda].infer_sharded(raw, make_mesh(devices=[cuda] * 3))):
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert kernels.launch_counts()["ring_shift"] > 0  # the seams ran K3
