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
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("shift", [1, -1])
def test_ring_kernels_match_plain_on_card(cuda, n, shift, monkeypatch):
    """K3 and the K4a/K4b pair, ranks sharing the card: bit-equal to the
    plain copy, for an aligned float buffer, one whose byte size is not a
    multiple of 16 and a view 4 bytes off 16-byte alignment, then over 1000
    back-to-back hops whose completion words start 10 hops short of 2^32.
    On one card a hop is one store launch, K3 launches no wait and K4b one."""
    from unmicst_tpu_torch.kernels import halo_ring

    views = [t[1:].view(32, 70, 3)  # 4 bytes past the allocation's start
             for t in _ring(n, (1 + 32 * 70 * 3,), torch.float32, cuda, 7)]
    assert all(v.data_ptr() % 16 == 4 for v in views)
    for xs in (_ring(n, (32, 70, 3), torch.float32, cuda, seed=n),
               _ring(n, (7, 13), torch.int16, cuda, seed=n), views):
        ref = kernels.ring_shift_plain(xs, shift)
        before = kernels.launch_counts()
        got = kernels.ring_shift(xs, shift, kind="output")
        pair = kernels.ring_shift_wait(kernels.ring_shift_start(xs, shift))
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        for name in ("ring_shift", "ring_shift_start", "ring_shift_wait"):
            assert after[name] == before[name] + 1, name
        for a, b, r in zip(got, pair, ref):
            assert torch.equal(a, r) and torch.equal(b, r)

    xs = _ring(n, (32, 70, 3), torch.float32, cuda, seed=n + 1)
    ref = kernels.ring_shift_plain(xs, shift)
    cards = (cuda.index or 0,) * n
    blocks = halo_ring.blocks_per_segment(xs[0].numel() * 4, n)
    start = 2**32 - 10 * blocks
    ring = halo_ring._Ring(cards)  # a fresh ring, its words set near 2^32
    for i in range(n):
        ring.words[i].fill_(start - 2**32)  # the int32 of start
        for k in halo_ring.KINDS.values():
            for j in range(n):
                ring.counters.value[(k, i, j)] = start
    torch.cuda.synchronize()
    monkeypatch.setitem(halo_ring._rings, cards, ring)
    for hop in range(1000):
        got = kernels.ring_shift(xs, shift, kind="input")
        pair = kernels.ring_shift_wait(kernels.ring_shift_start(xs, shift))
        for a, b, r in zip(got, pair, ref):
            assert torch.equal(a, r) and torch.equal(b, r), hop
    torch.cuda.synchronize()
    target = (start + 1000 * blocks) % 2**32
    assert target < start  # the counts crossed 2^32
    for i in range(n):  # rank i's words: only its source's has counted
        row = ring.words[i][halo_ring.KINDS["start"]].cpu().numpy()
        assert (row.astype(np.int64) % 2**32).tolist() == [
            target if j == (i - shift) % n else start for j in range(n)]


def _cards(cuda):
    """Every visible card, or a skip: the peer-store path needs two."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards: peer stores cross cards")
    return [torch.device("cuda", c) for c in range(n)]


def _sync(cards):
    for d in cards:
        torch.cuda.synchronize(d)


@pytest.mark.cuda
@pytest.mark.parametrize("per_card", [1, 2])
def test_ring_kernels_across_cards(cuda, per_card):
    """Ranks spread over every visible card: stores into a peer card's
    memory released at system scope, waits on the destinations' streams,
    events for the landing buffers' allocation points.  Bit-equal to the
    plain copy; one store launch per card and, as each card receives
    exactly one segment from another card, one wait per card (K3 and K4b)."""
    cards = _cards(cuda)
    devs = [d for d in cards for _ in range(per_card)]
    n = len(devs)
    views = [torch.from_numpy(np.arange(1 + 32 * 70 * 3, dtype=np.float32)
                              * (k + 1)).to(d)[1:].view(32, 70, 3)
             for k, d in enumerate(devs)]
    for xs in ([x.to(d) for x, d in zip(
                   _ring(n, (32, 70, 3), torch.float32, "cpu", seed=n), devs)],
               [x.to(d) for x, d in zip(
                   _ring(n, (7, 13), torch.int16, "cpu", seed=n), devs)],
               views):
        for shift in (1, -1):
            ref = kernels.ring_shift_plain(xs, shift)
            before = kernels.launch_counts()
            got = kernels.ring_shift(xs, shift, kind="output")
            pair = kernels.ring_shift_wait(kernels.ring_shift_start(xs, shift))
            _sync(cards)
            after = kernels.launch_counts()
            assert after["ring_shift"] - before["ring_shift"] == 2 * len(cards)
            assert (after["ring_shift_start"] - before["ring_shift_start"]
                    == len(cards))
            assert (after["ring_shift_wait"] - before["ring_shift_wait"]
                    == len(cards))
            for a, b, r, d in zip(got, pair, ref, devs):
                assert a.device == d and b.device == d
                assert torch.equal(a, r) and torch.equal(b, r)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["ring", "ring_overlap"])
def test_halo_and_sharded_stream_across_cards_match_cpu(cuda, impl):
    """spatial_infer and the sharded stream with 4 ranks over every
    visible card (peer stores) against the same on the CPU."""
    from unmicst_tpu_torch.runtime import halo
    from unmicst_tpu_torch.runtime.mesh import make_mesh
    from unmicst_tpu_torch.runtime.pipeline import StreamingEngine

    cards = _cards(cuda)
    ranks = [cards[k % len(cards)] for k in range(4)]
    hp, state = _small_net()
    img = np.random.RandomState(1).rand(400, 90).astype(np.float32)
    canvas = halo.build_canvas(img, hp, 4)
    kw = dict(mean=0.3, std=0.2, halo_impl=impl)
    ref = halo.spatial_infer(state, canvas, 400, 90, hp, "legacy",
                             make_mesh(devices=["cpu"] * 4), **kw)
    got = halo.spatial_infer(state, canvas, 400, 90, hp, "legacy",
                             make_mesh(devices=ranks), **kw)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=2e-5)
    if impl == "ring":
        raw = (np.random.RandomState(2).rand(300, 230) * 60000).astype(
            np.uint16)
        on = {d: StreamingEngine(hp, state, "legacy", 0.3, 0.2,
                                 compute_dtype=None, stripe_tile_rows=3,
                                 in_flight=2, device=d)
              for d in ("cpu", cuda)}
        want = on["cpu"].infer_sharded(raw, make_mesh(devices=["cpu"] * 4))
        have = on[cuda].infer_sharded(raw, make_mesh(devices=ranks))
        assert np.abs(have.astype(int) - want.astype(int)).max() <= 1


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
