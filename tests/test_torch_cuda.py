"""The CUDA kernels K1 and K2 against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc (the kernels have no CPU
interpret mode) and skip elsewhere.  They import no JAX, so they also run
on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import importlib
import os
import subprocess
import sys

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


# (c0, W, vector path): an odd c0 on the scalar lanes; an aligned c0 on the
# vector path; the same with a ragged last quad (W % 4 == 2)
_REGIONS = [(5, 90, False), (8, 88, True), (8, 90, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("c0,width,vector", _REGIONS)
@pytest.mark.parametrize("classes", [(2, 0), (2, 0, 1, 1, 0)])
def test_k2_region_entries_match_plain_on_card(cuda, c0, width, vector,
                                               classes):
    """The stripe entry with row and column masks, an addend and a class
    subset (five entries: two groups of loads), in every mode, on the
    vector path and on the scalar lanes; the strip and the epilogue on
    their main-path layouts (vector) and the epilogue on tiles read
    through a strided view (x stride K: the scalar lanes)."""
    bf = importlib.import_module("unmicst_tpu_torch.kernels.blend_fold")
    g, logits, win = _weighted_case((100, 120), 64, 8, 3, seed=4)
    x, w = torch.from_numpy(logits), torch.from_numpy(win)
    xc, wc = x.to(cuda), w.to(cuda)
    plan = bf.fold_launch(40, c0, width, (g.npc * xc.stride(0),
                                          *xc.stride()), g.sub, g.patch,
                          [xc.data_ptr(), wc.data_ptr()])
    assert (plan.cols == bf.VEC) == vector
    strip = kernels.blend_fold_strip(xc, g)
    np.testing.assert_allclose(strip.cpu().numpy(),
                               kernels.blend_fold_strip(x, g).numpy(),
                               atol=1e-5)
    # K1's output read through a [npr, npc, P, P, K] layout: x stride K
    t5 = xc.reshape(g.npr, g.npc, 3, 64, 64).permute(0, 1, 3, 4, 2)
    strided = t5.contiguous().permute(0, 1, 4, 2, 3).reshape(-1, 3, 64, 64)
    assert strided.stride(3) == 3
    for tiles in (xc, strided):
        got = kernels.blend_fold_epilogue(tiles, wc, g, classes=classes,
                                          quantize=False)
        ref = kernels.blend_fold_epilogue(x, w, g, classes=classes,
                                          quantize=False)
        np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=1e-5)
    rmask = torch.tensor([0.0] + [1.0] * (g.npr - 1))
    cmask = torch.tensor([1.0] * (g.npc - 1) + [0.0])
    add = torch.rand(40, 20, len(classes) + 1)
    kw = dict(row_mask=rmask, col_mask=cmask, classes=classes, addend=add)
    for mode in ("u8", "f32", "raw"):
        ref = kernels.blend_fold_stripe(x, w, g, (30, 40), (c0, width),
                                        mode=mode, **kw)
        got = kernels.blend_fold_stripe(
            xc, wc, g, (30, 40), (c0, width), mode=mode,
            **{k: v.to(cuda) if torch.is_tensor(v) else v
               for k, v in kw.items()})
        diff = (got.cpu().double() - ref.double()).abs().max().item()
        assert diff <= (1 if mode == "u8" else 1e-5), (mode, diff)


@pytest.mark.cuda
def test_k2_and_a_stripe_never_synchronise(cuda):
    """K2's three entries and one StreamingEngine._stripe make no call that
    synchronises the host with the card (no copy from the host, no wait):
    under set_sync_debug_mode("error") any such call raises."""
    from unmicst_tpu_torch.runtime.pipeline import StreamingEngine, _to_torch

    g, logits, win = _weighted_case((100, 120), 64, 8, 3, seed=5)
    x, w = torch.from_numpy(logits).to(cuda), torch.from_numpy(win).to(cuda)
    rmask = torch.ones(g.npr, device=cuda)
    hp, state = _small_net()
    engine = StreamingEngine(hp, state, "legacy", 0.3, 0.2,
                             compute_dtype=None, stripe_tile_rows=3,
                             device=cuda)
    raw = (np.random.RandomState(2).rand(300, 230) * 60000).astype(np.uint16)
    plan = engine._plan(*raw.shape)
    rows = _to_torch(engine._read_rows(raw, (plan.S - 1) * plan.grid.sub
                                       - plan.grid.margin, plan.in_rows))
    args = (rows[None].to(cuda), plan, 1, np.dtype(np.uint16), True,
            (np.float32([raw.min()]), np.float32([raw.max()])), [2, 0, 1])
    want = engine._stripe(*args)  # the first call builds the model
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernels.blend_fold_epilogue(x, w, g)
        kernels.blend_fold_strip(x, g)
        kernels.blend_fold_stripe(x, w, g, (8, g.height), (8, g.width),
                                  row_mask=rmask, classes=(1,))
        got = engine._stripe(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.abs(got.cpu().numpy().astype(int)
                  - want.cpu().numpy().astype(int)).max() <= 1


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


@pytest.mark.cuda
def test_k4b_waits_only_on_the_planned_stream(cuda):
    """K4b's prepared launch goes to the streams the hop was planned for:
    redeeming the handle under another current stream raises, and on the
    planned one it lands the hop with one wait launch."""
    xs = _ring(4, (32, 70, 3), torch.float32, cuda, seed=11)
    ref = kernels.ring_shift_plain(xs, 1)
    handle = kernels.ring_shift_start(xs, 1)
    with torch.cuda.stream(torch.cuda.Stream()):
        with pytest.raises(RuntimeError, match="current stream changed"):
            kernels.ring_shift_wait(handle)
    before = kernels.ring_shift_wait.launches
    got = kernels.ring_shift_wait(handle)
    torch.cuda.synchronize()
    assert kernels.ring_shift_wait.launches == before + 1
    assert all(torch.equal(a, r) for a, r in zip(got, ref))


_NEVER_STORED = """
import ctypes
import os
import torch
from unmicst_tpu_torch import kernels
from unmicst_tpu_torch.kernels import halo_ring
halo_ring.WAIT_TIMEOUT_S = 0.5
xs = [torch.ones(32, device="cuda") for _ in range(2)]
handle = kernels.ring_shift_start(xs, 1)
torch.cuda.synchronize()
never = type(handle.waits.table).from_buffer_copy(handle.waits.table)
for launch in never:  # targets no store will ever reach
    for k in range(launch.args.n):
        launch.args.entry[k].target += 1000
waits = handle.waits._replace(table=never, addr=ctypes.addressof(never))
kernels.ring_shift_wait(handle._replace(waits=waits))
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("trapped:", e, flush=True)
    os._exit(0)  # the context is gone: skip the interpreter's teardown
os._exit(3)
"""


@pytest.mark.cuda
def test_a_wait_whose_store_never_runs_traps(cuda):
    """K4b's wait warp on words that never reach their targets, as if the
    store never ran, traps after its timeout: the fault surfaces at the
    next synchronisation instead of hanging.  In a child process, since a
    trap ends the CUDA context."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _NEVER_STORED], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "trapped" in res.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("height,width", [(58, 90), (45, 2662 // 20)])
def test_k2_on_a_ragged_scaled_grid_matches_plain(cuda, height, width):
    """A scaled slide's grid, width = 2 (mod 4) (``int(90 * 0.65)`` = 58
    rows; 2662 / 20 = 133 columns, the 4096^2 slide at 0.65 cut down):
    the slide epilogue and the stripe entry, whose rows end in a ragged
    quad, against their plain versions."""
    g, logits, win = _weighted_case((height, width), 64, 8, 3, seed=8)
    x, w = torch.from_numpy(logits), torch.from_numpy(win)
    xc, wc = x.to(cuda), w.to(cuda)
    ref = kernels.blend_fold_epilogue(x, w, g)
    got = kernels.blend_fold_epilogue(xc, wc, g)
    assert np.abs(got.cpu().numpy().astype(int)
                  - ref.numpy().astype(int)).max() <= 1
    rmask = torch.tensor([0.0] + [1.0] * (g.npr - 1))
    rows, cols = (g.sub, g.padded_height - g.sub), (g.margin, width)
    for mode in ("u8", "f32"):
        want = kernels.blend_fold_stripe(x, w, g, rows, cols, row_mask=rmask,
                                         mode=mode)
        have = kernels.blend_fold_stripe(xc, wc, g, rows, cols,
                                         row_mask=rmask.to(cuda), mode=mode)
        diff = (have.cpu().double() - want.double()).abs().max().item()
        assert diff <= (1 if mode == "u8" else 1e-5), (mode, diff)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,out", [((300, 410), (195, 266)),
                                       ((64, 90), (128, 180)),
                                       ((8, 300), (1, 30))])
def test_resize_plan_on_card_matches_cpu(cuda, shape, out):
    from unmicst_tpu_torch.core.resize_dev import ResizePlan

    x = torch.from_numpy(np.random.RandomState(shape[0]).rand(
        2, *shape).astype(np.float32))
    want = ResizePlan(shape, out, "cpu").apply(x)
    got = ResizePlan(shape, out, cuda).apply(x.to(cuda))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-6)


def _duo_net(seed=0):
    from unmicst_tpu_torch.core.hp import HParams
    from unmicst_tpu_torch.core.unet import UNet

    hp = HParams(im_size=32, n_channels=2, n_classes=3, n_out0=4, ks=3,
                 n_extra_convs=0, n_layers=2, batch_size=8)
    g = torch.Generator().manual_seed(seed)
    state = {k: (0.5 + torch.rand(v.shape, generator=g)
                 if k.endswith(("gamma", "moving_variance"))
                 else 0.2 * torch.randn(v.shape, generator=g))
             for k, v in UNet(hp, "v2").state_dict().items()}
    return hp, state


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"outlier": 99.0, "classes": (2, 0)},
                                {"scaling_factor": 0.65}])
def test_infer_slide_stack_on_card_matches_cpu(cuda, kw):
    from unmicst_tpu_torch.infer import InferenceEngine

    hp, state = _duo_net()
    rng = np.random.RandomState(3)
    planes = [(rng.rand(150, 130) * top).astype(np.uint16)
              for top in (60000, 30000)]
    on = {d: InferenceEngine(hp, state, "v2", 0.18, 0.17, device=d)
          for d in ("cpu", cuda)}
    kernels.reset_launch_counts()
    got = on[cuda].infer_slide_stack(planes, **kw)
    counts = kernels.launch_counts()
    assert counts["softmax_blend"] > 0 and counts["blend_fold_epilogue"] == 1
    want = on["cpu"].infer_slide_stack(planes, **kw)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1
    if "scaling_factor" in kw:
        assert (d > 0).mean() < 0.02


@pytest.mark.cuda
def test_a_stack_stripe_never_synchronises(cuda):
    """One duo stripe (two channels, each with its own range) makes no
    call that synchronises the host with the card."""
    from unmicst_tpu_torch.runtime.pipeline import StreamingEngine, _to_torch

    hp, state = _duo_net()
    engine = StreamingEngine(hp, state, "v2", 0.18, 0.17, compute_dtype=None,
                             stripe_tile_rows=3, device=cuda)
    rng = np.random.RandomState(4)
    planes = [(rng.rand(300, 230) * top).astype(np.uint16)
              for top in (60000, 30000)]
    plan = engine._plan(300, 230)
    r0 = (plan.S - 1) * plan.grid.sub - plan.grid.margin
    rows = _to_torch(np.stack([engine._read_rows(p, r0, plan.in_rows)
                               for p in planes]))
    rng_ = (np.float32([p.min() for p in planes]),
            np.float32([p.max() for p in planes]))
    args = (rows.to(cuda), plan, 1, np.dtype(np.uint16), True, rng_,
            [2, 0, 1])
    want = engine._stripe(*args)  # the first call builds the model
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = engine._stripe(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.abs(got.cpu().numpy().astype(int)
                  - want.cpu().numpy().astype(int)).max() <= 1
    ref = StreamingEngine(hp, state, "v2", 0.18, 0.17, compute_dtype=None,
                          stripe_tile_rows=3, device="cpu")
    assert np.abs(engine.infer_stack(planes).astype(int)
                  - ref.infer_stack(planes).astype(int)).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,patch,margin,k", _GEOMS)
def test_k2_float32_slide_epilogue_matches_plain_on_card(cuda, shape, patch,
                                                         margin, k):
    """K2's slide epilogue with float32 maps (the host float path's mode)
    against ``blend_fold_epilogue_plain(quantize=False)``: within 1e-5
    (float32 sums of at most four tiles, one divide), one launch."""
    g, logits, win = _weighted_case(shape, patch, margin, k, seed=9)
    x, w = torch.from_numpy(logits), torch.from_numpy(win)
    before = kernels.blend_fold_epilogue.launches
    got = kernels.blend_fold_epilogue(x.to(cuda), w.to(cuda), g,
                                      quantize=False)
    torch.cuda.synchronize()
    assert kernels.blend_fold_epilogue.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (k,) + tuple(shape)
    want = kernels.blend_fold_epilogue_plain(x, w, g, quantize=False)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)


def _tiff(path, planes):
    from unmicst_tpu_torch.io.tiff import TiffWriter

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with TiffWriter(path, bigtiff=True) as tw:
        for p in planes:
            tw.write(p)
    return path


def _pages_close(a_dir, b_dir):
    from unmicst_tpu_torch.io.tiff import imread, num_pages

    names = sorted(f for f in os.listdir(a_dir) if f.endswith(".tif"))
    assert names and names == sorted(f for f in os.listdir(b_dir)
                                     if f.endswith(".tif"))
    for name in names:
        for page in range(num_pages(os.path.join(a_dir, name))):
            a = imread(os.path.join(a_dir, name), page).astype(int)
            b = imread(os.path.join(b_dir, name), page).astype(int)
            assert np.abs(a - b).max() <= 1, (name, page)


@pytest.mark.cuda
def test_sweep_and_host_float_path_on_card_match_cpu(cuda, tmp_path):
    """A blobDemo sweep (whole, streamed and 3-rank sharded slides) and the
    CLI's host float path (an int16 slide, --check-numerics) on the card,
    within 1 level of the same calls on the CPU; the host path ran K2's
    float32 epilogue once."""
    from unmicst_tpu_torch import batch, cli
    from unmicst_tpu_torch.runtime.mesh import make_mesh

    model = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "models", "blobDemo")
    rng = np.random.RandomState(11)
    slides = [_tiff(str(tmp_path / f"exemplar-00{i}" / "registration" /
                        "s.ome.tif"),
                    [(rng.rand(*shape) * 60000).astype(np.uint16)])
              for i, shape in enumerate([(200, 170), (300, 260)])]
    for dev in ("cpu", cuda):
        for kw, out in (({"stream_above_px": 50000}, "auto"),
                        ({"mesh": make_mesh(devices=[dev] * 3)}, "sharded")):
            rep = batch.run_sweep(slides, model, str(tmp_path / out /
                                                     str(dev)),
                                  device=dev, verbose=False, **kw)
            assert rep.completed == slides
    for out in ("auto", "sharded"):
        _pages_close(str(tmp_path / out / "cpu"),
                     str(tmp_path / out / str(cuda)))
    src = _tiff(str(tmp_path / "h" / "registration" / "i16.tif"),
                [(rng.rand(230, 190) * 30000 - 500).astype(np.int16)])
    for extra in ([], ["--check-numerics"]):
        argv = [src, "--tool", "unmicst-legacy", "--model", "blobDemo",
                "--modelRoot", os.path.dirname(model), *extra]
        cli.main(argv + ["--outputPath", str(tmp_path / "c")], device="cpu")
        kernels.reset_launch_counts()
        assert cli.main(argv + ["--outputPath", str(tmp_path / "g")]) == 0
        counts = kernels.launch_counts()
        assert counts["blend_fold_epilogue"] == 1, counts
        _pages_close(str(tmp_path / "c"), str(tmp_path / "g"))
