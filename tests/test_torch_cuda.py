"""The CUDA kernels K1 and K2 against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc (the kernels have no CPU
interpret mode) and skip elsewhere.  They import no JAX, so they also run
on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import importlib
import itertools
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


# (c0, W, vector path): c0 % 4 = 1, 0, 0, 2, 3, with ragged widths (W % 4
# = 2, 0, 2, 3, 1), all on the vector path (the strided view below runs the
# scalar lanes)
_REGIONS = [(5, 90, True), (8, 88, True), (8, 90, True), (6, 87, True),
            (7, 61, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("c0,width,vector", _REGIONS)
@pytest.mark.parametrize("classes", [(2, 0), (2, 0, 1, 1, 0)])
def test_k2_region_entries_match_plain_on_card(cuda, c0, width, vector,
                                               classes):
    """The stripe entry with row and column masks, an addend and a class
    subset (five entries: two groups of loads), in every mode, on the
    vector path at any column origin: 0 levels from the plain version in
    uint8, 1e-5 in float32; the strip and the epilogue on their main-path
    layouts (vector) and the epilogue on tiles read through a strided view
    (x stride K: the scalar lanes)."""
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
        assert diff <= (0 if mode == "u8" else 1e-5), (mode, diff)


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
def test_stream_uploads_wait_for_work_queued_before_them(cuda):
    """The stream's uploads start after the work already queued on the
    compute stream.  The caching allocator hands the stream's input
    buffers blocks that such work frees while it still runs (the int8
    calibration's forwards do): here a sleep, then a fill of tensors
    freed at once, each the size of one input buffer (over 10 MiB, so a
    segment of its own).  An upload that did not wait would be
    overwritten by the fill.  The engine is warm (a first call's new
    pinned host buffers come from a call that waits for the card, which
    would hide the race) and the call is made three times (the first
    after ``empty_cache`` may find the card idle)."""
    from unmicst_tpu_torch.runtime.pipeline import StreamingEngine

    hp, state = _small_net()
    raw = (np.random.RandomState(6).rand(2000, 6000) * 60000).astype(np.uint16)
    engine = StreamingEngine(hp, state, "legacy", 0.3, 0.2, compute_dtype=None,
                             stripe_tile_rows=40, in_flight=2, device=cuda)
    plan = engine._plan(*raw.shape)
    nbytes = plan.in_rows * plan.width * raw.itemsize
    assert nbytes > 10 << 20 and plan.n_stripes >= 2
    want = engine.infer(raw)
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        junk = [torch.empty(nbytes, dtype=torch.uint8, device=cuda)
                for _ in range(2)]
        torch.cuda._sleep(1_000_000_000)
        for j in junk:
            j.fill_(255)
        del junk, j
        assert np.array_equal(engine.infer(raw), want)


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


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["v2", "legacy"])
def test_train_step_on_card_matches_cpu(cuda, variant, tmp_path):
    """One training step (no dropout) on the card against the CPU, float32
    with TF32 off: the loss to 1e-5 relative; the first-moment slot, which
    holds the gradient (Momentum's trace g, Adam's mu 0.1 g), tensor by
    tensor to 1e-4 of its norm, the BN moving statistics' zero slots
    equal; Momentum's weights within 1e-6 (Adam's first update is lr0 x
    sign(g) whatever g is, so its weights say nothing more); a 3-step fit
    with prefetch on the card gives finite metrics and leaves the TF32
    flags as found."""
    from unmicst_tpu_torch import train as tr
    from unmicst_tpu_torch.core.hp import HParams
    from unmicst_tpu_torch.core.unet import init_params

    hp = HParams(im_size=32, n_channels=1, n_classes=3, n_out0=8, ks=3,
                 n_extra_convs=1, n_layers=2, batch_size=4)
    cfg = tr.TrainConfig.for_variant(variant, n_aug=1)
    state = init_params(hp, variant, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    batch = {"image": rng.normal(0, 1, (4, 32, 32, 1)).astype(np.float32),
             "labels": np.eye(3, dtype=np.float32)[rng.randint(0, 3,
                                                               (4, 32, 32))],
             "weights": rng.uniform(1, 5, (4, 32, 32, 3)).astype(np.float32)}
    slot = "mu" if cfg.optimizer == "adam" else "trace"
    out = {}
    for dev in ("cpu", cuda):
        t = tr.Trainer(hp, cfg, "unused", params=state, device=dev)
        m = t.train_step(t.model, t.opt_state, tr.to_device(batch, t.device),
                         None)
        out[str(dev)] = (float(m["loss"]),
                         {k: v.cpu() for k, v in t.params.items()},
                         {k: v.cpu() for k, v in
                          t.opt_state.slots[slot].items()})
    (l_cpu, p_cpu, s_cpu), (l_card, p_card, s_card) = (out["cpu"],
                                                       out[str(cuda)])
    assert l_card == pytest.approx(l_cpu, rel=1e-5)
    for k, v in s_cpu.items():
        if float(v.norm()) == 0:  # a BN moving statistic's slot
            assert torch.equal(s_card[k], v), k
        else:
            assert float((s_card[k] - v).norm()) <= 1e-4 * float(v.norm()), k
    if cfg.optimizer == "momentum":
        for k, v in p_cpu.items():
            assert float((p_card[k] - v).abs().max()) <= 1e-6, k
    saved = torch.backends.cudnn.allow_tf32

    class Same:  # a corpus whose every batch is ``batch``
        def batches(self, *args, **kwargs):
            return itertools.repeat(batch)

    t = tr.Trainer(hp, tr.TrainConfig.for_variant(variant, n_aug=1,
                                                  prefetch=2),
                   str(tmp_path / "m"), params=state, device=cuda)
    assert np.isfinite(t.fit(Same(), Same(), 3, verbose=False))
    assert torch.backends.cudnn.allow_tf32 == saved


def _int8_sites(name):
    """(site, OIHW kernel shape) of every int8 site of nucleiDAPI or
    nucleiDAPILAMIN at its published widths (SURVEY.md section 2.4)."""
    from unmicst_tpu_torch.core import quant
    from unmicst_tpu_torch.core.hp import HParams
    from unmicst_tpu_torch.core.unet import UNet

    kw, variant = {
        "nucleiDAPI": (dict(n_channels=1, n_out0=16, ks=5, n_extra_convs=1,
                            n_layers=2), "legacy"),
        "nucleiDAPILAMIN": (dict(n_channels=2, n_out0=36, ks=3,
                                 n_extra_convs=0, n_layers=5), "duo"),
    }[name]
    hp = HParams(im_size=128, n_classes=3, **kw)
    state = UNet(hp, variant).state_dict()
    return [(s, w.shape) for s, w in quant.conv_sites(state, hp).items()]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nucleiDAPI", "nucleiDAPILAMIN"])
def test_int8_conv_on_card_is_exact(cuda, name):
    """At every int8 site of both published nets: the card's int32 sums
    (``torch._int_mm`` over the im2col) equal a float64 convolution of the
    same int8 values, 0 apart, and the CPU route's; ``quant_conv`` on the
    card equals the CPU's bit for bit (the same sums, one float32
    multiply and add per output)."""
    from unmicst_tpu_torch.core import unet

    rng = np.random.RandomState(5)
    for site, shape in _int8_sites(name):
        cout, cin, ks, _ = shape
        x8 = torch.from_numpy(rng.randint(-127, 128, (3, cin, 9, 11))
                              .astype(np.int8))
        w8 = torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
        got = unet.quant_conv_sums(x8.to(cuda), w8.to(cuda)).cpu()
        ref = torch.nn.functional.conv2d(x8.double(), w8.double(),
                                         padding=ks // 2)
        assert torch.equal(got.long(), ref.long()), site
        assert torch.equal(got, unet.quant_conv_sums(x8, w8)), site
        x = torch.from_numpy(rng.randn(3, cin, 9, 11).astype(np.float32))
        qk = {"w8": w8,
              "w_scale": torch.from_numpy(rng.rand(cout).astype(np.float32)),
              "bias": torch.from_numpy(rng.randn(cout).astype(np.float32))}
        a = torch.from_numpy(rng.rand(cin).astype(np.float32) * 0.02 + 0.01)
        want = unet.quant_conv(x, qk, a)
        card = unet.quant_conv(x.to(cuda), {k: v.to(cuda)
                                            for k, v in qk.items()},
                               a.to(cuda)).cpu()
        assert torch.equal(card, want), site


@pytest.mark.cuda
@pytest.mark.parametrize("shape,patch,margin,k", _GEOMS)
@pytest.mark.parametrize("quantize", [True, False])
def test_k2_trimmed_region_matches_plain_on_card(cuda, shape, patch, margin,
                                                 k, quantize):
    """K2's slide epilogue with trim= on the card, at canvas column origins
    of every c0 % 4 and ragged widths (the vector path): 0 apart from its
    plain version, and equal to the untrimmed launch's crop; counted as a
    trim launch."""
    g, logits, win = _weighted_case(shape, patch, margin, k, seed=5)
    w = torch.from_numpy(win)
    x = torch.softmax(torch.from_numpy(logits), 1) * w
    xc, wc = x.to(cuda), w.to(cuda)
    full = kernels.blend_fold_epilogue(xc, wc, g, quantize=quantize)
    h, wd = shape
    for trim in [(0, 0, h, wd), (7, 3, h // 2, wd // 3),
                 (h - 5, wd - 9, 5, 9), (1, 1, h - 2, 1),
                 (2, 2, h // 3, wd // 2 + 1), (3, 1, 9, 3)]:
        tr, tc, th, tw = trim
        kernels.reset_launch_counts()
        got = kernels.blend_fold_epilogue(xc, wc, g, quantize=quantize,
                                          trim=trim)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["blend_fold_epilogue"] == 1
        assert counts["blend_fold_epilogue_trim"] == 1
        plain = kernels.blend_fold_epilogue_plain(x, w, g, quantize=quantize,
                                                  trim=trim)
        assert tuple(got.shape) == (k, th, tw)
        assert torch.equal(got, full[:, tr:tr + th, tc:tc + tw])
        if quantize:
            assert torch.equal(got.cpu(), plain)
        else:
            np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(),
                                       atol=1e-5)


def _blob_engine(device, **kw):
    from unmicst_tpu_torch.core.checkpoint import load_params_for_bundle
    from unmicst_tpu_torch.core.hp import load_model_dir
    from unmicst_tpu_torch.infer import InferenceEngine

    bundle = load_model_dir(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "models", "blobDemo"))
    return InferenceEngine.from_bundle(bundle, load_params_for_bundle(bundle),
                                       device=device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"in_range": (0, 65535),
                                     "classes": (1,)},
                                {"scaling_factor": 0.5}])
def test_device_pan_on_card_matches_infer_slide(cuda, kw):
    """A pan on a pinned plane on the card: equal to infer_slide of the
    band on the card (same shapes, same algorithms), its trim= the crop
    (K2 writes only the window at scale 1), and within 1 level of the
    CPU."""
    rng = np.random.RandomState(4)
    raw = (rng.rand(700, 600) * 60000).astype(np.uint16)
    eng = _blob_engine(cuda)
    plane = eng.device_plane(raw)
    assert plane.data.is_cuda and plane.data.dtype == torch.int16
    r0, c0, h, w = 96, 48, 288, 320
    band = np.ascontiguousarray(raw[r0:r0 + h, c0:c0 + w])
    want = eng.infer_slide(band, **kw)
    np.testing.assert_array_equal(
        eng.infer_slide_device(plane, r0, c0, h, w, **kw), want)
    kernels.reset_launch_counts()
    cut = eng.infer_slide_device(plane, r0, c0, h, w, trim=(50, 60, 128, 96),
                                 **kw)
    counts = kernels.launch_counts()
    np.testing.assert_array_equal(cut, want[:, 50:178, 60:156])
    assert counts["blend_fold_epilogue_trim"] == (
        0 if "scaling_factor" in kw else 1)
    cpu = _blob_engine("cpu").infer_slide(band, **kw)
    assert np.abs(want.astype(int) - cpu.astype(int)).max() <= 1


@pytest.mark.cuda
def test_concurrent_requests_on_card_equal_serial(cuda, tmp_path):
    """Four threads posting float32 and bfloat16 requests at once to two
    servers on the card get pages byte-equal to the same requests one at
    a time: the conv flags of one precision never leak into the other's
    work, and the TF32 flags end as they began."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from unmicst_tpu_torch import serve
    from unmicst_tpu_torch.io.tiff import TiffWriter

    models = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "models")
    rng = np.random.RandomState(8)
    path = str(tmp_path / "c.tif")
    with TiffWriter(path) as tw:
        tw.write((rng.rand(1024, 1024) * 60000).astype(np.uint16))
    with open(path, "rb") as f:
        body = f.read()
    urls, httpds = [], []
    for precision in ("float32", "bfloat16"):
        srv = serve.ModelServer(model_root=models, precision=precision)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(srv))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        httpds.append(httpd)
        urls.append(f"http://127.0.0.1:{httpd.server_address[1]}")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)

    def post(url):
        req = urllib.request.Request(url + "/infer?model=blobDemo",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read()

    try:
        cold = [post(u) for u in urls]  # each shape's cuDNN autotune
        serial = [post(u) for u in urls]
        assert serial[0] != serial[1]
        got = [None] * 4

        def run(i):
            try:
                got[i] = post(urls[i % 2])
            except Exception as e:  # noqa: BLE001 — reported below
                got[i] = e

        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        report = [g if isinstance(g, Exception) else g == serial[i % 2]
                  for i, g in enumerate(got)]
        assert all(r is True for r in report), (
            report, [c == s for c, s in zip(cold, serial)])
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == flags
    finally:
        for h in httpds:
            h.shutdown()
            h.server_close()


def _cli_card_and_cpu(src, tmp_path, flags, name):
    """``cli.main`` on ``src`` on the CPU and on the card (blobDemo): the
    card run's K1/K2 launches, and every page within 1 level."""
    from unmicst_tpu_torch import cli

    argv = [src, "--tool", "unmicst-legacy", "--model", "blobDemo",
            "--modelRoot", os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "models"), "--stackOutput",
            *flags]
    assert cli.main(argv + ["--outputPath", str(tmp_path / name / "c")],
                    device="cpu") == 0
    kernels.reset_launch_counts()
    assert cli.main(argv + ["--outputPath", str(tmp_path / name / "g")]) == 0
    counts = kernels.launch_counts()
    _pages_close(str(tmp_path / name / "c"), str(tmp_path / name / "g"))
    return counts


@pytest.mark.cuda
def test_pyramid_cli_on_card_matches_cpu(cuda, tmp_path):
    """``--usePyramid --scalingFactor 0.5`` on a zstd pyramid (when the
    host has libzstd) with ``--pyramidOutput``: the stored level through
    K1 and one K2 epilogue, the pages within 1 level of the CPU's."""
    from unmicst_tpu_torch.io import zstd
    from unmicst_tpu_torch.io.tiff import TiffWriter

    rng = np.random.RandomState(12)
    src = str(tmp_path / "pyr.tif")
    codec = "zstd" if zstd.available() else None
    with TiffWriter(src, compression=codec) as tw:
        tw.write_pyramid((rng.rand(640, 512) * 60000).astype(np.uint16),
                         tile=(64, 64), min_size=64)
    counts = _cli_card_and_cpu(src, tmp_path, [
        "--usePyramid", "--scalingFactor", "0.5", "--pyramidOutput"], "p")
    assert counts["softmax_blend"] > 0, counts
    assert counts["blend_fold_epilogue"] == 1, counts


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["whole", "streaming"])
def test_czi_and_nd2_cli_on_card_match_cpu(cuda, tmp_path, engine):
    """A mosaic CZI (zstd1 hi-lo with libzstd) and an ND2 through the
    whole engine and the stream on the card, within 1 level of the CPU;
    K1 and K2 (the epilogue or the stripe entry) launched."""
    import chip_smoke
    from unmicst_tpu_torch.io import zstd

    rng = np.random.RandomState(13)
    plane = (rng.rand(300, 260) * 60000).astype(np.uint16)
    czi = str(tmp_path / "s.czi")
    chip_smoke.write_czi(czi, plane, 128, 6 if zstd.available() else 0,
                         hilo=True)
    nd2 = str(tmp_path / "s.nd2")
    chip_smoke.write_nd2(nd2, np.stack([plane[::-1], plane], -1))
    k2 = "blend_fold_epilogue" if engine == "whole" else "blend_fold_stripe"
    for src, name in ((czi, "czi"), (nd2, "nd2")):
        counts = _cli_card_and_cpu(src, tmp_path, ["--engine", engine],
                                   name)
        assert counts["softmax_blend"] > 0 and counts[k2] > 0, counts


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["whole", "streaming"])
def test_jpeg_czi_cli_on_card_matches_cpu(cuda, tmp_path, engine):
    """A 1024^2 mosaic of the committed JPEG fixtures (M16) through the
    whole engine and the stream on the card, within 1 level of the CPU."""
    import chip_smoke

    czi = str(tmp_path / "j.czi")
    chip_smoke.jpeg_mosaic(czi, 1024)
    k2 = "blend_fold_epilogue" if engine == "whole" else "blend_fold_stripe"
    counts = _cli_card_and_cpu(czi, tmp_path, ["--engine", engine], "jpeg")
    assert counts["softmax_blend"] > 0 and counts[k2] > 0, counts


@pytest.mark.cuda
def test_toolbox_and_tiler3d_on_card_match_cpu(cuda):
    """``utils/imtools`` (M14e) and ``core/tiler3d`` (M14f) on the card
    against the same calls on the CPU: selections and morphology equal,
    float64 filters at rtol 1e-10, atol 1e-12."""
    from unmicst_tpu_torch.core import tiler3d
    from unmicst_tpu_torch.utils import imtools

    rng = np.random.RandomState(16)
    x, v = rng.rand(96, 80), rng.rand(20, 24, 28)
    for fn, args in ((imtools.imfeatures, (x, [1, 2], [1, 2], 3)),
                     (imtools.imfeatures3, (v, 2, 2, 2)),
                     (imtools.imresize3_double, (v, (9, 30, 17))),
                     (imtools.imgaussfilt, (x, 2.5))):
        np.testing.assert_allclose(fn(*args, device=cuda),
                                   fn(*args, device="cpu"), rtol=1e-10,
                                   atol=1e-12)
    u16 = (x * 65535).astype(np.uint16)
    for fn, args in ((imtools.medfilt, (u16, 3)), (imtools.ptlfilt, (x, 30,
                                                                      2)),
                     (imtools.imerode, (x > 0.4, 3)),
                     (imtools.imdilate3, (v > 0.6, 2)),
                     (imtools.imgaussfilt, (u16, 1.5))):
        np.testing.assert_array_equal(fn(*args, device=cuda),
                                      fn(*args, device="cpu"))
    g = tiler3d.make_grid3d(20, 24, 28, 16, 2)
    w = torch.from_numpy(tiler3d.ramp_window3d(16, 2))
    vol = torch.from_numpy(v.astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        tiles = tiler3d.unfold3d(tiler3d.pad_canvas3d(vol.to(dev), g), g)
        out[str(dev)] = (tiler3d.fold3d(tiles * w.to(dev), g).cpu(),
                         tiler3d.count_map3d(g, w.to(dev)).cpu())
    for a, b in zip(out["cpu"], out[str(cuda)]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


# -- CUDA graphs of the forward (runtime/graphs.py) ---------------------------


def _graph_engine(cuda, **kw):
    """A small legacy engine (nucleiDAPI's ks and widths at 64 px) on the
    card, seeded weights with non-trivial BN statistics."""
    from unmicst_tpu_torch.core.hp import HParams
    from unmicst_tpu_torch.core.unet import init_params
    from unmicst_tpu_torch.infer import InferenceEngine

    hp = HParams(im_size=64, n_channels=1, n_classes=3, n_out0=16, ks=5,
                 n_extra_convs=1, n_layers=2)
    g = torch.Generator().manual_seed(5)
    state = init_params(hp, "legacy", g)
    for name in state:
        if name.endswith(("moving_mean", "beta")):
            state[name] = 0.1 * torch.randn(state[name].shape, generator=g)
        elif name.endswith(("moving_variance", "gamma")):
            state[name] = 0.5 + torch.rand(state[name].shape, generator=g)
    return InferenceEngine(hp, state, "legacy", 0.2, 0.16, device=cuda, **kw)


def _weigh(engine, raw, chunk, graphs, quant=None):
    """``weigh_tiles`` of ``raw``'s canvas through ``engine``'s model, on
    graphs or eagerly; returns the weighted tiles and K1's launches."""
    from unmicst_tpu_torch.infer import weigh_tiles

    hp = engine.hp
    grid = tt.make_grid(*raw.shape, hp.im_size, hp.margin)
    m = grid.margin
    canvas = torch.zeros((1, grid.padded_height, grid.padded_width),
                         device=engine.device)
    canvas[0, m : m + raw.shape[0], m : m + raw.shape[1]] = torch.from_numpy(
        raw.astype(np.float32) / 65535.0).to(engine.device)
    mask = torch.ones(grid.num_tiles, device=engine.device)
    before = kernels.softmax_blend.launches
    out = weigh_tiles(engine.model, engine.normalize(canvas), grid,
                      engine.window, mask, chunk, quant=quant,
                      packed=engine._packed, _graphs=graphs)
    torch.cuda.synchronize()
    return out.cpu(), kernels.softmax_blend.launches - before


def _raw(seed, shape=(300, 260)):
    return (np.random.RandomState(seed).rand(*shape) * 60000).astype(
        np.uint16)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"compute_dtype": torch.bfloat16},
                                {"s2d": True}])
def test_graph_forward_equals_eager_on_card(cuda, kw):
    """A shape's first call runs eagerly and its second captures; the
    replayed graph gives eager's weighted tiles bit for bit, K1 launched
    once per chunk either way, and replays of two keys sharing the card's
    pool in turns (A, B, A) stay equal to eager."""
    from unmicst_tpu_torch.runtime.graphs import graphs_for

    engine = _graph_engine(cuda, **kw)
    graphs = graphs_for(engine.model, engine.device)
    raw = _raw(1)
    for k, chunk in enumerate((16, 7, 16)):
        eager, n_eager = _weigh(engine, raw, chunk, graphs=False)
        for _ in range(2 if k < 2 else 1):
            graph, n_graph = _weigh(engine, raw, chunk, graphs=True)
            assert torch.equal(graph, eager), chunk
            assert n_graph == n_eager > 1
        assert len(graphs.cache) == min(k + 1, 2)
    assert len(graphs.capture_s) == 2
    maps = engine.infer_slide(raw)
    assert maps.shape == (3, 300, 260) and len(graphs.cache) == 2
    np.testing.assert_array_equal(engine.infer_slide(raw), maps)
    assert len(graphs.cache) == 3


@pytest.mark.cuda
def test_graph_int8_follows_recalibration_on_card(cuda):
    """The int8 graph copies the engine's current QuantState in before
    each replay: after calibrating on another slide it equals eager with
    the new state, and that state's tiles differ from the old state's (a
    stale scale would show)."""
    from unmicst_tpu_torch.core import quant as q

    engine = _graph_engine(cuda, quantized=True,
                           compute_dtype=torch.bfloat16)
    raw_a, raw_b = _raw(2), (_raw(3) // 4).astype(np.uint16)
    states = []
    for raw in (raw_a, raw_b):
        engine._quant = None
        engine.infer_slide(raw)  # calibrates, then runs on the graph
        states.append(q.to_device(engine._quant, engine.device))
    _weigh(engine, raw_b, 16, graphs=True, quant=states[0])  # first: eager
    for state in (states[0], states[1], states[0]):
        eager, _ = _weigh(engine, raw_b, 16, graphs=False, quant=state)
        graph, _ = _weigh(engine, raw_b, 16, graphs=True, quant=state)
        assert torch.equal(graph, eager)
    old, _ = _weigh(engine, raw_b, 16, graphs=True, quant=states[0])
    new, _ = _weigh(engine, raw_b, 16, graphs=True, quant=states[1])
    assert not torch.equal(old, new)


@pytest.mark.cuda
def test_graph_capture_failure_raises_on_card(cuda):
    """A forward that synchronises with the host cannot be captured: the
    capture raises, and a second request of the key raises again from
    a new attempt, never falling back to eager."""
    from unmicst_tpu_torch.runtime.graphs import graphs_for

    engine = _graph_engine(cuda)
    graphs = graphs_for(engine.model, engine.device)

    def syncing(x, quant):
        y = engine.model.forward_nchw(x, return_logits=True)
        return y * float(y.sum().item())  # a host read inside the forward

    # the first request runs eagerly, where a host read is allowed
    assert graphs.get(("bad",), syncing, (4, 1, 64, 64),
                      torch.float32) is None
    for _ in range(2):
        with pytest.raises(RuntimeError):
            graphs.get(("bad",), syncing, (4, 1, 64, 64), torch.float32)
    torch.cuda.synchronize()
    assert ("bad",) not in graphs.capture_s
    raw = _raw(4, (130, 120))
    eager, _ = _weigh(engine, raw, 8, graphs=False)
    for _ in range(2):
        graph, _ = _weigh(engine, raw, 8, graphs=True)
        assert torch.equal(graph, eager)
    assert len(graphs.capture_s) == 1


@pytest.mark.cuda
def test_graph_first_requests_in_three_threads_capture_once(cuda,
                                                           monkeypatch):
    """Three threads' first requests of one shape: one runs eagerly (the
    key's first request), the other two capture one graph between them
    (the cache's dedup), and all three get the same maps.  cuDNN keeps
    its plans per thread, so threads may run other algorithms (other
    bits) for one shape, eagerly as on graphs: cuDNN's choice is pinned
    here to its heuristics, and the graph is held against eager in a new
    thread (this one holds earlier tests' autotuned plans)."""
    import threading

    from unmicst_tpu_torch.runtime.graphs import graphs_for

    flags = torch.backends.cudnn.flags
    monkeypatch.setattr(torch.backends.cudnn, "flags", lambda *a, **kw: flags(
        *a, **{**kw, "benchmark": False}))
    engine = _graph_engine(cuda, tile_batch=8)
    raw = _raw(5)
    results = [None] * 3

    def run(k):
        results[k] = engine.infer_slide(raw)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert len(graphs_for(engine.model, engine.device).capture_s) == 1
    for r in results[1:]:
        np.testing.assert_array_equal(r, results[0])
    tiles = {}

    def weigh_both():
        tiles["eager"], _ = _weigh(engine, raw, 8, graphs=False)
        tiles["graph"], _ = _weigh(engine, raw, 8, graphs=True)

    t = threading.Thread(target=weigh_both)
    t.start()
    t.join(120)
    assert not t.is_alive() and len(tiles) == 2
    assert torch.equal(tiles["graph"], tiles["eager"])


@pytest.mark.cuda
def test_graph_capture_after_every_graph_died_on_card(cuda):
    """When every graph of the card's pool has been collected, PyTorch no
    longer takes captures into that pool: the next capture starts a
    fresh one, and its replay equals eager."""
    import gc

    from unmicst_tpu_torch.runtime.graphs import card_pool, graphs_for

    gc.collect()  # earlier tests' engines, and their graphs
    raw = _raw(6, (130, 120))
    pools = []
    for _ in range(2):
        engine = _graph_engine(cuda)
        eager, _ = _weigh(engine, raw, 8, graphs=False)
        for _ in range(2):
            graph, _ = _weigh(engine, raw, 8, graphs=True)
            assert torch.equal(graph, eager)
        assert len(graphs_for(engine.model, engine.device).capture_s) == 1
        pools.append(card_pool(engine.device).pool)
        del engine
        gc.collect()
    assert pools[0] != pools[1]
