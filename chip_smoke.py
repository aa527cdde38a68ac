#!/usr/bin/env python3
"""Drive unmicst_tpu_torch on one NVIDIA GPU and check it, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; with no CUDA device it exits 2 before
printing any result):

1. build the CUDA kernels from ``unmicst_tpu_torch/csrc`` with nvcc;
2. hold K1 (softmax x blend window) and K2 (gather overlap-add, both
   entry points) against their plain PyTorch versions on the card, at the
   shapes of a 4096^2 slide through the legacy net (T 1849 tiles, K 3,
   P 128, float32), and time kernel, plain version and a one-call
   PyTorch yardstick (``torch.softmax``, ``torch.nn.functional.fold``);
   K2's device time per launch by the profiler beside its events time, and
   K2 under ``torch.cuda.set_sync_debug_mode("error")`` (no call of it may
   synchronise the host with the card);
3. run the CLI on ``models/blobDemo`` (real TF1 weights) over a seeded
   blob slide: three output pages, blobs inside > 0.8, background < 0.3,
   both main-path kernels launched; and the engine on the card against
   the engine on the CPU (plain versions) on a small slide, float32 and
   bfloat16, at the bar of the CPU tests against the JAX package;
4. run the full-width legacy net (the nucleiDAPI hyper-parameters with
   seeded weights) over a seeded 4096^2 uint16 slide through
   ``InferenceEngine.infer_slide``, float32 and bfloat16, with Mpx/s and
   peak device memory (and the peak one tile adds, against the estimate
   the tile batch is chosen from); the launch counters are set to 0 just
   before the float32 run and read just after, and the engine must leave
   the process's TF32 flags as it found them; one more slide in each
   precision runs under ``torch.profiler`` for the device time by kernel
   and the idle share; both precisions on the card against the CPU;
5. halo: K3 (``ring_shift``) and the K4a/K4b pair (``ring_shift_start`` /
   ``ring_shift_wait``) bit-equal to their plain versions on rings of 1,
   2, 4 and 8 ranks sharing the card, shifts +1 and -1, on the seam
   buffers of a 4096^2 slide, one of an odd byte size and a view 4 bytes
   off 16-byte alignment, one launch each per hop; timed by CUDA events
   and by the profiler per launch beside the plain copy, ``Tensor.copy_``
   and (for K4b) ``Stream.wait_event``, with the host's issue time per
   call and the cost of K4b's current-stream check; then
   ``runtime.halo.spatial_infer`` over a seeded 4096^2 plane
   on 4 ranks of the card with every seam
   implementation (the counters set to 0 before each), against each other
   and against ``InferenceEngine.infer``, with K2's fold-only entry timed
   at a band's shapes (events and profiler, and without synchronising);
6. streaming: a seeded 8192^2 uint16 slide (67 Mpx) through
   ``StreamingEngine.infer`` against ``InferenceEngine.infer_slide``,
   ``infer_sharded`` over 4 ranks of the card (ring seams) against
   ``infer``, and the CLI's ``--engine auto`` and ``--engine sharded`` on
   a TIFF of it, with Mpx/s and the device's busy and idle share over one
   warm ``infer`` (profiler), one ``StreamingEngine._stripe`` call and K2's
   stripe entry without synchronising, and K2's stripe entry timed at a
   stripe's shapes (events and profiler);
7. print the ``{"kernels": [...]}`` line, the card's name and power limit,
   and the ``{"ok": true, ...}`` line last.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet): device memory and float32 outside
# the tensor cores, the rate of the kernels' elementwise arithmetic
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SLIDE = 4096  # the full-width legacy slide side
BIG = 8192  # the streaming phase's slide side (67 Mpx, above the 64 Mpx line)
RANKS = 4  # ranks sharing the card in the multi-rank phases
SEED = 0


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, names, iters: int = 20) -> dict:
    """Device time per call of the kernels whose names contain one of
    ``names``, from ``torch.profiler`` over ``iters`` calls: the kernels'
    own time, without the gaps in which the card waits for the host to
    issue them.  Returns ``{name: (ms per call, launches per call)}`` for
    each of ``names`` (NaN ms where the profiler saw none of its events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for n in names:
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and n in e.name]
        # launches per call, rounded: the profiler may drop the odd event
        # of a session; the time per call is then the mean launch's times
        # the launches per call
        per_call = round(len(us) / iters)
        out[n] = (sum(us) / len(us) * per_call / 1e3 if us
                  else float("nan"), per_call)
    return out


def no_sync(fn, label: str):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: any
    call in it that synchronises the host with the card raises."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"[sync] {label}: no host synchronisation "
        "(set_sync_debug_mode('error'))")
    return res


def fold_device_ms(fn, label: str) -> float:
    """K2's own device time per launch (profiler); one launch per call."""
    ms, n = kernel_device_ms(fn, ("fold_region",))["fold_region"]
    check(n == 1, f"{label}: expected one fold_region launch per call, the "
                  f"profiler saw {n}")
    return ms


def busy_ms(prof) -> float:
    """Device busy time of a profile: the union of its device intervals
    (kernels and copies on every stream), in ms."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in
                   prof.events() if e.device_type == DeviceType.CUDA)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def legacy_hp():
    """nucleiDAPI's published hyper-parameters (SURVEY.md section 2.4)."""
    from unmicst_tpu_torch.core.hp import HParams

    return HParams(im_size=128, n_channels=1, n_classes=3, n_out0=16,
                   feat_maps_fact=2, down_samp_fact=2, ks=5, n_extra_convs=1,
                   std_dev0=0.03, n_layers=2, batch_size=16)


LEGACY_MEAN, LEGACY_STD = 0.19808, 0.16236


def seeded_state(hp, variant: str, seed: int) -> dict:
    """Random weights for ``UNet(hp, variant)``: He-scaled kernels and
    plausible BN statistics, from a torch.Generator."""
    import torch

    from unmicst_tpu_torch.core.unet import UNet

    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, p in UNet(hp, variant).state_dict().items():
        if name.endswith(("gamma", "moving_variance")):
            v = 0.5 + torch.rand(p.shape, generator=g)
        elif name.endswith(("beta", "moving_mean")):
            v = 0.1 * torch.randn(p.shape, generator=g)
        else:
            # OIHW conv kernels; transposed ones are [in, out, ks, ks]
            transposed = name.startswith("up.") and name.endswith("kernel1")
            fan_in = p.shape[0] * p[0, 0].numel() if transposed else p[0].numel()
            v = torch.randn(p.shape, generator=g) * (2.0 / fan_in) ** 0.5
        state[name] = v
    return state


def blob_slide(rng, h: int, w: int, n_blobs: int):
    """The tests/test_demo_model.py blob recipe at a larger size."""
    import numpy as np

    img = rng.rand(h, w).astype(np.float32) * 0.15
    for _ in range(n_blobs):
        r, c = rng.randint(20, h - 20), rng.randint(20, w - 20)
        rad = rng.randint(5, 9)
        r0, c0 = r - rad - 2, c - rad - 2
        rr, cc = np.ogrid[r0 : r + rad + 3, c0 : c + rad + 3]
        d2 = (rr - r) ** 2 + (cc - c) ** 2
        win = img[r0 : r + rad + 3, c0 : c + rad + 3]
        win[d2 < rad ** 2] = 0.7
        win[(d2 < (rad + 2) ** 2) & (d2 >= rad ** 2)] = 0.4
    return img


def maps_agree(a, b, compute_dtype) -> tuple:
    """(ok, max level difference, share of pixels that differ) of two uint8
    map stacks, at the bar the CPU tests hold the port to against the JAX
    package (tests/test_torch_infer.py): float32 at most 1 level; bfloat16
    at most 2 levels on at most 5% of pixels, since summation order can
    move a conv output across a bf16 rounding step."""
    import numpy as np

    if a.shape != b.shape:
        return False, None, 1.0
    d = np.abs(a.astype(int) - b.astype(int))
    worst, share = int(d.max()), float((d > 0).mean())
    if compute_dtype is None:
        return worst <= 1, worst, share
    return worst <= 2 and share <= 0.05, worst, share


# -- phases ---------------------------------------------------------------------


def phase_build() -> None:
    from unmicst_tpu_torch.kernels import _build

    secs = _build.build_all()
    log(f"[build] nvcc {secs:.2f}s (parallel, one process per source) "
        f"-> {_build.build_dir()}")
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_kernels(dev) -> dict:
    """K1 and K2 against their plain versions at the main-path shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from unmicst_tpu_torch import kernels
    from unmicst_tpu_torch.core import tiler

    hp = legacy_hp()
    grid = tiler.make_grid(SLIDE, SLIDE, hp.im_size, hp.margin)
    t, k, p = grid.num_tiles, hp.n_classes, hp.im_size
    check(t == 1849, f"expected 1849 tiles, got {t}")
    g = torch.Generator(device=dev).manual_seed(SEED)
    logits = 3 * torch.randn((t, k, p, p), generator=g, device=dev)
    window = torch.from_numpy(tiler.ramp_window(p, hp.margin)).to(dev)
    mask = (torch.rand((t,), generator=g, device=dev) > 0.05).float()
    ones = torch.ones(t, device=dev)

    k1 = kernels.softmax_blend(logits, window, mask)
    k1_plain = kernels.softmax_blend_plain(logits, window, mask)
    torch.cuda.synchronize()
    err1 = (k1 - k1_plain).abs().max().item()
    log(f"[K1] T {t} K {k} P {p}: max |kernel - plain| {err1:.3e} "
        "(atol 1e-6)")
    check(err1 <= 1e-6, f"K1 disagrees with its plain version: {err1}")
    # as the engine calls it: one 256-tile chunk into a slice of the buffer
    buf = torch.zeros_like(logits)
    kernels.softmax_blend(logits[256:512], window, mask[256:512],
                          out=buf[256:512])
    torch.cuda.synchronize()
    err1c = (buf[256:512] - k1_plain[256:512]).abs().max().item()
    untouched = buf[:256].abs().max().item() + buf[512:].abs().max().item()
    log(f"[K1] one 256-tile chunk into out=: max |kernel - plain| "
        f"{err1c:.3e}, outside the slice {untouched}")
    check(err1c <= 1e-6 and untouched == 0,
          f"K1 into a slice: err {err1c}, wrote outside it: {untouched}")
    del buf

    # K2 (a): the Pallas contract, on K1's output read as [npr,npc,P,P,K]
    # through strides (no copy)
    t5 = k1.reshape(grid.npr, grid.npc, k, p, p).permute(0, 1, 3, 4, 2)
    a = kernels.blend_fold(t5, window, grid)
    a_plain = kernels.blend_fold_plain(t5, window, grid)
    torch.cuda.synchronize()
    err2a = (a - a_plain).abs().max().item()
    log(f"[K2a] fold {tuple(a.shape)}: max |kernel - plain| {err2a:.3e} "
        "(atol 1e-5)")
    check(err2a <= 1e-5, f"K2 (a) disagrees with its plain version: {err2a}")

    # K2 (b): the main-path epilogue on real tiles (mask 1)
    weighted = kernels.softmax_blend(logits, window, ones)
    b = kernels.blend_fold_epilogue(weighted, window, grid)
    b_plain = kernels.blend_fold_epilogue_plain(weighted, window, grid)
    torch.cuda.synchronize()
    diff = (b.int() - b_plain.int()).abs()
    err2b = diff.max().item()
    share = (diff > 0).float().mean().item()
    log(f"[K2b] maps {tuple(b.shape)} uint8: max |kernel - plain| {err2b} "
        f"level(s), {share:.3e} of pixels differ (bar: 1 level)")
    check(err2b <= 1, f"K2 (b) disagrees with its plain version: {err2b}")

    # timing at the main-path shapes (inputs of 363 MB: the 50 MB L2
    # cannot hold them between launches)
    k1_ms = cuda_ms(lambda: kernels.softmax_blend(logits, window, ones))
    k1_plain_ms = cuda_ms(
        lambda: kernels.softmax_blend_plain(logits, window, ones), iters=5)
    k1_lib_ms = cuda_ms(lambda: torch.softmax(logits, dim=1))
    n = t * k * p * p
    k1_bound, k1_by = bound_ms(2 * 4 * n + 4 * p * p + 4 * t, 8 * n)

    k2_ms = cuda_ms(lambda: kernels.blend_fold_epilogue(weighted, window,
                                                        grid))
    k2_dev_ms = fold_device_ms(
        lambda: kernels.blend_fold_epilogue(weighted, window, grid),
        "K2 slide epilogue")
    no_sync(lambda: kernels.blend_fold_epilogue(weighted, window, grid),
            "K2 slide epilogue")
    k2_plain_ms = cuda_ms(lambda: kernels.blend_fold_epilogue_plain(
        weighted, window, grid), iters=3)
    cols = weighted.reshape(t, k * p * p).t().unsqueeze(0).contiguous()
    size = (grid.padded_height, grid.padded_width)
    k2_lib_ms = cuda_ms(lambda: F.fold(cols, size, p, stride=grid.sub))
    # elements of the tiles that land inside the cropped slide
    def covered(n_tiles):
        m, sub = grid.margin, grid.sub
        return sum(max(0, min(p, m + SLIDE - i * sub) - max(0, m - i * sub))
                   for i in range(n_tiles))
    n_read = covered(grid.npr) * covered(grid.npc) * k
    n_out = k * SLIDE * SLIDE
    k2_bound, k2_by = bound_ms(4 * n_read + 4 * p * p + n_out,
                               4 * n_read + 7 * n_out)
    for name, ms, pl, lib, bd in [
        ("K1", k1_ms, k1_plain_ms, k1_lib_ms, k1_bound),
        ("K2b", k2_ms, k2_plain_ms, k2_lib_ms, k2_bound),
    ]:
        log(f"[{name}] kernel {ms:.4f} ms | plain {pl:.4f} ms | library "
            f"{lib:.4f} ms | bound {bd:.4f} ms")
    log(f"[K2b] device time per launch (profiler) {k2_dev_ms:.4f} ms, "
        f"events {k2_ms:.4f} ms, {k2_dev_ms / k2_bound:.2f}x the bound")
    del cols, logits, k1, k1_plain, a, a_plain, weighted, b, b_plain
    torch.cuda.empty_cache()
    return {
        "softmax_blend": dict(
            route="cuda", source="unmicst_tpu_torch/csrc/softmax_blend.cu",
            replaces="exhibits/pallas/fused_tail.py:44",
            max_abs_err=err1, ms=k1_ms, plain_ms=k1_plain_ms,
            bound_ms=k1_bound, bound_by=k1_by, library_ms=k1_lib_ms),
        "blend_fold_epilogue": dict(
            route="cuda", source="unmicst_tpu_torch/csrc/blend_fold.cu",
            replaces="exhibits/pallas/blend.py:76",
            max_abs_err=float(err2b), ms=k2_ms, plain_ms=k2_plain_ms,
            bound_ms=k2_bound, bound_by=k2_by, library_ms=k2_lib_ms,
            mode_a_max_abs_err=err2a),
    }


def phase_cli(dev) -> None:
    """The CLI on the committed blobDemo model, and card vs CPU."""
    import numpy as np

    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.core.checkpoint import load_params_for_bundle
    from unmicst_tpu_torch.core.hp import load_model_dir
    from unmicst_tpu_torch.infer import InferenceEngine
    from unmicst_tpu_torch.io.tiff import TiffWriter, imread, num_pages

    rng = np.random.RandomState(42)
    img = blob_slide(rng, 1024, 1024, 256)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "s", "registration", "blobs.tif")
        os.makedirs(os.path.dirname(src))
        with TiffWriter(src, bigtiff=False) as tw:
            tw.write((np.clip(img, 0, 1) * 65535).astype(np.uint16))
        out = os.path.join(tmp, "out")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main([src, "--tool", "unmicst-solo", "--model", "blobDemo",
                       "--modelRoot", os.path.join(ROOT, "models"),
                       "--outputPath", out, "--stackOutput", "--stats"])
        secs = time.perf_counter() - t0
        counts = kernels.launch_counts()
        check(rc == 0, f"CLI returned {rc}")
        prob = os.path.join(out, "blobs_Probabilities_1.tif")
        check(num_pages(prob) == 3, "expected 3 probability pages")
        nuclei = imread(prob, 0).astype(float) / 255
        inside = nuclei[img > 0.6].mean()
        background = nuclei[img < 0.2].mean()
    log(f"[cli] blobDemo 1024^2 stack: {secs:.2f}s, inside {inside:.3f} "
        f"background {background:.3f}, launches {counts}")
    check(inside > 0.8 and background < 0.3,
          f"blob segmentation off: inside {inside}, background {background}")
    check(counts["softmax_blend"] > 0 and counts["blend_fold_epilogue"] > 0,
          f"the CLI did not run both kernels: {counts}")

    bundle = load_model_dir(os.path.join(ROOT, "models", "blobDemo"))
    params = load_params_for_bundle(bundle)
    raw = (np.clip(img[:300, :260], 0, 1) * 65535).astype(np.uint16)
    for dt in (None, torch.bfloat16):
        on_card = InferenceEngine.from_bundle(bundle, params, device=dev,
                                              compute_dtype=dt)
        on_cpu = InferenceEngine.from_bundle(bundle, params, device="cpu",
                                             compute_dtype=dt)
        for kw in ({"rescale": False}, {"outlier": 99.5}):
            a = on_card.infer_slide(raw, **kw)
            ok, worst, share = maps_agree(a, on_cpu.infer_slide(raw, **kw), dt)
            name = "float32" if dt is None else "bfloat16"
            log(f"[cli] engine {name} card vs CPU {kw}: max "
                f"{worst} level(s), {share:.3e} of pixels differ")
            check(ok, f"card and CPU engines disagree: {worst} levels on "
                      f"{share:.3e} of pixels")


def phase_legacy(dev) -> dict:
    """The full-width legacy net over a 4096^2 slide; returns launches."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import kernels
    from unmicst_tpu_torch.infer import InferenceEngine, tile_bytes

    hp = legacy_hp()
    state = seeded_state(hp, "legacy", SEED)
    g = torch.Generator().manual_seed(SEED + 1)
    raw = torch.randint(0, 65536, (SLIDE, SLIDE), generator=g,
                        dtype=torch.int32).numpy().astype(np.uint16)

    f32 = InferenceEngine(hp, state, "legacy", LEGACY_MEAN, LEGACY_STD,
                          device=dev)
    tf32_before = (torch.backends.cudnn.allow_tf32,
                   torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.benchmark)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    maps = f32.infer_slide(raw)
    first = time.perf_counter() - t0
    launches = kernels.launch_counts()
    log(f"[legacy] float32 first call {first:.3f}s (cuDNN autotune "
        f"included), tile batch {f32.tile_batch}, launches {launches}")
    check(maps.shape == (3, SLIDE, SLIDE) and maps.dtype == np.uint8,
          f"bad maps {maps.shape} {maps.dtype}")
    check(launches["softmax_blend"] > 0 and
          launches["blend_fold_epilogue"] > 0,
          f"the main path did not run both kernels: {launches}")
    # a probability partition: the three uint8 planes sum to <= 255
    total = maps.astype(np.int32).sum(axis=0)
    check(total.max() <= 255 and total.min() >= 252,
          f"class planes do not sum to ~255: [{total.min()}, {total.max()}]")

    def rate(engine, reps=5):
        """Host wall seconds of whole ``infer_slide`` calls (uint16 plane
        in, uint8 maps on the host out), warm; Mpx/s at the median."""
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            engine.infer_slide(raw)
            times.append(time.perf_counter() - t)
        med = float(np.median(times))
        return SLIDE * SLIDE / 1e6 / med, med, times

    tf32_after = (torch.backends.cudnn.allow_tf32,
                  torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.benchmark)
    check(tf32_after == tf32_before,
          f"the engine left the TF32/benchmark flags changed: {tf32_before} "
          f"-> {tf32_after}")

    def peak(engine):
        """Peak device bytes of one ``infer_slide`` above what was
        allocated before it."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        engine.infer_slide(raw)
        return torch.cuda.max_memory_allocated() - base

    mpx, med, times = rate(f32)
    peak_f32 = peak(f32)
    log(f"[legacy] float32 4096^2: {mpx:.2f} Mpx/s (median {med:.4f}s of "
        f"{[round(x, 4) for x in times]}), peak device memory "
        f"{peak_f32 / 2**30:.2f} GiB at tile batch {f32.tile_batch}")
    # the tile-batch choice rests on tile_bytes: hold it against what one
    # tile adds to the peak (256 against 128 tiles per forward)
    half = InferenceEngine(hp, state, "legacy", LEGACY_MEAN, LEGACY_STD,
                           tile_batch=f32.tile_batch // 2, device=dev)
    half.infer_slide(raw)  # cuDNN's autotune workspaces out of the peak
    per_tile = (peak_f32 - peak(half)) / (f32.tile_batch - half.tile_batch)
    log(f"[legacy] peak memory per tile {per_tile / 2**20:.3f} MiB "
        f"measured, tile_bytes estimate {tile_bytes(hp) / 2**20:.3f} MiB "
        f"({tile_bytes(hp) / per_tile:.2f}x)")
    check(tile_bytes(hp) >= per_tile,
          "tile_bytes underestimates the memory one tile takes")
    del half
    profile_slide(f32, raw, "float32")
    bf16 = InferenceEngine(hp, state, "legacy", LEGACY_MEAN, LEGACY_STD,
                           compute_dtype=torch.bfloat16, device=dev)
    maps_bf = bf16.infer_slide(raw)
    mpx_bf, med_bf, times_bf = rate(bf16)
    d = np.abs(maps.astype(int) - maps_bf.astype(int))
    log(f"[legacy] bfloat16 4096^2: {mpx_bf:.2f} Mpx/s (median "
        f"{med_bf:.4f}s of {[round(x, 4) for x in times_bf]}), peak device "
        f"memory {peak(bf16) / 2**30:.2f} GiB; vs float32 max {d.max()} "
        f"levels, {(d > 0).mean():.3e} of pixels differ, {(d > 1).mean():.3e}"
        " by >1")
    profile_slide(bf16, raw, "bfloat16")

    # the same weights on the CPU (plain versions) over a small slide
    small = raw[:300, :300]
    card, cpu = {}, {}
    for engine in (f32, bf16):
        dt = engine.compute_dtype
        card[dt] = engine.infer_slide(small)
        cpu[dt] = InferenceEngine(hp, state, "legacy", LEGACY_MEAN,
                                  LEGACY_STD, compute_dtype=dt,
                                  device="cpu").infer_slide(small)
    ok, worst, share = maps_agree(card[None], cpu[None], None)
    log(f"[legacy] float32 card vs CPU on 300^2: max {worst} level(s), "
        f"{share:.3e} of pixels differ")
    check(ok, f"float32 card and CPU disagree by {worst} levels")
    # bfloat16 with seeded weights: summation order (cuDNN against the
    # CPU) moves some conv outputs across a bf16 rounding step, and this
    # untrained net amplifies such steps, so no level bar holds here (the
    # bar holds on trained blobDemo weights, phase 3).  What must hold is
    # that the card's bf16 maps are nearer the CPU's bf16 maps than the
    # card's float32 maps.
    bf = torch.bfloat16
    _, worst, share = maps_agree(card[bf], cpu[bf], bf)
    _, worst_m, share_m = maps_agree(card[bf], card[None], None)
    log(f"[legacy] bfloat16 card vs CPU on 300^2: max {worst} level(s), "
        f"{share:.3e} of pixels differ; card bfloat16 vs float32: max "
        f"{worst_m}, {share_m:.3e}")
    check(share < share_m, "bfloat16 on the card is no nearer the CPU's "
                           "bfloat16 than the card's float32")
    return launches


def profile_slide(engine, raw, label: str) -> None:
    """Where one slide's device time goes: torch.profiler over one
    ``infer_slide``, device kernels summed by name, and the device's busy
    and idle shares of the call's wall time (profiler on)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.infer_slide(raw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    if not by_name:
        log("[profile] not measured: the profiler saw no device events")
        return
    busy = sum(ms for ms, _ in by_name.values())
    groups = {"K1 softmax_blend": ("softmax_blend",),
              "K2 blend_fold": ("fold_region", "fold_weighted")}
    kernel_ms = {g: sum(ms for name, (ms, _) in by_name.items()
                        if any(s in name for s in keys))
                 for g, keys in groups.items()}
    log(f"[profile] {label} slide: wall {wall_ms:.2f} ms (profiler on), "
        f"device busy {busy:.2f} ms ({busy / wall_ms:.3f}), idle share "
        f"{1 - busy / wall_ms:.3f}; "
        + ", ".join(f"{g} {ms:.3f} ms" for g, ms in kernel_ms.items()))
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile] {ms:9.3f} ms {ms / busy:6.3f} x{n:<4d} {name[:100]}")


def covered(n_tiles: int, sub: int, patch: int, lo: int, hi: int) -> int:
    """(tile, pixel) pairs along one axis whose canvas coordinate lies in
    [lo, hi): the tile elements a fold over that window reads."""
    return sum(max(0, min(i * sub + patch, hi) - max(i * sub, lo))
               for i in range(n_tiles))


def phase_halo(dev) -> dict:
    """K3/K4a/K4b against their plain versions, then spatial_infer on 4
    ranks of the card with every seam implementation."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import kernels
    from unmicst_tpu_torch.core import tiler
    from unmicst_tpu_torch.infer import InferenceEngine
    from unmicst_tpu_torch.kernels import halo_ring
    from unmicst_tpu_torch.runtime import halo
    from unmicst_tpu_torch.runtime.mesh import make_mesh

    hp = legacy_hp()
    grid = tiler.make_grid(SLIDE, SLIDE, hp.im_size, hp.margin)
    two_m, wp = 2 * hp.margin, grid.padded_width
    g = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [((two_m, wp, 1), torch.float32), ((two_m, wp, 3), torch.float32),
              ((7, 13), torch.int16),  # 182 bytes: not a multiple of 16
              ("view", torch.float32)]  # 4 bytes off 16-byte alignment

    def ring_of(n, shape, dtype):
        if shape == "view":
            return [torch.randn((1 + two_m * wp * 3,), generator=g,
                                device=dev)[1:].view(two_m, wp, 3)
                    for _ in range(n)]
        if dtype == torch.int16:
            return [torch.randint(-30000, 30000, shape, generator=g,
                                  device=dev, dtype=torch.int32).to(dtype)
                    for _ in range(n)]
        return [torch.randn(shape, generator=g, device=dev) for _ in range(n)]

    k3_err = k4_err = 0.0  # max |kernel - plain| over every ring checked
    for n in (1, 2, 4, 8):
        for shape, dtype in shapes:
            xs = ring_of(n, shape, dtype)
            for shift in (1, -1):
                ref = kernels.ring_shift_plain(xs, shift)
                before = kernels.launch_counts()
                k3 = kernels.ring_shift(xs, shift, kind="output")
                k4 = kernels.ring_shift_wait(kernels.ring_shift_start(xs, shift))
                torch.cuda.synchronize()
                after = kernels.launch_counts()
                # ranks on one card: one store launch per hop, no K3 wait
                for name in ("ring_shift", "ring_shift_start",
                             "ring_shift_wait"):
                    check(after[name] - before[name] == 1,
                          f"ring n {n}: {name} launched "
                          f"{after[name] - before[name]} kernels for one hop")
                for a, b, r in zip(k3, k4, ref):
                    k3_err = max(k3_err, (a.double() - r.double()).abs()
                                 .max().item())
                    k4_err = max(k4_err, (b.double() - r.double()).abs()
                                 .max().item())
                same = all(torch.equal(a, r) and torch.equal(b, r)
                           for a, b, r in zip(k3, k4, ref))
                check(same, f"ring n {n} {shape} shift {shift}: K3 or K4 "
                            "differs from the plain copy")
        log(f"[halo] ring of {n}: K3 and K4a+K4b bit-equal to the plain copy "
            f"on {[s for s, _ in shapes]}, shifts +1 and -1; one launch each "
            "of K3, K4a and K4b per hop")
    log(f"[halo] max |kernel - plain| over every ring: K3 {k3_err} | "
        f"K4a+K4b {k4_err}")

    # times on the output hop's buffers, 4 ranks on the card
    xs = [torch.randn((two_m, wp, 3), generator=g, device=dev)
          for _ in range(RANKS)]
    dst = [torch.empty_like(x) for x in xs]
    n_bytes = sum(x.numel() * 4 for x in xs)
    side = halo_ring._ring((dev.index,) * RANKS).side_stream(dev.index)

    def start_joined():
        kernels.ring_shift_start(xs, 1)
        torch.cuda.current_stream().wait_stream(side)

    def copies():
        for i, d in enumerate(dst):
            d.copy_(xs[(i - 1) % RANKS])

    landed = kernels.ring_shift_start(xs, 1)
    torch.cuda.synchronize()
    # K4b's yardstick: the current stream waits for an event recorded on
    # another stream after the four copies (the hop landed)
    with torch.cuda.stream(side):
        copies()
        copied = side.record_event()
    torch.cuda.synchronize()
    cur = torch.cuda.current_stream()
    k3_ms = cuda_ms(lambda: kernels.ring_shift(xs, 1, kind="output"))
    k4a_ms = cuda_ms(start_joined)
    k4b_ms = cuda_ms(lambda: kernels.ring_shift_wait(landed))
    wait_event_ms = cuda_ms(lambda: cur.wait_event(copied))
    plain_ms = cuda_ms(lambda: kernels.ring_shift_plain(xs, 1))
    plain_handle = landed._replace(plain=True)
    plain_wait_ms = cuda_ms(lambda: kernels.ring_shift_wait(plain_handle))
    copy_ms = cuda_ms(copies)
    hop_bound, hop_by = bound_ms(2 * n_bytes, 0)
    wait_bound, wait_by = bound_ms(4 * RANKS, 0)
    log(f"[halo] hop of {RANKS} x {(two_m, wp, 3)} f32 ({n_bytes / 1e6:.2f} "
        f"MB), CUDA events around each call: K3 {k3_ms:.4f} ms | K4a (stores, "
        f"side stream joined) {k4a_ms:.4f} ms | K4b (hop landed) "
        f"{k4b_ms:.4f} ms | plain {plain_ms:.4f} ms | Tensor.copy_ x{RANKS} "
        f"{copy_ms:.4f} ms | Stream.wait_event {wait_event_ms:.4f} ms | "
        f"bound {hop_bound:.4f} ms")

    def host_ms(fn, iters=200):
        """Host wall time of one call, the card left to run behind."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t = (time.perf_counter() - t0) / iters * 1e3
        torch.cuda.synchronize()
        return t

    log(f"[halo] host issue time per call: K3 "
        f"{host_ms(lambda: kernels.ring_shift(xs, 1, kind='output')):.4f} ms"
        f" | K4a (side stream joined) {host_ms(start_joined):.4f} ms | K4b "
        f"{host_ms(lambda: kernels.ring_shift_wait(landed)):.4f} ms | "
        f"Tensor.copy_ x{RANKS} {host_ms(copies):.4f} ms | Stream.wait_event "
        f"{host_ms(lambda: cur.wait_event(copied)):.4f} ms")
    dev_idx, waits = dev.index, landed.waits
    log(f"[halo] K4b's parts, host time per call: current-stream check by "
        f"stream id "
        f"{host_ms(lambda: torch._C._cuda_getCurrentStream(dev_idx)):.4f} ms"
        f" (torch.cuda.current_stream "
        f"{host_ms(lambda: torch.cuda.current_stream(dev_idx)):.4f} ms) | "
        "the bare ring_wait_all call (one wait warp) "
        f"{host_ms(lambda: waits.launch(waits.addr, waits.n)):.4f} ms")
    names = ("ring_store", "ring_wait")
    dev_k3 = kernel_device_ms(lambda: kernels.ring_shift(xs, 1, kind="output"),
                              names)
    dev_k4a = kernel_device_ms(start_joined, names)
    dev_k4b = kernel_device_ms(lambda: kernels.ring_shift_wait(landed), names)
    dev_copy = kernel_device_ms(copies, ("copy", "Memcpy"))
    copy_dev_ms = sum(ms for ms, n in dev_copy.values() if n)
    copy_dev_n = sum(n for _, n in dev_copy.values())

    def per_launch(ms_n):
        ms, n = ms_n
        return f"{n:g} x {ms / n:.4f} ms" if n else "none"

    for label, d in (("K3 ring_shift", dev_k3), ("K4a ring_shift_start", dev_k4a),
                     ("K4b ring_shift_wait", dev_k4b)):
        log(f"[halo] {label}, kernels' own device time per call (profiler): "
            f"store {per_launch(d['ring_store'])} | wait "
            f"{per_launch(d['ring_wait'])}")
    log(f"[halo] Tensor.copy_ x{RANKS} device time per call (profiler): "
        f"{copy_dev_ms:.4f} ms in {copy_dev_n:g} launches; Stream.wait_event "
        "launches no kernel")
    for label, d, want in (("K3", dev_k3, (1, 0)), ("K4a", dev_k4a, (1, 0)),
                           ("K4b", dev_k4b, (0, 1))):
        check((d["ring_store"][1], d["ring_wait"][1]) == want,
              f"{label} on one card: expected {want[0]} store and {want[1]} "
              f"wait launch(es) per hop, the profiler saw {d}")

    # spatial_infer at full width: 4096^2, 4 ranks on the card
    state = seeded_state(hp, "legacy", SEED)
    plane = torch.rand((SLIDE, SLIDE), generator=torch.Generator()
                       .manual_seed(SEED + 2)).numpy()
    canvas = halo.build_canvas(plane, hp, RANKS)
    mesh = make_mesh(devices=[dev] * RANKS)
    npr_pad = -(-grid.npr // RANKS) * RANKS
    R = npr_pad // RANKS
    log(f"[halo] spatial_infer 4096^2 on {RANKS} ranks: npr {grid.npr} -> "
        f"{npr_pad}, R {R} tile rows, {R * grid.npc} tiles per rank")
    single = InferenceEngine(hp, state, "legacy", LEGACY_MEAN, LEGACY_STD,
                             device=dev).infer(plane)
    outs, launches = {}, {}
    for impl in ("ppermute", "ring", "ring_overlap"):
        run = lambda: halo.spatial_infer(  # noqa: E731
            state, canvas, SLIDE, SLIDE, hp, "legacy", mesh,
            mean=LEGACY_MEAN, std=LEGACY_STD, halo_impl=impl)
        run()  # cuDNN autotune at these shapes
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        outs[impl] = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[impl] = kernels.launch_counts()
        got = outs[impl].cpu().numpy()
        err = float(np.abs(np.moveaxis(got, -1, 0) - single).max())
        log(f"[halo] {impl}: wall {wall:.4f} s ({SLIDE * SLIDE / 1e6 / wall:.2f}"
            f" Mpx/s), max |halo - engine| {err:.3e} (bar 2e-5), launches "
            f"{ {k: v for k, v in launches[impl].items() if v} }")
        check(got.shape == (SLIDE, SLIDE, 3) and np.isfinite(got).all(),
              f"{impl}: bad maps {got.shape}")
        check(err <= 2e-5, f"{impl} disagrees with the engine: {err}")
    for impl in ("ring", "ring_overlap"):
        d = (outs[impl] - outs["ppermute"]).abs().max().item()
        log(f"[halo] {impl} vs ppermute: max |diff| {d:.3e} (bar 1e-6)")
        check(d <= 1e-6, f"{impl} disagrees with ppermute: {d}")
    # the ranks share one card: each hop is one store launch (K3 with no
    # wait; K4a's stores, then one K4b wait)
    ring_l, ov_l = launches["ring"], launches["ring_overlap"]
    check(ring_l["ring_shift"] == 2 and ring_l["blend_fold_strip"] > 0
          and ring_l["softmax_blend"] > 0, f"ring launches {ring_l}")
    check(ov_l["ring_shift_start"] == 1 and ov_l["ring_shift_wait"] == 1
          and ov_l["ring_shift"] == 1, f"ring_overlap launches {ov_l}")
    check(launches["ppermute"]["ring_shift"] == 0, "ppermute ran K3")

    # K2's fold-only entry at a band's shapes: [R*npc, 3, 128, 128]
    band = tiler.make_grid(R * grid.sub, SLIDE, hp.im_size, hp.margin)
    t = R * grid.npc
    logits = 3 * torch.randn((t, 3, hp.im_size, hp.im_size), generator=g,
                             device=dev)
    window = torch.from_numpy(tiler.ramp_window(hp.im_size, hp.margin)).to(dev)
    weighted = kernels.softmax_blend(logits, window, torch.ones(t, device=dev))
    strip = kernels.blend_fold_strip(weighted, band)
    t5 = weighted.reshape(band.npr, band.npc, 3, hp.im_size, hp.im_size)
    strip_plain = tiler.fold(t5.permute(0, 1, 3, 4, 2), band)
    strip_err = (strip - strip_plain).abs().max().item()
    check(strip_err <= 1e-5, f"K2 strip disagrees with its plain version: "
                             f"{strip_err}")
    strip_ms = cuda_ms(lambda: kernels.blend_fold_strip(weighted, band))
    strip_dev_ms = fold_device_ms(
        lambda: kernels.blend_fold_strip(weighted, band), "K2 strip")
    no_sync(lambda: kernels.blend_fold_strip(weighted, band), "K2 strip")
    strip_plain_ms = cuda_ms(lambda: tiler.fold(t5.permute(0, 1, 3, 4, 2),
                                                band), iters=3)
    cols = weighted.reshape(t, -1).t().unsqueeze(0).contiguous()
    strip_lib_ms = cuda_ms(lambda: torch.nn.functional.fold(
        cols, (band.padded_height, band.padded_width), hp.im_size,
        stride=band.sub))
    n_el = t * 3 * hp.im_size ** 2
    strip_bound, strip_by = bound_ms(
        4 * n_el + 4 * strip.numel(), n_el)
    log(f"[K2 strip] {tuple(weighted.shape)} -> {tuple(strip.shape)}: max "
        f"|kernel - plain| {strip_err:.3e} | kernel {strip_ms:.4f} ms | plain "
        f"{strip_plain_ms:.4f} ms | library {strip_lib_ms:.4f} ms | bound "
        f"{strip_bound:.4f} ms | device time per launch (profiler) "
        f"{strip_dev_ms:.4f} ms, {strip_dev_ms / strip_bound:.2f}x the bound")
    del logits, weighted, cols, strip, strip_plain, outs
    torch.cuda.empty_cache()
    hop = dict(route="cuda", source="unmicst_tpu_torch/csrc/halo_ring.cu")
    return {
        "blend_fold_strip": dict(
            route="cuda", source="unmicst_tpu_torch/csrc/blend_fold.cu",
            replaces="exhibits/pallas/blend.py:76", max_abs_err=strip_err,
            ms=strip_ms, plain_ms=strip_plain_ms, bound_ms=strip_bound,
            bound_by=strip_by, library_ms=strip_lib_ms,
            launches=ring_l["blend_fold_strip"]),
        "ring_shift": dict(
            hop, replaces="unmicst_tpu/kernels/halo_rdma.py:80",
            max_abs_err=k3_err, ms=k3_ms,
            plain_ms=plain_ms, bound_ms=hop_bound, bound_by=hop_by,
            library_ms=copy_ms, launches=ring_l["ring_shift"]),
        "ring_shift_start": dict(
            hop, replaces="unmicst_tpu/kernels/halo_rdma.py:198",
            max_abs_err=k4_err, ms=k4a_ms,
            plain_ms=plain_ms, bound_ms=hop_bound, bound_by=hop_by,
            library_ms=copy_ms, launches=ov_l["ring_shift_start"]),
        "ring_shift_wait": dict(
            hop, replaces="unmicst_tpu/kernels/halo_rdma.py:236",
            max_abs_err=k4_err, ms=k4b_ms,
            plain_ms=plain_wait_ms, bound_ms=wait_bound, bound_by=wait_by,
            library_ms=wait_event_ms, launches=ov_l["ring_shift_wait"]),
    }


def phase_streaming(dev) -> dict:
    """The 8192^2 slide through the streaming engine, its column-sharded
    form and the CLI's auto route."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.core import tiler
    from unmicst_tpu_torch.core.hp import load_model_dir
    from unmicst_tpu_torch.infer import InferenceEngine
    from unmicst_tpu_torch.io.tiff import TiffWriter, imread
    from unmicst_tpu_torch.runtime.mesh import make_mesh
    from unmicst_tpu_torch.runtime.pipeline import StreamingEngine

    hp = legacy_hp()
    state = seeded_state(hp, "legacy", SEED)
    g = torch.Generator().manual_seed(SEED + 3)
    raw = torch.randint(0, 65536, (BIG, BIG), generator=g,
                        dtype=torch.int32).numpy().astype(np.uint16)
    mpx = BIG * BIG / 1e6

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    whole_engine = InferenceEngine(hp, state, "legacy", LEGACY_MEAN,
                                   LEGACY_STD, device=dev)
    whole, secs = timed(lambda: whole_engine.infer_slide(raw))
    log(f"[stream] whole engine 8192^2: {secs:.3f} s ({mpx / secs:.2f} Mpx/s, "
        "first call)")
    del whole_engine
    torch.cuda.empty_cache()
    stream = StreamingEngine(hp, state, "legacy", LEGACY_MEAN, LEGACY_STD,
                             compute_dtype=None, device=dev)
    plan = stream._plan(BIG, BIG)
    kernels.reset_launch_counts()
    got, secs = timed(lambda: stream.infer(raw))
    launches = kernels.launch_counts()
    d = np.abs(got.astype(int) - whole.astype(int))
    log(f"[stream] StreamingEngine.infer 8192^2 float32: {secs:.3f} s "
        f"({mpx / secs:.2f} Mpx/s, first call), S {plan.S}, {plan.n_stripes} "
        f"stripes; vs infer_slide max {d.max()} level(s), {(d > 0).mean():.3e}"
        f" of pixels differ; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    check(got.shape == (3, BIG, BIG) and d.max() <= 1,
          f"stream disagrees with the whole engine: {d.max()} levels")
    check(launches["blend_fold_stripe"] == plan.n_stripes
          and launches["softmax_blend"] > 0
          and launches["blend_fold_epilogue"] == 0,
          f"the stream did not run K1 and K2's stripe entry: {launches}")
    _, secs = timed(lambda: stream.infer(raw))
    log(f"[stream] StreamingEngine.infer again: {secs:.3f} s "
        f"({mpx / secs:.2f} Mpx/s)")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: stream.infer(raw))
    busy = busy_ms(prof)
    log(f"[stream] StreamingEngine.infer under the profiler: wall "
        f"{wall * 1e3:.2f} ms ({mpx / wall:.2f} Mpx/s, profiler on), device "
        f"busy {busy:.2f} ms ({busy / (wall * 1e3):.3f}), idle share "
        f"{1 - busy / (wall * 1e3):.3f}; warm without the profiler "
        f"{mpx / secs:.2f} Mpx/s")
    # one stripe of the loop, its rows already on the card: no call in it
    # may wait for the host
    from unmicst_tpu_torch.runtime.pipeline import _to_torch

    lo_hi = tuple(np.float32(v) for v in stream.global_stats(raw))
    s1 = min(1, plan.n_stripes - 1)
    rows_dev = _to_torch(stream._read_rows(
        raw, (s1 * plan.S - 1) * plan.grid.sub - plan.grid.margin,
        plan.in_rows)).to(dev)
    stripe_args = (rows_dev, plan, s1, np.dtype(np.uint16), True, lo_hi,
                   [0, 1, 2])
    ref_stripe = stream._stripe(*stripe_args)
    got_stripe = no_sync(lambda: stream._stripe(*stripe_args),
                         f"StreamingEngine._stripe (stripe {s1})")
    d_stripe = (got_stripe.int() - ref_stripe.int()).abs().max().item()
    check(d_stripe <= 1, f"_stripe under the sync check is {d_stripe} "
                         "levels from the same call before it")
    mesh = make_mesh(devices=[dev] * RANKS)
    _, first = timed(lambda: stream.infer_sharded(raw, mesh))
    kernels.reset_launch_counts()
    sharded, secs = timed(lambda: stream.infer_sharded(raw, mesh))
    sh_launches = kernels.launch_counts()
    log(f"[stream] infer_sharded first call {first:.3f} s (cuDNN autotune "
        "included)")
    d = np.abs(sharded.astype(int) - got.astype(int))
    log(f"[stream] infer_sharded over {RANKS} ranks (ring seams): {secs:.3f} s "
        f"({mpx / secs:.2f} Mpx/s); vs infer max {d.max()} level(s), "
        f"{(d > 0).mean():.3e} of pixels differ; launches "
        f"{ {k: v for k, v in sh_launches.items() if v} }")
    check(d.max() <= 1, f"sharded disagrees with the stream: {d.max()}")
    # two hops per stripe, one K3 store launch each (the ranks share a card)
    check(sh_launches["ring_shift"] == 2 * plan.n_stripes,
          f"sharded seams did not run K3 once per hop: {sh_launches}")

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "s", "registration", "big.tif")
        os.makedirs(os.path.dirname(src))
        with TiffWriter(src, bigtiff=True) as tw:
            tw.write(raw)
        out = os.path.join(tmp, "out")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main([src, "--tool", "unmicst-legacy", "--model",
                       os.path.join(ROOT, "models", "blobDemo"),
                       "--outputPath", out, "--stackOutput", "--stats"])
        secs = time.perf_counter() - t0
        cli_launches = kernels.launch_counts()
        pages = [imread(os.path.join(out, "big_Probabilities_1.tif"), k)
                 for k in range(3)]
        # --engine sharded over every visible card (one here: one rank)
        out_sh = os.path.join(tmp, "out_sharded")
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        rc_sh = cli.main([src, "--tool", "unmicst-legacy", "--model",
                          os.path.join(ROOT, "models", "blobDemo"),
                          "--outputPath", out_sh, "--stackOutput",
                          "--engine", "sharded", "--stats"])
        secs_sh = time.perf_counter() - t1
        cli_sh_launches = kernels.launch_counts()
        sh_diff = max(int(np.abs(imread(os.path.join(
            out_sh, "big_Probabilities_1.tif"), k).astype(int)
            - pages[k].astype(int)).max()) for k in range(3))
    check(rc == 0 and all(p.shape == (BIG, BIG) for p in pages),
          f"CLI --engine auto failed: rc {rc}")
    log(f"[stream] CLI --engine sharded ({torch.cuda.device_count()} "
        f"rank(s)) on the same TIFF: {secs_sh:.2f} s end to end; vs --engine "
        f"auto max {sh_diff} level(s); launches "
        f"{ {k: v for k, v in cli_sh_launches.items() if v} }")
    check(rc_sh == 0 and sh_diff <= 1,
          f"CLI --engine sharded: rc {rc_sh}, {sh_diff} levels from auto")
    # per stripe two hops; one rank makes each hop one K3 store launch (n
    # ranks on n cards: a store and a wait per card)
    cards = torch.cuda.device_count()
    cli_plan = StreamingEngine.from_bundle(
        load_model_dir(os.path.join(ROOT, "models", "blobDemo")), {},
        device=dev)._plan(BIG, BIG)
    per_hop = 1 if cards == 1 else 2 * cards
    check(cli_sh_launches["ring_shift"] == 2 * cli_plan.n_stripes * per_hop,
          f"--engine sharded: expected {per_hop} K3 launch(es) per hop, two "
          f"hops for each of {cli_plan.n_stripes} stripes: {cli_sh_launches}")
    check(cli_launches["blend_fold_stripe"] > 0
          and cli_launches["blend_fold_epilogue"] == 0,
          f"--engine auto did not stream the 67 Mpx slide: {cli_launches}")
    total = sum(p.astype(np.int32) for p in pages)
    check(total.max() <= 255 and total.min() >= 252,
          f"CLI class pages do not sum to ~255: [{total.min()}, {total.max()}]")
    log(f"[stream] CLI --engine auto (blobDemo) on a 8192^2 TIFF: {secs:.2f} s "
        f"end to end ({mpx / secs:.2f} Mpx/s, read, stats, stream, preview "
        f"and write), streamed: {cli_launches['blend_fold_stripe']} stripes")

    # K2's stripe entry at a stripe's shapes
    grid = plan.grid
    sub, m = grid.sub, grid.margin
    band = tiler.make_grid((plan.S + 1) * sub, BIG, hp.im_size, hp.margin)
    t = band.num_tiles
    gd = torch.Generator(device=dev).manual_seed(SEED)
    logits = 3 * torch.randn((t, 3, hp.im_size, hp.im_size), generator=gd,
                             device=dev)
    window = torch.from_numpy(tiler.ramp_window(hp.im_size, hp.margin)).to(dev)
    rmask = torch.ones(plan.S + 1, device=dev)
    rmask[0] = 0.0  # the first stripe's phantom row above the slide
    weighted = kernels.softmax_blend(
        logits, window, rmask.repeat_interleave(band.npc))
    rows, cols = (sub, plan.band_rows), (m, BIG)
    args = (weighted, window, band, rows, cols)
    st = kernels.blend_fold_stripe(*args, row_mask=rmask)
    st_plain = kernels.fold_region_plain(weighted, window, band, rows, cols,
                                         [0, 1, 2], "u8", rmask)
    st_err = (st.int() - st_plain.int()).abs().max().item()
    check(st_err <= 1, f"K2 stripe disagrees with its plain version: {st_err}")
    st_ms = cuda_ms(lambda: kernels.blend_fold_stripe(*args, row_mask=rmask))
    st_dev_ms = fold_device_ms(
        lambda: kernels.blend_fold_stripe(*args, row_mask=rmask), "K2 stripe")
    no_sync(lambda: kernels.blend_fold_stripe(*args, row_mask=rmask),
            "K2 stripe")
    st_plain_ms = cuda_ms(lambda: kernels.fold_region_plain(
        weighted, window, band, rows, cols, [0, 1, 2], "u8", rmask), iters=3)
    flat = weighted.reshape(t, -1).t().unsqueeze(0).contiguous()
    st_lib_ms = cuda_ms(lambda: torch.nn.functional.fold(
        flat, (band.padded_height, band.padded_width), hp.im_size,
        stride=band.sub))
    n_read = (covered(band.npr, sub, hp.im_size, rows[0], rows[0] + rows[1])
              * covered(band.npc, sub, hp.im_size, m, m + BIG) * 3)
    n_out = 3 * rows[1] * BIG
    st_bound, st_by = bound_ms(4 * n_read + 4 * hp.im_size ** 2 + n_out,
                               4 * n_read + 7 * n_out)
    log(f"[K2 stripe] {tuple(weighted.shape)} -> {tuple(st.shape)} uint8: max "
        f"|kernel - plain| {st_err} level(s) | kernel {st_ms:.4f} ms | plain "
        f"{st_plain_ms:.4f} ms | library {st_lib_ms:.4f} ms | bound "
        f"{st_bound:.4f} ms | device time per launch (profiler) "
        f"{st_dev_ms:.4f} ms, {st_dev_ms / st_bound:.2f}x the bound")
    del logits, weighted, flat, st, st_plain
    torch.cuda.empty_cache()
    return {"blend_fold_stripe": dict(
        route="cuda", source="unmicst_tpu_torch/csrc/blend_fold.cu",
        replaces="exhibits/pallas/blend.py:76", max_abs_err=float(st_err),
        ms=st_ms, plain_ms=st_plain_ms, bound_ms=st_bound, bound_by=st_by,
        library_ms=st_lib_ms, launches=launches["blend_fold_stripe"])}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import unmicst_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    phase_build()
    stats = phase_kernels(dev)
    phase_cli(dev)
    launches = phase_legacy(dev)
    for name in stats:
        stats[name]["launches"] = launches[name]
    stats.update(phase_halo(dev))
    stats.update(phase_streaming(dev))
    log(f"[done] {time.perf_counter() - t0:.1f}s")
    rows = []
    for name, row in stats.items():
        rows.append({"name": name, **{k: row[k] for k in (
            "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi unavailable (rc {smi.returncode})")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
