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
   K2's slide epilogue in both modes, uint8 maps and the float32 maps of
   the host float path (yardstick: ``fold`` of the tiles over ``fold``
   of the window);
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
7. duo and scale: the full-width duo net (nucleiDAPILAMIN's
   hyper-parameters, seeded weights) over a seeded 4096^2 two-channel
   uint16 slide through ``InferenceEngine.infer_slide_stack``, float32 and
   bfloat16, with Mpx/s (median of 3), peak device memory, the launch
   counters (set to 0 just before the float32 call), one profiled call's
   idle share, and the card against the CPU on 256^2; the legacy net at
   4096^2 through ``infer_slide`` at ``scaling_factor`` 0.5 and 0.65
   (Mpx/s on raw pixels), K2's epilogue on the 0.65 grid (2662 columns,
   its ragged scalar lanes) against its plain version (0 levels), and the
   card against the CPU at 0.65; ``StreamingEngine.infer_stack`` and
   ``infer_sharded_stack`` (4 ranks of the card) on a seeded 8192^2 duo
   slide against ``infer_slide_stack``, with one stack stripe checked for
   host synchronisation; ``StreamingEngine.infer`` on a
   ``ResampledSource(tiff, 0.5)`` of the 4096^2 slide, upscaled with
   ``upscale_pm``, against ``infer_slide(scaling_factor=0.5)``; the CLI's
   ``--tool unmicst-duo --channel 1 2`` (the ``oracle_duo`` TF1 weights in
   a temporary model directory) and ``--scalingFactor 0.5`` (blobDemo);
   every number beside the card's name and power limit;
8. sweep and host float path: the legacy net at nucleiDAPI's widths with
   seeded weights, written as a model directory by ``save_tf1_params`` and
   read back bit for bit; ``python -m unmicst_tpu_torch.batch`` in a child
   process over a root of two 4096^2 slides (whole engine), an 8192^2
   one (streamed) and a truncated one (exit 2, that slide alone in
   ``failed``), every page against the engines in this process, the
   sweep's Mpx/s and each slide's seconds beside the bare engine call;
   the same sweep again (every slide skipped, K1 never launched) beside
   the 8192^2 slide with ``--engine sharded --meshShape 4`` (K3 twice per
   stripe), the two children side by side; then ``cli.main`` on the host
   float path, a 4096^2 int16 legacy slide and a 4096^2 uint8 + uint16
   duo slide (the duo net at nucleiDAPILAMIN's widths, its model
   directory also written by
   ``save_tf1_params``), beside the on-card path for the same slides in
   uint16, with K2's float32 epilogue launched once per slide, the host
   path's breakdown and the D2H of its float32 maps; the card against
   the CPU at 1024^2, ``--check-numerics`` on seeded weights and on a NaN
   weight, and ``--trace`` (a trace holding K1 and K2 events);
9. train (float32, TF32 off): TF's one-step and both 50-step trajectory
   oracles on the card; one step at nucleiDAPI1-5's and nucleiDAPI's
   widths on the card against the CPU (loss, first-moment slot, and
   Momentum's weights); the device step by events and the profiler with
   an analytic FLOP count beside XLA's, the bfloat16 step, and ``fit`` at
   ``valid_every`` 1 and 50 with ``prefetch`` 0 and 4; ``Trainer.save`` of
   the v2 directory reloaded from its msgpack file and from its TF1
   bundle; ``cli.main`` and ``python -m unmicst_tpu_torch`` on a 4096^2
   slide with that directory (K1 and K2 launched, the child's pages
   against ``cli.main``'s, and both again with cuDNN's algorithms pinned;
   the two children and the pinned ``cli.main`` side by side);
10. int8 (``--precision int8``: the bfloat16 mode with the plain conv
    sites as an exact s8 x s8 -> s32 ``torch._int_mm`` over an im2col):
    at every int8 site of nucleiDAPI's and nucleiDAPILAMIN's widths, at
    the engine's chunk, the card's int32 sums against a float64
    convolution of the same int8 values (0 apart), and the route's time
    by stage beside the bfloat16-mode cuDNN conv and the bound; the
    legacy 4096^2 slide in int8 beside float32 and bfloat16 in turns
    (median of 5), its calibration seconds, peak memory and profile by
    kind; int8 against bfloat16 at the JAX CLI's int8 bar; the card
    against the CPU with one QuantState (seeded weights: few pixels
    apart; blobDemo: 2 levels on 5%); blobDemo's calibration from fresh
    threads, half under load, to the same scales; the scaled slide at
    0.5, the 8192^2 stream and its 4-rank sharded form, the duo net at
    4096^2, with the launches of K1, K2 and K3; ``--precision int8``
    through ``cli.main``;
11. serving (``unmicst_tpu_torch.serve`` live on the card in threads, the
    legacy net at nucleiDAPI's widths with seeded weights written by
    ``save_tf1_params``): ``POST /infer`` of a 4096^2 slide in float32 and
    bfloat16 beside the bare ``infer_slide``, four concurrent clients
    against the same requests one at a time (byte-equal), an 8192^2
    ``POST /slides`` and 50 pans of a 1024^2 ROI at seeded offsets on the
    pinned plane and again on the host path (p50/p95, the first pan, the
    H2D and D2H bytes of a pan from the profiler's memcpy events),
    ``classes=1`` pans, the 8192^2 streamed post with a pinned range beside
    the bare ``StreamingEngine.infer`` and pinned-range pans against its
    crop (at most 1 level), a streamed post at ``scale=0.5``, one int8
    request against the bfloat16 server, ``prewarm=1``, ``DELETE`` and
    ``/stats``, the launch counters set to 0 before the first request and
    read after the last; then K2's trimmed route at a pan's shapes
    against its plain version (0 levels);
12. multi-process and tensor parallelism (M13): the v2 training step at
    nucleiDAPI1-5's widths (64 px, nOut0 80, 4 layers, batch 32, dropout
    on) over ``make_mesh(data=1, model=2)`` on the card (the 1280-wide
    bottom and every layer of 256 or more split) against the one-device
    step at phase 9's bar, with each step's ms; then two worker processes
    (this script with ``--mp-worker``, a free ``tcp://localhost`` port)
    sharing the card over gloo, and one process per card over NCCL when
    there are two cards, each with one rank of a mesh spanning the
    processes: K3 and K4a/K4b across the processes (shared slots over
    CUDA IPC, credit words) bit-equal to ``ppermute`` on the seam buffers
    of a 4096^2 slide with the hop's event ms, and ``ppermute`` over gloo
    on the card refused; ``spatial_infer`` of a seeded 4096^2 plane,
    ``ring`` and ``ring_overlap``, within 2e-5 of ``InferenceEngine.infer``;
    ``infer_sharded`` of a seeded 8192^2 slide within 1 level of
    ``StreamingEngine.infer``; the DP step over the processes against the
    one-device step; each worker's launch counters set to 0 before each
    path and read after;
13. slide formats (the legacy net at nucleiDAPI's widths, seeded weights
    written by ``save_tf1_params``; the CZI and ND2 fixtures written here,
    their zstd frames by the port's ``io/zstd.compress``): whether the
    host's libzstd loads (without it, every zstd path must refuse naming
    ROADMAP M14b, and the zstd cases run uncompressed); a seeded 8192^2
    uint16 blob slide through ``TiffWriter.write_pyramid`` (zstd, 256^2
    tiles), then ``cli.main --usePyramid --scalingFactor 0.5`` (the stored
    4096^2 level, K1 and K2 counted) byte-equal to ``--scalingFactor 1``
    on the level plane as a plain TIFF brought back with ``upscale_pm``,
    beside the full-resolution ``--scalingFactor 0.5 --engine whole`` run;
    a 4096^2 zstd1 hi-lo mosaic CZI (``--channelName``) and a two-component
    ND2 through the whole engine and an 8192^2 CZI through ``--engine
    auto`` (streamed), each byte-equal to the same pixels as a TIFF, with
    each read's MB/s; ``--pyramidOutput --compressOutput zstd`` read back
    and the write seconds per codec; the server in threads (a CZI body,
    ``usePyramid=1&scale=0.5``, ``compress=zstd&pyramid=1``); and a model
    directory whose only bundle is ``nuclei20x2bin1chan`` (16 wide, its
    ``hp.data`` saying 20) through ``cli.main``, card against CPU; the
    launch counters set to 0 before each counted path and read after;
14. after phase 17, print the ``{"kernels": [...]}`` line (K3/K4a/K4b
    with their launches and event ms across processes, K1 and K2 with
    ``launches_formats``, ``launches_slice12``, ``launches_slice13`` and
    ``launches_slice15``, their launches on each path of phases 13, 15,
    16 and 17), the card's name and power limit, and the ``{"ok": true,
    ...}`` line last;
15. the native TIFF codec, the forward's CUDA graphs and space-to-depth
    (the legacy net at nucleiDAPI's widths, seeded weights): the port's
    C++ codec must load (built here by g++); a seeded 4096^2 uint16 blob
    slide written as LZW predictor-2 strips (this script's own encoder, in
    spawned processes; 2048^2 if it would take over 20 s) read natively
    and its first band through the Python codec (MB/s each), then
    ``cli.main`` on it, pages byte-equal to the same pixels uncompressed;
    the three maps written as deflate pyramids by the native encoder and
    by zlib (seconds each); ``cli.main`` twice in each of two fresh
    processes, on the card's default path and eagerly (seconds, and no
    capture); three servers (float32, bfloat16, int8) answering one
    slide three times each and pans on the card-resident slide, on the
    default path and eagerly: tile batches, reserved memory and the graph
    pool, every answer equal; ``spatial_infer`` twice in a row (no
    capture); ``infer_slide`` at 4096^2 in float32 and bfloat16, a
    1024^2 pan on a pinned 8192^2 plane, a 300^2 slide and
    ``StreamingEngine.infer`` at 8192^2 on graphs (a key's first request
    runs eagerly, its second captures) against the same calls eager
    (``weigh_tiles(_graphs=False)``), byte-equal, with Mpx/s both ways in
    turns, the idle share, capture seconds per key, peak and held memory
    with three keys cached, the 4096^2 slide replayed after the other
    keys; int8 calibrated on one slide then another, byte-equal to eager
    after each; ``InferenceEngine(s2d=True)`` at 4096^2 against
    the standard engine (float32 within 1 level, bfloat16 at phase 4's
    relative bar), Mpx/s both ways, and level 0's convolutions at a
    256-tile chunk by the profiler, packed against standard; K1 and K2
    counted on each path;
16. the CZI JPEG decoder (M16), the toolbox (M14e) and the 3D tiler
    (M14f): the committed JPEG fixtures (``tests/fixtures/torch_jpeg``,
    PIL's decode beside each) decoded natively and in Python, coefficients
    bit-equal and pixels within 1 level of PIL's, with the native MB/s on
    a 4096^2 mosaic and the Python MB/s on one 512^2 tile; Gray8 CZIs of
    512^2 JPEG sub-blocks (baseline with restart markers, progressive,
    baseline, optimized tables) at 4096^2 through ``cli.main`` and 8192^2
    through ``--engine auto`` (streamed), pages byte-equal to the decoded
    pixels as a plain TIFF, K1 and K2 counted; ``imfeatures`` (23
    features) of a seeded 1024^2 plane on the card against scipy on the
    host (filter planes at rtol 1e-10, atol 1e-12, local percentiles
    bit-equal), its seconds at 2048^2 and ``imfeatures3`` at 128^3, and
    ``imread`` of a Paeth-filtered 2048^2 RGB PNG, native and (64 rows)
    Python; the 3D
    tiler's round trip of a seeded 128x512x512 float32 volume (patch 64,
    margin 8) within 1e-5, with its time and peak memory.
17. the TIFF pages the JAX package reads through PIL (M17, first part;
    the legacy net at nucleiDAPI's widths, seeded weights): two 4096^2
    gray JPEG TIFFs of 512^2 tiles from the committed fixture streams,
    written here without PIL (a JPEGTables tag and abbreviated tiles, and
    complete streams), and a 4096^2 float32 deflate TIFF with the
    floating-point predictor (numpy and zlib), each decoded twice (MB/s)
    and run through ``cli.main``, pages byte-equal to the same pixels as a
    plain TIFF, K1 and K2 counted; an 8192^2 JPEG TIFF under ``--engine
    auto`` with the net at one level, on the whole engine (K2's slide
    epilogue once, its stripe entry never: the streamed probe refuses
    such pages, as in JAX), and ``--engine streaming`` refusing it.
18. the rest of the TIFF pages (M17, second part; ``phase_slice16``):
    Group 4, 12-bit LZW and PNG-as-TIFF 4096^2 slides through
    ``cli.main``, byte-equal to their plain twins, and the committed
    bilevel, old-style JPEG, colour and planar fixtures;
19. the last TIFF pages, the toolbox's formats and F5 (M17, third part;
    ``phase_slice17``, the legacy net at nucleiDAPI's widths, seeded
    weights): a 4096^2 gray old-style JPEG slide in the table form and a
    4096^2 4-bit palette slide through ``cli.main``, each byte-equal to
    its pixels as a plain TIFF, K1 and one K2 epilogue counted, with the
    decode seconds; every committed fixture of
    ``tests/fixtures/torch_tiff_pages`` and ``torch_image_formats`` equal
    to PIL's read, ``imtools.imwrite`` of each dtype read back to PIL's
    read; ``imgaussfilt``, ``imgradmag`` and ``imderivatives`` of a bool
    image on the card byte-equal to scipy's;
20. GIF, JPEG write and lossless JPEG (M17, fourth part;
    ``phase_slice18``, the same net): a 4096^2 two-frame GIF under a
    ``.tif`` name (frame 0 with every gray level, written by the port's
    GIF writer) through ``cli.main`` at channels 1 and 2, and a 4096^2
    lossless (SOF3, predictor 1) JPEG under a ``.tif`` name, each
    byte-equal to its pixels as a plain TIFF, K1 and one K2 epilogue
    counted, with the decode seconds; a palette GIF's RGB frame refused
    with ``ValueError``; ``imtools.imwrite`` of the 4096^2 class map as
    ``.gif`` and ``.jpg`` with seconds; every committed fixture of
    ``tests/fixtures/torch_gif`` and ``torch_jpeg_write`` read equal to
    PIL's read and written byte-equal to PIL's file;
21. MPO, arithmetic JPEG and Netpbm (M17, fifth part; ``phase_slice19``,
    the same net): a 4096^2 gray SOF9 JPEG under a ``.tif`` name (coded by
    the test-side encoder of ``tests/fixtures/torch_jpeg_arith/make.py``
    from the coefficients of the port's baseline JPEG of a flat slide
    with 350 nuclei, its scan within the 64 KiB PIL reads at once), a
    4096^2 gray 3-frame MPO under a ``.tif`` name at ``--channel 2``
    (frame 1) and a 4096^2 P5 PGM at maxval 65535 under a ``.tif`` name
    through ``cli.main``, each byte-equal to its pixels as a plain TIFF
    (int32 for the PGM, as PIL reads it), K1 and one K2 epilogue counted,
    with the encode and decode seconds; the entropy decode alone of the
    SOF9 stream beside the Huffman one of the same coefficients, and the
    SOF9 stream behind a 40000-byte APP15 segment under a ``.tif`` name
    refused with ``ValueError`` (PIL's 64 KiB read); every committed
    fixture of
    ``tests/fixtures/torch_jpeg_arith``, ``torch_mpo`` and ``torch_pnm``
    read equal to PIL's read and written byte-equal to PIL's file;
22. TGA, SGI, PCX, DCX and GIF frames past the logical screen (M17,
    sixth part, and the F7 repair; ``phase_slice20``, the same net): one
    seeded 4096^2 slide with nuclei and its plain TIFF twin against a
    gray PCX (the port's writer), a gray RLE TGA (type 11, bottom-up), a
    2-byte RLE SGI (read as its high bytes), a 3-frame DCX at
    ``--channel 2`` and a GIF at ``--channel 2`` whose frame 1 grows
    the screen, each under a ``.tif`` name through ``cli.main``, pages
    byte-equal to the twin's, K1 and one K2 epilogue counted, with the
    build, read and native RLE decode seconds; every committed fixture of
    ``tests/fixtures/torch_rle`` read equal to PIL's read and written
    byte-equal to PIL's file.
23. The toolbox's remaining PIL writes and their reads (M17, seventh
    part; ``phase_slice21``, the same net): one seeded 4096^2 slide and
    its plain TIFF twins (uint8 and uint16) against an IM (``I;16``) of
    the uint16 plane, a DIB and an uncompressed DDS of the uint8 plane,
    and an RGB GIF of the twin's three uint8 maps stacked as RGB (the
    port's median cut; its twin a TIFF of the index plane the port's
    GIF reader gives), each under a ``.tif`` name through ``cli.main``,
    pages byte-equal to the twin's, K1 and one K2 epilogue counted; an
    RGBA GIF (the fast octree), a QOI, an XBM and an MSP written and read
    back equal to their input; the median cut's and the octree's seconds
    at 4096^2; every committed fixture of ``tests/fixtures/torch_write``
    written byte-equal to PIL's file (APNG: read equal, the port's
    deflate is its own) and read equal to PIL's read.
24. JPEG 2000 read (M17, eighth part; ``phase_slice22``, the same net):
    the two committed 4096^2 slides of ``tests/fixtures/torch_j2k`` (a
    lossy JP2 at ``irreversible=True, quality_layers=[40]`` in 1024^2
    tiles, a lossless 5/3 J2K), each decoded by the port on the native
    library to PIL's sha256, with the tier 2, tier 1 and wavelet seconds
    and ``read_channel``'s, then under a ``.tif`` name through
    ``cli.main`` against a plain TIFF twin of its pixels, pages
    byte-equal, K1 and one K2 epilogue counted; every small fixture there
    read equal to PIL's committed read.
25. The raster plugins PIL decodes itself (M17, ninth part;
    ``phase_slice23``, the same net): three 4096^2 files written from a
    seed by ``tests/fixtures/torch_rasters/make.py``'s ``slide_files``
    (a big-endian float32 SPIDER stack of 3, a 16-bit FITS, a gray
    PackBits PSD with two layers), each file and each read held to the
    sha256 ``slides.json`` records from PIL, then under a ``.tif`` name
    through ``cli.main`` against a plain TIFF twin of the read: the
    SPIDER stack at ``--channel 2`` (``seek(1)``, its second image, on
    the host float path: K2's float32 epilogue), the FITS at ``--channel
    1``, the PSD at ``--channel 2`` (``seek(1)``, the composite) and
    ``--channel 3`` (``seek(2)``, PIL's second layer); pages byte-equal
    to the twin's, K1 and one K2 epilogue counted on each; the PSD's
    channel 0 refused as the JAX CLI refuses it (``IndexError``); every
    small fixture there read as PIL's committed read or exception.
26. Icons, animations and textures (M17, tenth part; ``phase_slice24``,
    the same net): ``tests/fixtures/torch_icons/make.py``'s
    ``slide_files`` writes from a seed 4096^2 DDS files in BC1, BC7, BC6H
    and BC4, a BLP2 DXT5, an FTEX DXT1 and a two-frame FLC, a 1024^2
    ICNS ``ic10`` PNG and 256^2 ICOs (a 24-bit BMP with its AND mask, a
    gray PNG); each file and each read held to the sha256 ``slides.json``
    records from PIL and read again through ``read_channel`` under a
    ``.tif`` name; the one-plane reads (the FLC at ``--channel 1`` and
    ``2``, the BC4 DDS, the gray ICO) through ``cli.main`` against a
    plain TIFF twin, pages byte-equal, K1 and one K2 epilogue counted on
    each; a colour read refused by ``cli.main`` as by the JAX CLI
    (``ValueError``: both take one-plane reads only); every small fixture
    there read as PIL's committed read or exception (an EPS file's frame
    0 refused naming M17: PIL needs Ghostscript).
27. The toolbox's ICO, ICNS and PDF writes (M17, eleventh part;
    ``phase_slice25``, the same net): ``tests/fixtures/torch_write25/
    make.py``'s seeded 4096^2 uint8, bool, RGBA and uint16 planes through
    ``imtools.imwrite`` to ``.ico``, ``.icns`` and ``.pdf`` (Pillow's
    resampler, the port's PNG, JPEG and Group 4 encoders), each ICO's and
    ICNS's skeleton and entry pixels and each PDF (its date fixed) held
    to the sha256 ``writes.json`` records from PIL; the RGBA PDF refused
    naming M17, the uint16 PDF with PIL's ``ValueError``; the resampler's
    native passes equal to its numpy ones at 4096^2, the G4 encode's
    seconds and round trip; ``cli.main`` on the uint8 plane, its nuclei
    map written as an ICO, and that ICO under a ``.tif`` name (its 256^2
    entry) through ``cli.main`` against a plain TIFF twin, pages
    byte-equal, K1 8 and one K2 epilogue on the slide, K1 1 and one K2
    epilogue on the entry and its twin.  The ``kernels`` line gives each
    path's launches under ``launches_slice16`` to ``launches_slice25``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import struct
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


_CARD = []


def card_label() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    if not _CARD:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        _CARD.append(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
                     else f"nvidia-smi unavailable (rc {smi.returncode})")
    return _CARD[0]


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
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if any(n in e.name for e in events for n in names):
            break
        # a session may come back without the kernels' events (CUPTI
        # dropped them, all of them or all but a few others); the kernels
        # still ran (their counters say so), so profile again rather than
        # read "no launches".  Every caller names a kernel its call runs.
        log(f"[profile] the profiler saw none of {names} in "
            f"{len(events)} device events; profiling again")
    out = {}
    for n in names:
        us = [e.time_range.elapsed_us() for e in events if n in e.name]
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


def blob_slide(rng, h: int, w: int, n_blobs: int, background=None):
    """The tests/test_demo_model.py blob recipe at a larger size; on a
    flat ``background`` level in place of its noise where one is given."""
    import numpy as np

    img = (rng.rand(h, w).astype(np.float32) * 0.15 if background is None
           else np.full((h, w), background, np.float32))
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

    # K2 (c): the same epilogue with float32 maps, the host float path's
    # mode (InferenceEngine.infer)
    f = kernels.blend_fold_epilogue(weighted, window, grid, quantize=False)
    f_plain = kernels.blend_fold_epilogue_plain(weighted, window, grid,
                                                quantize=False)
    torch.cuda.synchronize()
    err2f = (f - f_plain).abs().max().item()
    log(f"[K2f] maps {tuple(f.shape)} float32: max |kernel - plain| "
        f"{err2f:.3e} (atol 1e-5)")
    check(f.dtype == torch.float32 and err2f <= 1e-5,
          f"K2's float32 epilogue disagrees with its plain version: {err2f}")
    del f, f_plain
    f32_fn = lambda: kernels.blend_fold_epilogue(  # noqa: E731
        weighted, window, grid, quantize=False)
    k2f_ms = cuda_ms(f32_fn)
    k2f_dev_ms = fold_device_ms(f32_fn, "K2 float32 slide epilogue")
    no_sync(f32_fn, "K2 float32 slide epilogue")
    k2f_plain_ms = cuda_ms(lambda: kernels.blend_fold_epilogue_plain(
        weighted, window, grid, quantize=False), iters=3)
    # F.fold of the tiles and of the window (the blend count), then divide
    ones_cols = window.reshape(1, p * p, 1).expand(1, p * p, t).contiguous()
    count = F.fold(ones_cols, size, p, stride=grid.sub)
    k2f_lib_ms = cuda_ms(lambda: F.fold(cols, size, p, stride=grid.sub)
                         / count)
    del ones_cols, count
    # elements of the tiles that land inside the cropped slide
    def covered(n_tiles):
        m, sub = grid.margin, grid.sub
        return sum(max(0, min(p, m + SLIDE - i * sub) - max(0, m - i * sub))
                   for i in range(n_tiles))
    n_read = covered(grid.npr) * covered(grid.npc) * k
    n_out = k * SLIDE * SLIDE
    k2_bound, k2_by = bound_ms(4 * n_read + 4 * p * p + n_out,
                               4 * n_read + 7 * n_out)
    k2f_bound, k2f_by = bound_ms(4 * n_read + 4 * p * p + 4 * n_out,
                                 4 * n_read + 7 * n_out)
    for name, ms, pl, lib, bd in [
        ("K1", k1_ms, k1_plain_ms, k1_lib_ms, k1_bound),
        ("K2b", k2_ms, k2_plain_ms, k2_lib_ms, k2_bound),
        ("K2f", k2f_ms, k2f_plain_ms, k2f_lib_ms, k2f_bound),
    ]:
        log(f"[{name}] kernel {ms:.4f} ms | plain {pl:.4f} ms | library "
            f"{lib:.4f} ms | bound {bd:.4f} ms")
    for name, dev_ms, ms, bd in [("K2b", k2_dev_ms, k2_ms, k2_bound),
                                 ("K2f", k2f_dev_ms, k2f_ms, k2f_bound)]:
        log(f"[{name}] device time per launch (profiler) {dev_ms:.4f} ms, "
            f"events {ms:.4f} ms, {dev_ms / bd:.2f}x the bound")
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
        "blend_fold_epilogue_f32": dict(
            route="cuda", source="unmicst_tpu_torch/csrc/blend_fold.cu",
            replaces="exhibits/pallas/blend.py:76", max_abs_err=err2f,
            ms=k2f_ms, plain_ms=k2f_plain_ms, bound_ms=k2f_bound,
            bound_by=k2f_by, library_ms=k2f_lib_ms),
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
    # tile adds to an eager call's peak (256 against 128 tiles per
    # forward; on the forward's CUDA graphs that memory is the graph
    # pool's, taken at the capture)
    half = InferenceEngine(hp, state, "legacy", LEGACY_MEAN, LEGACY_STD,
                           tile_batch=f32.tile_batch // 2, device=dev)
    with eager_forward():
        half.infer_slide(raw)  # cuDNN's autotune workspaces out of the peak
        per_tile = (peak(f32) - peak(half)) / (f32.tile_batch
                                               - half.tile_batch)
    log(f"[legacy] peak memory per tile {per_tile / 2**20:.3f} MiB "
        f"measured, tile_bytes estimate {tile_bytes(hp) / 2**20:.3f} MiB "
        f"({tile_bytes(hp) / per_tile:.2f}x)")
    check(tile_bytes(hp) >= per_tile,
          "tile_bytes underestimates the memory one tile takes")
    del half
    profile_slide(lambda: f32.infer_slide(raw), "float32")
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
    profile_slide(lambda: bf16.infer_slide(raw), "bfloat16")

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


def profile_slide(run, label: str) -> None:
    """Where one slide's device time goes: torch.profiler over one call of
    ``run`` (a whole-slide call), device kernels summed by name, and the
    device's busy and idle shares of the call's wall time (profiler on)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
        plan.in_rows))[None].to(dev)
    stripe_args = (rows_dev, plan, s1, np.dtype(np.uint16), True,
                   tuple(np.float32([v]) for v in lo_hi), [0, 1, 2])
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


DUO_MEAN, DUO_STD = 0.18, 0.17


def duo_hp():
    """nucleiDAPILAMIN's published hyper-parameters (SURVEY.md section
    2.4): the duo tool's net, two input channels (DNA and lamin)."""
    from unmicst_tpu_torch.core.hp import HParams

    return HParams(im_size=128, n_channels=2, n_classes=3, n_out0=36,
                   feat_maps_fact=2, down_samp_fact=2, ks=3, n_extra_convs=0,
                   std_dev0=0.03, n_layers=5, batch_size=24)


def wall(fn):
    """(result, host seconds) of ``fn()``, the card drained on both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def median_rate(fn, px: int, reps: int = 3) -> tuple:
    """(Mpx/s at the median, median seconds, every time) of ``reps`` warm
    calls of ``fn`` over ``px`` raw pixels."""
    import numpy as np

    times = [wall(fn)[1] for _ in range(reps)]
    med = float(np.median(times))
    return px / 1e6 / med, med, times


def peak_bytes(fn) -> int:
    """Peak device bytes of one ``fn()`` above what was allocated before."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def class_sum_ok(maps) -> bool:
    """uint8 class planes of a probability partition sum to 252..255."""
    import numpy as np

    total = maps.astype(np.int32).sum(axis=0)
    return bool(total.max() <= 255 and total.min() >= 252)


def duo_model_dir(root: str) -> str:
    """A nucleiDAPILAMIN model directory for the CLI: the oracle_duo TF1
    weights (tests/fixtures) through :func:`write_model_dir`."""
    from unmicst_tpu_torch.core.checkpoint import load_tf1_params
    from unmicst_tpu_torch.core.hp import HParams

    fixture = os.path.join(ROOT, "tests", "fixtures", "oracle_duo")
    with open(os.path.join(fixture, "hp.json")) as f:
        hp = HParams.from_ref_dict(json.load(f))
    state = load_tf1_params(os.path.join(fixture, "model.ckpt"), hp, "v2")
    return write_model_dir(root, "nucleiDAPILAMIN", hp, state, "v2",
                           DUO_MEAN, DUO_STD)


def phase_duo_scale(dev) -> None:
    """The duo tool's net and --scalingFactor on the card: the whole
    engine, the stack and resampled streams, and the CLI."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.core import tiler
    from unmicst_tpu_torch.infer import InferenceEngine
    from unmicst_tpu_torch.io import preprocess as pp
    from unmicst_tpu_torch.io.tiff import TiffFile, TiffWriter, imread, num_pages
    from unmicst_tpu_torch.runtime.mesh import make_mesh
    from unmicst_tpu_torch.runtime.pipeline import StreamingEngine, _to_torch

    card = card_label()
    t_phase = time.perf_counter()

    def seeded_planes(side, seed):
        g = torch.Generator().manual_seed(seed)
        return [torch.randint(0, top, (side, side), generator=g,
                              dtype=torch.int32).numpy().astype(np.uint16)
                for top in (65536, 30000)]

    def launched(counts):
        return {k: v for k, v in counts.items() if v}

    # -- the duo net on the whole engine, 4096^2 --------------------------------
    hp = duo_hp()
    state = seeded_state(hp, "v2", SEED)
    planes = seeded_planes(SLIDE, SEED + 4)
    px = SLIDE * SLIDE
    f32 = InferenceEngine(hp, state, "v2", DUO_MEAN, DUO_STD, device=dev)
    _, first = wall(lambda: f32.infer_slide_stack(planes))
    kernels.reset_launch_counts()
    maps = f32.infer_slide_stack(planes)
    duo_launches = kernels.launch_counts()
    log(f"[duo] float32 first call {first:.3f}s (cuDNN autotune included), "
        f"tile batch {f32.tile_batch}; launches of one 4096^2 call "
        f"{launched(duo_launches)}")
    check(maps.shape == (3, SLIDE, SLIDE) and maps.dtype == np.uint8,
          f"duo maps {maps.shape} {maps.dtype}")
    check(duo_launches["softmax_blend"] > 0
          and duo_launches["blend_fold_epilogue"] == 1,
          f"the duo slide did not run K1 and K2: {duo_launches}")
    check(class_sum_ok(maps), "duo class planes do not sum to ~255")
    mpx, med, times = median_rate(lambda: f32.infer_slide_stack(planes), px)
    pk = peak_bytes(lambda: f32.infer_slide_stack(planes))
    log(f"[duo] float32 infer_slide_stack 4096^2 x 2 channels: {mpx:.2f} "
        f"Mpx/s (median {med:.4f}s of {[round(x, 4) for x in times]}), peak "
        f"device memory {pk / 2**30:.2f} GiB [{card}]")
    profile_slide(lambda: f32.infer_slide_stack(planes),
                  f"duo float32 [{card}]")
    bf16 = InferenceEngine(hp, state, "v2", DUO_MEAN, DUO_STD,
                           compute_dtype=torch.bfloat16, device=dev)
    maps_bf = bf16.infer_slide_stack(planes)
    mpx_bf, med_bf, times_bf = median_rate(
        lambda: bf16.infer_slide_stack(planes), px)
    pk_bf = peak_bytes(lambda: bf16.infer_slide_stack(planes))
    d = np.abs(maps.astype(int) - maps_bf.astype(int))
    log(f"[duo] bfloat16 infer_slide_stack 4096^2: {mpx_bf:.2f} Mpx/s "
        f"(median {med_bf:.4f}s of {[round(x, 4) for x in times_bf]}), peak "
        f"device memory {pk_bf / 2**30:.2f} GiB; vs float32 max {d.max()} "
        f"levels, {(d > 0).mean():.3e} of pixels differ [{card}]")
    profile_slide(lambda: bf16.infer_slide_stack(planes),
                  f"duo bfloat16 [{card}]")
    del bf16, maps_bf, d
    small = [p[:256, :256] for p in planes]
    cpu = InferenceEngine(hp, state, "v2", DUO_MEAN, DUO_STD, device="cpu")
    ok, worst, share = maps_agree(f32.infer_slide_stack(small),
                                  cpu.infer_slide_stack(small), None)
    log(f"[duo] float32 card vs CPU on 256^2: max {worst} level(s), "
        f"{share:.3e} of pixels differ (bar: 1 level) [{card}]")
    check(ok, f"duo card and CPU disagree by {worst} levels")

    # -- --scalingFactor on the whole engine: the legacy net, 4096^2 ------------
    lhp = legacy_hp()
    lstate = seeded_state(lhp, "legacy", SEED)
    g = torch.Generator().manual_seed(SEED + 1)
    raw = torch.randint(0, 65536, (SLIDE, SLIDE), generator=g,
                        dtype=torch.int32).numpy().astype(np.uint16)
    eng = InferenceEngine(lhp, lstate, "legacy", LEGACY_MEAN, LEGACY_STD,
                          device=dev)
    scaled = {}
    for sf in (0.5, 0.65):
        eng.infer_slide(raw, scaling_factor=sf)  # cuDNN autotune
        kernels.reset_launch_counts()
        scaled[sf] = eng.infer_slide(raw, scaling_factor=sf)
        counts = kernels.launch_counts()
        check(scaled[sf].shape == (3, SLIDE, SLIDE)
              and counts["blend_fold_epilogue"] == 1
              and counts["softmax_blend"] > 0,
              f"scaled slide at {sf}: {scaled[sf].shape}, launches {counts}")
        mpx, med, times = median_rate(
            lambda: eng.infer_slide(raw, scaling_factor=sf), px)
        pk = peak_bytes(lambda: eng.infer_slide(raw, scaling_factor=sf))
        side = int(SLIDE * sf)
        log(f"[scale] float32 infer_slide 4096^2 at scaling_factor {sf} "
            f"(net at {side}^2): {mpx:.2f} Mpx/s on raw pixels (median "
            f"{med:.4f}s of {[round(x, 4) for x in times]}), peak device "
            f"memory {pk / 2**30:.2f} GiB; launches {launched(counts)} "
            f"[{card}]")
        profile_slide(lambda: eng.infer_slide(raw, scaling_factor=sf),
                      f"scaled {sf} float32 [{card}]")
    # K2's slide epilogue on the 0.65 grid: 2662 columns, not a multiple of
    # 4, so every row ends on the scalar lanes
    side = int(SLIDE * 0.65)
    grid = tiler.make_grid(side, side, lhp.im_size, lhp.margin)
    gd = torch.Generator(device=dev).manual_seed(SEED)
    logits = 3 * torch.randn((grid.num_tiles, 3, lhp.im_size, lhp.im_size),
                             generator=gd, device=dev)
    window = torch.from_numpy(tiler.ramp_window(lhp.im_size,
                                                lhp.margin)).to(dev)
    weighted = kernels.softmax_blend(logits, window,
                                     torch.ones(grid.num_tiles, device=dev))
    k2 = kernels.blend_fold_epilogue(weighted, window, grid)
    k2_plain = kernels.blend_fold_epilogue_plain(weighted, window, grid)
    err = (k2.int() - k2_plain.int()).abs().max().item()
    log(f"[scale] K2 epilogue on the 0.65 grid {tuple(k2.shape)} ({side} % 4 "
        f"= {side % 4}): max |kernel - plain| {err} level(s) (bar: 0) "
        f"[{card}]")
    check(err == 0, f"K2 on the 0.65 grid is {err} levels from its plain "
                    "version")
    del logits, weighted, k2, k2_plain
    cpu_l = InferenceEngine(lhp, lstate, "legacy", LEGACY_MEAN, LEGACY_STD,
                            device="cpu")
    d = np.abs(eng.infer_slide(raw[:300, :300], scaling_factor=0.65)
               .astype(int) - cpu_l.infer_slide(raw[:300, :300],
                                                scaling_factor=0.65)
               .astype(int))
    log(f"[scale] float32 card vs CPU on 300^2 at 0.65: max {d.max()} "
        f"level(s), {(d > 0).mean():.3e} of pixels differ (bar: 1 level on "
        f"< 2%) [{card}]")
    check(d.max() <= 1 and (d > 0).mean() < 0.02,
          f"scaled card and CPU disagree: {d.max()} levels")

    # -- the duo streams, 8192^2 ---------------------------------------------------
    big = seeded_planes(BIG, SEED + 5)
    mpx_big = BIG * BIG / 1e6
    whole, secs = wall(lambda: f32.infer_slide_stack(big))
    log(f"[duo stream] whole engine 8192^2: {secs:.3f} s "
        f"({mpx_big / secs:.2f} Mpx/s, first call) [{card}]")
    del f32
    torch.cuda.empty_cache()
    stream = StreamingEngine(hp, state, "v2", DUO_MEAN, DUO_STD,
                             compute_dtype=None, device=dev)
    plan = stream._plan(BIG, BIG)
    kernels.reset_launch_counts()
    got, first = wall(lambda: stream.infer_stack(big))
    stack_launches = kernels.launch_counts()
    d = np.abs(got.astype(int) - whole.astype(int))
    check(d.max() <= 1, f"infer_stack disagrees with infer_slide_stack: "
                        f"{d.max()} levels")
    check(stack_launches["blend_fold_stripe"] == plan.n_stripes
          and stack_launches["softmax_blend"] > 0,
          f"infer_stack did not run K1 and K2's stripe entry: "
          f"{stack_launches}")
    _, secs = wall(lambda: stream.infer_stack(big))
    log(f"[duo stream] infer_stack 8192^2 float32: {secs:.3f} s warm "
        f"({mpx_big / secs:.2f} Mpx/s; first call {first:.3f} s), S "
        f"{plan.S}, {plan.n_stripes} stripes; vs infer_slide_stack max "
        f"{d.max()} level(s), {(d > 0).mean():.3e} of pixels differ; "
        f"launches {launched(stack_launches)} [{card}]")
    ranges = [stream.global_stats(p) for p in big]
    s1 = min(1, plan.n_stripes - 1)
    r0 = (s1 * plan.S - 1) * plan.grid.sub - plan.grid.margin
    rows = _to_torch(np.stack([stream._read_rows(p, r0, plan.in_rows)
                               for p in big])).to(dev)
    stripe_args = (rows, plan, s1, np.dtype(np.uint16), True,
                   tuple(np.float32([r[i] for r in ranges]) for i in (0, 1)),
                   [0, 1, 2])
    ref_stripe = stream._stripe(*stripe_args)
    got_stripe = no_sync(lambda: stream._stripe(*stripe_args),
                         f"StreamingEngine._stripe, duo stack (stripe {s1})")
    check((got_stripe.int() - ref_stripe.int()).abs().max().item() <= 1,
          "the stack stripe under the sync check moved")
    del rows, ref_stripe, got_stripe
    mesh = make_mesh(devices=[dev] * RANKS)
    _, first = wall(lambda: stream.infer_sharded_stack(big, mesh))
    kernels.reset_launch_counts()
    sharded, secs = wall(lambda: stream.infer_sharded_stack(big, mesh))
    sh_launches = kernels.launch_counts()
    d = np.abs(sharded.astype(int) - got.astype(int))
    log(f"[duo stream] infer_sharded_stack over {RANKS} ranks: {secs:.3f} s "
        f"warm ({mpx_big / secs:.2f} Mpx/s; first call {first:.3f} s); vs "
        f"infer_stack max {d.max()} level(s), {(d > 0).mean():.3e} of pixels "
        f"differ; launches {launched(sh_launches)} [{card}]")
    check(d.max() <= 1, f"infer_sharded_stack disagrees with infer_stack: "
                        f"{d.max()} levels")
    check(sh_launches["ring_shift"] == 2 * plan.n_stripes,
          f"the stack's seams did not run K3 once per hop: {sh_launches}")
    del big, whole, got, sharded, stream
    torch.cuda.empty_cache()

    # -- the resampled stream: ResampledSource of a 4096^2 TIFF ------------------
    lstream = StreamingEngine(lhp, lstate, "legacy", LEGACY_MEAN, LEGACY_STD,
                              compute_dtype=None, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slide.tif")
        with TiffWriter(path, bigtiff=True) as tw:
            tw.write(raw)
        with TiffFile(path) as tf:
            src = pp.ResampledSource((tf, 0), 0.5)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            maps = lstream.infer(src)
            t_stream = time.perf_counter() - t0
            rs_launches = kernels.launch_counts()
            up = np.stack([pp.upscale_pm(m, raw.shape) for m in maps])
            t_all = time.perf_counter() - t0
    d = np.abs(up.astype(int) - scaled[0.5].astype(int))
    log(f"[scale stream] infer(ResampledSource(tiff, 0.5)) 4096^2: stream "
        f"{t_stream:.3f} s ({px / 1e6 / t_stream:.2f} Mpx/s on raw pixels; "
        f"the host resize and stats included), with upscale_pm "
        f"{t_all:.3f} s; vs infer_slide(scaling_factor=0.5) max {d.max()} "
        f"level(s), {(d > 0).mean():.3e} of pixels differ (bar: 1 level on "
        f"< 2%); launches {launched(rs_launches)} [{card}]")
    check(d.max() <= 1 and (d > 0).mean() < 0.02,
          f"resampled stream disagrees: {d.max()} levels")
    check(rs_launches["blend_fold_stripe"] > 0, "no stripe ran K2")

    # -- the CLI: --tool unmicst-duo and --scalingFactor --------------------------
    rng = np.random.RandomState(SEED)
    img = blob_slide(rng, 1024, 1024, 256)
    with tempfile.TemporaryDirectory() as tmp:
        zoo = os.path.join(tmp, "zoo")
        duo_model_dir(zoo)
        src = os.path.join(tmp, "s", "registration", "duo.tif")
        os.makedirs(os.path.dirname(src))
        with TiffWriter(src, bigtiff=False) as tw:
            tw.write((np.clip(img, 0, 1) * 65535).astype(np.uint16))
            tw.write((rng.rand(1024, 1024) * 30000).astype(np.uint16))
        runs = {
            "duo": ([src, "--tool", "unmicst-duo", "--modelRoot", zoo,
                     "--channel", "1", "2"], "duo_Probabilities_1.tif"),
            "scaled": ([src, "--tool", "unmicst-legacy", "--model",
                        "blobDemo", "--modelRoot",
                        os.path.join(ROOT, "models"), "--scalingFactor",
                        "0.5"], "duo_Probabilities_1.tif"),
        }
        for name, (argv, prob) in runs.items():
            out = os.path.join(tmp, "out_" + name)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(argv + ["--outputPath", out, "--stackOutput"])
            secs = time.perf_counter() - t0
            counts = kernels.launch_counts()
            prob_path = os.path.join(out, prob)
            preview = os.path.join(out, "qc", "duo_Preview_1.tif")
            check(rc == 0 and num_pages(prob_path) == 3
                  and num_pages(preview) == 2,
                  f"CLI {name}: rc {rc} or missing pages")
            pages = [imread(prob_path, k) for k in range(3)]
            check(all(p.shape == (1024, 1024) for p in pages),
                  f"CLI {name}: pages {[p.shape for p in pages]}")
            check(counts["softmax_blend"] > 0
                  and counts["blend_fold_epilogue"] > 0,
                  f"CLI {name} did not run both kernels: {counts}")
            log(f"[cli] {' '.join(argv[1:])}: {secs:.2f} s, 3 probability "
                f"pages and the 2-page preview of 1024^2, launches "
                f"{launched(counts)} [{card}]")
    log(f"[duo and scale] phase {time.perf_counter() - t_phase:.1f}s")


def write_model_dir(root: str, name: str, hp, state, variant: str,
                    mean: float, std: float) -> str:
    """A model directory of ``state`` as the reference ships one: a TF1
    bundle written by ``save_tf1_params`` and the pickled sidecars
    (``toolbox/ftools.py:32-35``)."""
    from unmicst_tpu_torch.core.checkpoint import save_tf1_params
    from unmicst_tpu_torch.core.hp import save_pickle

    d = os.path.join(root, name)
    os.makedirs(d)
    save_tf1_params(os.path.join(d, "model.ckpt"), state, hp, variant)
    for fname, obj in (("hp.data", hp.to_ref_dict()),
                       ("datasetMean.data", mean),
                       ("datasetStDev.data", std)):
        save_pickle(obj, os.path.join(d, fname))
    return d


def start_sweep_process(argv) -> tuple:
    """``python -m unmicst_tpu_torch.batch ... --stats`` started in a
    child process: (the process, its start time)."""
    return subprocess.Popen(
        [sys.executable, "-m", "unmicst_tpu_torch.batch", *argv, "--stats"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True), time.perf_counter()


def finish_sweep_process(started, label: str) -> tuple:
    """Wait for a :func:`start_sweep_process` child (killed if it outlasts
    600 s): (exit code, its --stats record, wall seconds)."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    secs = time.perf_counter() - t0
    for line in out.splitlines():
        if line.startswith("[sweep"):
            log(f"[sweep] {label}: {line}")
    records = [line for line in out.splitlines() if line.startswith("{")]
    check(records, f"sweep {label}: no --stats record (rc {proc.returncode})"
                   f"\n{out[-3000:]}\n{err[-3000:]}")
    return proc.returncode, json.loads(records[-1]), secs


def run_sweep_process(argv, label: str) -> tuple:
    """:func:`start_sweep_process`, then :func:`finish_sweep_process`."""
    return finish_sweep_process(start_sweep_process(argv), label)


def phase_sweep(dev) -> int:
    """The batch entry point and the CLI's host float path at full width;
    returns the launches of K2's float32 epilogue on the host path's
    4096^2 int16 slide."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.core.checkpoint import (load_params_for_bundle,
                                                   save_tf1_params)
    from unmicst_tpu_torch.core.hp import load_model_dir
    from unmicst_tpu_torch.infer import InferenceEngine
    from unmicst_tpu_torch.io import preprocess as pp
    from unmicst_tpu_torch.io.tiff import TiffWriter, imread, num_pages
    from unmicst_tpu_torch.runtime.pipeline import StreamingEngine

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the sweep's child processes share the card
    hp, state = legacy_hp(), seeded_state(legacy_hp(), "legacy", SEED)
    mpx = SLIDE * SLIDE / 1e6

    def plane(side, seed, lo=0, hi=65536, dtype=np.uint16):
        g = torch.Generator().manual_seed(seed)
        return torch.randint(lo, hi, (side, side), generator=g,
                             dtype=torch.int32).numpy().astype(dtype)

    def tiff(path, planes):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with TiffWriter(path, bigtiff=True) as tw:
            for p in planes:
                tw.write(p)
        return path

    def levels(a, b):
        d = np.abs(a.astype(int) - b.astype(int))
        return int(d.max()), float((d > 0).mean())

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    try:
        # -- the model directory, through the TF1 writer ---------------------
        zoo = os.path.join(tmp, "zoo")
        t0 = time.perf_counter()
        mdir = write_model_dir(zoo, "nucleiDAPI", hp, state, "legacy",
                               LEGACY_MEAN, LEGACY_STD)
        back = load_params_for_bundle(load_model_dir(mdir))
        same = sorted(back) == sorted(state) and all(
            torch.equal(back[k], state[k].float()) for k in state)
        log(f"[sweep] nucleiDAPI model dir (save_tf1_params, "
            f"{sum(v.numel() for v in state.values())} weights) written and "
            f"read back in {time.perf_counter() - t0:.2f} s: bit-equal "
            f"{same}")
        check(same, "load_params_for_bundle did not give back the tensors "
                    "save_tf1_params wrote")

        # -- the sweep root --------------------------------------------------
        root = os.path.join(tmp, "sweep")
        reg = os.path.join(root, "exemplar-001", "registration")
        whole = {os.path.join(reg, f"slide{i}.ome.tif"): plane(SLIDE, 60 + i)
                 for i in range(2)}
        for path, raw in whole.items():
            tiff(path, [raw])
        big_raw = plane(BIG, 62)
        big = tiff(os.path.join(root, "exemplar-002", "registration",
                                "big.ome.tif"), [big_raw])
        bad = os.path.join(root, "exemplar-003", "registration",
                           "bad.ome.tif")
        os.makedirs(os.path.dirname(bad))
        first = next(iter(whole))
        with open(first, "rb") as f:
            head = f.read(os.path.getsize(first) // 2)
        with open(bad, "wb") as f:
            f.write(head)  # truncated: the strips run past the file's end
        argv = [root, "--model", "nucleiDAPI", "--modelRoot", zoo]

        # run 1: two whole slides, one streamed, one failure
        rc, rec, secs = run_sweep_process(argv, "run 1")
        launches = rec["launches"]
        stream = StreamingEngine(hp, state, "legacy", LEGACY_MEAN,
                                 LEGACY_STD, compute_dtype=None, device=dev)
        plan = stream._plan(BIG, BIG)
        good = sorted(list(whole) + [big])
        log(f"[sweep] run 1: rc {rc}, {len(rec['completed'])} completed, "
            f"failed {rec['failed']}, {rec['mpx_total']:.2f} Mpx in "
            f"{rec['wall_s']:.3f} s of sweep "
            f"({rec['mpx_total'] / rec['wall_s']:.2f} Mpx/s, reads and "
            f"writes included; process {secs:.2f} s); "
            f"launches { {k: v for k, v in launches.items() if v} } [{card}]")
        check(rc == 2 and rec["failed"] == [bad]
              and sorted(rec["completed"]) == good,
              f"sweep run 1: rc {rc}, failed {rec['failed']}, completed "
              f"{rec['completed']}")
        check(launches["blend_fold_epilogue"] == len(whole)
              and launches["blend_fold_stripe"] == plan.n_stripes
              and launches["softmax_blend"] > 0,
              f"sweep run 1 did not run K1, K2's slide epilogue per whole "
              f"slide and its stripe entry per stripe: {launches}")

        # each page against the engines in this process
        engine = InferenceEngine(hp, state, "legacy", LEGACY_MEAN, LEGACY_STD,
                                 device=dev)
        outs = {}
        for path, raw in list(whole.items()) + [(big, big_raw)]:
            if path == big:
                maps, bare = wall(lambda: stream.infer(raw, classes=(1, 2)))
                maps, bare = wall(lambda: stream.infer(raw, classes=(1, 2)))
            else:
                engine.infer_slide(raw, classes=(1, 2))  # cuDNN autotune
                maps, bare = wall(lambda: engine.infer_slide(raw,
                                                             classes=(1, 2)))
            out = os.path.join(os.path.dirname(os.path.dirname(path)),
                               "prob_maps")
            stem = os.path.basename(path).split(".")[0]
            cfile = os.path.join(out, f"{stem}_ContoursPM_1.tif")
            nfile = os.path.join(out, f"{stem}_NucleiPM_1.tif")
            check(num_pages(cfile) == 2 and num_pages(nfile) == 1,
                  f"{stem}: ContoursPM {num_pages(cfile)} pages, NucleiPM "
                  f"{num_pages(nfile)}")
            dc = levels(imread(cfile, 0), maps[0])
            dn = levels(imread(nfile, 0), maps[1])
            dp = levels(imread(cfile, 1), pp.preview_u8_from_raw(raw))
            total, inf = rec["seconds"][path], rec["infer_seconds"][path]
            extra = "cuDNN autotune" + (", and the stats pass"
                                        if path == big else "")
            log(f"[sweep] {stem}: {total:.3f} s in the sweep, of which "
                f"infer {inf:.3f} s and TIFF read, preview and writes "
                f"{total - inf:.3f} s; the warm bare "
                f"{'stream' if path == big else 'infer_slide'} here "
                f"{bare:.3f} s (the sweep's infer over it: the child's "
                f"first call per shape: {extra}); "
                f"vs this process: contours {dc[0]} level(s) on "
                f"{dc[1]:.3e}, nuclei {dn[0]} on {dn[1]:.3e}, preview "
                f"{dp[0]} [{card}]")
            # the stream's preview takes a float32 table, the whole
            # engine's float64 (as in the JAX package): 1 level apart at most
            check(dc[0] <= 1 and dn[0] <= 1
                  and dp[0] <= (1 if path == big else 0),
                  f"{stem}: sweep pages differ from the engine's: {dc} {dn} "
                  f"{dp}")
            outs[path] = (imread(cfile, 0), imread(nfile, 0))
        del engine

        # run 2: everything done is skipped; K1 never launches.  It and
        # run 3 read different roots: they run side by side (ROADMAP T1)
        resume = start_sweep_process(argv)
        root_big = os.path.join(tmp, "sweep_big")
        big_link = os.path.join(root_big, "exemplar-002", "registration",
                                "big.ome.tif")
        os.makedirs(os.path.dirname(big_link))
        os.link(big, big_link)
        children = [resume]
        try:
            # run 3: the 8192^2 slide, --engine sharded on 4 ranks of the
            # card
            children.append(start_sweep_process(
                [root_big, "--model", "nucleiDAPI", "--modelRoot", zoo,
                 "--engine", "sharded", "--meshShape", str(RANKS)]))
            rc, rec, secs = finish_sweep_process(resume, "run 2")
            log(f"[sweep] run 2 (resume, beside run 3): rc {rc}, skipped "
                f"{len(rec['skipped'])}, failed {rec['failed']}, launches "
                f"{ {k: v for k, v in rec['launches'].items() if v} }, "
                f"process {secs:.2f} s")
            check(rc == 2 and sorted(rec["skipped"]) == good
                  and not rec["completed"] and rec["failed"] == [bad]
                  and rec["launches"]["softmax_blend"] == 0,
                  f"sweep run 2 did not skip the finished slides: {rec}")
            rc, rec, secs = finish_sweep_process(children[1], "run 3")
        finally:
            for proc, _ in children:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        out = os.path.join(root_big, "exemplar-002", "prob_maps")
        dc = levels(imread(os.path.join(out, "big_ContoursPM_1.tif")),
                    outs[big][0])
        dn = levels(imread(os.path.join(out, "big_NucleiPM_1.tif")),
                    outs[big][1])
        log(f"[sweep] run 3 (--engine sharded --meshShape {RANKS}, beside "
            f"run 2): rc {rc}, "
            f"{BIG * BIG / 1e6 / rec['wall_s']:.2f} Mpx/s of sweep; vs the "
            f"one-rank stream contours {dc[0]} level(s), nuclei {dn[0]}; "
            f"launches { {k: v for k, v in rec['launches'].items() if v} } "
            f"[{card}]")
        check(rc == 0 and rec["completed"] == [big_link]
              and dc[0] <= 1 and dn[0] <= 1,
              f"sharded sweep: rc {rc}, {rec['completed']}, {dc} {dn}")
        check(rec["launches"]["ring_shift"] == 2 * plan.n_stripes,
              f"sharded sweep: expected {2 * plan.n_stripes} K3 launches "
              f"(two seams per stripe): {rec['launches']}")
        del stream, outs
        shutil.rmtree(root)
        shutil.rmtree(root_big)
        torch.cuda.empty_cache()

        # -- the host float path through cli.main ----------------------------
        dhp = duo_hp()
        dstate = seeded_state(dhp, "v2", SEED)
        t0 = time.perf_counter()
        write_model_dir(zoo, "nucleiDAPILAMIN", dhp, dstate, "v2", DUO_MEAN,
                        DUO_STD)
        log(f"[host] nucleiDAPILAMIN model dir "
            f"({sum(v.numel() for v in dstate.values())} weights) written in "
            f"{time.perf_counter() - t0:.2f} s")
        u16 = plane(SLIDE, 70, 0, 30000)
        i16 = (u16.astype(np.int32) - 2000).astype(np.int16)
        u8 = plane(SLIDE, 71, 0, 256, np.uint8)
        d16 = plane(SLIDE, 72)
        inputs = {
            "legacy int16": (["--tool", "unmicst-legacy", "--model",
                              "nucleiDAPI"], [i16]),
            "legacy uint16": (["--tool", "unmicst-legacy", "--model",
                               "nucleiDAPI"], [u16]),
            "duo uint8+uint16": (["--tool", "unmicst-duo", "--channel", "1",
                                  "2"], [u8, d16]),
            "duo uint16": (["--tool", "unmicst-duo", "--channel", "1", "2"],
                           [u8.astype(np.uint16) * 257, d16]),
        }
        f32_launches = None
        for name, (flags, planes) in inputs.items():
            src = tiff(os.path.join(tmp, name.replace(" ", "_"),
                                    "registration", "s.tif"), planes)
            argv = [src, "--modelRoot", zoo, "--stackOutput", *flags]
            out = os.path.join(tmp, "out_" + name.replace(" ", "_"))
            if "uint16" not in name or "+" in name:
                cli.main(argv + ["--outputPath", out])  # the net's autotune
            kernels.reset_launch_counts()
            _, secs = wall(lambda: cli.main(argv + ["--outputPath", out]))
            counts = kernels.launch_counts()
            host = name == "legacy int16" or "+" in name
            if name == "legacy int16":
                f32_launches = counts["blend_fold_epilogue"]
            log(f"[host] cli.main {name} {SLIDE}^2 "
                f"({'host float path' if host else 'on-card path'}): "
                f"{secs:.3f} s end to end, {mpx / secs:.2f} Mpx/s; launches "
                f"{ {k: v for k, v in counts.items() if v} } [{card}]")
            check(counts["blend_fold_epilogue"] == 1
                  and counts["softmax_blend"] > 0,
                  f"{name}: expected K1 and one K2 epilogue: {counts}")
            pages = [imread(os.path.join(out, "s_Probabilities_1.tif"), k)
                     for k in range(3)]
            check(all(p.shape == (SLIDE, SLIDE) for p in pages)
                  and class_sum_ok(np.stack(pages)),
                  f"{name}: pages {[p.shape for p in pages]} or class sum")
        # where the host path's time goes: the legacy int16 slide
        bundle = load_model_dir(mdir)
        engine = InferenceEngine.from_bundle(
            bundle, load_params_for_bundle(bundle), device=dev)
        pc, t_pre = wall(lambda: pp.preprocess_channel(i16, 1.0, -1))
        net = pc.net_input.astype(np.float32)
        probs, t_infer = wall(lambda: engine.infer(net))
        _, t_post = wall(lambda: [pp.postprocess_pm(probs[c], pc.raw_shape)
                                  for c in range(3)])
        x = torch.from_numpy(net)[None].to(dev)
        f_dev = engine._maps(x, None, quantize=False)
        q_dev = engine._maps(x, None, quantize=True)
        _, d2h_f = wall(lambda: f_dev.cpu())
        _, d2h_q = wall(lambda: q_dev.cpu())
        log(f"[host] int16 {SLIDE}^2 host path: preprocess_channel "
            f"{t_pre:.3f} s, engine.infer {t_infer:.3f} s (its D2H of the "
            f"float32 maps, {f_dev.numel() * 4 / 1e6:.1f} MB: {d2h_f:.4f} s; "
            f"the on-card path's uint8 maps, {q_dev.numel() / 1e6:.1f} MB: "
            f"{d2h_q:.4f} s), postprocess_pm x3 {t_post:.3f} s [{card}]")
        del f_dev, q_dev, x, probs, engine

        # card against CPU at 1024^2, --check-numerics, --trace
        small = {"legacy int16": [i16[:1024, :1024]],
                 "duo uint8+uint16": [u8[:1024, :1024], d16[:1024, :1024]]}
        for name, planes in small.items():
            src = tiff(os.path.join(tmp, "small_" + name.replace(" ", "_"),
                                    "registration", "s.tif"), planes)
            argv = [src, "--modelRoot", zoo, "--stackOutput",
                    *inputs[name][0]]
            got = {}
            for d in ("cuda", "cpu"):
                out = os.path.join(tmp, f"small_out_{d}_{name[:3]}")
                check(cli.main(argv + ["--outputPath", out], device=d) == 0,
                      f"{name} 1024^2 on {d}")
                got[d] = np.stack([imread(os.path.join(
                    out, "s_Probabilities_1.tif"), k) for k in range(3)])
            worst, share = levels(got["cuda"], got["cpu"])
            log(f"[host] {name} 1024^2 card vs CPU: max {worst} level(s), "
                f"{share:.3e} of pixels differ (bar: 1 level) [{card}]")
            check(worst <= 1, f"{name}: card and CPU {worst} levels apart")
        src = os.path.join(tmp, "small_legacy_int16", "registration", "s.tif")
        argv = [src, "--modelRoot", zoo, "--tool", "unmicst-legacy",
                "--model", "nucleiDAPI", "--outputPath",
                os.path.join(tmp, "out_checked")]
        check(cli.main(argv + ["--check-numerics"]) == 0,
              "--check-numerics failed on seeded weights")
        nan_state = {k: v.clone() for k, v in state.items()}
        nan_state["up.1.kernel2"].view(-1)[7] = float("nan")
        nan_dir = os.path.join(tmp, "zoo_nan", "nucleiDAPI")
        shutil.copytree(mdir, nan_dir)
        save_tf1_params(os.path.join(nan_dir, "model.ckpt"), nan_state, hp,
                        "legacy")
        argv_nan = argv[:2] + [os.path.dirname(nan_dir)] + argv[3:]
        try:
            cli.main(argv_nan + ["--check-numerics"])
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        log(f"[host] --check-numerics with a NaN in up.1.kernel2: "
            f"{raised!r}")
        check(raised and "up.1.kernel2" in raised,
              "--check-numerics passed a NaN weight")
        trace_dir = os.path.join(tmp, "trace")
        check(cli.main(argv + ["--trace", trace_dir]) == 0, "--trace run")
        (trace_file,) = os.listdir(trace_dir)
        with open(os.path.join(trace_dir, trace_file)) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        k1_ev = sorted(n for n in names if "softmax_blend" in n)
        k2_ev = sorted(n for n in names if "fold_region" in n)
        log(f"[host] --trace: {trace_file}, {len(names)} event names, K1 "
            f"{k1_ev[:2]}, K2 {k2_ev[:2]}")
        check(k1_ev and k2_ev, "the --trace file holds no K1 or K2 event")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[sweep and host float path] phase "
        f"{time.perf_counter() - t_phase:.1f}s")
    return f32_launches


# -- phase 9: training -----------------------------------------------------------


def v2_default_hp():
    """nucleiDAPI1-5's widths, the v2 default training configuration
    (``scripts/train_throughput_tpu.py:42-46``)."""
    from unmicst_tpu_torch.core.hp import HParams

    return HParams(im_size=64, n_channels=1, n_classes=3, n_out0=80,
                   feat_maps_fact=2, down_samp_fact=2, ks=3, n_extra_convs=0,
                   std_dev0=0.03, n_layers=4, batch_size=32)


# the FLOPs of one step of each configuration by XLA's cost analysis of
# the JAX step (README.md's training table); they count work, not time
XLA_STEP_TFLOP = {"v2 default": 0.436, "legacy flagship": 0.084}


def train_step_flops(hp, legacy: bool) -> float:
    """Analytic FLOPs of one training step of the torch UNet at batch
    ``hp.batch_size``: every convolution's forward (2 MACs per multiply-
    add; a transposed convolution counted on its input), its weight
    gradient, and its data gradient except for the two convolutions that
    read the input image (it needs none)."""
    b, s, w, ks, nx, n = (hp.batch_size, hp.im_size, hp.n_out_x, hp.ks,
                          hp.n_extra_convs, hp.n_layers)

    def conv(side, cin, cout, k):
        return 2.0 * b * side * side * cin * cout * k * k

    fwd, first = 0.0, 0.0
    for i in range(n):
        side = s >> i
        main = conv(side, w[i], w[i + 1], ks)
        short = conv(side, w[i], w[i + 1], 1 if legacy else ks)
        fwd += main + short + nx * conv(side, w[i + 1], w[i + 1], ks)
        if i == 0:
            first = main + short
    fwd += conv(s >> n, w[n], w[n + 1], ks)
    for i in range(n):
        fwd += (conv(s >> (i + 1), w[i + 2], w[i + 1], ks)
                + conv(s >> i, w[i] + w[i + 1], w[i + 1], ks)
                + nx * conv(s >> i, w[i + 1], w[i + 1], ks))
    fwd += conv(s, w[1], hp.n_classes, 1)
    return 3 * fwd - first


def write_corpus(path: str, n: int, hp, n_aug: int, seed: int) -> None:
    """A seeded corpus in the reference layout (``UnMicst1-5.py:295-312``):
    blob images (nuclei bright, a dimmer contour ring, noise) as
    ``I%05d_Img.tif`` with ``n_aug`` pages each (fresh noise per page),
    labels 1 background / 2 contour / 3 nucleus in ``I%05d_Ant.tif``, and
    the rings where two blobs meet in ``I%05d_wt.tif``."""
    import numpy as np

    from unmicst_tpu_torch.io.tiff import TiffWriter

    rng = np.random.RandomState(seed)
    side = hp.im_size
    os.makedirs(path, exist_ok=True)
    yy, xx = np.mgrid[:side, :side]
    for i in range(n):
        level = np.zeros((side, side))
        ant = np.ones((side, side), np.uint8)
        rings = np.zeros((side, side), np.int32)
        for _ in range(max(2, side * side // 600)):
            r, c = rng.randint(0, side, 2)
            rad = rng.randint(3, max(4, side // 12))
            d2 = (yy - r) ** 2 + (xx - c) ** 2
            ring = (d2 < (rad + 2) ** 2) & (d2 >= rad ** 2)
            inside = d2 < rad ** 2
            rings += ring
            ant[ring & (ant == 1)] = 2
            ant[inside] = 3
            level[ring] = np.maximum(level[ring], 0.4)
            level[inside] = 0.7
        with TiffWriter(os.path.join(path, f"I{i:05d}_Img.tif"),
                        bigtiff=False) as tw:
            for _ in range(n_aug * hp.n_channels):
                page = level + rng.rand(side, side) * 0.15
                tw.write((np.clip(page, 0, 1) * 65535).astype(np.uint16))
        for kind, arr in (("Ant", ant), ("wt", (rings > 1).astype(np.uint8))):
            with TiffWriter(os.path.join(path, f"I{i:05d}_{kind}.tif"),
                            bigtiff=False) as tw:
                tw.write(arr)


def _oracle_batch(dev, **arrays):
    """NHWC numpy arrays -> NCHW tensors on ``dev``."""
    import numpy as np
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(
        v.transpose(0, 3, 1, 2))).to(dev) for k, v in arrays.items()}


def train_oracles(dev, card: str) -> None:
    """The executed-TF training fixtures on the card, at the CPU tests'
    bars (``tests/test_oracle_parity.py:86-150,187-256``)."""
    import numpy as np

    from unmicst_tpu_torch import train as tr
    from unmicst_tpu_torch.core.checkpoint import (load_tf1_params,
                                                   params_to_jax)
    from unmicst_tpu_torch.core.hp import HParams

    fix = os.path.join(ROOT, "tests", "fixtures")
    d = os.path.join(fix, "oracle_train_legacy")
    with open(os.path.join(d, "hp.json")) as f:
        meta = json.load(f)
    hp = HParams.from_ref_dict(meta["hp"])
    data = np.load(os.path.join(d, "step.npz"))
    t = tr.Trainer(hp, tr.TrainConfig.for_variant("legacy"), "unused",
                   params=load_tf1_params(os.path.join(d, "model.ckpt"), hp,
                                          "legacy"), device=dev)
    m = t.train_step(t.model, t.opt_state,
                     _oracle_batch(dev, image=data["x"],
                                   labels=data["labels"]), None)
    loss_err = abs(float(m["loss"]) - meta["loss_train_mode"])
    tfv = {k[len("var::"):]: data[k] for k in data.files
           if k.startswith("var::")}
    tree = params_to_jax(t.params, hp, "legacy")
    pairs = [(tree["bottom"]["kernel1"], "lb/kernel1"),
             (tree["top"]["kernel"], "lt/kernel")]
    for i, layer in enumerate(tree["down"]):
        scope = "batch_normalization" + (f"_{i}" if i else "")
        pairs += [(layer["kernel1"], f"downsampling/ld{i}/kernel1"),
                  (layer["shortcut"], f"downsampling/ld{i}/shortcutWeights")]
        pairs += [(ke, f"downsampling/ld{i}/kernelExtra{j}")
                  for j, ke in enumerate(layer["extra"])]
        pairs += [(layer["bn"][k], f"{scope}/{k}") for k in
                  ("gamma", "beta", "moving_mean", "moving_variance")]
    for i, layer in enumerate(tree["up"]):
        pairs += [(layer["kernel1"], f"upsampling/lu{i}/kernel1"),
                  (layer["kernel2"], f"upsampling/lu{i}/kernel2")]
        pairs += [(ke, f"upsampling/lu{i}/kernel2Extra{j}")
                  for j, ke in enumerate(layer["extra"])]
    bad = [n for ours, n in pairs
           if not np.allclose(ours, tfv[n], atol=2e-5, rtol=2e-4)]
    worst = max(float(np.abs(ours - tfv[n]).max()) for ours, n in pairs)
    slot = t.tx.state_dict(t.opt_state, hp, "legacy")["0"]["trace"]
    slot_ok = np.allclose(slot["down"]["0"]["kernel1"],
                          tfv["downsampling/ld0/kernel1/Momentum"],
                          atol=1e-5, rtol=1e-4)
    log(f"[train] one-step TF oracle on the card: loss off by "
        f"{loss_err:.2e}, {len(pairs)} variables, max |d| {worst:.2e} "
        f"(bar atol 2e-5 rtol 2e-4), Momentum slot ok {slot_ok} [{card}]")
    check(loss_err < 1e-4 and not bad and slot_ok and len(pairs) == len(
        t.params), f"one-step oracle: loss {loss_err}, off {bad}, slot "
                   f"{slot_ok}")

    for variant in ("legacy", "v2"):
        d = os.path.join(fix, f"oracle_traj_{variant}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        hp = HParams.from_ref_dict(meta["hp"])
        data = np.load(os.path.join(d, "traj.npz"))
        cfg = tr.TrainConfig.for_variant(
            variant, decay_steps=meta["decay_steps"],
            decay_rate=meta["decay_rate"], lr0=meta["lr0"])
        t = tr.Trainer(hp, cfg, "unused", params=load_tf1_params(
            os.path.join(d, "init.ckpt"), hp, variant), device=dev)
        losses = []
        for s in range(meta["n_steps"]):
            arrays = {"image": data["x"][s], "labels": data["labels"][s]}
            if cfg.use_weights:
                arrays["weights"] = data["weights"][s]
            losses.append(t.train_step(t.model, t.opt_state,
                                       _oracle_batch(dev, **arrays), None)
                          ["loss"])
        losses = np.asarray([float(v) for v in losses])
        loss_ok = np.allclose(losses, data["losses"], rtol=1.2e-4,
                              atol=1.2e-4)
        final = load_tf1_params(os.path.join(d, "final.ckpt"), hp, variant)
        got = {k: v.cpu() for k, v in t.params.items()}
        var_ok = sorted(got) == sorted(final) and all(
            np.allclose(got[k].numpy(), final[k].numpy(), atol=2e-3,
                        rtol=1e-3) for k in final)
        worst = max(float((got[k] - final[k]).abs().max()) for k in final)
        rel = float(np.max(np.abs(losses - data["losses"])
                           / np.abs(data["losses"])))
        log(f"[train] {variant} 50-step TF trajectory on the card: loss "
            f"curve max rel {rel:.2e} (bar 1.2e-4), final variables max |d| "
            f"{worst:.2e} (bar atol 2e-3 rtol 1e-3) [{card}]")
        check(loss_ok and var_ok,
              f"{variant} trajectory: loss ok {loss_ok}, variables ok {var_ok}")


# ``python -m unmicst_tpu_torch`` with cuDNN's algorithms pinned: every
# ``torch.backends.cudnn.flags`` scope the engine opens runs without
# autotuning and with deterministic algorithms
_PIN = """
import torch

_flags = torch.backends.cudnn.flags


def _pinned(*args, **kwargs):
    kwargs.update(benchmark=False, deterministic=True)
    return _flags(*args, **kwargs)


torch.backends.cudnn.flags = _pinned
"""
PINNED_CLI = _PIN + """
import runpy

runpy.run_module("unmicst_tpu_torch", run_name="__main__", alter_sys=True)
"""


@contextlib.contextmanager
def pinned_cudnn():
    """:data:`PINNED_CLI`'s cuDNN pinning in this process, undone after."""
    import torch

    saved = torch.backends.cudnn.flags
    exec(_PIN, {})
    try:
        yield
    finally:
        torch.backends.cudnn.flags = saved


def in_new_thread(fn):
    """``fn()`` on a thread of its own, as a fresh process would run it:
    PyTorch keeps the cuDNN plans it has chosen per thread, keyed by the
    convolution and its flags but not by autotuning, so a pinned run on a
    thread whose plans were autotuned earlier would reuse those plans."""
    import threading

    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — raised below
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return out.get("value")


def read_pages(out_dir: str) -> list:
    from unmicst_tpu_torch.io.tiff import imread

    return [imread(os.path.join(out_dir, "s_Probabilities_1.tif"), k)
            for k in range(3)]


def level_diff(a_pages, b_pages) -> tuple:
    """(max level difference, pixels 1 level apart, pixels more apart)."""
    import numpy as np

    d = np.concatenate([np.abs(a.astype(np.int32) - b.astype(np.int32))
                        .ravel() for a, b in zip(a_pages, b_pages)])
    return int(d.max()), int((d == 1).sum()), int((d > 1).sum())


def phase_train(dev) -> dict:
    """Training on the card: the TF oracles, one step card against CPU,
    the full-width fits, and the trained model directory through the
    CLI.  Returns the launches of K1 and K2 on the trained directory's
    slide."""
    import dataclasses

    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch import train as tr
    from unmicst_tpu_torch.core.checkpoint import (NATIVE_FILE,
                                                   load_params_for_bundle)
    from unmicst_tpu_torch.core.hp import load_model_dir
    from unmicst_tpu_torch.core.unet import init_params
    from unmicst_tpu_torch.io.tiff import TiffWriter, imread, num_pages

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    train_oracles(dev, card)

    configs = {
        # name: (hp, variant, preset overrides, train / valid samples)
        "v2 default": (v2_default_hp(), "v2", {"n_aug": 12}, 96, 40),
        "legacy flagship": (legacy_hp(), "legacy", {}, 48, 24),
    }
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        trained = None
        for name, (hp, variant, over, n_train, n_valid) in configs.items():
            base = tr.TrainConfig.for_variant(variant, export_tf1=False,
                                              ckpt_every=10 ** 9, **over)
            data = os.path.join(tmp, name.replace(" ", "_"))
            t0 = time.perf_counter()
            write_corpus(data, n_train + n_valid, hp, base.n_aug, SEED + 90)
            corpus = tr.Corpus(data, n_train, hp, base)
            valid = tr.Corpus(data, n_valid, hp, base,
                              indices=np.arange(n_train, n_train + n_valid))
            log(f"[train] {name}: corpus of {n_train} + {n_valid} samples x "
                f"{base.n_aug} pages at {hp.im_size}^2 written and read in "
                f"{time.perf_counter() - t0:.2f} s")
            flops = train_step_flops(hp, variant == "legacy")
            state = init_params(hp, variant,
                                torch.Generator().manual_seed(SEED))

            # one step, card against CPU (no dropout: the two devices'
            # generators draw different masks)
            batch = next(corpus.batches(hp.batch_size,
                                        np.random.RandomState(SEED), True))
            res = {}
            slot = "mu" if base.optimizer == "adam" else "trace"
            for d in ("cpu", dev):
                t = tr.Trainer(hp, base, "unused", params=state, device=d)
                b = tr.to_device(batch, t.device)
                m = t.train_step(t.model, t.opt_state, b, None)
                res[str(d)] = (float(m["loss"]),
                               {k: v.cpu() for k, v in t.params.items()},
                               {k: v.cpu() for k, v in
                                t.opt_state.slots[slot].items()})
            (l_cpu, p_cpu, s_cpu), (l_card, p_card, s_card) = (
                res["cpu"], res[str(dev)])
            # the first-moment slot holds the gradient (Momentum's trace
            # is g, Adam's mu 0.1 g; the BN moving statistics' stay 0):
            # held tensor by tensor relative to its norm, where a wrong or
            # missing gradient is off by its whole norm and float32
            # rounding at these depths (ReLU gates and the probability
            # clip flipping) by far less than 5e-2 of it
            d_grad, worst = 0.0, ""
            zeros_equal = True
            for k, v in s_cpu.items():
                norm = float(v.norm())
                if norm == 0:
                    zeros_equal &= bool(torch.equal(s_card[k], v))
                    continue
                r = float((s_card[k] - v).norm()) / norm
                if r > d_grad:
                    d_grad, worst = r, k
            # Adam's first update is lr0 x sign(g), whatever g is, so only
            # Momentum's weights (lr0 x g) say more than the slot does
            d_param = max(float((p_card[k] - p_cpu[k]).abs().max())
                          for k in p_cpu)
            param_ok = base.optimizer == "adam" or d_param <= 1e-5
            log(f"[train] {name}: one step card vs CPU: loss {l_card:.7f} "
                f"vs {l_cpu:.7f} (rel {abs(l_card - l_cpu) / l_cpu:.2e}); "
                f"{slot} slot |d|/|s| at most {d_grad:.2e} ({worst}, bar "
                f"5e-2), zero slots equal {zeros_equal}; params max |d| "
                f"{d_param:.2e}" + ("" if base.optimizer == "adam" else
                                    " (bar 1e-5)") + f" [{card}]")
            check(abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
                  and d_grad <= 5e-2 and zeros_equal and param_ok,
                  f"{name}: card and CPU steps disagree")

            # device step time: back-to-back steps on one batch (events),
            # and the device busy time of 5 steps (profiler)
            t = tr.Trainer(hp, base, "unused", params=state, device=dev)
            b = tr.to_device(batch, dev)
            step_ms = cuda_ms(lambda: t.train_step(t.model, t.opt_state, b,
                                                   None), iters=20)
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    t.train_step(t.model, t.opt_state, b, None)
                torch.cuda.synchronize()
            busy = busy_ms(prof) / 5
            tflops = flops / step_ms / 1e9
            bt = tr.Trainer(hp, dataclasses.replace(
                base, compute_dtype="bfloat16"), "unused", params=state,
                device=dev)
            bf16_ms = cuda_ms(lambda: bt.train_step(bt.model, bt.opt_state,
                                                    b, None), iters=20)
            del t, bt
            log(f"[train] {name}: device step {step_ms:.3f} ms by events "
                f"(busy {busy:.3f} ms by the profiler), analytic "
                f"{flops / 1e12:.4f} TFLOP a step (XLA's count "
                f"{XLA_STEP_TFLOP[name]} TFLOP) = {tflops:.2f} TFLOP/s, "
                f"{tflops / (F32_FLOPS_PER_S / 1e12):.3f} of the float32 "
                f"peak (67 TFLOP/s); bfloat16 step {bf16_ms:.3f} ms "
                f"({flops / bf16_ms / 1e9:.2f} TFLOP/s) [{card}]")

            n_steps = 30
            for ve, pf in ((1, 0), (1, 4), (50, 0), (50, 4)):
                cfg = dataclasses.replace(base, valid_every=ve, prefetch=pf)
                tag = f"{name.replace(' ', '_')}_ve{ve}_pf{pf}"
                t = tr.Trainer(hp, cfg, os.path.join(tmp, "m_" + tag),
                               log_path=os.path.join(tmp, "log_" + tag),
                               params=state, device=dev)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                best = t.fit(corpus, valid, n_steps, verbose=False)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                t.close()
                with open(os.path.join(tmp, "log_" + tag,
                                       "metrics.jsonl")) as f:
                    recs = [json.loads(line) for line in f]
                el = [r["elapsed_s"] for r in recs]
                losses = [r["loss"] for r in recs]
                # steady state: steps 10..28 (past the first step's cuDNN
                # autotune and step 0's checkpoint, before the validation
                # that every fit runs after its last step)
                per_step = (el[-2] - el[10]) / (len(el) - 12)
                check(len(recs) == n_steps and np.all(np.isfinite(losses))
                      and np.isfinite(best), f"{tag}: fit records")
                log(f"[train] {name} fit valid_every {ve} prefetch {pf}: "
                    f"{1 / per_step:.2f} steps/s = "
                    f"{hp.batch_size / per_step:.1f} tiles/s (steps 10-28), "
                    f"{per_step * 1e3:.3f} ms a step of which host "
                    f"{per_step * 1e3 - busy:.3f} ms over the device's "
                    f"{busy:.3f}; {flops / per_step / 1e12:.2f} TFLOP/s end "
                    f"to end; fit {n_steps} steps {secs:.2f} s; peak "
                    f"{peak:.2f} GiB; loss {np.mean(losses[:5]):.4f} -> "
                    f"{np.mean(losses[-5:]):.4f}, best valid error "
                    f"{best:.4f} [{card}]")
                shutil.rmtree(os.path.join(tmp, "m_" + tag))
                if variant == "v2" and (ve, pf) == (1, 0):
                    trained = (t, hp)
                else:
                    del t
                torch.cuda.empty_cache()

        # -- the trained v2 directory, through the zoo loader and the CLI ----
        t, hp = trained
        zoo = os.path.join(tmp, "zoo")
        mdir = os.path.join(zoo, "nucleiDAPI1-5")
        t.cfg = dataclasses.replace(t.cfg, export_tf1=True)
        t.model_path = mdir
        t0 = time.perf_counter()
        t.save()
        saved = {k: v.cpu() for k, v in t.params.items()}
        size = sum(os.path.getsize(os.path.join(mdir, f))
                   for f in os.listdir(mdir))
        log(f"[train] Trainer.save of the v2 directory: {size / 1e6:.1f} MB "
            f"in {time.perf_counter() - t0:.2f} s ({sorted(os.listdir(mdir))})")
        del t, trained
        torch.cuda.empty_cache()
        loaded = []
        for only, keep in (("msgpack", lambda f: not f.startswith(
                "model.ckpt")), ("tf1", lambda f: f != NATIVE_FILE)):
            d = os.path.join(tmp, "zoo_" + only, "nucleiDAPI1-5")
            os.makedirs(d)
            for f in filter(keep, os.listdir(mdir)):
                shutil.copy(os.path.join(mdir, f), d)
            loaded.append(load_params_for_bundle(load_model_dir(d)))
        same = all(sorted(p) == sorted(saved) and all(
            torch.equal(p[k], saved[k]) for k in saved) for p in loaded)
        log(f"[train] reloaded through load_params_for_bundle from the "
            f"msgpack file alone and from the TF1 bundle alone: bit-equal "
            f"{same}")
        check(same, "the trained directory does not reload to its "
                    "parameters")

        raw = (np.clip(blob_slide(np.random.RandomState(SEED + 91), SLIDE,
                                  SLIDE, SLIDE * SLIDE // 400), 0, 1)
               * 65535).astype(np.uint16)
        src = os.path.join(tmp, "slide", "registration", "s.tif")
        os.makedirs(os.path.dirname(src))
        with TiffWriter(src, bigtiff=True) as tw:
            tw.write(raw)
        argv = [src, "--tool", "unmicst-solo", "--model", "nucleiDAPI1-5",
                "--modelRoot", zoo, "--stackOutput"]
        cli.main(argv + ["--outputPath", os.path.join(tmp, "warm")])
        kernels.reset_launch_counts()
        _, secs = wall(lambda: cli.main(argv + ["--outputPath",
                                                os.path.join(tmp, "out")]))
        counts = kernels.launch_counts()
        prob = os.path.join(tmp, "out", "s_Probabilities_1.tif")
        pages = [imread(prob, k) for k in range(num_pages(prob))]
        log(f"[train] cli.main on the trained directory, {SLIDE}^2: "
            f"{secs:.3f} s ({SLIDE * SLIDE / 1e6 / secs:.2f} Mpx/s end to "
            f"end), launches {counts} [{card}]")
        check(counts["softmax_blend"] > 0
              and counts["blend_fold_epilogue"] == 1
              and len(pages) == 3 and class_sum_ok(np.stack(pages)),
              f"trained-directory slide: launches {counts}, "
              f"{len(pages)} pages")
        trace = os.path.join(tmp, "trace")
        # the two fresh processes and the pinned run here are independent
        # checks, so they run side by side (ROADMAP T1)
        t0 = time.perf_counter()
        children = [subprocess.Popen(
            [sys.executable, *cmd, *argv, "--outputPath",
             os.path.join(tmp, out)], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for cmd, out in ((["-m", "unmicst_tpu_torch", "--trace", trace],
                              "out2"), (["-c", PINNED_CLI], "pinned2"))]
        try:
            with pinned_cudnn():
                in_new_thread(lambda: cli.main(
                    argv + ["--outputPath", os.path.join(tmp, "pinned")]))
            for proc, label in zip(children, ("", "pinned ")):
                _, err = proc.communicate(timeout=600)
                if not label:
                    secs = time.perf_counter() - t0
                check(proc.returncode == 0, f"{label}python -m "
                      f"unmicst_tpu_torch: rc {proc.returncode}\n"
                      f"{err[-3000:]}")
        finally:
            for proc in children:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        child = read_pages(os.path.join(tmp, "out2"))
        # a fresh process autotunes cuDNN anew, and another algorithm may
        # round a probability across a level: the bar is 1 level.  With
        # the algorithms pinned (no autotune, deterministic ones) in both
        # processes, the pages must be equal
        diff, n1, n_more = level_diff(child, pages)
        p_diff, p1, p_more = level_diff(
            read_pages(os.path.join(tmp, "pinned2")),
            read_pages(os.path.join(tmp, "pinned")))
        (trace_file,) = os.listdir(trace)
        with open(os.path.join(trace, trace_file)) as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"]
        k1 = sum("softmax_blend" in n for n in names)
        k2 = sum("fold_region" in n for n in names)
        n_px = 3 * SLIDE * SLIDE
        log(f"[train] python -m unmicst_tpu_torch on the trained directory: "
            f"rc 0 in {secs:.2f} s (a fresh process: kernels loaded, cuDNN "
            f"autotuned; beside the pinned child and the pinned run here); "
            f"its trace holds {k1} K1 and {k2} K2 launches; "
            f"pages within {diff} level(s) of cli.main's: {n1} of {n_px} "
            f"pixels 1 level apart, {n_more} more; with cuDNN's algorithms "
            f"pinned in both processes: within {p_diff} level(s), {p1} "
            f"pixels 1 level apart, {p_more} more [{card}]")
        check(k1 > 0 and k2 > 0 and diff <= 1 and p_diff == 0,
              f"child process: K1 {k1}, K2 {k2}, pages {diff} levels apart "
              f"({p_diff} with cuDNN pinned)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[train] phase {time.perf_counter() - t_phase:.1f}s")
    return counts


# -- phase 10: int8 ---------------------------------------------------------------

# H100 SXM dense int8 tensor-core peak (NVIDIA data sheet), the rate the
# int8 sites' s8 x s8 -> s32 products are held against
INT8_OPS_PER_S = 1979e12


def int8_bar(a, b) -> tuple:
    """(ok, mean levels, 99th percentile, argmax disagreement) of two uint8
    map stacks, at the JAX CLI's bar for int8 against a float mode
    (tests/test_cli.py:181-184): mean < 6 levels, p99 <= 60, argmax
    disagreement < 4%."""
    import numpy as np

    d = np.abs(a.astype(int) - b.astype(int))
    mean, p99 = float(d.mean()), float(np.percentile(d, 99))
    dis = float((a.argmax(0) != b.argmax(0)).mean())
    return mean < 6.0 and p99 <= 60 and dis < 0.04, mean, p99, dis


def stream_after_queued_work(stream, src, plan):
    """``stream.infer(src)`` issued behind work queued on the compute
    stream: a sleep, then a fill of tensors freed before the call, each
    the size of one of the stream's input buffers, whose blocks the
    caching allocator then hands to those buffers.  Uploads that did not
    wait for the queued work would be overwritten by the fill.  ``stream``
    is warm: a first call's new pinned host buffers are allocated through
    a call that waits for the card, which would hide the race."""
    import torch

    nbytes = plan.in_rows * plan.width * src.itemsize
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    junk = [torch.empty(nbytes, dtype=torch.uint8, device=stream.device)
            for _ in range(stream.in_flight)]
    torch.cuda._sleep(1_000_000_000)
    for j in junk:
        j.fill_(255)
    del junk, j
    return stream.infer(src)


def int8_sites(dev, label: str, hp, variant: str, chunk: int) -> list:
    """Every int8 site of one net at the engine's chunk (``chunk`` tiles):
    the card's int32 sums against a float64 convolution of the same int8
    values (cuDNN off: integer sums below 2^53 are exact in any order),
    which must be 0 apart; then the int8 route's time by CUDA events,
    whole and by stage (quantize; im2col and ``_int_mm``; ``_int_mm``
    alone; dequantize by difference), beside the port's bfloat16-mode
    cuDNN conv of the same site (bf16-rounded operands, TF32 on), and the
    bound: the larger of the site's operations over the int8 peak and its
    int8 input and float32 output bytes over the memory rate."""
    import torch
    import torch.nn.functional as F

    from unmicst_tpu_torch.core import quant, unet
    from unmicst_tpu_torch.infer import _conv_precision
    from unmicst_tpu_torch.utils.flops import quant_site_ops

    card = card_label()
    state = seeded_state(hp, variant, SEED)
    ops1 = quant_site_ops(hp, variant)
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    rows = []
    for site, w in quant.conv_sites(state, hp).items():
        cout, cin, ks, _ = w.shape
        side = hp.im_size >> quant.site_level(site, hp)
        shape = (chunk, cin, side, side)
        x8 = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int16).to(torch.int8)
        w8 = torch.randint(-127, 128, w.shape, generator=g, device=dev,
                           dtype=torch.int16).to(torch.int8)
        sums = unet.quant_conv_sums(x8, w8)
        with torch.backends.cudnn.flags(enabled=False):
            ref = F.conv2d(x8.double(), w8.double(), padding=ks // 2)
        apart = float((sums.double() - ref).abs().max())
        check(apart == 0, f"int8 sums at {label} {site} are {apart} from "
                          "the float64 reference")
        del sums, ref, x8
        x = torch.randn(shape, generator=g, device=dev)
        a = x.abs().amax(dim=(0, 2, 3)) / 127
        k = quant.to_device({"kernels": {site: {
            "w8": w8, "w_scale": torch.rand(cout, device=dev) * 1e-3,
            "bias": torch.randn(cout, device=dev)}}, "scales": {site: a}},
            dev)["kernels"][site]
        mat = k["w8_mat"]
        route = cuda_ms(lambda: unet.quant_conv(x, k, a), iters=5)
        quantize = cuda_ms(lambda: unet.quantize_input(x, a), iters=5)
        x8q = unet.quantize_input(x, a)
        im2col_mm = cuda_ms(lambda: unet.int8_conv(
            x8q, mat, ks, lambda b0, s32: None), iters=5)
        kp = mat.shape[0]
        group = max(1, min(chunk, unet.IM2COL_BUDGET // (side * side * kp)))
        buf = torch.randint(-127, 128, (max(group * side * side, 17), kp),
                            generator=g, device=dev,
                            dtype=torch.int16).to(torch.int8)
        mm = cuda_ms(lambda: torch._int_mm(buf, mat), iters=5) * (
            chunk / group)
        wf = torch.from_numpy(w).to(dev)
        with _conv_precision(True):
            bf16 = cuda_ms(lambda: F.conv2d(
                x.to(torch.bfloat16).float(),
                wf.to(torch.bfloat16).float(), padding=ks // 2), iters=5)
        ops = ops1[site] * chunk
        n_bytes = chunk * side * side * (cin + 4 * cout)
        bound = max(ops / INT8_OPS_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3
        bound_by = ("operations" if ops / INT8_OPS_PER_S
                    > n_bytes / HBM_BYTES_PER_S else "bytes")
        row = dict(net=label, site=site, cin=cin, cout=cout, ks=ks,
                   side=side, k=cin * ks * ks, int8_ms=route,
                   quantize_ms=quantize, im2col_mm_ms=im2col_mm,
                   int_mm_ms=mm, dequant_ms=route - quantize - im2col_mm,
                   bf16_ms=bf16, bound_ms=bound, bound_by=bound_by,
                   tops=ops / route / 1e9)
        rows.append(row)
        log(f"[int8] {label} {site}: {chunk}x{cin}x{side}^2 -> {cout}, K "
            f"{cin * ks * ks}; sums 0 apart from float64; int8 route "
            f"{route:.4f} ms (quantize {quantize:.4f}, im2col + _int_mm "
            f"{im2col_mm:.4f}, _int_mm {mm:.4f}, dequantize "
            f"{route - quantize - im2col_mm:.4f}) against bf16-mode cuDNN "
            f"{bf16:.4f} ms; bound {bound:.4f} ms ({bound_by}); "
            f"{ops / route / 1e9:.2f} TOP/s "
            f"({ops / route / 1e9 / (INT8_OPS_PER_S / 1e12):.4f} of the "
            f"int8 peak) [{card}]")
        del x, x8q, buf
    torch.cuda.empty_cache()
    tot = {k: sum(r[k] for r in rows) for k in ("int8_ms", "bf16_ms",
                                                 "bound_ms")}
    log(f"[int8] {label} all {len(rows)} sites at chunk {chunk}: int8 "
        f"{tot['int8_ms']:.3f} ms, bf16-mode cuDNN {tot['bf16_ms']:.3f} ms, "
        f"bound {tot['bound_ms']:.3f} ms [{card}]")
    return rows


def int8_profile(run, label: str) -> None:
    """One int8 slide under the profiler: device time by kind (im2col and
    other copies, ``_int_mm``, elementwise, cuDNN, K1, K2), the busy and
    idle shares of the call's wall time, and the top kernels by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    if not by_name:
        log(f"[int8] {label} profile: not measured (no device events)")
        return

    def kind(name):
        low = name.lower()
        if "softmax_blend" in low:
            return "K1"
        if "fold_region" in low or "fold_weighted" in low:
            return "K2"
        if "memcpy" in low or "memset" in low:
            return "memcpy/memset"
        if any(t in low for t in ("s8", "i8", "imma", "int8", "igemm")):
            return "_int_mm"
        if "copy" in low:
            return "copies (im2col, pad, layout)"
        if any(t in low for t in ("conv", "fprop", "cudnn", "xmma", "sm90",
                                  "implicit", "winograd", "dgrad", "wgrad",
                                  "nhwc", "nchw")):
            return "cuDNN"
        return "elementwise and other"

    kinds = {}
    for name, (ms, n) in by_name.items():
        k = kind(name)
        kms, kn = kinds.get(k, (0.0, 0))
        kinds[k] = (kms + ms, kn + n)
    busy = busy_ms(prof)
    log(f"[int8] {label} profile: wall {wall_ms:.2f} ms (profiler on), "
        f"device busy {busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}; "
        + "; ".join(f"{k} {ms:.3f} ms x{n}" for k, (ms, n) in
                    sorted(kinds.items(), key=lambda kv: -kv[1][0])))
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:14]:
        log(f"[int8] {ms:9.3f} ms x{n:<5d} [{kind(name)}] {name[:110]}")


def phase_int8(dev) -> None:
    """int8 (``--precision int8``: bfloat16 glue, the plain conv sites in
    int8 through ``torch._int_mm`` over an im2col) on the card: every site
    of both nets exact and timed, the whole engine against float32 and
    bfloat16 in this call, its calibration and profile, the stream, the
    sharded stream, the duo net, a scaled slide, the card against the CPU,
    and the CLI."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.core import quant
    from unmicst_tpu_torch.infer import InferenceEngine, pick_tile_batch
    from unmicst_tpu_torch.io.tiff import TiffWriter, imread, num_pages
    from unmicst_tpu_torch.runtime.mesh import make_mesh
    from unmicst_tpu_torch.runtime.pipeline import StreamingEngine

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    bf = torch.bfloat16

    def launched():
        return {k: v for k, v in kernels.launch_counts().items() if v}

    lhp, dhp = legacy_hp(), duo_hp()
    chunk_l = pick_tile_batch(lhp, dev, True)
    chunk_d = pick_tile_batch(dhp, dev, True)
    int8_sites(dev, "nucleiDAPI", lhp, "legacy", chunk_l)
    int8_sites(dev, "nucleiDAPILAMIN", dhp, "v2", chunk_d)

    # -- the whole engine, legacy 4096^2 ----------------------------------------
    lstate = seeded_state(lhp, "legacy", SEED)
    g = torch.Generator().manual_seed(SEED + 1)
    raw = torch.randint(0, 65536, (SLIDE, SLIDE), generator=g,
                        dtype=torch.int32).numpy().astype(np.uint16)
    px = SLIDE * SLIDE
    engines = {
        "float32": InferenceEngine(lhp, lstate, "legacy", LEGACY_MEAN,
                                   LEGACY_STD, device=dev),
        "bfloat16": InferenceEngine(lhp, lstate, "legacy", LEGACY_MEAN,
                                    LEGACY_STD, compute_dtype=bf,
                                    device=dev),
        "int8": InferenceEngine(lhp, lstate, "legacy", LEGACY_MEAN,
                                LEGACY_STD, compute_dtype=bf, quantized=True,
                                device=dev),
    }
    q = engines["int8"]
    _, calib = wall(lambda: q._quant_for_raw(raw, -1, True))
    log(f"[int8] legacy calibration (64 tiles, two float32 forwards, "
        f"percentiles, host weight quantization): {calib:.3f} s [{card}]")
    maps = {}
    for name, eng in engines.items():
        kernels.reset_launch_counts()
        maps[name], first = wall(lambda: eng.infer_slide(raw))
        counts = launched()
        log(f"[int8] legacy {name} first call {first:.3f} s (cuDNN autotune "
            f"included), tile batch {eng.tile_batch}, launches {counts}")
        check(counts.get("softmax_blend", 0) > 0
              and counts.get("blend_fold_epilogue", 0) == 1,
              f"the {name} slide did not run K1 and K2: {counts}")
    check(maps["int8"].shape == (3, SLIDE, SLIDE)
          and class_sum_ok(maps["int8"]), "bad int8 maps")
    rates = {}
    for name in ("float32", "bfloat16", "int8", "bfloat16", "float32"):
        eng = engines[name]
        mpx, med, times = median_rate(lambda: eng.infer_slide(raw), px)
        rates.setdefault(name, []).append(mpx)
        log(f"[int8] legacy {name} 4096^2: {mpx:.2f} Mpx/s (median "
            f"{med:.4f}s of {[round(x, 4) for x in times]}) [{card}]")
    for name, eng in engines.items():
        pk = peak_bytes(lambda: eng.infer_slide(raw))
        log(f"[int8] legacy {name} peak device memory {pk / 2**30:.3f} GiB")
    log("[int8] legacy 4096^2 Mpx/s in this call: " + ", ".join(
        f"{k} {v}" for k, v in rates.items()) + f" [{card}]")
    int8_profile(lambda: q.infer_slide(raw), f"legacy int8 4096^2 [{card}]")
    ok, mean, p99, dis = int8_bar(maps["int8"], maps["bfloat16"])
    log(f"[int8] legacy int8 vs bfloat16 4096^2: mean {mean:.3f} levels, p99 "
        f"{p99:.1f}, argmax disagreement {dis:.4f} (bar: < 6, <= 60, < 0.04)")
    check(ok, f"int8 and bfloat16 maps disagree beyond the JAX CLI's bar: "
              f"mean {mean}, p99 {p99}, argmax {dis}")
    ok, mean, p99, dis = int8_bar(maps["int8"], maps["float32"])
    log(f"[int8] legacy int8 vs float32 4096^2: mean {mean:.3f} levels, p99 "
        f"{p99:.1f}, argmax disagreement {dis:.4f}")

    # the card against the CPU on a 512^2 crop, one QuantState.  On these
    # seeded full-width weights one int8 input that a float ulp moves
    # across a rounding edge shifts its neighbourhood by a whole int8 step,
    # which the untrained net amplifies to tens of levels at a few pixels:
    # the pair is held to few pixels apart (p99, argmax); the CLI's mode
    # (bfloat16 glue) on blobDemo's trained weights to 2 levels on 5%
    crop = raw[:512, :512]
    state_cpu = quant.to_device(q._quant, "cpu")
    for glue, name in ((bf, "bfloat16"), (None, "float32")):
        on = {}
        for d in (dev, "cpu"):
            e = InferenceEngine(lhp, lstate, "legacy", LEGACY_MEAN,
                                LEGACY_STD, compute_dtype=glue,
                                quantized=True, device=d)
            e._quant = state_cpu
            on[str(d)] = e.infer_slide(crop)
        _, worst, share = maps_agree(on[str(dev)], on["cpu"], bf)
        _, mean, p99, dis = int8_bar(on[str(dev)], on["cpu"])
        log(f"[int8] legacy int8 ({name} glue) card vs CPU on 512^2, one "
            f"QuantState: max {worst} level(s), {share:.3e} of pixels "
            f"differ, mean {mean:.4f}, p99 {p99:.1f}, argmax {dis:.4f} "
            "(bar: mean < 0.5, p99 <= 4, argmax < 0.01)")
        check(mean < 0.5 and p99 <= 4 and dis < 0.01,
              f"int8 card and CPU disagree ({name} glue): mean {mean}, p99 "
              f"{p99}, argmax {dis}")
    from unmicst_tpu_torch.core.checkpoint import load_params_for_bundle
    from unmicst_tpu_torch.core.hp import load_model_dir

    bundle = load_model_dir(os.path.join(ROOT, "models", "blobDemo"))
    demo_params = load_params_for_bundle(bundle)
    blobs = (np.clip(blob_slide(np.random.RandomState(43), 512, 512, 64),
                     0, 1) * 65535).astype(np.uint16)
    on_card, on_cpu = (InferenceEngine.from_bundle(
        bundle, demo_params, device=d, compute_dtype=bf, quantized=True)
        for d in (dev, "cpu"))
    card_maps = on_card.infer_slide(blobs, rescale=False)
    on_cpu._quant = quant.to_device(on_card._quant, "cpu")
    ok, worst, share = maps_agree(card_maps,
                                  on_cpu.infer_slide(blobs, rescale=False),
                                  bf)
    log(f"[int8] blobDemo int8 (bfloat16 glue) card vs CPU on 512^2, one "
        f"QuantState: max {worst} level(s), {share:.3e} of pixels differ "
        "(bar: 2 levels on 5%)")
    check(ok, f"blobDemo int8 card and CPU disagree: {worst} levels on "
              f"{share:.3e}")

    # the int8 calibration without autotuning: the same scales from fresh
    # threads (PyTorch's cuDNN plan cache is per thread), half of them
    # calibrating while a matmul loop on another stream loads the card;
    # autotuned, the timing runs' choice follows the load
    def calibrated_scales(load: bool):
        import threading

        stop = threading.Event()

        def busy():
            a = torch.randn(8192, 8192, device=dev)
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                while not stop.is_set():
                    a = (a @ a).clamp_(-1, 1)
                    torch.cuda.current_stream(dev).synchronize()

        noise = threading.Thread(target=busy) if load else None
        if noise:
            noise.start()
        try:
            e = InferenceEngine.from_bundle(bundle, demo_params, device=dev,
                                            compute_dtype=bf, quantized=True)
            e._quant_for_raw(blobs, -1, False)
        finally:
            stop.set()
            if noise:
                noise.join()
        return {k: v.cpu() for k, v in e._quant["scales"].items()}

    t = time.perf_counter()
    runs = [in_new_thread(lambda i=i: calibrated_scales(i % 2 == 1))
            for i in range(6)]
    same = all(r.keys() == on_card._quant["scales"].keys() and all(
        torch.equal(r[k], on_card._quant["scales"][k].cpu()) for k in r)
        for r in runs)
    log(f"[int8] blobDemo calibration in 6 fresh threads (3 with the card "
        f"loaded from another stream) and the engine's: scales identical "
        f"{same} ({time.perf_counter() - t:.2f} s)")
    check(same, "the int8 calibration's scales change with the card's load")

    # a scaled slide: its own calibration on resized row bands
    q05 = InferenceEngine(lhp, lstate, "legacy", LEGACY_MEAN, LEGACY_STD,
                          compute_dtype=bf, quantized=True, device=dev)
    _, calib = wall(lambda: q05._quant_for_raw(raw, -1, True, 0.5))
    kernels.reset_launch_counts()
    m05, first = wall(lambda: q05.infer_slide(raw, scaling_factor=0.5))
    counts = launched()
    mpx, med, times = median_rate(
        lambda: q05.infer_slide(raw, scaling_factor=0.5), px)
    b05 = engines["bfloat16"].infer_slide(raw, scaling_factor=0.5)
    mpx_b, med_b, _ = median_rate(
        lambda: engines["bfloat16"].infer_slide(raw, scaling_factor=0.5), px)
    ok, mean, p99, dis = int8_bar(m05, b05)
    log(f"[int8] legacy int8 at scaling factor 0.5: calibration {calib:.3f} "
        f"s, first call {first:.3f} s, {mpx:.2f} Mpx/s of raw pixels (median "
        f"{med:.4f}s of {[round(x, 4) for x in times]}) against bfloat16 "
        f"{mpx_b:.2f}; launches {counts}; vs bfloat16 mean {mean:.3f}, p99 "
        f"{p99:.1f}, argmax {dis:.4f} [{card}]")
    check(ok and m05.shape == (3, SLIDE, SLIDE)
          and counts.get("softmax_blend", 0) > 0
          and counts.get("blend_fold_epilogue", 0) == 1,
          f"the scaled int8 slide failed: {counts}, mean {mean}")
    del engines, maps, m05, b05, q05
    torch.cuda.empty_cache()

    # -- the stream and the sharded stream, 8192^2 ------------------------------
    g = torch.Generator().manual_seed(SEED + 3)
    big = torch.randint(0, 65536, (BIG, BIG), generator=g,
                        dtype=torch.int32).numpy().astype(np.uint16)
    bpx = BIG * BIG
    stream = StreamingEngine(lhp, lstate, "legacy", LEGACY_MEAN, LEGACY_STD,
                             quantized=True, device=dev)
    plan = stream._plan(BIG, BIG)
    kernels.reset_launch_counts()
    got, first = wall(lambda: stream.infer(big))
    counts = launched()
    mpx, med, times = median_rate(lambda: stream.infer(big), bpx, reps=2)
    log(f"[int8] stream 8192^2: first call {first:.3f} s (calibration and "
        f"autotune included), {mpx:.2f} Mpx/s (median {med:.4f}s of "
        f"{[round(x, 4) for x in times]}), {plan.n_stripes} stripes; "
        f"launches {counts} [{card}]")
    check(got.shape == (3, BIG, BIG) and class_sum_ok(got)
          and counts.get("blend_fold_stripe", 0) == plan.n_stripes
          and counts.get("softmax_blend", 0) > 0,
          f"the int8 stream did not run K1 and K2's stripe entry: {counts}")
    bstream = StreamingEngine(lhp, lstate, "legacy", LEGACY_MEAN, LEGACY_STD,
                              device=dev)
    bgot = bstream.infer(big)
    mpx_b, _, _ = median_rate(lambda: bstream.infer(big), bpx, reps=2)
    ok, mean, p99, dis = int8_bar(got, bgot)
    log(f"[int8] stream int8 against the bfloat16 stream ({mpx_b:.2f} "
        f"Mpx/s): mean {mean:.3f}, p99 {p99:.1f}, argmax {dis:.4f}")
    check(ok, f"the int8 stream is beyond the JAX CLI's bar from bfloat16: "
              f"mean {mean}, p99 {p99}, argmax {dis}")
    del bstream, bgot
    # the first call (calibration included) against a warm one, and warm
    # ones issued behind queued work that frees the blocks their input
    # buffers then take (stream_after_queued_work; twice, as the first
    # after empty_cache may find the card idle)
    warm = stream.infer(big)
    for name, other in (
            ("first call", lambda: got),
            ("call behind queued work",
             lambda: stream_after_queued_work(stream, big, plan)),
            ("second call behind queued work",
             lambda: stream_after_queued_work(stream, big, plan))):
        d = np.abs(other().astype(int) - warm.astype(int))
        log(f"[int8] stream {name} against a warm call: max {d.max()} "
            f"levels, {(d > 0).mean():.3e} of pixels differ")
        check(d.max() <= 1, f"the int8 stream's {name} differs from a warm "
              f"call by {d.max()} levels on {(d > 1).mean():.3e} of pixels")
    del warm, d
    mesh = make_mesh(devices=[dev] * RANKS)
    wall(lambda: stream.infer_sharded(big, mesh))
    kernels.reset_launch_counts()
    sharded, secs = wall(lambda: stream.infer_sharded(big, mesh))
    counts = launched()
    ok, mean, p99, dis = int8_bar(sharded, got)
    d = np.abs(sharded.astype(int) - got.astype(int))
    log(f"[int8] sharded stream over {RANKS} ranks of the card: "
        f"{bpx / 1e6 / secs:.2f} Mpx/s ({secs:.3f} s, warm); vs the stream "
        f"max {d.max()} levels, {(d > 0).mean():.3e} of pixels differ, mean "
        f"{mean:.4f}; launches {counts} [{card}]")
    check(ok and counts.get("ring_shift", 0) == 2 * plan.n_stripes
          and counts.get("softmax_blend", 0) > 0,
          f"the int8 sharded stream failed: {counts}, mean {mean}")
    del stream, got, sharded, big, d
    torch.cuda.empty_cache()

    # -- the duo net, 4096^2 ------------------------------------------------------
    dstate = seeded_state(dhp, "v2", SEED)
    g = torch.Generator().manual_seed(SEED + 4)
    planes = [torch.randint(0, top, (SLIDE, SLIDE), generator=g,
                            dtype=torch.int32).numpy().astype(np.uint16)
              for top in (65536, 30000)]
    dq = InferenceEngine(dhp, dstate, "v2", DUO_MEAN, DUO_STD,
                         compute_dtype=bf, quantized=True, device=dev)
    db = InferenceEngine(dhp, dstate, "v2", DUO_MEAN, DUO_STD,
                         compute_dtype=bf, device=dev)
    _, calib = wall(lambda: dq._quant_for_raw(np.stack(planes), -1, True))
    kernels.reset_launch_counts()
    dm, first = wall(lambda: dq.infer_slide_stack(planes))
    counts = launched()
    mpx, med, times = median_rate(lambda: dq.infer_slide_stack(planes), px)
    bm = db.infer_slide_stack(planes)
    mpx_b, med_b, _ = median_rate(lambda: db.infer_slide_stack(planes), px)
    ok, mean, p99, dis = int8_bar(dm, bm)
    pk = peak_bytes(lambda: dq.infer_slide_stack(planes))
    log(f"[int8] duo 4096^2: calibration {calib:.3f} s, first call "
        f"{first:.3f} s, {mpx:.2f} Mpx/s (median {med:.4f}s of "
        f"{[round(x, 4) for x in times]}) against bfloat16 {mpx_b:.2f}; "
        f"peak {pk / 2**30:.3f} GiB, tile batch {dq.tile_batch}; launches "
        f"{counts}; vs bfloat16 mean {mean:.3f}, p99 {p99:.1f}, argmax "
        f"{dis:.4f} [{card}]")
    check(ok and class_sum_ok(dm) and counts.get("softmax_blend", 0) > 0
          and counts.get("blend_fold_epilogue", 0) == 1,
          f"the duo int8 slide failed: {counts}, mean {mean}")
    int8_profile(lambda: dq.infer_slide_stack(planes),
                 f"duo int8 4096^2 [{card}]")
    del dq, db, dm, bm, planes
    torch.cuda.empty_cache()

    # -- the CLI: --precision int8 on blobDemo (trained weights) ------------------
    rng = np.random.RandomState(42)
    img = blob_slide(rng, 1024, 1024, 256)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "s", "registration", "blobs.tif")
        os.makedirs(os.path.dirname(src))
        with TiffWriter(src, bigtiff=False) as tw:
            tw.write((np.clip(img, 0, 1) * 65535).astype(np.uint16))
        pages = {}
        for prec in ("float32", "int8"):
            out = os.path.join(tmp, prec)
            kernels.reset_launch_counts()
            rc = cli.main([src, "--tool", "unmicst-solo", "--model",
                           "blobDemo", "--modelRoot",
                           os.path.join(ROOT, "models"), "--outputPath", out,
                           "--stackOutput", "--precision", prec])
            counts = launched()
            prob = os.path.join(out, "blobs_Probabilities_1.tif")
            check(rc == 0 and num_pages(prob) == 3,
                  f"the {prec} CLI run failed (rc {rc})")
            pages[prec] = np.stack([imread(prob, k) for k in range(3)])
    nuclei = pages["int8"][0].astype(float) / 255
    inside, background = nuclei[img > 0.6].mean(), nuclei[img < 0.2].mean()
    ok, mean, p99, dis = int8_bar(pages["int8"], pages["float32"])
    log(f"[int8] CLI --precision int8 (blobDemo, 1024^2): inside "
        f"{inside:.3f} background {background:.3f}; launches {counts}; "
        f"against --precision float32 mean {mean:.3f}, p99 {p99:.1f}, "
        f"argmax {dis:.4f}")
    check(ok and inside > 0.8 and background < 0.3
          and counts.get("softmax_blend", 0) > 0
          and counts.get("blend_fold_epilogue", 0) == 1,
          f"the int8 CLI run is off: inside {inside}, background "
          f"{background}, mean {mean}, launches {counts}")
    log(f"[int8] phase {time.perf_counter() - t_phase:.1f}s")


# -- phase 11: serving ------------------------------------------------------------

PAN = 1024  # a viewer's ROI side
N_PANS = 50


def pan_offsets() -> list:
    """Phase 11's seeded pans on the 8192^2 slide: (row, column) each."""
    import numpy as np

    g = np.random.RandomState(SEED + 32)
    return [(int(g.randint(0, BIG - PAN)), int(g.randint(0, BIG - PAN)))
            for _ in range(N_PANS)]


def k2_trim_windows(dev) -> dict:
    """K2's trimmed route at the first seeded pan: the 1024^2 window of its
    context band's maps, on K1-weighted random tiles.  Checks it against
    its plain version and the untrimmed launch's crop, then times it by
    events and by the profiler (device time per launch), in this order: at
    the same window moved to the nearest 4-aligned canvas column origin,
    at the window's own origin, at the aligned one again (what ran just
    before a launch moves its time: the same data may be left in L2 in
    another state), and over the whole band (a trim of all of it); with
    each launch plan's columns per thread, beside the plain version,
    ``F.fold`` of the band and the window's bound."""
    import importlib

    import torch
    import torch.nn.functional as F

    from unmicst_tpu_torch import kernels, serve
    from unmicst_tpu_torch.core import tiler

    bf = importlib.import_module("unmicst_tpu_torch.kernels.blend_fold")
    hp = legacy_hp()
    k, p = hp.n_classes, hp.im_size
    r0, c0 = pan_offsets()[0]
    a, b, ca, cb = serve.roi_band((r0, c0, PAN, PAN), (BIG, BIG), hp)
    grid = tiler.make_grid(b - a, cb - ca, p, hp.margin)
    t, m = grid.num_tiles, grid.margin
    gen = torch.Generator(device=dev).manual_seed(SEED + 33)
    window = torch.from_numpy(tiler.ramp_window(p, hp.margin)).to(dev)
    weighted = kernels.softmax_blend(
        3 * torch.randn((t, k, p, p), generator=gen, device=dev), window,
        torch.ones(t, device=dev))
    trim = (r0 - a, c0 - ca, PAN, PAN)
    got = kernels.blend_fold_epilogue(weighted, window, grid, trim=trim)
    plain = kernels.blend_fold_epilogue_plain(weighted, window, grid,
                                              trim=trim)
    untrimmed = kernels.blend_fold_epilogue(weighted, window, grid)
    torch.cuda.synchronize()
    err = int((got.int() - plain.int()).abs().max().item())
    crop_ok = torch.equal(got, untrimmed[:, trim[0]:trim[0] + PAN,
                                         trim[1]:trim[1] + PAN])
    st, sk, sy, sx = weighted.stride()
    tc_al = trim[1] + (-(m + trim[1])) % 4  # the next 4-aligned origin
    if tc_al + PAN > grid.width:
        tc_al -= 4
    origins = {}
    aligned = (trim[0], tc_al, PAN, PAN)
    for name, tr in (("aligned", aligned), ("seeded", trim),
                     ("aligned again", aligned),
                     ("band", (0, 0, grid.height, grid.width))):
        plan = bf.fold_launch(tr[2], m + tr[1], tr[3], (grid.npc * st, st, sk,
                                                        sy, sx), grid.sub, p,
                              [weighted.data_ptr(), window.data_ptr()])
        fn = lambda tr=tr: kernels.blend_fold_epilogue(  # noqa: E731
            weighted, window, grid, trim=tr)
        origins[name] = dict(c0=m + tr[1], cols=plan.cols, ms=cuda_ms(fn),
                             dev_ms=fold_device_ms(fn, f"K2 trimmed {name}"))
    no_sync(lambda: kernels.blend_fold_epilogue(weighted, window, grid,
                                                trim=trim),
            "K2 trimmed region")
    plain_ms = cuda_ms(lambda: kernels.blend_fold_epilogue_plain(
        weighted, window, grid, trim=trim), iters=3)
    cols = weighted.reshape(t, k * p * p).t().unsqueeze(0).contiguous()
    lib_ms = cuda_ms(lambda: F.fold(cols, (grid.padded_height,
                                           grid.padded_width), p,
                                    stride=grid.sub))
    n_read = (covered(grid.npr, grid.sub, p, m + trim[0], m + trim[0] + PAN)
              * covered(grid.npc, grid.sub, p, m + trim[1],
                        m + trim[1] + PAN) * k)
    n_out = k * PAN * PAN
    bound, by = bound_ms(4 * n_read + 4 * p * p + n_out,
                         4 * n_read + 7 * n_out)
    del weighted, cols, got, plain, untrimmed
    torch.cuda.empty_cache()
    return dict(band=(b - a, cb - ca), tiles=t, trim=trim, err=err,
                crop_ok=crop_ok, origins=origins, plain_ms=plain_ms,
                lib_ms=lib_ms, bound=bound, by=by)


def k2_trim_ab(trees) -> None:
    """:func:`k2_trim_windows` over the kernels of each of ``trees``
    (directories holding a copy of the repository, such as a ``git
    archive`` of another commit), in that order, each in a process of its
    own; one ``[K2t-ab]`` line each.  Run as ``python3 -c "import
    chip_smoke as c; c.k2_trim_ab(['parent', '.', '.', 'parent'])"``."""
    code = (
        "import importlib.util, json, sys, torch\n"
        "spec = importlib.util.spec_from_file_location('smoke', sys.argv[2])\n"
        "c = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(c)\n"
        "sys.path.insert(0, sys.argv[1])  # before the module's own root\n"
        "import unmicst_tpu_torch as u\n"
        "assert u.__file__.startswith(sys.argv[1] + '/'), u.__file__\n"
        "c.phase_build()\n"
        "print('[K2t-ab] ' + sys.argv[1] + ' ' + json.dumps("
        "c.k2_trim_windows(torch.device('cuda', 0))), flush=True)\n")
    for tree in trees:
        tree = os.path.abspath(tree)
        res = subprocess.run([sys.executable, "-c", code, tree,
                              os.path.abspath(__file__)], cwd=tree,
                             capture_output=True, text=True, timeout=600)
        for line in res.stdout.splitlines():
            if line.startswith("[K2t-ab]"):
                log(line)
        check(res.returncode == 0, f"K2t A/B in {tree}: rc "
              f"{res.returncode}\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    log(card_label())


def idct_times(side: int = SLIDE) -> dict:
    """Host seconds of the JPEG reads the islow IDCT dominates, in the
    package this process imports: the IDCT alone over the coefficients of
    phase 16's mosaic (64 tiles of 512^2, three passes), then the
    ``side``^2 JPEG CZI of those tiles (:func:`jpeg_mosaic`, through
    ``czi.read_czi_channel``) and the ``side``^2 JPEG TIFF of complete
    tiles (:func:`jpeg_tiff`, through ``tiff.imread``), each read whole
    twice; with a digest of the pixels of both reads."""
    import hashlib

    from unmicst_tpu_torch.io import czi, jpeg
    from unmicst_tpu_torch.io.tiff import imread

    tiles = [jpeg_fixture(n)[0] for n in MOSAIC_TILES]
    # the first decode also builds the host library
    coefs = [jpeg.decode_coefficients(tiles[k % len(tiles)])
             for k in range(64)]
    out = {"idct_mosaic_s": []}
    for _ in range(3):
        t0 = time.perf_counter()
        for frame, coef in coefs:
            jpeg.idct_islow(coef, frame.components[0].qtable)
        out["idct_mosaic_s"].append(time.perf_counter() - t0)
    digest = hashlib.sha256()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_idct_")
    try:
        for key, write, read in (
                ("czi", lambda p: jpeg_mosaic(p, side),
                 lambda p: czi.read_czi_channel(p, 0)),
                ("tiff", lambda p: jpeg_tiff(p, side, False), imread)):
            path = os.path.join(tmp, key)
            write(path)
            out[f"{key}_read_s"] = []
            for _ in range(2):
                t0 = time.perf_counter()
                px = read(path)
                out[f"{key}_read_s"].append(time.perf_counter() - t0)
            digest.update(px.tobytes())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["pixels_sha256"] = digest.hexdigest()[:16]
    return out


def idct_ab(trees) -> None:
    """:func:`idct_times` in each of ``trees`` (directories holding a
    copy of the repository, such as a ``git archive`` of another commit),
    in that order, each in a process of its own; one ``[IDCT-ab]`` line
    each.  Run as ``python3 -c "import chip_smoke as c;
    c.idct_ab(['parent', '.', '.', 'parent'])"``."""
    code = (
        "import importlib.util, json, sys\n"
        "spec = importlib.util.spec_from_file_location('smoke', sys.argv[2])\n"
        "c = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(c)\n"
        "sys.path.insert(0, sys.argv[1])  # before the module's own root\n"
        "import unmicst_tpu_torch as u\n"
        "assert u.__file__.startswith(sys.argv[1] + '/'), u.__file__\n"
        "print('[IDCT-ab] ' + sys.argv[1] + ' ' + json.dumps("
        "c.idct_times()), flush=True)\n")
    for tree in trees:
        tree = os.path.abspath(tree)
        res = subprocess.run([sys.executable, "-c", code, tree,
                              os.path.abspath(__file__)], cwd=tree,
                             capture_output=True, text=True, timeout=600)
        for line in res.stdout.splitlines():
            if line.startswith("[IDCT-ab]"):
                log(line)
        check(res.returncode == 0, f"IDCT A/B in {tree}: rc "
              f"{res.returncode}\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    log(card_label())


def http(method: str, url: str, data=None) -> tuple:
    """(status, body, headers, host seconds) of one request; an HTTP error
    is returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/octet-stream"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, body, headers = r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        status, body, headers = e.code, e.read(), e.headers
    return status, body, headers, time.perf_counter() - t0


def tiff_pages(blob: bytes):
    """The pages of a TIFF response, through the port's reader."""
    import numpy as np

    from unmicst_tpu_torch.io.tiff import TiffFile

    with tempfile.NamedTemporaryFile(suffix=".tif") as f:
        f.write(blob)
        f.flush()
        with TiffFile(f.name) as tf:
            return np.stack([tf.read_page(k) for k in range(len(tf.pages))])


def copy_bytes(fn) -> tuple:
    """(host-to-device bytes, device-to-host bytes) the card copied during
    ``fn()``: the ``bytes`` of the memcpy events of a ``torch.profiler``
    trace.  A profiled run that saw no device-to-host copy is profiled
    again (CUPTI may drop a run's events; every call here brings maps
    back)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        h2d = d2h = n_d2h = 0
        for e in events:
            name = e.get("name", "")
            if not name.startswith("Memcpy"):
                continue
            n = int((e.get("args") or {}).get("bytes", 0))
            if "HtoD" in name:
                h2d += n
            elif "DtoH" in name:
                d2h += n
                n_d2h += 1
        if n_d2h:
            return h2d, d2h
        log("[serve] the profiler saw no device-to-host copy; profiling "
            "again")
    raise RuntimeError("chip_smoke: three profiled runs saw no copy")


def pct(times, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(times) * 1e3, q))


def phase_serve(dev) -> dict:
    """``unmicst_tpu_torch.serve`` on the card over HTTP: whole, streamed,
    cached-slide pans on the pinned plane and on the host path, classes,
    pinned ranges, int8, prewarm, DELETE, concurrency; returns the row of
    K2's trimmed route."""
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from unmicst_tpu_torch import kernels, serve
    from unmicst_tpu_torch.io.slides import open_channel_source
    from unmicst_tpu_torch.io.tiff import TiffWriter

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    hp = legacy_hp()
    state = seeded_state(hp, "legacy", SEED)
    k, model = hp.n_classes, "nucleiDAPI"
    flags_before = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32,
                    torch.backends.cudnn.benchmark)

    def plane(side, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randint(0, 65536, (side, side), generator=g,
                             dtype=torch.int32).numpy().astype(np.uint16)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    httpds = []
    try:
        zoo = os.path.join(tmp, "zoo")
        write_model_dir(zoo, model, hp, state, "legacy", LEGACY_MEAN,
                        LEGACY_STD)

        def tiff(name, p):
            path = os.path.join(tmp, name)
            with TiffWriter(path, bigtiff=True) as tw:
                tw.write(p)
            with open(path, "rb") as f:
                return path, f.read()

        small = plane(SLIDE, SEED + 30)
        small_path, small_body = tiff("s4096.tif", small)
        big = plane(BIG, SEED + 31)
        big_path, big_body = tiff("s8192.tif", big)

        def start(precision):
            srv = serve.ModelServer(model_root=zoo, precision=precision)
            httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                        serve.make_handler(srv))
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            httpds.append(httpd)
            return srv, f"http://127.0.0.1:{httpd.server_address[1]}"

        f32, url32 = start("float32")
        bf16, url16 = start("bfloat16")
        i8, url8 = start("int8")
        st, body, _, _ = http("GET", url32 + "/healthz")
        health = json.loads(body)
        log(f"[serve] /healthz {st} {health} | {card}")
        check(st == 200 and health["devices"][0].startswith("cuda:0"),
              f"/healthz: {st} {health}")

        # -- the bare engines, the yardsticks (before the counted run), on
        # the server's device thread, whose cuDNN choices requests share --
        def on_card(fn, *a, **kw):
            return serve.run_on_device(dev, fn, *a, **kw)

        infer = {}
        for name, srv in (("float32", f32), ("bfloat16", bf16)):
            eng = srv.engine(model)
            infer[name] = on_card(eng.infer_slide, small)  # cuDNN autotune
            rate, med, _ = median_rate(
                lambda: on_card(eng.infer_slide, small), SLIDE * SLIDE)
            infer[name + " Mpx/s"] = rate
        stream = f32.engine(model, "stream")
        rng_pin = (0.0, 65535.0)
        with open_channel_source(big_path, "tif", 0) as src:
            on_card(stream.infer, src, stats=rng_pin)  # cuDNN autotune
            stream_full, stream_s = wall(lambda: on_card(
                stream.infer, src, stats=rng_pin))
        log(f"[serve] bare engines ({card}): infer_slide 4096^2 float32 "
            f"{infer['float32 Mpx/s']:.2f} Mpx/s, bfloat16 "
            f"{infer['bfloat16 Mpx/s']:.2f}; StreamingEngine.infer 8192^2 "
            f"float32 {BIG * BIG / 1e6 / stream_s:.2f} Mpx/s")

        # -- the main path, counted ----------------------------------------
        kernels.reset_launch_counts()
        whole = {}
        for name, url in (("float32", url32), ("bfloat16", url16)):
            walls, bodies = [], []
            for i in range(4):  # the first pays the request path's set-up
                st, body, hdr, secs = http(
                    "POST", url + f"/infer?model={model}", small_body)
                check(st == 200, f"POST /infer {name}: {st} {body[:300]}")
                walls.append(secs)
                bodies.append(body)
            check(all(b == body for b in bodies),
                  f"repeated {name} requests answered different pages")
            pages = tiff_pages(body)
            d = np.abs(pages.astype(int) - infer[name][::-1].astype(int))
            meta = json.loads(hdr["X-UnMicst-Meta"])
            rate = SLIDE * SLIDE / 1e6 / float(np.median(walls[1:]))
            whole[name] = (body, rate)
            log(f"[serve] POST /infer 4096^2 {name}: {rate:.2f} Mpx/s "
                f"(median of 3 warm requests, {walls[0]:.3f} s first; "
                f"bare engine {infer[name + ' Mpx/s']:.2f}, request/bare "
                f"{rate / infer[name + ' Mpx/s']:.3f}; server infer_s "
                f"{meta['infer_s']} s), pages vs the bare engine: max "
                f"{int(d.max())} level(s) | {card}")
            check(pages.shape == (k, SLIDE, SLIDE) and d.max() <= 1,
                  f"{name} request pages against the bare engine: "
                  f"{pages.shape}, {int(d.max())} levels")

        # the float32 request without HTTP: read, infer, encode
        direct_s, infer_s = [], []
        for _ in range(3):
            (_, meta), secs = wall(lambda: f32.infer_tiff_path(
                small_path, model, 0, True, -1))
            direct_s.append(secs)
            infer_s.append(meta["infer_s"])
        req_s = SLIDE * SLIDE / 1e6 / whole["float32"][1]
        log(f"[serve] float32 4096^2 request breakdown (medians): HTTP "
            f"request {req_s:.3f} s = ModelServer.infer_tiff_path "
            f"{np.median(direct_s):.3f} s (engine {np.median(infer_s):.3f} "
            f"s, TIFF read and encode the rest) + {req_s - np.median(direct_s):.3f}"
            f" s of HTTP (32 MB up, 50 MB down, the spool)")

        # four clients at once, float32 and bfloat16 interleaved, against
        # the same requests one at a time
        got = [None] * 4

        def client(i):
            got[i] = http("POST", (url32, url16)[i % 2]
                          + f"/infer?model={model}", small_body)[1]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        conc_s = time.perf_counter() - t0
        same = [got[i] == whole[("float32", "bfloat16")[i % 2]][0]
                for i in range(4)]
        log(f"[serve] 4 concurrent clients (2 float32, 2 bfloat16) in "
            f"{conc_s:.3f} s: pages byte-equal to serial requests {same}")
        check(all(same), f"concurrent requests differ from serial: {same}")

        # -- the cached slide: upload, pans on the card, pans on the host --
        st, body, _, up_s = http("POST", url32 + "/slides", big_body)
        sid = json.loads(body)["slide_id"]
        log(f"[serve] POST /slides 8192^2 uint16 ({len(big_body) / 1e6:.1f} "
            f"MB): {st} in {up_s:.3f} s")
        offsets = pan_offsets()

        def pan(url, r0, c0, extra=""):
            st, body, _, secs = http(
                "POST", url + f"/infer?model={model}&slide={sid}"
                f"&roi={r0},{c0},{PAN},{PAN}{extra}")
            check(st == 200, f"pan {r0},{c0}{extra}: {st} {body[:300]}")
            return tiff_pages(body), secs

        pins0 = f32.snapshot()
        first_pan, first_s = pan(url32, BIG // 2, BIG // 2)  # pins, autotunes
        dev_walls = [pan(url32, r0, c0)[1] for r0, c0 in offsets]
        after = f32.snapshot()
        check(after["device_pins"] == pins0["device_pins"] + 1
              and after["device_pans"] == pins0["device_pans"] + N_PANS + 1,
              f"device pans not counted: {pins0} -> {after}")
        r0, c0 = offsets[0]
        a, b, ca, cb = serve.roi_band((r0, c0, PAN, PAN), (BIG, BIG), hp)

        def direct(**kw):
            path = f32.acquire_slide(sid)
            try:
                return f32.infer_tiff_path(path, model, 0, True, -1,
                                           roi=(r0, c0, PAN, PAN),
                                           slide_id=sid, **kw)
            finally:
                f32.release_slide(sid)

        h2d_dev, d2h_dev = copy_bytes(direct)
        h2d_c1, d2h_c1 = copy_bytes(lambda: direct(classes=(1,)))
        f32.device_slide_bytes = 0  # the host path: bands read and uploaded
        host_walls = [pan(url32, r0, c0)[1] for r0, c0 in offsets]
        h2d_host, d2h_host = copy_bytes(direct)
        host_pan, _ = pan(url32, r0, c0)
        f32.device_slide_bytes = 2 << 30
        dev_pan, _ = pan(url32, r0, c0)
        band_px = (b - a) * (cb - ca)
        log(f"[serve] {N_PANS} pans of {PAN}^2 at seeded offsets (band "
            f"{b - a}x{cb - ca}): on the pinned plane p50 "
            f"{pct(dev_walls, 50):.2f} ms p95 {pct(dev_walls, 95):.2f} ms; "
            f"host path p50 {pct(host_walls, 50):.2f} ms p95 "
            f"{pct(host_walls, 95):.2f} ms; first pan (pin + cuDNN "
            f"autotune of the band) {first_s * 1e3:.2f} ms | {card}")
        log(f"[serve] bytes per pan (profiler memcpy events): pinned plane "
            f"H2D {h2d_dev} D2H {d2h_dev} (th*tw*K = {PAN * PAN * k}); "
            f"classes=1 H2D {h2d_c1} D2H {d2h_c1}; host path H2D {h2d_host} "
            f"(band {band_px * 2} B as uint16) D2H {d2h_host} (band maps "
            f"{band_px * k} B)")
        check(h2d_dev < 4096 and h2d_c1 < 4096,
              f"a pan on the pinned plane uploaded {h2d_dev} / {h2d_c1} B")
        check(PAN * PAN * k <= d2h_dev <= PAN * PAN * k + 4096
              and PAN * PAN <= d2h_c1 <= PAN * PAN + 4096,
              f"pan D2H {d2h_dev} / {d2h_c1} B, expected th*tw*K")
        check(np.array_equal(dev_pan, host_pan),
              "the pinned-plane pan differs from the host path's")
        check(first_pan.shape == (k, PAN, PAN), f"pan {first_pan.shape}")

        c1_walls = []
        for r0_, c0_ in offsets[:10]:
            p1, secs = pan(url32, r0_, c0_, "&classes=1")
            c1_walls.append(secs)
            check(p1.shape == (1, PAN, PAN), f"classes=1 pan {p1.shape}")
        log(f"[serve] classes=1 pans: p50 {pct(c1_walls, 50):.2f} ms p95 "
            f"{pct(c1_walls, 95):.2f} ms")

        # -- the streamed post with a pinned range, and pans against it ----
        st, body, hdr, secs = http(
            "POST", url32 + f"/infer?model={model}&range=0,65535", big_body)
        check(st == 200, f"streamed post: {st} {body[:300]}")
        full = tiff_pages(body)
        d = np.abs(full.astype(int) - stream_full[::-1].astype(int))
        log(f"[serve] streamed POST 8192^2 float32 (range=0,65535): "
            f"{BIG * BIG / 1e6 / secs:.2f} Mpx/s ({secs:.3f} s, server "
            f"infer_s {json.loads(hdr['X-UnMicst-Meta'])['infer_s']}; bare "
            f"StreamingEngine.infer {BIG * BIG / 1e6 / stream_s:.2f}), pages "
            f"vs the bare stream: max {int(d.max())} | {card}")
        check(full.shape == (k, BIG, BIG) and d.max() <= 1,
              f"streamed post {full.shape}, {int(d.max())} levels")
        worst, n_diff, n_px = 0, 0, 0
        for r0_, c0_ in offsets[:10]:
            p, _ = pan(url32, r0_, c0_, "&range=0,65535")
            crop = full[:, r0_:r0_ + PAN, c0_:c0_ + PAN]
            dd = np.abs(p.astype(int) - crop.astype(int))
            worst = max(worst, int(dd.max()))
            n_diff += int((dd > 0).sum())
            n_px += dd.size
        log(f"[serve] pinned-range pans against the streamed slide's crop "
            f"(10 pans): {n_diff} of {n_px} values differ, by at most "
            f"{worst} level(s) (bar 1)")
        check(worst <= 1, f"pinned-range pans {worst} levels from the crop")
        st, body, _, secs = http("POST", url32 + f"/infer?model={model}"
                                 "&scale=0.5", big_body)
        check(st == 200 and tiff_pages(body).shape == (k, BIG, BIG),
              f"streamed post at scale 0.5: {st}")
        log(f"[serve] streamed POST 8192^2 at scale=0.5 (host "
            f"ResampledSource): {BIG * BIG / 1e6 / secs:.2f} Mpx/s of raw "
            f"pixels ({secs:.3f} s)")

        # -- int8, prewarm, DELETE, /stats ---------------------------------
        st, body, _, secs = http("POST", url8 + f"/infer?model={model}",
                                 small_body)
        check(st == 200 and i8.engine(model)._quant is not None,
              f"int8 request: {st} {body[:300]}")
        ok8, mean8, p998, dis8 = int8_bar(tiff_pages(body),
                                          tiff_pages(whole["bfloat16"][0]))
        log(f"[serve] int8 POST /infer 4096^2 in {secs:.3f} s (calibration "
            f"included): against the bfloat16 server mean {mean8:.3f} "
            f"levels, p99 {p998:.0f}, argmax {dis8:.4f} (the JAX CLI's bar)")
        check(ok8, f"int8 server pages off: mean {mean8}, p99 {p998}, "
                   f"argmax {dis8}")

        roi_w = 3 * PAN // 4
        before = f32.snapshot()["prewarmed"]
        st, body, _, _ = http("POST", url32 + f"/slides?prewarm=1&model="
                              f"{model}&roi={roi_w}", big_body)
        check(st == 200 and json.loads(body)["prewarm"] == "scheduled",
              f"prewarm upload: {st} {body[:300]}")
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 120:
            snap = f32.snapshot()
            if snap["prewarm_pending"] == 0 and snap["prewarmed"] >= before + 4:
                break
            time.sleep(0.05)
        warm_s = time.perf_counter() - t0
        check(snap["prewarmed"] == before + 4 and not snap["prewarm_errors"],
              f"prewarm did not finish: {snap}")
        pw = []
        for r0_, c0_ in offsets[:6]:
            st, body, _, secs = http(
                "POST", url32 + f"/infer?model={model}&slide={sid}"
                f"&roi={r0_},{c0_},{roi_w},{roi_w}")
            check(st == 200, f"pan after prewarm: {st} {body[:300]}")
            pw.append(secs)
        log(f"[serve] first pan vs warm pans: without prewarm ({PAN}^2) "
            f"{first_s * 1e3:.2f} ms then p50 {pct(dev_walls, 50):.2f} ms; "
            f"with prewarm=1 ({roi_w}^2, 4 geometries warmed in "
            f"{warm_s:.2f} s) {pw[0] * 1e3:.2f} ms then p50 "
            f"{pct(pw[1:], 50):.2f} ms")

        st, body, _, _ = http("DELETE", url32 + f"/slides/{sid}")
        check(st == 200, f"DELETE: {st} {body[:200]}")
        st404 = http("DELETE", url32 + f"/slides/{sid}")[0]
        st, body, _, _ = http("GET", url32 + "/stats")
        stats = json.loads(body)
        launches = kernels.launch_counts()
        log(f"[serve] DELETE 200, again {st404}; /stats: requests "
            f"{stats['requests']} ok {stats['ok']} client_error "
            f"{stats['client_error']} device_pins {stats['device_pins']} "
            f"device_pans {stats['device_pans']} slides_cached "
            f"{stats['slides_cached']} device_planes_pinned "
            f"{stats['device_planes_pinned']} prewarmed "
            f"{stats['prewarmed']}; launches {launches}")
        check(st404 == 404 and stats["device_planes_pinned"] == 0
              and stats["slides_cached"] == 0,
              f"DELETE left the slide: {st404} {stats}")
        check(launches["softmax_blend"] > 0
              and launches["blend_fold_epilogue"] > 0
              and launches["blend_fold_epilogue_trim"] >= N_PANS
              and launches["blend_fold_stripe"] > 0,
              f"the serving path did not run every kernel: {launches}")
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32,
                 torch.backends.cudnn.benchmark)
        check(flags == flags_before,
              f"the TF32 flags changed: {flags_before} -> {flags}")
    finally:
        for h in httpds:
            h.shutdown()
            h.server_close()
        shutil.rmtree(tmp, ignore_errors=True)

    # -- K2's trimmed route at the pan's shapes, against its plain version -
    kt = k2_trim_windows(dev)
    seeded = kt["origins"]["seeded"]
    ms, dev_ms = seeded["ms"], seeded["dev_ms"]
    (bh, bw), t, err = kt["band"], kt["tiles"], kt["err"]
    crop_ok = kt["crop_ok"]
    plain_ms, lib_ms, bound, by = (kt["plain_ms"], kt["lib_ms"], kt["bound"],
                                   kt["by"])
    log(f"[K2t] trimmed region {PAN}^2 of a {bh}x{bw} band (T {t}): "
        f"max |kernel - plain| {err} level(s), equal to the untrimmed "
        f"launch's crop {crop_ok}; kernel {ms:.4f} ms (device {dev_ms:.4f}) "
        f"| plain {plain_ms:.4f} | F.fold {lib_ms:.4f} | bound {bound:.4f} "
        f"({by}) | {card}")
    log("[K2t] " + "; ".join(
        f"{name}: canvas column origin {o['c0']} (c0 % 4 = {o['c0'] % 4}), "
        f"{o['cols']} columns a thread, kernel {o['ms']:.4f} ms, device "
        f"{o['dev_ms']:.4f}" for name, o in kt["origins"].items())
        + f"; seeded device / bound {bound / dev_ms:.3f}; pans p50 "
        f"{pct(dev_walls, 50):.2f} ms | {card}")
    check(err == 0 and crop_ok,
          f"K2's trimmed route: {err} levels from plain, crop {crop_ok}")
    check(all(o["cols"] == 4 for o in kt["origins"].values()),
          f"K2's trimmed window left the vector path: {kt['origins']}")
    log(f"[serve] phase {time.perf_counter() - t_phase:.1f}s")
    return {"blend_fold_epilogue_trim": dict(
        route="cuda", source="unmicst_tpu_torch/csrc/blend_fold.cu",
        replaces="exhibits/pallas/blend.py:76",
        launches=launches["blend_fold_epilogue_trim"], max_abs_err=float(err),
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=lib_ms)}


# -- phase 12: multi-process and tensor parallelism -------------------------------

MP_WORLD = 2  # processes of phase 12
MP_TIMEOUT_S = 480  # a phase-12 worker's limit


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def step_ms(fn, reps: int = 5) -> float:
    """Median host wall of ``fn()`` in ms, the card synchronised."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[reps // 2]


def train_batch(hp, dev, seed: int) -> dict:
    """A seeded NCHW batch of ``hp.batch_size`` on ``dev``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    b, s, k = hp.batch_size, hp.im_size, hp.n_classes
    arrays = {
        "image": rng.rand(b, hp.n_channels, s, s).astype(np.float32),
        "labels": np.eye(k, dtype=np.float32)[rng.randint(0, k, (b, s, s))]
        .transpose(0, 3, 1, 2),
        "weights": rng.uniform(1, 5, (b, k, s, s)).astype(np.float32),
    }
    return {n: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for n, v in arrays.items()}


def step_agrees(label: str, m_one, one, m_mesh, mesh_trainer) -> None:
    """Phase 9's card bar between a one-device step and a mesh
    step: loss within 1e-4 relative, Adam's first moment (0.1 g) within
    5e-2 of each tensor's norm, the zero slots equal."""
    import torch

    mu_one = one.opt_state.slots["mu"]
    mu_mesh = mesh_trainer._full_opt_state().slots["mu"]
    worst, name, zeros = 0.0, "", True
    for k, v in mu_one.items():
        v, w = v.float().cpu(), mu_mesh[k].float().cpu()
        norm = float(v.norm())
        if norm == 0:
            zeros &= bool(torch.equal(v, w))
            continue
        r = float((w - v).norm()) / norm
        if r > worst:
            worst, name = r, k
    l1, l2 = float(m_one["loss"]), float(m_mesh["loss"])
    log(f"[mp] {label}: loss {l2:.7f} vs one device {l1:.7f} (rel "
        f"{abs(l2 - l1) / l1:.2e}, bar 1e-4); mu |d|/|mu| at most "
        f"{worst:.2e} ({name}, bar 5e-2); zero slots equal {zeros}")
    check(abs(l2 - l1) <= 1e-4 * abs(l1) and worst <= 5e-2 and zeros,
          f"{label}: the mesh step disagrees with the one-device step")


def mp_ring(span, rank: int, world: int, dev) -> dict:
    """K3 and K4a/K4b across the processes on the seam buffers of a
    4096^2 slide (and an odd int16 one), three hops each way, against the
    buffer ``ppermute`` delivers (its sender's seeded tensor, made here
    too); the hop's event ms."""
    import torch

    from unmicst_tpu_torch import kernels
    from unmicst_tpu_torch.core import tiler
    from unmicst_tpu_torch.kernels import halo_ring

    hp = legacy_hp()
    grid = tiler.make_grid(SLIDE, SLIDE, hp.im_size, hp.margin)
    two_m, wp = 2 * hp.margin, grid.padded_width
    shapes = [((two_m, wp, 1), torch.float32), ((two_m, wp, 3), torch.float32),
              ((7, 13), torch.int16)]

    def buf(r, shape, dtype, key):
        g = torch.Generator(device=dev).manual_seed(SEED + 1000 * key + r)
        if dtype.is_floating_point:
            return torch.randn(shape, generator=g, device=dev, dtype=dtype)
        return torch.randint(-30000, 30000, shape, generator=g, device=dev,
                             dtype=dtype)

    kernels.reset_launch_counts()
    same, hops = True, 0
    for k, (shape, dtype) in enumerate(shapes):
        for shift in (1, -1):
            for rep in range(3):
                key = 10 * k + rep + (5 if shift < 0 else 0)
                xs = [None] * world
                xs[rank] = buf(rank, shape, dtype, key)
                want = buf((rank - shift) % world, shape, dtype, key)
                got = kernels.ring_shift(xs, shift, kind="output",
                                         span=span)[rank]
                pair = kernels.ring_shift_wait(kernels.ring_shift_start(
                    xs, shift, span=span))[rank]
                same &= torch.equal(got, want) and torch.equal(pair, want)
                hops += 1
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    xs = [None] * world
    xs[rank] = buf(rank, shapes[1][0], torch.float32, 99)
    ms3 = cuda_ms(lambda: kernels.ring_shift(xs, 1, kind="output",
                                             span=span))
    ms4 = cuda_ms(lambda: kernels.ring_shift_wait(
        kernels.ring_shift_start(xs, 1, span=span)))
    plain = "refused"
    if span.backend == "gloo":
        try:
            halo_ring.ring_shift_plain(xs, 1, span)
            plain = "ran"
        except RuntimeError as e:
            plain = "refused" if "halo_impl='ring'" in str(e) else str(e)
    else:
        plain_ms = cuda_ms(lambda: halo_ring.ring_shift_plain(xs, 1, span))
        ref = halo_ring.ring_shift_plain(xs, 1, span)[rank]
        got = kernels.ring_shift(xs, 1, kind="output", span=span)[rank]
        plain = f"equal {torch.equal(ref, got)}, {plain_ms:.4f} ms"
    return {"same": bool(same), "hops": hops, "launches": launches,
            "k3_ms": ms3, "k4_ms": ms4, "plain": plain,
            "nbytes": xs[rank].numel() * 4}


def mp_halo(mesh, dev) -> dict:
    """``spatial_infer`` over a seeded 4096^2 plane at nucleiDAPI's widths
    across the processes, ``ring`` and ``ring_overlap``, against this
    process's ``InferenceEngine.infer``."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import kernels
    from unmicst_tpu_torch.infer import InferenceEngine
    from unmicst_tpu_torch.runtime import halo

    hp = legacy_hp()
    state = seeded_state(hp, "legacy", SEED)
    plane = torch.rand((SLIDE, SLIDE), generator=torch.Generator()
                       .manual_seed(SEED + 2)).numpy()
    canvas = halo.build_canvas(plane, hp, mesh.data)
    single = InferenceEngine(hp, state, "legacy", LEGACY_MEAN, LEGACY_STD,
                             device=dev).infer(plane)
    out = {}
    impls = ["ring", "ring_overlap"] + (
        ["ppermute"] if mesh.backend == "nccl" else [])
    for impl in impls:
        run = lambda: halo.spatial_infer(  # noqa: E731
            state, canvas, SLIDE, SLIDE, hp, "legacy", mesh,
            mean=LEGACY_MEAN, std=LEGACY_STD, halo_impl=impl)
        run()  # cuDNN autotune at these shapes
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = got.cpu().numpy()
        out[impl] = {
            "err": float(np.abs(np.moveaxis(got, -1, 0) - single).max()),
            "finite": bool(np.isfinite(got).all()), "wall": wall,
            "launches": kernels.launch_counts()}
    if mesh.backend == "gloo":
        try:
            halo.spatial_infer(state, canvas, SLIDE, SLIDE, hp, "legacy",
                               mesh, mean=LEGACY_MEAN, std=LEGACY_STD,
                               halo_impl="ppermute")
            out["ppermute"] = "ran"
        except RuntimeError as e:
            out["ppermute"] = ("refused" if "halo_impl='ring'" in str(e)
                               else str(e))
    return out


def mp_stream(mesh, dev) -> dict:
    """``infer_sharded`` of a seeded 8192^2 slide across the processes
    against this process's ``StreamingEngine.infer``."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import kernels
    from unmicst_tpu_torch.runtime.pipeline import StreamingEngine

    hp = legacy_hp()
    state = seeded_state(hp, "legacy", SEED)
    g = torch.Generator().manual_seed(SEED + 3)
    raw = torch.randint(0, 65536, (BIG, BIG), generator=g,
                        dtype=torch.int32).numpy().astype(np.uint16)
    stream = StreamingEngine(hp, state, "legacy", LEGACY_MEAN, LEGACY_STD,
                             compute_dtype=None, device=dev)
    ref = stream.infer(raw)
    stream.infer_sharded(raw, mesh)  # cuDNN autotune at the band shapes
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = stream.infer_sharded(raw, mesh)
    secs = time.perf_counter() - t0
    d = np.abs(got.astype(int) - ref.astype(int))
    return {"max": int(d.max()), "frac": float((d > 0).mean()),
            "secs": secs, "stripes": stream._plan(BIG, BIG).n_stripes,
            "launches": kernels.launch_counts()}


def mp_train(mesh, dev) -> dict:
    """The DP step at nucleiDAPI1-5's widths over the processes' ranks
    (batch 32, dropout on) against the one-device step on this card."""
    import torch

    from unmicst_tpu_torch import train as tr
    from unmicst_tpu_torch.core.unet import init_params

    hp = v2_default_hp()
    base = tr.TrainConfig.for_variant("v2", export_tf1=False)
    state = init_params(hp, "v2", torch.Generator().manual_seed(SEED))
    b = train_batch(hp, dev, SEED + 5)
    one = tr.Trainer(hp, base, "unused", params=state, device=dev)
    m1 = one.train_step(one.model, one.opt_state, b,
                        torch.Generator().manual_seed(SEED + 6))
    dp = tr.Trainer(hp, base, "unused", params=state, mesh=mesh)
    m2 = dp.train_step(dp.rank_models, dp.opt_state, b,
                       torch.Generator().manual_seed(SEED + 6))
    mu_one = one.opt_state.slots["mu"]
    mu_dp = dp._full_opt_state().slots["mu"]
    mu = {k: [float((mu_dp[k].float() - v.float()).norm()),
              float(v.float().norm()), bool(torch.equal(mu_dp[k], v))]
          for k, v in mu_one.items()}
    ms = step_ms(lambda: dp.train_step(dp.rank_models, dp.opt_state, b,
                                       None))
    return {"loss": float(m2["loss"]), "loss_one": float(m1["loss"]),
            "mu": mu, "ms": ms}


def mp_worker(rank: str, port: str, world: str, backend: str,
              out_path: str) -> int:
    """One process of phase 12: joins the job, runs :func:`mp_ring`,
    :func:`mp_halo`, :func:`mp_stream` and :func:`mp_train` on a mesh of
    one rank per process, writes their results as JSON."""
    import torch

    from unmicst_tpu_torch.runtime.mesh import (initialize_distributed,
                                                make_mesh,
                                                shutdown_distributed)

    rank, world = int(rank), int(world)
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    initialize_distributed(f"localhost:{port}", world, rank, backend=backend,
                           device=dev, timeout_s=MP_TIMEOUT_S)
    try:
        mesh = make_mesh(devices=[dev])
        res = {"backend": backend, "device": str(dev),
               "ring": mp_ring(mesh.span(), rank, world, dev),
               "halo": mp_halo(mesh, dev), "stream": mp_stream(mesh, dev),
               "train": mp_train(mesh, dev)}
    finally:
        shutdown_distributed()
    with open(out_path, "w") as f:
        json.dump(res, f)
    return 0


def run_workers(backend: str, tmp: str) -> list:
    """:data:`MP_WORLD` phase-12 workers of ``backend``; their results
    (every worker stopped before this returns)."""
    port = str(free_port())
    procs = []
    for r in range(MP_WORLD):
        out = os.path.join(tmp, f"{backend}{r}.json")
        logf = open(os.path.join(tmp, f"{backend}{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), "--mp-worker",
             str(r), port, str(MP_WORLD), backend, out],
            stdout=logf, stderr=subprocess.STDOUT, cwd=ROOT), out, logf))
    t0 = time.perf_counter()
    try:
        for p, _, _ in procs:
            p.wait(timeout=max(1.0, MP_TIMEOUT_S
                               - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, _, logf in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            logf.close()
    results = []
    for r, (p, out, _) in enumerate(procs):
        if p.returncode != 0 or not os.path.exists(out):
            with open(os.path.join(tmp, f"{backend}{r}.log")) as f:
                tail = f.read()[-4000:]
            check(False, f"phase 12 {backend} worker {r} failed (rc "
                         f"{p.returncode}):\n{tail}")
        with open(out) as f:
            results.append(json.load(f))
    return results


def report_workers(backend: str, res: list, one_ms: float, card: str
                   ) -> None:
    """Log and check the phase-12 workers' results of ``backend``."""
    for r, w in enumerate(res):
        ring, hl, st, trn = w["ring"], w["halo"], w["stream"], \
            w["train"]
        lr = ring["launches"]
        log(f"[mp] {backend} rank {r} ({w['device']}): K3/K4 across "
            f"processes bit-equal {ring['same']} over {ring['hops']} "
            f"hops each (3 shapes x 2 shifts x 3); launches K3 "
            f"{lr['ring_shift']}, K4a {lr['ring_shift_start']}, K4b "
            f"{lr['ring_shift_wait']}; hop of {ring['nbytes']} B: K3 "
            f"{ring['k3_ms']:.4f} ms, K4a+K4b {ring['k4_ms']:.4f} ms "
            f"(events); ppermute {ring['plain']} | {card}")
        check(ring["same"], f"{backend} rank {r}: K3/K4 across "
              "processes differ from ppermute")
        check(lr["ring_shift"] > 0 and lr["ring_shift_start"] > 0
              and lr["ring_shift_wait"] > 0,
              f"{backend} rank {r}: ring launches {lr}")
        if backend == "gloo":
            check(ring["plain"] == "refused"
                  and hl["ppermute"] == "refused",
                  f"ppermute over gloo on a card did not refuse: "
                  f"{ring['plain']} / {hl['ppermute']}")
        for impl, h in hl.items():
            if not isinstance(h, dict):
                continue
            la = h["launches"]
            log(f"[mp] {backend} rank {r}: spatial_infer {impl} 4096^2 "
                f"across processes: wall {h['wall']:.3f} s, max |halo "
                f"- engine| {h['err']:.3e} (bar 2e-5), launches "
                f"{ {k: v for k, v in la.items() if v} } | {card}")
            check(h["finite"] and h["err"] <= 2e-5,
                  f"{backend} rank {r} {impl}: {h['err']}")
            check(la["softmax_blend"] > 0
                  and la["blend_fold_strip"] > 0
                  and (la["ring_shift"] > 0 or impl == "ppermute"),
                  f"{backend} rank {r} {impl}: launches {la}")
            if impl == "ring_overlap":
                check(la["ring_shift_start"] > 0
                      and la["ring_shift_wait"] > 0,
                      f"ring_overlap launches {la}")
        ls = st["launches"]
        log(f"[mp] {backend} rank {r}: infer_sharded 8192^2 across "
            f"processes: {st['secs']:.3f} s ({BIG * BIG / 1e6 / st['secs']:.2f}"
            f" Mpx/s), max {st['max']} level(s) from infer on "
            f"{st['frac']:.2e} of values; K3 {ls['ring_shift']} "
            f"launches over {st['stripes']} stripes, K2 stripe "
            f"{ls['blend_fold_stripe']}, K1 {ls['softmax_blend']} | "
            f"{card}")
        check(st["max"] <= 1 and ls["ring_shift"] > 0
              and ls["blend_fold_stripe"] > 0
              and ls["softmax_blend"] > 0,
              f"{backend} rank {r}: sharded stream {st}")
        worst = max((d / n, k) for k, (d, n, _) in trn["mu"].items()
                    if n > 0)
        zeros = all(eq for d, n, eq in trn["mu"].values() if n == 0)
        rel = abs(trn["loss"] - trn["loss_one"]) / trn["loss_one"]
        log(f"[mp] {backend} rank {r}: DP step over {MP_WORLD} "
            f"processes, batch 32: loss {trn['loss']:.7f} vs one "
            f"device {trn['loss_one']:.7f} (rel {rel:.2e}, bar 1e-4);"
            f" mu |d|/|mu| at most {worst[0]:.2e} ({worst[1]}, bar "
            f"5e-2); zero slots equal {zeros}; step {trn['ms']:.3f} "
            f"ms (one device {one_ms:.3f} ms) | {card}")
        check(rel <= 1e-4 and worst[0] <= 5e-2 and zeros,
              f"{backend} rank {r}: the DP step disagrees")
    check(res[0]["train"]["loss"] == res[1]["train"]["loss"],
          f"{backend}: the processes see different losses")


def phase_multiprocess(dev) -> dict:
    """Tensor parallelism on the card in this process, then the workers:
    two processes sharing the card over gloo (and one per card over NCCL
    when there are two).  Returns the K3/K4a/K4b rows' cross-process
    numbers."""
    import torch

    from unmicst_tpu_torch import train as tr
    from unmicst_tpu_torch.core.unet import init_params
    from unmicst_tpu_torch.runtime.mesh import make_mesh

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # -- TP: make_mesh(data=1, model=2), both ranks on this card ------------
    hp = v2_default_hp()
    base = tr.TrainConfig.for_variant("v2", export_tf1=False)
    state = init_params(hp, "v2", torch.Generator().manual_seed(SEED))
    b = train_batch(hp, dev, SEED + 5)
    one = tr.Trainer(hp, base, "unused", params=state, device=dev)
    m1 = one.train_step(one.model, one.opt_state, b,
                        torch.Generator().manual_seed(SEED + 6))
    mesh = make_mesh(data=1, model=2, devices=[dev, dev])
    tp = tr.Trainer(hp, base, "unused", params=state, mesh=mesh)
    split = sorted(n for n, d in tp.spec.items() if d is not None)
    m2 = tp.train_step(tp.rank_models, tp.opt_state, b,
                       torch.Generator().manual_seed(SEED + 6))
    log(f"[mp] TP make_mesh(data=1, model=2) on one card, nucleiDAPI1-5 "
        f"widths (v2, {hp.im_size} px, nOut0 {hp.n_out0}, {hp.n_layers} "
        f"layers, batch {hp.batch_size}): {len(split)} tensors split "
        f"({', '.join(n for n in split if n.endswith('kernel1'))} ...)")
    step_agrees("TP step", m1, one, m2, tp)
    one_ms = step_ms(lambda: one.train_step(one.model, one.opt_state, b,
                                            None))
    tp_ms = step_ms(lambda: tp.train_step(tp.rank_models, tp.opt_state, b,
                                          None))
    check("bottom.kernel1" in split, f"the 1280-wide bottom is not split: "
          f"{split}")
    log(f"[mp] step ms (median of 5, host wall, synchronised): one device "
        f"{one_ms:.3f}, TP over 2 ranks of the card {tp_ms:.3f} | {card}")
    del one, tp
    torch.cuda.empty_cache()

    # -- the workers ----------------------------------------------------------
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2
                           else [])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    rows = {}
    try:
        for backend in backends:
            t0 = time.perf_counter()
            res = run_workers(backend, tmp)
            where = ("2 processes sharing cuda:0" if backend == "gloo"
                     else "1 process per card")
            log(f"[mp] {backend}, {where}: workers {time.perf_counter() - t0:.1f}"
                f" s")
            report_workers(backend, res, one_ms, card)
            r0 = res[0]["ring"]
            rows[backend] = {
                "ring_shift": (r0["launches"]["ring_shift"], r0["k3_ms"]),
                "ring_shift_start": (r0["launches"]["ring_shift_start"],
                                     r0["k4_ms"]),
                "ring_shift_wait": (r0["launches"]["ring_shift_wait"],
                                    r0["k4_ms"])}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[mp] phase {time.perf_counter() - t_phase:.1f}s")
    return rows["gloo"]


# -- phase 13: slide formats ---------------------------------------------------------


def _czi_segment(f, sid: bytes, payload: bytes) -> int:
    """Append one 32-byte-aligned ZISRAW segment; returns its offset."""
    pos = f.tell()
    alloc = -(-len(payload) // 32) * 32
    f.write(struct.pack("<16sqq", sid, alloc, len(payload)) + payload
            + bytes(alloc - len(payload)))
    return pos


def _czi_entry(pos: int, compression: int, dims: dict,
               pixel_type: int = 1) -> bytes:
    """A ``DirectoryEntryDV``: ``pixel_type`` (1 Gray16, 0 Gray8), one
    (start, size) per dimension, stored at full size."""
    out = (b"DV" + struct.pack("<iqii", pixel_type, pos, 0, compression)
           + bytes(6) + struct.pack("<i", len(dims)))
    for name, (start, size) in dims.items():
        out += struct.pack("<4siifi", name.encode(), start, size,
                           float(start), size)
    return out


def write_czi_blocks(path: str, blocks, compression: int,
                     pixel_type: int = 1, channel_names=None) -> None:
    """A one-scene CZI (ZISRAW) of ``blocks``, ``(dims, payload)`` pairs
    already encoded for ``compression``; with ``channel_names`` a metadata
    segment that names the channels."""
    header = (struct.pack("<ii8x16s16si", 1, 0, bytes(16), bytes(16), 0)
              + struct.pack("<qqiq", 0, 0, 0, 0))
    entries = []
    with open(path, "wb") as f:
        _czi_segment(f, b"ZISRAWFILE", header)
        for dims, pix in blocks:
            e = _czi_entry(0, compression, dims, pixel_type)
            head = struct.pack("<iiq", 0, 0, len(pix)) + e
            pos = _czi_segment(f, b"ZISRAWSUBBLOCK", head + bytes(
                max(256, len(e) + 16) - len(head)) + pix)
            entries.append(_czi_entry(pos, compression, dims, pixel_type))
        dir_pos = _czi_segment(f, b"ZISRAWDIRECTORY", struct.pack(
            "<i", len(entries)) + bytes(124) + b"".join(entries))
        meta_pos = 0
        if channel_names:
            xml = ("<ImageDocument><Metadata><Information><Image>"
                   "<Dimensions><Channels>" + "".join(
                       f'<Channel Id="Channel:{i}" Name="{n}"/>'
                       for i, n in enumerate(channel_names))
                   + "</Channels></Dimensions></Image></Information>"
                   "</Metadata></ImageDocument>").encode()
            meta_pos = _czi_segment(f, b"ZISRAWMETADATA", struct.pack(
                "<ii", len(xml), 0) + bytes(248) + xml)
        f.seek(32 + 52)
        f.write(struct.pack("<qq", dir_pos, meta_pos))


def write_czi(path: str, plane, block: int, compression: int = 0,
              hilo: bool = False, channel_names=None) -> None:
    """A one-channel, one-scene CZI (ZISRAW) of a uint16 ``plane`` in
    ``block`` x ``block`` mosaic sub-blocks: uncompressed (0), zstd0 (5)
    or zstd1 (6, with hi-lo byte packing when ``hilo``), the frames made
    by the port's ``io/zstd.compress``; with ``channel_names`` a metadata
    segment that names the channels."""
    import numpy as np

    from unmicst_tpu_torch.io import zstd

    h, w = plane.shape
    blocks = []
    for r0 in range(0, h, block):
        for c0 in range(0, w, block):
            piece = np.ascontiguousarray(plane[r0:r0 + block,
                                               c0:c0 + block])
            pix = piece.astype("<u2").tobytes()
            if compression in (5, 6):
                if hilo:
                    b = np.frombuffer(pix, np.uint8).reshape(-1, 2)
                    pix = b[:, 0].tobytes() + b[:, 1].tobytes()
                pix = zstd.compress(pix, 3)
                if compression == 6:
                    pix = (b"\x03\x01\x01" if hilo else b"\x01") + pix
            blocks.append(({"X": (c0, piece.shape[1]),
                            "Y": (r0, piece.shape[0]), "C": (0, 1)}, pix))
    write_czi_blocks(path, blocks, compression, 1, channel_names)


def write_nd2(path: str, frame) -> None:
    """A one-frame ND2 (chunk map) of a uint16 ``[H, W, components]``
    frame, the components interleaved."""
    h, w, comp = frame.shape
    sig = b"ND2 CHUNK MAP SIGNATURE 0000001!"

    def chunk(name: bytes, data: bytes) -> bytes:
        return struct.pack("<IIQ", 0x0ABECEDA, len(name), len(data)) + name \
            + data

    def lv(name: str, value: int) -> bytes:
        return (struct.pack("<BB", 3, len(name)) + name.encode("utf-16-le")
                + struct.pack("<I", value))

    attrs = (lv("uiWidth", w) + lv("uiHeight", h) + lv("uiComp", comp)
             + lv("uiBpcInMemory", 16))
    offsets = []
    with open(path, "wb") as f:
        for name, data in ((b"ImageAttributesLV!", attrs),
                           (b"ImageDataSeq|0!", struct.pack("<d", 0.0)
                            + frame.astype("<u2").tobytes())):
            offsets.append((name, f.tell()))
            f.write(chunk(name, data))
        map_pos = f.tell()
        f.write(chunk(sig, b"".join(n + struct.pack("<QQ", o, 0)
                                    for n, o in offsets)
                      + sig + struct.pack("<QQ", 0, 0)))
        f.write(sig + struct.pack("<Q", map_pos))


def phase_formats(dev) -> dict:
    """Pyramid input and output, zstd, CZI and ND2 through ``cli.main``
    and the server on the card, and a model directory whose bundle is not
    ``model.ckpt``; returns, per kernel, its launches on each path."""
    import dataclasses
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels, serve
    from unmicst_tpu_torch.core.checkpoint import save_tf1_params
    from unmicst_tpu_torch.core.hp import save_pickle
    from unmicst_tpu_torch.io import preprocess as pp
    from unmicst_tpu_torch.io import slides, zstd
    from unmicst_tpu_torch.io.tiff import (TiffFile, TiffWriter,
                                           _box_downsample2, imread, imwrite,
                                           num_pages)

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    hp = legacy_hp()
    state = seeded_state(hp, "legacy", SEED)
    have_zstd = zstd.available()
    log(f"[formats] host libzstd: {'found' if have_zstd else 'ABSENT'}")
    launches = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_formats_")
    httpd = None
    try:
        zoo = os.path.join(tmp, "zoo")
        write_model_dir(zoo, "nucleiDAPI", hp, state, "legacy", LEGACY_MEAN,
                        LEGACY_STD)
        base = ["--tool", "unmicst-legacy", "--model", "nucleiDAPI",
                "--modelRoot", zoo, "--stackOutput"]

        def out_file(out, kind):
            sub = os.path.join(out, "qc") if kind == "Preview" else out
            (name,) = [f for f in os.listdir(sub) if f"_{kind}_" in f]
            return os.path.join(sub, name)

        def run(src, name, *flags, count=None):
            """``cli.main`` on the card: (map pages, preview pages,
            seconds); ``count`` names the path whose K1/K2 launches this
            run records (the counters set to 0 just before it), and logs
            the run's ``--stats`` line."""
            out = os.path.join(tmp, "out", name)
            if count:
                kernels.reset_launch_counts()
            err = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                rc = cli.main([src, *base, "--outputPath", out, "--stats",
                               *flags])
            secs = time.perf_counter() - t0
            if count:
                launches[count] = kernels.launch_counts()
                log(f"[formats] {count}: " + " ".join(
                    ln.split("] ", 1)[-1] for ln in
                    err.getvalue().splitlines() if "total" in ln))
            check(rc == 0, f"cli.main {name}: rc {rc}\n{err.getvalue()}")
            maps, prev = out_file(out, "Probabilities"), out_file(out,
                                                                  "Preview")
            return ([imread(maps, k) for k in range(num_pages(maps))],
                    [imread(prev, k) for k in range(num_pages(prev))], secs)

        def same(a, b) -> bool:
            return len(a) == len(b) and all(
                x.shape == y.shape and np.array_equal(x, y)
                for x, y in zip(a, b))

        def rate(nbytes, secs):
            return f"{nbytes / 1e6 / secs:.1f} MB/s"

        def n_levels_of(side):  # write_pyramid's count at min_size 256
            n = 0
            while side >= 512:
                side, n = side // 2, n + 1
            return n

        # -- 1. zstd ----------------------------------------------------------
        if not have_zstd:
            zczi = os.path.join(tmp, "z.czi")
            write_czi(zczi, np.zeros((64, 64), np.uint16), 64)
            with open(zczi, "r+b") as f:  # the sub-block claims zstd0
                blob = f.read()
                at = blob.index(b"DV")
                while at >= 0:
                    f.seek(at + 2 + 4 + 8 + 4)
                    f.write(struct.pack("<i", 5))
                    at = blob.find(b"DV", at + 2)
            refusals = {
                "TiffWriter(compression='zstd')": lambda: TiffWriter(
                    os.path.join(tmp, "z.tif"), compression="zstd"),
                "zstd.decompress": lambda: zstd.decompress(b"\x28\xb5", 8),
                "zstd CZI sub-blocks": lambda: slides.open_channel_source(
                    zczi, "czi", 0),
                "cli --compressOutput zstd": lambda: cli.main(
                    [zczi, *base, "--outputPath", os.path.join(tmp, "z"),
                     "--compressOutput", "zstd"]),
            }
            held = {}
            for what, fn in refusals.items():
                try:
                    fn()
                    held[what] = False
                except (NotImplementedError, SystemExit) as e:
                    held[what] = "M14b" in str(e)
            log(f"[formats] libzstd absent: the zstd cases did NOT run; "
                f"the zstd paths refused naming ROADMAP M14b: {held}")
            check(all(held.values()), f"a zstd path did not refuse: {held}")
        codec = "zstd" if have_zstd else None
        czi_comp = 6 if have_zstd else 0

        # -- 2. a pyramidal 8192^2 slide through --usePyramid -----------------
        rng = np.random.RandomState(SEED + 40)
        big = (np.clip(blob_slide(rng, BIG, BIG, 40000), 0, 1)
               * 65535).astype(np.uint16)
        pyr = os.path.join(tmp, "pyr.tif")
        t0 = time.perf_counter()
        with TiffWriter(pyr, compression=codec) as tw:
            n_levels = tw.write_pyramid(big, tile=(256, 256))
        pyr_write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        level = slides.read_channel_level(pyr, "tif", 0, 0)
        level_read_s = time.perf_counter() - t0
        check(level.shape == (SLIDE, SLIDE), f"level 0 is {level.shape}")
        lvl = os.path.join(tmp, "lvl.tif")
        imwrite(lvl, level)
        _, h2d_s = wall(lambda: torch.from_numpy(level).to(dev))
        log(f"[formats] write_pyramid {BIG}^2 uint16 ({codec or 'none'}, "
            f"256^2 tiles): {n_levels} levels in {pyr_write_s:.2f} s; the "
            f"{SLIDE}^2 level decoded in {level_read_s:.3f} s "
            f"({rate(level.nbytes, level_read_s)}), its pageable H2D "
            f"{h2d_s * 1e3:.2f} ms | {card}")
        p_maps, p_prev, p_secs = run(pyr, "pyr", "--usePyramid",
                                     "--scalingFactor", "0.5",
                                     count="pyramid_cli")
        l_maps, l_prev, _ = run(lvl, "lvl")
        t0 = time.perf_counter()
        up_maps = [pp.upscale_pm(p, (BIG, BIG)) for p in l_maps]
        up_s = time.perf_counter() - t0
        up_prev = [pp.upscale_pm(p, (BIG, BIG)) for p in l_prev]
        f_maps, _, f_secs = run(pyr, "full", "--scalingFactor", "0.5",
                                "--engine", "whole")
        n = launches["pyramid_cli"]
        fd = level_diff(p_maps, f_maps)
        log(f"[formats] cli --usePyramid --scalingFactor 0.5 on the {BIG}^2 "
            f"pyramid: {p_secs:.2f} s ({BIG * BIG / 1e6 / p_secs:.2f} Mpx/s "
            f"of raw pixels; the 3 maps' host upscale_pm to {BIG}^2 "
            f"{up_s:.2f} s of it), against the full-resolution "
            f"--scalingFactor 0.5 --engine whole run {f_secs:.2f} s "
            f"({BIG * BIG / 1e6 / f_secs:.2f} Mpx/s; maps of the stored "
            f"box-mean level vs the card's gaussian resize: max {fd[0]} "
            f"levels, {fd[1] + fd[2]} pixels apart); K1 "
            f"{n['softmax_blend']} launches, K2 {n['blend_fold_epilogue']}; "
            f"pages byte-equal to --scalingFactor 1 on the level plane as "
            f"a plain TIFF, upscaled: {same(p_maps, up_maps)}, preview "
            f"{same(p_prev, up_prev)} | {card}")
        check(n["softmax_blend"] > 0 and n["blend_fold_epilogue"] == 1,
              f"--usePyramid did not run K1 and one K2 epilogue: {n}")
        check(same(p_maps, up_maps) and same(p_prev, up_prev),
              "--usePyramid pages differ from the level plane's run")

        # -- 3 and 4. CZI and ND2 4096^2 (whole engine), output codecs -------
        plane = np.ascontiguousarray(big[:SLIDE, :SLIDE])
        mb = plane.nbytes
        tif = os.path.join(tmp, "s.tif")
        imwrite(tif, plane)
        t_maps, _, t_secs = run(tif, "tif")
        czi = os.path.join(tmp, "s.czi")
        write_czi(czi, plane, 1024, czi_comp, hilo=True,
                  channel_names=["DNA"])
        t0 = time.perf_counter()
        got = slides.read_channel(czi, "czi", 0)
        czi_read_s = time.perf_counter() - t0
        check(np.array_equal(got, plane), "the CZI reads other pixels")
        c_maps, _, c_secs = run(czi, "czi", "--channelName", "DNA",
                                count="czi_whole")
        nd2 = os.path.join(tmp, "s.nd2")
        write_nd2(nd2, np.stack([big[SLIDE:, :SLIDE], plane], -1))
        t0 = time.perf_counter()
        got = slides.read_channel(nd2, "nd2", 1)
        nd2_read_s = time.perf_counter() - t0
        check(np.array_equal(got, plane), "the ND2 reads other pixels")
        n_maps, _, n_secs = run(nd2, "nd2", "--channel", "2", count="nd2")
        kind = "zstd1 hi-lo" if have_zstd else "uncompressed"
        log(f"[formats] {SLIDE}^2 through cli.main: TIFF {t_secs:.2f} s, CZI "
            f"({kind}, 1024^2 mosaic blocks, --channelName) "
            f"{c_secs:.2f} s, read {rate(mb, czi_read_s)}; ND2 (2 "
            f"components, --channel 2) {n_secs:.2f} s, read "
            f"{rate(mb, nd2_read_s)}; pages byte-equal to the TIFF's: CZI "
            f"{same(c_maps, t_maps)}, ND2 {same(n_maps, t_maps)}; launches "
            f"CZI {launches['czi_whole']['softmax_blend']} K1 / "
            f"{launches['czi_whole']['blend_fold_epilogue']} K2, ND2 "
            f"{launches['nd2']['softmax_blend']} / "
            f"{launches['nd2']['blend_fold_epilogue']} | {card}")
        for name in ("czi_whole", "nd2"):
            n = launches[name]
            check(n["softmax_blend"] > 0 and n["blend_fold_epilogue"] == 1,
                  f"{name} did not run K1 and one K2 epilogue: {n}")
        check(same(c_maps, t_maps) and same(n_maps, t_maps),
              "CZI or ND2 pages differ from the same pixels as a TIFF")
        out_codec = ["--compressOutput"] + (["zstd"] if have_zstd else [])
        o_maps, _, _ = run(czi, "czi_out", "--channelName", "DNA",
                           "--pyramidOutput", *out_codec)
        with TiffFile(out_file(os.path.join(tmp, "out", "czi_out"),
                               "Probabilities")) as tf:
            tags = {(p.compression, p.tiled, len(p.subifds)) for p in
                    tf.pages}
            lv = [tf.read_subifd(0, k) for k in range(len(tf.pages[0].subifds))]
        write_s = {}
        for c in (None, "deflate") + (("zstd",) if have_zstd else ()):
            path = os.path.join(tmp, f"w_{c}.tif")
            t0 = time.perf_counter()
            for k, m in enumerate(c_maps):
                imwrite(path, m, append=k > 0, compression=c, pyramid=True)
            write_s[c or "none"] = round(time.perf_counter() - t0, 3)
        log(f"[formats] --pyramidOutput {' '.join(out_codec)} pages "
            f"(compression, tiled, levels) {tags}, read back by the port's "
            f"reader equal to the uncompressed pages: {same(o_maps, c_maps)}; "
            f"write of the three {SLIDE}^2 maps, pyramidal, seconds by codec "
            f"{write_s} | {card}")
        check(same(o_maps, c_maps) and len(tags) == 1
              and next(iter(tags))[2] == n_levels_of(SLIDE)
              and np.array_equal(lv[0], _box_downsample2(c_maps[0])),
              f"pyramidal compressed outputs: {tags}")

        # -- 4. an 8192^2 CZI through --engine auto (streamed) ---------------
        flat = os.path.join(tmp, "big.tif")
        imwrite(flat, big)
        bt_maps, _, bt_secs = run(flat, "big_tif")
        bczi = os.path.join(tmp, "big.czi")
        write_czi(bczi, big, 1024, czi_comp, hilo=True)
        with slides.open_channel_source(bczi, "czi", 0) as src:
            t0 = time.perf_counter()
            for r0 in range(0, BIG, 1024):
                src.read_rows(r0, 1024)
            bczi_read_s = time.perf_counter() - t0
        bc_maps, _, bc_secs = run(bczi, "big_czi", count="czi_streamed")
        n = launches["czi_streamed"]
        log(f"[formats] {BIG}^2 CZI --engine auto (streamed): {bc_secs:.2f} s "
            f"({BIG * BIG / 1e6 / bc_secs:.2f} Mpx/s), the TIFF "
            f"{bt_secs:.2f} s; windowed read {rate(big.nbytes, bczi_read_s)}"
            f"; pages byte-equal to the TIFF's: {same(bc_maps, bt_maps)}; "
            f"K1 {n['softmax_blend']}, K2 stripe {n['blend_fold_stripe']} "
            f"launches | {card}")
        check(n["softmax_blend"] > 0 and n["blend_fold_stripe"] > 0
              and n["blend_fold_epilogue"] == 0,
              f"the {BIG}^2 CZI did not stream through K1 and K2: {n}")
        check(same(bc_maps, bt_maps), "the streamed CZI's pages differ")

        # -- 5. the server, in threads ---------------------------------------
        srv = serve.ModelServer(model_root=zoo)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(srv))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}/infer?model=nucleiDAPI"

        def post(path, query=""):
            with open(path, "rb") as f:
                st, body, _, secs = http("POST", url + query, f.read())
            check(st == 200, f"POST {os.path.basename(path)} {query}: {st} "
                             f"{body[:300]}")
            return body, secs

        def apart(a, b):
            d = level_diff(list(a), list(b))
            return d[0], d[1] + d[2]

        post(tif)  # the server's device thread chooses its cuDNN plans
        body, s_czi = post(czi)
        d_czi = apart(tiff_pages(body), c_maps)
        body, s_pyr = post(pyr, "&usePyramid=1&scale=0.5")
        d_pyr = apart(tiff_pages(body), p_maps)
        zbody, s_z = post(czi, "&pyramid=1" + (
            "&compress=zstd" if have_zstd else "&compress=deflate"))
        with tempfile.NamedTemporaryFile(suffix=".tif") as f:
            f.write(zbody)
            f.flush()
            with TiffFile(f.name) as tf:
                ztags = {(p.compression, len(p.subifds)) for p in tf.pages}
        d_z = apart(tiff_pages(zbody), tiff_pages(post(czi)[0]))
        log(f"[formats] serve: POST the CZI {s_czi:.3f} s, pages vs the "
            f"CLI's max {d_czi[0]} level(s) at {d_czi[1]} pixels; "
            f"usePyramid=1&scale=0.5 on the pyramid {s_pyr:.3f} s, vs the "
            f"CLI's max {d_pyr[0]} at {d_pyr[1]}; pyramid=1 compressed "
            f"{s_z:.3f} s, (compression, levels) {ztags}, vs uncompressed "
            f"max {d_z[0]} | {card}")
        check(d_czi[0] == 0 and d_pyr[0] == 0 and d_z[0] == 0
              and len(ztags) == 1
              and next(iter(ztags))[1] == n_levels_of(SLIDE),
              f"serve: {d_czi} {d_pyr} {d_z} {ztags}")

        # -- 6. a bundle that is not model.ckpt, with a stale hp.data --------
        alt_root = os.path.join(tmp, "alt")
        alt = os.path.join(alt_root, "mousenucleiDAPI")
        os.makedirs(alt)
        save_tf1_params(os.path.join(alt, "nuclei20x2bin1chan"), state, hp,
                        "legacy")
        save_pickle(dataclasses.replace(hp, n_out0=20).to_ref_dict(),
                    os.path.join(alt, "hp.data"))
        save_pickle(LEGACY_MEAN, os.path.join(alt, "datasetMean.data"))
        save_pickle(LEGACY_STD, os.path.join(alt, "datasetStDev.data"))
        small = os.path.join(tmp, "small.tif")
        imwrite(small, np.ascontiguousarray(big[:768, :768]))
        alt_pages = {}
        for d in ("cuda", "cpu"):
            out = os.path.join(tmp, "out", f"alt_{d}")
            check(cli.main([small, "--tool", "unmicst-legacy", "--model",
                            "mousenucleiDAPI", "--modelRoot", alt_root,
                            "--stackOutput", "--outputPath", out],
                           device=d) == 0, f"the alternate bundle on {d}")
            maps = out_file(out, "Probabilities")
            alt_pages[d] = [imread(maps, k) for k in range(3)]
        d_alt = level_diff(alt_pages["cuda"], alt_pages["cpu"])
        log(f"[formats] mousenucleiDAPI (bundle nuclei20x2bin1chan, 16 "
            f"wide; hp.data says 20) through cli.main 768^2: card vs CPU max "
            f"{d_alt[0]} level(s), {d_alt[1]} pixels 1 apart | {card}")
        check(d_alt[0] <= 1, f"alternate bundle card vs CPU: {d_alt}")
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[formats] phase {time.perf_counter() - t_phase:.1f}s")
    return {name: {path: counts[name] for path, counts in launches.items()}
            for name in ("softmax_blend", "blend_fold_epilogue",
                         "blend_fold_stripe")}




# -- phase 15: the native codec, CUDA graphs, space-to-depth ------------------


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, early change, a clear code first, the
    EOI at the width the spec asks), linear in ``data``: the string table
    is a dict keyed by ``prefix code << 8 | byte``, the code widths are
    kept as the points where they change, and numpy packs the codes into
    bits at the end.  The port reads LZW and never writes it, so the
    slide that phase 15 reads is encoded here."""
    import numpy as np

    codes = [256]
    marks = [(0, 9)]  # (first code index, width from there on)
    put = codes.append
    nbits = 9
    if data:
        table = {}
        get = table.get
        nxt, limit = 258, 512
        w = data[0]
        for b in data[1:]:
            k = (w << 8) | b
            c = get(k)
            if c is not None:
                w = c
                continue
            put(w)
            if nxt < 4094:
                table[k] = nxt
                nxt += 1
                # the decoder's table lags by one entry and it widens at
                # 2^n - 1 entries, so the encoder widens one code later
                if nxt >= limit and nbits < 12:
                    nbits += 1
                    limit <<= 1
                    marks.append((len(codes), nbits))
            else:  # table full: clear and start again
                put(256)
                table = {}
                get = table.get
                nxt, nbits, limit = 258, 9, 512
                marks.append((len(codes), 9))
            w = b
        put(w)
        # the decoder adds an entry for that last code, so the EOI may
        # have to be one bit wider
        if nxt >= limit - 1 and nbits < 12:
            nbits += 1
            marks.append((len(codes), nbits))
    put(257)
    c = np.asarray(codes, np.int64)
    starts = [m[0] for m in marks] + [len(codes)]
    wd = np.repeat([m[1] for m in marks], np.diff(starts))
    shift = np.arange(11, -1, -1)
    # each code's bits MSB first, left-aligned in 12, then the first
    # ``width`` of them
    bits = (c[:, None] << (12 - wd[:, None])) >> shift[None, :] & 1
    keep = shift[None, :] >= 12 - wd[:, None]
    return np.packbits(bits[keep].astype(np.uint8)).tobytes()


def write_lzw_tiff(path: str, plane, rows_per_strip: int,
                   workers: int = 1) -> None:
    """A classic little-endian TIFF of a grayscale ``plane`` in LZW
    strips of ``rows_per_strip`` rows, with horizontal predictor 2 (each
    row's differences, wrapping in the sample type); ``workers`` > 1
    encodes the strips in that many spawned processes, closed before it
    returns."""
    import concurrent.futures
    import multiprocessing

    import numpy as np

    plane = np.ascontiguousarray(plane)
    h, w = plane.shape
    diff = plane.astype(plane.dtype.newbyteorder("<"))  # a copy
    diff[:, 1:] -= plane[:, :-1]
    raw = [diff[r:r + rows_per_strip].tobytes()
           for r in range(0, h, rows_per_strip)]
    if workers > 1:
        with concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")
        ) as pool:
            strips = list(pool.map(lzw_encode, raw))
    else:
        strips = [lzw_encode(r) for r in raw]
    n = len(strips)
    offs, pos = [], 8
    for st in strips:
        offs.append(pos)
        pos += len(st) + len(st) % 2
    arrays = pos
    entries = [(256, 4, 1, w), (257, 4, 1, h),
               (258, 3, 1, plane.dtype.itemsize * 8), (259, 3, 1, 5),
               (262, 3, 1, 1), (273, 4, n, arrays if n > 1 else offs[0]),
               (277, 3, 1, 1), (278, 4, 1, rows_per_strip),
               (279, 4, n, arrays + 4 * n if n > 1 else len(strips[0])),
               (317, 3, 1, 2),
               (339, 3, 1, 2 if plane.dtype.kind == "i" else 1)]
    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42,
                            arrays + (8 * n if n > 1 else 0)))
        for st in strips:
            f.write(st + bytes(len(st) % 2))
        if n > 1:
            f.write(struct.pack(f"<{n}I", *offs))
            f.write(struct.pack(f"<{n}I", *(len(st) for st in strips)))
        f.write(struct.pack("<H", len(entries)))
        for tag, ftype, count, value in entries:
            f.write(struct.pack("<HHII", tag, ftype, count, value))
        f.write(struct.pack("<I", 0))


@contextlib.contextmanager
def python_codecs():
    """The port's Python codecs for the block: the native host library
    hidden as if it had not loaded, then restored."""
    from unmicst_tpu_torch.io import _native

    saved = (_native._lib, _native._load_failed)
    _native._lib, _native._load_failed = None, True
    try:
        yield
    finally:
        _native._lib, _native._load_failed = saved


@contextlib.contextmanager
def eager_forward():
    """The engines' forwards eager, as before the CUDA graphs: every
    module that calls ``weigh_tiles`` gets it with ``_graphs=False``."""
    import functools

    from unmicst_tpu_torch import infer
    from unmicst_tpu_torch.runtime import halo, pipeline

    saved = infer.weigh_tiles
    plain = functools.partial(saved, _graphs=False)
    mods = (infer, pipeline, halo)
    for m in mods:
        m.weigh_tiles = plain
    try:
        yield
    finally:
        for m in mods:
            m.weigh_tiles = saved


@contextlib.contextmanager
def capture_log():
    """The seconds of every forward-graph capture made inside the block
    (by any model, in any thread)."""
    from unmicst_tpu_torch.runtime import graphs

    real = graphs.ForwardGraphs._capture
    secs = []

    def timed(self, *args):
        t0 = time.perf_counter()
        try:
            return real(self, *args)
        finally:
            secs.append(time.perf_counter() - t0)

    graphs.ForwardGraphs._capture = timed
    try:
        yield secs
    finally:
        graphs.ForwardGraphs._capture = real


def graph_pool_bytes() -> int:
    """Device bytes the caching allocator holds in private pools (the
    forward graphs' shared pool, and any pool a failed capture left)."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


# one fresh process: ``cli.main`` twice on one slide, on the card's default
# path or eagerly; prints the seconds of each call and of every capture
COLD_CLI = """
import contextlib, io, json, sys, time
import chip_smoke
from unmicst_tpu_torch import cli

argv, out, eager = json.loads(sys.argv[1])
secs = []
with chip_smoke.capture_log() as caps, (
        chip_smoke.eager_forward() if eager else contextlib.nullcontext()):
    for k in range(2):
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv + ["--outputPath", f"{out}/{k}"])
        secs.append(time.perf_counter() - t0)
        if rc:
            sys.exit(f"cli.main rc {rc}: {err.getvalue()}")
print(json.dumps({"secs": secs, "captures": caps}))
"""


def cold_cli(argv, out: str, eager: bool) -> dict:
    """:data:`COLD_CLI` in a new process from this script's directory."""
    here = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run(
        [sys.executable, "-c", COLD_CLI, json.dumps([argv, out, eager])],
        cwd=here, capture_output=True, text=True, timeout=300)
    check(res.returncode == 0, f"the cold cli.main process failed: "
                               f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def idle_share(run) -> tuple:
    """(wall ms, device busy ms, idle share) of one ``run()`` under
    ``torch.profiler``; NaN busy when the profiler saw no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(prof) or float("nan")
    return wall_ms, busy, 1 - busy / wall_ms


def device_ms_per_call(fn, iters: int = 10) -> float:
    """All device time of ``fn()`` per call, from ``torch.profiler``."""
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
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    return sum(us) / iters / 1e3 if us else float("nan")


def server_memory(zoo: str, slide_path: str, card: str) -> None:
    """Three servers in one process (float32, bfloat16, int8) on the
    card, each answering one slide's request three times, then pans on
    the float32 server's card-resident copy of the slide: each engine's
    tile batch, the reserved memory and the graph pool after each, on
    the default path and eagerly.  Every answer must equal the first."""
    import gc
    import hashlib

    import torch

    from unmicst_tpu_torch import serve

    model, pan = "nucleiDAPI", 1024
    with open(slide_path, "rb") as f:
        body = f.read()
    digest = hashlib.sha256(body).hexdigest()
    answers = {}
    for how in ("graphs", "eager"):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        rows = []
        servers = []

        def note(label, tile_batch):
            torch.cuda.synchronize()
            rows.append(f"{label} (tile batch {tile_batch}): reserved "
                        f"+{(torch.cuda.memory_reserved() - base) / 2**30:.2f}"
                        f" GiB, graph pool "
                        f"{graph_pool_bytes() / 2**30:.2f} GiB")

        with (eager_forward() if how == "eager"
              else contextlib.nullcontext()), capture_log() as caps:
            for precision in ("float32", "bfloat16", "int8"):
                srv = serve.ModelServer(model_root=zoo, precision=precision)
                servers.append(srv)
                for _ in range(3):
                    page, _ = srv.infer_tiff_path(slide_path, model, 0, True,
                                                  -1)
                    check(answers.setdefault(precision, page) == page,
                          f"{how}: a {precision} answer differs from the "
                          f"first")
                note(precision, srv.engine(model).tile_batch)
            srv = servers[0]
            spool = os.path.join(os.path.dirname(slide_path), "spool.tif")
            with open(spool, "wb") as f:
                f.write(body)
            sid = srv.register_slide(spool, len(body), digest)["slide_id"]
            for k in range(3):
                path = srv.acquire_slide(sid)
                try:
                    page, _ = srv.infer_tiff_path(
                        path, model, 0, True, -1, roi=(512, 768, pan, pan),
                        slide_id=sid)
                finally:
                    srv.release_slide(sid)
                check(answers.setdefault("pan", page) == page,
                      f"{how}: a pan differs from the first")
            note("float32 pans", srv.engine(model).tile_batch)
            srv.drop_slide(sid)
        log(f"[slice12] server memory, {how}: " + "; ".join(rows)
            + f"; captures {len(caps)} | {card}")
        del servers, srv
    gc.collect()
    torch.cuda.empty_cache()


def phase_slice12(dev) -> dict:
    """The native TIFF codec on the card's host, the forward's CUDA graphs
    against eager on every engine path, and the space-to-depth engine
    against the standard one; returns, per kernel, its launches on each
    path (the counters set to 0 just before it)."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.core import s2d
    from unmicst_tpu_torch.infer import InferenceEngine, _conv_precision
    from unmicst_tpu_torch.io import _native
    from unmicst_tpu_torch.io.tiff import TiffFile, imread, imwrite, num_pages
    from unmicst_tpu_torch.runtime import halo
    from unmicst_tpu_torch.runtime.graphs import graphs_for
    from unmicst_tpu_torch.runtime.mesh import make_mesh
    from unmicst_tpu_torch.runtime.pipeline import StreamingEngine

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    hp = legacy_hp()
    state = seeded_state(hp, "legacy", SEED)
    launches = {}
    mpx = SLIDE * SLIDE / 1e6

    def counted(path, fn):
        kernels.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        launches[path] = kernels.launch_counts()
        return res

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def turns(graph_fn, eager_fn, reps=2):
        """Median seconds of ``graph_fn`` and ``eager_fn`` timed in turns
        (graph, eager, eager, graph, ...)."""
        g, e = [], []
        for k in range(reps):
            for which in ((0, 1) if k % 2 == 0 else (1, 0)):
                if which == 0:
                    g.append(timed(graph_fn)[1])
                else:
                    with eager_forward():
                        e.append(timed(eager_fn)[1])
        return float(np.median(g)), float(np.median(e))

    # -- 1. the native codec ----------------------------------------------
    lib = _native.get_lib()
    check(lib is not None, "the native TIFF codec did not load on the "
                           "card's host (g++ missing or the build failed)")
    log(f"[slice12] native codec loaded from {_native.lib_path()}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice12_")
    try:
        zoo = os.path.join(tmp, "zoo")
        write_model_dir(zoo, "nucleiDAPI", hp, state, "legacy", LEGACY_MEAN,
                        LEGACY_STD)
        base = ["--tool", "unmicst-legacy", "--model", "nucleiDAPI",
                "--modelRoot", zoo, "--stackOutput", "--stats"]
        rng = np.random.RandomState(SEED + 15)
        side = SLIDE
        raw = (np.clip(blob_slide(rng, side, side, 4000), 0, 1)
               * 65535).astype(np.uint16)
        # the encoder is Python: size it from a sample before committing
        diff = raw[:64].copy()
        diff[:, 1:] -= raw[:64, :-1]
        workers = max(1, min(8, os.cpu_count() or 1))
        _, sample_s = timed(lambda: lzw_encode(diff.tobytes()))
        predicted = sample_s * side / 64 / workers
        if predicted > 20:
            side = SLIDE // 2
            raw = np.ascontiguousarray(raw[:side, :side])
            log(f"[slice12] LZW encode predicted {predicted:.1f} s at "
                f"{SLIDE}^2 on {workers} workers: CUT to {side}^2")
        lzw = os.path.join(tmp, "lzw.tif")
        _, enc_s = timed(lambda: write_lzw_tiff(lzw, raw, 64, workers))
        flat = os.path.join(tmp, "flat.tif")
        imwrite(flat, raw)
        with TiffFile(lzw) as tf:
            page = tf.pages[0]
            got, read_s = timed(lambda: tf.read_page(0))
            check(page.compression == 5 and page.predictor == 2
                  and np.array_equal(got, raw), "the LZW slide reads other "
                                                "pixels")
            band = page.rows_per_strip
            with python_codecs():
                got_py, py_s = timed(lambda: tf.read_region(0, 0, 0, band,
                                                            side))
            check(np.array_equal(got_py, raw[:band]),
                  "the Python codec reads other pixels")
        mb = raw.nbytes / 1e6
        lzw_mb = os.path.getsize(lzw) / 1e6
        log(f"[slice12] {side}^2 uint16 blob slide as LZW predictor-2 strips "
            f"of 64 rows ({lzw_mb:.1f} MB on disk, {mb:.1f} MB raw), "
            f"encoded here in {enc_s:.2f} s on {workers} processes; read "
            f"natively {read_s:.3f} s = {mb / read_s:.1f} MB/s; the Python "
            f"codec on one {band}-row band {py_s:.3f} s = "
            f"{raw[:band].nbytes / 1e6 / py_s:.2f} MB/s "
            f"({mb / read_s / (raw[:band].nbytes / 1e6 / py_s):.0f}x) | "
            f"{card}")

        def cli_pages(src, name, count=None):
            out = os.path.join(tmp, "out", name)
            err = io.StringIO()
            t0 = time.perf_counter()

            def go():
                with contextlib.redirect_stderr(err):
                    return cli.main([src, *base, "--outputPath", out])

            rc = counted(count, go) if count else go()
            secs = time.perf_counter() - t0
            check(rc == 0, f"cli.main {name}: rc {rc}\n{err.getvalue()}")
            stats = [ln for ln in err.getvalue().splitlines()
                     if "total" in ln]
            (maps,) = [os.path.join(out, f) for f in os.listdir(out)
                       if "_Probabilities_" in f]
            return ([imread(maps, k) for k in range(num_pages(maps))], secs,
                    stats[-1] if stats else "")

        # the uncompressed run first: cuDNN's autotune lands there, not in
        # the LZW run (neither captures a graph: each cli.main call builds
        # its engine, whose shape it runs once)
        f_pages, f_secs, f_stats = cli_pages(flat, "flat")
        l_pages, l_secs, l_stats = cli_pages(lzw, "lzw", count="lzw_cli")
        same = len(l_pages) == len(f_pages) and all(
            np.array_equal(a, b) for a, b in zip(l_pages, f_pages))
        log(f"[slice12] cli.main on the LZW slide {l_secs:.2f} s "
            f"[{l_stats.split('] ', 1)[-1]}], on the same pixels "
            f"uncompressed {f_secs:.2f} s [{f_stats.split('] ', 1)[-1]}]; "
            f"pages byte-equal: {same}; K1 "
            f"{launches['lzw_cli']['softmax_blend']} K2 "
            f"{launches['lzw_cli']['blend_fold_epilogue']} | {card}")
        check(same, "the LZW slide's pages differ from the uncompressed "
                    "slide's")
        check(launches["lzw_cli"]["softmax_blend"] > 0
              and launches["lzw_cli"]["blend_fold_epilogue"] == 1,
              f"the LZW CLI run did not run K1 and K2: {launches['lzw_cli']}")

        write_s = {}
        for how in ("native", "zlib", "none"):
            path = os.path.join(tmp, f"w_{how}.tif")
            with (python_codecs() if how == "zlib"
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                for k, m in enumerate(l_pages):
                    imwrite(path, m, append=k > 0, pyramid=True,
                            compression=None if how == "none" else "deflate")
                write_s[how] = time.perf_counter() - t0
            back = [imread(path, k) for k in range(num_pages(path))]
            check(all(np.array_equal(a, b) for a, b in zip(back, l_pages)),
                  f"the {how} pyramid pages read back other pixels")
        log(f"[slice12] write of the three {side}^2 maps as pyramids "
            f"(deflate level 3, 256^2 tiles): native "
            f"{write_s['native']:.3f} s, zlib {write_s['zlib']:.3f} s, "
            f"uncompressed {write_s['none']:.3f} s | {card}")

        # -- the cold cost: a fresh process, as a one-shot pipeline step
        cold = {how: cold_cli([flat, *base], os.path.join(tmp, f"cold_{how}"),
                              how == "eager")
                for how in ("default", "eager")}
        log(f"[slice12] cli.main twice in a fresh process on the {side}^2 "
            f"uncompressed slide: default {cold['default']['secs'][0]:.3f} "
            f"then {cold['default']['secs'][1]:.3f} s (captures "
            f"{cold['default']['captures']}), eager "
            f"{cold['eager']['secs'][0]:.3f} then "
            f"{cold['eager']['secs'][1]:.3f} s | {card}")
        check(not cold["default"]["captures"],
              "a one-shot cli.main call captured a graph")

        # -- a server holding several engines: float32, bfloat16 and int8
        # requests of one slide (each three times: eager, capture, replay)
        # and pans on its card-resident slide cache
        server_memory(zoo, flat, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 2. CUDA graphs against eager ------------------------------------
    g = torch.Generator().manual_seed(SEED + 16)
    slide = torch.randint(0, 65536, (SLIDE, SLIDE), generator=g,
                          dtype=torch.int32).numpy().astype(np.uint16)
    other = (np.clip(blob_slide(np.random.RandomState(SEED + 18), SLIDE,
                                SLIDE, 4000), 0, 1) * 65535).astype(np.uint16)
    big = torch.randint(0, 65536, (BIG, BIG), generator=g,
                        dtype=torch.int32).numpy().astype(np.uint16)
    pans = [(int(r), int(c)) for r, c in
            np.random.RandomState(SEED + 17).randint(0, BIG - 1024, (5, 2))]

    def fresh(**kw):
        return InferenceEngine(hp, state, "legacy", LEGACY_MEAN, LEGACY_STD,
                               device=dev, **kw)

    def captures(engine_model):
        return [round(v, 3) for v in
                graphs_for(engine_model, dev).capture_s.values()]

    # spatial_infer builds its models per call, so it runs eagerly: two
    # calls in a row, neither capturing
    canvas = halo.build_canvas(slide.astype(np.float32) / 65535, hp, RANKS)
    mesh = make_mesh(devices=[dev] * RANKS)
    with capture_log() as caps:
        walls = [timed(lambda: halo.spatial_infer(
            state, canvas, SLIDE, SLIDE, hp, "legacy", mesh,
            mean=LEGACY_MEAN, std=LEGACY_STD))[1] for _ in range(2)]
    log(f"[slice12] spatial_infer {SLIDE}^2 on {RANKS} ranks (ppermute), "
        f"two calls in a row: {walls[0]:.4f} then {walls[1]:.4f} s; "
        f"captures {caps} | {card}")
    check(not caps, "spatial_infer captured a graph")
    del canvas

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    f32 = fresh()
    plane = f32.device_plane(big)
    # a key's first request runs eagerly, its second captures the graph
    for _ in range(2):
        maps_a = counted("graph_slide_f32", lambda: f32.infer_slide(slide))
        pan_g = [counted("graph_pan", lambda: f32.infer_slide_device(
            plane, r, c, 1024, 1024)) for r, c in pans[:1]]
        small_g = f32.infer_slide(slide[:300, :300])
    maps_a2 = f32.infer_slide(slide)  # key A replayed after keys B and C
    peak_g = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_g = torch.cuda.memory_reserved() - base_reserved
    with eager_forward():
        maps_e = f32.infer_slide(slide)
        pan_e = [f32.infer_slide_device(plane, r, c, 1024, 1024)
                 for r, c in pans[:1]]
        small_e = f32.infer_slide(slide[:300, :300])
    eq = {"slide": np.array_equal(maps_a, maps_e),
          "pan": all(np.array_equal(a, b) for a, b in zip(pan_g, pan_e)),
          "small": np.array_equal(small_g, small_e),
          "A after B, C": np.array_equal(maps_a2, maps_e)}
    n_keys = len(graphs_for(f32.model, dev).cache)
    log(f"[slice12] graphs vs eager, float32 engine: byte-equal {eq}; "
        f"{n_keys} keys cached, capture s per key {captures(f32.model)}; "
        f"peak allocated {peak_g / 2**30:.2f} GiB over the three keys' "
        f"first two calls, reserved with them held "
        f"{held_g / 2**30:.2f} GiB | {card}")
    check(all(eq.values()), f"graph maps differ from eager: {eq}")
    check(n_keys == 3, f"expected 3 graph keys, got {n_keys}")
    del plane
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    with eager_forward():
        eng_e = fresh()
        eng_e.infer_slide(slide)
        eng_e.infer_slide(slide[:300, :300])
    peak_e = torch.cuda.max_memory_allocated() - base_alloc
    del eng_e
    torch.cuda.empty_cache()
    log(f"[slice12] eager engine, the same slides: peak allocated "
        f"{peak_e / 2**30:.2f} GiB above the "
        f"{base_alloc / 2**30:.2f} GiB already held | {card}")

    for label, engine in (("float32", f32),
                          ("bfloat16", fresh(compute_dtype=torch.bfloat16))):
        engine.infer_slide(slide)  # the key's first request, if it is
        got = counted(f"graph_slide_{'f32' if engine is f32 else 'bf16'}",
                      lambda: engine.infer_slide(slide))
        with eager_forward():
            want = engine.infer_slide(slide)
        check(np.array_equal(got, want), f"{label} graph maps differ from "
                                         "eager")
        sg, se = turns(lambda: engine.infer_slide(slide),
                       lambda: engine.infer_slide(slide))
        _, _, idle_g = idle_share(lambda: engine.infer_slide(slide))
        with eager_forward():
            _, _, idle_e = idle_share(lambda: engine.infer_slide(slide))
        log(f"[slice12] {label} {SLIDE}^2 infer_slide: graphs "
            f"{mpx / sg:.2f} Mpx/s ({sg:.4f} s), eager {mpx / se:.2f} Mpx/s "
            f"({se:.4f} s), medians of 2 in turns; idle share graphs "
            f"{idle_g:.3f}, eager {idle_e:.3f} (profiler on); capture s "
            f"per key {captures(engine.model)}; maps byte-equal | {card}")
    bf16 = engine
    plane = f32.device_plane(big)

    def pan_all():
        return [f32.infer_slide_device(plane, r, c, 1024, 1024)
                for r, c in pans]

    pg, pe = turns(pan_all, pan_all)
    log(f"[slice12] {len(pans)} 1024^2 pans on the pinned {BIG}^2 plane: "
        f"graphs {pg / len(pans) * 1e3:.2f} ms a pan, eager "
        f"{pe / len(pans) * 1e3:.2f} ms (medians of 2 in turns) | {card}")
    del plane

    stream = StreamingEngine(hp, state, "legacy", LEGACY_MEAN, LEGACY_STD,
                             compute_dtype=None, device=dev)
    got = counted("graph_stream", lambda: stream.infer(big))
    with eager_forward():
        want = stream.infer(big)
    check(np.array_equal(got, want), "the stream's graph maps differ from "
                                     "eager")
    sg, se = turns(lambda: stream.infer(big), lambda: stream.infer(big), 2)
    _, _, idle_g = idle_share(lambda: stream.infer(big))
    with eager_forward():
        _, _, idle_e = idle_share(lambda: stream.infer(big))
    big_mpx = BIG * BIG / 1e6
    log(f"[slice12] StreamingEngine.infer {BIG}^2 float32: graphs "
        f"{big_mpx / sg:.2f} Mpx/s, eager {big_mpx / se:.2f} Mpx/s (medians "
        f"of 2 in turns); idle share graphs {idle_g:.3f}, eager "
        f"{idle_e:.3f}; capture s per key "
        f"{captures(stream._model(dev)[0])}; maps byte-equal | {card}")
    del stream, big
    torch.cuda.empty_cache()

    q8 = fresh(quantized=True, compute_dtype=torch.bfloat16)
    scales = []
    for k, raw_q in enumerate((slide, other)):
        q8._quant = None  # calibrate on this slide
        if k == 0:
            q8.infer_slide(raw_q)  # calibrates; the key's first request
        got = counted(f"graph_int8_{k}", lambda: q8.infer_slide(raw_q))
        with eager_forward():
            want = q8.infer_slide(raw_q)
        scales.append([float(torch.as_tensor(a).max()) for _, a in
                       sorted(q8._quant["scales"].items())])
        check(np.array_equal(got, want), f"int8 graph maps after "
                                         f"calibration {k} differ from eager")
    log(f"[slice12] int8 {SLIDE}^2, calibrated on one slide then another "
        f"(first site's max scale {scales[0][0]:.5g} then "
        f"{scales[1][0]:.5g}): graph "
        f"maps byte-equal to eager after each; capture s per key "
        f"{captures(q8.model)} | {card}")
    check(scales[0] != scales[1], "the two calibrations gave one state")
    del q8

    # -- 3. space-to-depth ------------------------------------------------
    for label, dt in (("float32", None), ("bfloat16", torch.bfloat16)):
        std = f32 if dt is None else bf16
        packed = fresh(s2d=True, compute_dtype=dt)
        got = counted(f"s2d_{label}", lambda: packed.infer_slide(slide))
        packed.infer_slide(slide)  # the capture, out of the timed calls
        want = std.infer_slide(slide)
        sp, ss = [], []
        for k in range(3):
            for eng, acc in ((packed, sp), (std, ss))[::1 if k % 2 == 0
                                                      else -1]:
                acc.append(timed(lambda: eng.infer_slide(slide))[1])
        sp, ss = float(np.median(sp)), float(np.median(ss))
        d = np.abs(got.astype(int) - want.astype(int))
        if dt is None:
            ok = d.max() <= 1
            bar = "at most 1 level"
        else:
            # phase 4's bar for seeded weights: bfloat16 s2d nearer the
            # standard bfloat16 maps than the standard float32 maps are
            _, _, share_bf = maps_agree(got, want, dt)
            _, _, share_f = maps_agree(want, maps_e, None)
            ok = share_bf < share_f
            bar = (f"nearer than standard bfloat16 to float32 "
                   f"({share_f:.3e} of pixels)")
        model, pk = packed.model, packed._packed
        x = torch.randn((256, 1, 128, 128), generator=torch.Generator(
            device=dev).manual_seed(SEED), device=dev)
        h1 = torch.randn((256, 32, 64, 64), device=dev)

        def level0_standard():
            d0, u0 = model.down[0], model.up[0]
            model._conv(x, d0.kernel1)
            model._conv(x.expand(-1, 16, -1, -1), d0.extra[0])
            model._conv(x, d0.shortcut)
            u = model._conv_transpose(h1, u0.kernel1)
            model._conv(torch.cat([x, u], 1), u0.kernel2)
            model._conv(u, u0.extra[0])

        xp = s2d.space_to_depth(x)

        def level0_packed():
            d0, u0 = pk.down0, pk.up0
            model._conv(xp, d0.kernel1)
            model._conv(xp.repeat(1, 16, 1, 1), d0.extra[0])
            model._conv(xp, d0.shortcut)
            u = model._conv(h1, u0.kernel1)
            model._conv(torch.cat([xp.reshape(256, 4, 1, 64, 64),
                                   u.reshape(256, 4, 16, 64, 64)], 2
                                  ).reshape(256, 68, 64, 64), u0.kernel2)
            model._conv(u, u0.extra[0])

        with torch.inference_mode(), _conv_precision(dt is not None):
            ms_std = device_ms_per_call(level0_standard)
            ms_pk = device_ms_per_call(level0_packed)
        log(f"[slice12] s2d {label} {SLIDE}^2: {mpx / sp:.2f} Mpx/s against "
            f"standard {mpx / ss:.2f} (medians of 3 in turns); maps max "
            f"{d.max()} level(s) apart, {(d > 0).mean():.3e} of pixels "
            f"({bar}: {ok}); level 0's convolutions at a 256-tile chunk, "
            f"all device kernels by the profiler: packed {ms_pk:.3f} ms, "
            f"standard {ms_std:.3f} ms | {card}")
        check(ok, f"s2d {label} maps miss the bar: max {d.max()} levels")
        del packed
    torch.cuda.empty_cache()
    log(f"[slice12] phase {time.perf_counter() - t_phase:.1f}s")
    names = ("softmax_blend", "blend_fold_epilogue", "blend_fold_stripe")
    for path, n in launches.items():
        check(n["softmax_blend"] > 0, f"{path} launched no K1: {n}")
    return {name: {path: n[name] for path, n in launches.items()}
            for name in names}



# -- phase 16: the CZI JPEG decoder, the toolbox, the 3D tiler ----------------

JPEG_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_jpeg")
# the 512^2 fixtures a JPEG mosaic cycles through: baseline with restart
# markers, progressive, plain baseline, optimized tables
MOSAIC_TILES = ("blob_restart", "blob_progressive", "blob_baseline",
                "blob_optimize")
FEATURE_SIDES = (1024, 2048)  # the toolbox's checked plane, its timed plane
FEATURE_VOLUME = 128  # imfeatures3's cube side
TILER_VOLUME = (128, 512, 512)  # the 3D tiler's float32 volume
PNG_SIDE, PNG_PY_ROWS = 2048, 64  # the timed PNG, the rows read in Python


def jpeg_fixture(name: str):
    """A committed JPEG and PIL's decode of it (``.npy``)."""
    import numpy as np

    with open(os.path.join(JPEG_FIXTURES, name + ".jpg"), "rb") as f:
        data = f.read()
    return data, np.load(os.path.join(JPEG_FIXTURES, name + ".npy"))


def jpeg_mosaic(path: str, side: int):
    """A Gray8 CZI of ``side``^2 in 512^2 JPEG sub-blocks cycling through
    :data:`MOSAIC_TILES`; returns the plane the port decodes it to and the
    JPEG bytes."""
    import numpy as np

    from unmicst_tpu_torch.io import jpeg

    tiles = [jpeg_fixture(n)[0] for n in MOSAIC_TILES]
    pixels = [jpeg.decode(t) for t in tiles]
    plane = np.empty((side, side), np.uint8)
    blocks = []
    for k, (r0, c0) in enumerate((r, c) for r in range(0, side, 512)
                                 for c in range(0, side, 512)):
        plane[r0:r0 + 512, c0:c0 + 512] = pixels[k % len(tiles)]
        blocks.append(({"X": (c0, 512), "Y": (r0, 512), "C": (0, 1)},
                       tiles[k % len(tiles)]))
    write_czi_blocks(path, blocks, 2, pixel_type=0)
    return plane, sum(len(b) for _, b in blocks)


def paeth_png(path: str, img) -> None:
    """An RGB 8-bit PNG with every row Paeth-filtered (PNG spec 9.4), the
    slowest row filter to undo and a common choice of adaptive encoders."""
    import zlib

    import numpy as np

    h, w, _ = img.shape
    cur = img.reshape(h, w * 3).astype(np.int32)
    prior = np.vstack([np.zeros((1, w * 3), np.int32), cur[:-1]])

    def left(a):
        return np.hstack([np.zeros((h, 3), np.int32), a[:, :-3]])

    a, b, c = left(cur), prior, left(prior)
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.hstack([np.full((h, 1), 4, np.int32), (cur - pred) % 256])

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.astype(np.uint8)
                                               .tobytes(), 6))
                + chunk(b"IEND", b""))


def scipy_features(x, sigma_deriv, sigma_log, rad):
    """The JAX toolbox's ``imfeatures`` written out on ``scipy.ndimage``
    (``unmicst_tpu/utils/imtools.py:163-268``), the host reference."""
    import numpy as np
    from scipy import ndimage as ndi

    def g(s, order=0):
        return ndi.gaussian_filter(x, s, order=order)

    planes = []
    for s in sigma_deriv:
        dx, dy = g(s, [0, 1]), g(s, [1, 0])
        dxx, dyy = g(s, [0, 2]), g(s, [2, 0])
        planes += [g(s), dx, dy, dxx, g(s, [1, 1]), dyy,
                   np.sqrt(dx ** 2 + dy ** 2), np.sqrt(dxx ** 2 + dyy ** 2)]
    planes += [-ndi.gaussian_laplace(x, s) for s in sigma_log]
    yy, xx = np.ogrid[-rad:rad + 1, -rad:rad + 1]
    disk = xx * xx + yy * yy <= rad * rad
    planes += [ndi.percentile_filter(x, p, footprint=disk)
               for p in (10, 30, 50, 70, 90)]
    return np.stack(planes, -1)


def phase_slice13(dev) -> dict:
    """The CZI JPEG decoder (M16), the toolbox on the card (M14e) and the
    3D tiler (M14f); returns, per kernel, its launches on the JPEG CZI
    paths."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.core import tiler3d
    from unmicst_tpu_torch.io import _native, jpeg
    from unmicst_tpu_torch.io.tiff import imread, imwrite, num_pages
    from unmicst_tpu_torch.utils import imtools

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {}

    # -- 1. the decoder against PIL's decode ---------------------------------
    check(_native.get_lib() is not None, "the native host library did not "
          "load (g++)")
    names = sorted(f[:-4] for f in os.listdir(JPEG_FIXTURES)
                   if f.endswith(".jpg"))
    check(len(names) == 6, f"JPEG fixtures: {names}")
    rows = []
    for name in names:
        data, want = jpeg_fixture(name)
        _, cn = jpeg.decode_coefficients(data)
        with python_codecs():
            _, cp = jpeg.decode_coefficients(data)
        same = np.array_equal(cn, cp)
        for label, ctx in (("native", contextlib.nullcontext),
                           ("python", python_codecs)):
            with ctx():
                got = jpeg.decode(data)
            d = np.abs(got.astype(int) - want.astype(int))
            check(got.shape == want.shape and d.max() <= 1 and same,
                  f"JPEG {name} {label}: max {d.max()} levels, "
                  f"coefficients equal {same}")
            rows.append(f"{name} {label} max {d.max()} ({(d == 1).mean():.3e}"
                        " of pixels 1 level off)")
    log(f"[slice13] JPEG fixtures against PIL's decode, native and Python "
        f"coefficients bit-equal: {'; '.join(rows)}")
    tiles = [jpeg_fixture(n)[0] for n in MOSAIC_TILES]
    mosaic = [tiles[k % len(tiles)] for k in range(64)]
    nbytes = sum(map(len, mosaic))
    runs = []
    for _ in range(2):  # the first pass in the process, then again
        t0 = time.perf_counter()
        coefs = [jpeg.decode_coefficients(t) for t in mosaic]
        entropy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for frame, coef in coefs:
            jpeg.idct_islow(coef, frame.components[0].qtable)
        idct_s = time.perf_counter() - t0
        runs.append(f"entropy decode {entropy_s:.3f} s + numpy islow IDCT "
                    f"{idct_s:.3f} s = "
                    f"{nbytes / 1e6 / (entropy_s + idct_s):.2f} MB/s "
                    f"({4096 * 4096 / 1e6 / (entropy_s + idct_s):.2f} "
                    "Mpx/s)")
    t0 = time.perf_counter()
    with python_codecs():
        jpeg.decode(tiles[2])
    py_s = time.perf_counter() - t0
    log(f"[slice13] JPEG decode of a 4096^2 mosaic (64 tiles of 512^2, "
        f"{nbytes / 1e6:.2f} MB), native: first {runs[0]}; again "
        f"{runs[1]}; the Python decoder on one 512^2 tile {py_s:.3f} s = "
        f"{len(tiles[2]) / 1e6 / py_s:.3f} MB/s | {card}")

    # -- 2. JPEG CZIs through cli.main, whole and streamed -------------------
    hp = legacy_hp()
    state = seeded_state(hp, "legacy", SEED)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice13_")
    try:
        zoo = os.path.join(tmp, "zoo")
        write_model_dir(zoo, "nucleiDAPI", hp, state, "legacy", LEGACY_MEAN,
                        LEGACY_STD)

        def run(src, name, count=None):
            out = os.path.join(tmp, "out", name)
            if count:
                kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main([src, "--tool", "unmicst-legacy", "--model",
                           "nucleiDAPI", "--modelRoot", zoo, "--stackOutput",
                           "--outputPath", out], device=dev)
            secs = time.perf_counter() - t0
            if count:
                launches[count] = kernels.launch_counts()
            check(rc == 0, f"cli.main {name}: rc {rc}")
            (maps,) = [os.path.join(out, f) for f in os.listdir(out)
                       if "_Probabilities_" in f]
            return [imread(maps, k) for k in range(num_pages(maps))], secs

        for side, label, path_name in ((SLIDE, "whole", "czi_jpeg_whole"),
                                       (BIG, "--engine auto, streamed",
                                        "czi_jpeg_streamed")):
            czi = os.path.join(tmp, f"j{side}.czi")
            plane, jbytes = jpeg_mosaic(czi, side)
            tif = os.path.join(tmp, f"j{side}.tif")
            imwrite(tif, plane)
            t_maps, t_secs = run(tif, f"tif{side}")
            c_maps, c_secs = run(czi, f"czi{side}", count=path_name)
            n = launches[path_name]
            same = len(c_maps) == len(t_maps) == 3 and all(
                np.array_equal(a, b) for a, b in zip(c_maps, t_maps))
            log(f"[slice13] JPEG CZI {side}^2 ({side * side // 512 ** 2} "
                f"sub-blocks, {jbytes / 1e6:.1f} MB) through cli.main, "
                f"{label}: {c_secs:.2f} s ({side * side / 1e6 / c_secs:.2f} "
                f"Mpx/s), the decoded pixels as a plain TIFF {t_secs:.2f} s; "
                f"pages byte-equal: {same}; K1 {n['softmax_blend']}, K2 "
                f"epilogue {n['blend_fold_epilogue']}, K2 stripe "
                f"{n['blend_fold_stripe']} | {card}")
            check(same, f"the {side}^2 JPEG CZI's pages differ from the "
                        "TIFF's")
            if side == SLIDE:
                check(n["softmax_blend"] > 0
                      and n["blend_fold_epilogue"] == 1,
                      f"the JPEG CZI did not run K1 and one K2: {n}")
            else:
                check(n["softmax_blend"] > 0 and n["blend_fold_stripe"] > 0
                      and n["blend_fold_epilogue"] == 0,
                      f"the {side}^2 JPEG CZI did not stream: {n}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 3. the toolbox on the card against scipy on the host -----------------
    rng = np.random.RandomState(SEED + 13)
    side, big_side = FEATURE_SIDES
    x = rng.rand(side, side)
    kw = dict(sigma_deriv=[1, 2], sigma_log=[1, 2], loc_stats_rad=3)
    t0 = time.perf_counter()
    got = imtools.imfeatures(x, device=dev, **kw)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = scipy_features(x, kw["sigma_deriv"], kw["sigma_log"], 3)
    host_s = time.perf_counter() - t0
    check(got.shape == want.shape == (side, side, 23), f"{got.shape}")
    err = np.abs(got[..., :18] - want[..., :18])
    close = np.allclose(got[..., :18], want[..., :18], rtol=1e-10,
                        atol=1e-12)
    ranks_equal = np.array_equal(got[..., 18:], want[..., 18:])
    log(f"[slice13] imfeatures {side}^2 (23 features) on the card against "
        f"scipy on the host: filter planes max |diff| {err.max():.3e} "
        f"(rtol 1e-10, atol 1e-12: {close}), local percentiles bit-equal "
        f"{ranks_equal}; card {card_s:.3f} s (first call), scipy "
        f"{host_s:.3f} s | {card}")
    check(close and ranks_equal, "imfeatures on the card misses scipy")
    x2 = rng.rand(big_side, big_side)
    imtools.imfeatures(x2[:256, :256], device=dev, **kw)
    t0 = time.perf_counter()
    imtools.imfeatures(x2, device=dev, **kw)
    f2_s = time.perf_counter() - t0
    vol = rng.rand(*(FEATURE_VOLUME,) * 3)
    t0 = time.perf_counter()
    f3 = imtools.imfeatures3(vol, sigma_deriv=2, sigma_log=2, device=dev)
    f3_s = time.perf_counter() - t0
    log(f"[slice13] imfeatures {big_side}^2 (23 features) on the card "
        f"{f2_s:.3f} s; imfeatures3 {FEATURE_VOLUME}^3 (sigma 2, "
        f"{f3.shape[-1]} "
        f"features) {f3_s:.3f} s; host copies of the stacks included | "
        f"{card}")

    # a 2048^2 RGB PNG with every row Paeth-filtered, read by imtools.imread
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice13_png_")
    try:
        img = (rng.rand(PNG_SIDE, PNG_SIDE, 3) * 255).astype(np.uint8)
        img = np.cumsum(img, 1, dtype=np.uint8)  # smooth-ish, compressible
        png_path = os.path.join(tmp, "paeth.png")
        paeth_png(png_path, img)
        t0 = time.perf_counter()
        got = imtools.imread(png_path)
        png_s = time.perf_counter() - t0
        check(np.array_equal(got, img), "the Paeth PNG reads other pixels")
        strip = os.path.join(tmp, "strip.png")
        paeth_png(strip, img[:PNG_PY_ROWS])
        with python_codecs():
            t0 = time.perf_counter()
            got = imtools.imread(strip)
            png_py_s = time.perf_counter() - t0
        check(np.array_equal(got, img[:PNG_PY_ROWS]),
              "the Python PNG reader reads other pixels")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[slice13] imread of a Paeth-filtered {PNG_SIDE}^2 RGB PNG "
        f"({img.nbytes / 1e6:.2f} MB of pixels): native unfilter "
        f"{png_s:.3f} s = {img.nbytes / 1e6 / png_s:.2f} MB/s; the Python "
        f"unfilter on its first {PNG_PY_ROWS} rows {png_py_s:.3f} s = "
        f"{img[:PNG_PY_ROWS].nbytes / 1e6 / png_py_s:.3f} MB/s (inflate "
        f"included in both) | {card}")

    # -- 4. the 3D tiler round trip ------------------------------------------
    g = tiler3d.make_grid3d(*TILER_VOLUME, 64, 8)
    v = torch.from_numpy(np.random.RandomState(SEED + 14).rand(
        *TILER_VOLUME).astype(np.float32)).to(dev)
    w = torch.from_numpy(tiler3d.ramp_window3d(64, 8)).to(dev)

    def round_trip():
        tiles = tiler3d.unfold3d(tiler3d.pad_canvas3d(v, g), g) * w
        folded = tiler3d.fold3d(tiles, g)
        del tiles
        count = tiler3d.count_map3d(g, w)
        return tiler3d.crop_valid3d(folded / count.clamp_min(1e-12), g)

    round_trip()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    back = round_trip()
    torch.cuda.synchronize()
    t3_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    d3 = float((back - v).abs().max())
    log(f"[slice13] tiler3d {'x'.join(map(str, TILER_VOLUME))} float32, "
        f"patch 64, margin 8 "
        f"({g.npz}x{g.npr}x{g.npc} tiles): unfold -> window -> fold3d / "
        f"count_map3d -> crop in {t3_s * 1e3:.1f} ms, peak "
        f"{peak / 2 ** 30:.2f} GiB above the volume, max |out - in| "
        f"{d3:.2e} | {card}")
    check(d3 <= 1e-5, f"tiler3d round trip: {d3}")
    del v, back
    torch.cuda.empty_cache()
    log(f"[slice13] phase {time.perf_counter() - t_phase:.1f}s")
    return {name: {path: counts[name] for path, counts in launches.items()}
            for name in ("softmax_blend", "blend_fold_epilogue",
                         "blend_fold_stripe")}

# -- phase 17: the TIFF pages the JAX package reads through PIL ---------------

_TIFF_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "I", 7: "B", 11: "f",
               12: "d"}


def write_segment_tiff(path: str, pages, byteorder: str = "<",
                       prefix: bytes = b"") -> None:
    """A classic TIFF of segments encoded elsewhere (JPEG streams,
    predictor-3 deflate), in byte order ``byteorder`` ("<" II, ">" MM):
    ``pages`` holds ``(tags, segments)`` a page, or ``(tags, segments,
    levels)`` with ``levels`` more such pairs hung off the page's SubIFDs
    (tag 330); ``tags`` is ``{tag: (type, values)}`` (a list, numerator
    and denominator in turn for type 5, or bytes for types 2 and 7)
    without the segments' offsets and byte counts, which are filled in,
    as tiles where tag 322 is given and as strips otherwise.  The pages chain in order.  ``prefix`` lies right after the
    8-byte header, so tags may point into it at ``8 + position``."""
    bo = byteorder
    out = bytearray((b"II*\0" if bo == "<" else b"MM\0*") + bytes(4)
                    + prefix)

    def ifd(tags, segments) -> int:
        """Write the segments and the IFD; returns the IFD's offset."""
        offsets = []
        for seg in segments:
            out.extend(bytes(len(out) % 2))
            offsets.append(len(out))
            out.extend(seg)
        tiled = 322 in tags
        tags = {**tags, (324 if tiled else 273): (4, offsets),
                (325 if tiled else 279): (4, [len(g) for g in segments])}
        out.extend(bytes(len(out) % 2))
        at = len(out)
        extra_at = at + 2 + 12 * len(tags) + 4
        entries, extra = [], bytearray()
        for tag in sorted(tags):
            ftype, values = tags[tag]
            if isinstance(values, (bytes, bytearray)):
                data, count = bytes(values), len(values)
            else:
                data = struct.pack(f"{bo}{len(values)}{_TIFF_TYPES[ftype]}",
                                   *values)
                count = len(values) // 2 if ftype == 5 else len(values)
            if len(data) <= 4:
                field = data.ljust(4, b"\0")
            else:
                extra.extend(bytes(len(extra) % 2))
                field = struct.pack(bo + "I", extra_at + len(extra))
                extra.extend(data)
            entries.append(struct.pack(bo + "HHI", tag, ftype, count) + field)
        out.extend(struct.pack(bo + "H", len(entries)) + b"".join(entries)
                   + bytes(4) + extra)
        return at

    link = 4  # where the previous IFD's (or the header's) pointer lies
    for tags, segments, *levels in pages:
        if levels:
            subs = [ifd({254: (4, [1]), **t}, g) for t, g in levels[0]]
            tags = {**tags, 330: (4, subs)}
        at = ifd(tags, segments)
        struct.pack_into(bo + "I", out, link, at)
        link = at + 2 + 12 * struct.unpack_from(bo + "H", out, at)[0]
    with open(path, "wb") as f:
        f.write(bytes(out))


def jpeg_split(stream: bytes) -> tuple:
    """A complete JPEG stream split as libtiff writes a JPEG TIFF's
    segments: ``(tables, abbreviated)``, its DQT and DHT segments before
    the first scan as a tables-only stream (SOI, tables, EOI), and the
    stream without them and without its APPn segments."""
    pos, tables, rest = 2, b"", b""
    while stream[pos + 1] != 0xDA:
        n = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        seg, marker = stream[pos:pos + 2 + n], stream[pos + 1]
        if marker in (0xDB, 0xC4):
            tables += seg
        elif not 0xE0 <= marker <= 0xEF:
            rest += seg
        pos += 2 + n
    return b"\xff\xd8" + tables + b"\xff\xd9", b"\xff\xd8" + rest + stream[pos:]


def gray_jpeg_tags(h: int, w: int, tile=None, tables=None,
                   rows_per_strip=None, photometric: int = 1) -> dict:
    """The tags of a gray 8-bit JPEG-compressed page (compression 7),
    tiled ``tile = (th, tw)`` or in strips of ``rows_per_strip`` rows,
    with ``tables`` as its JPEGTables (tag 347) when given."""
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8]), 259: (3, [7]),
            262: (3, [photometric]), 277: (3, [1]), 284: (3, [1])}
    if tile is not None:
        tags[322], tags[323] = (4, [tile[1]]), (4, [tile[0]])
    if rows_per_strip is not None:
        tags[278] = (4, [rows_per_strip])
    if tables is not None:
        tags[347] = (7, tables)
    return tags


# the fixture streams of a JPEG TIFF's tiles; the first two share their
# tables (quality 95, standard Huffman tables), so they also serve as the
# abbreviated streams of a JPEGTables layout
JPEG_TIFF_TILES = ("blob_baseline", "blob_restart", "blob_progressive",
                   "blob_optimize")


def jpeg_tiff(path: str, side: int, abbreviated: bool):
    """A ``side``^2 gray JPEG TIFF of 512^2 tiles from the committed
    fixture streams, written without PIL: with a JPEGTables tag and
    abbreviated tiles (baseline, and baseline with restart markers), or
    every tile a complete stream (those, progressive and optimized).
    Returns PIL's decode of the slide (the fixtures' ``.npy``, tile by
    tile) and the tiles' bytes."""
    import numpy as np

    names = JPEG_TIFF_TILES[:2] if abbreviated else JPEG_TIFF_TILES
    fixtures = [jpeg_fixture(n) for n in names]
    split = [jpeg_split(data) for data, _ in fixtures]
    if abbreviated:
        check(split[0][0] == split[1][0], "the tiles' tables differ")
    plane = np.empty((side, side), np.uint8)
    segments = []
    for k, (r0, c0) in enumerate((r, c) for r in range(0, side, 512)
                                 for c in range(0, side, 512)):
        data, want = fixtures[k % len(names)]
        plane[r0:r0 + 512, c0:c0 + 512] = want
        segments.append(split[k % len(names)][1] if abbreviated else data)
    tags = gray_jpeg_tags(side, side, (512, 512),
                          split[0][0] if abbreviated else None)
    write_segment_tiff(path, [(tags, segments)])
    return plane, sum(map(len, segments))


def float_predictor_rows(plane) -> bytes:
    """Rows of samples encoded with TIFF's floating-point predictor (3,
    Technote 3): each row's bytes as planes, most significant first, then
    differenced byte by byte."""
    import numpy as np

    h, w = plane.shape
    big = plane.astype(plane.dtype.newbyteorder(">")).view(np.uint8)
    planes = big.reshape(h, w, -1).transpose(0, 2, 1).reshape(h, -1)
    out = planes.copy()
    out[:, 1:] -= planes[:, :-1]
    return out.tobytes()


def float_predictor_tiff(path: str, plane, rows_per_strip: int,
                         byteorder: str = "<", level: int = 1) -> int:
    """A float page of ``plane`` in deflate strips with the floating-point
    predictor, as tifffile's ``predictor=True`` writes one; returns the
    compressed bytes."""
    import zlib

    h, w = plane.shape
    segments = [zlib.compress(float_predictor_rows(plane[r:r + rows_per_strip]),
                              level) for r in range(0, h, rows_per_strip)]
    tags = {256: (4, [w]), 257: (4, [h]),
            258: (3, [plane.dtype.itemsize * 8]), 259: (3, [8]),
            262: (3, [1]), 277: (3, [1]), 278: (4, [rows_per_strip]),
            284: (3, [1]), 317: (3, [3]), 339: (3, [3])}
    write_segment_tiff(path, [(tags, segments)], byteorder)
    return sum(map(len, segments))


def phase_slice15(dev) -> dict:
    """The TIFF pages the JAX package reads through PIL (M17, first part),
    through ``cli.main`` on the card: 4096^2 gray JPEG TIFFs of 512^2
    fixture tiles (a JPEGTables layout and a complete-stream one) and a
    4096^2 float32 predictor-3 deflate TIFF, each byte-equal to the same
    pixels uncompressed; an 8192^2 JPEG TIFF under ``--engine auto`` on
    the whole engine (the streamed probe refuses, as in JAX) at one level
    of depth, and ``--engine streaming`` refusing it.  Returns, per
    kernel, its launches on each counted path."""
    import dataclasses

    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.io.tiff import imread, imwrite, num_pages

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {}
    hp = legacy_hp()
    shallow = dataclasses.replace(hp, n_layers=1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice15_")
    try:
        zoo = os.path.join(tmp, "zoo")
        write_model_dir(zoo, "nucleiDAPI", hp, seeded_state(
            hp, "legacy", SEED), "legacy", LEGACY_MEAN, LEGACY_STD)
        write_model_dir(zoo, "shallow", shallow, seeded_state(
            shallow, "legacy", SEED), "legacy", LEGACY_MEAN, LEGACY_STD)

        def run(src, name, count=None, model="nucleiDAPI", extra=()):
            out = os.path.join(tmp, "out", name)
            if count:
                kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main([src, "--tool", "unmicst-legacy", "--model", model,
                           "--modelRoot", zoo, "--stackOutput",
                           "--outputPath", out, *extra], device=dev)
            secs = time.perf_counter() - t0
            if count:
                launches[count] = kernels.launch_counts()
            check(rc == 0, f"cli.main {name}: rc {rc}")
            (maps,) = [os.path.join(out, f) for f in os.listdir(out)
                       if "_Probabilities_" in f]
            return [imread(maps, k) for k in range(num_pages(maps))], secs

        def against_plain(path, plane, label, count, nbytes):
            """The decode alone, twice (MB/s of the file's segments), then
            the CLI on ``path`` against the CLI on ``plane`` as a plain
            TIFF."""
            secs = []
            for _ in range(2):
                t0 = time.perf_counter()
                got = imread(path)
                secs.append(time.perf_counter() - t0)
                check(got.dtype == plane.dtype and np.array_equal(
                    got.view(np.uint8), plane.view(np.uint8)),
                    f"{label}: the fallback's decode differs")
            dec_s = min(secs)
            plain = os.path.join(tmp, f"plain_{count}.tif")
            imwrite(plain, plane)
            p_maps, p_secs = run(plain, f"plain_{count}")
            c_maps, c_secs = run(path, count, count=count)
            n = launches[count]
            same = len(c_maps) == len(p_maps) == 3 and all(
                np.array_equal(a, b) for a, b in zip(c_maps, p_maps))
            log(f"[slice15] {label}: decode {secs[0]:.3f} s first, "
                f"{secs[1]:.3f} s again = {nbytes / 1e6 / dec_s:.2f} MB/s of "
                f"segments ({plane.nbytes / 1e6 / dec_s:.2f} MB/s of pixels); "
                f"cli.main {c_secs:.2f} s, the pixels as a plain TIFF "
                f"{p_secs:.2f} s; pages byte-equal: {same}; K1 "
                f"{n['softmax_blend']}, K2 epilogue "
                f"{n['blend_fold_epilogue']}, K2 stripe "
                f"{n['blend_fold_stripe']} | {card}")
            check(same, f"{label}: pages differ from the plain TIFF's")
            check(n["softmax_blend"] > 0 and n["blend_fold_epilogue"] == 1
                  and n["blend_fold_stripe"] == 0,
                  f"{label} did not run K1 and one K2 epilogue: {n}")

        # -- 1. gray JPEG TIFFs (compression 7), 4096^2 ------------------------
        for layout, abbreviated in (("JPEGTables", True), ("complete", False)):
            path = os.path.join(tmp, f"jpeg_{layout}.tif")
            plane, nbytes = jpeg_tiff(path, SLIDE, abbreviated)
            against_plain(path, plane, f"JPEG TIFF {SLIDE}^2 (64 tiles, "
                          f"{layout}, {nbytes / 1e6:.1f} MB)",
                          f"jpeg_tiff_{layout}", nbytes)

        # -- 2. float32 with the floating-point predictor, 4096^2 ---------------
        rng = np.random.RandomState(SEED + 15)
        fplane = blob_slide(rng, SLIDE, SLIDE, 4000)
        path = os.path.join(tmp, "float_predictor.tif")
        t0 = time.perf_counter()
        nbytes = float_predictor_tiff(path, fplane, 64)
        log(f"[slice15] predictor-3 deflate float32 {SLIDE}^2 written by "
            f"numpy and zlib in {time.perf_counter() - t0:.2f} s "
            f"({nbytes / 1e6:.1f} MB)")
        against_plain(path, fplane, f"float32 predictor-3 deflate TIFF "
                      f"{SLIDE}^2 (the host float path)", "float_predictor",
                      nbytes)

        # -- 3. the route: --engine auto keeps such a slide whole --------------
        path = os.path.join(tmp, f"jpeg_{BIG}.tif")
        plane, nbytes = jpeg_tiff(path, BIG, True)
        maps, secs = run(path, "jpeg_big", count="jpeg_tiff_8192_auto",
                         model="shallow", extra=("--engine", "auto"))
        n = launches["jpeg_tiff_8192_auto"]
        ok = all(m.shape == (BIG, BIG) and m.dtype == np.uint8
                 for m in maps) and len(maps) == 3
        log(f"[slice15] JPEG TIFF {BIG}^2 ({BIG * BIG / 1e6:.0f} Mpx, above "
            f"the 64 Mpx line) under --engine auto, the net at 1 level: "
            f"{secs:.2f} s; K1 {n['softmax_blend']}, K2 epilogue "
            f"{n['blend_fold_epilogue']}, K2 stripe "
            f"{n['blend_fold_stripe']} (whole engine); three {BIG}^2 uint8 "
            f"pages: {ok} | {card}")
        check(ok and n["softmax_blend"] > 0 and n["blend_fold_epilogue"] == 1
              and n["blend_fold_stripe"] == 0,
              f"the {BIG}^2 JPEG TIFF did not take the whole engine: {n}")
        try:
            cli.main([path, "--tool", "unmicst-legacy", "--model", "shallow",
                      "--modelRoot", zoo, "--stackOutput", "--engine",
                      "streaming", "--outputPath",
                      os.path.join(tmp, "out", "streaming")], device=dev)
            refused = "no error"
        except NotImplementedError as e:
            refused = f"NotImplementedError: {e}"
        log(f"[slice15] --engine streaming on it: {refused}")
        check(refused.startswith("NotImplementedError"),
              "--engine streaming read a JPEG TIFF, which JAX refuses")
        del plane, fplane
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[slice15] phase {time.perf_counter() - t_phase:.1f}s")
    return {name: {path: counts[name] for path, counts in launches.items()}
            for name in ("softmax_blend", "blend_fold_epilogue",
                         "blend_fold_stripe")}


def jpeg_parts(stream: bytes) -> dict:
    """A baseline JPEG stream taken apart as an old-style JPEG TIFF in the
    table form stores it: per component its quantisation table (64
    bytes, zigzag order), DC and AC Huffman tables (16 counts, then the
    values), and sampling byte; the frame's size; the restart interval
    (DRI, 0 without one); the header up to and with the SOS segment; and
    the entropy-coded data cut at its restart markers, which are
    dropped."""
    pos, q, huff, dri = 2, {}, {}, 0
    while True:
        marker = stream[pos + 1]
        n = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        body = stream[pos + 4:pos + 2 + n]
        if marker == 0xDB:
            for i in range(0, len(body), 65):
                q[body[i] & 15] = body[i + 1:i + 65]
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                count = sum(body[i + 1:i + 17])
                huff[body[i]] = body[i + 1:i + 17 + count]
                i += 17 + count
        elif marker in (0xC0, 0xC1):
            sof = body
        elif marker == 0xDD:
            dri = struct.unpack(">H", body)[0]
        elif marker == 0xDA:
            sos = body
            pos += 2 + n
            break
        pos += 2 + n
    nc = sof[5]
    comps = [sof[6 + 3 * k:9 + 3 * k] for k in range(nc)]
    sel = [sos[2 + 2 * k] for k in range(nc)]
    scan = stream[pos:stream.rindex(b"\xff\xd9")]
    intervals, cur, i = [], bytearray(), 0
    while i < len(scan):
        if scan[i] == 0xFF and 0xD0 <= scan[i + 1] <= 0xD7:
            intervals.append(bytes(cur))
            cur, i = bytearray(), i + 2
            continue
        cur.append(scan[i])
        i += 1
    intervals.append(bytes(cur))
    return {"q": [q[c[2]] for c in comps],
            "dc": [huff[t >> 4] for t in sel],
            "ac": [huff[0x10 | (t & 15)] for t in sel],
            "sampling": [c[1] for c in comps],
            "size": struct.unpack(">HH", sof[1:5]), "restart": dri,
            "header": stream[:pos], "intervals": intervals}


def ojpeg_tiff(path: str, h: int, w: int, parts: dict, segments,
               photometric: int = 1, rows_per_strip=None, tile=None,
               form: str = "tables", tags=None) -> None:
    """A one-page old-style JPEG TIFF (compression 6) of ``segments`` (the
    strips or tiles' bytes), in ``form`` "tables": JPEGProc 1,
    JPEGRestartInterval and JPEGQTables, JPEGDCTables and JPEGACTables
    (519-521) pointing at ``parts``' tables (:func:`jpeg_parts`), placed
    after the header, a component whose table equals its predecessor's
    sharing its offset; or "jif": JPEGInterchangeFormat (513/514)
    pointing at ``parts["header"]``.  ``tags`` adds or overrides tags."""
    samples = len(parts["q"])
    prefix, offsets, placed = bytearray(), {519: [], 520: [], 521: []}, {}
    if form == "jif":
        prefix += parts["header"]
    else:
        for tag, key in ((519, "q"), (520, "dc"), (521, "ac")):
            for table in parts[key]:
                if table not in placed:
                    prefix += bytes(len(prefix) % 2)
                    placed[table] = 8 + len(prefix)
                    prefix += table
                offsets[tag].append(placed[table])
    base = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * samples),
            259: (3, [6]), 262: (3, [photometric]), 277: (3, [samples]),
            284: (3, [1])}
    if form == "jif":
        base.update({513: (4, [8]), 514: (4, [len(parts["header"])])})
    else:
        base.update({512: (3, [1]), 515: (3, [parts["restart"]]),
                     519: (4, offsets[519]), 520: (4, offsets[520]),
                     521: (4, offsets[521])})
    if tile is not None:
        base[322], base[323] = (4, [tile[1]]), (4, [tile[0]])
    else:
        base[278] = (4, [rows_per_strip or h])
    write_segment_tiff(path, [({**base, **(tags or {})}, list(segments))],
                       prefix=bytes(prefix))


BILEVEL_FIXTURES = os.path.join(ROOT, "tests", "fixtures",
                                "torch_tiff_bilevel")


def _packbits_literal(data: bytes) -> bytes:
    """PackBits of literal runs only."""
    return b"".join(bytes([len(data[i:i + 128]) - 1]) + data[i:i + 128]
                    for i in range(0, len(data), 128))


def segment_encoder(compression: int):
    """The encoder of one strip or tile under a TIFF compression the
    port decodes: none, LZW, Deflate (8 or 32946), PackBits (literal
    runs), LZMA (xz) or zstd (the port's libzstd binding)."""
    import lzma
    import zlib

    from unmicst_tpu_torch.io import zstd

    return {1: lambda b: b, 5: lzw_encode, 8: zlib.compress,
            32946: zlib.compress, 32773: _packbits_literal,
            34925: lambda b: lzma.compress(b, format=lzma.FORMAT_XZ),
            50000: zstd.compress}[compression]


def pack_samples(plane, bits: int):
    """``plane``'s samples (integers below ``2 ** bits``; 1, 2, 4 or 12
    bits) packed as TIFF stores them: most significant bit first, each
    row padded to a whole byte.  ``[rows, ceil(cols * bits / 8)]``
    uint8."""
    import numpy as np

    v = np.asarray(plane).astype(np.uint16)
    h, w = v.shape
    if bits == 12:
        v = np.pad(v, ((0, 0), (0, w % 2)))
        a, b = v[:, 0::2], v[:, 1::2]
        trio = np.stack([a >> 4, ((a & 15) << 4) | (b >> 8), b & 255], -1)
        return trio.reshape(h, -1)[:, : (w * 12 + 7) // 8].astype(np.uint8)
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint16)
    flat = ((v[:, :, None] >> shifts) & 1).astype(np.uint8).reshape(h, -1)
    return np.packbits(flat, axis=1)


def packed_tiff(path: str, plane, bits: int, compression: int = 1,
                rows_per_strip: int = 0, photometric=1, byteorder="<",
                fill_order: int = 1, predictor: int = 0,
                repeat: int = 1, colormap=None) -> int:
    """A one-page gray TIFF of ``plane`` at ``bits`` (1, 2, 4 or 12) bits
    a sample, in strips of ``rows_per_strip`` rows (all rows by default)
    under ``compression`` (:func:`segment_encoder`); ``photometric``
    None leaves the tag out, ``fill_order`` 2 stores every byte's bits
    reversed (of the coded bytes: libtiff reverses them before it
    decodes), ``predictor`` writes tag 317 without applying it;
    ``repeat`` > 1 writes the strips that many times over, a page of
    ``np.tile(plane, (repeat, 1))`` coded once; ``colormap`` (3 * 2**bits
    values) is a palette page's ColorMap (tag 320).  Returns the coded
    bytes."""
    import numpy as np

    h, w = plane.shape
    rows = rows_per_strip or h
    packed = pack_samples(plane, bits)
    segments = [segment_encoder(compression)(packed[r:r + rows].tobytes())
                for r in range(0, h, rows)] * repeat
    h *= repeat
    if fill_order == 2:
        rev = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                       np.uint8)
        segments = [rev[np.frombuffer(seg, np.uint8)].tobytes()
                    for seg in segments]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits]),
            259: (3, [compression]), 277: (3, [1]), 278: (4, [rows])}
    if photometric is not None:
        tags[262] = (3, [photometric])
    if fill_order != 1:
        tags[266] = (3, [fill_order])
    if predictor:
        tags[317] = (3, [predictor])
    if colormap is not None:
        tags[320] = (3, list(colormap))
    write_segment_tiff(path, [(tags, segments)], byteorder)
    return sum(map(len, segments))


def ccitt_tags(h: int, w: int, compression: int, rows_per_strip=None,
               tile=None, photometric=0, t4_options=None) -> dict:
    """The tags of a bilevel CCITT page (compression 2, 3 or 4) in strips
    of ``rows_per_strip`` rows or tiles ``(th, tw)``."""
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [1]),
            259: (3, [compression]), 277: (3, [1])}
    if photometric is not None:
        tags[262] = (3, [photometric])
    if tile is not None:
        tags[322], tags[323] = (4, [tile[1]]), (4, [tile[0]])
    else:
        tags[278] = (4, [rows_per_strip or h])
    if t4_options is not None:
        tags[292] = (4, [t4_options])
    return tags


def phase_slice16(dev) -> dict:
    """The rest of the TIFF pages the JAX package reads through PIL (M17,
    second part), through ``cli.main`` on the card, each byte-equal to
    its plain twin: a 4096^2 Group 4 bilevel slide of 64 strips (each a
    copy of the committed 4096 x 64 fixture strip) against the same
    1-bit pixels uncompressed, both on the host float path; a 4096^2
    12-bit LZW slide against its uint16 pixels as a plain TIFF; a 4096^2
    PNG under a TIFF name against its pixels as a TIFF.  The CCITT decode
    natively (MB/s) and in Python on one strip, byte-equal; every
    committed fixture of ``tests/fixtures/torch_tiff_bilevel`` (bilevel,
    old-style JPEG, colour JPEG and planar RGB pages) read equal to PIL's
    read.  Returns, per kernel, its launches on each counted path."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.io import _native, ccitt, png
    from unmicst_tpu_torch.io.tiff import TiffFile, imread, imwrite, num_pages

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {}
    hp = legacy_hp()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice16_")
    try:
        zoo = os.path.join(tmp, "zoo")
        write_model_dir(zoo, "nucleiDAPI", hp, seeded_state(
            hp, "legacy", SEED), "legacy", LEGACY_MEAN, LEGACY_STD)

        def run(src, name, count):
            out = os.path.join(tmp, "out", name)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main([src, "--tool", "unmicst-legacy", "--model",
                           "nucleiDAPI", "--modelRoot", zoo, "--stackOutput",
                           "--outputPath", out], device=dev)
            secs = time.perf_counter() - t0
            launches[count] = kernels.launch_counts()
            check(rc == 0, f"cli.main {name}: rc {rc}")
            (maps,) = [os.path.join(out, f) for f in os.listdir(out)
                       if "_Probabilities_" in f]
            return [imread(maps, k) for k in range(num_pages(maps))], secs

        def against_twin(path, twin, label, count, twin_count):
            """The CLI on ``path`` against the CLI on its plain twin:
            pages byte-equal, K1 launched and one K2 epilogue each."""
            t_maps, t_secs = run(twin, f"twin_{count}", twin_count)
            c_maps, c_secs = run(path, count, count)
            same = len(c_maps) == len(t_maps) == 3 and all(
                np.array_equal(a, b) for a, b in zip(c_maps, t_maps))
            for key, secs in ((count, c_secs), (twin_count, t_secs)):
                n = launches[key]
                log(f"[slice16] {label}, {key}: cli.main {secs:.2f} s; K1 "
                    f"{n['softmax_blend']}, K2 epilogue "
                    f"{n['blend_fold_epilogue']}, K2 stripe "
                    f"{n['blend_fold_stripe']} | {card}")
                check(n["softmax_blend"] > 0
                      and n["blend_fold_epilogue"] == 1
                      and n["blend_fold_stripe"] == 0,
                      f"{label} ({key}) did not run K1 and one K2 "
                      f"epilogue: {n}")
            log(f"[slice16] {label}: pages byte-equal to the twin's: {same}")
            check(same, f"{label}: pages differ from the plain twin's")

        def decode_s(path):
            """The fallback's decode alone, twice: (seconds, pixels)."""
            secs = []
            for _ in range(2):
                t0 = time.perf_counter()
                got = imread(path)
                secs.append(time.perf_counter() - t0)
            return secs, got

        # -- 1. the CCITT strip: native, Python and PIL's read -----------------
        fixture = os.path.join(BILEVEL_FIXTURES, "blob_strip_g4.tif")
        with TiffFile(fixture) as tf:
            page = tf.pages[0]
            strip = tf._stored(page, 0)
        rows, width = page.height, page.width
        want = np.load(fixture[:-4] + ".npy")
        check(_native.get_lib() is not None, "the native codec did not load")
        t0 = time.perf_counter()
        native = _native.ccitt_decode(strip, width, rows, 4)
        nat_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        python = ccitt.decode(strip, width, rows, 4)
        py_s = time.perf_counter() - t0
        photometric = page.photometric
        pil = want if photometric == 1 else ~want  # PIL's read, as coded
        log(f"[slice16] Group 4 strip {rows}x{width} ({len(strip)} B): "
            f"native {nat_s * 1e3:.3f} ms, Python {py_s:.3f} s; native == "
            f"Python: {np.array_equal(native, python)}; == PIL's read: "
            f"{np.array_equal(native, pil)} | {card}")
        check(np.array_equal(native, python) and np.array_equal(native, pil),
              "the CCITT decoders disagree with each other or with PIL")

        # -- 2. a 4096^2 Group 4 slide against its 1-bit pixels uncompressed -
        n_strips = SLIDE // rows
        g4 = os.path.join(tmp, "bilevel_g4.tif")
        write_segment_tiff(g4, [(ccitt_tags(
            SLIDE, width, 4, rows, photometric=photometric),
            [strip] * n_strips)])
        bits = np.tile(np.unpackbits(want, axis=1)[:, :width], (n_strips, 1))
        flat = os.path.join(tmp, "bilevel_none.tif")
        packed_tiff(flat, bits if photometric == 1 else 1 - bits, 1, 1, rows,
                    photometric)
        secs, got = decode_s(g4)
        nbytes = len(strip) * n_strips
        log(f"[slice16] Group 4 {SLIDE}^2 ({n_strips} strips, "
            f"{nbytes / 1e6:.3f} MB): native decode {secs[0]:.4f} s first, "
            f"{secs[1]:.4f} s again = {nbytes / 1e6 / min(secs):.2f} MB/s "
            f"of segments ({SLIDE * width / 1e6 / min(secs):.1f} Mpx/s); "
            f"Python decode of one strip {py_s:.3f} s (the whole slide "
            f"about {py_s * n_strips:.1f} s) | {card}")
        check(got.dtype == bool and np.array_equal(got, bits.astype(bool)),
              "the Group 4 slide does not decode to its pixels")
        against_twin(g4, flat, f"bilevel {SLIDE}^2 (the host float path)",
                     "g4_bilevel", "bilevel_uncompressed")

        # -- 3. a 4096^2 12-bit LZW slide against its uint16 pixels ------------
        # one 64-row strip coded once and repeated, as the Group 4 slide
        rng = np.random.RandomState(SEED + 16)
        band = (np.clip(blob_slide(rng, 64, SLIDE, 64), 0, 1)
                * 4095).astype(np.uint16)
        deep = np.tile(band, (SLIDE // 64, 1))
        lzw = os.path.join(tmp, "deep_12bit_lzw.tif")
        t0 = time.perf_counter()
        nbytes = packed_tiff(lzw, band, 12, 5, 64, repeat=SLIDE // 64)
        log(f"[slice16] 12-bit LZW {SLIDE}^2 ({SLIDE // 64} copies of one "
            f"64-row strip) written in {time.perf_counter() - t0:.2f} s "
            f"({nbytes / 1e6:.1f} MB)")
        secs, got = decode_s(lzw)
        log(f"[slice16] 12-bit LZW {SLIDE}^2: decode {secs[0]:.3f} s first, "
            f"{secs[1]:.3f} s again = {nbytes / 1e6 / min(secs):.2f} MB/s "
            f"of segments | {card}")
        check(got.dtype == np.uint16 and np.array_equal(got, deep),
              "the 12-bit slide does not decode to its pixels")
        plain = os.path.join(tmp, "deep_uint16.tif")
        imwrite(plain, deep)
        against_twin(lzw, plain, f"12-bit LZW {SLIDE}^2", "lzw_12bit",
                     "uint16_plain")

        # -- 4. a PNG under a TIFF name ----------------------------------------
        u8 = (np.clip(blob_slide(rng, SLIDE, SLIDE, 4000), 0, 1)
              * 255).astype(np.uint8)
        png_tif = os.path.join(tmp, "png_as.tif")
        png.write_png(png_tif, u8)
        secs, got = decode_s(png_tif)
        log(f"[slice16] PNG {SLIDE}^2 under a TIFF name: read "
            f"{min(secs):.3f} s | {card}")
        check(np.array_equal(got, u8), "png_as.tif does not read its pixels")
        plain = os.path.join(tmp, "u8_plain.tif")
        imwrite(plain, u8)
        against_twin(png_tif, plain, f"PNG as TIFF {SLIDE}^2", "png_as_tif",
                     "uint8_plain")
        del bits, deep, u8, got

        # -- 5. the committed fixtures -----------------------------------------
        names = sorted(f[:-4] for f in os.listdir(BILEVEL_FIXTURES)
                       if f.endswith(".tif") and os.path.exists(
                           os.path.join(BILEVEL_FIXTURES, f[:-4] + ".npy")))
        bad = []
        for name in names:
            path = os.path.join(BILEVEL_FIXTURES, name + ".tif")
            ref = np.load(path[:-4] + ".npy")
            px = imread(path)
            if name == "blob_strip_g4":
                px = np.packbits(px, axis=1)
            if px.dtype != ref.dtype or not np.array_equal(px, ref):
                bad.append(name)
        log(f"[slice16] {len(names)} fixtures (bilevel, old-style JPEG, "
            f"colour JPEG, planar RGB) equal to PIL's reads: "
            f"{len(names) - len(bad)}; differing: {bad}")
        check(not bad, f"fixtures differ from PIL's reads: {bad}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[slice16] phase {time.perf_counter() - t_phase:.1f}s")
    return {name: {path: counts[name] for path, counts in launches.items()}
            for name in ("softmax_blend", "blend_fold_epilogue",
                         "blend_fold_stripe")}


# -- phase 19: the rest of the TIFF pages, and the toolbox's formats ---------

TIFF_PAGES_FIXTURES = os.path.join(ROOT, "tests", "fixtures",
                                   "torch_tiff_pages")
FORMATS_FIXTURES = os.path.join(ROOT, "tests", "fixtures",
                                "torch_image_formats")
BOOL_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_imtools_bool",
                            "bool_filters.npz")


def ojpeg_fixture_parts(path: str) -> tuple:
    """A one-strip gray old-style JPEG fixture in the table form, read
    with the port's ``TiffFile``: its tables as :func:`jpeg_parts` gives
    them, and its strip's bytes."""
    from unmicst_tpu_torch.io.tiff import TiffFile

    with TiffFile(path) as tf:
        page = tf.pages[0]
        strip = tf._stored(page, 0)
        tables = {}
        for tag, key in ((519, "q"), (520, "dc"), (521, "ac")):
            tf._fh.seek(int(page.fallback_tags[tag][0]))
            head = tf._fh.read(64 if key == "q" else 16)
            tables[key] = [head if key == "q"
                           else head + tf._fh.read(sum(head))]
    return {**tables, "restart": 0}, strip


def phase_slice17(dev) -> dict:
    """The rest of the TIFF pages the JAX package reads through PIL and
    the toolbox's formats (M17, third part), and F5: through ``cli.main``
    on the card, each byte-equal to its plain twin: a 4096^2 gray
    old-style JPEG slide in the table form (256 strips, each the
    committed 4096 x 16 fixture strip's scan) against its decoded pixels
    as a plain TIFF, and a 4096^2 4-bit palette slide (Deflate) against
    its indices as a plain uint8 TIFF, with the fallback's decode seconds;
    every committed fixture of ``tests/fixtures/torch_tiff_pages`` and
    ``torch_image_formats`` read equal to PIL's read, and ``imwrite`` of
    each dtype read back to PIL's read of PIL's file (or refused where
    PIL refuses); the toolbox's Gaussian filters on a bool image on the
    card byte-equal to scipy's.  Returns, per kernel, its launches on
    each counted path."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.io.tiff import imread, imwrite, num_pages
    from unmicst_tpu_torch.utils import imtools

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {}
    hp = legacy_hp()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice17_")
    try:
        zoo = os.path.join(tmp, "zoo")
        write_model_dir(zoo, "nucleiDAPI", hp, seeded_state(
            hp, "legacy", SEED), "legacy", LEGACY_MEAN, LEGACY_STD)

        def run(src, name):
            out = os.path.join(tmp, "out", name)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main([src, "--tool", "unmicst-legacy", "--model",
                           "nucleiDAPI", "--modelRoot", zoo, "--stackOutput",
                           "--outputPath", out], device=dev)
            secs = time.perf_counter() - t0
            launches[name] = kernels.launch_counts()
            check(rc == 0, f"cli.main {name}: rc {rc}")
            (maps,) = [os.path.join(out, f) for f in os.listdir(out)
                       if "_Probabilities_" in f]
            return [imread(maps, k) for k in range(num_pages(maps))], secs

        def against_twin(path, twin, label, name, twin_name):
            t_maps, t_secs = run(twin, twin_name)
            c_maps, c_secs = run(path, name)
            same = len(c_maps) == len(t_maps) == 3 and all(
                np.array_equal(a, b) for a, b in zip(c_maps, t_maps))
            for key, secs in ((name, c_secs), (twin_name, t_secs)):
                n = launches[key]
                log(f"[slice17] {label}, {key}: cli.main {secs:.2f} s; K1 "
                    f"{n['softmax_blend']}, K2 epilogue "
                    f"{n['blend_fold_epilogue']}, K2 stripe "
                    f"{n['blend_fold_stripe']} | {card}")
                check(n["softmax_blend"] > 0
                      and n["blend_fold_epilogue"] == 1
                      and n["blend_fold_stripe"] == 0,
                      f"{label} ({key}) did not run K1 and one K2 "
                      f"epilogue: {n}")
            log(f"[slice17] {label}: pages byte-equal to the twin's: {same}")
            check(same, f"{label}: pages differ from the plain twin's")

        def decode_s(path):
            secs = []
            for _ in range(2):
                t0 = time.perf_counter()
                got = imread(path)
                secs.append(time.perf_counter() - t0)
            return secs, got

        # -- 1. a 4096^2 old-style JPEG slide in the table form --------------
        fixture = os.path.join(TIFF_PAGES_FIXTURES, "blob_strip_ojpeg.tif")
        strip_px = np.load(fixture[:-4] + ".npy")
        check(np.array_equal(imread(fixture), strip_px),
              "the old-style JPEG strip does not read as PIL reads it")
        parts, strip = ojpeg_fixture_parts(fixture)
        rows, width = strip_px.shape
        ojpeg = os.path.join(tmp, "ojpeg_table.tif")
        ojpeg_tiff(ojpeg, SLIDE, width, parts, [strip] * (SLIDE // rows),
                   rows_per_strip=rows)
        plane = np.tile(strip_px, (SLIDE // rows, 1))
        secs, got = decode_s(ojpeg)
        nbytes = len(strip) * (SLIDE // rows)
        log(f"[slice17] old-style JPEG {SLIDE}x{width} in the table form "
            f"({SLIDE // rows} strips, {nbytes / 1e6:.3f} MB): decode "
            f"{secs[0]:.3f} s first, {secs[1]:.3f} s again = "
            f"{nbytes / 1e6 / min(secs):.2f} MB/s of segments | {card}")
        check(got.dtype == np.uint8 and np.array_equal(got, plane),
              "the old-style JPEG slide does not decode to its pixels")
        plain = os.path.join(tmp, "ojpeg_plain.tif")
        imwrite(plain, plane)
        against_twin(ojpeg, plain, f"old-style JPEG {SLIDE}^2",
                     "ojpeg_table", "ojpeg_plain")

        # -- 2. a 4096^2 4-bit palette slide ---------------------------------
        rng = np.random.RandomState(SEED + 17)
        band = (np.clip(blob_slide(rng, 256, SLIDE, 256), 0, 1)
                * 15).astype(np.uint8)
        idx = np.tile(band, (SLIDE // 256, 1))
        pal = os.path.join(tmp, "palette4.tif")
        nbytes = packed_tiff(pal, band, 4, 8, 64, photometric=3,
                             repeat=SLIDE // 256,
                             colormap=[v * 4369 for v in range(16)] * 3)
        secs, got = decode_s(pal)
        log(f"[slice17] 4-bit palette {SLIDE}^2 (Deflate, {nbytes / 1e6:.3f}"
            f" MB): decode {secs[0]:.3f} s first, {secs[1]:.3f} s again | "
            f"{card}")
        check(got.dtype == np.uint8 and np.array_equal(got, idx),
              "the palette slide does not decode to its indices")
        plain = os.path.join(tmp, "palette_plain.tif")
        imwrite(plain, idx)
        against_twin(pal, plain, f"4-bit palette {SLIDE}^2", "palette4",
                     "palette_plain")
        del plane, idx, got

        # -- 3. the committed fixtures, and imwrite's round trips ------------
        bad, n = [], 0
        for folder, ext, read in ((TIFF_PAGES_FIXTURES, (".tif",), imread),
                                  (FORMATS_FIXTURES, (".png", ".bmp"),
                                   imtools.imread)):
            for f in sorted(os.listdir(folder)):
                ref = os.path.join(folder, f.rsplit(".", 1)[0] + ".npy")
                if not f.endswith(ext) or not os.path.exists(ref):
                    continue
                n += 1
                want, px = np.load(ref), read(os.path.join(folder, f))
                if px.dtype != want.dtype or not np.array_equal(px, want):
                    bad.append(f)
        trips = 0
        for f in sorted(os.listdir(FORMATS_FIXTURES)):
            if not (f.startswith("write_") and f.count("_") == 1):
                continue
            x = np.load(os.path.join(FORMATS_FIXTURES, f))
            for ext in ("png", "bmp"):
                ref = os.path.join(FORMATS_FIXTURES, f"{f[:-4]}_{ext}.npy")
                out = os.path.join(tmp, f"{f[:-4]}.{ext}")
                trips += 1
                try:
                    imtools.imwrite(x, out)
                except OSError:
                    if os.path.exists(ref):
                        bad.append(f"{f[:-4]}.{ext} refused")
                    continue
                want, px = np.load(ref), imtools.imread(out)
                if px.dtype != want.dtype or not np.array_equal(px, want):
                    bad.append(f"{f[:-4]}.{ext}")
        log(f"[slice17] {n} fixtures (old-style JPEG, YCbCr, planar, "
            f"palette TIFF pages; PNG and BMP files) and {trips} imwrite "
            f"round trips equal to PIL's reads: {n + trips - len(bad)}; "
            f"differing: {bad}")
        check(not bad, f"fixtures or writes differ from PIL's: {bad}")

        # -- 4. F5: the Gaussian filters on a bool image, on the card --------
        ref = np.load(BOOL_FIXTURE)
        img = ref["image"]
        calls = {"gauss_0.7_order02": lambda: imtools.imgaussfilt(
                     img, 0.7, order=[0, 2], device=dev),
                 "gauss_1.0_order1_cval3": lambda: imtools.imgaussfilt(
                     img, 1.0, order=1, mode="constant", cval=3.0,
                     device=dev),
                 "gauss_0.5_order2": lambda: imtools.imgaussfilt(
                     img, 0.5, order=2, device=dev),
                 "gauss_1.0": lambda: imtools.imgaussfilt(img, 1.0,
                                                          device=dev),
                 "gradmag_1.0": lambda: imtools.imgradmag(img, 1.0,
                                                          device=dev),
                 "derivatives_0.7": lambda: imtools.imderivatives(
                     img, [0.7], device=dev)}
        bad = []
        for name, fn in calls.items():
            got = fn()
            got = got.view(np.uint8) if got.dtype == np.bool_ else got
            if got.dtype != ref[name].dtype or got.tobytes() != ref[
                    name].tobytes():
                bad.append(name)
        log(f"[slice17] F5: {len(calls)} filters of a bool image on {dev} "
            f"byte-equal to scipy's: {len(calls) - len(bad)}; differing: "
            f"{bad}")
        check(not bad, f"bool filters differ from scipy's: {bad}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[slice17] phase {time.perf_counter() - t_phase:.1f}s")
    return {name: {path: counts[name] for path, counts in launches.items()}
            for name in ("softmax_blend", "blend_fold_epilogue",
                         "blend_fold_stripe")}


# -- phase 20: GIF, JPEG write, lossless JPEG (M17, fourth part) -------------

GIF_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_gif")
JPEG_WRITE_FIXTURES = os.path.join(ROOT, "tests", "fixtures",
                                   "torch_jpeg_write")


def gif_file(width: int, height: int, frames, palette: bytes = None,
             background: int = 0, version: bytes = b"89a") -> bytes:
    """A GIF built here: a logical screen ``width`` x ``height`` with the
    global colour table ``palette`` (RGB bytes, padded to a power of two;
    None: none), then ``frames``, each a dict with ``pixels`` (``[h, w]``
    indices) and optionally ``x``, ``y`` (its offset), ``palette`` (a
    local table), ``transparency``, ``disposal``, ``interlace``, ``bits``
    (the LZW minimum code size, 8 by default) and ``comment``; the LZW
    codes are Pillow's encoder's (``io/gif.py``)."""
    import numpy as np

    from unmicst_tpu_torch.io import gif

    def table(pal):
        size = max(0, (len(pal) // 3 - 1).bit_length() - 1)
        return size, bytes(pal) + bytes(3 * (2 << size) - len(pal))

    flags, body = 0, b""
    if palette is not None:
        size, body = table(palette)
        flags = 128 | size
    out = [b"GIF" + version + struct.pack("<HHBBB", width, height, flags,
                                          background, 0) + body]
    for fr in frames:
        if fr.get("comment"):
            out.append(b"!\xfe" + bytes([len(fr["comment"])]) + fr["comment"]
                       + b"\0")
        t, disposal = fr.get("transparency"), fr.get("disposal", 0)
        if t is not None or disposal:
            out.append(b"!\xf9\x04" + struct.pack(
                "<BHBB", (t is not None) | (disposal << 2), 0, t or 0, 0))
        px = np.asarray(fr["pixels"], np.uint8)
        h, w = px.shape
        fl, local = (64 if fr.get("interlace") else 0), b""
        if fr.get("palette") is not None:
            size, local = table(fr["palette"])
            fl |= 128 | size
        out.append(b"," + struct.pack("<HHHHB", fr.get("x", 0), fr.get("y", 0),
                                      w, h, fl) + local)
        if fr.get("interlace"):
            px = np.concatenate([px[0::8], px[4::8], px[2::4], px[1::2]])
        bits = fr.get("bits", 8)
        out.append(bytes([bits]) + gif.sub_blocks(
            gif.lzw_codes(np.ascontiguousarray(px).tobytes(), bits), w)
            + b"\0")
    return b"".join(out) + b";"


def gif_two_frames(frame0, frame1) -> bytes:
    """The port's GIF writer's file of the uint8 ``frame0`` with a second
    frame, ``frame1``'s values under the same global table, appended."""
    import numpy as np

    from unmicst_tpu_torch.io import gif

    h, w = frame1.shape
    px = np.ascontiguousarray(frame1, np.uint8)
    return (gif.encode_gif(frame0)[:-1] + b"," + struct.pack(
        "<HHHHB", 0, 0, w, h, 0) + b"\x08"
        + gif.sub_blocks(gif.lzw_codes(px.tobytes(), 8), w) + b"\0;")


# a lossless stream's Huffman table: categories 0-16, 5 bits each
_LOSSLESS_BITS = bytes([0, 0, 0, 0, 17] + [0] * 11)


def lossless_jpeg(img, predictor: int = 1, pt: int = 0,
                  restart_rows: int = 0, ids=None, jfif: bool = False,
                  repeat: int = 1) -> bytes:
    """A lossless (SOF3) JPEG of the uint8 ``[h, w]`` or ``[h, w, 3]``
    ``img`` (one scan, components interleaved, 1x1): samples ``>> pt``,
    each predicted by ``predictor`` (1-7; the first row of the scan and of
    each restart interval from the left, from ``2**(7 - pt)`` at its
    start, later rows' first sample from above), the differences modulo
    2**16 coded by category under one table of 5-bit codes; a restart
    marker every ``restart_rows`` rows (0: none); component ids ``ids``
    (1, 2, 3 by default); a JFIF APP0 where ``jfif``.  ``repeat`` > 1
    stacks the image that many times, each copy's restart intervals (one
    a copy where ``restart_rows`` is 0, else dividing its rows) the
    first's data again.  The
    interval, ``restart_rows * width`` MCUs, must fit DRI's 16 bits.
    Vectorised: a 2048^2 plane takes about 2 s."""
    import numpy as np

    planes = [img] if img.ndim == 2 else [img[..., k] for k in
                                          range(img.shape[2])]
    nc = len(planes)
    h, w = planes[0].shape
    first = np.zeros(h, bool)
    first[0] = True
    if restart_rows:
        first[::restart_rows] = True
    diffs = []
    for plane in planes:
        x = plane.astype(np.int64) >> pt
        ra, rb, rc = (np.zeros_like(x) for _ in range(3))
        ra[:, 1:], rb[1:], rc[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
        pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                7: (ra + rb) >> 1}[predictor].copy()
        pred[:, 0] = rb[:, 0]
        pred[first] = ra[first]
        pred[first, 0] = 1 << (7 - pt)
        diffs.append((x - pred) & 0xFFFF)
    d = np.stack(diffs, -1).reshape(h, w * nc)
    signed = np.where(d > 32768, d - 65536, d)
    cat = np.where(d == 32768, 16, np.ceil(np.log2(np.abs(signed) + 1))
                   ).astype(np.int64)
    extra = np.where(signed < 0, signed - 1, signed) & ((1 << cat) - 1)
    extra = np.where(cat == 16, 0, extra)
    nbits = 5 + np.where(cat == 16, 0, cat)
    code = (cat << (nbits - 5)) | extra
    ids = list(ids or range(1, nc + 1))
    head = [b"\xff\xd8"]
    if jfif:
        head.append(b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00"
                    b"\x01\x00\x00")
    if repeat > 1 and not restart_rows:
        restart_rows = h
    if repeat > 1 and h % restart_rows:
        raise ValueError(f"{restart_rows}-row restart intervals do not "
                         f"tile a {h}-row copy")
    if restart_rows * w > 65535:
        raise ValueError(f"a restart interval of {restart_rows} rows of {w}"
                         " MCUs does not fit DRI's 16 bits")
    sof = struct.pack(">BHHB", 8, h * repeat, w, nc) + b"".join(
        bytes([i, 0x11, 0]) for i in ids)
    head.append(b"\xff\xc3" + struct.pack(">H", len(sof) + 2) + sof)
    dht = b"\x00" + _LOSSLESS_BITS + bytes(range(17))
    head.append(b"\xff\xc4" + struct.pack(">H", len(dht) + 2) + dht)
    if restart_rows:
        head.append(b"\xff\xdd\x00\x04" + struct.pack(">H",
                                                     restart_rows * w))
    sos = bytes([nc]) + b"".join(bytes([i, 0]) for i in ids) + bytes(
        [predictor, 0, pt])
    head.append(b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos)
    chunks = []
    starts = list(np.flatnonzero(first)) + [h]
    lane = np.arange(32)
    for k, (r0, r1) in enumerate(zip(starts[:-1], starts[1:])):
        n, v = nbits[r0:r1].ravel(), code[r0:r1].ravel()
        packed, carry = [], np.zeros(0, np.uint8)
        for a in range(0, len(n), 1 << 20):  # each code's bits, MSB first
            nn = n[a : a + (1 << 20)]
            words = (v[a : a + (1 << 20)] << (32 - nn)).astype(">u4")
            bits = np.unpackbits(words.view(np.uint8)).reshape(-1, 32)[
                lane < nn[:, None]]
            bits = np.concatenate([carry, bits])
            cut = len(bits) // 8 * 8
            packed.append(np.packbits(bits[:cut]))
            carry = bits[cut:]
        if len(carry):  # the interval's last byte padded with ones
            packed.append(np.packbits(np.concatenate(
                [carry, np.ones(8 - len(carry), np.uint8)])))
        data = np.concatenate(packed)
        data = np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0)
        chunks.append(data.tobytes())
    out = [b"".join(head)]
    for k, chunk in enumerate(chunks * repeat):
        if k:
            out.append(bytes([0xFF, 0xD0 + (k - 1) % 8]))
        out.append(chunk)
    return b"".join(out) + b"\xff\xd9"


def sampled_jpeg(height: int, width: int, planes, hv) -> bytes:
    """A baseline colour JPEG of ``height`` x ``width`` (JFIF, components
    1-3, quality 75's tables, the standard Huffman tables) of the uint8
    component ``planes``, each at its sampled size (``ceil(height * v /
    vmax)`` rows), sampled ``hv`` = ``[(h, v), ...]``: each plane's edges
    repeated out to whole MCUs, the port's forward DCT and entropy coder
    (``io/jpegenc.py``), the MCUs interleaved."""
    import numpy as np

    from unmicst_tpu_torch.io import jpegenc as je

    h, w = height, width
    hmax, vmax = max(a for a, _ in hv), max(b for _, b in hv)
    mr, mc = -(-h // (8 * vmax)), -(-w // (8 * hmax))
    qs = [je.quant_table(je._BASE_LUMA), je.quant_table(je._BASE_CHROMA)]
    grids = [je._component(je._pad(p, mr * v * 8, mc * a * 8), qs[min(k, 1)])
             for k, (p, (a, v)) in enumerate(zip(planes, hv))]
    blocks, slots = [], []
    for my in range(mr):
        for mx in range(mc):
            for k, (a, v) in enumerate(hv):
                for by in range(v):
                    for bx in range(a):
                        blocks.append(grids[k][my * v + by, mx * a + bx])
                        slots.append(k)
    coef = np.ascontiguousarray(np.stack(blocks), np.int16)
    dc = [je.huff_codes(je._STD_HUFF[(0, min(k, 1))]) for k in range(3)]
    ac = [je.huff_codes(je._STD_HUFF[(1, min(k, 1))]) for k in range(3)]
    scan = je.encode_blocks_py(coef, np.array(slots, np.uint8), dc, ac)
    sof = struct.pack(">BHHB", 8, h, w, 3) + b"".join(
        bytes([k + 1, (a << 4) | v, min(k, 1)]) for k, (a, v) in
        enumerate(hv))
    return (b"\xff\xd8" + je._JFIF + je._dqt(0, qs[0]) + je._dqt(1, qs[1])
            + je._segment(0xC0, sof) + je._dht(0, 0) + je._dht(1, 0)
            + je._dht(0, 1) + je._dht(1, 1)
            + je._segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                       0]))
            + scan + b"\xff\xd9")


def phase_slice18(dev) -> dict:
    """GIF read and write, JPEG write and lossless JPEG frames (M17,
    fourth part), through ``cli.main`` on the card (the legacy net at
    nucleiDAPI's widths, seeded weights), each slide byte-equal to its
    plain twin: a 4096^2 two-frame GIF under a ``.tif`` name (frame 0 8-bit
    gray with all 256 levels, so the table is the identity ramp and the
    frames read as gray planes; written by the port's GIF writer), channel
    1 (frame 0) and channel 2 (frame 1) against the same pixels as plain
    uint8 TIFFs, and a two-frame palette GIF's channel 2 (an RGB plane)
    refused with ``ValueError`` as the CPU test pins it; a 4096^2 lossless
    (SOF3, predictor 1) JPEG under a ``.tif`` name against its twin; the
    decode seconds of each; ``imtools.imwrite`` of the GIF slide's 4096^2
    class map as ``.gif`` (read back equal) and ``.jpg``, with seconds;
    every committed fixture of ``tests/fixtures/torch_gif`` and
    ``torch_jpeg_write`` read equal to PIL's read, every committed write
    byte-equal to PIL's file.  Returns, per kernel, its launches on each
    counted path."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.io import gif, jpeg, jpegenc, slides
    from unmicst_tpu_torch.io.tiff import imread, imwrite, num_pages
    from unmicst_tpu_torch.utils import imtools

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {}
    hp = legacy_hp()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice18_")
    try:
        zoo = os.path.join(tmp, "zoo")
        write_model_dir(zoo, "nucleiDAPI", hp, seeded_state(
            hp, "legacy", SEED), "legacy", LEGACY_MEAN, LEGACY_STD)

        def argv(src, name, channel):
            return [src, "--tool", "unmicst-legacy", "--model",
                    "nucleiDAPI", "--modelRoot", zoo, "--stackOutput",
                    "--channel", str(channel), "--outputPath",
                    os.path.join(tmp, "out", name)]

        def run(src, name, channel=1):
            out = os.path.join(tmp, "out", name)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(argv(src, name, channel), device=dev)
            secs = time.perf_counter() - t0
            launches[name] = kernels.launch_counts()
            check(rc == 0, f"cli.main {name}: rc {rc}")
            (maps,) = [os.path.join(out, f) for f in os.listdir(out)
                       if "_Probabilities_" in f]
            return [imread(maps, k) for k in range(num_pages(maps))], secs

        def against_twin(path, channel, twin, label, name, twin_name):
            t_maps, t_secs = run(twin, twin_name)
            c_maps, c_secs = run(path, name, channel)
            same = len(c_maps) == len(t_maps) == 3 and all(
                np.array_equal(a, b) for a, b in zip(c_maps, t_maps))
            for key, secs in ((name, c_secs), (twin_name, t_secs)):
                n = launches[key]
                log(f"[slice18] {label}, {key}: cli.main {secs:.2f} s; K1 "
                    f"{n['softmax_blend']}, K2 epilogue "
                    f"{n['blend_fold_epilogue']}, K2 stripe "
                    f"{n['blend_fold_stripe']} | {card}")
                check(n["softmax_blend"] > 0
                      and n["blend_fold_epilogue"] == 1
                      and n["blend_fold_stripe"] == 0,
                      f"{label} ({key}) did not run K1 and one K2 "
                      f"epilogue: {n}")
            log(f"[slice18] {label}: pages byte-equal to the twin's: {same}")
            check(same, f"{label}: pages differ from the plain twin's")
            return c_maps

        def decode_s(path, channel):
            secs = []
            for _ in range(2):
                t0 = time.perf_counter()
                got = slides.read_channel(path, "tif", channel)
                secs.append(time.perf_counter() - t0)
            return secs, got

        # -- 1. a 4096^2 two-frame GIF under a TIFF name ---------------------
        rng = np.random.RandomState(SEED + 18)
        frames = [(np.clip(blob_slide(rng, SLIDE, SLIDE, 40000), 0, 1)
                   * 255).astype(np.uint8) for _ in range(2)]
        frames[0][0, :256] = np.arange(256)  # every level: the identity
        t0 = time.perf_counter()
        data = gif_two_frames(*frames)
        write_s = time.perf_counter() - t0
        gif_path = os.path.join(tmp, "two_frames.tif")
        with open(gif_path, "wb") as f:
            f.write(data)
        log(f"[slice18] GIF {SLIDE}^2, two frames ({len(data) / 1e6:.3f} MB):"
            f" written in {write_s:.3f} s (frame 0 by the port's writer) | "
            f"{card}")
        maps = None
        for channel, frame in ((1, frames[0]), (2, frames[1])):
            secs, got = decode_s(gif_path, channel - 1)
            log(f"[slice18] GIF frame {channel - 1}: decode {secs[0]:.3f} s "
                f"first, {secs[1]:.3f} s again = "
                f"{SLIDE * SLIDE / 1e6 / min(secs):.1f} Mpx/s | {card}")
            check(got.dtype == np.uint8 and np.array_equal(got, frame),
                  f"GIF frame {channel - 1} does not decode to its pixels")
            plain = os.path.join(tmp, f"gif_plain{channel}.tif")
            imwrite(plain, frame)
            c_maps = against_twin(gif_path, channel, plain,
                                  f"GIF {SLIDE}^2 channel {channel}",
                                  f"gif_channel{channel}",
                                  f"gif_plain{channel}")
            maps = maps if maps is not None else c_maps
        small = os.path.join(tmp, "palette_frames.tif")
        prng = np.random.RandomState(SEED + 48)
        with open(small, "wb") as f:
            f.write(gif_file(64, 48, [
                dict(pixels=prng.randint(0, 256, (48, 64))),
                dict(pixels=prng.randint(0, 256, (20, 30)), x=5, y=9)],
                prng.randint(0, 256, 768).astype(np.uint8).tobytes()))
        try:
            cli.main(argv(small, "palette_rgb", 2), device=dev)
            refused = None
        except ValueError as e:
            refused = str(e)
        log(f"[slice18] a palette GIF's channel 2 (frame 1, RGB): cli.main "
            f"raises ValueError as JAX's: {refused}")
        check(refused is not None and "(48, 64, 3)" in refused,
              "the RGB frame was not refused as the JAX CLI refuses it")

        # -- 2. a 4096^2 lossless JPEG under a TIFF name ---------------------
        band = (np.clip(blob_slide(rng, 256, SLIDE, 2500), 0, 1)
                * 255).astype(np.uint8)
        stream = lossless_jpeg(band, 1, restart_rows=8,
                               repeat=SLIDE // 256)
        ljpeg = os.path.join(tmp, "lossless.tif")
        with open(ljpeg, "wb") as f:
            f.write(stream)
        plane = np.tile(band, (SLIDE // 256, 1))
        secs, got = decode_s(ljpeg, 0)
        log(f"[slice18] lossless JPEG {SLIDE}^2, predictor 1 "
            f"({len(stream) / 1e6:.3f} MB, {SLIDE // 8} restart "
            f"intervals): decode {secs[0]:.3f} s first, {secs[1]:.3f} s "
            f"again = {len(stream) / 1e6 / min(secs):.2f} MB/s | {card}")
        check(got.dtype == np.uint8 and np.array_equal(got, plane),
              "the lossless JPEG does not decode to its pixels")
        plain = os.path.join(tmp, "lossless_plain.tif")
        imwrite(plain, plane)
        against_twin(ljpeg, 1, plain, f"lossless JPEG {SLIDE}^2",
                     "lossless", "lossless_plain")
        del plane, got, frames

        # -- 3. the writers on the GIF slide's class map ---------------------
        cls = np.argmax(np.stack(maps), 0).astype(np.uint8)
        for ext in ("gif", "jpg"):
            out = os.path.join(tmp, f"classes.{ext}")
            t0 = time.perf_counter()
            imtools.imwrite(cls, out)
            secs = time.perf_counter() - t0
            back = imtools.imread(out)
            log(f"[slice18] imwrite of the {SLIDE}^2 class map as .{ext}: "
                f"{secs:.3f} s, {os.path.getsize(out) / 1e6:.3f} MB | "
                f"{card}")
            check(back.shape == cls.shape and back.dtype == np.uint8,
                  f"the .{ext} class map does not read back")
            if ext == "gif":
                check(np.array_equal(back, cls),
                      "the GIF class map does not read back equal")

        # -- 4. the committed fixtures ---------------------------------------
        bad, reads, writes = [], 0, 0
        for f in sorted(os.listdir(GIF_FIXTURES)):
            path = os.path.join(GIF_FIXTURES, f)
            if f.endswith(".npz"):
                ref = np.load(path)
                with open(path[:-4] + ".gif", "rb") as g:
                    data = g.read()
                for k in range(len(ref.files)):
                    reads += 1
                    px = gif.read_frame(data, k)
                    want = ref[f"frame{k}"]
                    if px.dtype != want.dtype or not np.array_equal(px, want):
                        bad.append(f"{f[:-4]} frame {k}")
            elif f.startswith("write_") and f.endswith(".npy"):
                writes += 1
                with open(path[:-4] + ".gif", "rb") as g:
                    if gif.encode_gif(np.load(path)) != g.read():
                        bad.append(f[:-4] + ".gif")
        for f in sorted(os.listdir(JPEG_WRITE_FIXTURES)):
            path = os.path.join(JPEG_WRITE_FIXTURES, f)
            if not f.endswith(".jpg"):
                continue
            with open(path, "rb") as g:
                data = g.read()
            if f.startswith("write_"):
                writes += 1
                if jpegenc.encode_jpeg(np.load(path[:-4] + ".npy")) != data:
                    bad.append(f)
            else:
                reads += 1
                px, want = jpeg.decode(data), np.load(path[:-4] + ".npy")
                if px.dtype != want.dtype or not np.array_equal(px, want):
                    bad.append(f)
        log(f"[slice18] {reads} fixture reads (GIF frames, lossless and "
            f"sampled JPEGs) equal to PIL's and {writes} writes (GIF, JPEG) "
            f"byte-equal to PIL's files: {reads + writes - len(bad)}; "
            f"differing: {bad}")
        check(not bad, f"fixtures differ from PIL's: {bad}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[slice18] phase {time.perf_counter() - t_phase:.1f}s")
    return {name: {path: counts[name] for path, counts in launches.items()}
            for name in ("softmax_blend", "blend_fold_epilogue",
                         "blend_fold_stripe")}


ARITH_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_jpeg_arith")
MPO_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_mpo")
PNM_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_pnm")


def mpo_file(streams, byteorder: str = "<") -> bytes:
    """An MPO (CIPA DC-007) of the JPEG ``streams``: the first with an
    APP2 ``MPF`` segment right after its SOI, a TIFF header in
    ``byteorder`` ("<" II, ">" MM) and an IFD of MPFVersion,
    NumberOfImages and MPEntry, each entry's DataOffset counted from that
    header (the first's 0); the others after it, as they are."""
    n, bo = len(streams), byteorder
    ifd_len = 2 + 3 * 12 + 4
    seg_len = 2 + 4 + 8 + ifd_len + 16 * n
    first = len(streams[0]) + 2 + seg_len
    offsets, at = [0], first
    for data in streams[1:]:
        offsets.append(at - 10)  # SOI, marker, length, "MPF\0"
        at += len(data)
    entries = b"".join(struct.pack(
        bo + "LLLHH", (0x20030000 if k == 0 else 0x00020002),
        len(streams[k]) + (seg_len + 2 if k == 0 else 0), offsets[k], 0, 0)
        for k in range(n))
    ifd = (struct.pack(bo + "H", 3)
           + struct.pack(bo + "HHL", 0xB000, 7, 4) + b"0100"
           + struct.pack(bo + "HHLL", 0xB001, 4, 1, n)
           + struct.pack(bo + "HHLL", 0xB002, 7, 16 * n, 8 + ifd_len)
           + bytes(4))
    head = (b"II*\0" if bo == "<" else b"MM\0*") + struct.pack(bo + "L", 8)
    seg = (b"\xff\xe2" + struct.pack(">H", seg_len) + b"MPF\0" + head + ifd
           + entries)
    return streams[0][:2] + seg + streams[0][2:] + b"".join(streams[1:])


def arith_encoder():
    """The test-side arithmetic JPEG encoder (``jcarith.c``):
    ``tests/fixtures/torch_jpeg_arith/make.py``, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "arith_make", os.path.join(ARITH_FIXTURES, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_slice19(dev) -> dict:
    """MPO frames, arithmetic-coded JPEG and Netpbm (M17, fifth part),
    through ``cli.main`` on the card (the legacy net at nucleiDAPI's
    widths, seeded weights), each slide byte-equal to its plain twin: a
    4096^2 gray SOF9 JPEG under a ``.tif`` name, coded by the test-side
    encoder from the coefficients of the port's baseline JPEG of a flat
    slide with 350 nuclei (its scan fits the 64 KiB PIL hands libjpeg at
    once, so JAX reads it too), against the baseline's pixels as a plain
    TIFF, with the encode and decode seconds; the entropy decode alone
    (``jpeg.decode_coefficients``) of that stream beside the baseline's
    Huffman one, the same coefficients; that stream behind a 40000-byte
    APP15 segment, so that its scan crosses PIL's first read, under a
    ``.tif`` name refused with ``ValueError`` as JAX (PIL) refuses it; a
    4096^2 gray 3-frame MPO of the baseline JPEG and one of a slide with
    1500 nuclei (``mpo_file``) under a ``.tif`` name at ``--channel 2``
    (frame 1, the 1500-nuclei slide) against frame 1's
    pixels; a 4096^2 P5 PGM at maxval 65535 (that slide widened to 16
    bits with seeded low bytes) under a ``.tif`` name against its samples
    as an int32 TIFF (the dtype PIL gives); every committed fixture of
    ``tests/fixtures/torch_jpeg_arith``, ``torch_mpo`` and ``torch_pnm``
    read equal to PIL's read, every committed Netpbm write byte-equal to
    PIL's file.  Returns, per kernel, its launches on each counted path."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.io import jpeg, jpegenc, mpo, pnm, slides
    from unmicst_tpu_torch.io.tiff import imread, imwrite, num_pages

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {}
    hp = legacy_hp()
    enc = arith_encoder()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice19_")
    try:
        zoo = os.path.join(tmp, "zoo")
        write_model_dir(zoo, "nucleiDAPI", hp, seeded_state(
            hp, "legacy", SEED), "legacy", LEGACY_MEAN, LEGACY_STD)

        def run(src, name, channel):
            out = os.path.join(tmp, "out", name)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main([src, "--tool", "unmicst-legacy", "--model",
                           "nucleiDAPI", "--modelRoot", zoo, "--stackOutput",
                           "--channel", str(channel), "--outputPath", out],
                          device=dev)
            secs = time.perf_counter() - t0
            launches[name] = kernels.launch_counts()
            check(rc == 0, f"cli.main {name}: rc {rc}")
            (maps,) = [os.path.join(out, f) for f in os.listdir(out)
                       if "_Probabilities_" in f]
            return [imread(maps, k) for k in range(num_pages(maps))], secs

        def against_twin(path, channel, plane, label, name):
            twin = os.path.join(tmp, f"{name}_plain.tif")
            imwrite(twin, plane)
            t_maps, t_secs = run(twin, f"{name}_plain", 1)
            c_maps, c_secs = run(path, name, channel)
            same = len(c_maps) == len(t_maps) == 3 and all(
                np.array_equal(a, b) for a, b in zip(c_maps, t_maps))
            for key, secs in ((name, c_secs), (f"{name}_plain", t_secs)):
                n = launches[key]
                log(f"[slice19] {label}, {key}: cli.main {secs:.2f} s; K1 "
                    f"{n['softmax_blend']}, K2 epilogue "
                    f"{n['blend_fold_epilogue']}, K2 stripe "
                    f"{n['blend_fold_stripe']} | {card}")
                check(n["softmax_blend"] > 0
                      and n["blend_fold_epilogue"] == 1
                      and n["blend_fold_stripe"] == 0,
                      f"{label} ({key}) did not run K1 and one K2 "
                      f"epilogue: {n}")
            log(f"[slice19] {label}: pages byte-equal to the twin's: {same}")
            check(same, f"{label}: pages differ from the plain twin's")

        def read_timed(path, channel):
            t0 = time.perf_counter()
            got = slides.read_channel(path, "tif", channel)
            return got, time.perf_counter() - t0

        # -- 1. a 4096^2 arithmetic JPEG under a TIFF name ------------------
        rng = np.random.RandomState(SEED + 19)
        base = jpegenc.encode_jpeg((blob_slide(
            rng, SLIDE, SLIDE, 350, 0.1) * 255).astype(np.uint8))
        frame, coef = jpeg.decode_coefficients(base)
        t0 = time.perf_counter()
        stream = enc.encode(coef, [(1, 1, 1, 0)], SLIDE, SLIDE,
                            {0: frame.components[0].qtable})
        enc_s = time.perf_counter() - t0
        plane = jpeg.decode(base)
        path = os.path.join(tmp, "arith.tif")
        with open(path, "wb") as f:
            f.write(stream)
        check(len(stream) < jpeg.PIL_FEED,
              f"the SOF9 slide is {len(stream)} bytes, past PIL's first read")
        got, secs = read_timed(path, 0)
        log(f"[slice19] SOF9 JPEG {SLIDE}^2 ({len(stream)} bytes; baseline "
            f"{len(base)} bytes): encoded in {enc_s:.3f} s (test-side "
            f"encoder), read in {secs:.3f} s = "
            f"{len(stream) / 1e6 / secs:.3f} MB/s, "
            f"{SLIDE * SLIDE / 1e6 / secs:.1f} Mpx/s | {card}")
        check(got.dtype == np.uint8 and np.array_equal(got, plane),
              "the SOF9 JPEG does not decode to its baseline's pixels")
        against_twin(path, 1, plane, f"SOF9 JPEG {SLIDE}^2", "arith")
        first = base

        # -- 2. the entropy decode's rate, and PIL's 64 KiB read -------------
        secs = {"arithmetic": [], "Huffman": []}
        for _ in range(2):
            for kind, data in (("arithmetic", stream), ("Huffman", base)):
                t0 = time.perf_counter()
                _, c = jpeg.decode_coefficients(data)
                secs[kind].append(time.perf_counter() - t0)
                check(np.array_equal(c, coef), f"the {kind} stream's "
                      "coefficients differ from the baseline's")
        log(f"[slice19] entropy decode alone (jpeg.decode_coefficients, "
            f"native) of the same {SLIDE}^2 coefficients, "
            f"{len(coef)} blocks: " + ", ".join(
                f"{k} {n} bytes in {min(secs[k]):.4f} s (of "
                f"{', '.join(f'{t:.4f}' for t in secs[k])}) = "
                f"{n / 1e6 / min(secs[k]):.3f} MB/s, "
                f"{SLIDE * SLIDE / 1e6 / min(secs[k]):.1f} Mpx/s"
                for k, n in (("arithmetic", len(stream)),
                             ("Huffman", len(base)))) + f" | {card}")
        # an APP15 segment after SOI moves the scan across PIL's first read
        pad = 40000
        big = os.path.join(tmp, "arith_big.tif")
        with open(big, "wb") as f:
            f.write(stream[:2] + b"\xff\xef" + struct.pack(">H", pad + 2)
                    + bytes(pad) + stream[2:])
        try:
            slides.read_channel(big, "tif", 0)
            refused = None
        except ValueError as e:
            refused = str(e)
        log(f"[slice19] that SOF9 stream under .tif behind a {pad}-byte "
            f"APP15 segment ({len(stream) + pad + 4} bytes): ValueError as "
            f"JAX's (PIL's 64 KiB read): {refused is not None}")
        check(refused is not None and "65536" in refused,
              f"the SOF9 scan past PIL's first read was not refused: "
              f"{refused}")
        base = jpegenc.encode_jpeg((blob_slide(
            rng, SLIDE, SLIDE, 1500, 0.1) * 255).astype(np.uint8))
        plane = jpeg.decode(base)

        # -- 3. a 4096^2 gray 3-frame MPO under a TIFF name -------------------
        data = mpo_file([first, base, first])
        path = os.path.join(tmp, "frames.tif")
        with open(path, "wb") as f:
            f.write(data)
        got, secs = read_timed(path, 1)
        log(f"[slice19] MPO {SLIDE}^2, 3 frames ({len(data) / 1e6:.3f} MB): "
            f"frame 1 read in {secs:.3f} s | {card}")
        check(np.array_equal(got, plane), "MPO frame 1 differs from its JPEG")
        against_twin(path, 2, plane, f"MPO {SLIDE}^2 frame 1", "mpo")

        # -- 4. a 4096^2 16-bit PGM under a TIFF name --------------------------
        plane = plane.astype(np.uint16) * 256 + rng.randint(
            0, 256, plane.shape).astype(np.uint16)
        path = os.path.join(tmp, "gray16.tif")
        with open(path, "wb") as f:
            f.write(b"P5\n%d %d\n65535\n" % (SLIDE, SLIDE)
                    + plane.astype(">u2").tobytes())
        got, secs = read_timed(path, 0)
        log(f"[slice19] P5 PGM {SLIDE}^2 at maxval 65535: read in {secs:.3f} "
            f"s as {got.dtype} | {card}")
        check(got.dtype == np.int32 and np.array_equal(got, plane),
              "the PGM does not read as its samples in int32")
        against_twin(path, 1, plane.astype(np.int32), f"PGM {SLIDE}^2",
                     "pgm")
        del plane, got, data, coef

        # -- 5. the committed fixtures -------------------------------------------
        bad, reads, writes = [], 0, 0
        for name in sorted(enc.CASES):
            reads += 1
            with open(os.path.join(ARITH_FIXTURES, name + ".jpg"), "rb") as f:
                data = f.read()
            want = np.load(os.path.join(ARITH_FIXTURES, name + ".npy"))
            px = jpeg.decode(data, feed=jpeg.PIL_FEED)
            if enc.case(name, **enc.CASES[name]) != data or \
                    px.dtype != want.dtype or not np.array_equal(px, want):
                bad.append(name)
        for f in sorted(os.listdir(MPO_FIXTURES)):
            if not f.endswith(".mpo"):
                continue
            with open(os.path.join(MPO_FIXTURES, f), "rb") as g:
                data = g.read()
            ref = np.load(os.path.join(MPO_FIXTURES, f[:-4] + ".npz"))
            for k in range(len(ref.files)):
                reads += 1
                px, want = mpo.read_frame(data, k), ref[f"frame{k}"]
                if px.dtype != want.dtype or not np.array_equal(px, want):
                    bad.append(f"{f} frame {k}")
        for f in sorted(os.listdir(PNM_FIXTURES)):
            path = os.path.join(PNM_FIXTURES, f)
            if f.startswith("write_") and f.endswith(".npy"):
                writes += 1
                (out,) = [g for g in os.listdir(PNM_FIXTURES)
                          if g.startswith(f[:-3]) and not g.endswith(".npy")]
                with open(os.path.join(PNM_FIXTURES, out), "rb") as g:
                    if pnm.encode_pnm(np.load(path)) != g.read():
                        bad.append(out)
            elif f.endswith(".pnm") and not f.startswith("write_"):
                reads += 1
                px, want = pnm.read_frame(path), np.load(path[:-4] + ".npy")
                if px.dtype != want.dtype or not np.array_equal(px, want):
                    bad.append(f)
        log(f"[slice19] {reads} fixture reads (arithmetic JPEGs, MPO frames, "
            f"Netpbm) equal to PIL's and {writes} Netpbm writes byte-equal to "
            f"PIL's files: {reads + writes - len(bad)}; differing: {bad}")
        check(not bad, f"fixtures differ from PIL's: {bad}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[slice19] phase {time.perf_counter() - t_phase:.1f}s")
    return {name: {path: counts[name] for path, counts in launches.items()}
            for name in ("softmax_blend", "blend_fold_epilogue",
                         "blend_fold_stripe")}


# -- phase 22: TGA, SGI, PCX, DCX and grown GIF frames (M17, sixth part) ------

RLE_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_rle")


def rle_files():
    """The test-side TGA, SGI, PCX and DCX file writers and RLE encoders:
    ``tests/fixtures/torch_rle/make.py``, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "rle_make", os.path.join(RLE_FIXTURES, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_slice20(dev, side: int = SLIDE) -> dict:
    """TGA, SGI, PCX and DCX read (F7: such a file under a TIFF name) and
    GIF frames past the logical screen (M17, sixth part), through
    ``cli.main`` on the card (the legacy net at nucleiDAPI's widths,
    seeded weights): one seeded ``side``^2 slide with nuclei on a flat
    background, and one plain TIFF twin of it, against five files under a
    ``.tif`` name, each page byte-equal to the twin's: a gray PCX (the
    port's writer, PIL's form: RLE), a gray RLE TGA (type 11, bottom-up,
    raw packets across rows), a 2-byte RLE SGI (the slide the high bytes,
    seeded low bytes on the nuclei), a 3-frame DCX at ``--channel 2``
    (frame 1) and a GIF at ``--channel 2`` whose frame 1 grows the
    ``side - 96``-row screen of frame 0 (every gray level in frame 0, so
    the screen stays 2-D), with the build, read and native RLE decode
    seconds; every committed fixture of ``tests/fixtures/torch_rle`` read
    equal to PIL's read, every committed write byte-equal to PIL's file.
    Returns, per kernel, its launches on each counted path."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.io import _native, gif, pcx, sgi, slides, tga
    from unmicst_tpu_torch.io.tiff import imread, imwrite, num_pages

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    mk = rle_files()
    launches = {}
    hp = legacy_hp()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice20_")
    try:
        zoo = os.path.join(tmp, "zoo")
        write_model_dir(zoo, "nucleiDAPI", hp, seeded_state(
            hp, "legacy", SEED), "legacy", LEGACY_MEAN, LEGACY_STD)

        def run(src, name, channel):
            out = os.path.join(tmp, "out", name)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main([src, "--tool", "unmicst-legacy", "--model",
                           "nucleiDAPI", "--modelRoot", zoo, "--stackOutput",
                           "--channel", str(channel), "--outputPath", out],
                          device=dev)
            secs = time.perf_counter() - t0
            launches[name] = kernels.launch_counts()
            check(rc == 0, f"cli.main {name}: rc {rc}")
            (maps,) = [os.path.join(out, f) for f in os.listdir(out)
                       if "_Probabilities_" in f]
            n = launches[name]
            log(f"[slice20] {name}: cli.main {secs:.2f} s; K1 "
                f"{n['softmax_blend']}, K2 epilogue "
                f"{n['blend_fold_epilogue']}, K2 stripe "
                f"{n['blend_fold_stripe']} | {card}")
            return [imread(maps, k) for k in range(num_pages(maps))]

        rng = np.random.RandomState(SEED + 20)
        plane = (blob_slide(rng, side, side, 350, 0.1) * 255).astype(
            np.uint8)
        twin = os.path.join(tmp, "plain.tif")
        imwrite(twin, plane)
        t_maps = run(twin, "plain", 1)
        k1 = launches["plain"]["softmax_blend"]
        check(k1 > 0 and launches["plain"]["blend_fold_epilogue"] == 1,
              f"the plain twin did not run K1 and one K2 epilogue: "
              f"{launches['plain']}")

        # -- the five files, each built here -----------------------------------
        files = {}
        t0 = time.perf_counter()
        files["pcx"] = (pcx.encode_pcx(plane), 1)
        built = {"pcx": time.perf_counter() - t0}
        t0 = time.perf_counter()
        files["tga"] = (mk.tga(11, 8, side, side,
                               mk.tga_rle(plane[::-1, :, None])), 1)
        built["tga"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        low = np.where(plane == plane[0, 0], 0x55, rng.randint(
            0, 256, plane.shape)).astype(np.uint16)
        files["sgi"] = (mk.sgi((plane.astype(np.uint16) << 8) | low, bpc=2,
                               rle=True), 1)
        built["sgi"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        files["dcx"] = (mk.dcx([pcx.encode_pcx(255 - plane), files["pcx"][0],
                                pcx.encode_pcx(plane // 2)]), 2)
        built["dcx"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        first = plane[: side - 96].copy()
        first[0, :256] = np.arange(256)  # every level: the identity table
        files["gif"] = (gif_two_frames(first, plane), 2)
        built["gif"] = time.perf_counter() - t0
        check(gif.Screen(files["gif"][0]).height == side - 96,
              "frame 1 of the GIF does not grow its screen")

        # -- the native RLE decode alone --------------------------------------
        decode = {}
        for kind, fn in (
                ("pcx", lambda d: _native.pcx_rle_decode(
                    d, 128, np.empty((side, side), np.uint8))),
                ("tga", lambda d: _native.tga_rle_decode(
                    d, 18, np.empty((side, side), np.uint8), 1)),
                ("sgi", lambda d: _native.sgi_rle_decode(
                    d, np.empty((side, 1, 2 * side), np.uint8), 2))):
            data = files[kind][0]
            secs = []
            for _ in range(3):
                t0 = time.perf_counter()
                rc = fn(data)
                secs.append(time.perf_counter() - t0)
            check(rc == 0, f"native {kind} RLE decode: {rc}")
            decode[kind] = min(secs)
            log(f"[slice20] native {kind.upper()} RLE decode of "
                f"{len(data)} bytes: {min(secs):.4f} s (of "
                f"{', '.join(f'{t:.4f}' for t in secs)}) = "
                f"{len(data) / 1e6 / min(secs):.1f} MB/s, "
                f"{side * side / 1e6 / min(secs):.1f} Mpx/s | {card}")

        # -- each file under a TIFF name through cli.main ----------------------
        for kind, (data, channel) in files.items():
            path = os.path.join(tmp, f"{kind}.tif")
            with open(path, "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            got = slides.read_channel(path, "tif", channel - 1)
            read_s = time.perf_counter() - t0
            log(f"[slice20] {kind.upper()} {side}^2 ({len(data)} bytes): "
                f"built in {built[kind]:.3f} s, read_channel "
                f"{channel - 1} in {read_s:.3f} s | {card}")
            check(got.dtype == np.uint8 and np.array_equal(got, plane),
                  f"the {kind} file's channel {channel - 1} differs from "
                  "the slide")
            c_maps = run(path, kind, channel)
            n = launches[kind]
            check(n["softmax_blend"] == k1 and n["blend_fold_epilogue"] == 1
                  and n["blend_fold_stripe"] == 0,
                  f"{kind} did not run K1 {k1} times and one K2 epilogue: "
                  f"{n}")
            same = len(c_maps) == len(t_maps) == 3 and all(
                np.array_equal(a, b) for a, b in zip(c_maps, t_maps))
            log(f"[slice20] {kind.upper()}: pages byte-equal to the twin's: "
                f"{same}")
            check(same, f"{kind}: pages differ from the plain twin's")
        del plane, files

        # -- the committed fixtures -------------------------------------------
        bad, reads, writes = [], 0, 0
        cases, arrays = mk.read_cases(), mk.write_arrays()
        for name, (ext, data) in sorted(cases.items()):
            with open(os.path.join(RLE_FIXTURES, f"{name}.{ext}"), "rb") as f:
                if f.read() != data:
                    bad.append(f"{name}.{ext} (not make.py's bytes)")
            ref = np.load(os.path.join(RLE_FIXTURES, f"{name}.npz"))
            read = {"tga": tga.read_frame, "sgi": sgi.read_frame}.get(
                ext, pcx.read_frame)
            for k in range(len(ref.files)):
                reads += 1
                px, want = read(data, k), ref[f"frame{k}"]
                if px.dtype != want.dtype or not np.array_equal(px, want):
                    bad.append(f"{name} frame {k}")
        for name, (x, ext) in sorted(arrays.items()):
            writes += 1
            path = os.path.join(RLE_FIXTURES, f"write_{name}{ext}")
            encode = {"tga": tga.encode_tga, "pcx": pcx.encode_pcx}.get(
                name[:3], lambda a: sgi.encode_sgi(a, path))
            with open(path, "rb") as f:
                if encode(x) != f.read():
                    bad.append(f"write_{name}{ext}")
        log(f"[slice20] {reads} fixture reads (TGA, SGI, PCX, DCX frames) "
            f"equal to PIL's and {writes} writes byte-equal to PIL's files: "
            f"{reads + writes - len(bad)}; differing: {bad}")
        check(not bad, f"fixtures differ from PIL's: {bad}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[slice20] phase {time.perf_counter() - t_phase:.1f}s")
    return {name: {path: counts[name] for path, counts in launches.items()}
            for name in ("softmax_blend", "blend_fold_epilogue",
                         "blend_fold_stripe")}


WRITE_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_write")


def write_files():
    """The seeded arrays and extra read cases of the toolbox's remaining
    PIL writes and reads: ``tests/fixtures/torch_write/make.py``, loaded
    by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "write_make", os.path.join(WRITE_FIXTURES, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_slice21(dev, side: int = SLIDE) -> dict:
    """The toolbox's remaining PIL writes and their reads (M17, seventh
    part) through ``cli.main`` on the card (the legacy net at
    nucleiDAPI's widths, seeded weights): one seeded ``side``^2 slide and
    its plain TIFF twins against four files under a ``.tif`` name, each
    page byte-equal to its twin's: an IM (``I;16``) of the uint16 plane,
    a DIB and an uncompressed DDS of the uint8 plane, and an RGB GIF of
    the uint8 twin's three maps stacked as RGB (the port's median cut;
    its twin a TIFF of the index plane the port's reader gives).  An RGBA
    GIF (the fast octree), a QOI, an XBM and an MSP written and read back
    equal to their input, with the quantizers' seconds; every committed
    fixture of ``tests/fixtures/torch_write`` written byte-equal to PIL's
    file (APNG read equal: the port's deflate is its own) and read equal
    to PIL's read.  Returns, per kernel, its launches on each counted
    path."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.io import (_native, bmp, dds, gif, identify, im,
                                      msp, png, qoi, quant, slides, xbm)
    from unmicst_tpu_torch.io.tiff import imread, imwrite, num_pages
    from unmicst_tpu_torch.utils import imtools

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    mk = write_files()
    launches = {}
    hp = legacy_hp()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice21_")
    try:
        zoo = os.path.join(tmp, "zoo")
        write_model_dir(zoo, "nucleiDAPI", hp, seeded_state(
            hp, "legacy", SEED), "legacy", LEGACY_MEAN, LEGACY_STD)

        def run(src, name):
            out = os.path.join(tmp, "out", name)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main([src, "--tool", "unmicst-legacy", "--model",
                           "nucleiDAPI", "--modelRoot", zoo, "--stackOutput",
                           "--channel", "1", "--outputPath", out],
                          device=dev)
            secs = time.perf_counter() - t0
            launches[name] = kernels.launch_counts()
            check(rc == 0, f"cli.main {name}: rc {rc}")
            (maps,) = [os.path.join(out, f) for f in os.listdir(out)
                       if "_Probabilities_" in f]
            n = launches[name]
            log(f"[slice21] {name}: cli.main {secs:.2f} s; K1 "
                f"{n['softmax_blend']}, K2 epilogue "
                f"{n['blend_fold_epilogue']}, K2 stripe "
                f"{n['blend_fold_stripe']} | {card}")
            return [imread(maps, k) for k in range(num_pages(maps))]

        def against_twin(kind, data, want, twin_maps):
            path = os.path.join(tmp, f"{kind}.tif")
            with open(path, "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            got = slides.read_channel(path, "tif", 0)
            read_s = time.perf_counter() - t0
            log(f"[slice21] {kind} {side}^2 ({len(data)} bytes): "
                f"read_channel 0 in {read_s:.3f} s | {card}")
            check(got.dtype == want.dtype and np.array_equal(got, want),
                  f"the {kind} file's channel 0 differs from its plane")
            maps = run(path, kind)
            n = launches[kind]
            check(n["softmax_blend"] == k1 and n["blend_fold_epilogue"] == 1
                  and n["blend_fold_stripe"] == 0,
                  f"{kind} did not run K1 {k1} times and one K2 epilogue: "
                  f"{n}")
            same = len(maps) == len(twin_maps) == 3 and all(
                np.array_equal(a, b) for a, b in zip(maps, twin_maps))
            log(f"[slice21] {kind}: pages byte-equal to the twin's: {same}")
            check(same, f"{kind}: pages differ from the plain twin's")

        rng = np.random.RandomState(SEED + 21)
        plane = (blob_slide(rng, side, side, 350, 0.1) * 255).astype(
            np.uint8)
        wide = (plane.astype(np.uint16) << 8) | rng.randint(
            0, 256, plane.shape).astype(np.uint16)
        twin8, twin16 = (os.path.join(tmp, f"plain{b}.tif") for b in (8, 16))
        imwrite(twin8, plane)
        imwrite(twin16, wide)
        maps8 = run(twin8, "plain8")
        k1 = launches["plain8"]["softmax_blend"]
        check(k1 > 0 and launches["plain8"]["blend_fold_epilogue"] == 1,
              f"the plain twin did not run K1 and one K2 epilogue: "
              f"{launches['plain8']}")
        maps16 = run(twin16, "plain16")
        check(launches["plain16"]["softmax_blend"] == k1,
              f"the uint16 twin's K1 launches: {launches['plain16']}")

        # -- IM, DIB and DDS of the slide -------------------------------------
        for kind, data, want, maps in (
                ("im", im.encode_im(wide, "slide.im"), wide, maps16),
                ("dib", bmp.encode_bmp(plane, file_header=False), plane,
                 maps8),
                ("dds", dds.encode_dds(plane), plane, maps8)):
            against_twin(kind, data, want, maps)

        # -- the RGB GIF of the twin's maps: the median cut at side^2 ---------
        t0 = time.perf_counter()
        check(_native.get_lib() is not None,
              "the native host library (quant.cpp) did not build or load")
        log(f"[slice21] native host library ready in "
            f"{time.perf_counter() - t0:.2f} s (g++ where not built yet)")
        rgb = np.ascontiguousarray(np.stack(maps8, -1))
        px = quant.pixels(rgb)
        t0 = time.perf_counter()
        idx, pal = quant.median_cut(px)
        cut_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        data = gif.encode_gif(rgb)
        gif_s = time.perf_counter() - t0
        colours = np.count_nonzero(np.bincount(
            px[:, 0].astype(np.int64) << 16 | px[:, 1].astype(np.int64) << 8
            | px[:, 2], minlength=1 << 24))
        log(f"[slice21] median cut of {side}^2 RGB ({colours} colours) to "
            f"{len(pal)} entries: {cut_s:.3f} s; RGB GIF write "
            f"{gif_s:.3f} s ({len(data)} bytes) | {card}")
        check(len(pal) == 256 or colours <= 256,
              f"the median cut gave {len(pal)} entries")
        index = gif.read_frame(data, 0)
        check(np.array_equal(index, idx.reshape(side, side)),
              "the RGB GIF's index plane is not the median cut's")
        twin_gif = os.path.join(tmp, "index.tif")
        imwrite(twin_gif, index)
        against_twin("gif_rgb", data, index, run(twin_gif, "index"))

        # -- written and read back: RGBA GIF, QOI, XBM, MSP -------------------
        rgba = np.concatenate([rgb, np.where(plane > plane[0, 0], 255, 0)
                               .astype(np.uint8)[..., None]], -1)
        t0 = time.perf_counter()
        oidx, opal = quant.octree(quant.pixels(rgba))
        oct_s = time.perf_counter() - t0
        data = gif.encode_gif(rgba)
        back = gif.read_frame(data, 0)
        check(np.array_equal(back, oidx.reshape(side, side)),
              "the RGBA GIF's index plane is not the octree's")
        bits = plane > plane[0, 0]
        times = {}
        for kind, x, encode, read in (
                ("qoi", rgba, qoi.encode_qoi, qoi.read_frame),
                ("xbm", bits, xbm.encode_xbm, xbm.read_frame),
                ("msp", bits, msp.encode_msp, msp.read_frame)):
            if kind == "msp" and side > 65535:
                continue
            t0 = time.perf_counter()
            blob = encode(x)
            t1 = time.perf_counter()
            y = read(blob, 0)
            times[kind] = (t1 - t0, time.perf_counter() - t1, len(blob))
            check(y.dtype == x.dtype and np.array_equal(y, x),
                  f"{kind}: read back differs from what was written")
        log(f"[slice21] fast octree of {side}^2 RGBA: {oct_s:.3f} s; "
            f"RGBA GIF, QOI, XBM, MSP read back equal; write / read s: "
            + ", ".join(f"{k} {w:.3f} / {r:.3f} ({n} bytes)"
                        for k, (w, r, n) in times.items()) + f" | {card}")
        del plane, wide, rgb, rgba, px, index, back, bits

        # -- the committed fixtures -------------------------------------------
        bad, reads, writes = [], 0, 0
        ref = np.load(os.path.join(WRITE_FIXTURES, "reads.npz"))
        for name, (x, ext) in sorted(mk.write_arrays().items()):
            fname = f"write_{name}{ext}"
            with open(os.path.join(WRITE_FIXTURES, fname), "rb") as f:
                want = f.read()
            writes += 1
            if ext == ".apng":
                if not np.array_equal(png.read_png(os.path.join(
                        WRITE_FIXTURES, fname)), x):
                    bad.append(fname)
                continue
            path = os.path.join(tmp, "w", fname)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            imtools._BY_EXTENSION[ext](path, x)
            with open(path, "rb") as f:
                if f.read() != want:
                    bad.append(fname)
        for name, (ext, data) in sorted(mk.read_cases().items()):
            with open(os.path.join(WRITE_FIXTURES, f"read_{name}{ext}"),
                      "rb") as f:
                if f.read() != data:
                    bad.append(f"read_{name}{ext} (not make.py's bytes)")
        for key in ref.files:
            fname, _, frame = key.partition("#")
            with open(os.path.join(WRITE_FIXTURES, fname), "rb") as f:
                data = f.read()
            reads += 1
            px = identify.read(data, int(frame or 0), fname)
            if px is None or px.dtype != ref[key].dtype or not np.array_equal(
                    px, ref[key]):
                bad.append(key)
        log(f"[slice21] {writes} fixture writes byte-equal to PIL's files "
            f"(APNG read equal) and {reads} reads equal to PIL's: "
            f"{reads + writes - len(bad)}; differing: {bad}")
        check(not bad, f"fixtures differ from PIL's: {bad}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[slice21] phase {time.perf_counter() - t_phase:.1f}s")
    return {name: {path: counts[name] for path, counts in launches.items()}
            for name in ("softmax_blend", "blend_fold_epilogue",
                         "blend_fold_stripe")}


J2K_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_j2k")


def phase_slice22(dev) -> dict:
    """JPEG 2000 read (M17, eighth part) through ``cli.main`` on the card
    (the legacy net at nucleiDAPI's widths, seeded weights): the two
    committed 4096^2 slides (``tests/fixtures/torch_j2k``: a lossy JP2,
    9/7 at ``quality_layers=[40]`` in 1024^2 tiles, and a lossless 5/3
    J2K), each decoded by the port on the native library with its stage
    seconds and held to the sha256 of PIL's read, read by
    ``read_channel`` under a ``.tif`` name, then through ``cli.main``
    against a plain TIFF twin of its pixels, pages byte-equal, K1 and one
    K2 epilogue counted; every small fixture there read equal to PIL's
    committed read.  Returns, per kernel, its launches on each counted
    path."""
    import hashlib

    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.io import _native, jpeg2000, slides
    from unmicst_tpu_torch.io.tiff import imread, imwrite, num_pages

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {}
    hp = legacy_hp()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice22_")
    try:
        zoo = os.path.join(tmp, "zoo")
        write_model_dir(zoo, "nucleiDAPI", hp, seeded_state(
            hp, "legacy", SEED), "legacy", LEGACY_MEAN, LEGACY_STD)

        def run(src, name):
            out = os.path.join(tmp, "out", name)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main([src, "--tool", "unmicst-legacy", "--model",
                           "nucleiDAPI", "--modelRoot", zoo, "--stackOutput",
                           "--channel", "1", "--outputPath", out],
                          device=dev)
            secs = time.perf_counter() - t0
            launches[name] = kernels.launch_counts()
            check(rc == 0, f"cli.main {name}: rc {rc}")
            (maps,) = [os.path.join(out, f) for f in os.listdir(out)
                       if "_Probabilities_" in f]
            n = launches[name]
            log(f"[slice22] {name}: cli.main {secs:.2f} s; K1 "
                f"{n['softmax_blend']}, K2 epilogue "
                f"{n['blend_fold_epilogue']}, K2 stripe "
                f"{n['blend_fold_stripe']} | {card}")
            return [imread(maps, k) for k in range(num_pages(maps))]

        t0 = time.perf_counter()
        check(_native.get_lib() is not None,
              "the native host library (j2kdec.cpp) did not build or load")
        log(f"[slice22] native host library ready in "
            f"{time.perf_counter() - t0:.2f} s (g++ where not built yet)")
        with open(os.path.join(J2K_FIXTURES, "slides.json")) as f:
            ref = json.load(f)
        k1 = None
        for fname in ("slide_lossy.jp2", "slide_lossless.j2k"):
            kind = fname.split(".")[0].split("_")[1]
            with open(os.path.join(J2K_FIXTURES, fname), "rb") as f:
                data = f.read()
            times = {}
            t0 = time.perf_counter()
            px = jpeg2000.load(data, jpeg2000.open_header(data), times)
            secs = time.perf_counter() - t0
            digest = hashlib.sha256(px.tobytes()).hexdigest()
            log(f"[slice22] {fname} ({len(data)} bytes, {px.shape[0]}x"
                f"{px.shape[1]} {px.dtype}): decode {secs:.3f} s (tier 2 "
                f"{times['tier2']:.3f}, tier 1 {times['tier1']:.3f}, "
                f"wavelet {times['wavelet']:.3f}, rest {times['rest']:.3f})"
                f"; sha256 equal to PIL's read: "
                f"{digest == ref[fname]['sha256']} | {card}")
            check(digest == ref[fname]["sha256"]
                  and str(px.dtype) == ref[fname]["dtype"]
                  and list(px.shape) == ref[fname]["shape"],
                  f"{fname}: the port's decode differs from PIL's read")
            path = os.path.join(tmp, f"{kind}.tif")
            with open(path, "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            got = slides.read_channel(path, "tif", 0)
            log(f"[slice22] {fname} under a .tif name: read_channel 0 in "
                f"{time.perf_counter() - t0:.3f} s | {card}")
            check(got.dtype == px.dtype and np.array_equal(got, px),
                  f"{fname}: read_channel differs from the decode")
            twin = os.path.join(tmp, f"{kind}_plain.tif")
            imwrite(twin, px)
            twin_maps = run(twin, f"{kind}_plain")
            if k1 is None:
                k1 = launches[f"{kind}_plain"]["softmax_blend"]
            n = launches[f"{kind}_plain"]
            check(k1 > 0 and n["softmax_blend"] == k1
                  and n["blend_fold_epilogue"] == 1,
                  f"the plain twin did not run K1 and one K2 epilogue: {n}")
            maps = run(path, kind)
            n = launches[kind]
            check(n["softmax_blend"] == k1 and n["blend_fold_epilogue"] == 1
                  and n["blend_fold_stripe"] == 0,
                  f"{kind} did not run K1 {k1} times and one K2 epilogue: "
                  f"{n}")
            same = len(maps) == len(twin_maps) == 3 and all(
                np.array_equal(a, b) for a, b in zip(maps, twin_maps))
            log(f"[slice22] {kind}: pages byte-equal to the twin's: {same}")
            check(same, f"{kind}: pages differ from the plain twin's")
            del px, got

        # -- the committed small fixtures -------------------------------------
        bad, reads = [], np.load(os.path.join(J2K_FIXTURES, "reads.npz"))
        for fname in reads.files:
            with open(os.path.join(J2K_FIXTURES, fname), "rb") as f:
                px = jpeg2000.read_frame(f.read(), 0)
            want = reads[fname]
            if px.dtype != want.dtype or not np.array_equal(px, want):
                bad.append(fname)
        log(f"[slice22] {len(reads.files)} small fixtures read equal to "
            f"PIL's committed reads: {len(reads.files) - len(bad)}; "
            f"differing: {bad}")
        check(not bad, f"fixtures differ from PIL's: {bad}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[slice22] phase {time.perf_counter() - t_phase:.1f}s")
    return {name: {path: counts[name] for path, counts in launches.items()}
            for name in ("softmax_blend", "blend_fold_epilogue",
                         "blend_fold_stripe")}


RASTER_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_rasters")


def raster_files():
    """The test-side SPIDER, FITS, McIDAS, PSD, Sun raster and other
    writers, and ``slide_files``: ``tests/fixtures/torch_rasters/
    make.py``, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "rasters_make", os.path.join(RASTER_FIXTURES, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_slice23(dev) -> dict:
    """The raster plugins PIL decodes itself (M17, ninth part) through
    ``cli.main`` on the card (the legacy net at nucleiDAPI's widths,
    seeded weights): ``slide_files``' three 4096^2 files, each file's and
    each read's sha256 held to PIL's (``slides.json``), each read under a
    ``.tif`` name against a plain TIFF twin of its pixels, pages
    byte-equal, K1 and one K2 epilogue counted per path; the committed
    small fixtures read as PIL's reads.  Returns, per kernel, its
    launches on each counted path."""
    import hashlib

    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.io import _native, identify, slides
    from unmicst_tpu_torch.io.tiff import imread, imwrite, num_pages

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {}
    hp = legacy_hp()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice23_")
    try:
        zoo = os.path.join(tmp, "zoo")
        write_model_dir(zoo, "nucleiDAPI", hp, seeded_state(
            hp, "legacy", SEED), "legacy", LEGACY_MEAN, LEGACY_STD)

        def run(src, name, channel):
            out = os.path.join(tmp, "out", name)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main([src, "--tool", "unmicst-legacy", "--model",
                           "nucleiDAPI", "--modelRoot", zoo, "--stackOutput",
                           "--channel", str(channel), "--outputPath", out],
                          device=dev)
            secs = time.perf_counter() - t0
            launches[name] = kernels.launch_counts()
            check(rc == 0, f"cli.main {name}: rc {rc}")
            (maps,) = [os.path.join(out, f) for f in os.listdir(out)
                       if "_Probabilities_" in f]
            n = launches[name]
            log(f"[slice23] {name}: cli.main {secs:.2f} s; K1 "
                f"{n['softmax_blend']}, K2 epilogue "
                f"{n['blend_fold_epilogue']}, K2 stripe "
                f"{n['blend_fold_stripe']} | {card}")
            return [imread(maps, k) for k in range(num_pages(maps))], secs

        t0 = time.perf_counter()
        check(_native.get_lib() is not None,
              "the native host library (rlecodec.cpp) did not build or load")
        log(f"[slice23] native host library ready in "
            f"{time.perf_counter() - t0:.2f} s (g++ where not built yet)")
        mk = raster_files()
        with open(os.path.join(RASTER_FIXTURES, "slides.json")) as f:
            ref = json.load(f)
        t0 = time.perf_counter()
        files = mk.slide_files()
        log(f"[slice23] slide_files wrote {len(files)} files in "
            f"{time.perf_counter() - t0:.2f} s")
        k1 = None
        for fname, (data, seeks) in files.items():
            kind = fname.split(".")[0]
            digest = hashlib.sha256(data).hexdigest()
            check(digest == ref[fname]["file_sha256"],
                  f"{fname}: the written file differs from the one PIL read")
            path = os.path.join(tmp, fname)
            with open(path, "wb") as f:
                f.write(data)
            for k in seeks:
                want = ref[fname][f"seek{k}"]
                t0 = time.perf_counter()
                px = identify.read(data, k, fname)
                secs = time.perf_counter() - t0
                same = (hashlib.sha256(px.tobytes()).hexdigest()
                        == want["sha256"] and str(px.dtype) == want["dtype"]
                        and list(px.shape) == want["shape"])
                log(f"[slice23] {fname} ({len(data)} bytes) seek({k}): "
                    f"{px.shape[0]}x{px.shape[1]} {px.dtype} decoded in "
                    f"{secs:.3f} s; sha256 equal to PIL's read: {same} | "
                    f"{card}")
                check(same, f"{fname} seek({k}): the port's read differs "
                      "from PIL's")
                name = f"{kind}_seek{k}"
                twin = os.path.join(tmp, f"{name}_plain.tif")
                imwrite(twin, px)
                twin_maps, twin_secs = run(twin, f"{name}_plain", 1)
                if k1 is None:
                    k1 = launches[f"{name}_plain"]["softmax_blend"]
                n = launches[f"{name}_plain"]
                check(k1 > 0 and n["softmax_blend"] == k1
                      and n["blend_fold_epilogue"] == 1,
                      f"the plain twin did not run K1 and one K2 epilogue: "
                      f"{n}")
                maps, secs = run(path, name, k + 1)
                n = launches[name]
                check(n["softmax_blend"] == k1
                      and n["blend_fold_epilogue"] == 1
                      and n["blend_fold_stripe"] == 0,
                      f"{name} did not run K1 {k1} times and one K2 "
                      f"epilogue: {n}")
                same = len(maps) == len(twin_maps) == 3 and all(
                    np.array_equal(a, b) for a, b in zip(maps, twin_maps))
                log(f"[slice23] {name}: pages byte-equal to the twin's: "
                    f"{same}; cli.main {secs:.2f} s against the twin's "
                    f"{twin_secs:.2f} s | {card}")
                check(same, f"{name}: pages differ from the plain twin's")
                del px
            if kind.startswith("psd"):
                try:
                    slides.read_channel(path, "tif", 0)
                    refused = False
                except IndexError:
                    refused = True
                log(f"[slice23] {fname} channel 0 (seek(0)) refused with "
                    f"IndexError, as the JAX package: {refused}")
                check(refused, f"{fname}: channel 0 was not refused")
        del files

        # -- the committed small fixtures -------------------------------------
        reads = np.load(os.path.join(RASTER_FIXTURES, "reads.npz"))
        with open(os.path.join(RASTER_FIXTURES, "errors.json")) as f:
            errors = json.load(f)
        bad, n_reads = [], 0
        for name in sorted(mk.small_cases()):
            with open(os.path.join(RASTER_FIXTURES, name), "rb") as f:
                data = f.read()
            for k in mk.SEEKS:
                key = name if k is None else f"{name}@{k}"
                n_reads += 1
                try:
                    px = identify.read(data, k, name)
                except Exception as e:  # noqa: BLE001 -- held to PIL's class
                    want = errors.get(key)
                    got = type(e).__name__
                    if want != got and not (
                            isinstance(e, OSError) and want in (
                                "OSError", "UnidentifiedImageError")):
                        bad.append(key)
                    continue
                want = reads[key] if key in reads.files else None
                if want is None or px.dtype != want.dtype or \
                        not np.array_equal(px, want):
                    bad.append(key)
        log(f"[slice23] {n_reads} reads of the small fixtures as PIL's: "
            f"{n_reads - len(bad)}; differing: {bad}")
        check(not bad, f"fixture reads differ from PIL's: {bad}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[slice23] phase {time.perf_counter() - t_phase:.1f}s")
    return {name: {path: counts[name] for path, counts in launches.items()}
            for name in ("softmax_blend", "blend_fold_epilogue",
                         "blend_fold_stripe")}


ICON_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_icons")


def icon_files():
    """The test-side ICO, CUR, ICNS, BLP, FTEX, DDS and FLI writers, and
    ``slide_files``: ``tests/fixtures/torch_icons/make.py``, loaded by
    path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "icons_make", os.path.join(ICON_FIXTURES, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_slice24(dev) -> dict:
    """Icons, animations and textures (M17, tenth part) on the card:
    ``slide_files``' 4096^2 DDS (BC1, BC7, BC6H, BC4), BLP2 DXT5, FTEX
    DXT1 and two-frame FLC, the 1024^2 ICNS ``ic10`` PNG and the 256^2
    ICOs, each file's and each read's sha256 held to PIL's
    (``slides.json``) and each read under a ``.tif`` name through
    ``read_channel``.  The reads that are one plane (the FLC's frames 0
    and 1, the BC4 DDS, the gray-PNG ICO) go through ``cli.main`` (the
    legacy net at nucleiDAPI's widths, seeded weights) against a plain
    TIFF twin, pages byte-equal, K1 and one K2 epilogue counted per
    path; a colour read through ``cli.main`` raises the ``ValueError``
    both CLIs raise for a plane of several samples.  The committed small
    fixtures read as PIL's reads (EPS's frame 0 refused naming M17).
    Returns, per kernel, its launches on each counted path."""
    import hashlib

    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.io import _native, identify, slides
    from unmicst_tpu_torch.io.tiff import imread, imwrite, num_pages

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {}
    hp = legacy_hp()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice24_")
    try:
        zoo = os.path.join(tmp, "zoo")
        write_model_dir(zoo, "nucleiDAPI", hp, seeded_state(
            hp, "legacy", SEED), "legacy", LEGACY_MEAN, LEGACY_STD)

        def cli_args(src, name, channel):
            return [src, "--tool", "unmicst-legacy", "--model", "nucleiDAPI",
                    "--modelRoot", zoo, "--stackOutput", "--channel",
                    str(channel), "--outputPath", os.path.join(tmp, "out",
                                                               name)]

        def run(src, name, channel):
            out = os.path.join(tmp, "out", name)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(cli_args(src, name, channel), device=dev)
            secs = time.perf_counter() - t0
            launches[name] = kernels.launch_counts()
            check(rc == 0, f"cli.main {name}: rc {rc}")
            (maps,) = [os.path.join(out, f) for f in os.listdir(out)
                       if "_Probabilities_" in f]
            n = launches[name]
            log(f"[slice24] {name}: cli.main {secs:.2f} s; K1 "
                f"{n['softmax_blend']}, K2 epilogue "
                f"{n['blend_fold_epilogue']}, K2 stripe "
                f"{n['blend_fold_stripe']} | {card}")
            return [imread(maps, k) for k in range(num_pages(maps))], secs

        t0 = time.perf_counter()
        check(_native.get_lib() is not None,
              "the native host library (bcndec.cpp, flidec.cpp) did not "
              "build or load")
        log(f"[slice24] native host library ready in "
            f"{time.perf_counter() - t0:.2f} s (g++ where not built yet)")
        mk = icon_files()
        with open(os.path.join(ICON_FIXTURES, "slides.json")) as f:
            ref = json.load(f)
        t0 = time.perf_counter()
        files = mk.slide_files()
        log(f"[slice24] slide_files wrote {len(files)} files in "
            f"{time.perf_counter() - t0:.2f} s")
        check(sorted(files) == sorted(ref), "slide_files and slides.json "
              "name different files")
        k1 = {}
        colour_checked = False
        for fname, (data, seeks) in files.items():
            kind = fname.split(".")[0]
            check(hashlib.sha256(data).hexdigest() == ref[fname][
                "file_sha256"], f"{fname}: the written file differs from "
                "the one PIL read")
            path = os.path.join(tmp, fname)
            with open(path, "wb") as f:
                f.write(data)
            for k in seeks:
                want = ref[fname][f"seek{k}"]
                t0 = time.perf_counter()
                px = identify.read(data, k, fname)
                secs = time.perf_counter() - t0
                same = (hashlib.sha256(px.tobytes()).hexdigest()
                        == want["sha256"] and str(px.dtype) == want["dtype"]
                        and list(px.shape) == want["shape"])
                log(f"[slice24] {fname} ({len(data)} bytes) seek({k}): "
                    f"{'x'.join(map(str, px.shape))} {px.dtype} decoded in "
                    f"{secs:.3f} s; sha256 equal to PIL's read: {same} | "
                    f"{card}")
                check(same, f"{fname} seek({k}): the port's read differs "
                      "from PIL's")
                t0 = time.perf_counter()
                got = slides.read_channel(path, "tif", k)
                log(f"[slice24] {fname} under a .tif name: read_channel "
                    f"{k} in {time.perf_counter() - t0:.3f} s | {card}")
                check(got.dtype == px.dtype and np.array_equal(got, px),
                      f"{fname}: read_channel {k} differs from the decode")
                name = f"{kind}_seek{k}"
                if px.ndim == 3:  # the CLIs take single-sample planes
                    if not colour_checked and px.shape[0] <= 1024:
                        try:
                            cli.main(cli_args(path, name, k + 1), device=dev)
                            refused = False
                        except ValueError as e:  # the CLI's own refusal
                            refused = "single-sample plane" in str(e)
                        log(f"[slice24] {fname} through cli.main: the "
                            f"colour plane refused with ValueError, as the "
                            f"JAX CLI refuses it: {refused}")
                        check(refused, f"{fname}: cli.main took a colour "
                              "plane")
                        colour_checked = True
                    del px, got
                    continue
                side = px.shape[0]
                twin = os.path.join(tmp, f"{name}_plain.tif")
                imwrite(twin, px)
                twin_maps, twin_secs = run(twin, f"{name}_plain", 1)
                k1.setdefault(side, launches[f"{name}_plain"][
                    "softmax_blend"])
                n = launches[f"{name}_plain"]
                check(k1[side] > 0 and n["softmax_blend"] == k1[side]
                      and n["blend_fold_epilogue"] == 1,
                      f"the plain twin did not run K1 and one K2 epilogue: "
                      f"{n}")
                maps, secs = run(path, name, k + 1)
                n = launches[name]
                check(n["softmax_blend"] == k1[side]
                      and n["blend_fold_epilogue"] == 1
                      and n["blend_fold_stripe"] == 0,
                      f"{name} did not run K1 {k1[side]} times and one K2 "
                      f"epilogue: {n}")
                same = len(maps) == len(twin_maps) == 3 and all(
                    np.array_equal(a, b) for a, b in zip(maps, twin_maps))
                log(f"[slice24] {name}: pages byte-equal to the twin's: "
                    f"{same}; cli.main {secs:.2f} s against the twin's "
                    f"{twin_secs:.2f} s | {card}")
                check(same, f"{name}: pages differ from the plain twin's")
                del px, got
        check(colour_checked, "no colour read went through cli.main")
        check(k1.get(SLIDE) == 8, f"K1 at {SLIDE}^2: {k1}")
        del files

        # -- the committed small fixtures -------------------------------------
        reads = np.load(os.path.join(ICON_FIXTURES, "reads.npz"))
        with open(os.path.join(ICON_FIXTURES, "errors.json")) as f:
            errors = json.load(f)
        bad, n_reads = [], 0
        for name in sorted(mk.small_cases()):
            with open(os.path.join(ICON_FIXTURES, name), "rb") as f:
                data = f.read()
            for k in mk.SEEKS:
                key = name if k is None else f"{name}@{k}"
                n_reads += 1
                try:
                    px = identify.read(data, k, name)
                except Exception as e:  # noqa: BLE001 -- held to PIL's class
                    want = errors.get(key)
                    got = type(e).__name__
                    if name.startswith("eps") and not k and "M17" in str(e):
                        # EPS: PIL needs Ghostscript for frame 0 (OSError
                        # without it); the port refuses it naming M17
                        continue
                    if want != got and not (
                            isinstance(e, OSError) and want in (
                                "OSError", "UnidentifiedImageError")):
                        bad.append(key)
                    continue
                if px is None:
                    if errors.get(key) != "UnidentifiedImageError":
                        bad.append(key)
                    continue
                want = reads[key] if key in reads.files else None
                if want is None or px.dtype != want.dtype or \
                        not np.array_equal(px, want):
                    bad.append(key)
        log(f"[slice24] {n_reads} reads of the small fixtures as PIL's: "
            f"{n_reads - len(bad)}; differing: {bad}")
        check(not bad, f"fixture reads differ from PIL's: {bad}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[slice24] phase {time.perf_counter() - t_phase:.1f}s")
    return {name: {path: counts[name] for path, counts in launches.items()}
            for name in ("softmax_blend", "blend_fold_epilogue",
                         "blend_fold_stripe")}


WRITE25_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_write25")


def write25_files():
    """The seeded planes, the entry splitter and the fixed date of the
    ICO, ICNS and PDF writes: ``tests/fixtures/torch_write25/make.py``,
    loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "write25_make", os.path.join(WRITE25_FIXTURES, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_slice25(dev) -> dict:
    """The toolbox's ICO, ICNS and PDF writes (M17, eleventh part) on the
    card's host: ``make.py``'s seeded 4096^2 uint8, bool, RGBA and uint16
    planes through ``imtools.imwrite`` to ``.ico``, ``.icns`` and
    ``.pdf`` (the PDF dated ``make.FIXED_DATE``), each ICO's and ICNS's
    skeleton and entries (read by the port's PNG decoder) and each PDF
    held to PIL's sha256 (``writes.json``), the RGBA PDF refused naming
    M17 and the uint16 one with PIL's ``ValueError``; the resampler's
    native passes against its numpy ones at 4096^2 (LANCZOS to 256^2,
    BICUBIC to 1024^2), the Group 4 encode's seconds and its round trip.
    Then the legacy net (nucleiDAPI's widths, seeded weights) runs
    ``cli.main`` on the uint8 plane as a TIFF, its nuclei map is written
    as an ICO, and that ICO under a ``.tif`` name (the port's read of its
    256^2 entry) runs ``cli.main`` against a plain TIFF twin of the entry,
    pages byte-equal.  Returns, per kernel, its launches on each counted
    path."""
    import numpy as np
    import torch

    from unmicst_tpu_torch import cli, kernels
    from unmicst_tpu_torch.io import _native, ccitt, ico, png, resample
    from unmicst_tpu_torch.io.tiff import imread, imwrite, num_pages
    from unmicst_tpu_torch.utils import imtools

    card = card_label()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    mk = write25_files()
    with open(os.path.join(WRITE25_FIXTURES, "writes.json")) as f:
        ref = json.load(f)
    launches = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice25_")
    try:
        t0 = time.perf_counter()
        check(_native.get_lib() is not None,
              "the native host library (resample.cpp, tiffcodec.cpp) did "
              "not build or load")
        log(f"[slice25] native host library ready in "
            f"{time.perf_counter() - t0:.2f} s (g++ where not built yet)")
        t0 = time.perf_counter()
        planes = mk.planes()
        log(f"[slice25] seeded {SLIDE}^2 planes made in "
            f"{time.perf_counter() - t0:.2f} s")
        check(sorted(ref) == sorted(n + e for n in planes for e in mk.EXTS),
              "make.planes and writes.json name different files")

        # -- ICO, ICNS and PDF of each plane, held to PIL's -------------------
        bad = []
        for name, x in planes.items():
            for ext in mk.EXTS:
                key, want = name + ext, ref[name + ext]
                path = os.path.join(tmp, key)
                t0 = time.perf_counter()
                try:
                    with mk.fixed_gmtime():
                        imtools.imwrite(x, path)
                except Exception as e:  # noqa: BLE001 -- held to PIL's
                    secs = time.perf_counter() - t0
                    got = f"{type(e).__name__}: {e}"
                    if "error" in want:
                        ok = got == want["error"]
                    else:  # PIL writes it through its JPEG 2000 encoder
                        ok = (isinstance(e, NotImplementedError)
                              and "M17" in str(e) and ext == ".pdf"
                              and name == "rgba" and not os.path.exists(path))
                    log(f"[slice25] {key}: refused in {secs:.4f} s "
                        f"({got[:72]}); as expected: {ok}")
                    if not ok:
                        bad.append(key)
                    continue
                secs = time.perf_counter() - t0
                with open(path, "rb") as f:
                    data = f.read()
                os.remove(path)
                t0 = time.perf_counter()
                try:
                    rec = mk.record(data, ext, lambda b: png.decode_png(
                        b, key))
                except ValueError as e:  # lengths or offsets inconsistent
                    rec = str(e)
                same = rec == want
                n = len(rec.get("entries", ())) if same else 0
                log(f"[slice25] {key}: written in {secs:.3f} s "
                    f"({len(data)} bytes"
                    + (f", {n} PNG entries" if n else "") + "); "
                    + ("skeleton and entry pixels" if n else "file")
                    + f" sha256 equal to PIL's: {same} (checked in "
                    f"{time.perf_counter() - t0:.3f} s) | {card}")
                if not same:
                    bad.append(key)
        check(not bad, f"writes differ from PIL's: {bad}")

        # -- the resampler native against numpy, the G4 encoder ---------------
        gray = planes["uint8"]
        for size, filt in (((256, 256), resample.LANCZOS),
                           ((1024, 1024), resample.BICUBIC)):
            t0 = time.perf_counter()
            native = resample.resize(gray, "L", size, filt)
            t1 = time.perf_counter()
            lib = _native.get_lib
            _native.get_lib = lambda: None
            try:
                plain = resample.resize(gray, "L", size, filt)
            finally:
                _native.get_lib = lib
            t2 = time.perf_counter()
            same = np.array_equal(native, plain)
            log(f"[slice25] resize {SLIDE}^2 -> {size[0]}^2 "
                f"{'LANCZOS' if filt == resample.LANCZOS else 'BICUBIC'}: "
                f"native {t1 - t0:.3f} s, numpy {t2 - t1:.3f} s; equal: "
                f"{same} | {card}")
            check(same, f"native and numpy resize to {size} differ")
        rows = np.packbits(planes["bool"].astype(np.uint8), axis=1)
        t0 = time.perf_counter()
        strip = ccitt.encode_g4(rows, SLIDE)
        secs = time.perf_counter() - t0
        back = ccitt.decode(strip, SLIDE, SLIDE, ccitt.COMPRESSION_T6)
        log(f"[slice25] G4 encode of {SLIDE}^2 bilevel: {secs:.4f} s, "
            f"{rows.nbytes / secs / 1e6:.1f} MB/s of packed rows, "
            f"{SLIDE * SLIDE / secs / 1e6:.1f} Mpx/s ({len(strip)} bytes); "
            f"decodes back: {np.array_equal(back, rows)} | {card}")
        check(np.array_equal(back, rows), "the G4 strip does not decode "
              "back to its rows")
        del rows, back, strip

        # -- cli.main: the slide, its nuclei map as an ICO, the ICO's entry ---
        hp = legacy_hp()
        zoo = os.path.join(tmp, "zoo")
        write_model_dir(zoo, "nucleiDAPI", hp, seeded_state(
            hp, "legacy", SEED), "legacy", LEGACY_MEAN, LEGACY_STD)

        def run(src, name):
            out = os.path.join(tmp, "out", name)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main([src, "--tool", "unmicst-legacy", "--model",
                           "nucleiDAPI", "--modelRoot", zoo, "--stackOutput",
                           "--channel", "1", "--outputPath", out],
                          device=dev)
            secs = time.perf_counter() - t0
            launches[name] = kernels.launch_counts()
            check(rc == 0, f"cli.main {name}: rc {rc}")
            (maps,) = [os.path.join(out, f) for f in os.listdir(out)
                       if "_Probabilities_" in f]
            n = launches[name]
            log(f"[slice25] {name}: cli.main {secs:.2f} s; K1 "
                f"{n['softmax_blend']}, K2 epilogue "
                f"{n['blend_fold_epilogue']}, K2 stripe "
                f"{n['blend_fold_stripe']} | {card}")
            return [imread(maps, k) for k in range(num_pages(maps))]

        slide = os.path.join(tmp, "slide.tif")
        imwrite(slide, gray)
        del planes, gray
        nuclei = run(slide, "slide")[0]
        n = launches["slide"]
        check(n["softmax_blend"] == 8 and n["blend_fold_epilogue"] == 1
              and n["blend_fold_stripe"] == 0,
              f"the {SLIDE}^2 slide did not run K1 8 times and one K2 "
              f"epilogue: {n}")
        path = os.path.join(tmp, "nuclei.ico")
        t0 = time.perf_counter()
        imtools.imwrite(nuclei, path)
        secs = time.perf_counter() - t0
        with open(path, "rb") as f:
            data = f.read()
        entry = ico.read_frame(data, 0)
        want = resample.thumbnail(nuclei, "L", (256, 256), resample.LANCZOS)
        log(f"[slice25] the nuclei map as an ICO: written in {secs:.3f} s "
            f"({len(data)} bytes, {len(ico.entries(data))} entries); its "
            f"{entry.shape[0]}x{entry.shape[1]} {entry.dtype} entry is the "
            f"map's LANCZOS thumbnail: {np.array_equal(entry, want)}")
        check(entry.shape == (256, 256) and entry.dtype == np.uint8
              and np.array_equal(entry, want),
              "the ICO's 256^2 entry is not the map's thumbnail")
        as_tif = os.path.join(tmp, "nuclei_ico.tif")
        os.rename(path, as_tif)
        twin = os.path.join(tmp, "nuclei_plain.tif")
        imwrite(twin, entry)
        twin_maps = run(twin, "ico_plain")
        maps = run(as_tif, "ico")
        for name in ("ico_plain", "ico"):
            n = launches[name]
            check(n["softmax_blend"] == 1 and n["blend_fold_epilogue"] == 1
                  and n["blend_fold_stripe"] == 0,
                  f"{name} did not run K1 once and one K2 epilogue: {n}")
        same = len(maps) == len(twin_maps) == 3 and all(
            np.array_equal(a, b) for a, b in zip(maps, twin_maps))
        log(f"[slice25] the ICO under a .tif name: pages byte-equal to the "
            f"twin's: {same}")
        check(same, "the ICO's pages differ from the plain twin's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[slice25] phase {time.perf_counter() - t_phase:.1f}s")
    return {name: {path: counts[name] for path, counts in launches.items()}
            for name in ("softmax_blend", "blend_fold_epilogue",
                         "blend_fold_stripe")}


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--mp-worker"] and len(argv) == 6:
        return mp_worker(*argv[1:])
    if argv:
        print("usage: chip_smoke.py", file=sys.stderr)
        return 2
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
    for name in ("softmax_blend", "blend_fold_epilogue"):
        stats[name]["launches"] = launches[name]
    stats.update(phase_halo(dev))
    stats.update(phase_streaming(dev))
    phase_duo_scale(dev)
    stats["blend_fold_epilogue_f32"]["launches"] = phase_sweep(dev)
    phase_train(dev)
    phase_int8(dev)
    stats.update(phase_serve(dev))
    for name, (n, ms) in phase_multiprocess(dev).items():
        stats[name]["launches_across_processes"] = n
        stats[name]["ms_across_processes"] = ms
    for name, per_path in phase_formats(dev).items():
        stats[name]["launches_formats"] = per_path
    for name, per_path in phase_slice12(dev).items():
        stats[name]["launches_slice12"] = per_path
    for name, per_path in phase_slice13(dev).items():
        stats[name]["launches_slice13"] = per_path
    for name, per_path in phase_slice15(dev).items():
        stats[name]["launches_slice15"] = per_path
    for name, per_path in phase_slice16(dev).items():
        stats[name]["launches_slice16"] = per_path
    for name, per_path in phase_slice17(dev).items():
        stats[name]["launches_slice17"] = per_path
    for name, per_path in phase_slice18(dev).items():
        stats[name]["launches_slice18"] = per_path
    for name, per_path in phase_slice19(dev).items():
        stats[name]["launches_slice19"] = per_path
    for name, per_path in phase_slice20(dev).items():
        stats[name]["launches_slice20"] = per_path
    for name, per_path in phase_slice21(dev).items():
        stats[name]["launches_slice21"] = per_path
    for name, per_path in phase_slice22(dev).items():
        stats[name]["launches_slice22"] = per_path
    for name, per_path in phase_slice23(dev).items():
        stats[name]["launches_slice23"] = per_path
    for name, per_path in phase_slice24(dev).items():
        stats[name]["launches_slice24"] = per_path
    for name, per_path in phase_slice25(dev).items():
        stats[name]["launches_slice25"] = per_path
    log(f"[done] {time.perf_counter() - t0:.1f}s")
    rows = []
    for name, row in stats.items():
        rows.append({"name": name, **{k: row[k] for k in (
            "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")},
            **{k: v for k, v in row.items()
               if k.endswith("processes")
               or k in ("launches_formats", "launches_slice12",
                        "launches_slice13", "launches_slice15",
                        "launches_slice16", "launches_slice17",
                        "launches_slice18", "launches_slice19",
                        "launches_slice20", "launches_slice21",
                        "launches_slice22", "launches_slice23",
                        "launches_slice24", "launches_slice25")}})
    print(json.dumps({"kernels": rows}))
    print(card_label())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
