"""Command line: a slide to probability-map TIFFs on the GPU.

The main path of ``unmicst_tpu/cli.py`` (``:770-862`` and
``_write_outputs`` at ``:323-367``) for every tool, ``unmicst-solo``,
``unmicst-legacy``, ``unmicst-duo`` and ``UnMicstCyto2``::

    python -m unmicst_tpu_torch IMAGE --tool unmicst-legacy --model nucleiDAPI
        --outputPath OUT [--stackOutput] [--channel N [N2]]
        [--channelName NAME [NAME2]] [--classOrder A B C] [--outlier F]
        [--scalingFactor F] [--intensityRange LO,HI [LO,HI]]
        [--precision float32|highest|bfloat16|int8]
        [--calibrationPercentile P] [--tileBatch N]
        [--modelRoot DIR] [--GPU N] [--stats]
        [--engine auto|whole|streaming|sharded] [--meshShape N]
        [--check-numerics] [--trace DIR] [--usePyramid]
        [--pyramidOutput] [--compressOutput [deflate|zstd]]
    python -m unmicst_tpu_torch --listModels [--modelRoot DIR]

Inputs: TIFF, OME-TIFF and BigTIFF (uncompressed, Deflate, LZW,
PackBits, LZMA or zstd strips and tiles), CZI and ND2 (``--channelName``
resolves through a CZI's metadata XML as through OME-XML).
``--usePyramid`` at ``--scalingFactor`` 0.5 or below reads the deepest
stored SubIFD level of a pyramidal TIFF whose integer divisor does not
pass ``1 / scalingFactor``, runs the whole engine at the residual scale
``scalingFactor * divisor`` and brings the maps back to the full size
(``cli.py:643-676`` of the JAX package); it does not combine with
``--engine streaming|sharded``.  ``--pyramidOutput`` writes every output
page tiled with a SubIFD pyramid; ``--compressOutput`` writes Deflate
(bare flag) or zstd pages.

``--tool unmicst-duo`` (nucleiDAPILAMIN) feeds two channels, ``--channel
A B`` (one channel is fed twice), each rescaled with its own range; its
preview page shows the last channel (``UnMicst2.py:776,792``).
``--scalingFactor`` resizes the plane before the net and the maps back to
the raw size after it (``UnMicst1-5.py:813-854``): on the card in the
whole-slide engine, through a virtual resized source on the stream.

Output contract: ``<stem>_Probabilities_<chan+1>.tif`` (classOrder pages
reversed) plus ``qc/<stem>_Preview_<chan+1>.tif`` with ``--stackOutput``;
otherwise ``<stem>_ContoursPM_<chan+1>.tif`` (map, raw preview) and
``<stem>_NucleiPM_<chan+1>.tif``.  Cyto2 uses the 0-based channel suffix
and writes its preview beside the maps.  The v2 solo tool feeds the
un-rescaled image to the net (``UnMicst1-5.py:815-816,848``).

Engines (``cli.py:735`` of the JAX package): ``--engine auto`` streams
single-channel TIFF/OME-TIFF slides above 64 Mpx through the
``StreamingEngine`` (bounded memory, read in windows) and runs smaller
ones through the whole-slide engine; ``streaming`` and ``sharded`` force
the stream, ``sharded`` with every stripe column-sharded over a mesh of
``--meshShape`` ranks (default: every visible card; on the CPU, ranks that
share it).

The whole engine runs on the card from the raw planes when every plane
is uint8 or uint16, of one dtype, and ``--check-numerics`` is off
(``_device_slide_ok``, ``cli.py:306-321`` of the JAX package).  Other
inputs (int16, float32 and float64 planes, duo channels of mixed dtypes)
and ``--check-numerics`` take the host float path (``cli.py:764-867``):
``preprocess_channel`` on the host, ``InferenceEngine.infer`` on the card
(the net, K1 and K2's float32 epilogue), then ``postprocess_pm`` per page.
``--check-numerics`` scans the params and the float maps for NaN/Inf
(under ``--engine streaming|sharded`` the params only: the stream's maps
are uint8 on the card); ``--trace DIR`` leaves a ``torch.profiler``
Chrome trace of the inference in ``DIR``; ``--listModels`` prints which
zoo models each model root can load.

``--precision int8`` is the bfloat16 mode with the plain conv sites in
int8 (``core/quant.py``; ``precision_mode``, ``cli.py:237-254`` of the
JAX package), calibrated from the slide with ``--calibrationPercentile``
in every engine.

zstd needs the host's libzstd; without it zstd inputs and
``--compressOutput zstd`` refuse naming ROADMAP M14b.  CZI sub-blocks in
JPEG decode through ``io/jpeg.py``; JPEG XR ones refuse (no decoder under
the port's import rule).
``--fetchModels`` is a download, which this package does not do.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import List, Optional

import numpy as np

DEFAULT_MODEL_ROOTS = [
    os.environ.get("UNMICST_TPU_MODEL_ROOT", ""),
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "models"),
]

TOOL_DEFAULT_MODEL = {
    "unmicst-legacy": "nucleiDAPI",  # UnMicst.py:547
    "unmicst-solo": "nucleiDAPI1-5",  # UnMicst1-5.py:716
    "unmicst-duo": "nucleiDAPILAMIN",  # UnMicst2.py:695
    "UnMicstCyto2": "nucleiDAPI",  # UnMicstCyto2.py:695
}

# --engine auto streams slides above this many pixels
MAX_WHOLE_SLIDE_PX = 64_000_000


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m unmicst_tpu_torch",
        description="UnMICST probability maps on an NVIDIA GPU (PyTorch/CUDA)",
    )
    p.add_argument("imagePath", nargs="?",
                   help="path to the image (.tif/.ome.tif/.btf/.czi/.nd2)")
    p.add_argument("--tool", default="unmicst-solo",
                   choices=list(TOOL_DEFAULT_MODEL))
    p.add_argument("--model", help="model directory name (or absolute path)")
    p.add_argument("--outputPath", help="output path of probability map")
    p.add_argument("--channel", nargs="+", type=int, default=[1],
                   help="channel to perform inference on, 1-based")
    p.add_argument("--channelName", nargs="+", metavar="NAME",
                   help="select the channel by OME-XML Channel Name")
    p.add_argument("--classOrder", nargs="+", type=int, default=-1,
                   help="background, contours, foreground (1-based)")
    p.add_argument("--mean", type=float, default=-1)
    p.add_argument("--std", type=float, default=-1)
    p.add_argument("--scalingFactor", type=float, default=1)
    p.add_argument("--stackOutput", action="store_true")
    p.add_argument("--GPU", type=int, default=-1,
                   help="CUDA device index; -1 picks the card with the most "
                   "free memory (UnMicst.py:577-595)")
    p.add_argument("--outlier", type=float, default=-1)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--modelRoot", help="directory containing model subdirs")
    p.add_argument("--precision", default="float32",
                   choices=["float32", "highest", "bfloat16", "int8"],
                   help="float32 and highest: full float32 convolutions "
                   "(TF32 off); bfloat16: bf16 operands, float32 sums; "
                   "int8: bfloat16 with the plain convs quantized")
    p.add_argument("--tileBatch", type=int, default=0,
                   help="tiles per forward batch; 0 = from the card's free "
                   "memory, at most 256")
    p.add_argument("--calibrationPercentile", type=float, default=99.99,
                   help="int8 activation-scale clipping percentile (only "
                   "with --precision int8)")
    p.add_argument("--stats", action="store_true",
                   help="print stage timings + Mpx/s")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "whole", "streaming", "sharded"],
                   help="auto: stream slides > 64 Mpx (bounded memory); "
                   "whole: one device-resident pass; sharded: stream with "
                   "each stripe column-sharded over the rank mesh")
    p.add_argument("--meshShape", type=int, metavar="N",
                   help="with --engine sharded: ranks along the column "
                   "axis (default: every visible card)")
    p.add_argument("--usePyramid", action="store_true",
                   help="with --scalingFactor <= 0.5: read the nearest "
                   "stored SubIFD level instead of full resolution")
    p.add_argument("--pyramidOutput", action="store_true",
                   help="write tiled SubIFD-pyramid output pages")
    p.add_argument("--compressOutput", nargs="?", const="deflate",
                   default=None, choices=["deflate", "zstd"],
                   help="compress output pages (bare flag = deflate)")
    p.add_argument("--intensityRange", nargs="+", metavar="LO,HI",
                   help="pin the rescale range (raw pixel units)")
    p.add_argument("--trace", metavar="DIR",
                   help="write a torch.profiler trace of the inference "
                   "into DIR")
    p.add_argument("--check-numerics", action="store_true",
                   help="scan params and probability maps for NaN/Inf "
                   "(takes the host float path)")
    p.add_argument("--listModels", action="store_true",
                   help="print model zoo availability and exit")
    p.add_argument("--fetchModels", nargs="*", metavar="NAME",
                   help="download checkpoint blobs (not in this package)")
    return p


def _trace(args):
    """``--trace DIR``: a profiler session around the inference."""
    if not args.trace:
        return contextlib.nullcontext()
    from unmicst_tpu_torch.utils.profiling import trace

    return trace(args.trace)


def _list_models(model_root: Optional[str]) -> int:
    """``--listModels`` (``unmicst_tpu/cli.py:524-538``)."""
    from unmicst_tpu_torch.models.zoo import available_models

    roots = [model_root] if model_root else [
        r for r in DEFAULT_MODEL_ROOTS if r and os.path.isdir(r)]
    bad = [r for r in roots if not os.path.isdir(r)]
    if bad or not roots:
        raise SystemExit(f"no such model root: {bad or DEFAULT_MODEL_ROOTS}")
    for root in roots:
        print(f"{root}:")
        for name, status in sorted(available_models(root).items()):
            print(f"  {name}: {status}")
    return 0


def _device_slide_ok(args, planes) -> bool:
    """Whether the whole engine runs from the raw planes on the card: no
    ``--check-numerics`` (uint8 maps would quantise NaN/Inf away), every
    plane uint8 or uint16 (a known im2double on the card), one dtype."""
    return (not args.check_numerics
            and all(p.dtype in (np.uint8, np.uint16) for p in planes)
            and len({p.dtype for p in planes}) == 1)


def resolve_model_dir(model: str, model_root: Optional[str]) -> str:
    if os.path.isabs(model) and os.path.isdir(model):
        return model
    roots = [model_root] if model_root else [r for r in DEFAULT_MODEL_ROOTS if r]
    for root in roots:
        cand = os.path.join(root, model)
        if os.path.isdir(cand):
            return cand
    raise FileNotFoundError(
        f"model dir '{model}' not found under {roots}; set --modelRoot"
    )


def parse_stem(file_name: str, tool: str):
    """Stem/extension parsing, per-tool parity."""
    if tool == "unmicst-solo":
        parts = file_name.split(os.extsep)  # UnMicst1-5.py:783-792
        if len(parts) < 2:
            raise ValueError("Input filename has no extension")
        if parts[-2] == "ome":
            return os.extsep.join(parts[:-2]), os.extsep.join(parts[-2:])
        return os.extsep.join(parts[:-1]), parts[-1]
    parts = file_name.split(os.extsep, 1)  # UnMicst.py:603-605
    return parts[0], parts[1] if len(parts) > 1 else ""


def _pinned_ranges(args, tool: str, n: int):
    """``--intensityRange`` -> a list of ``n`` raw-unit (lo, hi) pairs (one
    given pair serves every channel), or None (``cli.py:75-104``)."""
    if not args.intensityRange:
        return None
    if tool == "unmicst-solo":
        raise SystemExit(
            "--intensityRange has no effect on unmicst-solo: its net input "
            "is deliberately un-rescaled (the reference quirk)"
        )
    from unmicst_tpu_torch.infer import _normalize_in_range

    pairs = []
    for text in args.intensityRange:
        parts = text.split(",")
        try:
            if len(parts) != 2:
                raise ValueError(f"expected LO,HI, got {text!r}")
            pairs.append((float(parts[0]), float(parts[1])))
        except ValueError as e:
            raise SystemExit(f"--intensityRange: {e}")
    try:
        arr = _normalize_in_range(pairs, n)
    except ValueError as e:
        raise SystemExit(f"--intensityRange: {e}")
    return [tuple(p) for p in arr.tolist()]


def _duo_chans(channels0):
    """The duo tool's two channels: ``--channel A B``, else the first
    channel twice (the wrapper forwards ``channel[0]`` unless exactly two
    are given)."""
    return channels0 if len(channels0) == 2 else channels0[:1] * 2


def _write_outputs(args, stem, out_path, cyto, dapi_channel, class_order,
                   get_page, raw_preview_u8) -> None:
    """The output-file contract (``unmicst_tpu/cli.py:323-367``).
    ``get_page(i_class) -> uint8 [H, W]``."""
    from unmicst_tpu_torch.io.tiff import imwrite

    compression = args.compressOutput
    chan_suffix = str(dapi_channel if cyto else dapi_channel + 1)
    qc_dir = out_path if cyto else os.path.join(out_path, "qc")

    def out_file(kind: str) -> str:
        return os.path.join(out_path, f"{stem}_{kind}_{chan_suffix}.tif")

    def put(path, page, append):
        imwrite(path, page, bigtiff=True, append=append,
                compression=compression, pyramid=args.pyramidOutput)

    if args.stackOutput:
        prob_file = out_file("Probabilities")
        preview_file = os.path.join(qc_dir, f"{stem}_Preview_{chan_suffix}.tif")
        for slice_idx, i_class in enumerate(class_order[::-1]):
            pm = get_page(i_class)
            put(prob_file, pm, slice_idx > 0)
            if slice_idx == 1:
                put(preview_file, pm, False)
                put(preview_file, raw_preview_u8, True)
    else:
        f = out_file("ContoursPM")
        put(f, get_page(class_order[1]), False)
        put(f, raw_preview_u8, True)
        put(out_file("NucleiPM"), get_page(class_order[2]), False)


def _pyramid_plan(args, file_type: str, chans):
    """``--usePyramid``'s ``(level, divisor, full_shape, level_shape)``, or
    None with a note when no stored level serves (``cli.py:643-676`` of the
    JAX package)."""
    from unmicst_tpu_torch.io.slides import pyramid_plan_multi

    pyr = pyramid_plan_multi(args.imagePath, file_type,
                             list(dict.fromkeys(chans)), args.scalingFactor)
    if pyr is None:
        print("[unmicst-tpu-torch] --usePyramid: no usable stored level "
              "(needs SubIFDs on every channel page and --scalingFactor "
              "<= 0.5) — reading full resolution", file=sys.stderr)
        return None
    if args.engine in ("streaming", "sharded"):
        raise SystemExit(
            f"--usePyramid decodes a stored level whole (the whole engine); "
            f"it does not combine with --engine {args.engine}")
    if args.verbose or args.stats:
        print(f"[unmicst-tpu-torch] pyramid: stored level {pyr[0]} "
              f"(1/{pyr[1]}) + residual scale "
              f"{args.scalingFactor * pyr[1]:.3f}", file=sys.stderr)
    return pyr


def _use_streaming(args, tool: str, cyto: bool, file_type: str,
                   chans, pyr=None) -> bool:
    """Whether the slide streams: ``--engine streaming|sharded``, or
    ``auto`` above 64 Mpx (of the stored level's pixels under
    ``--usePyramid``), when every channel can stream (a TIFF, CZI or ND2;
    uint8 or uint16 for the un-rescaled solo tool; one of uint8, uint16 or
    int16 across the channels for an exact streamed histogram; no float32
    for Cyto2, which never takes the parity cast)."""
    from unmicst_tpu_torch.io.slides import TIFF_LIKE, open_channel_source

    explicit = args.engine in ("streaming", "sharded")
    if file_type not in TIFF_LIKE + ("czi", "nd2"):
        if explicit:
            raise SystemExit(
                f"--engine {args.engine} supports TIFF/CZI/ND2 inputs")
        return False
    dtypes, raw_dtypes = [], []
    try:
        for c in dict.fromkeys(chans):
            with open_channel_source(args.imagePath, file_type, c) as src:
                px = src.height * src.width
                dtypes.append(src.dtype)
                raw_dtypes.append(src.raw_dtype)
    except (ValueError, NotImplementedError, IndexError, OSError):
        return explicit  # the stream raises the reader's own error
    if tool == "unmicst-solo":
        ok = dtypes[0] in (np.dtype(np.uint8), np.dtype(np.uint16))
        why = f"rescale-free streaming needs uint8/uint16, got {dtypes[0]}"
    else:
        ok = len(set(dtypes)) == 1 and dtypes[0] in (
            np.dtype(np.uint8), np.dtype(np.uint16), np.dtype(np.int16))
        why = ("streamed stats need one integer dtype across channels, got "
               f"{sorted(map(str, dtypes))}")
    if cyto and np.dtype(np.float32) in raw_dtypes:
        ok, why = False, "Cyto2 float32 input must not take the parity cast"
    if not ok:
        if explicit:
            raise SystemExit(f"--engine {args.engine}: {why}; use --engine "
                             "whole")
        return False
    if pyr is not None:
        px = pyr[3][0] * pyr[3][1]
    if not explicit and not (args.engine == "auto"
                             and px > MAX_WHOLE_SLIDE_PX):
        return False
    if args.check_numerics:
        # the stream's maps are uint8 on the card: auto takes the whole
        # engine's float path, an explicit engine scans the params only
        if not explicit:
            return False
        print(f"note: --check-numerics under --engine {args.engine} scans "
              "params only (maps are uint8 on the card)")
    return True


def _run_streaming(args, bundle, tool, chans, class_order, file_type, stem,
                   out_path, cyto, pinned, dev, t_start) -> int:
    """The large-slide path (``_run_streaming``, ``cli.py:370-517`` of the
    JAX package): the ``StreamingEngine``, bounded memory, uint8 maps end
    to end; at ``--scalingFactor`` other than 1 it streams virtual
    resized sources and resizes the maps back as it writes them."""
    from unmicst_tpu_torch.core.checkpoint import load_params_for_bundle
    from unmicst_tpu_torch.infer import PRECISIONS
    from unmicst_tpu_torch.io import preprocess as pp
    from unmicst_tpu_torch.io.slides import open_channel_source, preview_u8
    from unmicst_tpu_torch.runtime.mesh import make_mesh
    from unmicst_tpu_torch.runtime.pipeline import StreamingEngine

    params = load_params_for_bundle(bundle)
    stream = StreamingEngine.from_bundle(
        bundle, params,
        compute_dtype=PRECISIONS[args.precision],
        tile_batch=args.tileBatch or None,
        quantized=args.precision == "int8",
        calibration_percentile=args.calibrationPercentile, device=dev,
    )
    classes = (None if args.stackOutput or len(class_order) < 3
               else (class_order[1], class_order[2]))
    mesh = None
    if args.engine == "sharded":
        if dev.type == "cuda":
            mesh = make_mesh(data=args.meshShape or None)
        else:  # ranks that share the CPU
            mesh = make_mesh(devices=[dev] * (args.meshShape or 1))
        if args.verbose or args.stats:
            print(f"[unmicst-tpu-torch] sharded engine: {mesh.shape['data']}"
                  " rank(s) on the column axis", file=sys.stderr)
    sf = args.scalingFactor
    duo = tool == "unmicst-duo"
    rescale = tool != "unmicst-solo"  # the v2-solo quirk
    t0 = time.perf_counter()
    srcs = {}
    try:
        for c in dict.fromkeys(chans):
            srcs[c] = open_channel_source(args.imagePath, file_type, c)
        # at scale 1 one histogram pass per channel gives the range and
        # the preview's max
        shared, vmaxes = {}, {}
        if sf == 1 and rescale:
            for c, src in srcs.items():
                lo, hi, vmaxes[c] = src.stats(args.outlier, with_max=True)
                shared[c] = (lo, hi)
        net_srcs = [pp.ResampledSource(srcs[c], sf) if sf != 1 else srcs[c]
                    for c in chans]
        if pinned:  # raw units -> the units each source streams
            stats = [pp.pinned_to_source_units(p, s)
                     for p, s in zip(pinned, net_srcs)]
        else:
            stats = [shared[c] for c in chans] if shared else None
        kw = dict(outlier=args.outlier, classes=classes)
        with _trace(args):
            if duo:
                maps = (stream.infer_sharded_stack(net_srcs, mesh,
                                                   stats=stats, **kw)
                        if mesh is not None
                        else stream.infer_stack(net_srcs, stats=stats, **kw))
            else:
                kw.update(rescale=rescale,
                          stats=stats[0] if stats else None)
                maps = (stream.infer_sharded(net_srcs[0], mesh, **kw)
                        if mesh is not None
                        else stream.infer(net_srcs[0], **kw))
            t_infer = time.perf_counter()
            raw_src = srcs[chans[-1]]  # the duo preview: the last channel
            shape = (raw_src.height, raw_src.width)
            raw_u8 = preview_u8(raw_src, vmax=vmaxes.get(chans[-1]))
    finally:
        for src in srcs.values():
            src.close()
    if args.check_numerics:
        from unmicst_tpu_torch.utils.profiling import check_numerics

        check_numerics(params, "params")
    idx = ({c: i for i, c in enumerate(classes)} if classes is not None
           else {c: c for c in class_order})

    def page(c):
        return pp.upscale_pm(maps[idx[c]], shape) if sf != 1 else maps[idx[c]]
    _write_outputs(args, stem, out_path, cyto, chans[0], class_order, page,
                   raw_u8)
    if args.stats or args.verbose:
        infer_s = t_infer - t0
        print(
            f"[unmicst-tpu-torch] streaming infer {infer_s:.2f}s "
            f"({shape[0] * shape[1] / 1e6 / infer_s:.1f} Mpx/s) | total "
            f"{time.perf_counter() - t_start:.2f}s",
            file=sys.stderr,
        )
    return 0


def main(argv: Optional[List[str]] = None, *, device="cuda") -> int:
    """Run the CLI.  ``device``: ``"cuda"`` (the default; ``--GPU`` picks
    the card, and no card raises) or ``"cpu"``, which only a caller may
    ask for."""
    args = build_parser().parse_args(argv)
    if args.listModels:
        return _list_models(args.modelRoot)
    if args.fetchModels is not None:
        raise SystemExit(
            "--fetchModels downloads checkpoint blobs; unmicst_tpu_torch "
            "does not download (not ported): use unmicst_tpu --fetchModels")
    if not args.imagePath:
        raise SystemExit("imagePath is required (or use --listModels)")
    if args.compressOutput == "zstd":
        from unmicst_tpu_torch.io import zstd

        if not zstd.available():  # refuse before any inference
            raise SystemExit(f"--compressOutput zstd: {zstd.unavailable()}")
    t_start = time.perf_counter()

    import torch

    from unmicst_tpu_torch.core.checkpoint import load_params_for_bundle
    from unmicst_tpu_torch.core.hp import load_model_dir
    from unmicst_tpu_torch.infer import PRECISIONS, InferenceEngine
    from unmicst_tpu_torch.io import preprocess as pp
    from unmicst_tpu_torch.io.slides import (read_channel, read_channel_level,
                                             resolve_channel_names)
    from unmicst_tpu_torch.runtime.devices import describe, resolve_device, select_device

    dev = torch.device(device)
    dev = select_device(args.GPU) if dev.type == "cuda" else resolve_device(dev)
    print(f"Using device {describe(dev)}")

    tool = args.tool
    model_dir = resolve_model_dir(args.model or TOOL_DEFAULT_MODEL[tool],
                                  args.modelRoot)
    bundle = load_model_dir(model_dir, args.mean, args.std)
    hp = bundle.hp

    channels0 = [c - 1 for c in args.channel]  # wrapper 1-based -> 0-based
    if args.classOrder == -1:
        class_order = list(range(hp.n_classes))
    else:
        class_order = [c - 1 for c in args.classOrder]
    if not args.stackOutput and len(class_order) < 3:
        raise SystemExit(
            "non-stack output needs 3 classes (contours+nuclei); this model "
            "has fewer — use --stackOutput (the reference tool crashes with "
            "an IndexError here)"
        )

    stem, file_type = parse_stem(os.path.basename(args.imagePath), tool)
    if args.channelName:
        try:
            channels0 = resolve_channel_names(args.imagePath, file_type,
                                              args.channelName)
        except (ValueError, NotImplementedError) as e:
            raise SystemExit(f"--channelName: {e}")
    duo = tool == "unmicst-duo"
    chans = _duo_chans(channels0) if duo else channels0[:1]
    parent = os.path.dirname(os.path.dirname(args.imagePath))
    out_path = args.outputPath or os.path.join(parent, "probability_maps")
    os.makedirs(out_path, exist_ok=True)
    cyto = tool == "UnMicstCyto2"
    if not cyto:
        os.makedirs(os.path.join(out_path, "qc"), exist_ok=True)
    pinned = _pinned_ranges(args, tool, len(chans))
    pyr = _pyramid_plan(args, file_type, chans) if args.usePyramid else None
    sf = args.scalingFactor * pyr[1] if pyr else args.scalingFactor

    # ---- engine choice (cli.py:681-759 of the JAX package) -----------------
    if _use_streaming(args, tool, cyto, file_type, chans, pyr):
        return _run_streaming(args, bundle, tool, chans, class_order,
                              file_type, stem, out_path, cyto, pinned, dev,
                              t_start)

    # ---- read + preprocess -------------------------------------------------
    t_read = time.perf_counter()
    try:
        by_chan = {c: (read_channel_level(args.imagePath, file_type, c,
                                          pyr[0]) if pyr
                       else read_channel(args.imagePath, file_type, c))
                   for c in dict.fromkeys(chans)}
    except NotImplementedError as e:
        raise SystemExit(str(e))
    planes = [by_chan[c] for c in chans]
    for raw in planes:
        if raw.ndim != 2:  # JAX's CLI fails unpacking the shape: ValueError
            raise ValueError(f"expected a single-sample plane, got "
                             f"{raw.shape}")
    on_card = _device_slide_ok(args, planes)
    if on_card:
        preview = pp.preview_u8_from_raw(planes[-1])  # duo: the last channel
    else:
        # the host float path (cli.py:764-867 of the JAX package)
        net, raw_norm = [], None
        for i, raw in enumerate(planes):
            pc = pp.preprocess_channel(
                raw, sf, args.outlier,
                use_rescaled=tool != "unmicst-solo", cast_float32=not cyto,
                in_range=pinned[i] if pinned else None)
            net.append(pc.net_input)
            raw_norm, raw_shape = pc.raw_norm, pc.raw_shape  # last wins
        net_image = np.stack(net).astype(np.float32)
        preview = np.uint8(255 * raw_norm)

    # ---- inference (single pass, all classes) ------------------------------
    t_pre = time.perf_counter()
    params = load_params_for_bundle(bundle)
    engine = InferenceEngine.from_bundle(
        bundle, params, compute_dtype=PRECISIONS[args.precision],
        tile_batch=args.tileBatch or None,
        quantized=args.precision == "int8",
        calibration_percentile=args.calibrationPercentile, device=dev,
    )
    t_load = time.perf_counter()
    with _trace(args):
        if on_card:
            # non-stack output needs only the contour and nuclei planes
            classes = (None if args.stackOutput or len(class_order) < 3
                       else (class_order[1], class_order[2]))
            kw = dict(outlier=args.outlier, classes=classes,
                      scaling_factor=sf)
            if duo:
                maps = engine.infer_slide_stack(planes, in_range=pinned, **kw)
            else:
                maps = engine.infer_slide(
                    planes[0], rescale=tool != "unmicst-solo",
                    in_range=pinned[0] if pinned else None, **kw)
            idx = {c: i for i, c in enumerate(classes)} if classes else None

            def get_page(c):
                return maps[idx[c] if idx else c]
        else:
            maps = engine.infer(net_image, "stack" if duo else "broadcast")

            def get_page(c):
                return pp.postprocess_pm(maps[c], raw_shape)
    if args.check_numerics:
        from unmicst_tpu_torch.utils.profiling import check_numerics

        check_numerics(params, "params")
        check_numerics(maps, "probability maps")
    t_infer = time.perf_counter()
    if pyr is not None:
        # the stored level's maps and preview back to the full size: the
        # output contract is the raw dims (UnMicst1-5.py:848-854)
        level_page = get_page

        def get_page(c):
            return pp.upscale_pm(level_page(c), pyr[2])
        preview = pp.upscale_pm(preview, pyr[2])

    _write_outputs(args, stem, out_path, cyto, chans[0], class_order,
                   get_page, preview)
    t_write = time.perf_counter()
    if args.stats or args.verbose:
        h, w = planes[0].shape
        infer_s = t_infer - t_load
        print(
            f"[unmicst-tpu-torch] read+pre {t_pre - t_read:.2f}s | model "
            f"load {t_load - t_pre:.2f}s | infer {infer_s:.2f}s "
            f"({h * w / 1e6 / infer_s:.1f} Mpx/s, all {hp.n_classes} "
            f"classes) | write {t_write - t_infer:.2f}s | total "
            f"{t_write - t_start:.2f}s",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
