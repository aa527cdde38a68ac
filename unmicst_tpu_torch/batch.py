"""Batch slide sweeps on the GPU: the ``batchUnMicst.py`` successor,
resumable and split over hosts (``unmicst_tpu/batch.py``).

The reference (``batchUnMicst.py:533-588``) sets the model up once, globs
``<root>/exemplar*``, takes each sample's ``registration/*ome.tif`` (or
``dearray/*.tif`` minus ``TMA_MAP.tif`` with ``--TMA``), runs the net and
writes ``prob_maps/<stem>_{ContoursPM,NucleiPM}_<chan+1>.tif``: a two-page
``ContoursPM`` (map, then the raw preview) and a one-page ``NucleiPM``.
As in the JAX package:

* one whole-slide engine and one streaming engine serve every slide, with
  all classes in one pass;
* a JSON cursor per shard and output directory
  (``.unmicst-tpu-cursor[.N].json``, the JAX package's names, so a sweep
  one package started the other resumes) records finished slides, which a
  later run skips;
* ``shard_index`` / ``num_shards`` give each host every N-th slide;
* a slide that fails is recorded in the report and the sweep goes on;
* slides above ``stream_above_px`` (or every slide, given a mesh) stream
  in bounded memory at any scale, column-sharded over the mesh's ranks
  with ``mesh``.

Run it as ``python -m unmicst_tpu_torch.batch ROOT --model M ...``; it
runs on the card unless a caller asks for ``device="cpu"``, and exits 2
when any slide failed.  Pyramid input and output and zstd output refuse,
naming ROADMAP M14.
"""

from __future__ import annotations

import contextlib
import fnmatch
import glob
import json
import os
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np


@dataclass
class BatchReport:
    completed: List[str] = field(default_factory=list)
    skipped: List[str] = field(default_factory=list)
    failed: List[str] = field(default_factory=list)
    mpx_total: float = 0.0
    wall_s: float = 0.0
    # per completed slide: seconds with the read and the writes, and the
    # inference alone
    seconds: Dict[str, float] = field(default_factory=dict)
    infer_seconds: Dict[str, float] = field(default_factory=dict)


def discover_slides(root: str, tma: bool = False,
                    sample_glob: str = "exemplar*") -> List[str]:
    """The slides of a sweep root (``batchUnMicst.py:548-556``)."""
    slides: List[str] = []
    for sample in sorted(os.listdir(root)) if os.path.isdir(root) else []:
        if not fnmatch.fnmatch(sample, sample_glob):
            continue
        sub = os.path.join(root, sample, "dearray" if tma else "registration")
        if not os.path.isdir(sub):
            continue
        for f in sorted(os.listdir(sub)):
            if tma:
                # batchUnMicst.py:553 leaves the TMA map out
                if f.endswith(".tif") and f != "TMA_MAP.tif":
                    slides.append(os.path.join(sub, f))
            elif f.endswith("ome.tif"):
                slides.append(os.path.join(sub, f))
    return slides


def _cursor_path(out_dir: str, shard_index: int = 0) -> str:
    # one file per shard: shards sweeping into one output dir never
    # rewrite each other's records
    suffix = f".{shard_index}" if shard_index else ""
    return os.path.join(out_dir, f".unmicst-tpu-cursor{suffix}.json")


def _load_done(out_dir: str) -> set:
    """The union of every shard's records in ``out_dir``."""
    done = set()
    for path in glob.glob(os.path.join(out_dir, ".unmicst-tpu-cursor*.json")):
        try:
            with open(path) as f:
                done.update(json.load(f).get("done", []))
        except (OSError, ValueError):
            pass
    return done


def _save_cursor(out_dir: str, cursor: dict, shard_index: int = 0) -> None:
    path = _cursor_path(out_dir, shard_index)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cursor, f)
    os.replace(tmp, path)


def _record_done(my_done: dict, done_cache: dict, out_dir: str,
                 shard_index: int, slide: str) -> None:
    """Append a finished slide to this shard's cursor file."""
    if out_dir not in my_done:
        # seed with this shard's earlier records, or a resumed run would
        # truncate its own cursor
        try:
            with open(_cursor_path(out_dir, shard_index)) as f:
                my_done[out_dir] = list(json.load(f).get("done", []))
        except (OSError, ValueError):
            my_done[out_dir] = []
    my_done[out_dir].append(slide)
    done_cache.setdefault(out_dir, set()).add(slide)
    _save_cursor(out_dir, {"done": my_done[out_dir]}, shard_index)


def run_sweep(
    slides: List[str],
    model_dir: str,
    out_dir: Optional[str] = None,
    *,
    channel: int = 0,
    channel_name=None,
    scaling_factor: float = 1.0,
    outlier: float = -1,
    mean: float = -1,
    std: float = -1,
    compute_dtype=None,
    tile_batch: Optional[int] = None,
    shard_index: int = 0,
    num_shards: int = 1,
    resume: bool = True,
    verbose: bool = True,
    stream_above_px: int = 64_000_000,
    compress_output: Union[bool, str, None] = False,
    pyramid_output: bool = False,
    in_range=None,
    mesh=None,
    use_pyramid: bool = False,
    device="cuda",
) -> BatchReport:
    """Run this shard's slides; resumable through the cursor files.

    ``compute_dtype``: ``None`` (float32, TF32 off) or ``torch.bfloat16``,
    for both engines.  ``in_range``: a pinned ``(lo, hi)`` in raw pixel
    units for every slide instead of each slide's own range (TMA cores of
    one scan normalise alike); it overrides ``outlier``.
    ``channel_name``: the channel by its OME name, resolved per slide; a
    slide without it fails alone.  ``mesh``: a
    :class:`~unmicst_tpu_torch.runtime.mesh.Mesh`; streamable slides then
    stream column-sharded over its ranks (``infer_sharded``).
    ``device``: the card unless the caller names the CPU.
    """
    from unmicst_tpu_torch.core.checkpoint import load_params_for_bundle
    from unmicst_tpu_torch.core.hp import load_model_dir
    from unmicst_tpu_torch.infer import InferenceEngine, _normalize_in_range
    from unmicst_tpu_torch.io import preprocess as pp
    from unmicst_tpu_torch.io.slides import (open_channel_source, preview_u8,
                                             read_channel,
                                             resolve_channel_names, tiff_plane)
    from unmicst_tpu_torch.io.tiff import TiffFile
    from unmicst_tpu_torch.io.tiff import imwrite as _imwrite
    from unmicst_tpu_torch.runtime.pipeline import (StreamingEngine,
                                                    _not_ported)

    if use_pyramid:
        raise _not_ported("pyramid input (use_pyramid)", "M14")
    if pyramid_output:
        raise _not_ported("pyramid output (pyramid_output)", "M14")
    if compress_output == "zstd":
        raise _not_ported("zstd output (compress_output='zstd')", "M14")
    codec = "deflate" if compress_output in (True, "deflate") else None
    if not 0 <= shard_index < num_shards:
        # an index out of range would drop some slides and run others twice
        raise ValueError(f"shard_index {shard_index} out of range for "
                         f"{num_shards} shard(s)")
    bundle = load_model_dir(model_dir, mean, std)
    if bundle.hp.n_classes < 3:
        # the sweep writes the contour and nuclei planes (classes 1, 2):
        # refuse before reading any slide
        raise ValueError(
            f"batch sweeps need a 3-class model (contours+nuclei); "
            f"{os.path.basename(model_dir)} has {bundle.hp.n_classes}")
    if in_range is not None:
        in_range = tuple(_normalize_in_range(in_range, 1)[0])
    params = load_params_for_bundle(bundle)
    kw = dict(compute_dtype=compute_dtype, tile_batch=tile_batch,
              device=device)
    engine = InferenceEngine.from_bundle(bundle, params, **kw)
    stream_engine = StreamingEngine.from_bundle(bundle, params, **kw)

    def imwrite(path, page, append=False):
        _imwrite(path, page, append=append, compression=codec)

    def write(this_out, stem, chan, contours, nuclei, preview):
        # batchUnMicst.py:570-587: ContoursPM is [map, preview]
        cfile = os.path.join(this_out, f"{stem}_ContoursPM_{chan + 1}.tif")
        imwrite(cfile, contours)
        imwrite(cfile, preview, append=True)
        imwrite(os.path.join(this_out, f"{stem}_NucleiPM_{chan + 1}.tif"),
                nuclei)

    report = BatchReport()
    t_start = time.perf_counter()
    my_done: dict = {}
    done_cache: dict = {}  # other shards' records count at start-up only
    for slide in slides[shard_index::num_shards]:
        this_out = out_dir or os.path.join(
            os.path.dirname(os.path.dirname(slide)), "prob_maps")
        os.makedirs(this_out, exist_ok=True)
        if resume and this_out not in done_cache:
            done_cache[this_out] = _load_done(this_out)
        if resume and slide in done_cache[this_out]:
            report.skipped.append(slide)
            continue
        stem = os.path.basename(slide).split(os.extsep, 1)[0]
        t_slide = time.perf_counter()
        try:
            chan = channel
            if channel_name is not None:
                # per slide: channel order may differ between files
                chan = resolve_channel_names(slide, "tif", [channel_name])[0]
            with TiffFile(slide) as tf:
                page = tf.pages[tiff_plane(tf, chan)]
                slide_px = page.height * page.width
                # the stream's exact stats need an integer histogram; other
                # dtypes take the whole engine, which rescales any dtype
                streamable = (np.dtype(np.uint16) if page.dtype == np.float32
                              else page.dtype) in (
                    np.dtype(np.uint8), np.dtype(np.uint16),
                    np.dtype(np.int16))
            sharded = mesh is not None
            if (slide_px > stream_above_px or sharded) and streamable:
                # bounded memory end to end, at any scale
                with open_channel_source(slide, "tif", chan) as src:
                    t0 = time.perf_counter()
                    if scaling_factor == 1:
                        # one histogram pass: the range and the preview max
                        lo, hi, vmax = src.stats(outlier, with_max=True)
                        net_src, stats = src, in_range or (lo, hi)
                    else:
                        net_src = pp.ResampledSource(src, scaling_factor)
                        stats, vmax = pp.pinned_to_source_units(
                            in_range, net_src), None
                    sw = dict(outlier=outlier, classes=(1, 2), stats=stats)
                    contours, nuclei = (
                        stream_engine.infer_sharded(net_src, mesh, **sw)
                        if sharded else stream_engine.infer(net_src, **sw))
                    if scaling_factor != 1:
                        shape = (src.height, src.width)
                        contours = pp.upscale_pm(contours, shape)
                        nuclei = pp.upscale_pm(nuclei, shape)
                    dt = time.perf_counter() - t0
                    preview = preview_u8(src, vmax=vmax)
                how = "streamed" + (f", {len(mesh.ranks())} ranks"
                                    if sharded else "")
            else:
                raw = read_channel(slide, "tif", chan)  # OME-plane aware
                t0 = time.perf_counter()
                # the card takes raw integers up and brings uint8 maps back
                contours, nuclei = engine.infer_slide(
                    raw, outlier=outlier, classes=(1, 2),
                    scaling_factor=scaling_factor, in_range=in_range)
                dt = time.perf_counter() - t0
                preview = pp.preview_u8_from_raw(raw)  # parity-casts float32
                how = "whole"
            write(this_out, stem, chan, contours, nuclei, preview)
            mpx = slide_px / 1e6
            report.mpx_total += mpx
            report.completed.append(slide)
            report.infer_seconds[slide] = dt
            report.seconds[slide] = time.perf_counter() - t_slide
            _record_done(my_done, done_cache, this_out, shard_index, slide)
            if verbose:
                print(f"[sweep {shard_index}/{num_shards}] {slide} ({how}): "
                      f"{mpx:.1f} Mpx, infer {dt:.2f}s, "
                      f"{report.seconds[slide]:.2f}s with read and write")
        except Exception:
            report.failed.append(slide)
            if verbose:
                print(f"[sweep] FAILED {slide}\n{traceback.format_exc()}")
    report.wall_s = time.perf_counter() - t_start
    return report


def _mesh(n: Optional[int], device):
    """``--engine sharded``'s mesh: ``n`` ranks over the visible cards in
    turn (ranks share a card when ``n`` exceeds them; default one rank
    per card), or ``n`` ranks sharing the CPU."""
    import torch

    from unmicst_tpu_torch.runtime.devices import resolve_device
    from unmicst_tpu_torch.runtime.mesh import make_mesh

    dev = resolve_device(device)
    if dev.type == "cpu":
        return make_mesh(devices=[dev] * (n or 1))
    cards = torch.cuda.device_count()
    return make_mesh(devices=[torch.device("cuda", r % cards)
                              for r in range(n or cards)])


def build_parser():
    import argparse

    p = argparse.ArgumentParser(prog="python -m unmicst_tpu_torch.batch")
    p.add_argument("imagePath", help="root containing exemplar*/ sample dirs")
    p.add_argument("--model", default="nucleiDAPI")
    p.add_argument("--modelRoot")
    p.add_argument("--outputPath", help="override per-sample prob_maps dirs")
    p.add_argument("--TMA", action="store_true", help="dearray/*.tif layout")
    p.add_argument("--channel", type=int, default=0, help="0-based channel")
    p.add_argument("--channelName", metavar="NAME",
                   help="select the channel by its OME name per slide "
                   "(takes precedence over --channel); slides without it "
                   "fail alone and the sweep continues")
    p.add_argument("--scalingFactor", type=float, default=1)
    p.add_argument("--outlier", type=float, default=-1)
    p.add_argument("--mean", type=float, default=-1)
    p.add_argument("--std", type=float, default=-1)
    p.add_argument("--shardIndex", type=int, default=0)
    p.add_argument("--numShards", type=int, default=1)
    p.add_argument("--noResume", action="store_true")
    p.add_argument("--precision", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--compressOutput", nargs="?", const="deflate",
                   default=None, choices=["deflate", "zstd"])
    p.add_argument("--usePyramid", action="store_true")
    p.add_argument("--pyramidOutput", action="store_true")
    p.add_argument("--intensityRange", metavar="LO,HI",
                   help="one rescale range (raw pixel units) for every "
                   "slide; overrides --outlier")
    p.add_argument("--engine", choices=["auto", "sharded"], default="auto",
                   help="sharded: stream every streamable slide with its "
                   "stripes column-sharded over the rank mesh")
    p.add_argument("--meshShape", type=int, metavar="N",
                   help="with --engine sharded: ranks on the column axis "
                   "(default: one per visible card; more than the cards "
                   "share them)")
    p.add_argument("--stats", action="store_true",
                   help="print one JSON line: per-slide seconds and the "
                   "kernels' launch counts")
    return p


def batch_main(argv=None, *, device="cuda") -> int:
    """``python -m unmicst_tpu_torch.batch ROOT --model M [--TMA] ...``: the
    JAX package's ``unmicst-tpu-batch`` flags.  Exits 2 when a slide
    failed.  ``device``: ``"cuda"`` (the default; no card raises) or
    ``"cpu"``, which only a caller may ask for."""
    from unmicst_tpu_torch.cli import _not_ported as _refuse
    from unmicst_tpu_torch.cli import resolve_model_dir
    from unmicst_tpu_torch.infer import PRECISIONS
    from unmicst_tpu_torch.runtime.devices import resolve_device

    args = build_parser().parse_args(argv)
    in_range = None
    if args.intensityRange:
        parts = args.intensityRange.split(",")
        try:
            if len(parts) != 2:
                raise ValueError(
                    f"expected LO,HI, got {args.intensityRange!r}")
            in_range = (float(parts[0]), float(parts[1]))
        except ValueError as e:
            raise SystemExit(f"--intensityRange: {e}")
    if args.engine == "sharded" and args.usePyramid:
        raise SystemExit(
            "--usePyramid decodes stored levels whole (the whole engine); "
            "it does not combine with --engine sharded")
    if args.usePyramid or args.pyramidOutput:
        raise _refuse("--usePyramid / --pyramidOutput", "M14")
    if args.compressOutput == "zstd":
        raise _refuse("--compressOutput zstd", "M14")
    dev = resolve_device(device)  # raises without a card
    mesh = _mesh(args.meshShape, dev) if args.engine == "sharded" else None
    slides = discover_slides(args.imagePath, tma=args.TMA)
    if not slides:
        print(f"no slides found under {args.imagePath}")
        return 1
    if args.stats:
        from unmicst_tpu_torch import kernels

        kernels.reset_launch_counts()
    report = run_sweep(
        slides, resolve_model_dir(args.model, args.modelRoot),
        args.outputPath, channel=args.channel, channel_name=args.channelName,
        scaling_factor=args.scalingFactor, outlier=args.outlier,
        mean=args.mean, std=args.std,
        compute_dtype=PRECISIONS[args.precision],
        shard_index=args.shardIndex, num_shards=args.numShards,
        resume=not args.noResume, compress_output=args.compressOutput,
        in_range=in_range, mesh=mesh, device=dev)
    print(f"[sweep] done: {len(report.completed)} completed, "
          f"{len(report.skipped)} skipped, {len(report.failed)} failed, "
          f"{report.mpx_total:.1f} Mpx in {report.wall_s:.1f}s")
    if args.stats:
        print(json.dumps({
            "completed": report.completed, "skipped": report.skipped,
            "failed": report.failed, "mpx_total": report.mpx_total,
            "wall_s": report.wall_s, "seconds": report.seconds,
            "infer_seconds": report.infer_seconds,
            "launches": kernels.launch_counts()}))
    return 2 if report.failed else 0


def deploy_folder(im_path: str, n_images: int, model_dir: str, pm_path: str,
                  pm_index: int = 1, mean: float = -1, std: float = -1, *,
                  device="cuda") -> None:
    """``UNet2D.deploy`` (``UnMicst.py:417-487``): the net on each
    ``I%05d_Img.tif`` crop, channels >= 1 zero-filled, writing the
    ``I%05d_{Im,PM}.png`` pair (the sqrt-stretched image and the
    ``pm_index`` map).  One forward per crop, softmax in the net."""
    import torch

    from unmicst_tpu_torch.core.checkpoint import load_params_for_bundle
    from unmicst_tpu_torch.core.hp import load_model_dir
    from unmicst_tpu_torch.core.unet import UNet
    from unmicst_tpu_torch.infer import _conv_precision
    from unmicst_tpu_torch.io import preprocess as pp
    from unmicst_tpu_torch.io.png import write_png
    from unmicst_tpu_torch.io.tiff import imread
    from unmicst_tpu_torch.runtime.devices import resolve_device

    dev = resolve_device(device)
    bundle = load_model_dir(model_dir, mean, std)
    hp = bundle.hp
    model = UNet(hp, bundle.variant)
    model.load_state_dict(load_params_for_bundle(bundle))
    model.to(dev).eval()
    os.makedirs(pm_path, exist_ok=True)
    for i in range(n_images):
        im = pp.im2double(imread(os.path.join(im_path, f"I{i:05d}_Img.tif")))
        x = np.zeros((1,) + im.shape + (hp.n_channels,), np.float32)
        # UnMicst.py:435-445 zero-fills channels >= 1 (no broadcast)
        x[..., 0] = ((im - bundle.mean) / bundle.std).astype(np.float32)
        with torch.inference_mode(), (_conv_precision(False)
                                      if dev.type == "cuda"
                                      else contextlib.nullcontext()):
            probs = model(torch.from_numpy(x).to(dev))[0].cpu().numpy()
        norm = (im - im.min()) / max(im.max() - im.min(), 1e-12)
        write_png(os.path.join(pm_path, f"I{i + 1:05d}_Im.png"),
                  np.uint8(255 * np.sqrt(norm)))
        write_png(os.path.join(pm_path, f"I{i + 1:05d}_PM.png"),
                  np.uint8(255 * probs[..., pm_index]))


if __name__ == "__main__":
    raise SystemExit(batch_main())
