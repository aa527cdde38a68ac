"""Streaming whole-slide inference: bounded host and device memory.

``unmicst_tpu/runtime/pipeline.py`` (``StreamingEngine``) for one source
broadcast into every net channel (:meth:`StreamingEngine.infer`) or one
source per channel, each with its own rescale range (the duo tool,
:meth:`StreamingEngine.infer_stack`).  The slide is cut into independent
overlapping stripes of ``S`` tile rows; a stripe recomputes one boundary
tile row of its predecessor, so every output row is finished by exactly
one stripe and nothing accumulates across stripes.  Per stripe:

1. the raw rows (``(S + 1) * sub + 2m`` of them, zero outside the slide)
   of every channel are read from the sources (arrays, windowed TIFF
   sources, ``(TiffFile, page)`` pairs, or the unit-scale float32 rows of
   a :class:`~unmicst_tpu_torch.io.preprocess.ResampledSource` for
   ``--scalingFactor``) into a pinned ``[C, rows, width]`` host buffer and
   uploaded on a copy stream;
2. on the card: the canvas in source units, the rescale with each
   channel's global range (or im2double alone), mean/std, the UNet and K1
   with the stripe's tile-row mask, then K2's stripe entry, which folds,
   divides by the fold of the *masked* window (the stripe's own blend
   count, not the slide's), crops the finished rows and the margin
   columns and stores ``uint8(255 * p)``;
3. the uint8 maps go back on a second copy stream into a pinned buffer,
   and stripes are drained into the output in stripe order, ``in_flight``
   stripes behind.

:meth:`StreamingEngine.infer_sharded` cuts every stripe into column bands
over a :class:`~unmicst_tpu_torch.runtime.mesh.Mesh`, the column-wise
twin of ``runtime/halo.spatial_infer``: a ``[C, rows, 2m]`` input halo
in the sources' dtype from the right-hand neighbour, and the fold tail
(sums and count) of each band added into its right-hand neighbour's head,
both through kernel K3 (``kernels.ring_shift``; the plain copy for CPU
ranks); :meth:`StreamingEngine.infer_sharded_stack` is its duo form.

Not ported yet: the int8 mode (ROADMAP M11), which raises naming it.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from unmicst_tpu_torch.core import tiler
from unmicst_tpu_torch.core.checkpoint import State
from unmicst_tpu_torch.core.hp import HParams, ModelBundle
from unmicst_tpu_torch.core.unet import UNet
from unmicst_tpu_torch.infer import (_column, _reciprocal, pick_tile_batch,
                                     weigh_tiles)
from unmicst_tpu_torch.io.tiff import TiffFile
from unmicst_tpu_torch.kernels import blend_fold_stripe, ring_shift
from unmicst_tpu_torch.runtime.devices import Device, resolve_device
from unmicst_tpu_torch.runtime.mesh import Mesh
from unmicst_tpu_torch.utils.batching import even_chunk

# im2double scale by dtype (rescale=False divides by it); float32 rows
# come only from unit-scale virtual sources (ResampledSource)
_IM2DOUBLE_SCALE = {
    np.dtype(np.uint8): 255.0,
    np.dtype(np.uint16): 65535.0,
    np.dtype(np.int16): 32767.0,
    np.dtype(np.float32): 1.0,
}
_STREAM_DTYPES = tuple(_IM2DOUBLE_SCALE)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to unmicst_tpu_torch yet (ROADMAP {item})")


def _source_dims(src) -> Tuple[int, int]:
    """(height, width) of a streaming source."""
    if hasattr(src, "read_rows"):
        return src.height, src.width
    if isinstance(src, np.ndarray):
        if src.ndim != 2:
            raise ValueError(f"raw slide must be [H, W], got {src.shape}")
        return src.shape
    tf, page = src
    return tf.pages[page].height, tf.pages[page].width


def _source_dtype(src) -> np.dtype:
    """The dtype rows arrive as, after the float32 -> uint16 parity cast."""
    if hasattr(src, "read_rows"):
        return np.dtype(src.dtype)
    dt = np.dtype(src.dtype if isinstance(src, np.ndarray)
                  else src[0].pages[src[1]].dtype)
    return np.dtype(np.uint16) if dt == np.float32 else dt


def _check_classes(classes, n_classes: int):
    if classes is None:
        return None
    classes = tuple(int(c) for c in classes)
    bad = [c for c in classes if not 0 <= c < n_classes]
    if bad:
        raise ValueError(f"class index(es) {bad} out of range for a "
                         f"{n_classes}-class model")
    return classes


def _check_dtype(dtype: np.dtype, rescale: bool) -> None:
    """``_check_rescale_dtype`` of the JAX engine (``pipeline.py:80-93``),
    one policy for every entry point."""
    if dtype not in _STREAM_DTYPES:
        raise ValueError(f"streaming takes uint8, uint16 or int16 slides "
                         f"(float32 through the uint16 parity cast) and "
                         f"unit-scale float32 virtual sources, got {dtype}")
    if not rescale and dtype == np.dtype(np.int16):
        raise ValueError("streaming with rescale=False requires uint8/uint16"
                         f" (or unit-float virtual) input, got {dtype}")


def _cast_raw(arr: np.ndarray) -> np.ndarray:
    """float32 slides truncate to uint16 first (``UnMicst1-5.py:807-808``)."""
    return arr.astype(np.uint16) if arr.dtype == np.float32 else arr


def _to_torch(rows: np.ndarray) -> torch.Tensor:
    """Host rows -> a tensor of the same bytes (uint16 travels as int16)."""
    rows = np.ascontiguousarray(rows)
    if rows.dtype == np.uint16:
        rows = rows.view(np.int16)
    return torch.from_numpy(rows)


def _raw_float(x: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    """Raw rows on the device -> float32 raw values."""
    if dtype == np.dtype(np.uint16):
        return (x.to(torch.int32) & 0xFFFF).float()
    return x.float()


def _col_mask(npc: int, c_dev: int, d: int, device) -> torch.Tensor:
    """1 for rank ``d``'s tile columns that exist (columns ``d * c_dev``
    .. ``(d + 1) * c_dev - 1`` of the slide's tile grid), 0 for the phantom
    ones; made on ``device``."""
    return (torch.arange(c_dev, device=device) + d * c_dev < npc).float()


@dataclasses.dataclass
class _StripePlan:
    height: int
    width: int
    S: int  # finished tile rows per stripe
    n_stripes: int
    grid: tiler.TileGrid
    in_rows: int  # raw input rows fed per stripe
    band_rows: int  # finished output rows per stripe (S*sub)

    def rows(self, s: int) -> Tuple[int, int]:
        """Padded-canvas rows ``[a, b)`` of output that stripe ``s``
        finishes (inside the slide's ``[m, m + height)``)."""
        m, p0 = self.grid.margin, s * self.band_rows
        return max(p0, m), min(p0 + self.band_rows, m + self.height)


class StreamingEngine:
    """Pipelined raw-slide inference: integer plane in, uint8 maps out.

    ``device``: ``None``/``"cuda"`` (the card; raises without one) or
    ``"cpu"`` (the plain kernel versions).  ``compute_dtype`` defaults to
    ``torch.bfloat16``, as in the JAX engine; ``None`` runs float32.
    """

    def __init__(self, hp: HParams, params: State, variant: str,
                 mean: float, std: float, *, compute_dtype=torch.bfloat16,
                 tile_batch: Optional[int] = None,
                 stripe_tile_rows: Optional[int] = None,
                 in_flight: int = 4, quantized: bool = False,
                 device: Device = None):
        if quantized:
            raise _not_ported("the int8 streaming mode (quantized=True)",
                              "M11")
        if in_flight < 1:
            raise ValueError(f"in_flight must be >= 1, got {in_flight}")
        self.device = resolve_device(device)
        self.hp, self.params, self.variant = hp, params, variant
        self.mean, self.std = float(mean), float(std)
        self.compute_dtype = compute_dtype
        self.tile_batch = int(tile_batch or pick_tile_batch(hp, self.device))
        self.stripe_tile_rows = stripe_tile_rows
        self.in_flight = int(in_flight)
        self._models = {}
        self._windows = {}

    @classmethod
    def from_bundle(cls, bundle: ModelBundle, params: State, **kw):
        return cls(bundle.hp, params, bundle.variant, bundle.mean,
                   bundle.std, **kw)

    def _model(self, device: torch.device) -> Tuple[UNet, torch.Tensor]:
        """The UNet and the blend window on ``device`` (built once)."""
        if device not in self._models:
            model = UNet(self.hp, self.variant, self.compute_dtype)
            model.load_state_dict(self.params)
            self._models[device] = model.to(device).eval()
            self._windows[device] = torch.from_numpy(tiler.ramp_window(
                self.hp.im_size, self.hp.margin)).to(device)
        return self._models[device], self._windows[device]

    # -- planning ------------------------------------------------------------

    def _plan(self, height: int, width: int) -> _StripePlan:
        if height <= 0 or width <= 0:
            raise ValueError(f"empty image: {height}x{width}")
        hp = self.hp
        grid = tiler.make_grid(height, width, hp.im_size, hp.margin)
        sub = grid.sub
        if self.stripe_tile_rows is not None:
            S = self.stripe_tile_rows
        else:
            # >= tile_batch tiles and >= ~1024 rows per stripe, nudged so
            # the (S+1)*npc tiles split into full tile_batch chunks
            S = max(1, self.tile_batch // max(1, grid.npc), -(-1024 // sub))
            lo = min(S, grid.npr)
            S = min(range(lo, min(S + 4, grid.npr + 1)),
                    key=lambda s: ((s + 1) * grid.npc) % self.tile_batch
                    / ((s + 1) * grid.npc))
        S = min(S, grid.npr)
        # stripes must cover every valid padded row [margin, margin+height):
        # the last tile row's window tail extends margin rows past npr*sub,
        # so ceil(npr/S) under-covers when height mod sub > sub - margin
        n_stripes = -(-(grid.margin + height) // (S * sub))
        in_rows = (S + 1) * sub + 2 * grid.margin
        return _StripePlan(height=height, width=width, S=S,
                           n_stripes=n_stripes, grid=grid, in_rows=in_rows,
                           band_rows=S * sub)

    # -- host side -------------------------------------------------------------

    @staticmethod
    def _read_rows(source, r0: int, nrows: int) -> np.ndarray:
        """Rows [r0, r0+nrows) of the raw slide, zero-padded outside."""
        if hasattr(source, "read_rows"):
            return source.read_rows(r0, nrows)
        if isinstance(source, np.ndarray):
            h, w = source.shape
            out = np.zeros((nrows, w), source.dtype)
            a, b = max(r0, 0), min(r0 + nrows, h)
            if b > a:
                out[a - r0 : b - r0] = source[a:b]
            return out
        tf, page = source
        h, w = tf.pages[page].height, tf.pages[page].width
        out = np.zeros((nrows, w), _source_dtype(source))
        a, b = max(r0, 0), min(r0 + nrows, h)
        if b > a:
            rows = _cast_raw(tf.read_region(page, a, 0, b - a, w))
            out[a - r0 : b - r0] = rows  # also to native byte order
        return out

    def global_stats(self, source, outlier: float = -1) -> Tuple[float, float]:
        """The rescale range (min, max | percentile) in raw units.  TIFF
        sources are read in row chunks through a histogram, which gives
        the exact ``np.percentile`` value for integer pixels."""
        from unmicst_tpu_torch.io.slides import _streamed_int_stats

        if hasattr(source, "stats"):
            return source.stats(outlier)
        if isinstance(source, np.ndarray):
            arr = _cast_raw(source)
            lo = float(arr.min())
            hi = (float(np.percentile(arr, outlier)) if outlier != -1
                  else float(arr.max()))
            return lo, hi
        h, w = _source_dims(source)
        return _streamed_int_stats(
            lambda r0, n: self._read_rows(source, r0, n), h, w,
            _source_dtype(source), outlier)

    def _prepare(self, sources, outlier, rescale, classes, stats, *,
                 stack: bool):
        """Check the sources (one per channel with ``stack``, else one),
        cast float32 arrays, plan the stripes and fix each channel's
        rescale range: ``(lo, hi)`` float32 arrays of one entry per
        source."""
        sources = [_cast_raw(s) if isinstance(s, np.ndarray) else s
                   for s in sources]  # once, not per stripe
        for src in sources:
            if not (isinstance(src, np.ndarray) or hasattr(src, "read_rows")
                    or (isinstance(src, tuple) and len(src) == 2
                        and isinstance(src[0], TiffFile))):
                raise TypeError(f"unsupported streaming source {type(src)}")
        height, width = _source_dims(sources[0])
        if any(_source_dims(s) != (height, width) for s in sources[1:]):
            raise ValueError("channel sources must share dimensions")
        dtypes = {_source_dtype(s) for s in sources}
        if len(dtypes) != 1:
            raise ValueError(f"channel sources disagree on dtype: "
                             f"{sorted(map(str, dtypes))}")
        dtype = dtypes.pop()
        _check_dtype(dtype, rescale)
        classes = _check_classes(classes, self.hp.n_classes)
        plan = self._plan(height, width)
        if not rescale:
            ranges = [(0.0, 1.0)] * len(sources)
        elif stats is None:
            ranges = [self.global_stats(s, outlier) for s in sources]
        elif stack:
            ranges = list(stats)
            if len(ranges) != len(sources):
                raise ValueError(
                    f"stats has {len(ranges)} ranges for {len(sources)} "
                    "channels (a short list would give channel 0's range to "
                    "every channel)")
        else:
            ranges = [stats]
        rng = tuple(np.asarray([r[i] for r in ranges], np.float32)
                    for i in (0, 1))
        return sources, dtype, classes, plan, rng

    def _check_stack(self, sources) -> list:
        if len(sources) != self.hp.n_channels:
            raise ValueError(f"model expects {self.hp.n_channels} channels, "
                             f"got {len(sources)}")
        return list(sources)

    # -- device side -----------------------------------------------------------

    def _net_input(self, x: torch.Tensor, dtype: np.dtype, rescale: bool,
                   rng) -> torch.Tensor:
        """Canvas ``[C0, rows, cols]`` (float32 source values, zero fill
        included) -> ``[C, rows, cols]`` net input: each channel's rescale
        (or im2double), mean/std, the compute dtype; ``C0 == 1``
        broadcasts over the net's channels."""
        if rescale:
            lo, hi = (_column(v, x.device) for v in rng)
            x = torch.minimum(torch.maximum(x, lo), hi)
            x = (x - lo) / torch.clamp(hi - lo, min=1e-12) * 0.983
        else:
            x = x * _reciprocal(_IM2DOUBLE_SCALE[dtype])
        x = (x - self.mean) * _reciprocal(self.std)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return x.expand(self.hp.n_channels, -1, -1)

    def _row_mask(self, plan: _StripePlan, s: int, device) -> torch.Tensor:
        """1 for the stripe's tile rows that exist (rows s*S-1 .. (s+1)*S-1
        of the slide's tile grid), 0 for the phantom ones; made on
        ``device``, so the stripe never waits for a copy from the host."""
        ids = torch.arange(plan.S + 1, device=device) + (s * plan.S - 1)
        return ((ids >= 0) & (ids < plan.grid.npr)).float()

    def _stripe(self, raw: torch.Tensor, plan: _StripePlan, s: int,
                dtype: np.dtype, rescale: bool, rng, cls,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One stripe on ``raw``'s device: source rows ``[C0, in_rows,
        width]`` -> uint8 maps ``[Kc, b - a, width]`` of its finished
        rows."""
        grid, dev = plan.grid, raw.device
        m, sub = grid.margin, grid.sub
        model, window = self._model(dev)
        canvas = torch.zeros((raw.shape[0], plan.in_rows, grid.padded_width),
                             dtype=torch.float32, device=dev)
        canvas[:, :, m : m + plan.width] = _raw_float(raw, dtype)
        band_grid = tiler.make_grid((plan.S + 1) * sub, plan.width,
                                    self.hp.im_size, self.hp.margin)
        rmask = self._row_mask(plan, s, dev)
        weighted = weigh_tiles(model, self._net_input(canvas, dtype, rescale,
                                                      rng),
                               band_grid, window,
                               rmask.repeat_interleave(grid.npc),
                               even_chunk(band_grid.num_tiles,
                                          self.tile_batch))
        a, b = plan.rows(s)
        p0 = s * plan.band_rows
        return blend_fold_stripe(weighted, window, band_grid,
                                 (sub + a - p0, b - a), (m, plan.width),
                                 row_mask=rmask, classes=cls, out=out)

    # -- public API ----------------------------------------------------------

    def infer(self, source: Union[np.ndarray, Tuple], outlier: float = -1,
              rescale: bool = True, out: Optional[np.ndarray] = None,
              classes=None,
              stats: Optional[Tuple[float, float]] = None) -> np.ndarray:
        """Stream the slide; returns uint8 ``[K, H, W]`` (or fills ``out``).

        ``classes``: class indexes to emit, in that order.  ``stats``:
        a precomputed (lo, hi) in source units (skips the stats pass)."""
        return self._stream([source], outlier, rescale, out, classes, stats,
                            stack=False)

    def infer_stack(self, sources, outlier: float = -1, rescale: bool = True,
                    out: Optional[np.ndarray] = None, classes=None,
                    stats=None) -> np.ndarray:
        """Multi-channel (duo) streaming: one source per net channel, each
        rescaled with its own global range (``UnMicst2.py:784-788``).
        ``stats``: one precomputed (lo, hi) per channel, in source units.
        Otherwise :meth:`infer`."""
        return self._stream(self._check_stack(sources), outlier, rescale,
                            out, classes, stats, stack=True)

    def _stream(self, sources, outlier, rescale, out, classes, stats, *,
                stack: bool) -> np.ndarray:
        sources, dtype, classes, plan, rng = self._prepare(
            sources, outlier, rescale, classes, stats, stack=stack)
        cls = list(classes) if classes is not None else list(
            range(self.hp.n_classes))
        m = plan.grid.margin
        if out is None:
            out = np.empty((len(cls), plan.height, plan.width), np.uint8)

        def raw_r0(s):
            return (s * plan.S - 1) * plan.grid.sub - m

        if self.device.type != "cuda":
            for s in range(plan.n_stripes):
                rows = _to_torch(np.stack([
                    self._read_rows(src, raw_r0(s), plan.in_rows)
                    for src in sources]))
                a, b = plan.rows(s)
                out[:, a - m : b - m] = self._stripe(
                    rows, plan, s, dtype, rescale, rng, cls).numpy()
            return out
        return self._infer_cuda(sources, plan, dtype, rescale, rng, cls, out,
                                raw_r0)

    def _infer_cuda(self, sources, plan, dtype, rescale, rng, cls, out,
                    raw_r0) -> np.ndarray:
        """The stripe loop on the card: pinned ``[C, rows, width]`` host
        buffers in the sources' dtype, an upload and a download stream,
        ``in_flight`` stripes in flight, drained in stripe order."""
        dev, m = self.device, plan.grid.margin
        k = min(self.in_flight, plan.n_stripes)
        tdt = _to_torch(np.zeros(1, dtype)).dtype
        n_out = len(cls) * plan.band_rows * plan.width
        with torch.cuda.device(dev):
            compute = torch.cuda.current_stream()
            up, down = torch.cuda.Stream(), torch.cuda.Stream()
            host_in = [torch.empty((len(sources), plan.in_rows, plan.width),
                                   dtype=tdt, pin_memory=True)
                       for _ in range(k)]
            dev_in = [torch.empty_like(h, device=dev) for h in host_in]
            host_out = [torch.empty(n_out, dtype=torch.uint8, pin_memory=True)
                        for _ in range(k)]
            dev_out = [torch.empty(n_out, dtype=torch.uint8, device=dev)
                       for _ in range(k)]
            done = [torch.cuda.Event() for _ in range(k)]
            pending = collections.deque()

            def drain():
                s, slot = pending.popleft()
                a, b = plan.rows(s)
                done[slot].synchronize()
                n = len(cls) * (b - a) * plan.width
                out[:, a - m : b - m] = host_out[slot][:n].numpy().reshape(
                    len(cls), b - a, plan.width)

            for s in range(plan.n_stripes):
                slot = s % k
                if len(pending) == k:
                    drain()  # frees this slot's buffers
                for c, src in enumerate(sources):
                    host_in[slot][c].copy_(_to_torch(self._read_rows(
                        src, raw_r0(s), plan.in_rows)))
                with torch.cuda.stream(up):
                    dev_in[slot].copy_(host_in[slot], non_blocking=True)
                compute.wait_stream(up)
                a, b = plan.rows(s)
                n = len(cls) * (b - a) * plan.width
                self._stripe(dev_in[slot], plan, s, dtype, rescale, rng, cls,
                             out=dev_out[slot][:n].view(len(cls), b - a,
                                                        plan.width))
                down.wait_stream(compute)
                with torch.cuda.stream(down):
                    host_out[slot][:n].copy_(dev_out[slot][:n],
                                             non_blocking=True)
                    done[slot].record()
                pending.append((s, slot))
            while pending:
                drain()
        return out

    # -- column-sharded streaming ---------------------------------------------

    def infer_sharded(self, source, mesh: Mesh, axis: str = "data",
                      outlier: float = -1, rescale: bool = True,
                      out: Optional[np.ndarray] = None, classes=None,
                      stats: Optional[Tuple[float, float]] = None
                      ) -> np.ndarray:
        """Stream the slide with each stripe column-sharded over ``mesh``'s
        ranks; returns uint8 ``[K, H, W]`` like :meth:`infer`.

        Each rank takes ``ceil(npc / n)`` tile columns (phantom columns
        masked); its input halo is the first ``2m`` source columns of the
        right-hand neighbour (the last rank's is the canvas tail), and the
        fold tail of its last ``2m`` columns, sums and count, is added into
        the right-hand neighbour's head.  Both hops are kernel K3 on a
        card (the plain copy on the CPU)."""
        return self._sharded([source], mesh, axis, outlier, rescale, out,
                             classes, stats, stack=False)

    def infer_sharded_stack(self, sources, mesh: Mesh, axis: str = "data",
                            outlier: float = -1, rescale: bool = True,
                            out: Optional[np.ndarray] = None, classes=None,
                            stats=None) -> np.ndarray:
        """Multi-channel (duo) column-sharded streaming: per-channel global
        ranges (``UnMicst2.py:784-788``), ``[C, rows, 2m]`` input halos;
        otherwise :meth:`infer_sharded`.  ``stats``: one (lo, hi) per
        channel, in source units, like :meth:`infer_stack`."""
        return self._sharded(self._check_stack(sources), mesh, axis, outlier,
                             rescale, out, classes, stats, stack=True)

    def _sharded(self, sources, mesh, axis, outlier, rescale, out, classes,
                 stats, *, stack: bool) -> np.ndarray:
        ranks = mesh.ranks(axis)
        sources, dtype, classes, plan, rng = self._prepare(
            sources, outlier, rescale, classes, stats, stack=stack)
        cls = list(classes) if classes is not None else list(
            range(self.hp.n_classes))
        grid = plan.grid
        m, sub, two_m, npc = grid.margin, grid.sub, 2 * grid.margin, grid.npc
        n_dev = len(ranks)
        c_dev = -(-npc // n_dev)  # tile columns per rank
        cw = c_dev * sub  # canvas columns per rank
        body_w = n_dev * cw
        dev_grid = tiler.make_grid((plan.S + 1) * sub, cw, self.hp.im_size,
                                   self.hp.margin)
        cmasks = [_col_mask(npc, c_dev, d, dev) for d, dev in enumerate(ranks)]
        if out is None:
            out = np.empty((len(cls), plan.height, plan.width), np.uint8)
        for s in range(plan.n_stripes):
            raw = np.zeros((len(sources), plan.in_rows, body_w + two_m), dtype)
            for c, src in enumerate(sources):
                raw[c, :, m : m + plan.width] = self._read_rows(
                    src, (s * plan.S - 1) * sub - m, plan.in_rows)
            raw = _to_torch(raw)
            blocks = [raw[:, :, d * cw : (d + 1) * cw].contiguous().to(dev)
                      for d, dev in enumerate(ranks)]
            # input halo in the sources' dtype: the right-hand neighbour's
            # first 2m columns; the last rank takes the canvas tail
            halos = ring_shift([b[:, :, :two_m].contiguous() for b in blocks],
                               -1, kind="input")
            halos[-1] = raw[:, :, body_w:].contiguous().to(ranks[-1])
            a, b = plan.rows(s)
            rows = (sub + a - s * plan.band_rows, b - a)
            weighted, tails = [], []
            for d, dev in enumerate(ranks):
                model, window = self._model(dev)
                x = _raw_float(torch.cat([blocks[d], halos[d]], 2), dtype)
                rmask = self._row_mask(plan, s, dev)
                tile_mask = (rmask[:, None] * cmasks[d][None, :]).reshape(-1)
                w = weigh_tiles(model, self._net_input(x, dtype, rescale,
                                                       rng),
                                dev_grid, window, tile_mask,
                                even_chunk(dev_grid.num_tiles,
                                           self.tile_batch))
                weighted.append((w, rmask))
                # the fold tail (sums + count) of the last 2m columns
                tails.append(blend_fold_stripe(
                    w, window, dev_grid, rows, (cw, two_m), row_mask=rmask,
                    col_mask=cmasks[d], classes=cls, mode="raw"))
            recv = ring_shift(tails, 1, kind="output")
            for d, dev in enumerate(ranks):
                # this rank's valid canvas columns, local: [lo, hi)
                end = cw + (two_m if d == n_dev - 1 else 0)
                lo = max(0, m - d * cw)
                hi = min(end, m + plan.width - d * cw)
                if hi <= lo:
                    continue  # a band of phantom columns only
                w, rmask = weighted[d]
                _, window = self._model(dev)
                maps = blend_fold_stripe(
                    w, window, dev_grid, rows, (lo, hi - lo), row_mask=rmask,
                    col_mask=cmasks[d], classes=cls,
                    addend=recv[d] if d > 0 else None)
                g0 = d * cw + lo - m  # first output column
                out[:, a - m : b - m, g0 : g0 + hi - lo] = maps.cpu().numpy()
        return out
