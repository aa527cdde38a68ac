"""Whole-slide tiled inference on the GPU — the ``singleImageInference``
successor, ported from ``unmicst_tpu/infer.py``.

One slide runs as (``infer.py:520-751,942-998`` of the JAX package):

1. the raw plane (or the duo tool's channel planes) goes to the device as
   8/16-bit integers; im2double, the ``--scalingFactor`` resize
   (``core/resize_dev.py``), the min/max (or outlier-percentile) rescale
   of each channel to [0, 0.983] or a pinned range, the zero-padded
   canvas and the mean/std normalisation run there;
2. the canvas is cut into ``imSize`` tiles at stride ``imSize - 2*margin``
   (a strided view), which the UNet runs in ``tile_batch`` chunks, all
   classes in one pass, returning logits;
3. kernel K1 turns each chunk's logits into ``softmax x window x mask``
   (the chunk padding's phantom tiles get mask 0);
4. kernel K2 gathers the overlap-add, the blend count, divides, crops the
   margin, keeps the requested classes and stores ``uint8(255 * p)``;
5. at a scale other than 1 the uint8 maps are resized back to the raw size
   and quantised again (``UnMicst1-5.py:848-854``).

``quantized=True`` is the int8 mode (``core/quant.py``): the plain conv
sites run ``quant_conv`` with a QuantState calibrated lazily on the first
input, which then serves the engine's lifetime (``infer.py:160-209,
370-472``).

Only the uint8 maps come back to the host.  Accumulation is float32 (the
reference accumulates in float16, ``PartitionOfImage.py:86-90``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch

from unmicst_tpu_torch.core import tiler
from unmicst_tpu_torch.core.checkpoint import State
from unmicst_tpu_torch.core.hp import HParams, ModelBundle
from unmicst_tpu_torch.core.resize_dev import ResizePlan
from unmicst_tpu_torch.core import quant as _q
from unmicst_tpu_torch.core import s2d as _s2d
from unmicst_tpu_torch.core.unet import IM2COL_BUDGET, UNet
from unmicst_tpu_torch.kernels import (blend_fold_epilogue, check_trim,
                                       softmax_blend)
from unmicst_tpu_torch.runtime import graphs as _graphs_mod
from unmicst_tpu_torch.runtime.devices import Device, resolve_device
from unmicst_tpu_torch.utils.batching import chunks

DEFAULT_TILE_BATCH = 256

# --precision -> UNet compute dtype (None = float32).  On the GPU
# "float32" and "highest" both run full float32 with TF32 off; "int8" is
# the bfloat16 mode with its plain conv sites quantized (the JAX CLI's
# precision_mode, cli.py:251-253)
PRECISIONS = {"float32": None, "highest": None, "bfloat16": torch.bfloat16,
              "int8": torch.bfloat16}

_IM2DOUBLE = {np.dtype(np.uint8): 255.0, np.dtype(np.uint16): 65535.0}


def _reciprocal(c: float) -> float:
    """``1 / c`` rounded to float32.  XLA compiles the JAX engine's
    division by a constant (the im2double scale, the model's std) into a
    multiply by this reciprocal.  The port does the same, so its rescaled
    plane agrees with the JAX engine's bit for bit.  That matters in the
    bfloat16 mode, where one float32 ulp can move a pixel of the net input
    to the next bfloat16 value."""
    return float(np.float32(1.0) / np.float32(c))


def _column(values, device) -> torch.Tensor:
    """float32 ``[C, 1, 1]`` of ``values``, made on ``device``: filled
    there, so the caller never waits for a copy from the host."""
    return torch.cat([torch.full((1, 1, 1), float(v), device=device)
                      for v in values])


def _normalize_in_range(in_range, n: int) -> np.ndarray:
    """A pinned rescale range -> float64 [n, 2] raw-unit array; one
    ``(lo, hi)`` pair broadcasts over ``n`` channels; every pair must be
    finite with ``lo < hi`` (``infer.py:55-78``)."""
    arr = np.asarray(in_range, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr[None]
    if arr.shape == (1, 2) and n > 1:
        arr = np.repeat(arr, n, axis=0)
    if arr.shape != (n, 2):
        raise ValueError(
            f"in_range must be one (lo, hi) pair or {n} pairs, got "
            f"shape {arr.shape}"
        )
    if not np.all(np.isfinite(arr)) or not np.all(arr[:, 0] < arr[:, 1]):
        raise ValueError(
            f"in_range pairs must be finite with lo < hi, got {arr.tolist()}"
        )
    return arr


def percentile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q)`` (method ``linear``) over all of ``x``,
    with JAX's float32 arithmetic for the position and the weights.
    Uses two ``kthvalue`` selections: ``torch.quantile`` refuses inputs
    above 2**24 elements."""
    if not 0 <= q <= 100:
        raise ValueError(f"outlier percentile {q} not in [0, 100] (or -1)")
    return _q.percentile_rows(x.reshape(1, -1), q)[0]


def tile_bytes(hp: HParams, quantized: bool = False) -> int:
    """Upper estimate of the device bytes one tile adds to a forward: six
    float32 tensors of every level's in + out width at that level's
    resolution (activations are float32 in every precision mode).  In the
    int8 mode a site adds its quantized input (int8, padded) and its
    int32 sums: two more bytes per input and four per output channel.
    ``chip_smoke.py`` holds it against the measured growth of peak memory
    per tile."""
    w, p = hp.n_out_x, hp.im_size
    per_level = sum(
        (w[i + 1] + w[i]) * (p >> i) ** 2 for i in range(hp.n_layers + 1)
    )
    if quantized:
        return (6 * 4 + 6) * per_level
    return 6 * per_level * 4


def pick_tile_batch(hp: HParams, device: torch.device,
                    quantized: bool = False) -> int:
    """256 tiles per forward, fewer when 40% of the card's free memory
    cannot hold that chunk (less, in the int8 mode, one im2col buffer of
    ``IM2COL_BUDGET`` bytes)."""
    if device.type != "cuda":
        return DEFAULT_TILE_BATCH
    free, _ = torch.cuda.mem_get_info(device)
    room = int(0.4 * free) - (IM2COL_BUDGET if quantized else 0)
    return max(1, min(DEFAULT_TILE_BATCH,
                      room // tile_bytes(hp, quantized)))


class _FlagGuard:
    """The process-wide cuDNN and matmul flags, shared by the threads that
    run device work.  The first holder saves the flags and sets them; later
    holders that want the same setting (TF32, autotuning) join it, one
    that wants another waits until the last holder has left and restored
    them.  A thread that nests a different setting inside its own raises
    instead of waiting for itself."""

    def __init__(self):
        self._cond = threading.Condition()
        self._setting: Optional[tuple] = None
        self._holders = {}  # thread id -> depth
        self._undo = None

    @contextlib.contextmanager
    def hold(self, tf32: bool, autotune: bool = True):
        me = threading.get_ident()
        setting = (tf32, autotune)
        with self._cond:
            if self._holders.get(me) and self._setting != setting:
                raise RuntimeError(
                    "nested engine work with another TF32 or autotuning "
                    "setting")
            while self._holders and self._setting != setting:
                self._cond.wait()
            if not self._holders:
                self._undo = self._set(tf32, autotune)
                self._setting = setting
            self._holders[me] = self._holders.get(me, 0) + 1
        try:
            yield
        finally:
            with self._cond:
                self._holders[me] -= 1
                if not self._holders[me]:
                    del self._holders[me]
                if not self._holders:
                    self._undo()
                    self._setting = None
                    self._cond.notify_all()

    @staticmethod
    def _set(tf32: bool, autotune: bool):
        """Set the flags; returns the function that restores them."""
        matmul = torch.backends.cuda.matmul
        saved = matmul.allow_tf32
        matmul.allow_tf32 = tf32
        scope = torch.backends.cudnn.flags(enabled=True, benchmark=autotune,
                                           deterministic=True,
                                           allow_tf32=tf32)
        scope.__enter__()

        def undo():
            scope.__exit__(None, None, None)
            matmul.allow_tf32 = saved

        return undo


_FLAGS = _FlagGuard()


def _conv_precision(tf32: bool, autotune: bool = True):
    """cuDNN and matmul TF32 set for the engine's work only, and restored
    after.  The float32 modes run with TF32 off (cuDNN convolutions default
    to TF32; the JAX float32 modes are 3-pass or full f32, ``cli.py:237-
    254``, ``unet.py:115-134``).  The bfloat16 mode convolves float32
    tensors that hold bf16 values, which TF32 represents exactly, so it
    lets cuDNN use the TF32 tensor cores.  Every chunk has the same shape,
    so cuDNN benchmarks its algorithms once, among its deterministic ones:
    the same input gives the same maps on every call (a nondeterministic
    choice can move a float32 map by a level between two calls of one
    engine, and a server's repeated requests must answer alike).  The
    flags are global to the process: overlapping calls from several
    threads share them through :class:`_FlagGuard`, so no call runs with
    another's setting.

    ``autotune=False`` (the int8 mode and its calibration) takes cuDNN's
    heuristic choice instead of timing the algorithms.  Which algorithm a
    timing run picks depends on what else loads the card, and in the int8
    mode a float ulp that moves an activation across a rounding edge moves
    its neighbourhood by a whole int8 step: the calibration's scales and
    the maps would change from run to run with the card's load.  PyTorch
    keeps a thread's chosen cuDNN plans keyed by the convolution and these
    flags, not by autotuning: a thread that autotuned the same convolution
    earlier reuses that plan."""
    return _FLAGS.hold(tf32, autotune)


def weigh_tiles(model: UNet, canvas: torch.Tensor, grid: tiler.TileGrid,
                window: torch.Tensor, mask: torch.Tensor, tile_batch: int,
                out: Optional[torch.Tensor] = None,
                quant: Optional[_q.QuantState] = None,
                packed: Optional[_s2d.Packed] = None,
                _graphs: bool = True) -> torch.Tensor:
    """The UNet and K1 over every tile of a canvas: ``[T, K, P, P]``
    float32 ``softmax(logits) * window * mask[t]``, in row-major tile order.

    ``canvas``: ``[C, H', W']`` net input (after mean/std, in the model's
    compute dtype) on the model's device, cut into ``grid``'s tiles (a
    strided view).  Every forward runs exactly ``tile_batch`` tiles: the
    last chunk is padded with zero tiles, so every forward has one shape.
    Callers pick the chunk (capped at the tile count, or split evenly).
    ``mask``: ``[T]`` float32 per-tile factor (0 drops a phantom tile from
    the blend).  ``out``: optional contiguous ``[T, K, P, P]`` destination.
    ``quant``: the int8 mode's QuantState on the canvas's device.
    ``packed``: the space-to-depth weights (``core/s2d.py``) of ``model``,
    whose forward then runs level 0 packed.

    On a card, from the second call of a shape on ``model`` on, the
    forward is a CUDA graph of that shape (``runtime/graphs.py``),
    captured at that call's start and replayed for every chunk; each
    chunk's tiles are copied into the graph's static input and K1 reads
    its static logits.  The first call of a shape and the CPU run
    eagerly.  ``_graphs=False`` runs the card eagerly always: callers
    whose model lives for one call, and the chip smoke, which holds the
    two against each other.
    """
    hp = model.hp
    device = canvas.device
    n_ch, patch = canvas.shape[0], grid.patch
    # [npr, npc, C, P, P] strided view of the canvas, no copy
    tiles = tiler.unfold(canvas.permute(1, 2, 0), grid).permute(0, 1, 4, 2, 3)
    n_tiles, npc = grid.num_tiles, grid.npc
    if out is None:
        out = torch.empty((n_tiles, hp.n_classes, patch, patch),
                          dtype=torch.float32, device=device)

    def forward(x, q):
        if packed is not None:
            return _s2d.forward_nchw(model, packed, x)
        return model.forward_nchw(x, return_logits=True, quant=q)

    on_card = device.type == "cuda"
    flags = (_conv_precision(model.compute_dtype is not None,
                             autotune=quant is None)
             if on_card else contextlib.nullcontext())
    with torch.inference_mode(), flags:
        graph = None
        shape = (tile_batch, n_ch, patch, patch)
        if on_card and _graphs:
            graph = _graphs_mod.graphs_for(model, device).get(
                _graphs_mod.graph_key(model, device, tile_batch, n_ch, patch,
                                      canvas.dtype, packed, quant),
                forward, shape, canvas.dtype, quant, keep=(packed,))
        staging = (graph.staging if graph else
                   torch.zeros(shape, dtype=canvas.dtype, device=device))
        for t0, t1 in chunks(n_tiles, tile_batch):
            real = t1 - t0
            with graph.card.turn() if graph else contextlib.nullcontext():
                if real < tile_batch:
                    staging[real:].zero_()  # phantom tiles of the last chunk
                # copy the chunk's tiles row segment by row segment
                t = t0
                while t < t1:
                    i, j = divmod(t, npc)
                    n = min(npc - j, t1 - t)
                    staging[t - t0 : t - t0 + n].copy_(tiles[i, j : j + n])
                    t += n
                logits = (graph.replay(quant) if graph
                          else forward(staging, quant))
                softmax_blend(logits[:real], window, mask[t0:t1],
                              out=out[t0:t1])
    return out


class InferenceEngine:
    """Tiled whole-slide inference for one loaded model.

    ``device``: ``None`` or ``"cuda"`` runs on the card (and raises when
    there is none); ``"cpu"`` runs the same path with the kernels' plain
    versions.  ``compute_dtype``: ``None`` (float32, TF32 off) or
    ``torch.bfloat16``.  ``tile_batch``: tiles per forward (default from
    the card's free memory, at most 256).

    ``quantized``: the int8 mode (``core/quant.py``).  The first call
    calibrates from its own input (``calibration_percentile``,
    ``quant_bias_correct``) and that QuantState, ``_quant``, serves every
    later call; the glue around the int8 sites runs in ``compute_dtype``.

    ``s2d``: run level 0 space-to-depth packed (``core/s2d.py``): the same
    maps, summed in another order (``unmicst_tpu/infer.py:163-184``).  It
    does not combine with ``quantized``, whose sites are those of the
    standard layout.
    """

    def __init__(self, hp: HParams, params: State, variant: str,
                 mean: float, std: float, *, compute_dtype=None,
                 tile_batch: Optional[int] = None, quantized: bool = False,
                 calibration_percentile: float = 99.99,
                 quant_bias_correct: bool = True, s2d: bool = False,
                 device: Device = None):
        if s2d and quantized:
            raise ValueError(
                "s2d and int8 quantization cannot combine (the int8 site "
                "calibration is keyed to the standard layout)")
        self.device = resolve_device(device)
        self.hp, self.variant = hp, variant
        self.mean, self.std = float(mean), float(std)
        self.compute_dtype = compute_dtype
        self.model = UNet(hp, variant, compute_dtype)
        self.model.load_state_dict(params)
        self.model.to(self.device).eval()
        self.s2d = bool(s2d)
        self._packed = (_s2d.refold_params(self.model).to(self.device)
                        if self.s2d else None)
        self.quantized = bool(quantized)
        self.calibration_percentile = float(calibration_percentile)
        self.quant_bias_correct = bool(quant_bias_correct)
        self._params = params if quantized else None
        self._quant: Optional[_q.QuantState] = None
        self._quant_devs = {}  # _q.cached_on's cache
        self.tile_batch = int(tile_batch or pick_tile_batch(
            hp, self.device, self.quantized))
        self.window = torch.from_numpy(
            tiler.ramp_window(hp.im_size, hp.margin)
        ).to(self.device)
        self._plans = {}  # _resize_plan's cache
        self._plans_lock = threading.Lock()

    @classmethod
    def from_bundle(cls, bundle: ModelBundle, params: State, **kw):
        return cls(bundle.hp, params, bundle.variant, bundle.mean,
                   bundle.std, **kw)

    def _check_classes(self, classes):
        if classes is None:
            return None
        classes = tuple(int(c) for c in classes)
        bad = [c for c in classes if not 0 <= c < self.hp.n_classes]
        if bad:
            raise ValueError(
                f"class index(es) {bad} out of range for a "
                f"{self.hp.n_classes}-class model"
            )
        return classes

    # -- int8 calibration ------------------------------------------------------

    def _calibrate(self, tiles: np.ndarray) -> _q.QuantState:
        """The engine's QuantState from sample tiles, on the first call
        only."""
        if self._quant is None:
            self._quant = _q.calibrate(
                self._params, tiles, self.hp, self.variant,
                percentile=self.calibration_percentile,
                bias_correct=self.quant_bias_correct, device=self.device)
        return self._quant

    def _quant_for_normalized(self, image: np.ndarray) -> None:
        """Calibrate the host float path (:meth:`infer`) from the
        net-input image itself, on first use."""
        if self.quantized and self._quant is None:
            self._calibrate(_q.sample_tiles(np.asarray(image), self.hp,
                                            self.mean, self.std))

    def _quant_for_raw(self, raw: np.ndarray, outlier, rescale: bool,
                       scaling_factor: float = 1.0, in_range=None) -> None:
        """Calibrate the raw-slide paths on first use, from windows
        preprocessed as the slide is (``infer.py:399-472``).
        At a scale other than 1 the windows come from eight resized row
        bands spread over the scaled plane (``io/preprocess.resize_rows``,
        already im2double'd, so a pinned range converts to unit scale)."""
        if not self.quantized or self._quant is not None:
            return
        scale = _IM2DOUBLE.get(np.dtype(raw.dtype))
        if scaling_factor == 1.0:
            self._calibrate(_q.sample_tiles_raw(
                raw, self.hp, self.mean, self.std, scale=scale,
                outlier=outlier, rescale=rescale, in_range=in_range))
            return
        from unmicst_tpu_torch.io.preprocess import resize_rows

        planes = raw if raw.ndim == 3 else raw[None]
        h, w = planes.shape[-2:]
        sh = int(float(h) * float(scaling_factor))
        sw = int(float(w) * float(scaling_factor))
        s_tile, grid = self.hp.im_size, 8
        # deduplicated: a short slide collapses to one band
        starts = sorted({
            0 if sh <= s_tile else min(gi * (sh - s_tile) // max(grid - 1, 1),
                                       sh - s_tile)
            for gi in range(grid)})
        bands = np.stack([
            np.concatenate([
                resize_rows(lambda a, b, _p=plane: _p[a:b], (h, w), (sh, sw),
                            r0, min(s_tile, sh))
                for r0 in starts], axis=0).astype(np.float32)
            for plane in planes])
        ir = None
        if in_range is not None:
            ir = np.asarray(in_range, np.float64).reshape(-1, 2)
            if scale is not None:
                ir = ir / scale
        self._calibrate(_q.sample_tiles_raw(
            bands, self.hp, self.mean, self.std, scale=None, outlier=outlier,
            rescale=rescale, in_range=ir))

    # -- the device pipeline -------------------------------------------------

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """``(x - mean) / std`` (as the JAX engine compiles it), in the
        compute dtype: the net input of a canvas."""
        x = (x - self.mean) * _reciprocal(self.std)
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def _maps(self, planes: torch.Tensor, classes, quantize: bool,
              trim=None):
        """``planes``: [C0, H, W] float32 on the device, the net input
        before mean/std (C0 == 1 broadcasts into every net channel).
        Returns ``[Kc, H, W]`` uint8 (``quantize``) or float32 maps, or
        only their ``trim`` window (K2 writes just that); the int8 mode
        runs with the QuantState its caller calibrated."""
        hp = self.hp
        _, height, width = planes.shape
        grid = tiler.make_grid(height, width, hp.im_size, hp.margin)
        m = grid.margin
        canvas = torch.zeros((hp.n_channels, grid.padded_height,
                              grid.padded_width),
                             dtype=torch.float32, device=self.device)
        canvas[:, m : m + height, m : m + width] = planes
        mask = torch.ones(grid.num_tiles, dtype=torch.float32,
                          device=self.device)
        weighted = weigh_tiles(self.model, self.normalize(canvas), grid,
                               self.window, mask,
                               min(self.tile_batch, grid.num_tiles),
                               quant=_q.cached_on(self._quant_devs,
                                                  self._quant, self.device),
                               packed=self._packed)
        return blend_fold_epilogue(weighted, self.window, grid, classes,
                                   quantize, trim)

    @staticmethod
    def _host_tensor(raw: np.ndarray) -> torch.Tensor:
        """A host plane as the tensor that goes to the card: integers in
        their own width (uint16 as its int16 bit view, torch's uint16
        support being partial), anything else as float32."""
        a = np.ascontiguousarray(raw)
        if a.dtype == np.uint16:
            return torch.from_numpy(a.view(np.int16))
        if a.dtype in (np.uint8, np.int8, np.int16, np.int32):
            return torch.from_numpy(a)
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    @staticmethod
    def _widen(x: torch.Tensor, dtype) -> torch.Tensor:
        """A device tensor of :meth:`_host_tensor` -> float32 values of the
        raw ``dtype`` (uint16 widened and masked on the card)."""
        if np.dtype(dtype) == np.uint16:
            x = x.to(torch.int32) & 0xFFFF
        return x.to(torch.float32)

    def _upload(self, raw: np.ndarray) -> torch.Tensor:
        """Host plane -> float32 on the device."""
        return self._widen(self._host_tensor(raw).to(self.device), raw.dtype)

    def _resize_plan(self, src: tuple, dst: tuple) -> ResizePlan:
        """The resize between two shapes, built once per engine: its
        indices live on the card, so a repeated pan uploads nothing."""
        with self._plans_lock:
            plan = self._plans.get((src, dst))
            if plan is None:
                if len(self._plans) >= 64:
                    self._plans.pop(next(iter(self._plans)))
                plan = self._plans[src, dst] = ResizePlan(src, dst,
                                                          self.device)
        return plan

    # -- public API ----------------------------------------------------------

    def infer(self, image: np.ndarray,
              channel_mode: str = "broadcast") -> np.ndarray:
        """Float net input ``[H, W]`` (broadcast) or ``[C, H, W]`` (stack)
        -> ``[K, H, W]`` float32 probability maps (``infer.py:504-516``)."""
        img = np.asarray(image, np.float32)
        if img.ndim == 2:
            img = img[None]
        if img.ndim != 3:
            raise ValueError("image must be [H, W] or [C, H, W]")
        if channel_mode == "broadcast" and img.shape[0] != 1:
            raise ValueError("broadcast mode expects a single plane")
        if channel_mode == "stack" and img.shape[0] != self.hp.n_channels:
            raise ValueError(
                f"model expects {self.hp.n_channels} channels, got "
                f"{img.shape[0]}"
            )
        self._quant_for_normalized(image)
        planes = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        return self._maps(planes, None, quantize=False).cpu().numpy()

    def infer_slide(self, raw: np.ndarray, outlier: float = -1,
                    rescale: bool = True, classes=None,
                    scaling_factor: float = 1.0,
                    in_range=None) -> np.ndarray:
        """Raw single-channel slide -> uint8 ``[K, H, W]`` maps
        (``infer.py:696-751``).

        ``outlier``: percentile for the rescale's upper limit (-1: max).
        ``rescale=False``: the v2-solo quirk, im2double only.
        ``classes``: class indexes to return, in that order.
        ``scaling_factor``: the net sees the plane resized to
        ``(int(H * sf), int(W * sf))`` and its maps come back to ``H x W``
        through the reference's double quantisation.
        ``in_range``: pinned ``(lo, hi)`` rescale range in raw units (after
        the float32 -> uint16 parity cast); overrides ``outlier``.  It
        applies to the resized plane, as the derived range does.
        """
        if raw.ndim != 2:
            raise ValueError(f"raw slide must be [H, W], got {raw.shape}")
        return self._slide([raw], outlier, rescale, classes, scaling_factor,
                           in_range)

    def infer_slide_stack(self, raws, outlier: float = -1,
                          rescale: bool = True, classes=None,
                          scaling_factor: float = 1.0,
                          in_range=None) -> np.ndarray:
        """Raw channel planes (``hp.n_channels`` of them, one dtype) ->
        uint8 ``[K, H, W]`` maps, each channel rescaled with its own range
        (the duo tool, ``UnMicst2.py:760-788``; ``infer.py:942-998``).
        ``in_range``: one ``(lo, hi)`` pair for every channel, or one pair
        per channel.  Otherwise :meth:`infer_slide`."""
        planes = [np.asarray(r) for r in raws]
        if len(planes) != self.hp.n_channels:
            raise ValueError(
                f"model expects {self.hp.n_channels} channels, got "
                f"{len(planes)}"
            )
        dtypes = {np.dtype(np.uint16) if p.dtype == np.float32 else p.dtype
                  for p in planes}
        if len(dtypes) != 1:
            # stacking would promote the narrow channel and im2double it
            # by the wrong constant
            raise ValueError(
                f"channel planes disagree on dtype: {sorted(map(str, dtypes))}"
            )
        if any(p.ndim != 2 or p.shape != planes[0].shape for p in planes):
            raise ValueError("channel planes must be [H, W] of one shape, got "
                             f"{[p.shape for p in planes]}")
        return self._slide(planes, outlier, rescale, classes, scaling_factor,
                           in_range)

    def _slide(self, planes, outlier, rescale, classes, scaling_factor,
               in_range) -> np.ndarray:
        """``[C0]`` raw host planes -> uint8 maps (:meth:`_run_slide`).
        ``C0 == 1`` broadcasts into every channel."""
        # parity cast (UnMicst1-5.py:807-808)
        planes = [p.astype(np.uint16) if p.dtype == np.float32 else p
                  for p in planes]
        classes = self._check_classes(classes)
        scale, ir = self._slide_range(planes[0].dtype, rescale, in_range,
                                      len(planes))
        self._quant_for_raw(
            planes[0] if len(planes) == 1 else np.stack(planes), outlier,
            rescale, scaling_factor, in_range)
        x = torch.stack([self._upload(p) for p in planes])  # [C0, H, W]
        return self._run_slide(x, scale, ir, outlier, rescale, classes,
                               scaling_factor)

    @staticmethod
    def _slide_range(dtype, rescale: bool, in_range, n: int):
        """The im2double scale of ``dtype`` (None past 16 bits) and the
        pinned range as ``[n, 2]`` units of the im2double'd plane (or
        None); raises for the combinations the JAX engine refuses."""
        scale = _IM2DOUBLE.get(np.dtype(dtype))
        if scale is None and not rescale:
            raise ValueError(
                f"rescale=False requires uint8/uint16 input, got "
                f"{np.dtype(dtype)}"
            )
        if in_range is None:
            return scale, None
        if not rescale:
            raise ValueError("in_range requires rescale=True")
        return scale, _normalize_in_range(in_range, n) / (scale or 1.0)

    def _run_slide(self, x: torch.Tensor, scale, ir, outlier, rescale: bool,
                   classes, scaling_factor: float, trim=None) -> np.ndarray:
        """``x``: ``[C0, H, W]`` float32 raw values on the device -> uint8
        maps, the order of ``_build_slide`` (``infer.py:520-631``):
        im2double, the forward resize, the range of each resized channel,
        the canvas, net, K1 and K2's epilogue at the scaled size, then the
        back resize of ``q8 / 255`` and ``uint8(255 * r)``.

        ``trim = (tr, tc, th, tw)``: only that window of the maps comes
        back.  At scale 1 it goes into K2, which writes only the window;
        at another scale the back resize needs the whole band, and the
        window is cut from its output on the card.  Either way only the
        window's bytes cross to the host."""
        _, height, width = x.shape
        trim = check_trim(trim, height, width)
        sh = int(float(height) * float(scaling_factor))
        sw = int(float(width) * float(scaling_factor))
        fwd = self._resize_plan((height, width), (sh, sw))
        if scale is not None:
            x = x * _reciprocal(scale)  # im2double
        x = fwd.apply(x)  # [C0, sh, sw]
        if rescale:
            if ir is not None:
                lo = _column(ir[:, 0], self.device)
                hi = _column(ir[:, 1], self.device)
            else:
                lo = x.amin(dim=(1, 2), keepdim=True)
                hi = (torch.stack([percentile_linear(c, outlier) for c in x])
                      .reshape(-1, 1, 1) if outlier != -1
                      else x.amax(dim=(1, 2), keepdim=True))
            x = torch.minimum(torch.maximum(x, lo), hi)
            x = (x - lo) / torch.clamp(hi - lo, min=1e-12) * 0.983
        if fwd.identity:
            return self._maps(x, classes, quantize=True, trim=trim
                              ).cpu().numpy()
        q8 = self._maps(x, classes, quantize=True)
        # q8 / 255 as XLA compiles the JAX engine's division (see
        # _reciprocal); a lerp of values in [0, 1] stays in [0, 1] up
        # to rounding, so the truncating cast needs no clamp
        back = self._resize_plan((sh, sw), (height, width))
        r = back.apply(q8.float() * _reciprocal(255.0))
        q8 = (r * 255.0).to(torch.uint8)
        if trim is not None:
            tr, tc, th, tw = trim
            q8 = q8[:, tr : tr + th, tc : tc + tw].contiguous()
        return q8.cpu().numpy()

    # -- the card-resident slide (viewer pans without uploads) ---------------

    def device_plane(self, raw, outlier: float = -1, rescale: bool = True,
                     in_range=None) -> "DevicePlane":
        """Pin a raw slide plane ``[H, W]`` or channel stack ``[C, H, W]``
        in device memory for repeated windowed inference
        (``unmicst_tpu/infer.py:764-782``).

        It goes up once; every :meth:`infer_slide_device` pan after that
        slices its band on the card.  float32 planes take the parity cast
        to uint16; uint16 stays in its int16 bit view, two bytes a pixel,
        and each band is widened on the card.  An int8 engine calibrates
        from this plane, on the host, before the upload."""
        a = np.asarray(raw)
        if a.ndim not in (2, 3):
            raise ValueError(f"plane must be [H, W] or [C, H, W], got "
                             f"{a.shape}")
        if a.dtype == np.float32:
            a = a.astype(np.uint16)
        if self.quantized and self._quant is None:
            self._quant_for_raw(a, outlier, rescale, in_range=in_range)
        return DevicePlane(self._host_tensor(a).to(self.device), a.dtype)

    @staticmethod
    def _band_checked(plane: "DevicePlane", ndim: int, r0: int, c0: int,
                      height: int, width: int) -> torch.Tensor:
        """The ``[..., height, width]`` band at ``(r0, c0)``: a view of the
        pinned plane, no copy.  A band outside the plane raises (a slice
        would clamp it to a shifted window)."""
        if plane.ndim != ndim:
            raise ValueError(
                f"pinned plane must be {ndim}-D, got shape {plane.shape}"
            )
        ph, pw = plane.shape[-2:]
        r0, c0, height, width = int(r0), int(c0), int(height), int(width)
        if not (0 <= r0 and 0 <= c0 and height > 0 and width > 0
                and r0 + height <= ph and c0 + width <= pw):
            raise ValueError(
                f"band ({r0},{c0})+{height}x{width} outside the "
                f"{ph}x{pw} pinned plane"
            )
        return plane.data[..., r0 : r0 + height, c0 : c0 + width]

    def _pan(self, plane, ndim, r0, c0, height, width, outlier, rescale,
             classes, scaling_factor, in_range, trim) -> np.ndarray:
        if self.quantized and self._quant is None:
            raise RuntimeError(
                "int8 engine is uncalibrated: pin the slide with "
                "device_plane(...) (which calibrates) or run one host-path "
                "request first"
            )
        classes = self._check_classes(classes)
        band = self._band_checked(plane, ndim, r0, c0, height, width)
        band = band if ndim == 3 else band[None]
        scale, ir = self._slide_range(plane.dtype, rescale, in_range,
                                      band.shape[0])
        check_trim(trim, height, width)
        return self._run_slide(self._widen(band, plane.dtype), scale, ir,
                               outlier, rescale, classes, scaling_factor,
                               trim)

    def infer_slide_device(self, plane: "DevicePlane", r0: int, c0: int,
                           height: int, width: int, outlier: float = -1,
                           rescale: bool = True, classes=None,
                           scaling_factor: float = 1.0, in_range=None,
                           trim=None) -> np.ndarray:
        """Windowed inference against a :meth:`device_plane` slide: uint8
        ``[K, height, width]`` maps of the band at ``(r0, c0)``, equal to
        :meth:`infer_slide` of the band's pixels, but the band never
        crosses from the host (``unmicst_tpu/infer.py:816-879``).

        ``trim = (tr, tc, th, tw)`` (band-relative) returns only the
        ``[K, th, tw]`` window, equal to the untrimmed maps' crop; only its
        bytes come back to the host."""
        return self._pan(plane, 2, r0, c0, height, width, outlier, rescale,
                         classes, scaling_factor, in_range, trim)

    def infer_slide_stack_device(self, planes: "DevicePlane", r0: int,
                                 c0: int, height: int, width: int,
                                 outlier: float = -1, rescale: bool = True,
                                 classes=None, scaling_factor: float = 1.0,
                                 in_range=None, trim=None) -> np.ndarray:
        """:meth:`infer_slide_device` for a pinned ``[C, H, W]`` channel
        stack (duo plumbing, a range per channel; the same ``trim``)."""
        n_in = int(planes.shape[0]) if planes.ndim == 3 else 0
        if n_in != self.hp.n_channels:
            raise ValueError(
                f"model expects {self.hp.n_channels} channels, got {n_in}"
            )
        return self._pan(planes, 3, r0, c0, height, width, outlier, rescale,
                         classes, scaling_factor, in_range, trim)


class DevicePlane:
    """A slide pinned in device memory by
    :meth:`InferenceEngine.device_plane`: ``data`` on the card in the
    raw ``dtype``'s width (uint16 as its int16 bits), ``shape`` and
    ``ndim`` of the raw plane."""

    def __init__(self, data: torch.Tensor, dtype):
        self.data, self.dtype = data, np.dtype(dtype)
        self.shape, self.ndim = tuple(data.shape), data.dim()
        self.nbytes = data.numel() * data.element_size()
