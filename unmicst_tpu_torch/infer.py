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

Only the uint8 maps come back to the host.  Accumulation is float32 (the
reference accumulates in float16, ``PartitionOfImage.py:86-90``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from unmicst_tpu_torch.core import tiler
from unmicst_tpu_torch.core.checkpoint import State
from unmicst_tpu_torch.core.hp import HParams, ModelBundle
from unmicst_tpu_torch.core.resize_dev import ResizePlan
from unmicst_tpu_torch.core.unet import UNet
from unmicst_tpu_torch.kernels import blend_fold_epilogue, softmax_blend
from unmicst_tpu_torch.runtime.devices import Device, resolve_device
from unmicst_tpu_torch.utils.batching import chunks

DEFAULT_TILE_BATCH = 256

# --precision -> UNet compute dtype (None = float32).  On the GPU
# "float32" and "highest" both run full float32 with TF32 off.
PRECISIONS = {"float32": None, "highest": None, "bfloat16": torch.bfloat16}

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
    flat = x.reshape(-1)
    n = flat.numel()
    nf = np.float32(n)
    pos = (np.float32(q) / np.float32(100.0)) * (nf - np.float32(1.0))
    low, high = np.floor(pos), np.ceil(pos)
    hw = np.float32(pos - low)
    lw = np.float32(np.float32(1.0) - hw)
    low = int(min(max(low, 0), nf - 1))
    high = int(min(max(high, 0), nf - 1))
    v_low = torch.kthvalue(flat, low + 1).values
    v_high = torch.kthvalue(flat, high + 1).values if high != low else v_low
    return v_low * float(lw) + v_high * float(hw)


def tile_bytes(hp: HParams) -> int:
    """Upper estimate of the device bytes one tile adds to a forward: six
    float32 tensors of every level's in + out width at that level's
    resolution (activations are float32 in both precision modes).
    ``chip_smoke.py`` holds it against the measured growth of peak memory
    per tile."""
    w, p = hp.n_out_x, hp.im_size
    per_level = sum(
        (w[i + 1] + w[i]) * (p >> i) ** 2 for i in range(hp.n_layers + 1)
    )
    return 6 * per_level * 4


def pick_tile_batch(hp: HParams, device: torch.device) -> int:
    """256 tiles per forward, fewer when 40% of the card's free memory
    cannot hold that chunk."""
    if device.type != "cuda":
        return DEFAULT_TILE_BATCH
    free, _ = torch.cuda.mem_get_info(device)
    return max(1, min(DEFAULT_TILE_BATCH, int(0.4 * free) // tile_bytes(hp)))


@contextlib.contextmanager
def _conv_precision(tf32: bool):
    """cuDNN and matmul TF32 set for the engine's work only, and restored
    after.  The float32 modes run with TF32 off (cuDNN convolutions default
    to TF32; the JAX float32 modes are 3-pass or full f32, ``cli.py:237-
    254``, ``unet.py:115-134``).  The bfloat16 mode convolves float32
    tensors that hold bf16 values, which TF32 represents exactly, so it
    lets cuDNN use the TF32 tensor cores.  Every chunk has the same shape,
    so cuDNN benchmarks its algorithms once."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = tf32
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                        deterministic=False,
                                        allow_tf32=tf32):
            yield
    finally:
        matmul.allow_tf32 = saved


def weigh_tiles(model: UNet, canvas: torch.Tensor, grid: tiler.TileGrid,
                window: torch.Tensor, mask: torch.Tensor, tile_batch: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The UNet and K1 over every tile of a canvas: ``[T, K, P, P]``
    float32 ``softmax(logits) * window * mask[t]``, in row-major tile order.

    ``canvas``: ``[C, H', W']`` net input (after mean/std, in the model's
    compute dtype) on the model's device, cut into ``grid``'s tiles (a
    strided view).  Every forward runs exactly ``tile_batch`` tiles: the
    last chunk is padded with zero tiles, so every forward has one shape.
    Callers pick the chunk (capped at the tile count, or split evenly).
    ``mask``: ``[T]`` float32 per-tile factor (0 drops a phantom tile from
    the blend).  ``out``: optional contiguous ``[T, K, P, P]`` destination.
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
    staging = torch.zeros((tile_batch, n_ch, patch, patch),
                          dtype=canvas.dtype, device=device)
    flags = (_conv_precision(model.compute_dtype is not None)
             if device.type == "cuda" else contextlib.nullcontext())
    with torch.inference_mode(), flags:
        for t0, t1 in chunks(n_tiles, tile_batch):
            real = t1 - t0
            if real < tile_batch:
                staging[real:].zero_()  # phantom tiles of the last chunk
            # copy the chunk's tiles row segment by row segment
            t = t0
            while t < t1:
                i, j = divmod(t, npc)
                n = min(npc - j, t1 - t)
                staging[t - t0 : t - t0 + n].copy_(tiles[i, j : j + n])
                t += n
            logits = model.forward_nchw(staging, return_logits=True)
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
    """

    def __init__(self, hp: HParams, params: State, variant: str,
                 mean: float, std: float, *, compute_dtype=None,
                 tile_batch: Optional[int] = None, device: Device = None):
        self.device = resolve_device(device)
        self.hp, self.variant = hp, variant
        self.mean, self.std = float(mean), float(std)
        self.compute_dtype = compute_dtype
        self.model = UNet(hp, variant, compute_dtype)
        self.model.load_state_dict(params)
        self.model.to(self.device).eval()
        self.tile_batch = int(tile_batch or pick_tile_batch(hp, self.device))
        self.window = torch.from_numpy(
            tiler.ramp_window(hp.im_size, hp.margin)
        ).to(self.device)

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

    # -- the device pipeline -------------------------------------------------

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """``(x - mean) / std`` (as the JAX engine compiles it), in the
        compute dtype: the net input of a canvas."""
        x = (x - self.mean) * _reciprocal(self.std)
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def _maps(self, planes: torch.Tensor, classes, quantize: bool):
        """``planes``: [C0, H, W] float32 on the device, the net input
        before mean/std (C0 == 1 broadcasts into every net channel).
        Returns ``[Kc, H, W]`` uint8 (``quantize``) or float32 maps."""
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
                               min(self.tile_batch, grid.num_tiles))
        return blend_fold_epilogue(weighted, self.window, grid, classes,
                                   quantize)

    def _upload(self, raw: np.ndarray) -> torch.Tensor:
        """Host plane -> float32 on the device; uint16 travels as int16 and
        is widened and masked there (torch's uint16 support is partial)."""
        if raw.dtype == np.uint16:
            x = torch.from_numpy(np.ascontiguousarray(raw).view(np.int16))
            x = x.to(self.device).to(torch.int32) & 0xFFFF
        elif raw.dtype == np.uint8:
            x = torch.from_numpy(np.ascontiguousarray(raw)).to(self.device)
        else:
            x = torch.from_numpy(np.ascontiguousarray(raw, np.float32))
            x = x.to(self.device)
        return x.to(torch.float32)

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
        """``[C0]`` raw planes -> uint8 maps, the order of ``_build_slide``
        (``infer.py:520-631``): im2double, the forward resize, the range
        of each resized channel, the canvas, net, K1 and K2's epilogue at
        the scaled size, then the back resize of ``q8 / 255`` and
        ``uint8(255 * r)``.  ``C0 == 1`` broadcasts into every channel."""
        # parity cast (UnMicst1-5.py:807-808)
        planes = [p.astype(np.uint16) if p.dtype == np.float32 else p
                  for p in planes]
        classes = self._check_classes(classes)
        scale = _IM2DOUBLE.get(np.dtype(planes[0].dtype))
        if scale is None and not rescale:
            raise ValueError(
                f"rescale=False requires uint8/uint16 input, got "
                f"{planes[0].dtype}"
            )
        if in_range is not None:
            if not rescale:
                raise ValueError("in_range requires rescale=True")
            ir = _normalize_in_range(in_range, len(planes)) / (scale or 1.0)
        height, width = planes[0].shape
        sh = int(float(height) * float(scaling_factor))
        sw = int(float(width) * float(scaling_factor))
        fwd = ResizePlan((height, width), (sh, sw), self.device)
        x = torch.stack([self._upload(p) for p in planes])  # [C0, H, W]
        if scale is not None:
            x = x * _reciprocal(scale)  # im2double
        x = fwd.apply(x)  # [C0, sh, sw]
        if rescale:
            if in_range is not None:
                lo = _column(ir[:, 0], self.device)
                hi = _column(ir[:, 1], self.device)
            else:
                lo = x.amin(dim=(1, 2), keepdim=True)
                hi = (torch.stack([percentile_linear(c, outlier) for c in x])
                      .reshape(-1, 1, 1) if outlier != -1
                      else x.amax(dim=(1, 2), keepdim=True))
            x = torch.minimum(torch.maximum(x, lo), hi)
            x = (x - lo) / torch.clamp(hi - lo, min=1e-12) * 0.983
        q8 = self._maps(x, classes, quantize=True)
        if not fwd.identity:
            # q8 / 255 as XLA compiles the JAX engine's division (see
            # _reciprocal); a lerp of values in [0, 1] stays in [0, 1] up
            # to rounding, so the truncating cast needs no clamp
            back = ResizePlan((sh, sw), (height, width), self.device)
            r = back.apply(q8.float() * _reciprocal(255.0))
            q8 = (r * 255.0).to(torch.uint8)
        return q8.cpu().numpy()
