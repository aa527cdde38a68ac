"""Post-training int8 quantization of the UNet inference path.

The counterpart of ``unmicst_tpu/core/quant.py``, the same scheme:

* activations: per-input-channel symmetric scales ``a[cin] =
  percentile(|x[:, cin]|, calibration_percentile) / 127`` (the channel's
  absmax where the percentile is 0), from one float32 forward over sample
  tiles with a tap at every conv site's input;
* weights: the scales fold into the kernel (``W' = a[cin] * W``), and
  ``W'`` is quantized per output channel (``w_scale[co] = max|W'[co]| /
  127``), so dequantizing is one multiply per output channel; the
  inference residual fold applies first, so the fused kernel is the one
  quantized;
* bias correction (on by default): per site and output channel, the mean
  of ``conv_f32(x) - quant_conv(x)`` over the calibration tiles, added
  after the dequantize;
* compute: ``core/unet.py`` :func:`quant_conv`, an exact s8 x s8 -> s32
  ``torch._int_mm`` over an im2col (the JAX package runs XLA's int8
  convolution; neither is a hand-written kernel).

A QuantState is the JAX one with PyTorch layouts::

    {"kernels": {site: {"w8": int8 OIHW, "w_scale": float32 [cout],
                        "bias": float32 [cout] (bias correction)}},
     "scales":  {site: float32 [cin]}}

:func:`to_device` copies one to a device and adds each site's prepared
``_int_mm`` operand (``"w8_mat"``); :func:`quant_from_jax` turns a JAX
QuantState (numpy) into the port's.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from unmicst_tpu_torch.core.hp import HParams
from unmicst_tpu_torch.core.unet import UNet, quant_conv, weight_matrix

QuantState = Dict[str, Dict[str, Any]]

# tiles per calibration forward
CALIBRATION_CHUNK = 32


def _quantize_kernel(w: np.ndarray, a: Optional[np.ndarray] = None
                     ) -> Dict[str, np.ndarray]:
    """Quantize OIHW ``a[cin] * w`` per output channel (``a=None`` ->
    ones); the arithmetic of ``quant._quantize_kernel`` in numpy float32."""
    w = np.asarray(w, np.float32)
    if a is not None:
        w = w * np.asarray(a, np.float32)[None, :, None, None]
    absmax = np.max(np.abs(w), axis=(1, 2, 3))
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    w8 = np.clip(np.round(w / scale[:, None, None, None]), -127,
                 127).astype(np.int8)
    return {"w8": w8, "w_scale": scale}


def _fuse_host(layer: Dict[str, np.ndarray]) -> Optional[np.ndarray]:
    """numpy copy of the inference residual fold (``UNet._fused_residual``)
    on OIHW kernels; a drift from the module's fold shows as a site that
    the calibration never reaches."""
    if layer["extra"]:
        return None
    k1, ks = layer["kernel1"], layer["shortcut"]
    if k1.shape == ks.shape:
        return k1 + ks
    kh, kw = k1.shape[-2:]
    if ks.shape[-2:] == (1, 1) and kh % 2 and kw % 2:
        out = k1.copy()
        out[:, :, kh // 2, kw // 2] += ks[:, :, 0, 0]
        return out
    return None


def conv_sites(state, hp: HParams) -> Dict[str, np.ndarray]:
    """Site name -> float32 OIHW kernel for every plain conv that runs in
    int8 (``quant.conv_sites``): the fused or separate down convs of level
    1 and below, the bottom conv, the up levels' ``kernel2`` and extra
    convs.  The first down block (its input is the raw standardized
    image), the transposed convs and the 1x1 top conv stay float, as in
    the JAX package."""
    st = {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v,
                        np.float32) for k, v in state.items()}
    nx = hp.n_extra_convs
    sites: Dict[str, np.ndarray] = {}
    for i in range(1, hp.n_layers):
        layer = {"kernel1": st[f"down.{i}.kernel1"],
                 "shortcut": st[f"down.{i}.shortcut"],
                 "extra": [st[f"down.{i}.extra.{j}"] for j in range(nx)]}
        fused = _fuse_host(layer)
        if fused is not None:
            sites[f"down{i}"] = fused
        else:
            sites[f"down{i}.k1"] = layer["kernel1"]
            sites[f"down{i}.short"] = layer["shortcut"]
            for j, ke in enumerate(layer["extra"]):
                sites[f"down{i}.extra{j}"] = ke
    sites["bottom"] = st["bottom.kernel1"]
    for i in range(hp.n_layers):
        sites[f"up{i}.k2"] = st[f"up.{i}.kernel2"]
        for j in range(nx):
            sites[f"up{i}.extra{j}"] = st[f"up.{i}.extra.{j}"]
    return sites


def site_level(site: str, hp: HParams) -> int:
    """The resolution level (0: the full tile) of a site's input."""
    if site == "bottom":
        return hp.n_layers
    return int(site.split(".")[0].lstrip("downup"))


def to_device(qs: QuantState, device) -> QuantState:
    """``qs`` with every tensor on ``device`` and each site's ``_int_mm``
    operand (``weight_matrix``) made once, as ``"w8_mat"``."""
    device = torch.device(device)
    kernels = {}
    for site, qk in qs["kernels"].items():
        k = {n: torch.as_tensor(v).to(device) for n, v in qk.items()
             if n != "w8_mat"}
        k["w8_mat"] = weight_matrix(k["w8"])
        kernels[site] = k
    scales = {site: torch.as_tensor(a).to(device)
              for site, a in qs["scales"].items()}
    return {"kernels": kernels, "scales": scales}


def cached_on(cache: dict, qs: Optional[QuantState], device
              ) -> Optional[QuantState]:
    """``qs`` on ``device`` through ``cache`` (device -> (state, copy)):
    copied once per state and device, so an engine's state pinned from
    elsewhere, or used on several ranks' devices, moves once."""
    if qs is None:
        return None
    src, copy = cache.get(device, (None, None))
    if src is not qs:
        copy = to_device(qs, device)
        cache[device] = (qs, copy)
    return copy


def quant_from_jax(qs) -> QuantState:
    """A JAX QuantState (arrays or numpy) -> the port's, on the CPU: each
    ``w8`` from HWIO to OIHW int8; scales, weight scales and biases as
    float32."""
    kernels = {}
    for site, qk in qs["kernels"].items():
        k = {"w8": torch.from_numpy(np.ascontiguousarray(np.transpose(
            np.asarray(qk["w8"], np.int8), (3, 2, 0, 1))))}
        for n in ("w_scale", "bias"):
            if n in qk:
                k[n] = torch.from_numpy(np.array(qk[n], np.float32))
        kernels[site] = k
    scales = {site: torch.from_numpy(np.array(a, np.float32))
              for site, a in qs["scales"].items()}
    return {"kernels": kernels, "scales": scales}


def percentile_rows(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x.T, q, axis=0)`` (method ``linear``) of each row
    of a ``[C, n]`` tensor, with JAX's float32 arithmetic for the position
    and the weights; two ``kthvalue`` selections per row, since
    ``torch.quantile`` refuses more than 2**24 elements."""
    n = x.shape[1]
    nf = np.float32(n)
    pos = (np.float32(q) / np.float32(100.0)) * (nf - np.float32(1.0))
    low, high = np.floor(pos), np.ceil(pos)
    hw = np.float32(pos - low)
    lw = np.float32(np.float32(1.0) - hw)
    low = int(min(max(low, 0), nf - 1))
    high = int(min(max(high, 0), nf - 1))
    v_low = torch.kthvalue(x, low + 1, dim=1).values
    v_high = (torch.kthvalue(x, high + 1, dim=1).values if high != low
              else v_low)
    return v_low * float(lw) + v_high * float(hw)


def _float_model(state, hp: HParams, variant: str, device) -> UNet:
    model = UNet(hp, variant)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model.to(device).eval()


def _precision(device: torch.device):
    """TF32 off on the card for the calibration's float32 convolutions, and
    cuDNN's heuristic algorithms: the scales must not depend on which
    algorithm a timing run picked (``infer._conv_precision``)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    from unmicst_tpu_torch.infer import _conv_precision

    return _conv_precision(False, autotune=False)


def calibrate(state, tiles: np.ndarray, hp: HParams, variant: str, *,
              percentile: float = 99.99, bias_correct: bool = True,
              device=None, chunk: int = CALIBRATION_CHUNK) -> QuantState:
    """A QuantState from normalized sample tiles ``[N, S, S, C]`` (the JAX
    layout), on ``device`` (default: the CPU).

    One float32 forward over the tiles, ``chunk`` tiles at a time, taps
    each site's ``|x|`` per channel; the per-channel percentile (absmax
    where it is 0) over all tiles gives the activation scales, which fold
    into the weights quantized on the host.  With ``bias_correct`` a
    second float32 forward measures each site's mean int8 error per output
    channel (float64 sums over the chunks)."""
    device = torch.device(device or "cpu")
    site_kernels = conv_sites(state, hp)
    model = _float_model(state, hp, variant, device)
    x = torch.from_numpy(np.ascontiguousarray(
        np.asarray(tiles, np.float32).transpose(0, 3, 1, 2)))
    batches = [x[i : i + chunk].to(device)
               for i in range(0, x.shape[0], chunk)]
    seen: Dict[str, list] = {}

    def stats_tap(site, h):
        if site in site_kernels:
            seen.setdefault(site, []).append(
                h.float().abs().transpose(0, 1).reshape(h.shape[1], -1))

    with torch.inference_mode(), _precision(device):
        for t in batches:
            model.forward_nchw(t, tap=stats_tap)
    missing = set(site_kernels) - set(seen)
    if missing:
        raise ValueError(
            f"calibration never reached conv site(s) {sorted(missing)}: "
            "site naming drifted between conv_sites and UNet.forward_nchw")
    scales, kernels = {}, {}
    for site, w in site_kernels.items():
        ax = torch.cat(seen.pop(site), dim=1)
        m_pct = percentile_rows(ax, percentile).cpu().numpy()
        m_max = ax.amax(dim=1).cpu().numpy()
        del ax
        m = np.where(m_pct > 0, m_pct, m_max)  # the absmax fallback
        a = np.where(m > 0, m / 127.0, 1.0).astype(np.float32)
        scales[site] = a
        kernels[site] = _quantize_kernel(w, a)
    qs = to_device({"kernels": kernels, "scales": scales}, device)
    if bias_correct:
        sums: Dict[str, torch.Tensor] = {}
        counts: Dict[str, int] = {}
        weights = {site: torch.from_numpy(w).to(device)
                   for site, w in site_kernels.items()}

        def bias_tap(site, h):
            if site in site_kernels:
                w = weights[site]
                yf = F.conv2d(h.float(), w, padding=w.shape[-1] // 2)
                yq = quant_conv(h, qs["kernels"][site], qs["scales"][site])
                d = (yf - yq).double().sum(dim=(0, 2, 3))
                sums[site] = sums[site] + d if site in sums else d
                counts[site] = (counts.get(site, 0)
                                + h.shape[0] * h.shape[2] * h.shape[3])

        with torch.inference_mode(), _precision(device):
            for t in batches:
                model.forward_nchw(t, tap=bias_tap)
        for site, total in sums.items():
            qs["kernels"][site]["bias"] = (total / counts[site]).float()
    return qs


def _jitter_grid(h: int, w: int, s: int, n: int, rng):
    """The (row, col) of each of ``n`` sample windows of side ``s``: an
    even grid over the slide with a seeded jitter of a quarter tile (the
    draws of ``quant.sample_tiles``, in the same order)."""
    grid = max(1, int(np.ceil(np.sqrt(n))))
    k = 0
    for gi in range(grid):
        for gj in range(grid):
            if k >= min(n, grid * grid):
                return
            r0 = 0 if h <= s else int(
                np.clip(gi * (h - s) / max(grid - 1, 1)
                        + rng.randint(-s // 4, s // 4 + 1), 0, h - s))
            c0 = 0 if w <= s else int(
                np.clip(gj * (w - s) / max(grid - 1, 1)
                        + rng.randint(-s // 4, s // 4 + 1), 0, w - s))
            yield r0, c0
            k += 1


def sample_tiles(image: np.ndarray, hp: HParams, mean: float, std: float,
                 *, n: int = 64, seed: int = 0) -> np.ndarray:
    """``n`` normalized patches ``[n, S, S, C]`` of a 2D net-input image
    (or a ``[C, H, W]`` stack) for calibration, evenly spread over it with
    a seeded jitter (``quant.sample_tiles``, the same draws and values)."""
    if image.ndim == 2:
        image = image[None]
    c, h, w = image.shape
    s = hp.im_size
    grid = max(1, int(np.ceil(np.sqrt(n))))
    out = np.empty((min(n, grid * grid), s, s, hp.n_channels), np.float32)
    for k, (r0, c0) in enumerate(_jitter_grid(h, w, s, n,
                                              np.random.RandomState(seed))):
        patch = np.zeros((s, s, c), np.float32)
        blk = image[:, r0 : r0 + s, c0 : c0 + s]
        patch[: blk.shape[1], : blk.shape[2], :] = np.transpose(
            blk, (1, 2, 0)).astype(np.float32)
        if c == 1 and hp.n_channels > 1:
            patch = np.repeat(patch, hp.n_channels, axis=-1)
        out[k] = (patch - mean) / std
    return out


def sample_tiles_raw(planes, hp: HParams, mean: float, std: float, *,
                     scale: Optional[float], outlier: float = -1,
                     rescale: bool = True, n: int = 64, seed: int = 0,
                     in_range=None) -> np.ndarray:
    """Calibration tiles for the raw slide paths (``quant.
    sample_tiles_raw``): sampled windows through the engine's
    preprocessing (im2double by ``scale``, clip to each channel's min and
    max or outlier percentile, rescale to 0.983, mean/std), the range from
    a 4x-decimated pass, or ``in_range`` (raw units of ``planes``) when
    pinned."""
    planes = np.asarray(planes)
    if planes.ndim == 2:
        planes = planes[None]
    c, h, w = planes.shape
    s = hp.im_size
    if rescale:
        if in_range is not None:
            ir = np.asarray(in_range, np.float64).reshape(-1, 2)
            if ir.shape[0] == 1 and c > 1:
                ir = np.repeat(ir, c, axis=0)
            lo = ir[:, 0].astype(np.float32)
            hi = ir[:, 1].astype(np.float32)
            if scale is not None:
                lo, hi = lo / scale, hi / scale
        else:
            dec = planes[:, ::4, ::4].astype(np.float32)
            if scale is not None:
                dec /= scale
            lo = dec.min(axis=(1, 2))
            hi = (np.percentile(dec, outlier, axis=(1, 2)) if outlier != -1
                  else dec.max(axis=(1, 2)))
    grid = max(1, int(np.ceil(np.sqrt(n))))
    out = np.empty((min(n, grid * grid), s, s, hp.n_channels), np.float32)
    for k, (r0, c0) in enumerate(_jitter_grid(h, w, s, n,
                                              np.random.RandomState(seed))):
        blk = planes[:, r0 : r0 + s, c0 : c0 + s].astype(np.float32)
        if scale is not None:
            blk /= scale
        if rescale:
            for ci in range(c):
                b = np.clip(blk[ci], lo[ci], hi[ci])
                blk[ci] = (b - lo[ci]) / max(hi[ci] - lo[ci], 1e-12) * 0.983
        patch = np.zeros((s, s, c), np.float32)
        patch[: blk.shape[1], : blk.shape[2], :] = np.transpose(
            blk, (1, 2, 0))
        if c == 1 and hp.n_channels > 1:
            patch = np.repeat(patch, hp.n_channels, axis=-1)
        out[k] = (patch - mean) / std
    return out


def stream_tiles(read_rows, height: int, width: int, hp: HParams, lo, hi,
                 rescale: bool, inv_scale: float, mean: float, std: float,
                 grid_n: int = 8) -> np.ndarray:
    """The streaming engine's calibration tiles (``pipeline.
    _quant_for_stream``): a seeded jittered ``grid_n`` x ``grid_n`` grid
    of windows, one row band per grid row and channel through
    ``read_rows(channel, r0, nrows)``, preprocessed with the stream's own
    global ranges ``lo`` / ``hi`` (raw units, one per net channel) or
    im2double by ``inv_scale``, then mean/std."""
    s, n_ch = hp.im_size, hp.n_channels
    lo = np.broadcast_to(np.asarray(lo, np.float32), (n_ch,))
    hi = np.broadcast_to(np.asarray(hi, np.float32), (n_ch,))
    rng = np.random.RandomState(0)
    tiles = np.zeros((grid_n * grid_n, s, s, n_ch), np.float32)
    k = 0
    for gi in range(grid_n):
        r0 = 0 if height <= s else int(
            np.clip(gi * (height - s) / (grid_n - 1)
                    + rng.randint(-s // 4, s // 4 + 1), 0, height - s))
        rows = [read_rows(ci, r0, s).astype(np.float32)
                for ci in range(n_ch)]
        for gj in range(grid_n):
            c0 = 0 if width <= s else int(
                np.clip(gj * (width - s) / (grid_n - 1)
                        + rng.randint(-s // 4, s // 4 + 1), 0, width - s))
            for ci, r in enumerate(rows):
                blk = r[:, c0 : c0 + s]
                tiles[k, :, : blk.shape[1], ci] = blk
            k += 1
    if rescale:
        x = np.clip(tiles, lo, hi)
        x = (x - lo) / np.maximum(hi - lo, 1e-12) * 0.983
    else:
        x = tiles * inv_scale
    return (x - mean) / std
