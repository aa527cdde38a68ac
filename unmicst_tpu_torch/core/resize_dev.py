"""The ``--scalingFactor`` resize on the device (``unmicst_tpu/core/
resize_dev.py``).

The reference resizes on the host with ``skimage.transform.resize``
(``UnMicst1-5.py:813-815``): a gaussian anti-alias on downscale (sigma
``(f - 1) / 2``, truncate 4.0, mirror boundary), then a bilinear resample
at half-pixel centres.  Here both run in float32 on ``[..., H, W]``
tensors: the blur as a sum of the taps over mirror-indexed gathers, in
the JAX package's tap order, and the resample as two gather + lerp stages
(rows, then columns).  Every static piece (taps, gather indices, lerp
fractions) is computed once in numpy; the indices and fractions live on
the plan's device, so applying a plan copies nothing from the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def _gauss_kernel(sigma: float) -> np.ndarray:
    """The float32 taps of ``scipy.ndimage.gaussian_filter1d``
    (truncate 4.0), as the JAX plan computes them."""
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def mirror_index(idx: np.ndarray, n: int) -> np.ndarray:
    """Fold indices into ``[0, n)`` by scipy's ``mirror`` rule (numpy's
    ``reflect`` pad): period ``2(n - 1)``, the edge sample not repeated;
    any reach, however far past the axis."""
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return np.where(idx > n - 1, period - idx, idx)


def _fold(coords: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Mirror-fold sample coordinates into ``[0, n - 1]`` -> (lo index,
    float32 fraction), the host resize's ``_fold_coords``."""
    c = np.abs(coords)
    c = np.where(c > n - 1, 2.0 * (n - 1) - c, c)
    lo = np.floor(c).astype(np.int64)
    np.clip(lo, 0, max(n - 2, 0), out=lo)
    return lo, (c - lo).astype(np.float32)


class _Blur:
    """One axis of the anti-alias: ``taps`` (float32 values as Python
    floats) over the rows of ``ext``, the mirror-extended index of the
    axis (``n + 2 * radius`` entries)."""

    def __init__(self, sigma: float, n: int, device):
        k = _gauss_kernel(sigma)
        self.taps: List[float] = [float(w) for w in k]
        radius = (len(k) - 1) // 2
        self.n = n
        self.ext = torch.from_numpy(
            mirror_index(np.arange(-radius, n + radius), n)).to(device)

    def apply(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        xp = x.index_select(axis, self.ext)
        out = None
        for i, w in enumerate(self.taps):
            term = xp.narrow(axis, i, self.n) * w
            out = term if out is None else out + term
        return out


class _Lerp:
    """One axis of the bilinear resample: ``a + (b - a) * frac``."""

    def __init__(self, coords: np.ndarray, n: int, device):
        self.n, self.m = n, len(coords)
        lo, frac = _fold(coords, n)
        self.lo = torch.from_numpy(lo).to(device)
        self.hi = torch.from_numpy(np.minimum(lo + 1, n - 1)).to(device)
        self.frac = torch.from_numpy(frac).to(device)

    def apply(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        if self.n == 1:
            shape = list(x.shape)
            shape[axis] = self.m
            return x.expand(shape)
        a = x.index_select(axis, self.lo)
        b = x.index_select(axis, self.hi)
        shape = [1] * x.dim()
        shape[axis] = self.m
        return a + (b - a) * self.frac.reshape(shape)


class ResizePlan:
    """The static pieces of one ``in_shape -> out_shape`` resize, on
    ``device``; :meth:`apply` resizes the last two axes of a float32
    tensor on that device."""

    def __init__(self, in_shape: Tuple[int, int], out_shape: Tuple[int, int],
                 device=None):
        in_h, in_w = in_shape
        out_h, out_w = out_shape
        if min(in_h, in_w, out_h, out_w) < 1:
            raise ValueError(f"degenerate resize {in_shape} -> {out_shape}")
        device = torch.device(device or "cpu")
        self.identity = (in_h, in_w) == (out_h, out_w)
        fr, fc = in_h / out_h, in_w / out_w
        sr, sc = max(0.0, (fr - 1.0) / 2.0), max(0.0, (fc - 1.0) / 2.0)
        self.blur_rows: Optional[_Blur] = (_Blur(sr, in_h, device) if sr > 0
                                           else None)
        self.blur_cols: Optional[_Blur] = (_Blur(sc, in_w, device) if sc > 0
                                           else None)
        self.rows = _Lerp((np.arange(out_h) + 0.5) * fr - 0.5, in_h, device)
        self.cols = _Lerp((np.arange(out_w) + 0.5) * fc - 0.5, in_w, device)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., H, W]`` float32 -> ``[..., out_h, out_w]`` float32."""
        if self.identity:
            return x
        r, c = x.dim() - 2, x.dim() - 1
        if self.blur_rows is not None:
            x = self.blur_rows.apply(x, r)
        if self.blur_cols is not None:
            x = self.blur_cols.apply(x, c)
        return self.cols.apply(self.rows.apply(x, r), c)
