"""K2: gather overlap-add of window-weighted tiles, with its epilogues.

The port of the TPU kernel ``exhibits/pallas/blend.py:76``
(``blend_fold_pallas``, ``_blend_kernel`` at ``:49``).  One CUDA source,
``unmicst_tpu_torch/csrc/blend_fold.cu``; the wrappers:

* :func:`blend_fold` — the Pallas contract: ``[npr, npc, P, P, K]`` tiles
  and a ``[P, P]`` window -> ``tiler.fold(tiles * window)``, the padded
  ``[H', W', K]`` canvas;
* :func:`blend_fold_epilogue` — the whole slide's tail (``infer.py:303-343``
  and ``:624`` of the JAX package): ``[T, K, P, P]`` tiles already
  weighted by K1 -> blend count, divide, margin crop, class subset and
  ``uint8(255 * p)`` (or float32) ``[Kc, H, W]``;
* :func:`blend_fold_strip` — the fold alone, without count or epilogue:
  K1-weighted tiles -> the padded ``[H', W', K]`` float32 strip (a halo
  band, ``runtime/halo.py:171`` of the JAX package);
* :func:`blend_fold_stripe` — a streamed stripe's tail
  (``runtime/pipeline.py:264-275`` and ``:660-682``): a rectangle of the
  stripe's canvas with the count of the *masked* window (tile-row and
  tile-column masks), an optional neighbour's fold tail added to its first
  columns, as maps or as raw sums plus count.

All but :func:`blend_fold` launch one entry, ``blend_fold_region``.  The
kernel reads tiles through element strides, so every layout goes in
without a copy.  CUDA tensors run the kernel (or raise); CPU tensors the
plain versions (``*_plain``), built on ``tiler.fold``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from unmicst_tpu_torch.core import tiler
from unmicst_tpu_torch.core.tiler import TileGrid
from unmicst_tpu_torch.kernels import _build

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "blend_fold_f32": [_P, _LL, _LL, _LL, _LL, _LL, _P, _P, _I, _I, _I, _I,
                       _I, _P],
    "blend_fold_region": [_P, _LL, _LL, _LL, _LL, _LL, _P, _P, _I, _P, _P,
                          _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I,
                          _P],
}


def _lib():
    return _build.load("blend_fold", _SIGNATURES)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_float(name: str, x: torch.Tensor, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, tiles on {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")


def _check_window(window: torch.Tensor, grid: TileGrid, device) -> None:
    _check_float("window", window, device)
    if tuple(window.shape) != (grid.patch, grid.patch):
        raise ValueError(
            f"window shape {tuple(window.shape)} != {(grid.patch, grid.patch)}"
        )
    if not window.is_contiguous():
        raise ValueError("window must be contiguous")


# -- (a) the Pallas contract --------------------------------------------------


def blend_fold_plain(tiles: torch.Tensor, window: torch.Tensor,
                     grid: TileGrid) -> torch.Tensor:
    return tiler.fold(tiles * window[None, None, :, :, None], grid)


def blend_fold(tiles: torch.Tensor, window: torch.Tensor,
               grid: TileGrid) -> torch.Tensor:
    """``[npr, npc, P, P, K] x [P, P] -> [H', W', K]`` float32, equal to
    ``tiler.fold(tiles * window[None, None, :, :, None], grid)``.
    ``tiles`` may be any strided view."""
    want = (grid.npr, grid.npc, grid.patch, grid.patch)
    if tiles.dim() != 5 or tuple(tiles.shape[:4]) != want:
        raise ValueError(f"tiles shape {tuple(tiles.shape)} != {want} + (K,)")
    _check_float("tiles", tiles, tiles.device)
    _check_window(window, grid, tiles.device)
    if not tiles.is_cuda:
        return blend_fold_plain(tiles, window, grid)
    k = tiles.shape[4]
    out = torch.empty((grid.padded_height, grid.padded_width, k),
                      dtype=torch.float32, device=tiles.device)
    si, sj, sy, sx, sk = tiles.stride()
    with torch.cuda.device(tiles.device):
        rc = _lib().blend_fold_f32(
            tiles.data_ptr(), si, sj, sk, sy, sx, window.data_ptr(),
            out.data_ptr(), grid.npr, grid.npc, grid.patch, grid.sub, k,
            _stream(),
        )
    if rc:
        raise RuntimeError(f"blend_fold launch failed: cudaError {rc}")
    blend_fold.launches += 1
    return out


blend_fold.launches = 0


# -- (b) the region entry: the slide epilogue, a band's strip, a stripe -------


def _classes(classes: Optional[Sequence[int]], k: int) -> list:
    cls = list(range(k)) if classes is None else [int(c) for c in classes]
    if not cls or any(not 0 <= c < k for c in cls):
        raise ValueError(f"classes {cls} out of range for {k} classes")
    return cls


_MODES = {"f32": 0, "u8": 1, "raw": 2}


def _check_weighted(weighted: torch.Tensor, grid: TileGrid) -> None:
    want = (grid.num_tiles, grid.patch, grid.patch)
    if (weighted.dim() != 4 or (weighted.shape[0],) + tuple(weighted.shape[2:])
            != want):
        raise ValueError(
            f"weighted shape {tuple(weighted.shape)} != [T, K, P, P] with "
            f"(T, P, P) = {want}"
        )
    _check_float("weighted", weighted, weighted.device)


def _check_mask(name: str, mask, n: int, device) -> None:
    if mask is None:
        return
    _check_float(name, mask, device)
    if tuple(mask.shape) != (n,) or not mask.is_contiguous():
        raise ValueError(f"{name} must be contiguous [{n}], got "
                         f"{tuple(mask.shape)}")


def fold_region_plain(weighted: torch.Tensor, window: Optional[torch.Tensor],
                      grid: TileGrid, rows: tuple, cols: tuple, cls: list,
                      mode: str, row_mask=None, col_mask=None,
                      addend=None) -> torch.Tensor:
    """The region entry in plain PyTorch: the JAX compositions
    ``fold(tiles * w)``, ``fold(w)`` (``w`` the masked window), the
    addend, then divide, class subset and ``uint8(255 * p)``."""
    (r0, h), (c0, w) = rows, cols
    k, p = weighted.shape[1], grid.patch
    t5 = weighted.reshape(grid.npr, grid.npc, k, p, p).permute(0, 1, 3, 4, 2)
    acc = tiler.fold(t5[..., cls], grid)[r0 : r0 + h, c0 : c0 + w]
    if window is not None:
        wm = window[None, None].expand(grid.npr, grid.npc, p, p)
        if row_mask is not None:
            wm = wm * row_mask[:, None, None, None]
        if col_mask is not None:
            wm = wm * col_mask[None, :, None, None]
        count = tiler.fold(wm, grid)[r0 : r0 + h, c0 : c0 + w]
        acc = torch.cat([acc, count[..., None]], -1)
    if addend is not None:
        n_add = max(0, min(w, addend.shape[1] - c0))
        acc = acc.clone()
        acc[:, :n_add] += addend[:, c0 : c0 + n_add]
    if mode == "raw":
        return acc.contiguous()
    probs = (acc[..., :-1] / acc[..., -1:].clamp(min=1e-12)).permute(2, 0, 1)
    if mode == "u8":
        return (probs * 255.0).clamp(0.0, 255.0).to(torch.uint8)
    return probs.contiguous()


def _fold_region(wrapper, weighted, window, grid, rows, cols, cls, mode,
                 row_mask=None, col_mask=None, addend=None, out=None):
    """Check the arguments and launch ``blend_fold_region`` (or take the
    plain version for CPU tensors)."""
    (r0, h), (c0, w) = rows, cols
    if (h < 1 or w < 1 or r0 < 0 or c0 < 0 or r0 + h > grid.padded_height
            or c0 + w > grid.padded_width):
        raise ValueError(
            f"region rows {rows} cols {cols} outside the "
            f"{grid.padded_height}x{grid.padded_width} canvas"
        )
    dev = weighted.device
    if window is not None:
        _check_window(window, grid, dev)
    elif mode != "raw":
        raise ValueError("maps need the window for the blend count")
    _check_mask("row_mask", row_mask, grid.npr, dev)
    _check_mask("col_mask", col_mask, grid.npc, dev)
    n_out = len(cls) + (window is not None)
    if addend is not None:
        _check_float("addend", addend, dev)
        if (window is None or addend.dim() != 3 or addend.shape[0] != h
                or addend.shape[2] != n_out or not addend.is_contiguous()):
            raise ValueError(
                f"addend must be contiguous [{h}, cols, {n_out}] with a "
                f"window, got {tuple(addend.shape)}"
            )
    if not weighted.is_cuda:
        res = fold_region_plain(weighted, window, grid, rows, cols, cls, mode,
                                row_mask, col_mask, addend)
        return res if out is None else out.copy_(res)
    shape = (h, w, n_out) if mode == "raw" else (len(cls), h, w)
    dtype = torch.uint8 if mode == "u8" else torch.float32
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=dev)
    elif (tuple(out.shape) != shape or out.dtype != dtype or out.device != dev
          or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous {shape} {dtype} on {dev}")
    cls_dev = torch.tensor(cls, dtype=torch.int32).to(dev)
    st, sk, sy, sx = weighted.stride()

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        rc = _lib().blend_fold_region(
            weighted.data_ptr(), grid.npc * st, st, sk, sy, sx, ptr(window),
            cls_dev.data_ptr(), len(cls), ptr(row_mask), ptr(col_mask),
            ptr(addend), 0 if addend is None else addend.shape[1], r0, c0, h,
            w, out.data_ptr(), _MODES[mode], grid.npr, grid.npc, grid.patch,
            grid.sub, _stream(),
        )
    if rc:
        raise RuntimeError(f"{wrapper.__name__} launch failed: cudaError {rc}")
    wrapper.launches += 1
    return out


def blend_fold_epilogue_plain(weighted: torch.Tensor, window: torch.Tensor,
                              grid: TileGrid, classes=None,
                              quantize: bool = True) -> torch.Tensor:
    """fold + count + divide + crop + class subset (+ uint8), in plain
    PyTorch (the JAX composition of ``infer.py:303-343,620-624``)."""
    k = weighted.shape[1]
    t5 = weighted.reshape(grid.npr, grid.npc, k, grid.patch, grid.patch)
    acc = tiler.fold(t5.permute(0, 1, 3, 4, 2), grid)  # [H', W', K]
    count = tiler.count_map(grid, window)
    valid = tiler.crop_valid(acc / count[..., None], grid)
    probs = valid[..., _classes(classes, k)].permute(2, 0, 1)
    if quantize:
        return (probs * 255.0).clamp(0.0, 255.0).to(torch.uint8)
    return probs.contiguous()


def blend_fold_epilogue(weighted: torch.Tensor, window: torch.Tensor,
                        grid: TileGrid, classes=None,
                        quantize: bool = True) -> torch.Tensor:
    """``[T, K, P, P]`` K1-weighted tiles (``T == grid.num_tiles``, in
    row-major tile order) -> ``[Kc, H, W]`` maps: uint8(255 * p) with
    ``quantize``, else float32.  ``classes``: the class indexes to keep,
    in that order (default all)."""
    _check_weighted(weighted, grid)
    _check_window(window, grid, weighted.device)
    cls = _classes(classes, weighted.shape[1])
    if not weighted.is_cuda:
        return blend_fold_epilogue_plain(weighted, window, grid, cls, quantize)
    m = grid.margin
    return _fold_region(blend_fold_epilogue, weighted, window, grid,
                        (m, grid.height), (m, grid.width), cls,
                        "u8" if quantize else "f32")


blend_fold_epilogue.launches = 0


def blend_fold_strip(weighted: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """``[T, K, P, P]`` K1-weighted tiles -> the padded ``[H', W', K]``
    float32 overlap-add, ``tiler.fold`` of the tiles (no count, no divide,
    no crop).  ``weighted`` may be any strided view (a stride-0 expand of
    the window gives the blend count)."""
    _check_weighted(weighted, grid)
    cls = list(range(weighted.shape[1]))
    if not weighted.is_cuda:
        k, p = weighted.shape[1], grid.patch
        t5 = weighted.reshape(grid.npr, grid.npc, k, p, p)
        return tiler.fold(t5.permute(0, 1, 3, 4, 2), grid).contiguous()
    return _fold_region(blend_fold_strip, weighted, None, grid,
                        (0, grid.padded_height), (0, grid.padded_width), cls,
                        "raw")


blend_fold_strip.launches = 0


def blend_fold_stripe(weighted: torch.Tensor, window: torch.Tensor,
                      grid: TileGrid, rows: tuple, cols: tuple, *,
                      row_mask: Optional[torch.Tensor] = None,
                      col_mask: Optional[torch.Tensor] = None,
                      classes=None, addend: Optional[torch.Tensor] = None,
                      mode: str = "u8",
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A streamed stripe's tail over the canvas rectangle ``rows = (r0, H)``
    x ``cols = (c0, W)`` of ``grid``.

    The blend count is the fold of the window times ``row_mask[i]`` and
    ``col_mask[j]`` (float32, per tile row / column; None = all 1), the
    stripe's own count rather than the slide's.  ``addend``: float32
    ``[H, A, Kc + 1]`` sums and count added at canvas columns ``[0, A)``
    (the left neighbour's fold tail in the column-sharded engine).
    ``mode``: ``"u8"`` -> ``uint8(255 * p)`` ``[Kc, H, W]``; ``"f32"`` ->
    float32 maps; ``"raw"`` -> float32 ``[H, W, Kc + 1]`` sums and count.
    ``out``: an optional contiguous destination."""
    _check_weighted(weighted, grid)
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {sorted(_MODES)}, got {mode!r}")
    cls = _classes(classes, weighted.shape[1])
    return _fold_region(blend_fold_stripe, weighted, window, grid,
                        tuple(rows), tuple(cols), cls, mode, row_mask,
                        col_mask, addend, out)


blend_fold_stripe.launches = 0
