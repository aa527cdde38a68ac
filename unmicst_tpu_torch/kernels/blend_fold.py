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
  ``uint8(255 * p)`` (or float32) ``[Kc, H, W]``, or only a ``trim``
  window of them (a viewer's ROI out of its context band);
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
without a copy.  Its launch is planned by :func:`fold_launch`, a pure
function of the layout: the vector path, where each thread loads one
canvas-aligned quad of :data:`VEC` columns with 16-byte loads and stores
the columns of it that lie in the region, at any region origin and width;
or, for tile layouts that cannot take 16-byte loads, the scalar lanes; the
block and the grid.  Its class subset travels by value in a
:data:`MAX_CLASSES`-entry table (:func:`class_table`), so a launch makes no
copy to the card and never waits for it.  CUDA tensors run the kernel (or
raise); CPU tensors the plain versions (``*_plain``), built on
``tiler.fold``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from unmicst_tpu_torch.core import tiler
from unmicst_tpu_torch.core.tiler import TileGrid
from unmicst_tpu_torch.kernels import _build

# the launch shape and limits of csrc/blend_fold.cu
VEC = 4  # canvas columns per thread on the vector path (kVec)
BLOCK = (32, 8)  # threads per block along columns and rows (kBx, kBy)
MAX_CLASSES = 8  # entries of the class table (kMaxClasses)


class _Classes(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("idx", ctypes.c_int * MAX_CLASSES)]


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "blend_fold_f32": [_P, _LL, _LL, _LL, _LL, _LL, _P, _P, _I, _I, _I, _I,
                       _I, _P],
    "blend_fold_region": [_P, _LL, _LL, _LL, _LL, _LL, _P,
                          ctypes.POINTER(_Classes), _P, _P, _P, _I, _I, _I,
                          _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
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
    if len(cls) > MAX_CLASSES:
        raise ValueError(f"K2 takes at most {MAX_CLASSES} classes, got "
                         f"{len(cls)}")
    return cls


def class_table(cls: Sequence[int]) -> _Classes:
    """The kernel's class table, passed by value: the count and the
    class indexes in output order."""
    if not 1 <= len(cls) <= MAX_CLASSES:
        raise ValueError(f"K2 takes 1..{MAX_CLASSES} classes, got {len(cls)}")
    return _Classes(len(cls), (ctypes.c_int * MAX_CLASSES)(*cls))


class FoldLaunch(NamedTuple):
    """One ``blend_fold_region`` launch: ``cols`` canvas columns per
    thread (:data:`VEC` on the vector path, 1 on the scalar lanes), and the
    ``block`` and the ``grid`` as (columns, rows).  A grid row covers the
    region's canvas quads ``c0 // 4 .. (c0 + w - 1) // 4`` on the vector
    path, its columns on the scalar lanes."""

    cols: int
    block: Tuple[int, int]
    grid: Tuple[int, int]


def fold_launch(h: int, c0: int, w: int, strides: Sequence[int], sub: int,
                patch: int, addresses: Sequence[int]) -> FoldLaunch:
    """The launch of the region ``[r0, r0 + h) x [c0, c0 + w)`` over
    tiles of element ``strides`` (tile row, tile column, class, y, x).

    The vector path needs x stride 1, the other strides, ``sub`` and
    ``patch`` multiples of :data:`VEC` (a canvas-aligned quad of columns
    then never straddles a tile column, and its four columns share their
    covering tiles at 16-byte aligned offsets), and every address read 16
    bytes at a time (``addresses``: the tiles and the window) on a 16-byte
    boundary.  The region's origin and width do not matter: threads take
    canvas-aligned quads and store the columns that lie in the region,
    four at a time where the output address allows, which the kernel
    decides per quad.  Other layouts run the scalar lanes, one column a
    thread."""
    si, sj, sk, sy, sx = strides
    vector = (sx == 1
              and all(v % VEC == 0 for v in (si, sj, sk, sy, sub, patch))
              and all(a % 16 == 0 for a in addresses))
    across = (c0 + w - 1) // VEC - c0 // VEC + 1 if vector else w
    bx, by = BLOCK
    return FoldLaunch(VEC if vector else 1, BLOCK,
                      (-(-across // bx), -(-h // by)))


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
    table = class_table(cls)
    st, sk, sy, sx = weighted.stride()
    strides = (grid.npc * st, st, sk, sy, sx)

    def ptr(x):
        return None if x is None else x.data_ptr()

    plan = fold_launch(h, c0, w, strides, grid.sub, grid.patch,
                       [x.data_ptr() for x in (weighted, window)
                        if x is not None])
    # the device and its raw stream go to the C side, which switches the
    # current device only when it must: cheaper than torch.cuda.device
    rc = _lib().blend_fold_region(
        weighted.data_ptr(), *strides, ptr(window), ctypes.byref(table),
        ptr(row_mask), ptr(col_mask), ptr(addend),
        0 if addend is None else addend.shape[1], r0, c0, h, w,
        out.data_ptr(), _MODES[mode], grid.npr, grid.npc, grid.patch,
        grid.sub, plan.cols, *plan.grid, dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index),
    )
    if rc:
        raise RuntimeError(f"{wrapper.__name__} launch failed: cudaError {rc}")
    wrapper.launches += 1
    return out


def check_trim(trim, height: int, width: int) -> Optional[tuple]:
    """``trim = (tr, tc, th, tw)`` as ints, inside an ``height x width``
    map (None passes); out of band it raises, as the JAX engine's
    ``_trim_checked`` does (``unmicst_tpu/infer.py:802-814``) rather than
    clamp to a shifted window."""
    if trim is None:
        return None
    tr, tc, th, tw = (int(v) for v in trim)
    if not (0 <= tr and 0 <= tc and th > 0 and tw > 0
            and tr + th <= height and tc + tw <= width):
        raise ValueError(
            f"trim ({tr},{tc})+{th}x{tw} outside the {height}x{width} band"
        )
    return tr, tc, th, tw


def blend_fold_epilogue_plain(weighted: torch.Tensor, window: torch.Tensor,
                              grid: TileGrid, classes=None,
                              quantize: bool = True,
                              trim=None) -> torch.Tensor:
    """fold + count + divide + crop + class subset (+ uint8), in plain
    PyTorch (the JAX composition of ``infer.py:303-343,620-624``); a
    ``trim`` crops the finished maps."""
    k = weighted.shape[1]
    t5 = weighted.reshape(grid.npr, grid.npc, k, grid.patch, grid.patch)
    acc = tiler.fold(t5.permute(0, 1, 3, 4, 2), grid)  # [H', W', K]
    count = tiler.count_map(grid, window)
    valid = tiler.crop_valid(acc / count[..., None], grid)
    probs = valid[..., _classes(classes, k)].permute(2, 0, 1)
    trim = check_trim(trim, grid.height, grid.width)
    if trim is not None:
        tr, tc, th, tw = trim
        probs = probs[:, tr : tr + th, tc : tc + tw]
    if quantize:
        return (probs * 255.0).clamp(0.0, 255.0).to(torch.uint8)
    return probs.contiguous()


def blend_fold_epilogue(weighted: torch.Tensor, window: torch.Tensor,
                        grid: TileGrid, classes=None,
                        quantize: bool = True, trim=None) -> torch.Tensor:
    """``[T, K, P, P]`` K1-weighted tiles (``T == grid.num_tiles``, in
    row-major tile order) -> ``[Kc, H, W]`` maps: uint8(255 * p) with
    ``quantize``, else float32.  ``classes``: the class indexes to keep,
    in that order (default all).

    ``trim = (tr, tc, th, tw)``: only the ``[Kc, th, tw]`` window at
    ``(tr, tc)`` of the maps, written by the same region launch over
    canvas rows ``(m + tr, th)`` and columns ``(m + tc, tw)``; equal to
    the untrimmed maps' crop.  Its launches also count in
    ``blend_fold_epilogue.trim_launches``."""
    _check_weighted(weighted, grid)
    _check_window(window, grid, weighted.device)
    cls = _classes(classes, weighted.shape[1])
    trim = check_trim(trim, grid.height, grid.width)
    if not weighted.is_cuda:
        return blend_fold_epilogue_plain(weighted, window, grid, cls, quantize,
                                         trim)
    m = grid.margin
    tr, tc, th, tw = trim or (0, 0, grid.height, grid.width)
    out = _fold_region(blend_fold_epilogue, weighted, window, grid,
                       (m + tr, th), (m + tc, tw), cls,
                       "u8" if quantize else "f32")
    if trim is not None:
        blend_fold_epilogue.trim_launches += 1
    return out


blend_fold_epilogue.launches = 0
blend_fold_epilogue.trim_launches = 0


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
