"""K2: gather overlap-add of window-weighted tiles, with the slide epilogue.

The port of the TPU kernel ``exhibits/pallas/blend.py:76``
(``blend_fold_pallas``, ``_blend_kernel`` at ``:49``).  One CUDA source,
``unmicst_tpu_torch/csrc/blend_fold.cu``, two entry points:

* :func:`blend_fold` — the Pallas contract: ``[npr, npc, P, P, K]`` tiles
  and a ``[P, P]`` window -> ``tiler.fold(tiles * window)``, the padded
  ``[H', W', K]`` canvas;
* :func:`blend_fold_epilogue` — the main path's tail (``infer.py:303-343``
  and ``:624`` of the JAX package): ``[T, K, P, P]`` tiles already
  weighted by K1 -> blend count, divide, margin crop, class subset and
  ``uint8(255 * p)`` (or float32) ``[Kc, H, W]``.

The kernel reads tiles through element strides, so both layouts go in
without a copy.  CUDA tensors run the kernel (or raise); CPU tensors the
plain versions, :func:`blend_fold_plain` and :func:`blend_fold_epilogue_plain`.
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
    "blend_fold_epilogue": [_P, _LL, _LL, _LL, _LL, _LL, _P, _P, _I, _P, _I,
                            _I, _I, _I, _I, _I, _I, _P],
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


# -- (b) the main-path epilogue ------------------------------------------------


def _classes(classes: Optional[Sequence[int]], k: int) -> list:
    cls = list(range(k)) if classes is None else [int(c) for c in classes]
    if not cls or any(not 0 <= c < k for c in cls):
        raise ValueError(f"classes {cls} out of range for {k} classes")
    return cls


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
    want = (grid.num_tiles, grid.patch, grid.patch)
    if (weighted.dim() != 4 or (weighted.shape[0],) + tuple(weighted.shape[2:])
            != want):
        raise ValueError(
            f"weighted shape {tuple(weighted.shape)} != [T, K, P, P] with "
            f"(T, P, P) = {want}"
        )
    _check_float("weighted", weighted, weighted.device)
    _check_window(window, grid, weighted.device)
    cls = _classes(classes, weighted.shape[1])
    if not weighted.is_cuda:
        return blend_fold_epilogue_plain(weighted, window, grid, cls, quantize)
    out = torch.empty((len(cls), grid.height, grid.width),
                      dtype=torch.uint8 if quantize else torch.float32,
                      device=weighted.device)
    cls_dev = torch.tensor(cls, dtype=torch.int32).to(weighted.device)
    st, sk, sy, sx = weighted.stride()
    with torch.cuda.device(weighted.device):
        rc = _lib().blend_fold_epilogue(
            weighted.data_ptr(), grid.npc * st, st, sk, sy, sx,
            window.data_ptr(), cls_dev.data_ptr(), len(cls), out.data_ptr(),
            int(quantize), grid.npr, grid.npc, grid.patch, grid.sub,
            grid.height, grid.width, _stream(),
        )
    if rc:
        raise RuntimeError(f"blend_fold_epilogue launch failed: cudaError {rc}")
    blend_fold_epilogue.launches += 1
    return out


blend_fold_epilogue.launches = 0
