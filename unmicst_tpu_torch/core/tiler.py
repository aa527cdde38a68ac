"""Overlap-tiled image partitioning in PyTorch (the PI2D successor).

The counterpart of ``unmicst_tpu/core/tiler.py:33-215``, with the same
layouts: canvases are ``[H', W', ...]`` and tile stacks
``[npr, npc, P, P, ...]``.  The reference cuts a zero-padded image into
``patch`` tiles at stride ``sub = patch - 2*margin``, weights each tile's
prediction by a linear-ramp window and overlap-adds (``PartitionOfImage.py:
6-147``).

* :func:`unfold` is a strided view of the canvas (no copy);
* :func:`fold` is the plain overlap-add, written as the JAX package's
  shifted dense adds so its sums pair up in the same order.  It is the
  plain version of kernel K2 (``kernels/blend_fold.py``);
* :func:`ramp_window` is a numpy copy of the reference window.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Static tile geometry (``PartitionOfImage.py:23-75``)."""

    height: int  # original image rows (NR)
    width: int  # original image cols (NC)
    patch: int  # PatchSize
    margin: int  # Margin

    @property
    def sub(self) -> int:
        return self.patch - 2 * self.margin

    @property
    def npr(self) -> int:
        return -(-self.height // self.sub)

    @property
    def npc(self) -> int:
        return -(-self.width // self.sub)

    @property
    def padded_height(self) -> int:  # NRPI
        return self.npr * self.sub + 2 * self.margin

    @property
    def padded_width(self) -> int:  # NCPI
        return self.npc * self.sub + 2 * self.margin

    @property
    def num_tiles(self) -> int:
        return self.npr * self.npc

    def __post_init__(self):
        if self.height <= 0 or self.width <= 0:
            raise ValueError(f"empty image: {self.height}x{self.width}")
        if self.margin < 1:
            # margin 0 leaves a zero blend count along every seam
            raise ValueError(f"margin must be >= 1, got {self.margin}")
        if self.patch <= 2 * self.margin:
            raise ValueError("patch must exceed 2*margin")
        if self.sub < 2 * self.margin:
            # every pixel must lie under at most 2 tiles per axis: the
            # dense-add fold and the gather kernel both rely on it
            raise ValueError(
                "overlap-add requires sub >= 2*margin "
                f"(patch={self.patch}, margin={self.margin})"
            )


def make_grid(height: int, width: int, patch: int, margin: int) -> TileGrid:
    return TileGrid(height=height, width=width, patch=patch, margin=margin)


def ramp_window(patch: int, margin: int, dtype=np.float32) -> np.ndarray:
    """The PI2D blend window, bit-for-bit (``PartitionOfImage.py:30-39``):
    zero on the outermost ring, ``i / (2*margin)`` on ring ``i`` for
    ``i in 1..2*margin-1``, ones inside."""
    w = np.ones((patch, patch), np.float64)
    w[[0, -1], :] = 0
    w[:, [0, -1]] = 0
    for i in range(1, 2 * margin):
        v = i / (2 * margin)
        w[i, i:-i] = v
        w[-i - 1, i:-i] = v
        w[i:-i, i] = v
        w[i:-i, -i - 1] = v
    return np.asarray(w, dtype)


def pad_canvas(image: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """Zero-pad ``[H, W, ...]`` to the tile canvas with a ``margin``
    top-left offset (``PartitionOfImage.py:58-63``)."""
    if tuple(image.shape[:2]) != (grid.height, grid.width):
        raise ValueError(
            f"image {tuple(image.shape[:2])} does not match grid "
            f"{(grid.height, grid.width)}"
        )
    out = image.new_zeros(
        (grid.padded_height, grid.padded_width) + tuple(image.shape[2:])
    )
    m = grid.margin
    out[m : m + grid.height, m : m + grid.width] = image
    return out


def unfold(padded: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """All tiles as a strided view: ``[H', W', ...] -> [npr, npc, P, P, ...]``
    (no copy; tile ``(i, j)`` starts at ``(i*sub, j*sub)``)."""
    if tuple(padded.shape[:2]) != (grid.padded_height, grid.padded_width):
        raise ValueError(
            f"canvas {tuple(padded.shape[:2])} does not match grid "
            f"{(grid.padded_height, grid.padded_width)}"
        )
    s0, s1 = padded.stride(0), padded.stride(1)
    rest = tuple(padded.shape[2:])
    return padded.as_strided(
        (grid.npr, grid.npc, grid.patch, grid.patch) + rest,
        (grid.sub * s0, grid.sub * s1, s0, s1) + tuple(padded.stride()[2:]),
    )


def _fold_axis(tiles: torch.Tensor, sub: int) -> torch.Tensor:
    """Overlap-add along the leading (tile, pixel) axis pair:
    ``[n, P, ...] -> [n*sub + (P - sub), ...]``; the tail of tile k-1
    lands on the first ``P - sub`` pixels of chunk k."""
    n, patch = tiles.shape[0], tiles.shape[1]
    two_m = patch - sub
    rest = tuple(tiles.shape[2:])
    chunks = tiles[:, :sub].clone()
    chunks[1:, :two_m] += tiles[:-1, sub:]
    return torch.cat([chunks.reshape((n * sub,) + rest), tiles[-1, sub:]], 0)


def fold(tiles: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """Overlap-add tiles back to the canvas:
    ``[npr, npc, P, P, ...] -> [H', W', ...]``.  Callers pre-multiply the
    tiles by the blend window (and a mask for phantom tiles)."""
    t = tiles.movedim(1, 2)  # (npr, Pr, npc, Pc, ...)
    t = _fold_axis(t, grid.sub)  # (H', npc, Pc, ...)
    t = t.movedim(0, 2)  # (npc, Pc, H', ...)
    t = _fold_axis(t, grid.sub)  # (W', H', ...)
    return t.transpose(0, 1)  # (H', W', ...)


def count_map(grid: TileGrid, window: torch.Tensor) -> torch.Tensor:
    """Per-pixel sum of the overlapping blend windows (PI2D ``Count``)."""
    tiles = window[None, None].expand(grid.npr, grid.npc, grid.patch,
                                      grid.patch)
    return fold(tiles, grid)


def crop_valid(canvas: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """Crop the margin offset back to ``H x W`` (``PartitionOfImage.py:
    108-122``)."""
    m = grid.margin
    return canvas[m : m + grid.height, m : m + grid.width]
