"""3D overlap tiling in PyTorch: the port of ``unmicst_tpu/core/tiler3d.py``
(the reference's ``PI3D``, ``PartitionOfImage.py:150-304``).

No CLI uses it; it exists for volumetric models.  The layouts are the JAX
package's: canvases ``[Z', H', W', ...]``, tile stacks ``[npz, npr, npc,
P, P, P, ...]``.  :func:`unfold3d` is a strided view of the canvas (no
copy), :func:`fold3d` three passes of the 2D tiler's overlap-add
(``core/tiler._fold_axis``), and :func:`count_map3d` folds the window one
axis at a time, so it never holds the ``npz * npr * npc`` window copies.
Every function runs on the device of its input.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from unmicst_tpu_torch.core.tiler import _fold_axis


@dataclasses.dataclass(frozen=True)
class TileGrid3D:
    depth: int  # NZ
    height: int  # NR
    width: int  # NC
    patch: int
    margin: int

    @property
    def sub(self) -> int:
        return self.patch - 2 * self.margin

    @property
    def npz(self) -> int:
        return -(-self.depth // self.sub)

    @property
    def npr(self) -> int:
        return -(-self.height // self.sub)

    @property
    def npc(self) -> int:
        return -(-self.width // self.sub)

    @property
    def padded(self):
        m2 = 2 * self.margin
        return (
            self.npz * self.sub + m2,
            self.npr * self.sub + m2,
            self.npc * self.sub + m2,
        )

    def __post_init__(self):
        # the 2D TileGrid's guards: margin 0 zeroes the window's outer
        # ring (a zero blend count on every seam plane, NaN after the
        # divide); negatives mis-slice every tile
        if self.depth <= 0 or self.height <= 0 or self.width <= 0:
            raise ValueError(
                f"empty volume: {self.depth}x{self.height}x{self.width}"
            )
        if self.margin < 1:
            raise ValueError(f"margin must be >= 1, got {self.margin}")
        if self.patch <= 2 * self.margin:
            raise ValueError("patch must exceed 2*margin")
        if self.sub < 2 * self.margin:
            raise ValueError("3D overlap-add requires sub >= 2*margin")


def make_grid3d(depth, height, width, patch, margin) -> TileGrid3D:
    return TileGrid3D(depth, height, width, patch, margin)


def ramp_window3d(patch: int, margin: int, dtype=np.float32) -> np.ndarray:
    """The PI3D cubic weight window, bit-for-bit (``:176-186``)."""
    w = np.ones((patch, patch, patch))
    w[[0, -1], :, :] = 0
    w[:, [0, -1], :] = 0
    w[:, :, [0, -1]] = 0
    for i in range(1, 2 * margin):
        v = i / (2 * margin)
        w[[i, -i - 1], i:-i, i:-i] = v
        w[i:-i, [i, -i - 1], i:-i] = v
        w[i:-i, i:-i, [i, -i - 1]] = v
    return np.asarray(w, dtype)


def pad_canvas3d(volume: torch.Tensor, grid: TileGrid3D) -> torch.Tensor:
    """Zero-pad ``[Z, H, W, ...]`` to the tile canvas, ``margin`` before
    each axis."""
    if tuple(volume.shape[:3]) != (grid.depth, grid.height, grid.width):
        raise ValueError(
            f"volume {tuple(volume.shape[:3])} does not match grid "
            f"{(grid.depth, grid.height, grid.width)}"
        )
    out = volume.new_zeros(tuple(grid.padded) + tuple(volume.shape[3:]))
    m = grid.margin
    out[m : m + grid.depth, m : m + grid.height, m : m + grid.width] = volume
    return out


def unfold3d(padded: torch.Tensor, grid: TileGrid3D) -> torch.Tensor:
    """All tiles as a strided view: ``[Z', H', W', ...] -> [npz, npr,
    npc, P, P, P, ...]``; tile ``(i, j, k)`` starts at ``(i, j, k) *
    sub``."""
    if tuple(padded.shape[:3]) != tuple(grid.padded):
        raise ValueError(f"canvas {tuple(padded.shape[:3])} does not match "
                         f"grid {tuple(grid.padded)}")
    s = padded.stride()
    n, p = (grid.npz, grid.npr, grid.npc), (grid.patch,) * 3
    return padded.as_strided(
        n + p + tuple(padded.shape[3:]),
        tuple(grid.sub * v for v in s[:3]) + s[:3] + tuple(s[3:]))


def fold3d(tiles: torch.Tensor, grid: TileGrid3D) -> torch.Tensor:
    """``[npz, npr, npc, Pz, Pr, Pc, ...] -> [Z', H', W', ...]``, the JAX
    package's three axis passes."""
    t = tiles.movedim(3, 1)  # (npz, Pz, npr, npc, Pr, Pc, ...)
    t = _fold_axis(t, grid.sub)  # (Z', npr, npc, Pr, Pc, ...)
    t = t.movedim(1, 0).movedim(3, 1)  # (npr, Pr, Z', npc, Pc, ...)
    t = _fold_axis(t, grid.sub)  # (H', Z', npc, Pc, ...)
    t = t.movedim(2, 0).movedim(3, 1)  # (npc, Pc, H', Z', ...)
    t = _fold_axis(t, grid.sub)  # (W', H', Z', ...)
    return t.movedim((0, 1, 2), (2, 1, 0))  # (Z', H', W', ...)


def count_map3d(grid: TileGrid3D, window: torch.Tensor) -> torch.Tensor:
    """Per-voxel sum of the overlapping blend windows (PI3D ``Count``):
    :func:`fold3d` of the window at every tile, folded one axis at a time
    (each pass's tiles are copies of one array, so an ``expand``)."""
    p = grid.patch
    t = _fold_axis(window.expand(grid.npz, p, p, p), grid.sub)  # (Z', P, P)
    t = t.movedim(1, 0)  # (Pr, Z', Pc)
    t = _fold_axis(t.expand((grid.npr,) + tuple(t.shape)), grid.sub)
    t = t.movedim(2, 0)  # (Pc, H', Z')
    t = _fold_axis(t.expand((grid.npc,) + tuple(t.shape)), grid.sub)
    return t.movedim((0, 1, 2), (2, 1, 0))  # (Z', H', W')


def crop_valid3d(canvas: torch.Tensor, grid: TileGrid3D) -> torch.Tensor:
    m = grid.margin
    return canvas[
        m : m + grid.depth, m : m + grid.height, m : m + grid.width
    ]
