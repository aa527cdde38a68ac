"""Spatially sharded inference with a halo exchange between ranks.

The port of ``unmicst_tpu/runtime/halo.py``.  The zero-padded slide canvas
is cut into row bands, one per rank of a :class:`~unmicst_tpu_torch.
runtime.mesh.Mesh`; each rank runs the tile pipeline on its band.  Two
seams need a neighbour's data, and each travels exactly one hop:

* the input halo: the first ``2m`` rows of the next band (rank ``i``
  receives from ``i + 1``, shift -1); the last rank takes the canvas tail
  instead, which holds real rows when ``H`` is a multiple of ``sub``;
* the output overlap: the ``2m``-row fold tail of each band lands on the
  next band's head (shift +1); rank 0 drops what it receives.

Seam implementations (``halo_impl``):

* ``"ppermute"`` (default): a plain cross-device copy
  (:func:`~unmicst_tpu_torch.kernels.halo_ring.ring_shift_plain`), the
  counterpart of ``jax.lax.ppermute``, which is an XLA collective;
* ``"ring"``: both hops through kernel K3 (JAX's ``"pallas"``);
* ``"ring_overlap"``: the input hop started by K4a before the band's
  interior tile rows run and redeemed by K4b before its last (seam) tile
  row, the output hop through K3 (JAX's ``"pallas_overlap"``).  A band of
  one tile row has no interior, and this falls back to ``"ring"``.

On a card each band goes through the port's kernels: the UNet and K1 with
the band's phantom-row mask, then K2's fold-only entry for the padded
strip.  On the CPU the kernels take their plain versions.

On a mesh that spans processes each process runs only its own ranks'
bands, the seam hops cross processes (``"ppermute"`` over the process
group, which gloo serves on the CPU only; ``"ring"`` and
``"ring_overlap"`` through K3/K4 over CUDA IPC on cards, ``ppermute`` on
the CPU), and every process gathers every band: the result is the
one-process call's, as the JAX workers' ``process_allgather`` gives it.
Every process holds the whole canvas.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from unmicst_tpu_torch.core import tiler
from unmicst_tpu_torch.core.checkpoint import State
from unmicst_tpu_torch.core.hp import HParams
from unmicst_tpu_torch.core.unet import UNet
from unmicst_tpu_torch.infer import _reciprocal, weigh_tiles
from unmicst_tpu_torch.kernels import (
    blend_fold_strip, ring_shift, ring_shift_plain, ring_shift_start,
    ring_shift_wait,
)
from unmicst_tpu_torch.kernels.halo_ring import RingSpan
from unmicst_tpu_torch.runtime.mesh import Mesh, process_allgather
from unmicst_tpu_torch.utils.batching import even_chunk, round_up

HALO_IMPLS = ("ppermute", "ring", "ring_overlap")


def exchange(bufs: List[Optional[torch.Tensor]], shift: int, halo_impl: str,
             kind: str, span: Optional[RingSpan] = None
             ) -> List[Optional[torch.Tensor]]:
    """One seam hop: rank ``i`` gets rank ``(i - shift) mod n``'s buffer,
    by a plain copy (``"ppermute"``) or by kernel K3 (``"ring"``).
    ``span``: a ring across processes (None for the others' ranks)."""
    if halo_impl == "ppermute":
        return ring_shift_plain(bufs, shift, span)
    return ring_shift(bufs, shift, kind=kind, span=span)


def count_map(grid: tiler.TileGrid, window: torch.Tensor) -> torch.Tensor:
    """The blend count of ``grid`` (``tiler.count_map``), through K2's
    fold-only entry on a card (the window broadcast by stride 0)."""
    p = grid.patch
    tiles = window[None, None].expand(grid.num_tiles, 1, p, p)
    return blend_fold_strip(tiles, grid)[..., 0]


def _models(params: State, hp: HParams, variant: str, devices,
            compute_dtype) -> Dict[torch.device, UNet]:
    out = {}
    for dev in dict.fromkeys(devices):
        model = UNet(hp, variant, compute_dtype)
        model.load_state_dict(params)
        out[dev] = model.to(dev).eval()
    return out


def spatial_infer(
    params: State,
    canvas,
    height: int,
    width: int,
    hp: HParams,
    variant: str,
    mesh: Mesh,
    *,
    mean: float,
    std: float,
    axis: str = "data",
    tile_batch: int = 64,
    compute_dtype=None,
    precision: Optional[str] = None,
    halo_impl: str = "ppermute",
) -> torch.Tensor:
    """Row-sharded tiled inference over ``mesh``'s ranks.

    ``params``: the UNet state dict.  ``canvas``: the zero-padded float32
    canvas ``[npr_pad*sub + 2m, W', C]`` (numpy or torch; see
    :func:`build_canvas`).  ``compute_dtype``: None (float32) or
    ``torch.bfloat16``.  ``precision``: None, ``"float32"`` or
    ``"highest"``, which on a card all run full float32 (TF32 off).
    Returns ``[H, W, K]`` float32 probability maps on the first rank's
    device (across processes: on this process's first rank's device).
    """
    if halo_impl not in HALO_IMPLS:
        raise ValueError(f"unknown halo_impl {halo_impl!r}; one of "
                         f"{HALO_IMPLS}")
    if precision not in (None, "float32", "highest"):
        raise ValueError(f"unknown precision {precision!r}")
    ranks = mesh.ranks(axis)
    n_dev = len(ranks)
    patch, margin = hp.im_size, hp.margin
    grid = tiler.make_grid(height, width, patch, margin)
    sub, two_m, npc = grid.sub, 2 * margin, grid.npc
    npr_pad = round_up(grid.npr, n_dev)
    R = npr_pad // n_dev  # tile rows per rank
    rows_per_dev = R * sub
    band_grid = tiler.make_grid(rows_per_dev, width, patch, margin)

    canvas = torch.as_tensor(canvas)
    if canvas.dtype != torch.float32 or canvas.dim() != 3:
        raise ValueError(f"canvas must be float32 [rows, W', C], got "
                         f"{canvas.dtype} {tuple(canvas.shape)}")
    expected = (npr_pad * sub + two_m, grid.padded_width, hp.n_channels)
    if tuple(canvas.shape) != expected:
        raise ValueError(f"canvas has shape {tuple(canvas.shape)}, expected "
                         f"{expected}")

    span = mesh.span(axis)
    mine = span.local()  # this process's ranks of the ring
    if not mine:
        raise ValueError(f"process {mesh.process} holds no rank along "
                         f"{axis!r}")
    models = _models(params, hp, variant, [ranks[d] for d in mine],
                     compute_dtype)
    windows = {d: torch.from_numpy(tiler.ramp_window(patch, margin)).to(d)
               for d in models}
    inv_std = _reciprocal(std)

    def net_input(x: torch.Tensor) -> torch.Tensor:
        """``[rows, W', C]`` canvas rows -> ``[C, rows, W']`` net input."""
        x = (x - mean) * inv_std
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        return x.permute(2, 0, 1)

    def every(fn) -> list:
        """``fn(d)`` for this process's ranks, None for the others'."""
        out = [None] * n_dev
        for d in mine:
            out[d] = fn(d)
        return out

    blocks = every(lambda d: canvas[d * rows_per_dev:
                                    (d + 1) * rows_per_dev].to(ranks[d]))
    # the canvas tail is the LAST rank's input halo
    global_tail = canvas[npr_pad * sub :].to(ranks[-1]) \
        if n_dev - 1 in mine else None
    heads = every(lambda d: blocks[d][:two_m])
    masks = every(lambda d: (torch.arange(R) + d * R < grid.npr).float()
                  .repeat_interleave(npc).to(ranks[d]))

    # every forward runs one chunk shape, the seam row's too: cuDNN picks
    # its algorithm by shape, and one shape keeps "ring_overlap" bit-equal
    # to the other seam implementations.  The chunk splits the interior
    # rows evenly, so the overlap's split forward wastes no more than one
    # chunk of the band's.
    chunk = even_chunk(max(R - 1, 1) * npc, tile_batch)

    def weigh(d, x, g, mask, out=None):
        dev = ranks[d]
        # eager: the models live for this call, so a graph captured in it
        # would not be replayed in another
        return weigh_tiles(models[dev], net_input(x), g, windows[dev], mask,
                           chunk, out=out, _graphs=False)

    weighted = [None] * n_dev
    if halo_impl == "ring_overlap" and R > 1:
        interior_grid = tiler.make_grid((R - 1) * sub, width, patch, margin)
        seam_grid = tiler.make_grid(sub, width, patch, margin)
        n_int = (R - 1) * npc
        handle = ring_shift_start(heads, -1, span=span)
        for d in mine:  # interior tile rows: local rows only
            w = torch.empty((R * npc, hp.n_classes, patch, patch),
                            dtype=torch.float32, device=ranks[d])
            weigh(d, blocks[d][: (R - 1) * sub + two_m], interior_grid,
                  masks[d][:n_int], out=w[:n_int])
            weighted[d] = w
        halos = ring_shift_wait(handle)
        for d in mine:  # the seam tile row: last sub rows + halo
            halo = global_tail if d == n_dev - 1 else halos[d]
            seam = torch.cat([blocks[d][(R - 1) * sub :], halo], 0)
            weigh(d, seam, seam_grid, masks[d][n_int:], out=weighted[d][n_int:])
    else:
        impl = "ring" if halo_impl == "ring_overlap" else halo_impl
        halos = exchange(heads, -1, impl, "input", span)
        for d in mine:
            halo = global_tail if d == n_dev - 1 else halos[d]
            band = torch.cat([blocks[d], halo], 0)
            weighted[d] = weigh(d, band, band_grid, masks[d])

    strips = every(lambda d: blend_fold_strip(weighted[d], band_grid))
    del weighted
    # output halo: each band's fold tail lands on the next band's head
    tails = every(lambda d: strips[d][rows_per_dev:])
    recv = exchange(tails, 1, "ppermute" if halo_impl == "ppermute"
                    else "ring", "output", span)
    for d in mine:  # rank 0 drops the wrapped-around tail
        if d > 0:
            strips[d][:two_m] += recv[d]

    dev0 = ranks[mine[0]]
    if span.multi:  # every process gathers every band
        strips = list(process_allgather(torch.stack(
            [strips[d] for d in mine])).to(dev0).unbind(0))
    # reassemble: every band, then the genuine global tail (the last rank's)
    out = torch.cat([s[:rows_per_dev].to(dev0) for s in strips]
                    + [strips[-1][rows_per_dev:].to(dev0)], 0)
    count = count_map(grid, windows[dev0])
    valid = out[: grid.padded_height] / count[..., None]
    return valid[margin : margin + height, margin : margin + width]


def build_canvas(image: np.ndarray, hp: HParams, n_dev: int,
                 channel_mode: str = "broadcast") -> np.ndarray:
    """Host-side canvas assembly padded for an ``n_dev``-way row shard
    (``halo.py:202-234``)."""
    patch, margin = hp.im_size, hp.margin
    if image.ndim == 2:
        planes = [image] * (hp.n_channels if channel_mode == "broadcast" else 1)
    elif image.ndim == 3:
        if channel_mode == "broadcast":
            if image.shape[0] != 1:
                raise ValueError("broadcast mode expects a single plane")
            planes = [image[0]] * hp.n_channels
        else:
            planes = list(image)
    else:
        raise ValueError("image must be [H, W] or [C, H, W]")
    # a silent mismatch would zero-fill (or overflow) channels
    if len(planes) != hp.n_channels:
        raise ValueError(
            f"model expects {hp.n_channels} channels, got {len(planes)}"
        )
    height, width = planes[0].shape
    grid = tiler.make_grid(height, width, patch, margin)
    npr_pad = round_up(grid.npr, n_dev)
    rows = npr_pad * grid.sub + 2 * margin
    canvas = np.zeros((rows, grid.padded_width, hp.n_channels), np.float32)
    for c, p in enumerate(planes):
        canvas[margin : margin + height, margin : margin + width, c] = p
    return canvas
