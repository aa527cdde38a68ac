"""Cross-rank operations of the mesh runtime (XLA inserts these in JAX).

Every function takes the tensors of this process's ranks, in
``mesh.local_ranks()`` order, and returns one tensor per such rank on its
device.  The ranks of one process meet on the host's side of the call;
the ranks of other processes through one ``torch.distributed``
``all_gather`` of this process's stacked tensors (so each process must
hold as many ranks, and every rank's tensor has one shape).  Sums run in
rank order whichever process holds a rank, so a mesh in one process and
the same mesh over several give the same bits.

* :func:`all_reduce_sum`: the sum over the ranks along ``axis``
  (``psum``); its gradient is the same sum of the gradients.
* :func:`all_gather`: the ranks' slices along ``axis`` concatenated on
  ``dim``.  Its backward is the rank's own slice of the gradient: the
  computation after a tensor-parallel gather is replicated on every model
  rank, and each copy's loss carries its own slice back; a reduce-scatter
  there would count the gradient ``model`` times.
* :func:`reduce_grad`: the identity, whose backward sums the gradient over
  ``axis``.  It stands before each layer whose output channels are split
  over ``model``: each rank's slice sends back only its share of the
  input's gradient (Megatron's column-parallel pattern).
* :func:`ppermute`: one ring hop (``jax.lax.ppermute``), through
  ``dist.batch_isend_irecv`` across processes; gloo cannot send a card's
  tensors, so there it raises rather than staging through the host.

Gloo carries host tensors: a card's tensor crosses the sum and the gather
through host memory, as gloo's own CUDA collectives do; NCCL runs them on
the card.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from unmicst_tpu_torch.kernels.halo_ring import ring_shift_plain
from unmicst_tpu_torch.runtime.mesh import Mesh


def _group(mesh: Mesh, axis: str, rank: int) -> Tuple[int, ...]:
    d, m = mesh.coords(rank)
    return mesh.rank_ids(axis, m if axis == "data" else d)


def _every(mesh: Mesh, xs: Sequence[torch.Tensor]) -> Dict[int, torch.Tensor]:
    """Every rank's tensor by rank: this process's as given, the others'
    gathered (on the host over gloo, on the first local card over NCCL)."""
    local = mesh.local_ranks()
    if len(xs) != len(local):
        raise ValueError(f"{len(xs)} tensors for {len(local)} local ranks")
    if not mesh.multi_process:
        return dict(zip(local, xs))
    host = mesh.backend == "gloo"
    dev = torch.device("cpu") if host else xs[0].device
    stacked = torch.stack([x.detach().to(dev) for x in xs]).contiguous()
    parts = [torch.empty_like(stacked) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, stacked)
    out = {}
    for p, part in enumerate(parts):
        ranks = [r for r in range(len(mesh.devices))
                 if mesh.process_index(r) == p]
        for k, r in enumerate(ranks):
            out[r] = part[k]
    for r, x in zip(local, xs):
        out[r] = x.detach()
    return out


def _sum(mesh: Mesh, axis: str, xs: Sequence[torch.Tensor]
         ) -> List[torch.Tensor]:
    every = _every(mesh, xs)
    out, done = [], {}
    for r, x in zip(mesh.local_ranks(), xs):
        g = _group(mesh, axis, r)
        key = (g, x.device)
        if key in done:  # another rank of the group on this device
            out.append(done[key].clone())
            continue
        acc = every[g[0]].to(x.device, copy=True)
        for q in g[1:]:
            acc += every[q].to(x.device)
        done[key] = acc
        out.append(acc)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(_sum(mesh, axis, xs))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(_sum(ctx.mesh, ctx.axis, grads))


def all_reduce_sum(xs: Sequence[torch.Tensor], mesh: Mesh,
                   axis: str = "data") -> List[torch.Tensor]:
    """For each local rank, the sum over its ranks along ``axis`` (in rank
    order), on its device; differentiable."""
    return list(_AllReduceSum.apply(mesh, axis, *xs))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, dim, *xs):
        every = _every(mesh, xs)
        ctx.pos, ctx.dim, ctx.size = [], dim, xs[0].shape[dim]
        out = []
        for r, x in zip(mesh.local_ranks(), xs):
            g = _group(mesh, axis, r)
            ctx.pos.append(g.index(r))
            out.append(torch.cat([every[q].to(x.device) for q in g], dim))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + tuple(
            g.narrow(ctx.dim, p * ctx.size, ctx.size)
            for g, p in zip(grads, ctx.pos))


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh, axis: str = "model",
               dim: int = 1) -> List[torch.Tensor]:
    """For each local rank, its ranks' tensors along ``axis`` concatenated
    on ``dim`` in rank order; the backward is the rank's own slice."""
    return list(_AllGather.apply(mesh, axis, dim, *xs))


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(_sum(ctx.mesh, ctx.axis, grads))


def reduce_grad(xs: Sequence[torch.Tensor], mesh: Mesh,
                axis: str = "model") -> List[torch.Tensor]:
    """The identity; the backward sums the gradient over ``axis``."""
    return list(_ReduceGrad.apply(mesh, axis, *xs))


def ppermute(bufs: Sequence, shift: int, mesh: Mesh, axis: str = "data",
             at: int = 0) -> list:
    """One hop along ``axis``: rank ``i`` gets rank ``(i - shift) mod n``'s
    buffer.  ``bufs`` holds every rank of the axis, ``None`` where another
    process holds it; the result likewise."""
    return ring_shift_plain(bufs, shift, span=mesh.span(axis, at))
