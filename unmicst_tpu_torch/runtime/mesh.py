"""The rank mesh of the multi-rank runtime (``unmicst_tpu/runtime/mesh.py``).

A :class:`Mesh` is a ``(data, model)`` grid of ranks, ``model``
innermost: rank ``r`` sits at ``(r // model, r % model)``.  Each rank has
a device, and a device may appear more than once: ranks then share that
card (or the CPU), which is how the CPU tests hold a ring of 8 and
``chip_smoke.py`` a ring of 4 on one card.  On distinct cards of one
process the mesh enables peer access when it is built, so the ring kernels
(``kernels/halo_ring.py``) store straight into the neighbour's memory, and
it raises where the hardware cannot.

Processes: :func:`initialize_distributed` joins a ``torch.distributed``
job (``tcp://`` with an explicit world size and rank, or torchrun's
environment); :func:`make_mesh` then spans every process's local ranks in
process order, so the ranks of one process are contiguous.  Each process
runs only its own ranks' work and meets the others in the collectives of
``runtime/collectives.py``.  The backend follows the ranks: NCCL when
every process drives a card of its own, gloo for CPU ranks and for
processes that share a card (NCCL refuses two ranks on one GPU).

Placement: :func:`data_sharding` splits a batch over ``data`` in
contiguous equal slices (JAX's ``P("data")``), and :func:`shard_params` /
:func:`put_params` split the wide parameters over ``model`` (tensor
parallelism), JAX's rule in the port's layouts.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from unmicst_tpu_torch.kernels.halo_ring import (RingSpan, close_rings,
                                                 enable_peer_access)
from unmicst_tpu_torch.runtime.devices import Device, resolve_device

State = Dict[str, torch.Tensor]
AXES = ("data", "model")
DEFAULT_TIMEOUT_S = 300.0


# -- processes ------------------------------------------------------------------


def _card_uuid(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    return str(getattr(props, "uuid", None) or props.pci_bus_id)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           device: Device = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the job of ``num_processes`` processes as ``process_id``, its
    coordinator at ``coordinator`` (``"host:port"``, process 0 listens).

    ``num_processes == 1`` is the only no-op, as in JAX.  With no
    arguments the job comes from torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` picks the
    card).  ``device``: the card this process drives (default: ``cuda``,
    the ``LOCAL_RANK``-th card under torchrun; raises without a card) or
    ``"cpu"``.  ``backend=None`` takes ``"nccl"`` for a card and
    ``"gloo"`` for the CPU.  NCCL refuses two ranks on one GPU, so
    processes that share a card name ``backend="gloo"`` themselves; with
    ``"nccl"`` the processes' cards are compared first and a shared card
    raises.  The backend is never switched quietly."""
    if num_processes == 1:
        return
    given = (coordinator, num_processes, process_id)
    if all(v is None for v in given):
        env = os.environ
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                               "RANK") if k not in env]
        if missing:
            raise ValueError(f"no coordinator given and torchrun's "
                             f"environment lacks {missing}")
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
        if device is None and backend != "gloo" and "LOCAL_RANK" in env:
            device = f"cuda:{int(env['LOCAL_RANK'])}"
    elif any(v is None for v in given):
        raise ValueError("give coordinator, num_processes and process_id "
                         "together, or none of them (torchrun's environment)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside 0..{num_processes}")
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    dev = None if (device is None and backend == "gloo") else \
        resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and (dev is None or dev.type != "cuda"):
        raise ValueError("the NCCL backend drives cards; CPU ranks take "
                         "backend='gloo'")
    if dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)
    host, port = coordinator.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), num_processes, process_id == 0,
                          timeout=timeout)
    if backend == "nccl":
        store.set(f"unmicst/card/{process_id}", _card_uuid(dev))
        cards = [store.get(f"unmicst/card/{p}").decode()
                 for p in range(num_processes)]
        shared = [p for p in range(num_processes)
                  if cards.index(cards[p]) != p]
        if shared:
            raise ValueError(
                f"processes {shared} drive a card another process drives: "
                "NCCL refuses two ranks on one GPU; processes that share a "
                "card name backend='gloo'")
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)


def is_multi_process() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def shutdown_distributed() -> None:
    """Close the ring kernels' shared allocations (every process at once),
    then leave the job.  No-op outside one."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    close_rings(barrier=dist.barrier)
    dist.destroy_process_group()


def process_allgather(t: torch.Tensor, tiled: bool = True) -> torch.Tensor:
    """``jax.experimental.multihost_utils.process_allgather``: every
    process's ``t`` (one shape), concatenated along dimension 0 in process
    order (``tiled``) or stacked on a new one, as a host tensor.  Over
    NCCL the gather runs on this process's card; gloo gathers host
    copies."""
    if not is_multi_process():
        return t.detach().cpu() if tiled else t.detach().cpu()[None]
    x = t.detach().contiguous()
    x = x.cpu() if dist.get_backend() == "gloo" else x.cuda()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    parts = [p.cpu() for p in parts]
    return torch.cat(parts, 0) if tiled else torch.stack(parts)


# -- the mesh -------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of ranks: ``devices[r]`` is rank ``r``'s
    device (in its own process's numbering), ``procs[r]`` its process
    (empty: every rank is in this one), ``process`` this process's index
    and ``backend`` the job's (None in one process)."""

    devices: Tuple[torch.device, ...]
    model: int = 1
    procs: Tuple[int, ...] = ()
    process: int = 0
    backend: Optional[str] = None

    @property
    def data(self) -> int:
        return len(self.devices) // self.model

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def multi_process(self) -> bool:
        return len(set(self.procs)) > 1

    def process_index(self, rank: int) -> int:
        return self.procs[rank] if self.procs else self.process

    def local_ranks(self) -> Tuple[int, ...]:
        """This process's ranks, in rank order."""
        return tuple(r for r in range(len(self.devices))
                     if self.process_index(r) == self.process)

    def coords(self, rank: int) -> Tuple[int, int]:
        """``(data index, model index)`` of ``rank``."""
        return divmod(rank, self.model)

    def rank_ids(self, axis: str = "data", at: int = 0) -> Tuple[int, ...]:
        """The ranks along ``axis`` at index ``at`` of the other axis."""
        if axis == "data":
            return tuple(d * self.model + at for d in range(self.data))
        if axis == "model":
            return tuple(at * self.model + m for m in range(self.model))
        raise ValueError(f"a mesh's axes are {AXES}, not {axis!r}")

    def ranks(self, axis: str = "data", at: int = 0
              ) -> Tuple[torch.device, ...]:
        """The devices of :meth:`rank_ids`."""
        return tuple(self.devices[r] for r in self.rank_ids(axis, at))

    def span(self, axis: str = "data", at: int = 0):
        """The ring of :meth:`rank_ids` for ``kernels.halo_ring``: each
        rank's card and process."""
        ids = self.rank_ids(axis, at)
        return RingSpan(
            cards=tuple(self.devices[r].index if self.devices[r].type
                        == "cuda" else None for r in ids),
            procs=tuple(self.process_index(r) for r in ids),
            me=self.process, backend=self.backend)


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[Device]] = None) -> Mesh:
    """A ``(data, model)`` mesh, ``model`` innermost.

    ``devices``: this process's rank devices (default: every visible card
    in one process; this process's current card in a job of several).
    In a job of several processes the mesh spans every process's ranks
    in process order: each process gives as many, and the grid takes
    them all.  ``data=None`` takes every rank not claimed by ``model``."""
    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
    multi = is_multi_process()
    if devices is None:
        resolve_device("cuda")  # raises without a card
        devices = ([torch.device("cuda", torch.cuda.current_device())]
                   if multi else [torch.device("cuda", i)
                                  for i in range(torch.cuda.device_count())])
    devs = [resolve_device(d) for d in devices]
    if len({d.type for d in devs}) > 1:
        raise ValueError("a mesh's ranks must all be cards or all the CPU")
    procs: Tuple[int, ...] = ()
    me, backend = 0, None
    if multi:
        me, backend = dist.get_rank(), dist.get_backend()
        per = [None] * dist.get_world_size()
        dist.all_gather_object(per, [str(d) for d in devs])
        if len({len(p) for p in per}) != 1:
            raise ValueError(f"every process must give as many ranks: "
                             f"{[len(p) for p in per]}")
        types = {torch.device(d).type for p in per for d in p}
        if backend == "nccl" and types != {"cuda"}:
            raise ValueError("the NCCL backend serves cards only; CPU ranks "
                             "take backend='gloo'")
        if len(types) > 1:
            raise ValueError("a mesh's ranks must all be cards or all the CPU")
        procs = tuple(p for p, ds in enumerate(per) for _ in ds)
        all_devs = [torch.device(d) for p in per for d in p]
        n = len(all_devs)
        if data is None:
            if n % model:
                raise ValueError(f"{n} ranks not divisible by model={model}")
            data = n // model
        if data * model != n:
            raise ValueError(f"a mesh across processes takes every rank: "
                             f"{data}x{model} against {n}")
        devs = all_devs
    else:
        n = len(devs)
        if data is None:
            if n % model:
                raise ValueError(f"{n} devices not divisible by model={model}")
            data = n // model
        if data < 1:
            raise ValueError(f"data axis must be >= 1, got {data}")
        if data * model > n:
            raise ValueError(f"mesh {data}x{model} exceeds {n} devices")
        devs = devs[: data * model]
    mesh = Mesh(tuple(devs), model, procs, me, backend)
    local = [mesh.devices[r] for r in mesh.local_ranks()]
    if {d.type for d in local} == {"cuda"} and len(set(local)) > 1:
        enable_peer_access(local)
    return mesh


# -- placement ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DataSharding:
    """The batch split over ``data``: contiguous equal slices in rank
    order (JAX's ``NamedSharding(mesh, P("data"))``), replicated over
    ``model``."""

    mesh: Mesh

    def bounds(self, n: int, rank: int) -> Tuple[int, int]:
        d = self.mesh.data
        if n % d:
            raise ValueError(f"a batch of {n} does not split over data={d}")
        i = self.mesh.coords(rank)[0]
        return i * (n // d), (i + 1) * (n // d)

    def local(self, t: torch.Tensor) -> List[torch.Tensor]:
        """This process's ranks' slices of ``t`` (dimension 0), each on
        its rank's device."""
        out = []
        for r in self.mesh.local_ranks():
            a, b = self.bounds(t.shape[0], r)
            out.append(t[a:b].to(self.mesh.devices[r]))
        return out


def data_sharding(mesh: Mesh) -> DataSharding:
    return DataSharding(mesh)


def shard_params(state: State, mesh: Mesh, tp_threshold: int = 256
                 ) -> Dict[str, Optional[int]]:
    """The dimension of each parameter split over ``model``, or None for a
    replicated one: JAX's rule (``unmicst_tpu/runtime/mesh.py:100-135``)
    in the port's layouts.  Output channels: dimension 0 of an OIHW
    kernel, dimension 1 of a transposed ``up.*.kernel1`` (``[w_in, w_out,
    ks, ks]``), dimension 0 of a 1-D BN vector; split only where that
    dimension is at least ``tp_threshold`` and divisible by ``model``."""
    tp = mesh.model
    spec: Dict[str, Optional[int]] = {}
    for name, t in state.items():
        dim = None
        if t.dim() == 4:
            dim = 1 if (name.startswith("up.")
                        and name.endswith(".kernel1")) else 0
        elif t.dim() == 1:
            dim = 0
        if (tp > 1 and dim is not None and t.shape[dim] >= tp_threshold
                and t.shape[dim] % tp == 0):
            spec[name] = dim
        else:
            spec[name] = None
    return spec


def shard_state(state: State, spec: Dict[str, Optional[int]], mesh: Mesh
                ) -> List[State]:
    """Each local rank's part of ``state`` under ``spec``, on its device
    (copies: the ranks never share storage)."""
    out = []
    for r in mesh.local_ranks():
        m = mesh.coords(r)[1]
        dev = mesh.devices[r]
        part = {}
        for name, t in state.items():
            dim = spec.get(name)
            if dim is not None:
                t = t.chunk(mesh.model, dim)[m]
            part[name] = t.detach().to(dev, copy=True).contiguous()
        out.append(part)
    return out


def put_params(state: State, mesh: Mesh, tp_threshold: int = 256
               ) -> List[State]:
    """``state`` placed on the mesh: each local rank's shards (under
    :func:`shard_params`) on its rank's device, in ``local_ranks`` order."""
    return shard_state(state, shard_params(state, mesh, tp_threshold), mesh)


def gather_state(parts: Sequence[State], spec: Dict[str, Optional[int]],
                 mesh: Mesh, device: Device = "cpu") -> State:
    """The inverse of :func:`shard_state`: the whole state from the local
    ranks' ``parts`` (and the other processes', a collective then), on
    ``device``.  Replicated tensors are rank 0's."""
    local = mesh.local_ranks()
    dev = torch.device(device)
    out = {}
    for name in parts[0]:
        if mesh.multi_process:
            stacked = torch.stack([p[name].detach() for p in parts])
            every = process_allgather(stacked)  # [ranks, ...] in rank order
            pick = lambda r: every[r]  # noqa: E731
        else:
            pick = lambda r: parts[local.index(r)][name].detach()  # noqa: E731
        dim = spec.get(name)
        if dim is None:
            out[name] = pick(0).to(dev, copy=True)
        else:
            out[name] = torch.cat([pick(r).to(dev) for r in
                                   mesh.rank_ids("model", 0)], dim)
    return out
