"""The rank mesh of the multi-rank runtime (``unmicst_tpu/runtime/mesh.py``).

One process drives every rank, as JAX's single controller does.  A
:class:`Mesh` is an ordered list of rank devices along the ``"data"``
axis; each rank's work runs on its device.  A device may appear more than
once: ranks then share that card (or the CPU), which is how the CPU tests
hold a ring of 8 and ``chip_smoke.py`` a ring of 4 on one card.  On
distinct cards the mesh enables peer access when it is built, so the ring
kernels (``kernels/halo_ring.py``) store straight into the neighbour's
memory, and it raises where the hardware cannot.

Tensor parallelism over a ``"model"`` axis, parameter sharding and the
multi-process bring-up wait for ROADMAP M10/M13.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from unmicst_tpu_torch.runtime.devices import Device, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Rank devices along ``"data"`` (the ``"model"`` axis has size 1)."""

    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": 1}

    def ranks(self, axis: str = "data") -> Tuple[torch.device, ...]:
        """The devices along ``axis`` (only ``"data"`` holds a ring)."""
        if axis != "data":
            raise ValueError(f"the mesh's ring axis is 'data', not {axis!r}")
        return self.devices


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[Device]] = None) -> Mesh:
    """A ``(data, 1)`` mesh over ``devices`` (default: every visible card).

    ``data=None`` takes every device given.  ``model`` must be 1: tensor
    parallelism is not ported yet (ROADMAP M13)."""
    if model != 1:
        if model < 1:
            raise ValueError(f"model axis must be >= 1, got {model}")
        raise NotImplementedError(
            "a model axis above 1 (tensor parallelism) is not ported to "
            "unmicst_tpu_torch yet (ROADMAP M13)"
        )
    if devices is None:
        resolve_device("cuda")  # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    n = len(devs)
    data = n if data is None else data
    if data < 1:
        raise ValueError(f"data axis must be >= 1, got {data}")
    if data > n:
        raise ValueError(f"mesh {data}x1 exceeds {n} devices")
    devs = devs[:data]
    if {d.type for d in devs} == {"cuda"} and len(set(devs)) > 1:
        from unmicst_tpu_torch.kernels.halo_ring import enable_peer_access

        enable_peer_access(devs)
    elif len({d.type for d in devs}) > 1:
        raise ValueError("a mesh's ranks must all be cards or all the CPU")
    return Mesh(tuple(devs))
