"""K3/K4a/K4b: one-hop ring shift of the halo runtime's seam buffers.

The port of the TPU kernels in ``unmicst_tpu/kernels/halo_rdma.py``:
``ring_shift`` (K3, ``:80``), ``ring_shift_start`` (K4a, ``:198``) and
``ring_shift_wait`` (K4b, ``:236``).  A ring is a list of tensors, one per
rank, each on its rank's device (ranks may share a card).  Semantics are
``ppermute``'s: rank ``i`` receives the buffer of rank ``(i - shift) mod n``.
CUDA source: ``unmicst_tpu_torch/csrc/halo_ring.cu``.

* :func:`ring_shift` (K3) issues every rank's store, then every rank's
  wait: the synchronous hop.
* :func:`ring_shift_start` (K4a) issues the stores on a side stream per
  source card, after the producer of each buffer; it returns a handle.
* :func:`ring_shift_wait` (K4b) issues the waits on the destination ranks'
  current streams and returns the landing buffers.  Work issued between
  the two calls overlaps the hop.

Ordering: in JAX an entry barrier keeps a chip from writing a landing
buffer its neighbour has not allocated yet.  In one process every landing
buffer is allocated before any store, so the barrier becomes stream order:
each store runs after its own producer (its stream) and after the point
where its landing buffer became free on the destination's stream (an
event).  All stores of a hop are issued before any wait, so ranks that
share one stream never wait on work queued behind them.  Completion is a
flag word per (hop kind, destination, source) that the store's last block
releases with a growing epoch and the wait acquires; see the CUDA source.
A wait that never sees its epoch traps after :data:`WAIT_TIMEOUT_S`, and
the fault surfaces as a CUDA error at the next synchronisation.

CUDA tensors run the kernels (or raise); CPU tensors take the plain
versions (:func:`ring_shift_plain` and the start/wait pair built on it,
which does the whole hop at start, as JAX's interpret mode does).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from unmicst_tpu_torch.kernels import _build

WAIT_TIMEOUT_S = 20.0
# one flag word per hop kind (JAX's collective_ids 7, 9 and 8)
KINDS = {"input": 0, "output": 1, "start": 2}

_P, _LL, _I, _U, _ULL = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_uint, ctypes.c_ulonglong)
_SIGNATURES = {
    "ring_store": [_P, _P, _LL, _P, _P, _U, _I, _P],
    "ring_wait": [_P, _U, _ULL, _I, _P],
    "ring_enable_peer": [_I, _I],
}


def _lib():
    return _build.load("halo_ring", _SIGNATURES)


def _raise(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


def enable_peer_access(devices: Sequence[torch.device]) -> None:
    """Let every pair of distinct cards in ``devices`` store into each
    other's memory; raise where the hardware says it cannot."""
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    for a in cards:
        for b in cards:
            if a == b:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(
                    f"cuda:{a} cannot access cuda:{b} as a peer: the ring "
                    "kernels store straight into the neighbour's memory "
                    "and do not stage through the host"
                )
            _raise(_lib().ring_enable_peer(a, b),
                   f"enabling peer access cuda:{a} -> cuda:{b}")


class _Ring:
    """Flag words, store tickets, epochs and side streams of one ring (one
    ordered tuple of rank devices)."""

    def __init__(self, devices: Tuple[torch.device, ...]):
        enable_peer_access(devices)
        n = len(devices)
        self.devices = devices
        # words[i][kind, j]: the last epoch rank j stored into rank i;
        # words[i][kind, n]: rank i's store tickets
        self.words = []
        for d in devices:
            with torch.cuda.device(d):
                self.words.append(torch.zeros((len(KINDS), n + 1),
                                              dtype=torch.int32, device=d))
                torch.cuda.synchronize(d)
        self.epochs: Dict[Tuple[int, int, int], int] = {}
        self.side: Dict[int, torch.cuda.Stream] = {}

    def flag(self, kind: int, dst: int, src: int) -> int:
        n = len(self.devices)
        return self.words[dst].data_ptr() + 4 * (kind * (n + 1) + src)

    def tickets(self, kind: int, src: int) -> int:
        n = len(self.devices)
        return self.words[src].data_ptr() + 4 * (kind * (n + 1) + n)

    def next_epoch(self, kind: int, dst: int, src: int) -> int:
        e = self.epochs.get((kind, dst, src), 0) + 1
        self.epochs[(kind, dst, src)] = e
        return e & 0xFFFFFFFF

    def side_stream(self, device: torch.device) -> torch.cuda.Stream:
        s = self.side.get(device.index)
        if s is None:
            s = self.side[device.index] = torch.cuda.Stream(device=device)
        return s


_rings: Dict[tuple, _Ring] = {}


def _ring(devices: Tuple[torch.device, ...]) -> _Ring:
    ring = _rings.get(devices)
    if ring is None:
        ring = _rings[devices] = _Ring(devices)
    return ring


def _check(xs: Sequence[torch.Tensor], shift: int) -> bool:
    """Validate a ring; True when it lies on CUDA devices."""
    if not xs:
        raise ValueError("a ring needs at least one rank")
    if not isinstance(shift, int):
        raise TypeError(f"shift must be an int, got {shift!r}")
    x0 = xs[0]
    cuda = [x.is_cuda for x in xs]
    if any(cuda) and not all(cuda):
        raise ValueError("a ring's buffers must all be on CUDA devices or "
                         "all on the CPU")
    for x in xs:
        if x.shape != x0.shape or x.dtype != x0.dtype:
            raise ValueError(
                f"ring buffers differ: {tuple(x.shape)} {x.dtype} against "
                f"{tuple(x0.shape)} {x0.dtype}"
            )
        if not x.is_contiguous():
            raise ValueError("ring buffers must be contiguous")
    return all(cuda)


def _kind(kind: str) -> int:
    if kind not in KINDS:
        raise ValueError(f"hop kind must be one of {sorted(KINDS)}, got "
                         f"{kind!r}")
    return KINDS[kind]


def ring_shift_plain(xs: Sequence[torch.Tensor], shift: int = 1
                     ) -> List[torch.Tensor]:
    """``[xs[(i - shift) % n]`` copied to rank ``i``'s device ``]``."""
    n = len(xs)
    return [xs[(i - shift) % n].to(xs[i].device, copy=True) for i in range(n)]


class RingShiftHandle(NamedTuple):
    """A hop in flight: the landing buffers and what their waits expect."""

    bufs: List[torch.Tensor]
    kind: int
    shift: int
    epochs: List[int]
    plain: bool


def _stores(xs, shift: int, kind: int, side: bool) -> RingShiftHandle:
    """Allocate every landing buffer, then issue every rank's store."""
    n = len(xs)
    devices = tuple(x.device for x in xs)
    ring = _ring(devices)
    lib = _lib()
    bufs, dst_streams = [], []
    for i in range(n):
        with torch.cuda.device(devices[i]):
            bufs.append(torch.empty(xs[0].shape, dtype=xs[0].dtype,
                                    device=devices[i]))
            dst_streams.append(torch.cuda.current_stream())
    epochs = [0] * n
    nbytes = xs[0].numel() * xs[0].element_size()
    for j in range(n):
        i = (j + shift) % n  # j's destination
        dev = devices[j]
        with torch.cuda.device(dev):
            cur = torch.cuda.current_stream()
            stream = ring.side_stream(dev) if side else cur
            if side:
                stream.wait_stream(cur)  # the producer of xs[j]
            if dst_streams[i] != stream:
                # the landing buffer is free from here on rank i's stream
                stream.wait_event(dst_streams[i].record_event())
            epochs[i] = ring.next_epoch(kind, i, j)
            rc = lib.ring_store(
                xs[j].data_ptr(), bufs[i].data_ptr(), nbytes,
                ring.tickets(kind, j), ring.flag(kind, i, j), epochs[i],
                dev.index, stream.cuda_stream,
            )
            if side:  # both tensors are in use on the side stream
                xs[j].record_stream(stream)
                bufs[i].record_stream(stream)
        _raise(rc, "ring_store launch")
    return RingShiftHandle(bufs, kind, shift, epochs, False)


def _waits(handle: RingShiftHandle) -> List[torch.Tensor]:
    n = len(handle.bufs)
    devices = tuple(b.device for b in handle.bufs)
    ring = _ring(devices)
    lib = _lib()
    timeout_ns = int(WAIT_TIMEOUT_S * 1e9)
    for i in range(n):
        src = (i - handle.shift) % n
        with torch.cuda.device(devices[i]):
            rc = lib.ring_wait(
                ring.flag(handle.kind, i, src), handle.epochs[i], timeout_ns,
                devices[i].index, torch.cuda.current_stream().cuda_stream,
            )
        _raise(rc, "ring_wait launch")
    return handle.bufs


def ring_shift(xs: Sequence[torch.Tensor], shift: int = 1, *,
               kind: str = "input") -> List[torch.Tensor]:
    """K3: rank ``i`` gets rank ``(i - shift) mod n``'s buffer.

    ``kind`` names the hop's flag words (``"input"`` or ``"output"``
    halo); hops of different kinds never release each other's waits."""
    k = _kind(kind)
    if not _check(xs, shift):
        return ring_shift_plain(xs, shift)
    handle = _stores(list(xs), shift, k, side=False)
    ring_shift.launches += len(xs)
    return _waits(handle)


ring_shift.launches = 0


def ring_shift_start(xs: Sequence[torch.Tensor], shift: int = 1, *,
                     kind: str = "start") -> RingShiftHandle:
    """K4a: start the hop on side streams; redeem the handle with
    :func:`ring_shift_wait`.  On the CPU the whole hop runs here."""
    k = _kind(kind)
    if not _check(xs, shift):
        return RingShiftHandle(ring_shift_plain(xs, shift), k, shift,
                               [0] * len(xs), True)
    handle = _stores(list(xs), shift, k, side=True)
    ring_shift_start.launches += len(xs)
    return handle


ring_shift_start.launches = 0


def ring_shift_wait(handle: RingShiftHandle) -> List[torch.Tensor]:
    """K4b: make each destination rank's current stream wait until its
    landing buffer is filled; returns the landing buffers."""
    if handle.plain:
        return handle.bufs
    out = _waits(handle)
    ring_shift_wait.launches += len(handle.bufs)
    return out


ring_shift_wait.launches = 0
