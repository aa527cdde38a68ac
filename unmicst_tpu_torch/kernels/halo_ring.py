"""K3/K4a/K4b: one-hop ring shift of the halo runtime's seam buffers.

The port of the TPU kernels in ``unmicst_tpu/kernels/halo_rdma.py``:
``ring_shift`` (K3, ``:80``), ``ring_shift_start`` (K4a, ``:198``) and
``ring_shift_wait`` (K4b, ``:236``).  A ring is a list of tensors, one per
rank, each on its rank's device (ranks may share a card).  Semantics are
``ppermute``'s: rank ``i`` receives the buffer of rank ``(i - shift) mod n``.
CUDA source: ``unmicst_tpu_torch/csrc/halo_ring.cu``.

* :func:`ring_shift` (K3) issues the hop's stores, then its waits: the
  synchronous hop.
* :func:`ring_shift_start` (K4a) issues the stores on a side stream per
  source card, after the producer of each buffer; it returns a handle.
* :func:`ring_shift_wait` (K4b) issues the waits on the destination cards'
  current streams, the ones the hop was planned for, and returns the
  landing buffers.  Work issued between the two calls overlaps the hop.

A hop is planned by :func:`hop_plan`, a pure function of the ranks' cards
and streams: ONE store launch per source card (split above
:data:`MAX_SEGMENTS` ranks), covering one segment per source rank, and one
wait launch per destination card, covering the segments whose landing
buffer is read on another stream than the one that stores it.  Where the
two streams are one (K3 with its ranks on one card), stream order
publishes the landing buffer and no wait is launched.  A hop's wait
launches are prepared when its stores are issued (a table of words,
targets, cards and streams) and go out in one call, ``ring_wait_all``.

Ordering: in JAX an entry barrier keeps a chip from writing a landing
buffer its neighbour has not allocated yet.  In one process every landing
buffer is allocated before any store, so the barrier becomes stream order:
each store runs after its own producer (its card's current stream, or the
side stream joined to it) and after the point where its landing buffer
became free on the destination's stream (an event, for a destination on
another card).  All stores of a hop are issued before any wait, so ranks
that share one stream never wait on work queued behind them.  Completion
is a word per (hop kind, destination, source) to which every block of the
segment adds 1 (release); a wait acquires it until it reaches its target,
the count of blocks the word has been sent after this hop (see the CUDA
source).  A wait that never sees its target traps after
:data:`WAIT_TIMEOUT_S`, and the fault surfaces as a CUDA error at the next
synchronisation.

The landing buffers of one card are slots of one allocation, each on a
:data:`SLOT_ALIGN`-byte boundary.

CUDA tensors run the kernels (or raise); CPU tensors take the plain
versions (:func:`ring_shift_plain` and the start/wait pair built on it,
which does the whole hop at start, as JAX's interpret mode does).
"""

from __future__ import annotations

import ctypes
from typing import (Callable, Dict, Hashable, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from unmicst_tpu_torch.kernels import _build

WAIT_TIMEOUT_S = 20.0
# one completion word per hop kind (JAX's collective_ids 7, 9 and 8)
KINDS = {"input": 0, "output": 1, "start": 2}

# the limits and launch shape of csrc/halo_ring.cu
MAX_SEGMENTS = 32  # segments per store launch (kMaxSegments)
MAX_WAITS = 32  # words per wait launch, one lane each (kMaxWaits)
BLOCK_BYTES = 256 * 4 * 16  # one block's pass: kThreads x kUnroll x 16 B
SMS = 132  # streaming multiprocessors of an H100
BLOCKS_PER_SM = 4  # a store launch's cap on resident blocks
SLOT_ALIGN = 256  # bytes: every landing slot starts on this boundary
_WORD = 1 << 32


class _Segment(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("word", ctypes.c_void_p), ("sys", ctypes.c_int),
                ("pad", ctypes.c_int)]


class _StoreArgs(ctypes.Structure):
    _fields_ = [("seg", _Segment * MAX_SEGMENTS), ("nbytes", ctypes.c_longlong),
                ("nseg", ctypes.c_int), ("blocks", ctypes.c_int)]


class _WaitEntry(ctypes.Structure):
    _fields_ = [("word", ctypes.c_void_p), ("target", ctypes.c_uint),
                ("sys", ctypes.c_int)]


class _WaitArgs(ctypes.Structure):
    _fields_ = [("entry", _WaitEntry * MAX_WAITS), ("n", ctypes.c_int),
                ("pad", ctypes.c_int), ("timeout_ns", ctypes.c_ulonglong)]


class _WaitLaunch(ctypes.Structure):
    _fields_ = [("args", _WaitArgs), ("stream", ctypes.c_void_p),
                ("device", ctypes.c_int), ("pad", ctypes.c_int)]


_SIGNATURES = {
    "ring_store": [ctypes.POINTER(_StoreArgs), ctypes.c_int, ctypes.c_void_p],
    "ring_wait_all": [ctypes.c_void_p, ctypes.c_int],  # WaitLaunch[n]
    "ring_enable_peer": [ctypes.c_int, ctypes.c_int],
}


def _lib():
    return _build.load("halo_ring", _SIGNATURES)


def _raise(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


# -- the plan: pure Python, pinned by tests/test_torch_ring_plan.py -------------


def blocks_per_segment(nbytes: int, nseg: int) -> int:
    """B: one block per :data:`BLOCK_BYTES` of a segment, capped so that a
    launch of ``nseg`` segments stays within :data:`BLOCKS_PER_SM` blocks
    on each of the card's SMs."""
    cap = -(-BLOCKS_PER_SM * SMS // nseg)
    return max(1, min(-(-nbytes // BLOCK_BYTES), cap))


def slot_layout(nbytes: int, count: int) -> Tuple[int, List[int]]:
    """(allocation bytes, slot byte offsets) of ``count`` landing buffers
    of ``nbytes`` each in one allocation, every slot on a
    :data:`SLOT_ALIGN` boundary."""
    stride = -(-nbytes // SLOT_ALIGN) * SLOT_ALIGN
    return stride * count, [k * stride for k in range(count)]


class StoreLaunch(NamedTuple):
    """One ``ring_store`` launch: segments ``(src rank, dst rank)`` of one
    source card on one stream, ``blocks`` blocks each; ``signal[k]``: the
    segment's destination waits on its word (else stream order suffices)."""

    card: Hashable
    stream: Hashable
    segments: Tuple[Tuple[int, int], ...]
    blocks: int
    signal: Tuple[bool, ...]


class WaitLaunch(NamedTuple):
    """One wait launch on a destination card's stream: the words
    ``(dst rank, src rank)`` it acquires."""

    card: Hashable
    words: Tuple[Tuple[int, int], ...]


class HopPlan(NamedTuple):
    stores: Tuple[StoreLaunch, ...]
    waits: Tuple[WaitLaunch, ...]
    # (source card, destination card): the source's store stream waits
    # for an event on the destination's stream (its landing buffer is free)
    events: Tuple[Tuple[Hashable, Hashable], ...]


def hop_plan(cards: Sequence[Hashable], shift: int, nbytes: int,
             store_streams: Dict[Hashable, Hashable],
             dst_streams: Dict[Hashable, Hashable]) -> HopPlan:
    """The launches of one hop of the ring whose rank ``j`` lives on
    ``cards[j]``.  ``store_streams[c]``: where card ``c``'s stores run;
    it runs after ``dst_streams[c]``, card ``c``'s current stream (it is
    that stream, or a side stream joined to it).  ``dst_streams[c]``: the
    stream on which card ``c`` reads its landing buffers."""
    n = len(cards)
    groups: Dict[Hashable, List[Tuple[int, int]]] = {}
    for j in range(n):
        groups.setdefault(cards[j], []).append((j, (j + shift) % n))
    stores, events = [], []
    waits: Dict[Hashable, List[Tuple[int, int]]] = {}
    for card, segs in groups.items():
        stream = store_streams[card]
        for k in range(0, len(segs), MAX_SEGMENTS):
            part = tuple(segs[k : k + MAX_SEGMENTS])
            signal = tuple(dst_streams[cards[i]] != stream for _, i in part)
            stores.append(StoreLaunch(card, stream, part,
                                      blocks_per_segment(nbytes, len(part)),
                                      signal))
            for (j, i), s in zip(part, signal):
                if s:
                    waits.setdefault(cards[i], []).append((i, j))
        for d in dict.fromkeys(cards[i] for _, i in segs):
            if dst_streams[d] not in (stream, dst_streams[card]):
                events.append((card, d))
    return HopPlan(
        tuple(stores),
        tuple(WaitLaunch(card, tuple(words[k : k + MAX_WAITS]))
              for card, words in waits.items()
              for k in range(0, len(words), MAX_WAITS)),
        tuple(events),
    )


class Counters:
    """The host's copy of the completion words: each ``(kind, dst, src)``
    word counts, modulo 2^32, the blocks that have added to it."""

    def __init__(self):
        self.value: Dict[Tuple[int, int, int], int] = {}

    def advance(self, key: Tuple[int, int, int], blocks: int) -> int:
        """Count one hop of ``blocks`` blocks into ``key``; its target."""
        v = (self.value.get(key, 0) + blocks) % _WORD
        self.value[key] = v
        return v


# -- the ring's device state and its cached launches ----------------------------


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


class _Program:
    """One hop plan turned into launch arguments that stay fixed from hop
    to hop: the store tables with their words (the buffer pointers are
    filled per hop), the wait table with its words, cards and streams (the
    targets are filled per hop), and the landing slots.  ``dst``: each
    card's current stream, where its waits go."""

    def __init__(self, ring: "_Ring", plan: HopPlan, kind: int,
                 x0: torch.Tensor, dst: Dict[int, torch.cuda.Stream]):
        cards = ring.cards
        nbytes, size = x0.numel() * x0.element_size(), x0.element_size()
        self.plan = plan
        # the landing slots: per card, elements of its one allocation; per
        # rank, its slot's byte offset
        self.slab_elems, self.offset = {}, [0] * len(cards)
        for c, ranks in ring.ranks_on.items():
            total, offsets = slot_layout(nbytes, len(ranks))
            self.slab_elems[c] = total // size
            for i, o in zip(ranks, offsets):
                self.offset[i] = o
        strides, step = [], 1  # contiguous strides of the landing buffers
        for s in reversed(x0.shape):
            strides.append(step)
            step *= s
        self.strides = tuple(reversed(strides))
        # (source card, destination card) pairs of the store launches
        self.crossing = tuple(dict.fromkeys(
            (launch.card, cards[i]) for launch in plan.stores
            for _, i in launch.segments))
        self.stores = []  # (card, args, [(segment struct, src, dst)])
        keys = {}  # (dst, src) -> (word key, blocks) of signalled segments
        for launch in plan.stores:
            args = _StoreArgs(nbytes=nbytes, nseg=len(launch.segments),
                              blocks=launch.blocks)
            fill = []
            for k, ((j, i), s) in enumerate(zip(launch.segments,
                                                launch.signal)):
                seg = args.seg[k]
                if s:
                    seg.word = ring.word(kind, i, j)
                    seg.sys = int(cards[i] != cards[j])
                    keys[(i, j)] = ((kind, i, j), launch.blocks)
                fill.append((seg, j, i))
            self.stores.append((launch.card, args, fill))
        # the wait table, and per launch its words' (key, blocks)
        self.wait_table = (_WaitLaunch * len(plan.waits))()
        self.wait_keys = []
        for w, launch in zip(self.wait_table, plan.waits):
            w.args.n = len(launch.words)
            w.args.timeout_ns = int(WAIT_TIMEOUT_S * 1e9)
            for k, (i, j) in enumerate(launch.words):
                w.args.entry[k].word = ring.word(kind, i, j)
                w.args.entry[k].sys = int(cards[i] != cards[j])
            w.stream = dst[launch.card].cuda_stream
            w.device = launch.card
            self.wait_keys.append([keys[wd] for wd in launch.words])
        # (card, stream id) of the streams the waits were planned for
        self.wait_streams = tuple((c, dst[c].stream_id) for c in
                                  dict.fromkeys(w.card for w in plan.waits))


class _Ring:
    """Completion words, counters, side streams and cached hop programs of
    one ring (one ordered tuple of rank cards)."""

    def __init__(self, cards: Tuple[int, ...]):
        enable_peer_access([torch.device("cuda", c) for c in cards])
        n = len(cards)
        self.cards = cards
        self.ranks_on: Dict[int, List[int]] = {}
        for i, c in enumerate(cards):
            self.ranks_on.setdefault(c, []).append(i)
        self.counters = Counters()
        # words[i][kind, j]: the blocks rank j has added into rank i's word
        self.words = [torch.zeros((len(KINDS), n), dtype=torch.int32,
                                  device=c) for c in cards]
        for c in self.ranks_on:
            torch.cuda.synchronize(c)
        self.side: Dict[int, torch.cuda.Stream] = {}
        self.events: Dict[Hashable, torch.cuda.Event] = {}
        self.programs: Dict[tuple, _Program] = {}

    def word(self, kind: int, dst: int, src: int) -> int:
        return self.words[dst].data_ptr() + 4 * (kind * len(self.cards) + src)

    def mark(self, key: Hashable, stream: torch.cuda.Stream
             ) -> torch.cuda.Event:
        """The event named ``key`` recorded on ``stream`` now: one event
        object per key, reused from hop to hop (a wait takes the record
        it sees when it is issued)."""
        ev = self.events.get(key)
        if ev is None:
            ev = self.events[key] = torch.cuda.Event()
        ev.record(stream)
        return ev

    def side_stream(self, card: int) -> torch.cuda.Stream:
        s = self.side.get(card)
        if s is None:
            s = self.side[card] = torch.cuda.Stream(device=card)
        return s


_rings: Dict[Tuple[int, ...], _Ring] = {}


def _ring(cards: Tuple[int, ...]) -> _Ring:
    ring = _rings.get(cards)
    if ring is None:
        ring = _rings[cards] = _Ring(cards)
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


class _Waits(NamedTuple):
    """A hop's prepared wait launches: the table (kept alive here), its
    address and length as ``ring_wait_all`` takes them, that entry point,
    and the (card, stream id) pairs of the streams the table blocks."""

    table: ctypes.Array
    addr: int
    n: int
    launch: Callable
    streams: Tuple[Tuple[int, int], ...]


class RingShiftHandle(NamedTuple):
    """A hop in flight: the landing buffers and the prepared wait launches
    that redeem them (None where stream order suffices)."""

    bufs: List[torch.Tensor]
    kind: int
    shift: int
    waits: Optional[_Waits]
    plain: bool


def _stores(xs, shift: int, kind: int, side: bool):
    """Allocate every landing buffer, then issue every store launch;
    returns (landing buffers, store launches, the prepared waits or
    None)."""
    x0 = xs[0]
    cards = tuple(x.get_device() for x in xs)
    ring = _ring(cards)
    cur = {c: torch.cuda.current_stream(c) for c in ring.ranks_on}
    store = {c: ring.side_stream(c) for c in cur} if side else cur
    cur_ids = {c: (c, s.cuda_stream) for c, s in cur.items()}
    store_ids = {c: (c, s.cuda_stream) for c, s in store.items()}
    nbytes = x0.numel() * x0.element_size()
    key = (shift, kind, x0.shape, x0.dtype, tuple(cur_ids.values()),
           tuple(store_ids.values()))
    prog = ring.programs.get(key)
    if prog is None:
        prog = ring.programs[key] = _Program(
            ring, hop_plan(cards, shift, nbytes, store_ids, cur_ids), kind,
            x0, cur)
    # the landing slots of each card: one allocation on its current stream
    size = x0.element_size()
    slabs = {c: torch.empty(n, dtype=x0.dtype, device=c)
             for c, n in prog.slab_elems.items()}
    base = {c: s.data_ptr() for c, s in slabs.items()}
    bufs = [slabs[c].as_strided(x0.shape, prog.strides, o // size)
            for c, o in zip(cards, prog.offset)]
    if side:
        for c, s in store.items():
            s.wait_event(ring.mark(c, cur[c]))  # this card's producers
    for c, d in prog.plan.events:
        store[c].wait_event(ring.mark((c, d), cur[d]))
    lib = _lib()
    for c, args, fill in prog.stores:
        for seg, j, i in fill:
            seg.src = xs[j].data_ptr()
            seg.dst = base[cards[i]] + prog.offset[i]
        _raise(lib.ring_store(args, c, store[c].cuda_stream),
               "ring_store launch")
    if side:  # what the side streams read and write
        for x in xs:
            x.record_stream(store[x.get_device()])
        for c, d in prog.crossing:
            slabs[d].record_stream(store[c])
    if not prog.wait_keys:
        return bufs, len(prog.stores), None
    table = type(prog.wait_table).from_buffer_copy(prog.wait_table)
    for w, keys in zip(table, prog.wait_keys):
        for k, (word, blocks) in enumerate(keys):
            w.args.entry[k].target = ring.counters.advance(word, blocks)
    return bufs, len(prog.stores), _Waits(
        table, ctypes.addressof(table), len(table), lib.ring_wait_all,
        prog.wait_streams)


def _waits(waits: Optional[_Waits]) -> int:
    """Issue a hop's prepared wait launches in one call; their count."""
    if waits is None:
        return 0
    _raise(waits.launch(waits.addr, waits.n), "ring_wait_all launch")
    return waits.n


def ring_shift(xs: Sequence[torch.Tensor], shift: int = 1, *,
               kind: str = "input") -> List[torch.Tensor]:
    """K3: rank ``i`` gets rank ``(i - shift) mod n``'s buffer.

    ``kind`` names the hop's completion words (``"input"`` or ``"output"``
    halo); hops of different kinds never release each other's waits."""
    k = _kind(kind)
    if not _check(xs, shift):
        return ring_shift_plain(xs, shift)
    bufs, n_stores, waits = _stores(xs, shift, k, side=False)
    ring_shift.launches += n_stores + _waits(waits)
    return bufs


ring_shift.launches = 0


def ring_shift_start(xs: Sequence[torch.Tensor], shift: int = 1, *,
                     kind: str = "start") -> RingShiftHandle:
    """K4a: start the hop on side streams; redeem the handle with
    :func:`ring_shift_wait`.  On the CPU the whole hop runs here."""
    k = _kind(kind)
    if not _check(xs, shift):
        return RingShiftHandle(ring_shift_plain(xs, shift), k, shift, None,
                               True)
    bufs, n_stores, waits = _stores(xs, shift, k, side=True)
    ring_shift_start.launches += n_stores
    return RingShiftHandle(bufs, k, shift, waits, False)


ring_shift_start.launches = 0


def ring_shift_wait(handle: RingShiftHandle) -> List[torch.Tensor]:
    """K4b: make each destination card's current stream wait until its
    landing buffers are filled; returns the landing buffers.  The current
    streams must be the ones :func:`ring_shift_start` saw."""
    if handle.plain:
        return handle.bufs
    if handle.waits is not None:
        for c, sid in handle.waits.streams:
            # the stream id alone: cheaper than torch.cuda.current_stream
            if torch._C._cuda_getCurrentStream(c)[0] != sid:
                raise RuntimeError(
                    f"ring_shift_wait: cuda:{c}'s current stream changed "
                    "since ring_shift_start; the waits go to the stream the "
                    "hop was planned for")
    ring_shift_wait.launches += _waits(handle.waits)
    return handle.bufs


ring_shift_wait.launches = 0
