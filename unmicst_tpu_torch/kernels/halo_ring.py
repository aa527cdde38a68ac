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

Across processes (a :class:`RingSpan` whose ranks live in several
processes: ``xs`` then holds ``None`` for the other processes' ranks) a
segment into another process lands in a slot of that process's shared
allocation (:class:`_Shared`: one ``cudaMalloc`` per process and card,
its IPC handle exchanged over the process group once per ring and slot
size, closed by :func:`close_rings`).  The destination waits on the
slot's completion word, copies the slot out into its landing buffer and
releases the slot's credit word; the next store into the slot acquires
that credit first (``ring_store_credit``), the entry barrier stream order
gave in one process.  Every process plans every hop
(:func:`hop_plan` with the ranks' processes), so each knows the block
counts the others send and the targets follow.

CUDA tensors run the kernels (or raise); CPU tensors take the plain
versions (:func:`ring_shift_plain` and the start/wait pair built on it,
which does the whole hop at start, as JAX's interpret mode does); across
processes the plain version is ``ppermute`` over the process group.
"""

from __future__ import annotations

import ctypes
from typing import (Any, Callable, Dict, Hashable, List, NamedTuple,
                    Optional, Sequence, Tuple)

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
MIN_SHARED_SLOT = 1 << 16  # bytes: the smallest slot of a shared allocation
_WORD = 1 << 32


class _Segment(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("word", ctypes.c_void_p), ("sys", ctypes.c_int),
                ("pad", ctypes.c_int)]


class _StoreArgs(ctypes.Structure):
    _fields_ = [("seg", _Segment * MAX_SEGMENTS), ("nbytes", ctypes.c_longlong),
                ("nseg", ctypes.c_int), ("blocks", ctypes.c_int)]


class _CreditArgs(ctypes.Structure):
    _fields_ = [("word", ctypes.c_void_p * MAX_SEGMENTS),
                ("target", ctypes.c_uint * MAX_SEGMENTS),
                ("timeout_ns", ctypes.c_ulonglong)]


class _WaitEntry(ctypes.Structure):
    _fields_ = [("word", ctypes.c_void_p), ("target", ctypes.c_uint),
                ("sys", ctypes.c_int)]


class _WaitArgs(ctypes.Structure):
    _fields_ = [("entry", _WaitEntry * MAX_WAITS), ("n", ctypes.c_int),
                ("pad", ctypes.c_int), ("timeout_ns", ctypes.c_ulonglong)]


class _WaitLaunch(ctypes.Structure):
    _fields_ = [("args", _WaitArgs), ("stream", ctypes.c_void_p),
                ("device", ctypes.c_int), ("pad", ctypes.c_int)]


IPC_HANDLE_BYTES = 64  # sizeof(cudaIpcMemHandle_t)

_SIGNATURES = {
    "ring_store": [ctypes.POINTER(_StoreArgs), ctypes.c_int, ctypes.c_void_p],
    "ring_store_credit": [ctypes.POINTER(_StoreArgs),
                          ctypes.POINTER(_CreditArgs), ctypes.c_int,
                          ctypes.c_void_p],
    "ring_wait_all": [ctypes.c_void_p, ctypes.c_int],  # WaitLaunch[n]
    "ring_enable_peer": [ctypes.c_int, ctypes.c_int],
    "ring_ipc_alloc": [ctypes.c_longlong, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p],
    "ring_ipc_open": [ctypes.c_char_p, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_void_p)],
    "ring_ipc_close": [ctypes.c_void_p, ctypes.c_int],
    "ring_ipc_free": [ctypes.c_void_p, ctypes.c_int],
}


def _lib():
    return _build.load("halo_ring", _SIGNATURES)


def _raise(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


class RingSpan(NamedTuple):
    """A ring whose ranks may live in several processes: each rank's card
    (its index in its own process; None for a CPU rank) and process,
    this process's index, and the process group's backend."""

    cards: Tuple[Optional[int], ...]
    procs: Tuple[int, ...]
    me: int = 0
    backend: Optional[str] = None

    @property
    def multi(self) -> bool:
        return len(set(self.procs)) > 1

    def local(self) -> Tuple[int, ...]:
        return tuple(i for i, p in enumerate(self.procs) if p == self.me)


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


def shared_slot_bytes(nbytes: int) -> int:
    """The slot size of the shared allocation that serves hops of
    ``nbytes``: a power of two of at least :data:`MIN_SHARED_SLOT`, so a
    ring exchanges handles once for many nearby sizes."""
    size = MIN_SHARED_SLOT
    while size < nbytes:
        size *= 2
    return size


class StoreLaunch(NamedTuple):
    """One ``ring_store`` launch: segments ``(src rank, dst rank)`` of one
    source card on one stream, ``blocks`` blocks each; ``signal[k]``: the
    segment's destination waits on its word (else stream order suffices);
    ``far[k]``: the destination is in another process (a shared slot
    behind its credit word)."""

    card: Hashable
    stream: Hashable
    segments: Tuple[Tuple[int, int], ...]
    blocks: int
    signal: Tuple[bool, ...]
    far: Tuple[bool, ...] = ()


class WaitLaunch(NamedTuple):
    """One wait launch on a destination card's stream: the words
    ``(dst rank, src rank)`` it acquires, and the blocks each word is
    sent per hop."""

    card: Hashable
    words: Tuple[Tuple[int, int], ...]
    blocks: Tuple[int, ...] = ()


class ConsumeLaunch(NamedTuple):
    """One copy-out launch on a destination card's stream: the shared
    slots ``(dst rank, src rank)`` filled from other processes, copied
    into the landing buffers, ``blocks`` blocks each releasing the slot's
    credit word."""

    card: Hashable
    words: Tuple[Tuple[int, int], ...]
    blocks: int


class HopPlan(NamedTuple):
    stores: Tuple[StoreLaunch, ...]
    waits: Tuple[WaitLaunch, ...]
    # (source card, destination card): the source's store stream waits
    # for an event on the destination's stream (its landing buffer is free)
    events: Tuple[Tuple[Hashable, Hashable], ...]
    consumes: Tuple[ConsumeLaunch, ...] = ()
    # every segment between processes, this process's or not:
    # (dst rank, src rank, store blocks, copy-out blocks)
    remote: Tuple[Tuple[int, int, int, int], ...] = ()


def hop_plan(cards: Sequence[Hashable], shift: int, nbytes: int,
             store_streams: Dict[Hashable, Hashable],
             dst_streams: Dict[Hashable, Hashable],
             procs: Optional[Sequence[int]] = None, me: int = 0) -> HopPlan:
    """The launches of one hop of the ring whose rank ``j`` lives on
    ``cards[j]`` of process ``procs[j]`` (default: all in process ``me``),
    as process ``me`` issues them.  ``store_streams[c]``: where this
    process's card ``c`` stores; it runs after ``dst_streams[c]``, card
    ``c``'s current stream (it is that stream, or a side stream joined to
    it).  ``dst_streams[c]``: the stream on which card ``c`` reads its
    landing buffers.  A segment into another process always signals, and
    its destination copies the shared slot out (``consumes``)."""
    n = len(cards)
    procs = tuple(procs) if procs is not None else (me,) * n
    groups: Dict[Hashable, List[Tuple[int, int]]] = {}
    for j in range(n):
        groups.setdefault((procs[j], cards[j]), []).append((j, (j + shift) % n))
    stores, events = [], []
    sent: Dict[Tuple[int, int], int] = {}  # (dst, src) -> store blocks
    waits: Dict[Hashable, List[Tuple[int, int]]] = {}
    for (p, card), segs in groups.items():
        for k in range(0, len(segs), MAX_SEGMENTS):
            part = tuple(segs[k : k + MAX_SEGMENTS])
            blocks = blocks_per_segment(nbytes, len(part))
            for j, i in part:
                sent[(i, j)] = blocks
            if p != me:
                continue
            stream = store_streams[card]
            far = tuple(procs[i] != me for _, i in part)
            signal = tuple(f or dst_streams[cards[i]] != stream
                           for (_, i), f in zip(part, far))
            stores.append(StoreLaunch(card, stream, part, blocks, signal,
                                      far))
            for (j, i), s, f in zip(part, signal, far):
                if s and not f:
                    waits.setdefault(cards[i], []).append((i, j))
        if p == me:
            for d in dict.fromkeys(cards[i] for _, i in segs
                                   if procs[i] == me):
                if dst_streams[d] not in (store_streams[card],
                                          dst_streams[card]):
                    events.append((card, d))
    # segments between processes: grouped by destination card, the copy-out
    inbound: Dict[Hashable, List[Tuple[int, int]]] = {}
    for j in range(n):
        i = (j + shift) % n
        if procs[i] != procs[j]:
            inbound.setdefault((procs[i], cards[i]), []).append((i, j))
    consumes, remote = [], []
    for (p, card), words in inbound.items():
        for k in range(0, len(words), MAX_SEGMENTS):
            part = tuple(words[k : k + MAX_SEGMENTS])
            blocks = blocks_per_segment(nbytes, len(part))
            remote.extend((i, j, sent[(i, j)], blocks) for i, j in part)
            if p == me:
                consumes.append(ConsumeLaunch(card, part, blocks))
                waits.setdefault(card, []).extend(part)
    return HopPlan(
        tuple(stores),
        tuple(WaitLaunch(card, tuple(words[k : k + MAX_WAITS]),
                         tuple(sent[w] for w in words[k : k + MAX_WAITS]))
              for card, words in waits.items()
              for k in range(0, len(words), MAX_WAITS)),
        tuple(events), tuple(consumes),
        tuple(sorted(remote, key=lambda r: r[1])),
    )


class Counters:
    """The host's copy of the completion words: each ``(kind, dst, src)``
    word counts, modulo 2^32, the blocks that have added to it."""

    def __init__(self):
        self.value: Dict[Tuple, int] = {}

    def advance(self, key: Tuple, blocks: int) -> int:
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


class _Shared:
    """The shared allocations of a ring that spans processes, for slots
    of ``slot`` bytes: per process and card, a completion word, a credit
    word and a landing slot for each (hop kind, destination rank on that
    card), in one ``cudaMalloc``; this process's own, and the others'
    opened by IPC handle (a collective over the process group)."""

    def __init__(self, ring: "_Ring", slot: int):
        import torch.distributed as dist

        lib = _lib()
        self.slot = slot
        self.ranks_on: Dict[Tuple[int, int], List[int]] = {}
        for i, (p, c) in enumerate(zip(ring.procs, ring.cards)):
            self.ranks_on.setdefault((p, c), []).append(i)
        self.words_bytes = -(-8 * len(KINDS) * max(
            len(v) for v in self.ranks_on.values()) // SLOT_ALIGN) * SLOT_ALIGN
        self.own: Dict[int, int] = {}  # card -> base, allocated here
        self.base: Dict[Tuple[int, int], int] = {}
        mine = []
        for (p, c), ranks in self.ranks_on.items():
            if p != ring.me:
                continue
            size = self.words_bytes + len(KINDS) * len(ranks) * slot
            ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(
                IPC_HANDLE_BYTES)
            _raise(lib.ring_ipc_alloc(size, c, ctypes.byref(ptr), handle),
                   f"the ring's shared allocation on cuda:{c}")
            self.own[c] = self.base[(p, c)] = ptr.value
            mine.append((c, handle.raw))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (ring.me, mine))
        opener = ring.cards[ring.local[0]]
        self.opened: List[int] = []
        for p, handles in every:
            if p == ring.me:
                continue
            for c, raw in handles:
                ptr = ctypes.c_void_p()
                _raise(lib.ring_ipc_open(raw, opener, ctypes.byref(ptr)),
                       f"opening process {p}'s ring allocation")
                self.base[(p, c)] = ptr.value
                self.opened.append(ptr.value)
        self.opener = opener

    def _at(self, ring: "_Ring", kind: int, i: int) -> Tuple[int, int]:
        key = (ring.procs[i], ring.cards[i])
        k = self.ranks_on[key].index(i)
        return self.base[key], kind * len(self.ranks_on[key]) + k

    def word(self, ring: "_Ring", kind: int, i: int) -> int:
        base, k = self._at(ring, kind, i)
        return base + 8 * k

    def credit(self, ring: "_Ring", kind: int, i: int) -> int:
        return self.word(ring, kind, i) + 4

    def slot_ptr(self, ring: "_Ring", kind: int, i: int) -> int:
        base, k = self._at(ring, kind, i)
        return base + self.words_bytes + k * self.slot

    def close(self) -> None:
        lib = _lib()
        for ptr in self.opened:
            _raise(lib.ring_ipc_close(ptr, self.opener),
                   "closing a peer's ring allocation")
        self.opened = []

    def free(self) -> None:
        lib = _lib()
        for c, ptr in self.own.items():
            _raise(lib.ring_ipc_free(ptr, c), "freeing the ring allocation")
        self.own = {}


class _Program:
    """One hop plan turned into launch arguments that stay fixed from hop
    to hop: the store tables with their words (the buffer pointers are
    filled per hop), the wait table with its words, cards and streams (the
    targets are filled per hop), the copy-out tables of slots filled from
    other processes, and the landing slots.  ``dst``: each card's current
    stream, where its waits and copy-outs go."""

    def __init__(self, ring: "_Ring", plan: HopPlan, kind: int,
                 x0: torch.Tensor, dst: Dict[int, torch.cuda.Stream]):
        cards = ring.cards
        nbytes, size = x0.numel() * x0.element_size(), x0.element_size()
        self.plan = plan
        self.shared = (ring.shared_for(shared_slot_bytes(nbytes))
                       if plan.remote else None)
        sh = self.shared
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
        # (source card, destination card) pairs of the local store launches
        self.crossing = tuple(dict.fromkeys(
            (launch.card, cards[i]) for launch in plan.stores
            for (_, i), f in zip(launch.segments, launch.far) if not f))
        # (card, args, credit args or None, [(segment struct, src rank,
        # dst rank, dst in another process, index)])
        self.stores = []
        for launch in plan.stores:
            args = _StoreArgs(nbytes=nbytes, nseg=len(launch.segments),
                              blocks=launch.blocks)
            credit = None
            if any(launch.far):
                credit = _CreditArgs(timeout_ns=int(WAIT_TIMEOUT_S * 1e9))
            fill = []
            for k, ((j, i), s, f) in enumerate(zip(
                    launch.segments, launch.signal, launch.far)):
                seg = args.seg[k]
                if f:
                    seg.dst = sh.slot_ptr(ring, kind, i)
                    seg.word = sh.word(ring, kind, i)
                    seg.sys = 1
                    credit.word[k] = sh.credit(ring, kind, i)
                elif s:
                    seg.word = ring.word(kind, i, j)
                    seg.sys = int(cards[i] != cards[j])
                fill.append((seg, j, i, f, k))
            self.stores.append((launch.card, args, credit, fill))
        # the wait table, and per launch its words' (counter key, blocks)
        self.wait_table = (_WaitLaunch * len(plan.waits))()
        self.wait_keys = []
        far_words = {(i, j) for i, j, _, _ in plan.remote}
        for w, launch in zip(self.wait_table, plan.waits):
            w.args.n = len(launch.words)
            w.args.timeout_ns = int(WAIT_TIMEOUT_S * 1e9)
            keys = []
            for k, ((i, j), blocks) in enumerate(zip(launch.words,
                                                     launch.blocks)):
                if (i, j) in far_words:
                    w.args.entry[k].word = sh.word(ring, kind, i)
                    w.args.entry[k].sys = 1
                    keys.append((("far", sh.slot, kind, i), blocks))
                else:
                    w.args.entry[k].word = ring.word(kind, i, j)
                    w.args.entry[k].sys = int(cards[i] != cards[j])
                    keys.append(((kind, i, j), blocks))
            w.stream = dst[launch.card].cuda_stream
            w.device = launch.card
            self.wait_keys.append(keys)
        # the copy-out launches: shared slot -> landing buffer, releasing
        # the slot's credit word
        self.consumes = []  # (card, args, [(segment struct, dst rank)])
        for launch in plan.consumes:
            args = _StoreArgs(nbytes=nbytes, nseg=len(launch.words),
                              blocks=launch.blocks)
            fill = []
            for k, (i, _) in enumerate(launch.words):
                seg = args.seg[k]
                seg.src = sh.slot_ptr(ring, kind, i)
                seg.word = sh.credit(ring, kind, i)
                seg.sys = 1
                fill.append((seg, i))
            self.consumes.append((launch.card, args, fill))
        # (card, stream id) of the streams the waits were planned for
        self.wait_streams = tuple((c, dst[c].stream_id) for c in
                                  dict.fromkeys(w.card for w in plan.waits))


class _Ring:
    """Completion words, counters, side streams and cached hop programs of
    one ring (one ordered tuple of rank cards, and, for a ring that spans
    processes, their processes): this process's part of it."""

    def __init__(self, cards: Tuple[int, ...],
                 procs: Optional[Tuple[int, ...]] = None, me: int = 0):
        n = len(cards)
        self.cards = cards
        self.procs = procs if procs is not None else (me,) * n
        self.me = me
        self.local = tuple(i for i in range(n) if self.procs[i] == me)
        enable_peer_access([torch.device("cuda", cards[i])
                            for i in self.local])
        self.ranks_on: Dict[int, List[int]] = {}
        for i in self.local:
            self.ranks_on.setdefault(cards[i], []).append(i)
        self.counters = Counters()
        # words[i][kind, j]: the blocks rank j has added into rank i's word
        self.words = {i: torch.zeros((len(KINDS), n), dtype=torch.int32,
                                     device=cards[i]) for i in self.local}
        for c in self.ranks_on:
            torch.cuda.synchronize(c)
        self.side: Dict[int, torch.cuda.Stream] = {}
        self.events: Dict[Hashable, torch.cuda.Event] = {}
        self.programs: Dict[tuple, _Program] = {}
        self.shared: Dict[int, _Shared] = {}

    def word(self, kind: int, dst: int, src: int) -> int:
        return self.words[dst].data_ptr() + 4 * (kind * len(self.cards) + src)

    def shared_for(self, slot: int) -> _Shared:
        """The shared allocations of ``slot``-byte slots, made (with the
        other processes, at the same hop) when first needed."""
        sh = self.shared.get(slot)
        if sh is None:
            sh = self.shared[slot] = _Shared(self, slot)
        return sh

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


_rings: Dict[tuple, _Ring] = {}


def _ring(cards: Tuple[int, ...], span: Optional[RingSpan] = None) -> _Ring:
    key = cards if span is None else (cards, span.procs, span.me)
    ring = _rings.get(key)
    if ring is None:
        ring = _rings[key] = (_Ring(cards) if span is None
                              else _Ring(cards, span.procs, span.me))
    return ring


def close_rings(barrier: Optional[Callable[[], Any]] = None) -> None:
    """Release every ring's shared allocations: finish this process's
    work on the cards, then (after ``barrier``, when given: every process
    must have finished before a peer's memory goes) close the peers'
    allocations, and after a second ``barrier`` free this process's own."""
    shared = [sh for ring in _rings.values() for sh in ring.shared.values()]
    for ring in _rings.values():
        for c in ring.ranks_on:
            torch.cuda.synchronize(c)
    if barrier is not None:
        barrier()
    for sh in shared:
        sh.close()
    if barrier is not None:
        barrier()
    for sh in shared:
        sh.free()
    _rings.clear()


def _check(xs: Sequence[Optional[torch.Tensor]], shift: int,
           span: Optional[RingSpan] = None) -> bool:
    """Validate a ring (this process's ranks of it); True when it lies on
    CUDA devices."""
    if not xs:
        raise ValueError("a ring needs at least one rank")
    if not isinstance(shift, int):
        raise TypeError(f"shift must be an int, got {shift!r}")
    if span is not None:
        if len(span.procs) != len(xs):
            raise ValueError(f"{len(xs)} buffers for a span of "
                             f"{len(span.procs)} ranks")
        mine = span.local()
        if any((x is None) == (i in mine) for i, x in enumerate(xs)):
            raise ValueError("a span's buffers are this process's ranks' "
                             "and None for the others'")
        local = [xs[i] for i in mine]
    else:
        local = list(xs)
    x0 = local[0]
    cuda = [x.is_cuda for x in local]
    if any(cuda) and not all(cuda):
        raise ValueError("a ring's buffers must all be on CUDA devices or "
                         "all on the CPU")
    for x in local:
        if x.shape != x0.shape or x.dtype != x0.dtype:
            raise ValueError(
                f"ring buffers differ: {tuple(x.shape)} {x.dtype} against "
                f"{tuple(x0.shape)} {x0.dtype}"
            )
        if not x.is_contiguous():
            raise ValueError("ring buffers must be contiguous")
    if span is not None and all(cuda):
        for i in mine:
            if xs[i].get_device() != span.cards[i]:
                raise ValueError(f"rank {i}'s buffer is on cuda:"
                                 f"{xs[i].get_device()}, its span says "
                                 f"cuda:{span.cards[i]}")
    return all(cuda)


def _kind(kind: str) -> int:
    if kind not in KINDS:
        raise ValueError(f"hop kind must be one of {sorted(KINDS)}, got "
                         f"{kind!r}")
    return KINDS[kind]


def _spanning(span: Optional[RingSpan]) -> Optional[RingSpan]:
    return span if span is not None and span.multi else None


def ring_shift_plain(xs: Sequence[Optional[torch.Tensor]], shift: int = 1,
                     span: Optional[RingSpan] = None
                     ) -> List[Optional[torch.Tensor]]:
    """``[xs[(i - shift) % n]`` copied to rank ``i``'s device ``]``.

    Across processes (``span``): ``ppermute`` over the process group, one
    ``dist.batch_isend_irecv`` of every segment between processes; the
    result holds None for the other processes' ranks.  Gloo cannot send a
    card's tensors: there it raises rather than stage through the host."""
    n = len(xs)
    span = _spanning(span)
    if span is None:
        return [xs[(i - shift) % n].to(xs[i].device, copy=True)
                for i in range(n)]
    import torch.distributed as dist

    me, procs = span.me, span.procs
    pairs = [(j, (j + shift) % n) for j in range(n)]
    if span.backend == "gloo" and span.cards[span.local()[0]] is not None \
            and any((procs[j] == me) != (procs[i] == me) for j, i in pairs):
        raise RuntimeError(
            "ppermute across processes over gloo cannot send a card's "
            "tensors: take halo_impl='ring' (kernels K3/K4 over CUDA IPC) "
            "or the NCCL backend")
    _check(xs, shift, span)
    out: List[Optional[torch.Tensor]] = [None] * n
    ops = []
    for j, i in pairs:  # one global order: sends and receives pair up
        if procs[j] == me and procs[i] == me:
            out[i] = xs[j].to(xs[i].device, copy=True)
        elif procs[j] == me:
            ops.append(dist.P2POp(dist.isend, xs[j], procs[i], tag=j))
        elif procs[i] == me:
            out[i] = torch.empty_like(xs[i])
            ops.append(dist.P2POp(dist.irecv, out[i], procs[j], tag=j))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Waits(NamedTuple):
    """A hop's prepared wait launches: the table (kept alive here), its
    address and length as ``ring_wait_all`` takes them, that entry point,
    the (card, stream id) pairs of the streams the table blocks, and the
    copy-out launches that follow the waits (card, args, stream)."""

    table: ctypes.Array
    addr: int
    n: int
    launch: Callable
    streams: Tuple[Tuple[int, int], ...]
    consumes: Tuple[Tuple[int, Any, int], ...] = ()


class RingShiftHandle(NamedTuple):
    """A hop in flight: the landing buffers and the prepared wait launches
    that redeem them (None where stream order suffices)."""

    bufs: List[Optional[torch.Tensor]]
    kind: int
    shift: int
    waits: Optional[_Waits]
    plain: bool


def _stores(xs, shift: int, kind: int, side: bool,
            span: Optional[RingSpan] = None):
    """Allocate every landing buffer, then issue every store launch;
    returns (landing buffers, store launches, the prepared waits or
    None)."""
    if span is None:
        cards = tuple(x.get_device() for x in xs)
        ring = _ring(cards)
    else:
        cards = span.cards
        ring = _ring(cards, span)
    x0 = xs[ring.local[0]]
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
            ring, hop_plan(cards, shift, nbytes, store_ids, cur_ids,
                           ring.procs, ring.me), kind, x0, cur)
    # the landing slots of each card: one allocation on its current stream
    size = x0.element_size()
    slabs = {c: torch.empty(n, dtype=x0.dtype, device=c)
             for c, n in prog.slab_elems.items()}
    base = {c: s.data_ptr() for c, s in slabs.items()}
    bufs: List[Optional[torch.Tensor]] = [None] * len(cards)
    for i in ring.local:
        bufs[i] = slabs[cards[i]].as_strided(x0.shape, prog.strides,
                                             prog.offset[i] // size)
    if side:
        for c, s in store.items():
            s.wait_event(ring.mark(c, cur[c]))  # this card's producers
    for c, d in prog.plan.events:
        store[c].wait_event(ring.mark((c, d), cur[d]))
    # the hop's targets: every segment between processes counts, this
    # process's or not (its slot's words are shared by whichever source)
    credit_target = {}
    far_target = {}
    if prog.shared is not None:
        sh = prog.shared
        for i, j, sent, copied in prog.plan.remote:
            credit_target[i] = ring.counters.value.get(
                ("credit", sh.slot, kind, i), 0)
            far_target[i] = ring.counters.advance(("far", sh.slot, kind, i),
                                                  sent)
            ring.counters.advance(("credit", sh.slot, kind, i), copied)
    lib = _lib()
    for c, args, credit, fill in prog.stores:
        for seg, j, i, far, k in fill:
            seg.src = xs[j].data_ptr()
            if far:
                credit.target[k] = credit_target[i]
            else:
                seg.dst = base[cards[i]] + prog.offset[i]
        if credit is None:
            _raise(lib.ring_store(args, c, store[c].cuda_stream),
                   "ring_store launch")
        else:
            _raise(lib.ring_store_credit(args, credit, c,
                                         store[c].cuda_stream),
                   "ring_store_credit launch")
    if side:  # what the side streams read and write
        for i in ring.local:
            xs[i].record_stream(store[cards[i]])
        for c, d in prog.crossing:
            slabs[d].record_stream(store[c])
    if not prog.wait_keys:
        return bufs, len(prog.stores), None
    table = type(prog.wait_table).from_buffer_copy(prog.wait_table)
    for w, keys in zip(table, prog.wait_keys):
        for k, (word, blocks) in enumerate(keys):
            w.args.entry[k].target = (far_target[word[3]]
                                      if word[0] == "far"
                                      else ring.counters.advance(word, blocks))
    consumes = []
    for c, args, fill in prog.consumes:
        for seg, i in fill:
            seg.dst = base[cards[i]] + prog.offset[i]
        consumes.append((c, args, cur[c].cuda_stream))
    return bufs, len(prog.stores), _Waits(
        table, ctypes.addressof(table), len(table), lib.ring_wait_all,
        prog.wait_streams, tuple(consumes))


def _waits(waits: Optional[_Waits]) -> int:
    """Issue a hop's prepared wait launches in one call, then its
    copy-outs; their count."""
    if waits is None:
        return 0
    _raise(waits.launch(waits.addr, waits.n), "ring_wait_all launch")
    lib = _lib()
    for c, args, stream in waits.consumes:
        _raise(lib.ring_store(args, c, stream), "ring copy-out launch")
    return waits.n + len(waits.consumes)


def ring_shift(xs: Sequence[Optional[torch.Tensor]], shift: int = 1, *,
               kind: str = "input", span: Optional[RingSpan] = None
               ) -> List[Optional[torch.Tensor]]:
    """K3: rank ``i`` gets rank ``(i - shift) mod n``'s buffer.

    ``kind`` names the hop's completion words (``"input"`` or ``"output"``
    halo); hops of different kinds never release each other's waits.
    ``span``: a ring across processes (``xs`` None for the other
    processes' ranks)."""
    k = _kind(kind)
    span = _spanning(span)
    if not _check(xs, shift, span):
        return ring_shift_plain(xs, shift, span)
    bufs, n_stores, waits = _stores(xs, shift, k, False, span)
    ring_shift.launches += n_stores + _waits(waits)
    return bufs


ring_shift.launches = 0


def ring_shift_start(xs: Sequence[Optional[torch.Tensor]], shift: int = 1, *,
                     kind: str = "start", span: Optional[RingSpan] = None
                     ) -> RingShiftHandle:
    """K4a: start the hop on side streams; redeem the handle with
    :func:`ring_shift_wait`.  On the CPU the whole hop runs here."""
    k = _kind(kind)
    span = _spanning(span)
    if not _check(xs, shift, span):
        return RingShiftHandle(ring_shift_plain(xs, shift, span), k, shift,
                               None, True)
    bufs, n_stores, waits = _stores(xs, shift, k, True, span)
    ring_shift_start.launches += n_stores
    return RingShiftHandle(bufs, k, shift, waits, False)


ring_shift_start.launches = 0


def ring_shift_wait(handle: RingShiftHandle) -> List[Optional[torch.Tensor]]:
    """K4b: make each destination card's current stream wait until its
    landing buffers are filled (and copy out those filled from other
    processes); returns the landing buffers.  The current streams must be
    the ones :func:`ring_shift_start` saw."""
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
