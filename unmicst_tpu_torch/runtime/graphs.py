"""CUDA graphs of the UNet forward: the port's counterpart of the JAX
engine's and stream's compiled programs (``ProgramCache(max_entries=16)``
at ``unmicst_tpu/infer.py:213`` and ``runtime/pipeline.py:168``).

Eager PyTorch issues every convolution, batch norm and activation of every
chunk from the host.  :func:`weigh_tiles` (``infer.py``) instead replays,
on the card, one captured graph of ``forward(staging) -> logits`` per
forward shape.  The graphs belong to the model (:func:`graphs_for`): a
:class:`ProgramCache` of 16 per model, keyed by what the capture fixed
(:func:`graph_key`).  K1 and K2 stay outside the graphs, so their
launch counters keep counting host launches.

When a graph pays: a capture costs a warm-up forward and the capture
(0.08-0.14 s a key with cuDNN's plans chosen, ``PERF.md``), and a replay
saves the host's issue time, a percent or two of a slide.  A model's
first request of a key therefore runs eagerly, and its second captures:
a process that runs a shape once (a one-shot CLI call, ``spatial_infer``'s
per-call models) never captures, and one that repeats it (the stream's
stripes, a batch of slides, a server) replays from the second call on.

What a graph fixes, and how this module keeps it right:

* *cuDNN's algorithm.*  The engine runs cuDNN with ``benchmark=True``
  under the flags that ``infer._conv_precision`` holds.  A capture first
  runs the forward once on a side stream under the same flags, in the
  same thread (PyTorch keeps cuDNN's plans per thread), so the capture
  finds its algorithms chosen and benchmarks nothing.
* *Memory.*  A graph keeps its intermediates for as long as it lives.
  Every graph on a card shares that card's one memory pool
  (``torch.cuda.graph_pool_handle``), across models and engines, and
  every capture runs on the card's one capture stream, so the graphs
  hold the largest forward's memory, not the sum; when the last of them
  dies, the pool's memory goes back and the next capture starts another.  Sharing is
  safe while no two of them run at once: captures and replays take the
  card's lock, and each replay's stream first waits for the event the
  pool's previous user recorded, so graphs of one pool never overlap on
  the card either; a replay's output is read (by K1) before the turn
  ends.  Each entry keeps its static tensors referenced.
* *The int8 state.*  A graph holds the addresses of the QuantState it was
  captured with.  The entry keeps its own copy of the state's tensors,
  and the caller's state is copied into it before every replay, so a
  re-calibrated state takes effect.
* *No fallback.*  A capture that fails (a host synchronisation inside the
  forward, say) raises, to every caller waiting on that key; nothing
  falls back to eager.  Later captures take a fresh pool.

The CPU never builds graphs.  Nothing here runs at import time.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import weakref
from typing import Callable, Dict, Optional

import torch

from unmicst_tpu_torch.utils.progcache import ProgramCache

MAX_GRAPHS = 16  # per model, as the JAX engine's ProgramCache


class ForwardGraph:
    """One captured forward: ``staging`` (the static input), ``logits``
    (the static output), the int8 state's static copy (or None),
    ``keep``, what the graph reads that its caller owns, and ``card``,
    the pool it was captured in; replay it within ``card.turn()``."""

    def __init__(self, graph, staging, logits, quant, keep, card):
        self.graph, self.staging, self.logits = graph, staging, logits
        self.quant, self.keep, self.card = quant, keep, card

    def replay(self, quant=None) -> torch.Tensor:
        """Run the graph on what ``staging`` holds now; returns the static
        ``logits``.  ``quant``: the caller's QuantState, copied into the
        graph's own first."""
        if self.quant is not None:
            if quant is None:
                raise ValueError("this forward graph was captured in int8 "
                                 "mode and needs a QuantState")
            torch._foreach_copy_(_tensors(self.quant), _tensors(quant))
        self.graph.replay()
        return self.logits


def _tensors(quant) -> list:
    """A QuantState's tensors in a fixed order."""
    out = []
    for site in sorted(quant["kernels"]):
        qk = quant["kernels"][site]
        out += [qk[n] for n in sorted(qk)]
    return out + [quant["scales"][s] for s in sorted(quant["scales"])]


def _clone_quant(quant):
    return {"kernels": {s: {n: t.clone() for n, t in k.items()}
                        for s, k in quant["kernels"].items()},
            "scales": {s: a.clone() for s, a in quant["scales"].items()}}


class CardPool:
    """A card's graph memory pool, shared by every model's graphs there:
    the pool, the one stream every capture runs on (the allocator reuses
    a freed block only on the stream it was allocated on, so captures on
    one stream share the pool's memory), the lock that captures and
    replays take, the event of the last use, and the live graphs of each
    pool.  Made at the card's first capture."""

    def __init__(self, device: torch.device):
        self.device = device
        with torch.cuda.device(device):
            self.stream = torch.cuda.Stream(device)
        self.pool = None
        self.lock = threading.Lock()
        self._done: Optional[torch.cuda.Event] = None
        self._live: Dict[tuple, int] = {}  # pool -> live graphs in it
        # finalizers run in any thread, also inside this lock's holder
        # when an allocation there starts the garbage collector
        self._live_lock = threading.RLock()

    def pool_for_capture(self):
        """The pool a new capture joins (under the lock).  When every graph
        of the pool has died, PyTorch's allocator no longer takes new
        captures into it, and frees its memory once it holds nothing:
        then the capture starts a fresh pool."""
        with self._live_lock:
            if not self._live.get(self.pool):
                self.pool = torch.cuda.graph_pool_handle()
        return self.pool

    def adopt(self, graph: "ForwardGraph", pool) -> None:
        """Count ``graph`` live in ``pool`` until it is collected."""
        with self._live_lock:
            self._live[pool] = self._live.get(pool, 0) + 1
        weakref.finalize(graph, self._release, pool)

    def _release(self, pool) -> None:
        with self._live_lock:
            self._live[pool] -= 1
            if not self._live[pool]:
                del self._live[pool]

    @contextlib.contextmanager
    def turn(self):
        """The pool to oneself: the lock, and the current stream ordered
        after the pool's previous user on the card.  Work enqueued in the
        block (copy-in, replay, the consumer of ``logits``) is what the
        next user waits for."""
        with self.lock:
            stream = torch.cuda.current_stream(self.device)
            if self._done is not None:
                stream.wait_event(self._done)
            yield
            if self._done is None:
                self._done = torch.cuda.Event()
            self._done.record(stream)

    def abandon(self) -> None:
        """After a failed capture (under the lock): PyTorch ends a
        capture's allocations into the pool only when the capture ends
        cleanly, so end them here and give later captures a pool of their
        own (the graphs captured before keep the old one)."""
        end = getattr(torch._C, "_cuda_endAllocateToPool", None)
        if end is not None:
            try:
                end(torch.cuda.current_device(), self.pool)
            except RuntimeError:
                pass  # the capture had ended its allocations itself
        self.pool = None


_attach = threading.Lock()
_CARDS: Dict[str, CardPool] = {}


def card_pool(device: torch.device) -> CardPool:
    """``device``'s shared pool (made on first use)."""
    with _attach:
        pool = _CARDS.get(str(device))
        if pool is None:
            pool = _CARDS[str(device)] = CardPool(device)
        return pool


class ForwardGraphs:
    """A model's forward graphs on its card: the cache, the keys requested
    so far (a key's first request runs eagerly), and the seconds each
    key's capture took."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cache = ProgramCache(max_entries=MAX_GRAPHS)
        self._seen: "collections.OrderedDict" = collections.OrderedDict()
        self._seen_lock = threading.Lock()
        self.capture_s: Dict[tuple, float] = {}

    def _second(self, key: tuple) -> bool:
        """Note a request of ``key``; True from its second on (and for a
        key whose graph is cached)."""
        with self._seen_lock:
            again = key in self._seen or key in self.cache
            self._seen[key] = True
            self._seen.move_to_end(key)
            while len(self._seen) > 4 * MAX_GRAPHS:
                self._seen.popitem(last=False)
            return again

    def get(self, key: tuple, forward: Callable, shape: tuple, dtype,
            quant=None, keep=()) -> Optional[ForwardGraph]:
        """The graph of ``key``, captured from ``forward(staging, quant)``
        on a zero ``staging`` of ``shape`` and ``dtype`` at the key's
        second request; None at its first (the caller runs eagerly)."""
        if not self._second(key):
            return None
        return self.cache.get_or_build(
            key, lambda: self._capture(key, forward, shape, dtype, quant,
                                       keep))

    def _capture(self, key, forward, shape, dtype, quant, keep
                 ) -> ForwardGraph:
        t0 = time.perf_counter()
        dev = self.device
        card = card_pool(dev)
        with card.lock, torch.cuda.device(dev):
            staging = torch.zeros(shape, dtype=dtype, device=dev)
            static_q = _clone_quant(quant) if quant is not None else None
            side = card.stream
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                forward(staging, static_q)  # cuDNN chooses here
            graph = torch.cuda.CUDAGraph()
            pool = card.pool_for_capture()
            try:
                with torch.cuda.graph(graph, pool=pool, stream=side,
                                      capture_error_mode="thread_local"):
                    logits = forward(staging, static_q)
            except BaseException:
                card.abandon()
                raise
            torch.cuda.current_stream(dev).wait_stream(side)
            entry = ForwardGraph(graph, staging, logits, static_q, keep, card)
            card.adopt(entry, pool)
        self.capture_s[key] = time.perf_counter() - t0
        return entry


def graphs_for(model: torch.nn.Module, device: torch.device
               ) -> ForwardGraphs:
    """``model``'s graphs (made on first use; they live as long as it)."""
    g = model.__dict__.get("_forward_graphs")
    if g is None:
        with _attach:
            g = model.__dict__.get("_forward_graphs")
            if g is None:
                g = model.__dict__["_forward_graphs"] = ForwardGraphs(device)
    return g


def graph_key(model: torch.nn.Module, device: torch.device, chunk: int,
              channels: int, patch: int, dtype, packed=None,
              quant=None) -> tuple:
    """What a capture fixes: the card, the model (whose cache holds the
    entry, so the identity cannot be reused while it lives), the staging
    shape and dtype, the TF32 flag it ran under, the space-to-depth
    weights it read (by identity: the entry keeps them alive), and the
    int8 sites."""
    return (str(device), id(model), chunk, channels, patch, str(dtype),
            bool(torch.backends.cudnn.allow_tf32),
            None if packed is None else id(packed),
            None if quant is None else tuple(sorted(quant["kernels"])))
