"""Bounded, thread-safe cache of built programs (``unmicst_tpu/utils/
progcache.py``).

On the card the port keeps one CUDA graph of the UNet forward per shape
here (``runtime/graphs.py``), where the JAX engine and stream keep their
compiled programs.  Every entry pins device memory, so the cache is a
FIFO of ``max_entries``.  Builds are deduplicated per key (two first
requests for one shape build once) but run off the cache's lock: a hit
never waits behind another key's build, and a build may itself call
:meth:`ProgramCache.get_or_build`.  A build that fails raises its error
to every caller that waited for it, and is not retried by them (a retry
would repeat a deterministic failure once per waiter).
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Hashable


class _Pending:
    __slots__ = ("event", "value", "error")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error = None


class ProgramCache:
    def __init__(self, max_entries: int = 16):
        self.max_entries = int(max_entries)
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self._pending: dict = {}
        # guards the two dicts only, never held across a build
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def get_or_build(self, key: Hashable, build: Callable):
        """The entry of ``key``, built by ``build()`` on a miss."""
        while True:
            with self._lock:
                hit = self._entries.get(key)
                if hit is not None:
                    return hit
                pending = self._pending.get(key)
                if pending is None:
                    pending = self._pending[key] = _Pending()
                    owner = True
                else:
                    owner = False
            if owner:
                break
            pending.event.wait()
            if pending.error is None:
                return pending.value
            raise pending.error
        try:
            value = build()
        except BaseException as exc:
            with self._lock:
                self._pending.pop(key, None)
            pending.error = exc
            pending.event.set()
            raise
        with self._lock:
            self._entries[key] = value
            self._pending.pop(key, None)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        pending.value = value
        pending.event.set()
        return value
