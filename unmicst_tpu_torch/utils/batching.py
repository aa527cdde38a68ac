"""Tile batching helpers (counterpart of ``unmicst_tpu/utils/batching.py``)."""

from __future__ import annotations

from typing import Iterator, Tuple


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``x``."""
    return -(-x // m) * m


def chunks(n: int, chunk: int) -> Iterator[Tuple[int, int]]:
    """``(start, stop)`` of consecutive ``chunk``-sized pieces of ``n``."""
    for t0 in range(0, n, chunk):
        yield t0, min(t0 + chunk, n)


def even_chunk(n: int, limit: int) -> int:
    """The chunk size that splits ``n`` into as few chunks of at most
    ``limit`` as possible, all of (nearly) one size: padding the last chunk
    to the full size then adds fewer than one tile per chunk."""
    return -(-n // -(-n // limit))
