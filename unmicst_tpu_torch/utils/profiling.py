"""Stage timing, profiler traces and the NaN/Inf scan
(``unmicst_tpu/utils/profiling.py``).

* :class:`StageTimer`: accumulating wall time per named stage, with
  Mpx/s reporting;
* :func:`trace`: a ``torch.profiler`` session around a block (the host,
  and the card when one is in use) that leaves a Chrome trace in a
  directory, the counterpart of ``jax.profiler`` trace capture (open it in
  Perfetto or ``chrome://tracing``);
* :func:`check_numerics`: an opt-in scan of a nested dict/list of tensors
  or arrays (a ``state_dict``, maps) that raises on NaN/Inf.

The JAX module's live profiler server (``start_server``) has no torch
counterpart and is not kept (ROADMAP M14).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np


class StageTimer:
    """Accumulating named stage timer.

    >>> t = StageTimer()
    >>> with t.stage("read"): ...
    >>> t.report(mpx=400.0)
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - start)

    @property
    def total(self) -> float:
        return time.perf_counter() - self._t0

    def report(self, mpx: Optional[float] = None) -> str:
        parts = [f"{k} {v:.2f}s" for k, v in self.totals.items()]
        line = " | ".join(parts) + f" | total {self.total:.2f}s"
        if mpx is not None and self.total > 0:
            line += f" | {mpx / self.total:.1f} Mpx/s"
        return line


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block and write ``trace.<pid>.json`` (Chrome
    trace format) into ``log_dir``.  The card's kernels and copies are in
    it when CUDA is available."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace.{os.getpid()}.json"))


def _non_finite(leaf) -> int:
    """The NaN/Inf count of a float tensor or array (0 for other dtypes)."""
    import torch

    if isinstance(leaf, torch.Tensor):
        if not leaf.is_floating_point():
            return 0
        return int((~torch.isfinite(leaf)).sum().item())
    arr = np.asarray(leaf)
    if arr.dtype.kind != "f":
        return 0
    return int((~np.isfinite(arr)).sum())


def check_numerics(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` if any leaf of ``tree`` (a tensor, an
    array, or a dict/list/tuple of them) holds NaN/Inf.  The message
    names each bad leaf by its path, ``['down.0.kernel1']`` for a
    ``state_dict`` key, as ``jax.tree_util.keystr`` names it."""
    bad = []

    def visit(path: str, node) -> None:
        if isinstance(node, dict):
            for k in sorted(node):  # jax.tree_util's order
                visit(f"{path}[{k!r}]", node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(f"{path}[{i}]", v)
        else:
            n_bad = _non_finite(node)
            if n_bad:
                bad.append(f"{path}: {n_bad} non-finite")

    visit("", tree)
    if bad:
        raise FloatingPointError(
            f"non-finite values in {name}: " + "; ".join(bad))
