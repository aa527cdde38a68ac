"""Build and load the hand-written CUDA kernels (``unmicst_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles with
``nvcc`` into its own shared library, loaded with ``ctypes``.  The build
runs at first use, one ``nvcc`` per source, all started together, into
``build/torch_kernels/<hash>/`` at the repository root; the hash covers
the sources and the flags, so an edited source rebuilds and an unchanged
one is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, str]:
    """``name -> path`` of every kernel source."""
    return {
        f[: -len(".cu")]: os.path.join(CSRC, f)
        for f in sorted(os.listdir(CSRC)) if f.endswith(".cu")
    }


def build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build on a machine with the CUDA "
        "toolkit (PATH or /usr/local/cuda/bin)"
    )


def build_all() -> float:
    """Compile every source that has no library yet, in parallel.

    Returns the wall seconds spent (0 when everything was built).  Each
    compiler's output, ptxas register and spill report included, is kept
    beside its library as ``<name>.log``."""
    out_dir = build_dir()
    todo = {
        n: p for n, p in sources().items()
        if not os.path.exists(os.path.join(out_dir, f"lib{n}.so"))
    }
    if not todo:
        return 0.0
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, src in todo.items():
        tmp = os.path.join(out_dir, f"lib{name}.so.{os.getpid()}.tmp")
        log = open(os.path.join(out_dir, f"{name}.log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=log, stderr=subprocess.STDOUT,
        ), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, os.path.join(out_dir, f"lib{name}.so"))
        else:
            failed.append(name)
    if failed:
        logs = "\n".join(
            open(os.path.join(out_dir, f"{n}.log")).read() for n in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler output of the last build of ``name``."""
    path = os.path.join(build_dir(), f"{name}.log")
    with open(path) as f:
        return f.read()


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built on first use, with
    ``argtypes`` set from ``signatures`` and every entry returning the
    launch's ``cudaError_t`` as an int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = os.path.join(build_dir(), f"lib{name}.so")
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib
