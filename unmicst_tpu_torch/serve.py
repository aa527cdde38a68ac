"""Inference service: the model stays resident and serves slides over
HTTP, on the GPU (the port of ``unmicst_tpu/serve.py``).

The reference is a batch CLI that pays the model's set-up per call
(``UnMicst.py:596``).  Pipelines (MCMICRO at scale) and interactive
viewers keep the model resident instead:

* ``POST /infer?model=nucleiDAPI&channel=0[&compress=1|deflate|zstd]
  [&scale=0.5][&roi=r0,c0,h,w][&range=lo,hi][&classes=1,2][&pyramid=1]
  [&usePyramid=1]`` with a TIFF, OME-TIFF, CZI or ND2 body (the container
  sniffed from its magic bytes, channels mapped OME-aware) -> a
  multi-page TIFF of uint8 probability maps, in reversed class order
  (optionally Deflate- or zstd-compressed pages; with ``pyramid=1`` each
  page tiled with a SubIFD pyramid).  ``usePyramid=1`` at ``scale`` 0.5
  or below reads a pyramidal TIFF's nearest stored level when it fits the
  whole engine (``stream_above_px``), and the full resolution otherwise.
  ``roi=`` infers only that window with one net tile of context around it (a
  viewer panning over a mega-slide); ``range=lo,hi`` pins the rescale
  range (once per channel for duo) so a window normalizes exactly as the
  whole slide does; ``classes=`` returns only those class pages, dropped
  on the card on every path;
* ``POST /infer?probe=range&channel=0[&outlier=p]`` -> JSON of the body's
  global per-channel (lo, hi), no inference: a viewer calls it once and
  pins ``range=`` on every ROI request;
* ``channel_name=DAPI`` (repeatable for duo) picks channels by their
  OME-XML names instead of their indexes;
* ``POST /slides`` with a body -> ``{"slide_id": ...}``: a content-
  addressed (sha256, deduplicated), LRU-bounded cache; body-less
  ``POST /infer?slide=ID&roi=...`` then serves every viewer window without
  a second upload.  ``roi=`` pans against a cached slide pin its plane in
  device memory once and slice each band there (no pixels go up per pan;
  K2 writes only the ROI);
* ``DELETE /slides/<id>``: the viewer closed the slide; its disk copy and
  pinned planes go now (after the last request in flight reads it; 404
  for unknown ids);
* ``GET /models`` (zoo availability), ``GET /healthz`` (liveness and the
  cards), ``GET /stats`` (request and throughput counters).

Posture: at most ``--maxInflight`` requests in flight (503 +
``Retry-After`` past it), drain on SIGTERM/SIGINT (stop accepting, finish
what is in flight, exit), per-request metrics in ``X-UnMicst-Meta``.
Engines are cached per (model, precision, kind); ``--precision int8``
calibrates on the engine's first slide and that state serves every later
request.

The server runs on the card unless the caller names the CPU
(``ModelServer(device="cpu")``, ``main(argv, device="cpu")``); without a
card it raises.  Requests are parsed, read and encoded on their handler
threads; their engine calls run on one worker thread per card
(:func:`run_on_device`), on its current stream, so cuDNN's autotuned
algorithms, which PyTorch keeps per thread, are chosen once.

A refusal that names its ROADMAP item answers 501 (zstd without the
host's libzstd, M14b); other reader errors, a CZI of JPEG XR sub-blocks or
of undecodable JPEG sub-blocks among them, answer 400 as in the JAX
server.  The persistent compile cache of the JAX server has no
counterpart here (M14c's ``progcache``).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import queue
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

# reader errors that mean a bad upload (HTTP 400), not a server fault
_READ_ERRORS = (OSError, ValueError, NotImplementedError, IndexError,
                EOFError)


def _is_not_ported(e: BaseException) -> bool:
    """A refusal of a path the port lacks (HTTP 501): it names its
    ROADMAP item."""
    return isinstance(e, NotImplementedError) and "ROADMAP" in str(e)


def _resolve_channel_names(path: str, fmt: str, names) -> list:
    """``channel_name=`` -> 0-based channel indexes through the OME-XML
    names; ValueError (-> 400) when absent or unresolvable."""
    from unmicst_tpu_torch.io.slides import resolve_channel_names

    return resolve_channel_names(path, fmt, names)


def _parse_compress(value: str) -> Optional[str]:
    """compress= accepts booleans (bare/1/true -> deflate, the any-reader
    codec) or a codec name ('deflate' | 'zstd')."""
    v = value.lower()
    if v in ("deflate", "zstd"):
        return v
    return "deflate" if _parse_bool(value, "compress") else None


def _parse_classes(q) -> Optional[tuple]:
    """``classes=`` -> tuple of 0-based class indexes (repeatable or
    comma-joined); None when absent.  The engine checks the range."""
    if "classes" not in q:
        return None
    vals = [x for v in q["classes"] for x in v.split(",") if x != ""]
    if not vals:
        raise ValueError(
            "classes parameter present but empty; pass 0-based class "
            "indices, e.g. classes=1,2"
        )
    try:
        return tuple(int(x) for x in vals)
    except ValueError:
        raise ValueError(
            f"classes must be integer indices, got {q['classes']!r}"
        ) from None


def _parse_bool(value: str, name: str) -> bool:
    """Strict query bool: a silent misparse (rescale=false staying on) is
    worse than a 400."""
    v = value.lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"{name} must be a boolean, got {value!r}")


def _parse_range(q) -> Optional[list]:
    """``range=lo,hi`` (repeatable) -> list of float pairs, or None."""
    if "range" not in q:
        return None
    out = []
    for v in q["range"]:
        parts = v.split(",")
        if len(parts) != 2:
            raise ValueError(f"range must be lo,hi — got {v!r}")
        out.append((float(parts[0]), float(parts[1])))
    return out


def _parse_channels(q) -> list:
    """``channel=`` (repeatable or ``0,1``) -> 1 or 2 indexes."""
    vals = [int(x) for v in q.get("channel", ["0"])
            for x in v.split(",") if x != ""]
    if not vals:
        raise ValueError("channel parameter present but empty; pass one "
                         "index or two (duo), e.g. channel=0,1")
    if len(vals) > 2:
        raise ValueError(f"{len(vals)} channels requested; at most 2 (duo) "
                         "are supported")
    return vals


def _parse_channel_names(q) -> Optional[list]:
    names = q.get("channel_name")
    if names is not None:
        if not all(names):
            raise ValueError("channel_name parameter present but empty")
        if len(names) > 2:
            raise ValueError(f"{len(names)} channel names requested; at "
                             "most 2 (duo) are supported")
    return names


def _plain_model_name(model: str) -> bool:
    """The model parameter reaches ``resolve_model_dir``, which takes
    paths: remote clients must not walk the host's file system."""
    return not (os.path.isabs(model) or os.sep in model
                or (os.altsep and os.altsep in model) or ".." in model)


def _channels(channel) -> list:
    return list(channel) if isinstance(channel, (list, tuple)) else [channel]


def card_names(device) -> list:
    """``/healthz``'s devices: each card with its name, or the CPU."""
    import torch

    if device.type != "cuda":
        return [str(device)]
    return [f"cuda:{i} ({torch.cuda.get_device_name(i)})"
            for i in range(torch.cuda.device_count())]


_WORKERS: Dict[str, "concurrent.futures.ThreadPoolExecutor"] = {}
_WORKERS_LOCK = threading.Lock()


def run_on_device(device, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on the one worker thread of ``device``, and
    its result (or its exception) here.

    Every engine call of the server goes through it.  cuDNN keeps the
    algorithms its autotune chose per thread (PyTorch's execution-plan
    cache is thread-local), and the HTTP server answers each request on a
    new thread: engine calls made there would autotune every convolution
    again on every request, and could choose other algorithms than the
    last request did.  On one worker per device the choices are made once
    and kept, and the device's work is serialised, as the device would
    serialise it anyway; decoding, encoding and the HTTP transfer stay on
    the request threads."""
    key = str(device)
    with _WORKERS_LOCK:
        worker = _WORKERS.get(key)
        if worker is None:
            worker = _WORKERS[key] = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"unmicst-{key}")
    if threading.current_thread().name.startswith(f"unmicst-{key}_"):
        return fn(*args, **kwargs)  # already on it
    return worker.submit(fn, *args, **kwargs).result()


def roi_band(roi, shape, hp) -> tuple:
    """The band ``(a, b, ca, cb)`` (rows ``[a, b)``, columns ``[ca, cb)``)
    inferred for ``roi = (r0, c0, h, w)`` of an ``shape`` slide
    (``unmicst_tpu/serve.py:851-875``): one net tile of context on every
    side, the start snapped to the slide's tile grid, the extent bucketed
    to multiples of two sub-strides from the ROI's size alone, clipped at
    the slide's edges.  A ROI outside the slide raises."""
    r0, c0, h, w = (int(v) for v in roi)
    if not (0 <= r0 < shape[0] and 0 <= c0 < shape[1] and h > 0 and w > 0
            and r0 + h <= shape[0] and c0 + w <= shape[1]):
        raise ValueError(f"roi {roi} outside the {shape[0]}x{shape[1]} slide")
    pad = int(hp.im_size)
    sub = int(hp.im_size) - 2 * int(hp.margin)
    step = 2 * sub

    def expand(lo, hi, limit):
        # the bucket from the ROI's extent alone (+ one sub-stride of
        # alignment slack): same-sized windows share one band shape
        # wherever they pan
        size = -(-(hi - lo + sub) // step) * step
        lo = (max(0, lo) // sub) * sub  # grid-aligned start
        hi = min(limit, lo + size)
        lo = max(0, hi - size)
        return (lo // sub) * sub, hi  # re-align after an end clip

    return (*expand(r0 - pad, r0 + h + pad, shape[0]),
            *expand(c0 - pad, c0 + w + pad, shape[1]))


class ModelServer:
    """The resident models, slide caches and counters behind the HTTP
    front end (``unmicst_tpu/serve.py:115-1020``).

    ``device``: ``"cuda"`` (the default; raises without a card) or
    ``"cpu"``, which only a caller may ask for."""

    def __init__(
        self,
        model_root: Optional[str] = None,
        precision: str = "float32",
        max_body_bytes: int = 2 << 30,
        stream_above_px: int = 64_000_000,
        max_inflight: int = 4,
        queue_timeout_s: float = 30.0,
        max_scaled_px: int = 1 << 30,
        calibration_percentile: float = 99.99,
        slide_cache_bytes: int = 4 << 30,
        device_slide_bytes: int = 2 << 30,
        device="cuda",
    ):
        from unmicst_tpu_torch.infer import PRECISIONS
        from unmicst_tpu_torch.runtime.devices import resolve_device

        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in "
                             f"{sorted(PRECISIONS)}")
        self.device = resolve_device(device)
        self.model_root = model_root
        self.precision = precision
        self.calibration_percentile = float(calibration_percentile)
        self.max_body_bytes = int(max_body_bytes)
        self.stream_above_px = int(stream_above_px)
        # backpressure: the card serialises inference anyway; beyond a
        # small queue each extra request only spools a body to disk and
        # holds a thread, so fail fast with 503 + Retry-After
        self.max_inflight = int(max_inflight)
        # bound on net-input pixels after an upscaling ?scale= (one
        # request must not exhaust the server's memory through scale > 1)
        self.max_scaled_px = int(max_scaled_px)
        self.queue_timeout_s = float(queue_timeout_s)
        self._inflight = threading.BoundedSemaphore(max(1, self.max_inflight))
        self._zero_inflight = self.max_inflight <= 0  # test hook: always busy
        self._engines: Dict[Tuple[str, str, str], dict] = {}
        self._lock = threading.Lock()  # the engine cache
        # counters have their own lock: an engine build takes seconds, and
        # counters and backpressure must never queue behind it
        self._stats_lock = threading.Lock()
        self._started = time.time()
        self.stats = {
            "requests": 0, "ok": 0, "client_error": 0, "server_error": 0,
            "busy_rejected": 0, "px_processed": 0, "infer_s_total": 0.0,
            "slide_uploads": 0, "slide_hits": 0, "slide_drops": 0,
            "by_model": {},
            "prewarmed": 0, "prewarm_errors": 0, "prewarm_pending": 0,
            "prewarm_dropped": 0,
            "device_pins": 0, "device_pans": 0,
        }
        # prewarm runs on ONE worker with a small bounded queue: a burst of
        # prewarm uploads must not pile up threads that camp on the
        # inflight semaphore and starve interactive /infer traffic
        self._prewarm_queue: "queue.Queue" = queue.Queue(maxsize=4)
        self._prewarm_worker: Optional[threading.Thread] = None
        # content-addressed slide cache (POST /slides)
        self.slide_cache_bytes = int(slide_cache_bytes)
        self._slide_lock = threading.Lock()
        self._slides: Dict[str, dict] = {}  # id -> {path,bytes,used,refs}
        self._slide_total = 0
        self._slide_dir: Optional[str] = None
        # planes pinned in device memory: an 8k^2 uint16 slide is 128 MiB,
        # so it stays on the card whole and every roi= pan slices its band
        # there instead of uploading it
        self.device_slide_bytes = int(device_slide_bytes)
        self._dev_lock = threading.Lock()
        # (slide_id, channels) -> {event,plane,bytes,used,error}
        self._dev_planes: Dict[tuple, dict] = {}
        self._dev_total = 0

    def _count(self, **deltas) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                if k == "by_model":
                    self.stats["by_model"][v] = (
                        self.stats["by_model"].get(v, 0) + 1
                    )
                else:
                    self.stats[k] += v

    def snapshot(self) -> dict:
        with self._stats_lock:
            out = dict(self.stats, by_model=dict(self.stats["by_model"]))
        out["uptime_s"] = round(time.time() - self._started, 1)
        out["max_inflight"] = self.max_inflight
        with self._slide_lock:
            out["slides_cached"] = len(self._slides)
            out["slide_cache_bytes_used"] = self._slide_total
        with self._dev_lock:
            out["device_planes_pinned"] = len(self._dev_planes)
            out["device_plane_bytes_used"] = self._dev_total
        return out

    # -- slide cache (upload once, infer many) -------------------------------

    def register_slide(self, spool_path: str, nbytes: int,
                       digest: str) -> dict:
        """Adopt a spooled upload into the content-addressed cache.

        ``digest`` is the body's sha256: a re-upload of the same bytes
        dedups to the existing entry.  The cache is LRU-bounded by
        ``slide_cache_bytes``; entries with readers in flight are never
        evicted (refcounted)."""
        import shutil

        sid = digest[:32]
        with self._slide_lock:
            if self._slide_dir is None:
                import atexit

                self._slide_dir = tempfile.mkdtemp(prefix="unmicst-slides-")
                atexit.register(
                    shutil.rmtree, self._slide_dir, ignore_errors=True
                )
            ent = self._slides.get(sid)
            if ent is not None:
                # a re-upload revives an entry DELETEd while readers were
                # still in flight (same bytes, same disk copy)
                ent.pop("doomed", None)
                ent["used"] = time.time()
                os.unlink(spool_path)
                return {"slide_id": sid, "bytes": ent["bytes"],
                        "deduplicated": True}
            dest = os.path.join(self._slide_dir, sid)
            os.replace(spool_path, dest)
            self._slides[sid] = {"path": dest, "bytes": nbytes,
                                 "used": time.time(), "refs": 0}
            self._slide_total += nbytes
            # LRU eviction, skipping entries a request currently reads
            while self._slide_total > self.slide_cache_bytes:
                victims = sorted(
                    (e["used"], i) for i, e in self._slides.items()
                    if e["refs"] == 0 and i != sid
                )
                if not victims:
                    break
                _, vid = victims[0]
                v = self._slides.pop(vid)
                self._slide_total -= v["bytes"]
                try:
                    os.unlink(v["path"])
                except OSError:
                    pass
                self._drop_device_planes(vid)
        self._count(slide_uploads=1)
        return {"slide_id": sid, "bytes": nbytes, "deduplicated": False}

    def acquire_slide(self, slide_id: str) -> str:
        """Path of a cached slide, pinned against eviction until
        :meth:`release_slide`.  FileNotFoundError (-> 404) if unknown or
        dropped by ``DELETE /slides/<id>``."""
        with self._slide_lock:
            ent = self._slides.get(slide_id)
            if ent is None or ent.get("doomed"):
                raise FileNotFoundError(
                    f"unknown slide id {slide_id!r} (expired or never "
                    "uploaded — POST the body to /slides first)"
                )
            ent["refs"] += 1
            ent["used"] = time.time()
            return ent["path"]

    def release_slide(self, slide_id: str) -> None:
        with self._slide_lock:
            ent = self._slides.get(slide_id)
            if ent is not None and ent["refs"] > 0:
                ent["refs"] -= 1
                if ent["refs"] == 0 and ent.get("doomed"):
                    self._finalize_drop(slide_id)

    def _finalize_drop(self, slide_id: str) -> None:
        """Remove a cache entry: disk copy unlinked, pinned planes
        released.  The caller holds ``_slide_lock``."""
        ent = self._slides.pop(slide_id, None)
        if ent is None:
            return
        self._slide_total -= ent["bytes"]
        try:
            os.unlink(ent["path"])
        except OSError:
            pass
        self._drop_device_planes(slide_id)

    def drop_slide(self, slide_id: str) -> bool:
        """``DELETE /slides/<id>``: free the disk copy and the pinned
        planes now.  With readers in flight the drop waits for the last
        :meth:`release_slide` (their paths and tensors stay valid); new
        requests 404 at once.  False when the id is unknown."""
        with self._slide_lock:
            ent = self._slides.get(slide_id)
            if ent is None or ent.get("doomed"):
                # a doomed entry is gone for clients: repeated DELETEs 404,
                # and slide_drops counts removals, not retries
                return False
            if ent["refs"] > 0:
                ent["doomed"] = True
            else:
                self._finalize_drop(slide_id)
        self._count(slide_drops=1)
        return True

    # -- planes pinned on the card (pans without uploads) ---------------------

    def _drop_device_planes(self, slide_id: str) -> None:
        """Release the pinned planes of an evicted slide (pans in flight
        keep their tensors through their own references; the memory goes
        back to the allocator when the last one drops)."""
        with self._dev_lock:
            for k in [k for k in self._dev_planes if k[0] == slide_id]:
                v = self._dev_planes.pop(k)
                if v["event"].is_set() and v["error"] is None:
                    self._dev_total -= v["bytes"]

    def _device_plane_for(self, slide_key, srcs, eng):
        """The pinned plane (``[H, W]`` or ``[C, H, W]``) of a cached
        slide, uploaded on first use; or None when the cache is off, the
        slide exceeds ``device_slide_bytes``, or an int8 engine has not
        calibrated yet (that request takes the host path, which
        calibrates; later pans go to the card).

        Keyed by (slide_id, channels): the pixels do not depend on the
        engine, so every model shares one upload.  LRU-bounded; concurrent
        first pans wait for the first one's upload.  A slide that cannot be read
        takes the host path, which reports the reader's own error; a
        failed upload raises to every waiter (no device error is answered
        from another path)."""
        if slide_key is None or self.device_slide_bytes <= 0:
            return None
        if eng.quantized and eng._quant is None:
            return None
        h, w = srcs[0].height, srcs[0].width
        nbytes = sum(h * w * np.dtype(s.dtype).itemsize for s in srcs)
        if nbytes > self.device_slide_bytes:
            return None
        with self._dev_lock:
            ent = self._dev_planes.get(slide_key)
            if ent is None:
                ent = {"event": threading.Event(), "plane": None,
                       "bytes": nbytes, "used": time.time(), "error": None,
                       "read_error": False}
                self._dev_planes[slide_key] = ent
                owner = True
            else:
                ent["used"] = time.time()
                owner = False
        if not owner:
            ent["event"].wait()
            if ent["error"] is not None:
                if ent["read_error"]:
                    return None
                raise ent["error"]
            return ent["plane"]

        def fail(e, read_error):
            ent["error"], ent["read_error"] = e, read_error
            with self._dev_lock:
                if self._dev_planes.get(slide_key) is ent:
                    self._dev_planes.pop(slide_key)
            ent["event"].set()

        try:
            raw = (srcs[0].read_rows(0, h) if len(srcs) == 1
                   else np.stack([s.read_rows(0, h) for s in srcs]))
        except _READ_ERRORS as e:
            fail(e, True)
            return None
        try:
            ent["plane"] = run_on_device(self.device, eng.device_plane, raw)
        except BaseException as e:
            fail(e, False)
            raise
        ent["event"].set()
        self._count(device_pins=1)
        with self._dev_lock:
            self._dev_total += nbytes
            while self._dev_total > self.device_slide_bytes:
                victims = sorted(
                    (e["used"], k) for k, e in self._dev_planes.items()
                    if e is not ent and e["event"].is_set()
                    and e["error"] is None
                )
                if not victims:
                    break
                _, vk = victims[0]
                v = self._dev_planes.pop(vk)
                self._dev_total -= v["bytes"]
        return ent["plane"]

    def prewarm_slide(self, slide_id: str, model: str, roi_h: int,
                      roi_w: int, channel=0, rescale: bool = True,
                      outlier: float = -1.0, scale: float = 1.0,
                      in_range=None, channel_names=None,
                      classes=None) -> int:
        """Run every ``roi=`` band geometry a viewer will hit on a cached
        slide before the first pan, so cuDNN has chosen its algorithms
        for each (the counterpart of JAX's per-geometry compile).

        Band snapping (:meth:`_infer_roi`) gives a (slide, window size)
        pair at most four band shapes: interior, bottom edge, right edge,
        corner.  One ROI request runs at each of the four extreme offsets
        (fewer when the slide is small), each through the in-flight
        semaphore, so prewarm never oversubscribes the card.  Outputs are
        discarded.  Returns the number of geometries warmed."""
        from unmicst_tpu_torch.io.slides import (open_channel_source,
                                                 sniff_format)

        path = self.acquire_slide(slide_id)
        try:
            fmt = sniff_format(path)
            first = (channel_names[0] if channel_names is not None
                     else _channels(channel)[0])
            if channel_names is not None:
                first = _resolve_channel_names(path, fmt, [first])[0]
            with open_channel_source(path, fmt, first) as src:
                hh, ww = src.height, src.width
            if roi_h > hh or roi_w > ww:
                raise ValueError(
                    f"prewarm roi {roi_h}x{roi_w} exceeds the "
                    f"{hh}x{ww} slide"
                )
            offsets = sorted({
                (r0, c0)
                for r0 in (0, hh - roi_h)
                for c0 in (0, ww - roi_w)
            })
            warmed = 0
            for r0, c0 in offsets:
                # prewarm yields to live traffic: a busy card is being
                # warmed by real pans anyway
                if not self._inflight.acquire(timeout=30.0):
                    break
                try:
                    self.infer_tiff_path(
                        path, model, channel, rescale, outlier,
                        scale=scale, roi=(r0, c0, roi_h, roi_w),
                        in_range=in_range, channel_names=channel_names,
                        slide_id=slide_id, classes=classes,
                    )
                finally:
                    self._inflight.release()
                warmed += 1
                self._count(prewarmed=1)
            return warmed
        finally:
            self.release_slide(slide_id)

    def schedule_prewarm(self, slide_id: str, **kwargs) -> str:
        """Queue an upload-time prewarm on the single bounded worker.
        Returns ``"scheduled"``, or ``"dropped"`` when the queue is full
        (counted): prewarm only saves latency, so a burst sheds it."""
        try:
            self._prewarm_queue.put_nowait((slide_id, kwargs))
        except queue.Full:
            self._count(prewarm_dropped=1)
            return "dropped"
        self._count(prewarm_pending=1)
        with self._stats_lock:
            worker = self._prewarm_worker
            if worker is None or not worker.is_alive():
                worker = threading.Thread(
                    target=self._prewarm_worker_loop,
                    name="prewarm-worker", daemon=True,
                )
                self._prewarm_worker = worker
                worker.start()
        return "scheduled"

    def _prewarm_worker_loop(self) -> None:
        """Drain the prewarm queue; failures (unknown model, a window
        larger than the slide) land in ``prewarm_errors``: the upload has
        already answered 200 and pans still work, only cold.  Exits when
        idle (restarted by the next schedule)."""
        while True:
            try:
                slide_id, kwargs = self._prewarm_queue.get(timeout=5.0)
            except queue.Empty:
                # decided under the lock schedule_prewarm tests liveness
                # with: a concurrent enqueue lands first or restarts us
                with self._stats_lock:
                    if self._prewarm_queue.empty():
                        self._prewarm_worker = None
                        return
                continue
            try:
                self.prewarm_slide(slide_id, **kwargs)
            except Exception as e:  # noqa: BLE001 — background: record it
                self._count(prewarm_errors=1)
                with self._stats_lock:
                    self.stats["last_prewarm_error"] = (
                        f"{type(e).__name__}: {e}"
                    )
            finally:
                self._count(prewarm_pending=-1)

    def engine(self, model: str, kind: str = "whole"):
        """The cached engine, built outside the cache lock: a cold build
        loads a checkpoint and must not block other models' hits.
        Concurrent requests for the same key wait for the first one's build."""
        key = (model, self.precision, kind)
        with self._lock:
            ent = self._engines.get(key)
            if ent is None:
                ent = {"event": threading.Event(), "value": None,
                       "error": None}
                self._engines[key] = ent
                owner = True
            else:
                owner = False
        if owner:
            try:
                from unmicst_tpu_torch.cli import resolve_model_dir
                from unmicst_tpu_torch.core.checkpoint import (
                    load_params_for_bundle,
                )
                from unmicst_tpu_torch.core.hp import load_model_dir
                from unmicst_tpu_torch.infer import (PRECISIONS,
                                                     InferenceEngine)
                from unmicst_tpu_torch.runtime.pipeline import StreamingEngine

                bundle = load_model_dir(
                    resolve_model_dir(model, self.model_root)
                )
                params = load_params_for_bundle(bundle)
                cls = (StreamingEngine if kind == "stream"
                       else InferenceEngine)
                ent["value"] = cls.from_bundle(
                    bundle, params,
                    compute_dtype=PRECISIONS[self.precision],
                    # int8 calibrates on the engine's first slide, and that
                    # QuantState serves every later request
                    quantized=self.precision == "int8",
                    calibration_percentile=self.calibration_percentile,
                    device=self.device,
                )
            except BaseException as e:
                ent["error"] = e
                with self._lock:
                    self._engines.pop(key, None)  # a failed build retries
                raise
            finally:
                ent["event"].set()
        else:
            ent["event"].wait()
            if ent["error"] is not None:
                raise ent["error"]
        return ent["value"]

    def infer_tiff(
        self, body: bytes, model: str, channel: int, rescale: bool,
        outlier: float, compress: Optional[str] = None,
        scale: float = 1.0, pyramid: bool = False,
        roi: Optional[Tuple[int, int, int, int]] = None,
        in_range=None, channel_names=None,
    ) -> Tuple[bytes, dict]:
        """In-memory wrapper over :meth:`infer_tiff_path`."""
        with tempfile.NamedTemporaryFile(suffix=".tif") as tmp:
            tmp.write(body)
            tmp.flush()
            return self.infer_tiff_path(
                tmp.name, model, channel, rescale, outlier,
                compress=compress, scale=scale, pyramid=pyramid, roi=roi,
                in_range=in_range, channel_names=channel_names,
            )

    def infer_tiff_path(
        self, path: str, model: str, channel, rescale: bool,
        outlier: float, compress: Optional[str] = None,
        scale: float = 1.0, pyramid: bool = False,
        roi: Optional[Tuple[int, int, int, int]] = None,
        in_range=None, channel_names=None, slide_id: Optional[str] = None,
        classes=None, use_pyramid: bool = False,
    ) -> Tuple[bytes, dict]:
        """Run channel(s) of an uploaded TIFF/OME-TIFF/CZI/ND2 (sniffed by
        magic bytes) through the resident model
        (``unmicst_tpu/serve.py:588-826``).  ``channel``: one index, or
        two for duo models.

        Slides above ``stream_above_px`` stream (a resized virtual source
        at ``scale != 1``); the rest run the whole engine.  ``roi=(r0, c0,
        h, w)`` infers a window (:meth:`_infer_roi`).  ``in_range``: pinned
        per-channel rescale ranges in raw units (one pair broadcasts);
        overrides ``outlier``.  ``classes``: only those class pages, in
        reversed request order, dropped on the card.  ``use_pyramid`` at
        ``scale <= 0.5`` reads the nearest stored level of a pyramidal
        TIFF when every channel has one and it fits the whole engine
        (``unmicst_tpu/serve.py:687-733``); ``pyramid`` writes pyramidal
        pages."""
        from unmicst_tpu_torch.infer import _normalize_in_range
        from unmicst_tpu_torch.io.slides import (open_channel_source,
                                                 sniff_format)

        if compress is True:  # boolean callers: True = deflate
            compress = "deflate"
        elif compress is False:
            compress = None
        if compress == "zstd":
            from unmicst_tpu_torch.io import zstd

            if not zstd.available():  # before any inference
                raise zstd.unavailable()
        fmt = sniff_format(path)
        if channel_names is not None:
            channels = _resolve_channel_names(path, fmt, channel_names)
        else:
            channels = _channels(channel)
        if in_range is not None:
            if not rescale:
                raise ValueError("range= requires rescale on")
            # checked here so every path (whole, streamed, roi) sees
            # well-formed pairs: the stream applies stats unchecked
            in_range = _normalize_in_range(in_range, len(channels)).tolist()
        with contextlib.ExitStack() as stack:
            srcs = [
                stack.enter_context(open_channel_source(path, fmt, c))
                for c in channels
            ]
            shape = (srcs[0].height, srcs[0].width)
            if any((s.height, s.width) != shape for s in srcs):
                raise ValueError("channel planes disagree on dimensions")
            if classes is not None:
                classes = tuple(int(c) for c in classes)
                if not classes:
                    raise ValueError(
                        "classes parameter present but empty; pass "
                        "0-based class indices, e.g. classes=1,2"
                    )
            if roi is not None:
                return self._infer_roi(
                    srcs, shape, model, roi, rescale, outlier,
                    compress=compress, scale=scale, pyramid=pyramid,
                    in_range=in_range,
                    slide_key=(
                        (slide_id, tuple(channels))
                        if slide_id is not None else None
                    ),
                    classes=classes,
                )
            plan = None
            if use_pyramid:
                from unmicst_tpu_torch.io.slides import pyramid_plan_multi

                plan = pyramid_plan_multi(path, fmt, channels, scale,
                                          max_level_px=self.stream_above_px)
            if (scale > 1
                    and shape[0] * shape[1] * scale * scale
                    > self.max_scaled_px):
                # only upscales cost more than the same slide at scale 1,
                # so the bound applies to scale > 1 only
                raise ValueError(
                    f"scaled pixel count {shape[0] * shape[1]} x "
                    f"{scale}^2 exceeds the server bound "
                    f"{self.max_scaled_px}"
                )
            if plan is None and shape[0] * shape[1] > self.stream_above_px:
                # mega-slide POST: bounded memory, windowed reads from the
                # spooled file; t0 starts after the engine lookup in both
                # branches, so infer_s leaves out a first build
                eng = self.engine(model, "stream")
                t0 = time.perf_counter()
                maps = run_on_device(self.device, self._stream, eng, srcs,
                                     scale, outlier, rescale, classes,
                                     in_range)
                if scale != 1:  # back to the raw size, on the host
                    from unmicst_tpu_torch.io.preprocess import upscale_pm

                    maps = np.stack([upscale_pm(m, shape) for m in maps])
            else:
                if plan is not None:  # the stored level, at the residual
                    from unmicst_tpu_torch.io.slides import (
                        read_channel_level)

                    raws = [read_channel_level(path, fmt, c, plan[0])
                            for c in channels]
                    sf = scale * plan[1]
                else:
                    raws = [s.read_rows(0, shape[0]) for s in srcs]
                    sf = scale
                eng = self.engine(model)
                t0 = time.perf_counter()
                if len(raws) > 1:
                    maps = run_on_device(
                        self.device, eng.infer_slide_stack, raws,
                        outlier=outlier, rescale=rescale,
                        scaling_factor=sf, in_range=in_range,
                        classes=classes,
                    )
                else:
                    maps = run_on_device(
                        self.device, eng.infer_slide, raws[0],
                        outlier=outlier, rescale=rescale,
                        scaling_factor=sf,
                        in_range=(
                            in_range[0] if in_range is not None else None
                        ),
                        classes=classes,
                    )
                if plan is not None:  # back to the raw size, on the host
                    from unmicst_tpu_torch.io.preprocess import upscale_pm

                    maps = np.stack([upscale_pm(m, shape) for m in maps])
            infer_s = time.perf_counter() - t0
        return self._encode(
            maps, model, shape, shape[0] * shape[1], infer_s,
            compress=compress, pyramid=pyramid, in_range=in_range,
            class_indices=classes,
        )

    @staticmethod
    def _stream(eng, srcs, scale, outlier, rescale, classes,
                in_range) -> np.ndarray:
        """A streamed POST's maps, at ``scale != 1`` those of resized
        virtual sources (the caller brings them back to the raw size)."""
        from unmicst_tpu_torch.io import preprocess as pp

        ins = ([pp.ResampledSource(s, scale) for s in srcs] if scale != 1
               else srcs)
        # range= pins are raw units; a resized source streams
        # img_as_float units
        stats = ([pp.pinned_to_source_units(tuple(p), s)
                  for p, s in zip(in_range, ins)]
                 if in_range is not None else None)
        if len(ins) > 1:
            return eng.infer_stack(ins, outlier=outlier, rescale=rescale,
                                   classes=classes, stats=stats)
        return eng.infer(ins[0], outlier=outlier, rescale=rescale,
                         classes=classes,
                         stats=stats[0] if stats is not None else None)

    def _infer_roi(self, srcs, shape, model: str, roi, rescale: bool,
                   outlier: float, compress: Optional[str] = None,
                   scale: float = 1.0, pyramid: bool = False, in_range=None,
                   slide_key=None, classes=None) -> Tuple[bytes, dict]:
        """Windowed inference for ``roi=(r0, c0, h, w)``
        (``unmicst_tpu/serve.py:828-946``): a band with one net tile of
        context on all four sides, inferred on the whole engine, trimmed
        to the ROI.

        The band's extents snap to the whole slide's tile grid and are
        bucketed to multiples of two sub-strides.  So pans of one window
        size reuse a handful of band shapes (cuDNN chooses algorithms for
        each shape once), and at ``scale == 1`` the band shares the whole
        slide's grid origin: with a pinned ``range=`` every ROI equals the
        whole-slide run's crop, at any offset.

        A cached slide (``slide_key``) pans on the card: its pinned plane
        is sliced there and K2 writes only the ROI, so no pixels go up and
        only ``h * w * K`` bytes come down."""
        r0, c0, h, w = (int(v) for v in roi)
        eng = self.engine(model)
        a, b, ca, cb = roi_band(roi, shape, eng.hp)
        if (b - a) * (cb - ca) > self.stream_above_px:
            raise ValueError(
                f"roi window of {(b - a)}x{(cb - ca)} px (incl. context) "
                f"exceeds the windowed-inference bound "
                f"{self.stream_above_px}; request a smaller window or "
                "drop roi= to stream the whole slide"
            )
        rng = in_range if len(srcs) > 1 or in_range is None else in_range[0]
        plane = self._device_plane_for(slide_key, srcs, eng)
        if plane is not None:
            t0 = time.perf_counter()
            pan = (eng.infer_slide_stack_device if len(srcs) > 1
                   else eng.infer_slide_device)
            maps = run_on_device(
                self.device, pan, plane, a, ca, b - a, cb - ca,
                outlier=outlier, rescale=rescale, scaling_factor=scale,
                in_range=rng, trim=(r0 - a, c0 - ca, h, w), classes=classes)
            infer_s = time.perf_counter() - t0
            self._count(device_pans=1)
        else:
            bands = [
                # read_rows takes (start, count)
                np.ascontiguousarray(s.read_rows(a, b - a)[:, ca:cb])
                for s in srcs
            ]
            t0 = time.perf_counter()
            run = (eng.infer_slide_stack if len(bands) > 1
                   else eng.infer_slide)
            maps = run_on_device(
                self.device, run, bands if len(bands) > 1 else bands[0],
                outlier=outlier, rescale=rescale, scaling_factor=scale,
                in_range=rng, classes=classes)
            infer_s = time.perf_counter() - t0
            # the host path infers the whole band: crop here
            maps = np.ascontiguousarray(
                maps[:, r0 - a : r0 - a + h, c0 - ca : c0 - ca + w]
            )
        return self._encode(
            maps, model, (h, w), h * w, infer_s, compress=compress,
            pyramid=pyramid, in_range=in_range, class_indices=classes,
        )

    def probe_range(self, path: str, channel, outlier: float,
                    channel_names=None) -> dict:
        """The upload's global per-channel rescale range, no inference:
        one bounded-memory histogram pass per channel.  A viewer calls it
        once per slide and pins ``range=lo,hi`` on every ROI request."""
        from unmicst_tpu_torch.io.slides import (open_channel_source,
                                                 sniff_format)

        fmt = sniff_format(path)
        if channel_names is not None:
            channels = _resolve_channel_names(path, fmt, channel_names)
        else:
            channels = _channels(channel)
        with contextlib.ExitStack() as stack:
            srcs = [
                stack.enter_context(open_channel_source(path, fmt, c))
                for c in channels
            ]
            shape = (srcs[0].height, srcs[0].width)
            if any((s.height, s.width) != shape for s in srcs):
                raise ValueError("channel planes disagree on dimensions")
            return {
                "shape": list(shape),
                "outlier": outlier,
                "channels": channels,
                "range": [list(s.stats(outlier)) for s in srcs],
            }

    def _encode(self, maps, model: str, shape, raw_size: int,
                infer_s: float, compress: Optional[str] = None,
                pyramid: bool = False, in_range=None,
                class_indices=None) -> Tuple[bytes, dict]:
        from unmicst_tpu_torch.io.tiff import TiffWriter

        buf = tempfile.NamedTemporaryFile(suffix=".tif", delete=False)
        buf.close()
        try:
            with TiffWriter(buf.name, bigtiff=True,
                            compression=compress or None) as tw:
                for k in range(maps.shape[0] - 1, -1, -1):  # reversed order
                    if pyramid:
                        tw.write_pyramid(maps[k])
                    else:
                        tw.write(maps[k])
            with open(buf.name, "rb") as f:
                out = f.read()
        finally:
            os.unlink(buf.name)
        meta = {
            "model": model,
            "shape": list(shape),
            "classes": int(maps.shape[0]),
            "infer_s": round(infer_s, 3),
            "mpx_per_s": round(raw_size / 1e6 / max(infer_s, 1e-9), 2),
        }
        if class_indices is not None:
            # which class each page is (reversed, like the page order)
            meta["class_indices"] = [int(c) for c in class_indices]
        if in_range is not None:
            meta["in_range"] = [list(p) for p in in_range]
        return out, meta


def _spool(rfile, length: int, out, digest=None) -> None:
    """Copy ``length`` body bytes to ``out`` in chunks; ConnectionError
    when the client hangs up first."""
    remaining = length
    while remaining:
        chunk = rfile.read(min(remaining, 16 << 20))
        if not chunk:
            raise ConnectionError("client hung up mid-body")
        if digest is not None:
            digest.update(chunk)
        out.write(chunk)
        remaining -= len(chunk)


def make_handler(server: ModelServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: dict, headers: dict = None):
            blob = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(blob)

        def _client_error(self, code: int, error: str):
            server._count(client_error=1)
            self._json(code, {"error": error})

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                self._json(200, {"status": "ok",
                                 "devices": card_names(server.device)})
            elif url.path == "/stats":
                self._json(200, server.snapshot())
            elif url.path == "/models":
                from unmicst_tpu_torch.cli import DEFAULT_MODEL_ROOTS
                from unmicst_tpu_torch.models.zoo import available_models

                root = server.model_root or next(
                    (r for r in DEFAULT_MODEL_ROOTS if r and os.path.isdir(r)),
                    "")
                self._json(200, available_models(root) if root else {})
            else:
                self._json(404, {"error": "not found"})

        def do_DELETE(self):
            url = urlparse(self.path)
            if not url.path.startswith("/slides/"):
                self._json(404, {"error": "not found"})
                return
            server._count(requests=1)
            sid = url.path[len("/slides/"):]
            if server.drop_slide(sid):
                server._count(ok=1)
                self._json(200, {"dropped": sid})
            else:
                self._client_error(404, f"unknown slide id {sid!r}")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/slides":
                server._count(requests=1)
                self._upload_slide(url)
                return
            if url.path != "/infer":
                self._json(404, {"error": "not found"})
                return
            server._count(requests=1)
            got_slot = (
                not server._zero_inflight
                and server._inflight.acquire(timeout=server.queue_timeout_s)
            )
            if not got_slot:
                server._count(busy_rejected=1)
                # read a bounded amount of the body first, so the client
                # sees the 503 instead of a reset mid-upload
                try:
                    remaining = min(
                        int(self.headers.get("Content-Length", "0") or 0),
                        64 << 20,
                    )
                    while remaining > 0:
                        chunk = self.rfile.read(min(remaining, 1 << 20))
                        if not chunk:
                            break
                        remaining -= len(chunk)
                except (OSError, ValueError):
                    pass  # malformed header: still send the 503
                self._json(503, {
                    "error": f"server busy ({server.max_inflight} "
                    "requests in flight); retry later"
                }, headers={"Retry-After": "5"})
                return
            try:
                self._infer(url)
            finally:
                server._inflight.release()

        def _prewarm_params(self, q) -> Optional[dict]:
            """``?prewarm=1&model=M&roi=H,W`` (with the usual channel,
            channel_name, range, rescale, outlier, scale and classes) ->
            :meth:`ModelServer.prewarm_slide`'s keywords, or None."""
            if not _parse_bool(q.get("prewarm", ["0"])[0], "prewarm"):
                return None
            model = q.get("model", ["nucleiDAPI"])[0]
            if not _plain_model_name(model):
                raise ValueError("model must be a plain model name")
            if "roi" not in q:
                raise ValueError("prewarm=1 requires roi=H,W (the pan "
                                 "window size to warm)")
            parts = q["roi"][0].split(",")
            if len(parts) == 1:
                parts = parts * 2  # roi=512 -> a square window
            if len(parts) != 2:
                raise ValueError(f"prewarm roi must be H,W — got "
                                 f"{q['roi'][0]!r}")
            roi_h, roi_w = (int(v) for v in parts)
            if roi_h <= 0 or roi_w <= 0:
                raise ValueError(f"prewarm roi must be positive, got "
                                 f"{roi_h},{roi_w}")
            chan_vals = _parse_channels(q)
            scale = float(q.get("scale", ["1"])[0])
            if not 0.01 <= scale <= 16:
                raise ValueError(f"scale must be in [0.01, 16], got {scale}")
            return dict(
                model=model, roi_h=roi_h, roi_w=roi_w,
                channel=chan_vals[0] if len(chan_vals) == 1 else chan_vals,
                rescale=_parse_bool(q.get("rescale", ["1"])[0], "rescale"),
                outlier=float(q.get("outlier", ["-1"])[0]),
                scale=scale, in_range=_parse_range(q),
                channel_names=_parse_channel_names(q),
                classes=_parse_classes(q),
            )

        def _upload_slide(self, url):
            """POST /slides: spool the body (sha256 while spooling), adopt
            it into the cache -> {"slide_id"}; ``prewarm=1`` also queues
            :meth:`ModelServer.prewarm_slide` (progress in /stats)."""
            import hashlib

            try:
                prewarm = self._prewarm_params(parse_qs(url.query))
            except ValueError as e:
                self._client_error(400, f"bad parameter: {e}")
                return
            try:
                length = int(self.headers.get("Content-Length", "0") or 0)
            except ValueError:
                length = -1
            if length <= 0:
                self._client_error(411, "Content-Length required")
                return
            if length > server.max_body_bytes:
                self._client_error(413, f"request body {length} B exceeds "
                                   f"the {server.max_body_bytes} B limit")
                return
            h = hashlib.sha256()
            tmp = tempfile.NamedTemporaryFile(suffix=".slide", delete=False)
            try:
                _spool(self.rfile, length, tmp, h)
                tmp.close()
                res = server.register_slide(tmp.name, length, h.hexdigest())
            except ConnectionError:
                tmp.close()
                os.unlink(tmp.name)
                server._count(client_error=1)
                return
            except Exception as e:  # noqa: BLE001 — surface, don't die
                tmp.close()
                try:
                    os.unlink(tmp.name)
                except OSError:
                    pass
                server._count(server_error=1)
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if prewarm is not None:
                res = dict(res, prewarm=server.schedule_prewarm(
                    res["slide_id"], **prewarm))
            server._count(ok=1)
            self._json(200, res)

        def _infer(self, url):
            q = parse_qs(url.query)
            model = q.get("model", ["nucleiDAPI"])[0]
            if not _plain_model_name(model):
                self._client_error(400, "model must be a plain model name")
                return
            try:
                rescale = _parse_bool(q.get("rescale", ["1"])[0], "rescale")
                chan_vals = _parse_channels(q)
                channel = chan_vals[0] if len(chan_vals) == 1 else chan_vals
                channel_names = _parse_channel_names(q)
                outlier = float(q.get("outlier", ["-1"])[0])
                if outlier != -1 and not 0 <= outlier <= 100:
                    raise ValueError(
                        f"outlier must be -1 or in [0, 100], got {outlier}"
                    )
                compress = _parse_compress(q.get("compress", ["0"])[0])
                scale = float(q.get("scale", ["1"])[0])
                pyramid = _parse_bool(q.get("pyramid", ["0"])[0], "pyramid")
                use_pyramid = _parse_bool(q.get("usePyramid", ["0"])[0],
                                          "usePyramid")
                roi = None
                if "roi" in q:
                    parts = q["roi"][0].split(",")
                    if len(parts) != 4:
                        raise ValueError(
                            f"roi must be r0,c0,h,w — got {q['roi'][0]!r}"
                        )
                    roi = tuple(int(v) for v in parts)
                classes = _parse_classes(q)
                in_range = _parse_range(q)
                probe = q.get("probe", [None])[0]
                if probe is not None and probe != "range":
                    raise ValueError(
                        f"probe supports only 'range', got {probe!r}"
                    )
                slide_id = q.get("slide", [None])[0]
                if slide_id is not None and (
                        not slide_id
                        or any(c not in "0123456789abcdef"
                               for c in slide_id)):
                    raise ValueError(
                        f"slide must be a hex id from POST /slides, "
                        f"got {slide_id!r}"
                    )
                if not 0.01 <= scale <= 16:
                    raise ValueError(
                        f"scale must be in [0.01, 16], got {scale}"
                    )
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError as e:
                self._client_error(400, f"bad parameter: {e}")
                return
            if slide_id is not None and length > 0:
                self._client_error(400, "pass either a body or slide=, "
                                   "not both")
                return
            if slide_id is None and length <= 0:
                self._client_error(411, "Content-Length required")
                return
            if length > server.max_body_bytes:
                self._client_error(413, f"request body {length} B exceeds "
                                   f"the {server.max_body_bytes} B limit")
                return

            def run_on(path):
                if probe == "range":
                    res = server.probe_range(path, channel, outlier,
                                             channel_names=channel_names)
                    return None, {"model": model, "shape": res["shape"],
                                  "infer_s": 0.0}, res
                out, meta = server.infer_tiff_path(
                    path, model, channel, rescale, outlier,
                    compress=compress, scale=scale, pyramid=pyramid,
                    roi=roi, in_range=in_range, channel_names=channel_names,
                    slide_id=slide_id, classes=classes,
                    use_pyramid=use_pyramid,
                )
                return out, meta, None

            try:
                if slide_id is not None:
                    # a body-less request against a cached upload: the
                    # viewer's pans after the slide went up once
                    path = server.acquire_slide(slide_id)
                    try:
                        out, meta, probe_res = run_on(path)
                    finally:
                        server.release_slide(slide_id)
                    server._count(slide_hits=1)
                else:
                    # spool to disk: a whole-slide POST must not sit in RAM
                    # twice.  Only the spool treats ConnectionError as a
                    # client hang-up
                    with tempfile.NamedTemporaryFile(suffix=".tif") as tmp:
                        try:
                            _spool(self.rfile, length, tmp)
                            tmp.flush()
                        except ConnectionError:
                            server._count(client_error=1)
                            return
                        out, meta, probe_res = run_on(tmp.name)
            except FileNotFoundError as e:
                self._client_error(404, str(e))
                return
            except _READ_ERRORS as e:
                # an unported path names its ROADMAP item (501); otherwise
                # a bad upload: an unknown or corrupt container, a codec
                # the reader lacks, a missing channel, a truncated stream
                code = 501 if _is_not_ported(e) else 400
                self._client_error(code, f"{type(e).__name__}: {e}")
                return
            except Exception as e:  # surface, don't kill the server
                server._count(server_error=1)
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if out is None:  # probe=range: JSON, nothing inferred
                server._count(ok=1, by_model=meta["model"])
                self._json(200, probe_res)
                return
            server._count(
                ok=1, px_processed=meta["shape"][0] * meta["shape"][1],
                infer_s_total=meta["infer_s"], by_model=meta["model"],
            )
            self.send_response(200)
            self.send_header("Content-Type", "image/tiff")
            self.send_header("Content-Length", str(len(out)))
            self.send_header("X-UnMicst-Meta", json.dumps(meta))
            self.end_headers()
            self.wfile.write(out)

    return Handler


def serve(host: str = "0.0.0.0", port: int = 8800, preload=None,
          device="cuda", **kw) -> None:
    """Serve until SIGTERM/SIGINT, then drain (``unmicst_tpu/serve.py:
    1477-1512``).  ``preload``: model names whose engines are built before
    the port opens (a bad name fails the deploy, not the first
    request)."""
    import signal

    server = ModelServer(device=device, **kw)
    for name in (preload or []):
        t0 = time.perf_counter()
        server.engine(name)
        print(f"preloaded {name} in {time.perf_counter() - t0:.1f}s",
              flush=True)
    httpd = ThreadingHTTPServer((host, port), make_handler(server))
    # drain: stop accepting on SIGTERM/SIGINT, finish the requests in
    # flight (server_close joins the non-daemon handler threads), return
    httpd.daemon_threads = False

    def _drain(signum, frame):
        print(f"signal {signum}: draining in-flight requests...", flush=True)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _drain)
        except ValueError:
            pass  # not the main thread
    # the bound port (port=0 asks the OS for one)
    print(f"unmicst-tpu-torch serving on {host}:{httpd.server_address[1]} "
          f"({', '.join(card_names(server.device))})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
    print("drained; bye", flush=True)


def build_parser():
    import argparse

    def _positive(v):
        iv = int(v)
        if iv < 1:
            raise argparse.ArgumentTypeError("--maxInflight must be >= 1")
        return iv

    p = argparse.ArgumentParser(prog="python -m unmicst_tpu_torch.serve")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8800)
    p.add_argument("--modelRoot")
    p.add_argument(
        "--precision", choices=["float32", "highest", "bfloat16", "int8"],
        default="float32",  # parity mode (<= 1 uint8 level); bf16/int8 fast
    )
    p.add_argument("--maxBodyBytes", type=int, default=2 << 30,
                   help="reject request bodies beyond this size (HTTP 413)")
    p.add_argument("--calibrationPercentile", type=float, default=99.99,
                   help="int8 activation-scale clipping percentile")
    p.add_argument("--maxInflight", type=_positive, default=4,
                   help="concurrent /infer bound (>= 1); excess gets 503 + "
                   "Retry-After")
    p.add_argument("--slideCacheBytes", type=int, default=4 << 30,
                   help="byte bound of the POST /slides cache (LRU)")
    p.add_argument("--deviceSlideBytes", type=int, default=2 << 30,
                   help="device-memory bound of the pinned cached-slide "
                   "planes that roi= pans slice on the card; 0 disables")
    p.add_argument("--preload", default=None,
                   help="comma-separated model names to build at startup, "
                   "before the port opens")
    return p


def main(argv=None, *, device="cuda") -> int:
    """``python -m unmicst_tpu_torch.serve``.  ``device``: ``"cuda"`` (the
    default; no card raises) or ``"cpu"``, which only a caller may ask
    for."""
    args = build_parser().parse_args(argv)
    serve(args.host, args.port, model_root=args.modelRoot,
          precision=args.precision, max_body_bytes=args.maxBodyBytes,
          max_inflight=args.maxInflight,
          calibration_percentile=args.calibrationPercentile,
          slide_cache_bytes=args.slideCacheBytes,
          device_slide_bytes=args.deviceSlideBytes,
          preload=args.preload.split(",") if args.preload else None,
          device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
