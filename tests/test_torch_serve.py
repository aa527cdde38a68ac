"""The port's server (unmicst_tpu_torch.serve) on the CPU: the card-resident
pan path against the whole engine (0 levels), K2's trimmed region, the
caches, the HTTP statuses, the refusals, drain, preload, prewarm, int8
serving, and the process-wide conv flags under threads."""

import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from unmicst_tpu import serve as jax_serve
from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu_torch import infer as port_infer
from unmicst_tpu_torch import kernels, serve
from unmicst_tpu_torch.core import tiler
from unmicst_tpu_torch.core.checkpoint import (load_params_for_bundle,
                                               load_tf1_params,
                                               save_tf1_params)
from unmicst_tpu_torch.core.hp import HParams, load_model_dir, save_pickle
from unmicst_tpu_torch.infer import InferenceEngine
from unmicst_tpu_torch.io import slides
from unmicst_tpu_torch.io.tiff import TiffFile, TiffWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
DUO = os.path.join(REPO, "tests", "fixtures", "oracle_duo")
H, W = 300, 260


def _blob_slide(rng, h, w, n=20, top=65535):
    img = rng.rand(h, w).astype(np.float32) * 0.15
    rr, cc = np.ogrid[:h, :w]
    for _ in range(n):
        r, c = rng.randint(20, h - 20), rng.randint(20, w - 20)
        rad = rng.randint(5, 9)
        d2 = (rr - r) ** 2 + (cc - c) ** 2
        img[d2 < rad**2] = 0.7
        img[(d2 < (rad + 2) ** 2) & (d2 >= rad**2)] = 0.4
    return (np.clip(img, 0, 1) * top).astype(np.uint16)


def _write(path, *planes):
    with TiffWriter(str(path), bigtiff=False) as tw:
        for p in planes:
            tw.write(p)
    with open(path, "rb") as f:
        return f.read()


def _pages(blob):
    with tempfile.NamedTemporaryFile(suffix=".tif") as f:
        f.write(blob)
        f.flush()
        with TiffFile(f.name) as tf:
            return np.stack([tf.read_page(k) for k in range(len(tf.pages))])


class Live:
    """A server on a random local port."""

    def __init__(self, srv):
        self.srv = srv
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                         serve.make_handler(srv))
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def call(self, method, query, data=None):
        """(status, body bytes, headers); HTTP errors are returned."""
        req = urllib.request.Request(
            self.url + query, data=data, method=method,
            headers={"Content-Type": "application/octet-stream"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, r.read(), r.headers
        except urllib.error.HTTPError as e:
            return e.code, e.read(), e.headers

    def json(self, method, query, data=None):
        status, body, _ = self.call(method, query, data)
        return status, json.loads(body)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture(scope="module")
def live():
    srv = Live(serve.ModelServer(model_root=MODELS, device="cpu"))
    yield srv
    srv.close()


@pytest.fixture(scope="module")
def jax_server():
    return jax_serve.ModelServer(model_root=MODELS, precision="float32")


@pytest.fixture(scope="module")
def engine():
    bundle = load_model_dir(os.path.join(MODELS, "blobDemo"))
    return InferenceEngine.from_bundle(bundle, load_params_for_bundle(bundle),
                                       device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _warm(engine):
    """One forward before any comparison: in a process that has imported
    JAX, the first CPU forward can come out a float ulp from every later
    one (a uint8 level at a few pixels), which the 0-level bars below
    would read as a difference between two paths."""
    engine.infer_slide(np.zeros((64, 64), np.uint16))


@pytest.fixture(scope="module")
def blob():
    return _blob_slide(np.random.RandomState(5), H, W)


# -- io/slides.sniff_format ----------------------------------------------------


@pytest.mark.parametrize("head,want", [
    (b"II*\x00", "tif"), (b"II+\x00", "tif"), (b"MM\x00*", "tif"),
    (b"MM\x00+", "tif"), (b"ZISRAWFILE", "item 6"),
    (b"\xda\xce\xbe\x0a", "item 6"), (b"GIF89a", "unrecognized"),
])
def test_sniff_format(tmp_path, head, want):
    """TIFF and BigTIFF in both byte orders are "tif"; CZI and ND2 magic
    (the "item 6" cases, which refused before the readers were ported)
    are "czi" and "nd2", as in JAX; anything else raises JAX's ValueError
    text."""
    p = tmp_path / "x"
    p.write_bytes(head + bytes(16))
    if want == "tif":
        assert slides.sniff_format(str(p)) == "tif"
        assert jax_slides.sniff_format(str(p)) == "tif"
    elif want == "item 6":
        fmt = "czi" if head.startswith(b"Z") else "nd2"
        assert slides.sniff_format(str(p)) == fmt
        assert jax_slides.sniff_format(str(p)) == fmt
    else:
        with pytest.raises(ValueError) as ours:
            slides.sniff_format(str(p))
        with pytest.raises(ValueError) as theirs:
            jax_slides.sniff_format(str(p))
        assert str(ours.value) == str(theirs.value)


# -- K2's trimmed region ---------------------------------------------------------


@pytest.mark.parametrize("shape,trim,classes,quantize", [
    ((300, 260), (0, 0, 300, 260), None, True),
    ((300, 260), (37, 41, 90, 70), None, True),
    ((300, 260), (299, 259, 1, 1), (2, 0), True),
    ((300, 260), (5, 3, 17, 255), (1,), False),
    ((130, 97), (64, 0, 66, 97), None, True),
])
def test_k2_trim_equals_the_crop(shape, trim, classes, quantize):
    """K2's slide epilogue with ``trim`` is the untrimmed maps' crop,
    0 apart (the plain version the CPU runs; the card case is in
    tests/test_torch_cuda.py)."""
    g = torch.Generator().manual_seed(1)
    grid = tiler.make_grid(*shape, 64, 16)
    window = torch.from_numpy(tiler.ramp_window(64, 16))
    w = torch.softmax(torch.randn(grid.num_tiles, 3, 64, 64, generator=g), 1)
    w = w * window
    full = kernels.blend_fold_epilogue(w, window, grid, classes, quantize)
    tr, tc, th, tw = trim
    got = kernels.blend_fold_epilogue(w, window, grid, classes, quantize,
                                      trim=trim)
    assert torch.equal(got, full[:, tr:tr + th, tc:tc + tw])
    assert torch.equal(got, kernels.blend_fold_epilogue_plain(
        w, window, grid, classes, quantize, trim))


@pytest.mark.parametrize("trim", [(-1, 0, 5, 5), (0, -1, 5, 5),
                                  (0, 0, 0, 5), (0, 0, 5, 0),
                                  (296, 0, 5, 5), (0, 256, 1, 5)])
def test_k2_trim_out_of_band_raises(trim):
    grid = tiler.make_grid(300, 260, 64, 16)
    window = torch.from_numpy(tiler.ramp_window(64, 16))
    w = torch.zeros(grid.num_tiles, 3, 64, 64)
    with pytest.raises(ValueError, match="outside"):
        kernels.blend_fold_epilogue(w, window, grid, trim=trim)


# -- the pan path of the engine ---------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"outlier": 99.0}, {"in_range": (1000, 50000)},
    {"classes": (2, 0)}, {"rescale": False}, {"scaling_factor": 0.5},
    {"scaling_factor": 0.65, "in_range": (0, 65535)},
])
@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
def test_device_pan_equals_infer_slide_of_the_band(engine, blob, kw, dtype):
    """infer_slide_device on a pinned plane is infer_slide of the sliced
    band, 0 apart; its trim= is the crop of that, 0 apart."""
    raw = blob if dtype == np.uint16 else (blob >> 8).astype(np.uint8)
    plane = engine.device_plane(raw)
    assert plane.nbytes == raw.nbytes and plane.dtype == raw.dtype
    r0, c0, h, w = 40, 28, 192, 160
    want = engine.infer_slide(raw[r0:r0 + h, c0:c0 + w], **kw)
    got = engine.infer_slide_device(plane, r0, c0, h, w, **kw)
    np.testing.assert_array_equal(got, want)
    trim = (23, 9, 100, 77)
    cut = engine.infer_slide_device(plane, r0, c0, h, w, trim=trim, **kw)
    np.testing.assert_array_equal(cut, want[:, 23:123, 9:86])


def test_device_plane_keeps_the_raw_width(engine, blob):
    """uint16 stays two bytes a pixel on the device (its int16 bits);
    float32 takes the parity cast to uint16."""
    plane = engine.device_plane(blob)
    assert plane.data.dtype == torch.int16 and plane.nbytes == blob.nbytes
    f = engine.device_plane(blob.astype(np.float32) + 0.25)
    assert f.dtype == np.uint16 and torch.equal(f.data, plane.data)


@pytest.mark.parametrize("args,match", [
    ((-1, 0, 64, 64), "outside"), ((0, 0, 301, 64), "outside"),
    ((250, 200, 64, 64), "outside"), ((0, 0, 0, 64), "outside"),
])
def test_device_pan_bands_never_clamp(engine, blob, args, match):
    plane = engine.device_plane(blob)
    with pytest.raises(ValueError, match=match):
        engine.infer_slide_device(plane, *args)


def test_device_pan_refusals(engine, blob):
    plane = engine.device_plane(blob)
    with pytest.raises(ValueError, match="outside"):
        engine.infer_slide_device(plane, 0, 0, 64, 64, trim=(60, 0, 8, 8))
    with pytest.raises(ValueError, match="2-D"):
        engine.infer_slide_device(engine.device_plane(blob[None]), 0, 0, 8, 8)
    with pytest.raises(ValueError, match="channels"):
        engine.infer_slide_stack_device(plane, 0, 0, 64, 64)
    with pytest.raises(ValueError, match="in_range requires"):
        engine.infer_slide_device(plane, 0, 0, 64, 64, rescale=False,
                                  in_range=(0, 1))


# -- ROIs against the whole slide ------------------------------------------------


@pytest.mark.parametrize("roi", [(203, 37, 61, 155), (3, 200, 97, 59),
                                 (149, 1, 150, 258)])
@pytest.mark.parametrize("cached", [False, True])
def test_roi_with_pinned_range_is_the_whole_slide_crop(tmp_path, blob, roi,
                                                       cached):
    """Band snapping puts every ROI on the whole slide's tile grid: with a
    pinned range any offset equals the whole-slide run's crop, 0 apart,
    on the host path and on the card-resident pan path."""
    srv = serve.ModelServer(model_root=MODELS, device="cpu")
    body = _write(tmp_path / "s.tif", blob)
    rng = [(0.0, 65535.0)]
    full, _ = srv.infer_tiff(body, "blobDemo", 0, True, -1, in_range=rng)
    sid = None
    if cached:
        spool = tmp_path / "spool"
        spool.write_bytes(body)
        sid = srv.register_slide(str(spool), len(body),
                                 hashlib.sha256(body).hexdigest())["slide_id"]
    path = srv.acquire_slide(sid) if cached else str(tmp_path / "s.tif")
    out, meta = srv.infer_tiff_path(path, "blobDemo", 0, True, -1, roi=roi,
                                    in_range=rng, slide_id=sid)
    r0, c0, h, w = roi
    np.testing.assert_array_equal(_pages(out),
                                  _pages(full)[:, r0:r0 + h, c0:c0 + w])
    assert meta["shape"] == [h, w]
    assert srv.snapshot()["device_pans"] == int(cached)


# -- duo pans ----------------------------------------------------------------


@pytest.fixture(scope="module")
def duo_root(tmp_path_factory):
    """A duo model directory written by the port's save_tf1_params from the
    oracle_duo weights, with pickled sidecars."""
    with open(os.path.join(DUO, "hp.json")) as f:
        ref = json.load(f)
    hp = HParams.from_ref_dict(ref)
    state = load_tf1_params(os.path.join(DUO, "model.ckpt"), hp, "v2")
    root = tmp_path_factory.mktemp("zoo")
    d = root / "duoTest"
    d.mkdir()
    save_tf1_params(str(d / "model.ckpt"), state, hp, "v2")
    for name, obj in (("hp.data", hp.to_ref_dict()),
                      ("datasetMean.data", 0.18), ("datasetStDev.data", 0.17)):
        save_pickle(obj, str(d / name))
    return str(root)


@pytest.mark.parametrize("kw", [{}, {"in_range": [(0, 60000), (10, 40000)]},
                                {"classes": (1,)}])
def test_duo_pans_device_equals_host_and_jax(tmp_path, duo_root, kw):
    """Duo pans pin a [C, H, W] stack: device pans equal the host path
    (0 apart) and the JAX server on the same directory (1 level)."""
    rng = np.random.RandomState(9)
    _write(tmp_path / "d.tif", _blob_slide(rng, 200, 180),
           _blob_slide(rng, 200, 180, top=40000))
    path = str(tmp_path / "d.tif")
    srv = serve.ModelServer(model_root=duo_root, device="cpu")
    common = dict(roi=(30, 40, 64, 70), **kw)
    host, _ = srv.infer_tiff_path(path, "duoTest", [0, 1], True, -1, **common)
    dev1, _ = srv.infer_tiff_path(path, "duoTest", [0, 1], True, -1,
                                  slide_id="ab", **common)
    dev2, _ = srv.infer_tiff_path(path, "duoTest", [0, 1], True, -1,
                                  slide_id="ab", **common)
    assert host == dev1 == dev2
    st = srv.snapshot()
    assert st["device_pins"] == 1 and st["device_pans"] == 2
    jax_out, _ = jax_serve.ModelServer(model_root=duo_root).infer_tiff_path(
        path, "duoTest", [0, 1], True, -1, slide_id="ab", **common)
    d = np.abs(_pages(jax_out).astype(int) - _pages(dev1).astype(int))
    assert d.max() <= 1


# -- int8 serving ------------------------------------------------------------


def test_int8_server_calibrates_once(tmp_path, blob, monkeypatch):
    """--precision int8: the engine calibrates on its first slide and that
    state serves every later request (the cached pans after it pin the
    plane and pan on it); the maps stay within
    the JAX CLI's int8 bar against float32 (tests/test_cli.py:181-184)."""
    from unmicst_tpu_torch.core import quant

    calls = []
    real = quant.calibrate

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(quant, "calibrate", counting)
    body = _write(tmp_path / "s.tif", blob)
    s8 = Live(serve.ModelServer(model_root=MODELS, precision="int8",
                                device="cpu"))
    s32 = Live(serve.ModelServer(model_root=MODELS, device="cpu"))
    try:
        st, a, _ = s8.call("POST", "/infer?model=blobDemo", body)
        assert st == 200
        st, b, _ = s32.call("POST", "/infer?model=blobDemo", body)
        assert st == 200
        p8, p32 = _pages(a).astype(int), _pages(b).astype(int)
        diff = np.abs(p8 - p32)
        assert diff.mean() < 6.0 and np.percentile(diff, 99) <= 60
        assert (p8.argmax(0) != p32.argmax(0)).mean() < 0.04
        _, up = s8.json("POST", "/slides", body)
        for _ in range(2):
            st, _, _ = s8.call("POST", f"/infer?model=blobDemo&slide="
                               f"{up['slide_id']}&roi=40,40,80,80")
            assert st == 200
        assert len(calls) == 1
        stats = s8.srv.snapshot()
        assert stats["device_pins"] == 1 and stats["device_pans"] == 2
        eng8 = s8.srv.engine("blobDemo")
        assert eng8.quantized and eng8._quant is not None
    finally:
        s8.close()
        s32.close()


# -- the HTTP surface -------------------------------------------------------------


def test_healthz_models_stats(live):
    st, health = live.json("GET", "/healthz")
    assert st == 200 and health == {"status": "ok", "devices": ["cpu"]}
    st, models = live.json("GET", "/models")
    assert models["blobDemo"] == "ready (local)"
    st, stats = live.json("GET", "/stats")
    for key in ("requests", "ok", "client_error", "busy_rejected",
                "slides_cached", "device_planes_pinned", "uptime_s"):
        assert key in stats
    assert live.call("GET", "/nothing")[0] == 404


def test_stats_count_success_and_errors(live, tmp_path, blob):
    _, before = live.json("GET", "/stats")
    body = _write(tmp_path / "s.tif", blob[:96, :112])
    assert live.call("POST", "/infer?model=blobDemo", body)[0] == 200
    assert live.call("POST", "/infer?model=blobDemo", b"zz")[0] == 400
    _, after = live.json("GET", "/stats")
    assert after["requests"] == before["requests"] + 2
    assert after["ok"] == before["ok"] + 1
    assert after["client_error"] == before["client_error"] + 1
    assert after["px_processed"] == before["px_processed"] + 96 * 112
    assert after["by_model"]["blobDemo"] >= 1


def test_slide_cache_delete_and_deferred_drop(live, tmp_path, blob):
    """POST /slides dedups; body-less slide= requests answer as the body
    request does; DELETE frees now (404 after, 404 on unknown ids); a
    re-upload revives; a drop with a reader in flight waits for it."""
    body = _write(tmp_path / "c.tif", blob[:120, :90])
    st, up = live.json("POST", "/slides", body)
    assert st == 200 and not up["deduplicated"]
    assert live.json("POST", "/slides", body)[1]["deduplicated"]
    sid = up["slide_id"]
    with_body = live.call("POST", "/infer?model=blobDemo", body)[1]
    assert live.call("POST", f"/infer?model=blobDemo&slide={sid}")[1] \
        == with_body
    assert live.json("DELETE", f"/slides/{sid}") == (200, {"dropped": sid})
    for method, q in [("POST", f"/infer?model=blobDemo&slide={sid}"),
                      ("DELETE", f"/slides/{sid}"),
                      ("DELETE", f"/slides/{'0' * 32}"),
                      ("DELETE", "/nope")]:
        assert live.call(method, q)[0] == 404, q
    assert not live.json("POST", "/slides", body)[1]["deduplicated"]

    srv = serve.ModelServer(model_root=MODELS, device="cpu")
    spool = tmp_path / "spool"
    spool.write_bytes(body)
    sid2 = srv.register_slide(str(spool), len(body),
                              hashlib.sha256(body).hexdigest())["slide_id"]
    path = srv.acquire_slide(sid2)
    assert srv.drop_slide(sid2) and os.path.exists(path)
    assert not srv.drop_slide(sid2)
    assert srv.snapshot()["slide_drops"] == 1
    with pytest.raises(FileNotFoundError):
        srv.acquire_slide(sid2)
    srv.release_slide(sid2)
    assert not os.path.exists(path)


def test_slide_cache_lru_and_device_budget(tmp_path):
    """The disk cache evicts least recently used slides past its bytes;
    the device cache pins within its budget, evicts LRU planes, serves an
    over-budget slide from the host path, and pins nothing when off."""
    rng = np.random.RandomState(2)
    plane_bytes = 150 * 130 * 2
    lv = Live(serve.ModelServer(model_root=MODELS, device="cpu",
                                slide_cache_bytes=100_000,
                                device_slide_bytes=int(plane_bytes * 1.5)))
    try:
        sids = []
        for i in range(3):
            body = _write(tmp_path / f"e{i}.tif", _blob_slide(rng, 150, 130))
            sids.append(lv.json("POST", "/slides", body)[1]["slide_id"])
        for sid in sids[1:]:
            assert lv.call("POST", f"/infer?model=blobDemo&slide={sid}"
                           "&roi=50,50,40,40")[0] == 200
        st = lv.srv.snapshot()
        assert st["device_pins"] == 2 and st["device_planes_pinned"] == 1
        assert st["device_plane_bytes_used"] == plane_bytes
        # 3 x ~39 kB > 100 kB: the oldest upload went
        assert lv.call("POST", f"/infer?model=blobDemo&slide={sids[0]}")[0] \
            == 404
        big = _write(tmp_path / "big.tif", _blob_slide(rng, 300, 200))
        sid = lv.json("POST", "/slides", big)[1]["slide_id"]
        assert lv.call("POST", f"/infer?model=blobDemo&slide={sid}"
                       "&roi=50,50,40,40")[0] == 200
        assert lv.srv.snapshot()["device_pins"] == 2  # over budget
        lv.srv.device_slide_bytes = 0
        small = _write(tmp_path / "s.tif", _blob_slide(rng, 150, 130))
        sid = lv.json("POST", "/slides", small)[1]["slide_id"]
        pans = lv.srv.snapshot()["device_pans"]
        assert lv.call("POST", f"/infer?model=blobDemo&slide={sid}"
                       "&roi=10,10,40,40")[0] == 200
        st = lv.srv.snapshot()
        assert st["device_pans"] == pans and st["device_pins"] == 2
    finally:
        lv.close()


def test_body_limits_411_413_and_busy_503(tmp_path):
    lv = Live(serve.ModelServer(model_root=MODELS, device="cpu",
                                max_body_bytes=1000))
    busy = Live(serve.ModelServer(model_root=MODELS, device="cpu",
                                  max_inflight=0, queue_timeout_s=0.1))
    try:
        assert lv.call("POST", "/infer?model=blobDemo", b"x" * 2000)[0] == 413
        assert lv.call("POST", "/slides", b"x" * 2000)[0] == 413
        assert lv.call("POST", "/infer?model=blobDemo", b"")[0] == 411
        assert lv.call("POST", "/slides", b"")[0] == 411
        st, body, headers = busy.call("POST", "/infer?model=blobDemo", b"xx")
        assert st == 503 and headers.get("Retry-After") == "5"
        assert "busy" in json.loads(body)["error"]
        stats = busy.srv.snapshot()
        assert (stats["requests"], stats["busy_rejected"], stats["ok"]) \
            == (1, 1, 0)
    finally:
        lv.close()
        busy.close()


@pytest.mark.parametrize("query", [
    "channel=x", "channel=,", "channel=0,1,2", "rescale=maybe",
    "compress=gzip", "outlier=150", "outlier=nan", "scale=0",
    "roi=1,2,3", "range=1", "range=5,1", "classes=,", "classes=a",
    "probe=max", "slide=XYZ", "channel_name=a&channel_name=b&channel_name=c",
    "model=../x", "model=/etc", "model=a/b",
])
def test_bad_parameters_get_400(live, tmp_path, blob, query):
    body = _write(tmp_path / "b.tif", blob[:64, :64])
    if not query.startswith("model="):
        query = "model=blobDemo&" + query
    assert live.call("POST", "/infer?" + query, body)[0] == 400


def test_hostile_bodies_never_500(live, tmp_path):
    """Mutated and garbage bodies come back 4xx, never 500, and the server
    stays healthy."""
    rng = np.random.RandomState(99)
    valid = _write(tmp_path / "b.tif",
                   (rng.rand(40, 50) * 255).astype(np.uint8))
    bodies = [b"garbage", b"II*\0" + bytes(rng.bytes(64)),
              b"II+\0" + bytes(rng.bytes(64))]
    for _ in range(12):
        b = bytearray(valid)
        for _ in range(rng.randint(1, 8)):
            b[rng.randint(0, len(b))] ^= 1 << rng.randint(0, 8)
        bodies.append(bytes(b))
    statuses = [live.call("POST", "/infer?model=blobDemo", b)[0]
                for b in bodies]
    assert all(s in (200, 400, 404) for s in statuses), statuses
    assert live.call("GET", "/healthz")[0] == 200


@pytest.mark.parametrize("query,head,item", [
    ("usePyramid=1&scale=0.5", None, "M14"),
    ("pyramid=1", None, "M14"),
    ("compress=zstd", None, "M14"),
    ("", b"ZISRAWFILE", "item 6"),
    ("", b"\xda\xce\xbe\x0a", "item 6"),
])
def test_unported_paths_answer_501(live, jax_server, tmp_path, blob, query,
                                  head, item):
    """These cases answered 501 naming ROADMAP M14 and item 6 before the
    paths were ported; now each answers 200, as the JAX server does, with
    pages within 1 uint8 level of its pages for the same body (the
    pyramid body is a pyramidal TIFF, so ``usePyramid=1`` reads its stored
    level; the CZI is zstd1 hi-lo, the ND2 two-component)."""
    from tests.test_slides_czi_nd2 import write_czi, write_nd2

    plane = blob[:128, :128]
    path = tmp_path / "b"
    if head == b"ZISRAWFILE":
        write_czi(str(path), [plane], compression=6, hilo=True)
    elif head:
        write_nd2(str(path), [np.stack([plane, plane[::-1]], -1)])
    else:
        with TiffWriter(str(path), bigtiff=False) as tw:
            tw.write_pyramid(plane, tile=(16, 16), min_size=16)
    body = path.read_bytes()
    st, got, _ = live.call("POST", "/infer?model=blobDemo&" + query, body)
    assert st == 200, got
    q = dict(kv.split("=") for kv in query.split("&") if kv)
    want, _ = jax_server.infer_tiff_path(
        str(path), "blobDemo", 0, True, -1, compress=q.get("compress"),
        scale=float(q.get("scale", 1)), pyramid="pyramid" in q,
        use_pyramid="usePyramid" in q)
    a, b = _pages(got), _pages(want)
    assert a.shape == b.shape == (3, 128, 128)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    with tempfile.NamedTemporaryFile(suffix=".tif") as f:
        f.write(got)
        f.flush()
        with TiffFile(f.name) as tf:
            page = tf.pages[0]
            assert page.compression == (50000 if "compress" in q else 1)
            assert page.tiled == ("pyramid" in q)


def test_refusals_that_stay(live, tmp_path, blob, monkeypatch,
                            jax_server):
    """zstd without the host's libzstd answers 501 naming M14b, before any
    inference; a CZI of JPEG sub-blocks that do not decode 400, and one of
    JPEG XR sub-blocks 400, as the JAX server answers (without
    imagecodecs)."""
    from tests.test_slides_czi_nd2 import _write_czi_blocks
    from unmicst_tpu_torch.io import zstd

    bodies = {}
    for comp in (2, 4):
        p = tmp_path / f"c{comp}.czi"
        _write_czi_blocks(str(p), [(dict(X=(0, 8), Y=(0, 8), C=(0, 1)),
                                    bytes(64))], pixel_type=0,
                          compression=comp)
        bodies[comp] = p.read_bytes()
    st, res = live.json("POST", "/infer?model=blobDemo", bodies[2])
    assert st == 400 and "failed to decode" in res["error"]
    with pytest.raises(ValueError, match="failed to decode"):
        jax_slides.read_channel(str(tmp_path / "c2.czi"), "czi", 0)
    st, res = live.json("POST", "/infer?model=blobDemo", bodies[4])
    assert st == 400 and "JPEG XR" in res["error"]
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd, "_checked", True)
    st, res = live.json("POST", "/infer?model=blobDemo&compress=zstd",
                        _write(tmp_path / "b.tif", blob[:64, :64]))
    assert st == 501 and "ROADMAP M14b" in res["error"]


def test_jpeg_czi_body_answers_as_its_pixels_as_a_tiff(live, tmp_path,
                                                       blob):
    """A CZI of JPEG sub-blocks (a baseline and a progressive tile) answers
    200 with the maps of the same decoded pixels posted as a TIFF."""
    import io

    from PIL import Image

    from tests.test_slides_czi_nd2 import _write_czi_blocks
    from unmicst_tpu_torch.io import jpeg

    plane = (blob[:96, :160] >> 8).astype(np.uint8)
    tiles, pixels = [], np.zeros_like(plane)
    for c0, progressive in ((0, False), (80, True)):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(plane[:, c0:c0 + 80]), "L").save(
            buf, "JPEG", quality=90, progressive=progressive)
        tiles.append((dict(X=(c0, 80), Y=(0, 96), C=(0, 1)), buf.getvalue()))
        pixels[:, c0:c0 + 80] = jpeg.decode(buf.getvalue())
    path = tmp_path / "j.czi"
    _write_czi_blocks(str(path), tiles, pixel_type=0, compression=2)
    st, got, _ = live.call("POST", "/infer?model=blobDemo",
                           path.read_bytes())
    assert st == 200, got
    st, want, _ = live.call("POST", "/infer?model=blobDemo",
                            _write(tmp_path / "j.tif", pixels))
    assert st == 200
    a, b = _pages(got), _pages(want)
    assert a.shape == (3, 96, 160)
    np.testing.assert_array_equal(a, b)


def test_concurrent_requests_equal_serial(live, tmp_path, blob):
    """Four simultaneous POSTs answer what one at a time answers."""
    body = _write(tmp_path / "c.tif", blob[:130, :150])
    want = live.call("POST", "/infer?model=blobDemo&outlier=99", body)[1]
    got = [None] * 4

    def post(i):
        got[i] = live.call("POST", "/infer?model=blobDemo&outlier=99", body)[1]

    threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert all(g == want for g in got)


def test_engine_calls_run_on_one_worker_thread(tmp_path, blob, monkeypatch):
    """Requests arrive on new threads, and every engine call of theirs
    runs on the one worker thread of the device (cuDNN keeps its
    autotuned algorithms per thread)."""
    lv = Live(serve.ModelServer(model_root=MODELS, device="cpu"))
    eng = lv.srv.engine("blobDemo")
    names = []
    for name in ("infer_slide", "infer_slide_device", "device_plane"):
        real = getattr(eng, name)

        def spy(*a, _real=real, **k):
            names.append(threading.current_thread().name)
            return _real(*a, **k)

        monkeypatch.setattr(eng, name, spy)
    body = _write(tmp_path / "w.tif", blob[:120, :100])
    try:
        sid = lv.json("POST", "/slides", body)[1]["slide_id"]
        threads = [threading.Thread(target=lv.call, args=(
            "POST", f"/infer?model=blobDemo&slide={sid}"
            + ("&roi=10,10,50,50" if i % 2 else ""))) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        lv.close()
    assert len(names) == 5 and len(set(names)) == 1, names
    assert names[0].startswith("unmicst-cpu_")
    assert serve.run_on_device("cpu", threading.current_thread) \
        is not threading.current_thread()


# -- prewarm --------------------------------------------------------------------


def test_prewarm_on_upload(live, tmp_path, blob):
    """POST /slides?prewarm=1 warms the <= 4 band shapes in the background
    (prewarmed += 4, or 2 for a full-width window), a window larger than
    the slide lands in prewarm_errors, bad parameters are 400 at once."""
    body = _write(tmp_path / "p.tif", blob)

    def settle(key, target):
        deadline = time.time() + 120
        while time.time() < deadline:
            st = live.srv.snapshot()
            if st["prewarm_pending"] == 0 and st[key] >= target:
                return st
            time.sleep(0.05)
        return live.srv.snapshot()

    base = live.srv.snapshot()
    st, res = live.json("POST", "/slides?prewarm=1&model=blobDemo&roi=64,96"
                        "&range=0,65535", body)
    assert st == 200 and res["prewarm"] == "scheduled"
    st = settle("prewarmed", base["prewarmed"] + 4)
    assert st["prewarmed"] == base["prewarmed"] + 4
    st = live.json("POST", "/slides?prewarm=1&model=blobDemo&roi=260",
                   body)[1]
    st = settle("prewarmed", base["prewarmed"] + 6)
    assert st["prewarmed"] == base["prewarmed"] + 6
    live.json("POST", "/slides?prewarm=1&model=blobDemo&roi=1000,1000", body)
    st = settle("prewarm_errors", base["prewarm_errors"] + 1)
    assert st["prewarm_errors"] == base["prewarm_errors"] + 1
    assert "exceeds" in st["last_prewarm_error"]
    for bad in ("prewarm=1", "prewarm=1&roi=0,64",
                "prewarm=1&roi=64&model=../../etc", "prewarm=maybe&roi=64"):
        assert live.call("POST", "/slides?" + bad, body)[0] == 400, bad


def test_prewarm_queue_is_bounded(monkeypatch):
    """One worker and a queue of 4: a burst sheds the excess as dropped;
    the worker restarts after an idle exit."""
    srv = serve.ModelServer(model_root="/nonexistent", device="cpu")
    started, release = threading.Event(), threading.Event()
    calls = []

    def fake(slide_id, **kw):
        calls.append(slide_id)
        started.set()
        release.wait(30)

    monkeypatch.setattr(srv, "prewarm_slide", fake)
    assert srv.schedule_prewarm("s0") == "scheduled"
    assert started.wait(10)
    for i in range(1, 5):
        assert srv.schedule_prewarm(f"s{i}") == "scheduled"
    assert srv.schedule_prewarm("s5") == "dropped"
    st = srv.snapshot()
    assert st["prewarm_dropped"] == 1 and st["prewarm_pending"] == 5
    release.set()
    deadline = time.time() + 30
    while time.time() < deadline and srv.snapshot()["prewarm_pending"]:
        time.sleep(0.02)
    assert calls == [f"s{i}" for i in range(5)]
    assert srv.schedule_prewarm("s6") == "scheduled"
    deadline = time.time() + 30
    while time.time() < deadline and "s6" not in calls:
        time.sleep(0.02)
    assert "s6" in calls


# -- entry points ---------------------------------------------------------------


def test_preload_builds_before_the_port_opens(monkeypatch):
    """serve(preload=[...]) builds the engines before the socket binds; a
    bad name fails the deploy."""
    old = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    captured = {}
    real_make = serve.make_handler

    def capturing(server):
        captured["engines"] = dict(server._engines)
        return real_make(server)

    class StubHTTPD:
        daemon_threads = False

        def __init__(self, addr, handler):
            self.server_address = (addr[0], 1)

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    monkeypatch.setattr(serve, "make_handler", capturing)
    monkeypatch.setattr(serve, "ThreadingHTTPServer", StubHTTPD)
    try:
        assert serve.main(["--host", "127.0.0.1", "--port", "0",
                           "--modelRoot", MODELS, "--preload", "blobDemo"],
                          device="cpu") == 0
        ent = captured["engines"][("blobDemo", "float32", "whole")]
        assert ent["value"] is not None and ent["error"] is None
        with pytest.raises(FileNotFoundError, match="doesNotExist"):
            serve.serve("127.0.0.1", 0, model_root=MODELS,
                        preload=["doesNotExist"], device="cpu")
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def test_the_server_needs_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.ModelServer(model_root=MODELS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--port", "0", "--modelRoot", MODELS])
    assert serve.ModelServer(model_root=MODELS, device="cpu").device.type \
        == "cpu"


def _start(argv_py):
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", argv_py], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, line = [], ""
    deadline = time.time() + 120
    while time.time() < deadline:
        line = proc.stdout.readline()
        lines.append(line)
        if "serving on" in line or (line == "" and proc.poll() is not None):
            break
    assert "serving on" in line, "".join(lines)
    return proc, int(line.split("serving on ")[1].split()[0].rsplit(":")[1])


def test_sigterm_drains_an_inflight_request(tmp_path):
    """python -m unmicst_tpu_torch.serve's main on the CPU: SIGTERM while a
    request runs lets it finish (200, full body), then the process exits
    0 saying it drained."""
    img = _blob_slide(np.random.RandomState(1), 1500, 1500, n=200)
    body = _write(tmp_path / "d.tif", img)
    proc, port = _start(
        "from unmicst_tpu_torch import serve; raise SystemExit(serve.main("
        f"['--host', '127.0.0.1', '--port', '0', '--modelRoot', '{MODELS}',"
        " '--preload', 'blobDemo'], device='cpu'))")
    try:
        result = {}
        started = threading.Event()

        def post():
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/infer?model=blobDemo", data=body,
                method="POST")
            started.set()
            with urllib.request.urlopen(req, timeout=300) as r:
                result["code"], result["pages"] = r.status, _pages(r.read())

        t = threading.Thread(target=post)
        t.start()
        started.wait(10)
        time.sleep(1.0)  # the request is in flight (seconds on the CPU)
        proc.send_signal(signal.SIGTERM)
        t.join(300)
        out, _ = proc.communicate(timeout=120)
        assert result.get("code") == 200, (result, out[-2000:])
        assert result["pages"].shape == (3, 1500, 1500)
        assert proc.returncode == 0 and "drain" in out, out[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()


def test_module_entry_point_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry point would run on it")
    r = subprocess.run([sys.executable, "-m", "unmicst_tpu_torch.serve",
                        "--port", "0", "--modelRoot", MODELS], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


# -- the conv flags under threads -----------------------------------------------


def test_conv_flags_hold_across_overlapping_threads():
    """Two overlapping engine calls with different TF32 settings: each
    runs with its own flags throughout (the second waits for the first to
    leave; cuDNN autotunes among its deterministic algorithms), calls with
    the same setting overlap, and the process's flags come back as they
    were.  A thread nesting the other setting inside
    its own raises."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark,
              cudnn.deterministic, cudnn.enabled)
    inside, seen, errors = threading.Event(), [], []
    release = threading.Event()

    def hold(tf32, hold_s, tag):
        try:
            with port_infer._conv_precision(tf32):
                inside.set()
                seen.append((tag, "in", matmul.allow_tf32, cudnn.allow_tf32,
                             cudnn.benchmark and cudnn.deterministic))
                release.wait(hold_s)
                seen.append((tag, "out", matmul.allow_tf32, cudnn.allow_tf32,
                             cudnn.benchmark and cudnn.deterministic))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    a = threading.Thread(target=hold, args=(True, 10, "a"))
    a.start()
    assert inside.wait(10)
    b = threading.Thread(target=hold, args=(False, 0, "b"))
    c = threading.Thread(target=hold, args=(True, 0, "c"))
    b.start()
    c.start()
    c.join(10)  # the same setting joins while "a" holds
    time.sleep(0.2)
    assert [s[0] for s in seen].count("b") == 0  # "b" waits for "a"
    release.set()
    for t in (a, b):
        t.join(10)
    assert not errors
    for tag, _, m, cd, bench in seen:
        assert (m, cd, bench) == ((tag != "b"), (tag != "b"), True), seen
    assert seen[-2:] == [("b", "in", False, False, True),
                         ("b", "out", False, False, True)]
    assert (matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark,
            cudnn.deterministic, cudnn.enabled) == before
    with port_infer._conv_precision(False):
        with port_infer._conv_precision(False):
            pass
        with pytest.raises(RuntimeError, match="another TF32"):
            with port_infer._conv_precision(True):
                pass
    assert (matmul.allow_tf32, cudnn.allow_tf32) == before[:2]


def test_int8_work_takes_cudnn_heuristics():
    """The int8 mode's convolutions and its calibration's float32 forward
    run without autotuning (deterministic algorithms, TF32 as the mode
    sets it); nesting the autotuned setting inside one on a thread raises.
    The flags come back as they were."""
    from unmicst_tpu_torch.core import quant as port_quant

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark,
              cudnn.deterministic, cudnn.enabled)
    with port_quant._precision(torch.device("cuda")):
        assert (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
                matmul.allow_tf32) == (False, True, False, False)
        with pytest.raises(RuntimeError, match="autotuning"):
            with port_infer._conv_precision(False):
                pass
    with port_infer._conv_precision(True, autotune=False):
        assert (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
                matmul.allow_tf32) == (False, True, True, True)
    assert (matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark,
            cudnn.deterministic, cudnn.enabled) == before
