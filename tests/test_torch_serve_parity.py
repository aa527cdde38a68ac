"""The port's server (unmicst_tpu_torch.serve, on the CPU) against the JAX
server (unmicst_tpu.serve), both live on random ports and loading
models/blobDemo: every request form answers pages within 1 uint8 level of
the JAX server's, with the same page count and order, the same
X-UnMicst-Meta keys and the same probe=range JSON."""

import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from unmicst_tpu import serve as jax_serve
from unmicst_tpu.io.tiff import TiffFile as JaxTiffFile
from unmicst_tpu_torch import serve
from unmicst_tpu_torch.io.tiff import TiffFile, TiffWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
H, W = 300, 260


def _blob_slide(rng, h, w, n=20):
    """The tests/test_demo_model.py recipe as uint16."""
    img = rng.rand(h, w).astype(np.float32) * 0.15
    rr, cc = np.ogrid[:h, :w]
    for _ in range(n):
        r, c = rng.randint(20, h - 20), rng.randint(20, w - 20)
        rad = rng.randint(5, 9)
        d2 = (rr - r) ** 2 + (cc - c) ** 2
        img[d2 < rad**2] = 0.7
        img[(d2 < (rad + 2) ** 2) & (d2 >= rad**2)] = 0.4
    return (np.clip(img, 0, 1) * 65535).astype(np.uint16)


def _live(srv):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def servers():
    """(jax server, port server, jax url, port url) for whole-slide
    requests, and the same pair streaming every post (small
    stream_above_px)."""
    made = {}
    for kind, kw in (("whole", {}), ("stream", {"stream_above_px": 20_000})):
        j = jax_serve.ModelServer(model_root=MODELS, precision="float32",
                                  **kw)
        t = serve.ModelServer(model_root=MODELS, precision="float32",
                              device="cpu", **kw)
        hj, uj = _live(jax_serve.make_handler(j))
        ht, ut = _live(serve.make_handler(t))
        made[kind] = (j, t, uj, ut, hj, ht)
    yield made
    for *_, hj, ht in made.values():
        for h in (hj, ht):
            h.shutdown()
            h.server_close()


@pytest.fixture(scope="module")
def slide(tmp_path_factory):
    img = _blob_slide(np.random.RandomState(3), H, W)
    path = str(tmp_path_factory.mktemp("slide") / "s.tif")
    with TiffWriter(path, bigtiff=False) as tw:
        tw.write(img)
    with open(path, "rb") as f:
        return img, f.read()


def _post(url, query, body):
    req = urllib.request.Request(
        url + query, data=body, method="POST",
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read(), r.headers.get("X-UnMicst-Meta")


def _pages(blob, tmp_path, name, reader=TiffFile):
    path = tmp_path / name
    path.write_bytes(blob)
    with reader(str(path)) as tf:
        return np.stack([tf.read_page(k) for k in range(len(tf.pages))])


def _same_pages(servers_pair, query, body, tmp_path):
    """Both servers answer ``query``: pages within 1 level, the same page
    count and meta keys; returns the port's pages and meta."""
    _, _, uj, ut, _, _ = servers_pair
    bj, mj = _post(uj, query, body)
    bt, mt = _post(ut, query, body)
    pj = _pages(bj, tmp_path, "j.tif")
    pt = _pages(bt, tmp_path, "t.tif")
    assert pj.shape == pt.shape and pt.dtype == np.uint8, (pj.shape,
                                                           pt.shape)
    d = np.abs(pj.astype(int) - pt.astype(int))
    assert d.max() <= 1, (query, d.max(), (d > 0).mean())
    mj, mt = json.loads(mj), json.loads(mt)
    assert sorted(mj) == sorted(mt)
    for key in ("model", "shape", "classes", "class_indices", "in_range"):
        assert mj.get(key) == mt.get(key), key
    return pt, mt, bt


RANGE = "range=0,65535"
ROI = "roi=37,41,90,70"


@pytest.mark.parametrize("kind,query", [
    ("whole", ""),
    ("whole", "&classes=1"),
    ("whole", "&classes=2,0&outlier=99.5"),
    ("whole", "&scale=0.5"),
    ("whole", "&rescale=0"),
    ("whole", "&compress=deflate"),
    ("whole", "&compress=1&" + RANGE),
    ("whole", "&" + ROI),
    ("whole", "&" + ROI + "&" + RANGE),
    ("whole", "&roi=250,200,50,60&classes=1"),
    ("stream", ""),
    ("stream", "&classes=1&" + RANGE),
    ("stream", "&scale=0.5"),
])
def test_body_requests_match_jax_server(servers, slide, tmp_path, kind,
                                        query):
    """POST /infer with a body: whole engine (classes, outlier, scale,
    rescale=0, deflate pages, roi with and without a pinned range) and a
    streamed post, the port's pages within 1 level of JAX's."""
    _, body = slide
    pages, meta, _ = _same_pages(servers[kind], "/infer?model=blobDemo"
                                 "&channel=0" + query, body, tmp_path)
    n = 1 if "classes=1" in query else 2 if "classes=2,0" in query else 3
    assert pages.shape[0] == meta["classes"] == n
    if "roi=" not in query:
        assert pages.shape[1:] == (H, W)


@pytest.mark.parametrize("device_path", [True, False])
@pytest.mark.parametrize("query", [ROI, ROI + "&" + RANGE,
                                   "roi=200,3,64,250&classes=1&" + RANGE,
                                   ROI + "&scale=0.5"])
def test_cached_slide_pans_match_jax_server(servers, slide, tmp_path,
                                            device_path, query):
    """POST /slides then body-less slide=ID pans, on the device-plane path
    and on the host path (device cache off on both servers): the same
    slide id from both, pages within 1 level, device pans counted."""
    _, body = slide
    j, t, uj, ut = servers["whole"][:4]
    sid = json.loads(_post(uj, "/slides", body)[0])["slide_id"]
    assert json.loads(_post(ut, "/slides", body)[0])["slide_id"] == sid
    saved = j.device_slide_bytes, t.device_slide_bytes
    if not device_path:
        j.device_slide_bytes = t.device_slide_bytes = 0
    try:
        before = t.snapshot()["device_pans"]
        _same_pages(servers["whole"], f"/infer?model=blobDemo&channel=0"
                    f"&slide={sid}&{query}", None, tmp_path)
        assert t.snapshot()["device_pans"] == before + device_path
    finally:
        j.device_slide_bytes, t.device_slide_bytes = saved


def test_probe_range_json_matches_jax_server(servers, slide):
    img, body = slide
    _, _, uj, ut = servers["whole"][:4]
    for q in ("/infer?probe=range&channel=0",
              "/infer?probe=range&channel=0&outlier=99.5"):
        rj = json.loads(_post(uj, q, body)[0])
        rt = json.loads(_post(ut, q, body)[0])
        assert rj == rt
    assert rt["range"][0][0] == float(img.min())


def test_page_order_and_readers(servers, slide, tmp_path):
    """The port's response reads in the JAX package's TIFF reader, page by
    page in reversed class order: page k is class K - 1 - k, and with
    classes=2,0 the pages are classes 0 then 2."""
    _, body = slide
    _, _, _, ut = servers["whole"][:4]
    full, _ = _post(ut, "/infer?model=blobDemo", body)
    sub, meta = _post(ut, "/infer?model=blobDemo&classes=2,0", body)
    pf = _pages(full, tmp_path, "f.tif", JaxTiffFile)
    ps = _pages(sub, tmp_path, "s.tif", JaxTiffFile)
    assert json.loads(meta)["class_indices"] == [2, 0]
    np.testing.assert_array_equal(ps[0], pf[2])  # class 0
    np.testing.assert_array_equal(ps[1], pf[0])  # class 2
    assert np.abs(pf.astype(int).sum(0) - 255).max() <= 3


def test_error_statuses_match_jax_server(servers, slide):
    """The status codes of bad requests are JAX's."""
    _, body = slide
    _, _, uj, ut = servers["whole"][:4]
    for query, data in [
        ("/infer?model=blobDemo&channel=x", body),
        ("/infer?model=blobDemo&roi=1,2,3", body),
        ("/infer?model=blobDemo&roi=290,0,64,64", body),
        ("/infer?model=blobDemo&range=5,1", body),
        ("/infer?model=blobDemo&classes=7", body),
        ("/infer?model=blobDemo&channel=3", body),
        ("/infer?model=nope", body),
        ("/infer?model=../x", body),
        ("/infer?model=blobDemo", b"garbage!"),
        ("/infer?model=blobDemo&slide=" + "0" * 32, None),
        ("/nothing", body),
    ]:
        codes = []
        for url in (uj, ut):
            try:
                _post(url, query, data)
                codes.append(200)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
        assert codes[0] == codes[1] and codes[0] >= 400, (query, codes)
