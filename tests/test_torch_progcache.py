"""The port's ``ProgramCache`` (``unmicst_tpu_torch/utils/progcache.py``)
against the JAX package's (``unmicst_tpu/utils/progcache.py``): the same
call sequence gives the same builds, hits, evictions and re-raised errors
in both; concurrent first requests of one key build once; a build may
nest ``get_or_build``.  The card's use of it, one CUDA graph per forward
shape, is held against eager in ``tests/test_torch_cuda.py``; here, the
policy around it: a key's first request runs eagerly and its second
captures, and ``spatial_infer`` (whose models live for one call) always
runs eagerly."""

import threading

import numpy as np
import pytest
import torch

from unmicst_tpu.utils.progcache import ProgramCache as JaxCache
from unmicst_tpu_torch.utils.progcache import ProgramCache


class Boom(RuntimeError):
    pass


def _trace(cache_cls, ops, max_entries=3):
    """Run ``ops`` (keys; a key starting with "bad" fails its build)
    through a cache; returns each call's outcome and the build log."""
    cache = cache_cls(max_entries=max_entries)
    builds = []

    def build(key):
        def fn():
            builds.append(key)
            if key.startswith("bad"):
                raise Boom(key)
            return f"program {key} #{len(builds)}"
        return fn

    out = []
    for key in ops:
        try:
            out.append(("ok", cache.get_or_build(key, build(key))))
        except Boom as exc:
            out.append(("error", str(exc)))
    return out, builds, list(cache._entries)


@pytest.mark.parametrize("ops", [
    ["a", "b", "a", "c", "d", "a", "b", "e", "c"],  # hits, FIFO evictions
    ["bad1", "a", "bad1", "bad1", "a", "b"],  # failures are not cached
    ["a"] * 5 + ["b", "c", "d", "a"],  # a hit keeps no FIFO slot fresh
])
def test_call_sequence_matches_jax(ops):
    assert _trace(ProgramCache, ops) == _trace(JaxCache, ops)


@pytest.mark.parametrize("cache_cls", [ProgramCache, JaxCache])
def test_concurrent_first_requests_build_once(cache_cls):
    """Two threads ask for one key while its build runs: one build, both
    get its value; a failing build raises its error in both."""
    for fail in (False, True):
        cache = cache_cls()
        started, release = threading.Event(), threading.Event()
        builds, results = [], []

        def build():
            builds.append(1)
            started.set()
            assert release.wait(10)
            if fail:
                raise Boom("once")
            return object()

        def ask():
            try:
                results.append(cache.get_or_build("k", build))
            except Boom as exc:
                results.append(exc)

        first = threading.Thread(target=ask)
        first.start()
        assert started.wait(10)
        second = threading.Thread(target=ask)
        second.start()
        release.set()
        for t in (first, second):
            t.join(10)
            assert not t.is_alive()
        assert len(builds) == 1 and len(results) == 2
        if fail:
            assert all(isinstance(r, Boom) for r in results)
            assert results[0] is results[1]
        else:
            assert results[0] is results[1]


def test_hit_does_not_wait_for_another_keys_build_and_builds_nest():
    """A build runs off the lock: a hit of another key returns while it
    runs, and the build itself may call ``get_or_build``."""
    cache = ProgramCache()
    cache.get_or_build("ready", lambda: "r")
    inside, release = threading.Event(), threading.Event()

    def slow():
        inside.set()
        assert release.wait(10)
        return cache.get_or_build("inner", lambda: "i") + "+outer"

    t = threading.Thread(target=cache.get_or_build, args=("slow", slow))
    t.start()
    assert inside.wait(10)
    assert cache.get_or_build("ready", lambda: "rebuilt") == "r"
    release.set()
    t.join(10)
    assert not t.is_alive()
    assert cache.get_or_build("slow", lambda: "x") == "i+outer"
    assert len(cache) == 3


def test_forward_graphs_capture_at_a_keys_second_request():
    """``ForwardGraphs.get``: None (run eagerly) at a key's first request,
    the captured graph from its second on, one capture a key; keys are
    counted apart, and a key forgotten past the bound starts over."""
    from unmicst_tpu_torch.runtime import graphs

    fg = graphs.ForwardGraphs(torch.device("cuda", 0))  # touches no card
    captured = []

    def capture(key, *args):
        captured.append(key)
        return f"graph {key}"

    fg._capture = capture
    get = lambda key: fg.get(key, None, (1,), torch.float32)  # noqa: E731
    assert [get("a"), get("b"), get("a"), get("a"), get("b")] == [
        None, None, "graph a", "graph a", "graph b"]
    assert captured == ["a", "b"]
    for k in range(4 * graphs.MAX_GRAPHS):
        get(("other", k))
    assert get("a") == "graph a"  # still cached: the cache keeps it
    assert get("c") is None and get("c") == "graph c"


def test_forward_graphs_threads_capture_once():
    """Three threads' requests of one new key: one sees its first request
    and runs eagerly, the other two share one capture."""
    from unmicst_tpu_torch.runtime import graphs

    fg = graphs.ForwardGraphs(torch.device("cuda", 0))
    release = threading.Event()
    captured, results = [], []

    def capture(key, *args):
        captured.append(key)
        assert release.wait(10)
        return "graph"

    fg._capture = capture
    threads = [threading.Thread(target=lambda: results.append(
        fg.get("k", None, (1,), torch.float32))) for _ in range(3)]
    for t in threads:
        t.start()
    release.set()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert sorted(map(str, results)) == ["None", "graph", "graph"]
    assert captured == ["k"]


def test_spatial_infer_runs_eagerly(monkeypatch):
    """``spatial_infer`` builds its models for one call, so it asks
    ``weigh_tiles`` for no graph (a capture per call would never be
    replayed in another)."""
    from unmicst_tpu_torch.core.hp import HParams
    from unmicst_tpu_torch.core.unet import init_params
    from unmicst_tpu_torch.runtime import halo
    from unmicst_tpu_torch.runtime.mesh import make_mesh

    seen = []
    real = halo.weigh_tiles

    def spy(*args, **kwargs):
        seen.append(kwargs.get("_graphs", True))
        return real(*args, **kwargs)

    monkeypatch.setattr(halo, "weigh_tiles", spy)
    hp = HParams(im_size=32, n_channels=1, n_classes=3, n_out0=4, ks=3,
                 n_extra_convs=1, n_layers=2)
    state = init_params(hp, "legacy", torch.Generator().manual_seed(0))
    image = np.random.RandomState(0).rand(70, 40).astype(np.float32)
    for impl in halo.HALO_IMPLS:
        got = halo.spatial_infer(
            state, halo.build_canvas(image, hp, 2), 70, 40, hp, "legacy",
            make_mesh(devices=["cpu"] * 2), mean=0.5, std=0.2,
            halo_impl=impl)
        assert got.shape == (70, 40, 3)
    assert seen and not any(seen)
