"""The mesh across processes on the card: K3/K4a/K4b between two processes
sharing the card (shared slots over CUDA IPC, credit words), the halo
across them, and tensor parallelism on the card.

These tests need an NVIDIA GPU and nvcc and skip elsewhere; they import
no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_ipc.py -q

Two gloo processes (this file run as a script) each hold one rank of a
mesh spanning them and print one ``RESULT`` JSON line."""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), str(r), port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    found = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        (line,) = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        found.append(json.loads(line[len("RESULT "):]))
    return found


@pytest.mark.cuda
def test_ipc_ring_bit_equal_across_processes(results):
    for r in results:
        assert r["ring"]["mismatches"] == [], r["ring"]


@pytest.mark.cuda
def test_ipc_ring_launches_per_hop(results):
    """Each process, one rank on the card: a K3 hop is its store (behind
    the credit), its wait and its copy-out; K4a the store; K4b the wait and
    the copy-out."""
    for r in results:
        hops = r["ring"]["hops"]
        assert r["ring"]["launches"] == {"ring_shift": 3 * hops,
                                         "ring_shift_start": hops,
                                         "ring_shift_wait": 2 * hops}


@pytest.mark.cuda
def test_halo_across_processes_on_card(results):
    for r in results:
        for impl in ("ring", "ring_overlap"):
            assert r["halo"][impl] <= 2e-5, r["halo"]
        assert "halo_impl='ring'" in r["halo"]["ppermute"]


@pytest.mark.cuda
def test_tp_step_on_card_matches_one_device():
    """``make_mesh(data=1, model=2)`` with both ranks on the card: loss and
    first moment at the card bar of the training phase (1e-4 relative,
    5e-2 of each tensor's norm)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    from unmicst_tpu_torch import train as tr
    from unmicst_tpu_torch.core.hp import HParams
    from unmicst_tpu_torch.core.unet import init_params
    from unmicst_tpu_torch.runtime.mesh import make_mesh

    dev = torch.device("cuda", 0)
    hp = HParams(im_size=32, n_channels=1, n_classes=3, n_out0=64, ks=3,
                 n_layers=2, batch_size=8)
    cfg = tr.TrainConfig.for_variant("v2", export_tf1=False)
    state = init_params(hp, "v2", torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"image": torch.rand((8, 1, 32, 32), generator=g),
             "labels": torch.nn.functional.one_hot(
                 torch.randint(0, 3, (8, 32, 32), generator=g), 3)
             .permute(0, 3, 1, 2).float(),
             "weights": torch.ones((8, 3, 32, 32))}
    batch = {k: v.to(dev) for k, v in batch.items()}
    one = tr.Trainer(hp, cfg, "unused", params=state, device=dev)
    m1 = one.train_step(one.model, one.opt_state, batch,
                        torch.Generator().manual_seed(2))
    tp = tr.Trainer(hp, cfg, "unused", params=state,
                    mesh=make_mesh(data=1, model=2, devices=[dev, dev]))
    m2 = tp.train_step(tp.rank_models, tp.opt_state, batch,
                       torch.Generator().manual_seed(2))
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-4 * float(
        m1["loss"])
    want, got = one.opt_state.slots["mu"], tp._full_opt_state().slots["mu"]
    for k, v in want.items():
        norm = float(v.norm())
        if norm == 0:
            assert torch.equal(got[k], v), k
        else:
            assert float((got[k] - v).norm()) <= 5e-2 * norm, k


# -- the worker ------------------------------------------------------------------


def _ring(rank, span, dev):
    from unmicst_tpu_torch import kernels

    def buf(r, shape, dtype, key):
        g = torch.Generator(device=dev).manual_seed(1000 * key + r)
        if dtype.is_floating_point:
            return torch.randn(shape, generator=g, device=dev, dtype=dtype)
        return torch.randint(-30000, 30000, shape, generator=g, device=dev,
                             dtype=dtype)

    cases = [((32, 70, 3), torch.float32), ((7, 13), torch.int16),
             ((1 + 32 * 70 * 3,), torch.float32)]
    kernels.reset_launch_counts()
    mismatches, hops = [], 0
    for k, (shape, dtype) in enumerate(cases):
        for shift in (1, -1):
            for rep in range(3):
                key = 10 * k + rep + (5 if shift < 0 else 0)
                x = buf(rank, shape, dtype, key)
                want = buf(1 - rank, shape, dtype, key)
                if len(shape) == 1:  # a view 4 bytes off 16-byte alignment
                    x, want = x[1:], want[1:]
                xs = [None, None]
                xs[rank] = x
                got = kernels.ring_shift(xs, shift, kind="input",
                                         span=span)[rank]
                pair = kernels.ring_shift_wait(kernels.ring_shift_start(
                    xs, shift, span=span))[rank]
                if not (torch.equal(got, want) and torch.equal(pair, want)):
                    mismatches.append([list(shape), shift, rep])
                hops += 1
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    return {"mismatches": mismatches, "hops": hops,
            "launches": {k: counts[k] for k in (
                "ring_shift", "ring_shift_start", "ring_shift_wait")}}


def _halo(mesh, dev):
    import numpy as np

    from unmicst_tpu_torch.core.hp import HParams
    from unmicst_tpu_torch.core.unet import init_params
    from unmicst_tpu_torch.infer import InferenceEngine
    from unmicst_tpu_torch.runtime import halo

    hp = HParams(im_size=64, n_channels=1, n_classes=3, n_out0=8, ks=3,
                 n_layers=2, std_dev0=0.25)
    state = init_params(hp, "legacy", torch.Generator().manual_seed(3))
    image = np.random.RandomState(0).rand(400, 300).astype(np.float32)
    ref = InferenceEngine(hp, state, "legacy", 0.3, 0.2,
                          device=dev).infer(image)
    canvas = halo.build_canvas(image, hp, 2)
    out = {}
    for impl in ("ring", "ring_overlap"):
        got = halo.spatial_infer(state, canvas, 400, 300, hp, "legacy", mesh,
                                 mean=0.3, std=0.2, halo_impl=impl)
        out[impl] = float(np.abs(np.moveaxis(got.cpu().numpy(), -1, 0)
                                 - ref).max())
    try:
        halo.spatial_infer(state, canvas, 400, 300, hp, "legacy", mesh,
                           mean=0.3, std=0.2, halo_impl="ppermute")
        out["ppermute"] = "ran"
    except RuntimeError as e:
        out["ppermute"] = str(e)
    return out


def main(rank: int, port: str) -> int:
    from unmicst_tpu_torch.runtime.mesh import (initialize_distributed,
                                                make_mesh,
                                                shutdown_distributed)

    dev = torch.device("cuda", 0)
    initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo",
                           device=dev, timeout_s=120)
    try:
        mesh = make_mesh(devices=[dev])
        out = {"ring": _ring(rank, mesh.span(), dev),
               "halo": _halo(mesh, dev)}
    finally:
        shutdown_distributed()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), sys.argv[2]))
