"""The port's mesh across two processes (``tests/test_multiprocess.py``'s
counterpart): two gloo processes on the CPU, each this file run as a
script, join one job through ``initialize_distributed`` and run

* a data-parallel training step over ``make_mesh(data=2)`` (one rank per
  process): both see one loss, equal to the one-process step's;
* ``runtime.halo.spatial_infer`` with every seam implementation (the ring
  implementations take ``ppermute`` over gloo on the CPU), within 2e-5 of
  ``InferenceEngine.infer``;
* ``StreamingEngine.infer_sharded`` and ``infer_sharded_stack`` within 1
  uint8 level of ``infer`` / ``infer_stack``;
* one tensor-parallel step over ``make_mesh(data=1, model=2)``, the split
  layers' halves in the two processes, against the one-process step.

Each worker prints one ``RESULT`` JSON line; the module fixture starts
both once and the tests read the lines."""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240  # each worker; the process group's own is 60 s


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results():
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), str(rank), port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    found = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert len(lines) == 1, out[-3000:]
        found.append(json.loads(lines[0][len("RESULT "):]))
    return found


def test_two_process_dp_train_step(results):
    a, b = (r["dp"] for r in results)
    assert a["loss"] == b["loss"]  # both see the one all-reduced loss
    assert abs(a["loss"] - a["single_loss"]) <= 1e-5 * abs(a["single_loss"])
    assert a["param_err"] <= 1e-5 and b["param_err"] <= 1e-5
    assert a["local_sum"] == b["local_sum"]  # each process's rank


@pytest.mark.parametrize("impl", ["ppermute", "ring", "ring_overlap"])
def test_two_process_spatial_halo(results, impl):
    for r in results:
        assert r["halo"][impl] < 2e-5, r["halo"]


def test_two_process_sharded_streaming(results):
    for r in results:
        assert r["stream"]["solo"] <= 1 and r["stream"]["duo"] <= 1, r


def test_two_process_tp_train_step(results):
    a, b = (r["tp"] for r in results)
    assert a["split"] > 0  # the step split some layers over the processes
    assert a["loss"] == b["loss"]
    assert abs(a["loss"] - a["single_loss"]) <= 1e-5 * abs(a["single_loss"])
    assert a["param_err"] <= 1e-5 and b["param_err"] <= 1e-5


def test_initialize_distributed_arguments(monkeypatch):
    import torch.distributed as dist

    from unmicst_tpu_torch.runtime import mesh

    mesh.initialize_distributed(num_processes=1)  # the only no-op
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="together"):
        mesh.initialize_distributed("localhost:1", 2)
    with pytest.raises(ValueError, match="backend"):
        mesh.initialize_distributed("localhost:1", 2, 0, backend="mpi")
    with pytest.raises(ValueError, match="gloo"):
        mesh.initialize_distributed("localhost:1", 2, 0, backend="nccl",
                                    device="cpu")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        mesh.initialize_distributed()
    monkeypatch.setattr(mesh.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.initialize_distributed("localhost:1", 2, 0)  # cuda by default
    assert not dist.is_initialized()


# -- the worker ------------------------------------------------------------------


def _max_err(a, b) -> float:
    return float((a - b).abs().max())


def _dp(rank):
    import numpy as np
    import torch

    from unmicst_tpu_torch import train as ttr
    from unmicst_tpu_torch.core.hp import HParams
    from unmicst_tpu_torch.runtime.mesh import make_mesh

    hp = HParams(im_size=16, n_channels=1, n_classes=3, n_out0=4, ks=3,
                 n_layers=1, batch_size=4)
    cfg = ttr.TrainConfig.for_variant("v2", n_aug=1, lr0=1e-3, seed=0)
    rng = np.random.RandomState(0)  # the same batch in both processes
    batch = {
        "image": rng.rand(4, 1, 16, 16).astype(np.float32),
        "labels": np.eye(3, dtype=np.float32)[rng.randint(0, 3, (4, 16, 16))]
        .transpose(0, 3, 1, 2).copy(),
        "weights": np.ones((4, 3, 16, 16), np.float32),
    }
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    one = ttr.Trainer(hp, cfg, "/nonexistent", device="cpu")
    m1 = one.train_step(one.model, one.opt_state, batch,
                        torch.Generator().manual_seed(7))
    mesh = make_mesh(data=2, devices=["cpu"])
    t = ttr.Trainer(hp, cfg, "/nonexistent", mesh=mesh)
    m2 = t.train_step(t.rank_models, t.opt_state, batch,
                      torch.Generator().manual_seed(7))
    got, want = t.params, one.params
    return {"loss": float(m2["loss"]), "single_loss": float(m1["loss"]),
            "param_err": max(_max_err(got[k], want[k]) for k in want),
            "local_sum": sum(float(v.double().sum()) for v in
                             t.rank_models[0].state_dict().values())}


def _halo(rank):
    import numpy as np

    from unmicst_tpu_torch.core.hp import HParams
    from unmicst_tpu_torch.core.unet import init_params
    from unmicst_tpu_torch.infer import InferenceEngine
    from unmicst_tpu_torch.runtime import halo
    from unmicst_tpu_torch.runtime.mesh import make_mesh

    import torch

    hp = HParams(im_size=32, n_channels=1, n_classes=3, n_out0=4, ks=3,
                 n_layers=1, std_dev0=0.5)
    state = init_params(hp, "legacy", torch.Generator().manual_seed(3))
    image = np.random.RandomState(0).rand(100, 60).astype(np.float32)
    ref = torch.from_numpy(InferenceEngine(hp, state, "legacy", 0.3, 0.2,
                                           device="cpu").infer(image))
    mesh = make_mesh(data=2, devices=["cpu"])
    canvas = halo.build_canvas(image, hp, 2)
    out = {}
    for impl in halo.HALO_IMPLS:
        got = halo.spatial_infer(state, canvas, 100, 60, hp, "legacy", mesh,
                                 mean=0.3, std=0.2, halo_impl=impl)
        out[impl] = _max_err(got.permute(2, 0, 1), ref)
    return out


def _stream(rank):
    import numpy as np
    import torch

    from unmicst_tpu_torch.core.hp import HParams
    from unmicst_tpu_torch.core.unet import init_params
    from unmicst_tpu_torch.runtime.mesh import make_mesh
    from unmicst_tpu_torch.runtime.pipeline import StreamingEngine

    rng = np.random.RandomState(0)
    mesh = make_mesh(data=2, devices=["cpu"])
    hp = HParams(im_size=32, n_channels=1, n_classes=3, n_out0=4, ks=3,
                 n_layers=1, std_dev0=0.5)
    state = init_params(hp, "legacy", torch.Generator().manual_seed(3))
    raw = (rng.rand(100, 200) * 60000).astype(np.uint16)
    eng = StreamingEngine(hp, state, "legacy", 0.3, 0.2, compute_dtype=None,
                          stripe_tile_rows=2, device="cpu")
    solo = np.abs(eng.infer(raw).astype(int)
                  - eng.infer_sharded(raw, mesh).astype(int)).max()
    duo_hp = HParams(im_size=32, n_channels=2, n_classes=3, n_out0=4, ks=3,
                     n_layers=1, std_dev0=0.5)
    duo_state = init_params(duo_hp, "v2", torch.Generator().manual_seed(4))
    planes = [(rng.rand(90, 170) * 60000).astype(np.uint16) for _ in range(2)]
    duo = StreamingEngine(duo_hp, duo_state, "v2", 0.1, 0.9,
                          compute_dtype=None, stripe_tile_rows=2,
                          device="cpu")
    duo_err = np.abs(duo.infer_stack(planes).astype(int)
                     - duo.infer_sharded_stack(planes, mesh).astype(int)).max()
    return {"solo": int(solo), "duo": int(duo_err)}


def _tp(rank):
    import numpy as np
    import torch

    from unmicst_tpu_torch import train as ttr
    from unmicst_tpu_torch.core.hp import HParams
    from unmicst_tpu_torch.runtime.mesh import make_mesh

    hp = HParams(im_size=16, n_channels=1, n_classes=3, n_out0=64, ks=3,
                 n_layers=1, batch_size=2)
    cfg = ttr.TrainConfig.for_variant("v2", n_aug=1, lr0=1e-2, seed=0,
                                      optimizer="momentum")
    rng = np.random.RandomState(1)
    batch = {
        "image": rng.rand(2, 1, 16, 16).astype(np.float32),
        "labels": np.eye(3, dtype=np.float32)[rng.randint(0, 3, (2, 16, 16))]
        .transpose(0, 3, 1, 2).copy(),
        "weights": np.ones((2, 3, 16, 16), np.float32),
    }
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    one = ttr.Trainer(hp, cfg, "/nonexistent", device="cpu")
    m1 = one.train_step(one.model, one.opt_state, batch,
                        torch.Generator().manual_seed(2))
    mesh = make_mesh(data=1, model=2, devices=["cpu"])
    t = ttr.Trainer(hp, cfg, "/nonexistent", mesh=mesh, tp_threshold=64)
    m2 = t.train_step(t.rank_models, t.opt_state, batch,
                      torch.Generator().manual_seed(2))
    got, want = t.params, one.params
    return {"loss": float(m2["loss"]), "single_loss": float(m1["loss"]),
            "param_err": max(_max_err(got[k], want[k]) for k in want),
            "split": sum(d is not None for d in t.spec.values())}


def main(rank: int, port: str) -> int:
    import torch

    torch.set_num_threads(1)
    from unmicst_tpu_torch.runtime.mesh import (initialize_distributed,
                                                shutdown_distributed)

    initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo",
                           timeout_s=60)
    try:
        out = {"dp": _dp(rank), "halo": _halo(rank),
               "stream": _stream(rank), "tp": _tp(rank)}
    finally:
        shutdown_distributed()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), sys.argv[2]))
