"""The port's mesh training (M13, ``tests/test_parallel.py``'s counterpart)
on CPU ranks that share the CPU, against the port's one-device step and
the JAX package's mesh step (its 8 virtual CPU devices).

Tolerances: loss 1e-5 relative, parameters and BN statistics 1e-5
absolute (the mesh sums the loss, the BN statistics and the gradients in
another order than one device); parameter placement exactly."""

import jax
import numpy as np
import pytest
import torch

from unmicst_tpu import train as jtr
from unmicst_tpu.core.hp import HParams as JaxHParams
from unmicst_tpu.runtime.mesh import data_sharding as jdata_sharding
from unmicst_tpu.runtime.mesh import make_mesh as jmake_mesh
from unmicst_tpu.runtime.mesh import shard_params as jshard_params
from unmicst_tpu_torch import train as ttr
from unmicst_tpu_torch.core import unet as tunet
from unmicst_tpu_torch.core.checkpoint import (param_paths, params_from_jax,
                                               params_to_jax)
from unmicst_tpu_torch.core.hp import HParams
from unmicst_tpu_torch.runtime import collectives
from unmicst_tpu_torch.runtime.mesh import (data_sharding, gather_state,
                                            make_mesh, put_params,
                                            shard_params)

DP_HP = HParams(im_size=32, n_channels=1, n_classes=3, n_out0=4, ks=3,
                n_extra_convs=0, n_layers=2, batch_size=8)


def _tp_hp(n_extra=0):
    return HParams(im_size=32, n_channels=1, n_classes=3, n_out0=64, ks=3,
                   n_extra_convs=n_extra, n_layers=2, batch_size=8)


def _state(hp, variant, seed=0):
    """Seeded weights with BN statistics away from (1, 0, 0, 1)."""
    state = tunet.init_params(hp, variant, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed + 1)
    for name, t in state.items():
        if name.endswith(("moving_variance", "gamma")):
            state[name] = torch.from_numpy(
                rng.uniform(0.5, 1.5, t.shape).astype(np.float32))
        elif name.endswith(("moving_mean", "beta")):
            state[name] = torch.from_numpy(
                rng.normal(0, 0.2, t.shape).astype(np.float32))
    return state


def _batch(hp, seed=0):
    rng = np.random.RandomState(seed)
    n, s, k = hp.batch_size, hp.im_size, hp.n_classes
    return {
        "image": rng.rand(n, s, s, hp.n_channels).astype(np.float32),
        "labels": np.eye(k, dtype=np.float32)[rng.randint(0, k, (n, s, s))],
        "weights": rng.uniform(1, 5, (n, s, s, k)).astype(np.float32),
    }


def _nchw(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
            for k, v in batch.items()}


def _cfg(variant, **kw):
    # lr 1e-3: one step moves the weights well past the tolerance
    return ttr.TrainConfig.for_variant(variant, **{"lr0": 1e-3, "seed": 0,
                                                   **kw})


# Adam's first update is lr * g / |g| elementwise: where a gradient is near
# 0 its sign is summation noise, and the update flips by 2 lr.  The TP step
# takes Momentum, whose first update is lr * g and whose trace after it is
# the gradient itself.  At n_out0 64 the step is ill-conditioned: a 1e-7
# relative change of the input moves a kernel's gradient by up to 1.4e-2
# of its largest entry (legacy's up.1.kernel1), whatever the summation
# order.  So the traces are held to 5e-2 of each kernel's largest entry (a
# missing or doubled share of a split layer's gradient is off by 25-100%),
# and the weights, at lr 1e-2, to the 1e-5 bar.
SGD = {"optimizer": "momentum", "lr0": 1e-2}


def _single_step(hp, variant, state, batch, seed, **kw):
    t = ttr.Trainer(hp, _cfg(variant, **kw), "/nonexistent", params=state,
                    device="cpu")
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    m = t.train_step(t.model, t.opt_state, _nchw(batch), gen)
    return t, m


def _mesh_step(hp, variant, state, batch, seed, mesh, tp_threshold=256,
               **kw):
    t = ttr.Trainer(hp, _cfg(variant, **kw), "/nonexistent", params=state,
                    mesh=mesh, tp_threshold=tp_threshold)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    m = t.train_step(t.rank_models, t.opt_state, _nchw(batch), gen)
    return t, m


def _assert_state(got, want, atol=1e-5):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=atol, rtol=0, err_msg=name)


# -- placement ------------------------------------------------------------------


@pytest.mark.parametrize("variant,model,threshold", [
    ("v2", 4, 256), ("v2", 2, 64), ("legacy", 4, 64), ("duo", 8, 128)])
def test_shard_params_matches_jax(variant, model, threshold):
    """Every parameter split over ``model`` where JAX splits it, on the
    axis that holds the same output channels in the port's layout."""
    hp = _tp_hp(n_extra=1)
    if variant == "duo":
        hp = HParams(**{**hp.__dict__, "n_channels": 2})
    state = _state(hp, variant)
    mesh = make_mesh(data=8 // model, model=model, devices=["cpu"] * 8)
    spec = shard_params(state, mesh, tp_threshold=threshold)
    jmesh = jmake_mesh(data=8 // model, model=model)
    jtree = params_to_jax(state, hp, variant)
    jspec = jshard_params(jtree, jmesh, tp_threshold=threshold)
    n_split = 0
    for name, path in param_paths(hp, variant):
        leaf, arr = jspec, jtree
        for key in path:
            leaf, arr = leaf[key], arr[key]
        axes = [i for i, a in enumerate(leaf.spec) if a == "model"]
        if not axes:
            assert spec[name] is None, name
            continue
        n_split += 1
        assert spec[name] is not None, name
        assert arr.shape[axes[0]] == state[name].shape[spec[name]], name
    assert n_split > 0
    parts = put_params(state, mesh, tp_threshold=threshold)
    assert len(parts) == 8
    for name, dim in spec.items():
        if dim is None:
            assert all(torch.equal(p[name], state[name]) for p in parts)
        else:
            for r, p in enumerate(parts):
                m = mesh.coords(r)[1]
                assert torch.equal(p[name], state[name].chunk(model, dim)[m])
    _assert_state(gather_state(parts, spec, mesh), state, atol=0)


def test_data_sharding_splits_contiguously():
    mesh = make_mesh(data=4, model=2, devices=["cpu"] * 8)
    x = torch.arange(8 * 3).reshape(8, 3)
    parts = data_sharding(mesh).local(x)
    assert [p[:, 0].tolist() for p in parts] == [
        [0, 3], [0, 3], [6, 9], [6, 9], [12, 15], [12, 15], [18, 21],
        [18, 21]]
    with pytest.raises(ValueError, match="split"):
        data_sharding(mesh).local(x[:6])


def test_collectives_in_one_process():
    mesh = make_mesh(data=2, model=3, devices=["cpu"] * 6)
    xs = [torch.full((2,), float(r), requires_grad=True) for r in range(6)]
    sums = collectives.all_reduce_sum(xs, mesh, "data")
    assert [s.tolist() for s in sums] == [[3.0, 3.0], [5.0, 5.0],
                                          [7.0, 7.0]] * 2
    torch.autograd.grad(sums[0].sum() + 2 * sums[3].sum(), xs)
    gathered = collectives.all_gather(xs, mesh, "model", 0)
    assert gathered[4].tolist() == [3.0, 3.0, 4.0, 4.0, 5.0, 5.0]
    grads = torch.autograd.grad([g.sum() for g in gathered], xs)
    assert all(g.tolist() == [1.0, 1.0] for g in grads)  # the own slice
    copies = collectives.reduce_grad(xs, mesh, "model")
    grads = torch.autograd.grad([(c * (r + 1)).sum()
                                 for r, c in enumerate(copies)], xs)
    assert [g[0].item() for g in grads] == [6.0] * 3 + [15.0] * 3
    # one hop along data at model index 1: rank i gets rank i - 1's
    bufs = [xs[r].detach() for r in mesh.rank_ids("data", 1)]
    got = collectives.ppermute(bufs, 1, mesh, "data", 1)
    assert [t[0].item() for t in got] == [4.0, 1.0]


# -- data parallelism -------------------------------------------------------------


@pytest.mark.parametrize("variant", ["v2", "duo"])
def test_dp_step_matches_single_step_with_dropout(variant):
    """``Trainer(mesh=make_mesh(data=8))`` takes the one-device step with
    dropout on: the global batch's BN statistics and dropout masks."""
    hp = HParams(**{**DP_HP.__dict__,
                    "n_channels": 2 if variant == "duo" else 1})
    state, batch = _state(hp, variant), _batch(hp)
    one, m1 = _single_step(hp, variant, state, batch, seed=5)
    t, m2 = _mesh_step(hp, variant, state, batch, 5,
                       make_mesh(data=8, devices=["cpu"] * 8))
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    _assert_state(t.params, one.params)
    # every rank holds the same parameters after the step
    for m in t.rank_models[1:]:
        for name, v in m.state_dict().items():
            assert torch.equal(v, t.rank_models[0].state_dict()[name]), name


def test_dp_step_matches_jax_mesh_step():
    """The port's DP step against JAX's ``Trainer(mesh=make_mesh(data=8))``
    step, dropout off."""
    hp, variant = DP_HP, "v2"
    state, batch = _state(hp, variant), _batch(hp, seed=3)
    t, m = _mesh_step(hp, variant, state, batch, None,
                      make_mesh(data=8, devices=["cpu"] * 8))
    jhp = JaxHParams.from_ref_dict(hp.to_ref_dict())
    jmesh = jmake_mesh(data=8, model=1)
    jt = jtr.Trainer(jhp, jtr.TrainConfig.for_variant(variant, lr0=1e-3,
                                                       seed=0),
                     model_path="/nonexistent",
                     params=params_to_jax(state, hp, variant), mesh=jmesh)
    sharded = {k: jax.device_put(v, jdata_sharding(jmesh))
               for k, v in batch.items()}
    p, _, jm = jt.train_step(jt.params, jt.opt_state, sharded, None)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, p), hp,
                           variant)
    _assert_state(t.params, want)


# -- tensor parallelism -----------------------------------------------------------


TP_CASES = [("v2", 256, 0), ("v2", 64, 1), ("legacy", 64, 0), ("duo", 64, 0)]


@pytest.mark.parametrize("variant,threshold,n_extra", TP_CASES)
def test_tp_forward_matches_unsharded(variant, threshold, n_extra):
    """The forward over a ``data=2, model=4`` mesh: the split layers'
    slices gathered, the BN statistics the global batch's."""
    hp = _tp_hp(n_extra)
    if variant == "duo":
        hp = HParams(**{**hp.__dict__, "n_channels": 2})
    state, batch = _state(hp, variant), _nchw(_batch(hp))
    model = tunet.UNet(hp, variant)
    model.load_state_dict(state)
    g = torch.Generator().manual_seed(9)
    want, want_stats = model.forward_nchw(batch["image"], train=True,
                                          generator=g)
    mesh = make_mesh(data=2, model=4, devices=["cpu"] * 8)
    spec = shard_params(state, mesh, threshold)
    assert any(d is not None for d in spec.values())
    models = [tunet.module_from_state(hp, variant, part)
              for part in put_params(state, mesh, threshold)]
    ops = ttr._MeshOps(mesh, spec, hp.batch_size)
    xs = [batch["image"][slice(*ops.batch_slice(k))] for k in range(8)]
    probs, stats = tunet.train_forward_ranks(
        models, xs, ops, torch.Generator().manual_seed(9))
    for k, p in enumerate(probs):
        a, b = ops.batch_slice(k)
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[a:b].detach().numpy(), atol=1e-5)
    for name, v in want_stats.items():
        dim = spec.get(name)
        for k in range(8):
            m = mesh.coords(k)[1]
            ref = v if dim is None else v.chunk(4, dim)[m]
            np.testing.assert_allclose(stats[k][name].numpy(), ref.numpy(),
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("variant,threshold,n_extra", TP_CASES)
def test_tp_step_matches_unsharded(variant, threshold, n_extra):
    hp = _tp_hp(n_extra)
    if variant == "duo":
        hp = HParams(**{**hp.__dict__, "n_channels": 2})
    state, batch = _state(hp, variant), _batch(hp, seed=1)
    one, m1 = _single_step(hp, variant, state, batch, seed=4, **SGD)
    t, m2 = _mesh_step(hp, variant, state, batch, 4,
                       make_mesh(data=2, model=4, devices=["cpu"] * 8),
                       tp_threshold=threshold, **SGD)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["reg"]), float(m1["reg"]), rtol=1e-5)
    _assert_state(t.params, one.params)
    g_want = one.opt_state.slots["trace"]
    g_got = t._full_opt_state().slots["trace"]
    for name, v in state.items():
        if v.dim() == 4:
            scale = float(g_want[name].abs().max())
            err = float((g_got[name] - g_want[name]).abs().max())
            assert err <= 5e-2 * scale, (name, err, scale)


# -- checkpoints ------------------------------------------------------------------


def test_save_restore_round_trip_under_a_mesh(tmp_path):
    """``save`` under a mesh writes what a one-device trainer writes at the
    same parameters and optimizer state; ``restore`` re-places them."""
    hp, variant = _tp_hp(), "v2"
    state, batch = _state(hp, variant), _batch(hp, seed=2)
    cfg = ttr.TrainConfig.for_variant(variant, lr0=1e-3, seed=0,
                                      export_tf1=False)
    mesh = make_mesh(data=2, model=2, devices=["cpu"] * 4)
    t = ttr.Trainer(hp, cfg, str(tmp_path / "mesh"), params=state, mesh=mesh)
    t.train_step(t.rank_models, t.opt_state, _nchw(batch), None)
    t.save()
    one = ttr.Trainer(hp, cfg, str(tmp_path / "one"), device="cpu")
    one.restore(str(tmp_path / "mesh" / "model.unmicst-tpu.msgpack"))
    _assert_state(one.params, t.params, atol=0)
    one.step = t.step  # restore resumes at the step after the save
    one.save()
    a = (tmp_path / "mesh" / "model.unmicst-tpu.msgpack").read_bytes()
    b = (tmp_path / "one" / "model.unmicst-tpu.msgpack").read_bytes()
    assert a == b
    back = ttr.Trainer(hp, cfg, str(tmp_path / "mesh"), mesh=mesh)
    back.restore()
    assert back.step == t.step + 1
    for m0, m1 in zip(back.rank_models, t.rank_models):
        for name, v in m1.state_dict().items():
            assert torch.equal(m0.state_dict()[name], v), name
    for s0, s1 in zip(back.opt_state, t.opt_state):
        assert s0.count == s1.count == 1
        for k in s1.slots:
            for name, v in s1.slots[k].items():
                assert torch.equal(s0.slots[k][name], v), (k, name)
    # the restored mesh trainer steps on as the original does
    m0 = back.train_step(back.rank_models, back.opt_state, _nchw(batch), None)
    m1 = t.train_step(t.rank_models, t.opt_state, _nchw(batch), None)
    assert float(m0["loss"]) == float(m1["loss"])
