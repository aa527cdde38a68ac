"""The port's training pieces (``unmicst_tpu_torch.train`` and the train
mode of ``core/unet.py``) against the JAX package and the executed-TF
oracles, on the CPU, at small hyper-parameters.

Tolerances, float32 unless stated: forward and BN statistics 2e-6 abs;
loss 1e-6 rel, gradients 1e-5 abs + 1e-4 rel (summation order); optimizer
trajectories 1e-6 abs over 5 updates; the oracles at the bars of
``tests/test_oracle_parity.py``; corpora and batch streams bit for bit."""

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization as flax_ser

from unmicst_tpu import train as jtr
from unmicst_tpu.core import unet as junet
from unmicst_tpu.core.hp import HParams as JaxHParams
from unmicst_tpu.io.tiff import TiffWriter
from unmicst_tpu_torch import train as ttr
from unmicst_tpu_torch.core import unet as tunet
from unmicst_tpu_torch.core.checkpoint import (load_tf1_params,
                                               params_from_jax, params_to_jax)
from unmicst_tpu_torch.core.hp import HParams
from unmicst_tpu_torch.core.unet import UNet

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
VARIANTS = ["legacy", "v2", "duo", "cyto2"]
HP = HParams(im_size=16, n_channels=1, n_classes=3, n_out0=4, ks=3,
             n_extra_convs=1, n_layers=2, batch_size=3)


def _hp(variant):
    """Two channels for duo, two classes for cyto2."""
    return HParams(im_size=16, n_channels=2 if variant == "duo" else 1,
                   n_classes=2 if variant == "cyto2" else 3, n_out0=4, ks=3,
                   n_extra_convs=1, n_layers=2, batch_size=3)


# jitted JAX references (eager JAX compiles every op on its own)
_init = jax.jit(junet.init_params, static_argnums=(1, 2))
_apply_train = jax.jit(partial(junet.apply, train=True),
                       static_argnums=(2, 3))
_value_and_grad = jax.jit(jax.value_and_grad(jtr.loss_fn, has_aux=True),
                          static_argnums=(2, 3))


def _jhp(hp):
    return JaxHParams.from_ref_dict(hp.to_ref_dict())


def _jax_tree(hp, variant, seed):
    """A JAX params tree (numpy) drawn with numpy: He-scaled kernels, BN
    statistics away from (1, 0, 0, 1)."""
    rng = np.random.RandomState(seed)
    state = {}
    for name, t in UNet(hp, variant).state_dict().items():
        field = name.rsplit(".", 1)[-1]
        if field in ("gamma", "moving_variance"):
            v = rng.uniform(0.5, 1.5, t.shape)
        elif field in ("beta", "moving_mean"):
            v = rng.normal(0, 0.2, t.shape)
        else:
            v = rng.normal(0, (2 / (t.shape[1] * t[0, 0].numel())) ** 0.5,
                           t.shape)
        state[name] = torch.from_numpy(v.astype(np.float32))
    return params_to_jax(state, hp, variant)


def _batch(hp, seed, n=3):
    rng = np.random.RandomState(seed)
    s, c, k = hp.im_size, hp.n_channels, hp.n_classes
    return {
        "image": rng.normal(0, 1, (n, s, s, c)).astype(np.float32),
        "labels": np.eye(k, dtype=np.float32)[rng.randint(0, k, (n, s, s))],
        "weights": rng.uniform(1, 5, (n, s, s, k)).astype(np.float32),
    }


def _nchw(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
            for k, v in batch.items()}


def _model(hp, variant, tree):
    model = UNet(hp, variant)
    model.load_state_dict(params_from_jax(tree, hp, variant))
    return model


# -- the train-mode forward ---------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_forward_and_bn_statistics_match_jax(variant):
    hp = _hp(variant)
    tree = _jax_tree(hp, variant, 1)
    x = _batch(hp, 2)["image"]
    want, new = _apply_train(jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(x), _jhp(hp), variant)
    model = _model(hp, variant, tree)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        got, stats = model(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    want_state = params_from_jax(jax.tree_util.tree_map(np.asarray, new), hp,
                                 variant)
    n_bn = hp.n_layers if variant == "legacy" else 2 * hp.n_layers + 2
    assert len(stats) == 2 * n_bn
    for name, t in stats.items():
        np.testing.assert_allclose(t.numpy(), want_state[name].numpy(),
                                   atol=2e-6, err_msg=name)
    # the module itself is left as it was
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("variant", VARIANTS)
def test_regularization_loss_matches_jax(variant):
    hp = _hp(variant)
    tree = _jax_tree(hp, variant, 3)
    want = float(junet.regularization_loss(
        jax.tree_util.tree_map(jnp.asarray, tree), variant))
    got = float(tunet.regularization_loss(_model(hp, variant, tree)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
    assert (want == 0) == (variant == "legacy")


@pytest.mark.parametrize("variant,use_weights",
                         [("v2", True), ("v2", False), ("legacy", False),
                          ("cyto2", True)])
def test_loss_and_gradients_match_jax(variant, use_weights):
    hp = _hp(variant)
    tree = _jax_tree(hp, variant, 4)
    batch = _batch(hp, 5)
    jcfg = jtr.TrainConfig.for_variant(variant, use_weights=use_weights)
    (jloss, (_, jm)), jgrads = _value_and_grad(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()}, _jhp(hp), jcfg, None)
    cfg = ttr.TrainConfig.for_variant(variant, use_weights=use_weights)
    model = _model(hp, variant, tree).requires_grad_(True)
    loss, (stats, m) = ttr.loss_fn(model, _nchw(batch), hp, cfg, None)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-6)
    assert float(m["reg"]) == pytest.approx(float(jm["reg"]), rel=1e-6,
                                            abs=1e-12)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), hp,
                           variant)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    # the BN moving statistics get no gradient and no parameter slot
    assert not any("moving" in n for n in names)
    assert all(float(want[n].abs().max()) == 0 for n in want if "moving" in n)


# -- init, dropout, remat -----------------------------------------------------


@pytest.mark.parametrize("variant", ["legacy", "v2"])
def test_init_params_law(variant):
    hp = HParams(im_size=32, n_channels=1, n_classes=3, n_out0=16, ks=5,
                 n_extra_convs=1, n_layers=2, std_dev0=0.03)
    a = tunet.init_params(hp, variant, torch.Generator().manual_seed(0))
    b = tunet.init_params(hp, variant, torch.Generator().manual_seed(0))
    ref = UNet(hp, variant).state_dict()
    assert list(a) == list(ref)
    for name, t in a.items():
        assert t.shape == ref[name].shape and torch.equal(t, b[name]), name
        field = name.rsplit(".", 1)[-1]
        if field in ("gamma", "moving_variance"):
            assert torch.all(t == 1), name
        elif field in ("beta", "moving_mean"):
            assert torch.all(t == 0), name
        else:
            fan_in = t.shape[1] * t.shape[2] * t.shape[3]
            plain = variant == "legacy" or (name.startswith("down.")
                                            and name.endswith(".kernel1"))
            std = 0.03 if plain else (1 / fan_in) ** 0.5 / 0.87962566103423978
            assert float(t.abs().max()) <= 2 * std + 1e-7, name
            if t.numel() >= 2000:  # the law's moments: mean 0, and the
                # deviation of a normal cut at +-2 sigma, 0.8796 sigma
                assert abs(float(t.mean())) < 0.1 * std, name
                assert float(t.std()) == pytest.approx(0.87962566 * std,
                                                       rel=0.1), name
    if variant == "legacy":
        return
    # JAX draws from the same law: the moments agree kernel by kernel
    j = params_from_jax(jax.tree_util.tree_map(np.asarray, _init(
        jax.random.PRNGKey(0), _jhp(hp), variant)), hp, variant)
    for name in ("up.0.kernel2", "down.1.kernel1", "up.1.kernel1"):
        assert float(a[name].std()) == pytest.approx(float(j[name].std()),
                                                     rel=0.1), name


def test_dropout_rate_scaling_and_generator():
    x = torch.ones(200, 1000)
    y = tunet.dropout(x, 0.35, torch.Generator().manual_seed(3))
    kept = y != 0
    assert float(kept.float().mean()) == pytest.approx(0.65, abs=0.005)
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.65))
    again = tunet.dropout(x, 0.35, torch.Generator().manual_seed(3))
    assert torch.equal(y, again)
    assert torch.equal(tunet.dropout(x, 0.35, None), x)
    assert torch.equal(tunet.dropout(x, 0.0, torch.Generator()), x)
    # through the forward: one seed, one set of masks; no generator, none
    hp = _hp("duo")
    model = _model(hp, "duo", _jax_tree(hp, "duo", 6))
    x = torch.from_numpy(_batch(hp, 7)["image"])
    with torch.no_grad():
        p1, _ = model(x, train=True, generator=torch.Generator().manual_seed(1))
        p2, _ = model(x, train=True, generator=torch.Generator().manual_seed(1))
        p0, _ = model(x, train=True)
    assert torch.equal(p1, p2) and not torch.allclose(p1, p0)


def test_remat_equals_plain_and_updates_bn_once():
    hp = _hp("v2")
    tree = _jax_tree(hp, "v2", 8)
    batch = _nchw(_batch(hp, 9))
    out = {}
    for remat in (False, True):
        cfg = ttr.TrainConfig.for_variant("v2", remat=remat)
        model = _model(hp, "v2", tree).requires_grad_(True)
        tx = ttr.make_optimizer(cfg)
        st = tx.init(model)
        m = ttr.make_train_step(hp, cfg, tx)(
            model, st, batch, torch.Generator().manual_seed(5))
        out[remat] = (model.state_dict(), float(m["loss"]))
    assert out[True][1] == out[False][1]
    for k, v in out[False][0].items():
        assert torch.equal(v, out[True][0][k]), k
    # once: the moving mean is 0.99 * old + 0.01 * batch mean, not twice
    model = _model(hp, "v2", tree)
    with torch.no_grad():
        _, stats = model.forward_nchw(batch["image"], train=True)
    assert torch.equal(out[True][0]["down.0.bn.moving_mean"],
                       stats["down.0.bn.moving_mean"])


# -- optimizers ---------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_optimizers_match_optax_across_a_staircase(optimizer):
    hp, variant = _hp("v2"), "v2"
    tree = _jax_tree(hp, variant, 10)
    cfg = ttr.TrainConfig.for_variant(variant, optimizer=optimizer, lr0=1e-2,
                                      decay_steps=2, decay_rate=0.5)
    jcfg = jtr.TrainConfig.for_variant(variant, optimizer=optimizer, lr0=1e-2,
                                       decay_steps=2, decay_rate=0.5)
    tx = jtr.make_optimizer(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jst = tx.init(jp)
    update = jax.jit(tx.update)
    apply_updates = jax.jit(optax.apply_updates)
    model = _model(hp, variant, tree).requires_grad_(True)
    opt = ttr.make_optimizer(cfg)
    st = opt.init(model)
    names, params = zip(*model.named_parameters())
    rng = np.random.RandomState(11)
    for t in range(5):
        assert ttr.learning_rate(cfg, t) == pytest.approx(
            float(optax.exponential_decay(1e-2, 2, 0.5, staircase=True)(t)),
            rel=1e-7)
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 1, a.shape).astype(np.float32), tree)
        for node in jax.tree_util.tree_leaves_with_path(g):
            if "moving" in jax.tree_util.keystr(node[0]):
                node[1][...] = 0  # no gradient reaches the moving statistics
        up, jst = update(jax.tree_util.tree_map(jnp.asarray, g), jst, jp)
        jp = apply_updates(jp, up)
        gs = params_from_jax(g, hp, variant)
        opt.update(st, list(names), list(params), [gs[n] for n in names])
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), hp, variant)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(),
                                   atol=1e-6, err_msg=k)
    # optax's layout: the same keys, slots (zero for the moving statistics)
    # and counts, leaf for leaf
    ours = opt.state_dict(st, hp, variant)
    theirs = flax_ser.to_state_dict(jst)
    lo = jax.tree_util.tree_flatten_with_path(ours)[0]
    lt = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [p for p, _ in lo] == [p for p, _ in lt]
    for (path, a), (_, b) in zip(lo, lt):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert int(ours["1"]["count"]) == 5


# -- the executed-TF oracles --------------------------------------------------


def test_one_step_matches_the_tf_oracle():
    """``tests/test_oracle_parity.py:86-150`` on the port: every variable
    after one Momentum step, and the Momentum slot."""
    d = os.path.join(FIXDIR, "oracle_train_legacy")
    with open(os.path.join(d, "hp.json")) as f:
        meta = json.load(f)
    hp = HParams.from_ref_dict(meta["hp"])
    data = np.load(os.path.join(d, "step.npz"))
    cfg = ttr.TrainConfig.for_variant("legacy")
    t = ttr.Trainer(hp, cfg, "unused", params=load_tf1_params(
        os.path.join(d, "model.ckpt"), hp, "legacy"), device="cpu")
    m = t.train_step(t.model, t.opt_state,
                     _nchw({"image": data["x"], "labels": data["labels"]}),
                     None)
    assert abs(float(m["loss"]) - meta["loss_train_mode"]) < 1e-4
    tfv = {k[len("var::"):]: data[k] for k in data.files
           if k.startswith("var::")}
    tree = params_to_jax(t.params, hp, "legacy")
    checked = 0
    for i, layer in enumerate(tree["down"]):
        names = {"kernel1": f"downsampling/ld{i}/kernel1",
                 "shortcut": f"downsampling/ld{i}/shortcutWeights"}
        scope = "batch_normalization" + (f"_{i}" if i else "")
        pairs = [(layer[k], n) for k, n in names.items()]
        pairs += [(layer["extra"][j], f"downsampling/ld{i}/kernelExtra{j}")
                  for j in range(len(layer["extra"]))]
        pairs += [(layer["bn"][k], f"{scope}/{k}") for k in
                  ("gamma", "beta", "moving_mean", "moving_variance")]
        for ours, name in pairs:
            np.testing.assert_allclose(ours, tfv[name], atol=2e-5, rtol=2e-4,
                                       err_msg=name)
            checked += 1
    pairs = [(tree["bottom"]["kernel1"], "lb/kernel1"),
             (tree["top"]["kernel"], "lt/kernel")]
    for i, layer in enumerate(tree["up"]):
        pairs += [(layer["kernel1"], f"upsampling/lu{i}/kernel1"),
                  (layer["kernel2"], f"upsampling/lu{i}/kernel2")]
        pairs += [(layer["extra"][j], f"upsampling/lu{i}/kernel2Extra{j}")
                  for j in range(len(layer["extra"]))]
    for ours, name in pairs:
        np.testing.assert_allclose(ours, tfv[name], atol=2e-5, rtol=2e-4,
                                   err_msg=name)
        checked += 1
    assert checked == len(t.params)
    slot = t.tx.state_dict(t.opt_state, hp, "legacy")["0"]["trace"]
    np.testing.assert_allclose(slot["down"]["0"]["kernel1"],
                               tfv["downsampling/ld0/kernel1/Momentum"],
                               atol=1e-5, rtol=1e-4)


def _trajectory(variant, **overrides):
    d = os.path.join(FIXDIR, f"oracle_traj_{variant}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    hp = HParams.from_ref_dict(meta["hp"])
    data = np.load(os.path.join(d, "traj.npz"))
    kw = dict(decay_steps=meta["decay_steps"], decay_rate=meta["decay_rate"],
              lr0=meta["lr0"])
    kw.update(overrides)
    cfg = ttr.TrainConfig.for_variant(variant, **kw)
    assert cfg.optimizer == meta["optimizer"]
    assert cfg.use_weights == meta["use_weights"]
    t = ttr.Trainer(hp, cfg, "unused", params=load_tf1_params(
        os.path.join(d, "init.ckpt"), hp, variant), device="cpu")
    losses = []
    for s in range(meta["n_steps"]):
        b = {"image": data["x"][s], "labels": data["labels"][s]}
        if cfg.use_weights:
            b["weights"] = data["weights"][s]
        # no generator: dropout off, as in the fixture (BN still trains)
        losses.append(float(t.train_step(t.model, t.opt_state, _nchw(b),
                                         None)["loss"]))
    final = load_tf1_params(os.path.join(d, "final.ckpt"), hp, variant)
    return np.asarray(losses), data["losses"], t.params, final


@pytest.mark.parametrize("variant", ["legacy", "v2"])
def test_trajectory_matches_the_tf_oracle(variant):
    """``tests/test_oracle_parity.py:187-256`` on the port: the 50-step
    loss curve (staircase firing at steps 20 and 40) and every final
    variable."""
    losses, want, params, final = _trajectory(variant)
    np.testing.assert_allclose(losses, want, rtol=1.2e-4, atol=1.2e-4,
                               err_msg="per-step train-mode loss curve")
    assert sorted(params) == sorted(final)
    for k in final:
        np.testing.assert_allclose(params[k].numpy(), final[k].numpy(),
                                   atol=2e-3, rtol=1e-3, err_msg=k)


def test_trajectory_oracle_catches_a_staircase_that_never_fires():
    losses, want, _, _ = _trajectory("legacy", decay_steps=1000)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(losses, want, rtol=1.2e-4, atol=1.2e-4)


# -- corpus and batches -------------------------------------------------------


def _write_corpus(path, n, hp, n_aug, rng):
    """The reference corpus layout (``tests/test_train.py``)."""
    os.makedirs(path, exist_ok=True)
    s = hp.im_size
    for i in range(n):
        with TiffWriter(os.path.join(path, f"I{i:05d}_Img.tif"),
                        bigtiff=False) as tw:
            for _ in range(n_aug * hp.n_channels):
                tw.write((rng.rand(s, s) * 65535).astype(np.uint16))
        with TiffWriter(os.path.join(path, f"I{i:05d}_Ant.tif"),
                        bigtiff=False) as tw:
            tw.write(rng.randint(1, hp.n_classes + 1, (s, s)).astype(np.uint8))
        with TiffWriter(os.path.join(path, f"I{i:05d}_wt.tif"),
                        bigtiff=False) as tw:
            tw.write((rng.rand(s, s) > 0.8).astype(np.uint8))


@pytest.mark.parametrize("variant,n_aug", [("v2", 3), ("duo", 1),
                                           ("cyto2", 1), ("legacy", 1)])
def test_corpus_and_batch_stream_bit_equal_jax(tmp_path, variant, n_aug):
    hp = _hp(variant)
    _write_corpus(str(tmp_path), 7, hp, n_aug, np.random.RandomState(12))
    cfg = ttr.TrainConfig.for_variant(variant, n_aug=n_aug)
    jcfg = jtr.TrainConfig.for_variant(variant, n_aug=n_aug)
    ours = ttr.Corpus(str(tmp_path), 7, hp, cfg)
    theirs = jtr.Corpus(str(tmp_path), 7, _jhp(hp), jcfg)
    for k in ("images", "labels", "weights"):
        assert np.array_equal(getattr(ours, k), getattr(theirs, k)), k
    assert cfg.per_step_shuffle == (variant == "legacy")
    for augment, jitter in ((n_aug > 1, True), (n_aug > 1, False)):
        a = ours.batches(3, np.random.RandomState(5), augment, jitter)
        b = theirs.batches(3, np.random.RandomState(5), augment, jitter)
        for _ in range(6):  # past an epoch reset
            x, y = next(a), next(b)
            for k in ("image", "labels", "weights"):
                assert np.array_equal(x[k], y[k]), k


def test_class_weight_maps_and_per_class_error():
    rng = np.random.RandomState(13)
    wt = (rng.rand(6, 6) > 0.5).astype(np.float32)
    for k, variant in ((3, "duo"), (2, "cyto2"), (3, "v2")):
        labels = np.eye(k, dtype=np.float32)[rng.randint(0, k, (6, 6))]
        cfg = ttr.TrainConfig.for_variant(variant)
        jcfg = jtr.TrainConfig.for_variant(variant)
        assert np.array_equal(ttr.class_weight_maps(labels, wt, cfg),
                              jtr.class_weight_maps(labels, wt, jcfg))
    assert np.array_equal(ttr.class_weight_maps(labels, wt),
                          jtr.class_weight_maps(labels, wt))
    probs = rng.rand(2, 5, 5, 3).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (2, 5, 5))]
    labels[..., 1] = 0  # a class with no labeled pixel: error 1 - 0/1
    got = ttr.per_class_error(torch.from_numpy(probs),
                              torch.from_numpy(labels)).numpy()
    want = np.asarray(jtr.per_class_error(jnp.asarray(probs),
                                          jnp.asarray(labels)))
    np.testing.assert_allclose(got, want, atol=1e-7)
    assert got[1] == 1.0


def test_bfloat16_step_tracks_jax_bfloat16():
    """The bf16 training step (bf16 conv outputs, float32 rest) against
    JAX's ``compute_dtype="bfloat16"`` step, at the loose bar of
    ``tests/test_train.py::test_mixed_precision_training_step``; and
    the bf16 loss near the float32 one."""
    hp = HParams(im_size=32, n_channels=1, n_classes=3, n_out0=4, ks=3,
                 n_layers=2, batch_size=4)
    tree = _jax_tree(hp, "v2", 14)
    batch = _batch(hp, 15, n=4)
    jcfg = jtr.TrainConfig.for_variant("v2", compute_dtype="bfloat16")
    tx = jtr.make_optimizer(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    step = jtr.make_train_step(_jhp(hp), jcfg, tx, donate=False)
    jp1, _, jm = step(jp, tx.init(jp), {k: jnp.asarray(v) for k, v in
                                        batch.items()}, None)
    losses = {}
    for dt in ("bfloat16", None):
        cfg = ttr.TrainConfig.for_variant("v2", compute_dtype=dt)
        t = ttr.Trainer(hp, cfg, "unused",
                        params=params_from_jax(tree, hp, "v2"), device="cpu")
        losses[dt] = float(t.train_step(t.model, t.opt_state, _nchw(batch),
                                        None)["loss"])
        if dt:
            want = params_from_jax(jax.tree_util.tree_map(np.asarray, jp1),
                                   hp, "v2")
            for k, v in t.params.items():
                assert v.dtype == torch.float32
                np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                           atol=5e-3, rtol=5e-3, err_msg=k)
    assert losses["bfloat16"] == pytest.approx(float(jm["loss"]), abs=5e-3)
    assert abs(losses["bfloat16"] - losses[None]) < 0.05
