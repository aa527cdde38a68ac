"""The port's standard-library msgpack codec (``unmicst_tpu_torch.core.
msgpack``) and native checkpoints, against the ``msgpack`` package, flax
and the JAX package's checkpoints and ``Trainer``."""

import os
import shutil

import jax
import msgpack as msgpack_pkg
import numpy as np
import optax
import pytest
import torch
from flax import serialization as flax_ser

from unmicst_tpu import train as jtr
from unmicst_tpu.core import checkpoint as jckpt
from unmicst_tpu.core.hp import HParams as JaxHParams
from unmicst_tpu_torch import cli
from unmicst_tpu_torch import train as ttr
from unmicst_tpu_torch.core import checkpoint as tckpt
from unmicst_tpu_torch.core import msgpack as mp
from unmicst_tpu_torch.core.hp import HParams, load_model_dir
from unmicst_tpu_torch.core.unet import init_params
from unmicst_tpu_torch.models import zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOB = os.path.join(REPO, "models", "blobDemo")

_VALUES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
    2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.5, -1e300, float("inf"), "",
    "a" * 31, "a" * 32, "é" * 200, "x" * 70000, b"", b"x" * 255,
    b"x" * 256, b"y" * 70000, [], list(range(15)), list(range(16)),
    list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): [i] for i in range(16)}, {"a": [1, {"b": None, "c": 2.5}]},
]


@pytest.mark.parametrize("value", _VALUES, ids=range(len(_VALUES)))
def test_round_trips_against_the_msgpack_package(value):
    ours = mp.packb(value)
    assert ours == msgpack_pkg.packb(value, use_bin_type=True)
    assert mp.unpackb(ours) == msgpack_pkg.unpackb(ours, raw=False)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 8, 16, 17, 255, 70000])
def test_ndarray_ext_sizes_match_flax(n):
    """An ndarray is ext type 1 around a nested msgpack payload; its size
    picks fixext, ext8, ext16 or ext32, as the msgpack package picks."""
    tree = {"a": np.arange(n, dtype=np.uint8).reshape(1, n),
            "s": np.float64(n)}
    ours = mp.serialize(tree)
    assert ours == flax_ser.msgpack_serialize(tree)
    back = mp.restore(ours)
    assert np.array_equal(back["a"], tree["a"]) and back["s"] == n
    with pytest.raises(ValueError, match="ext type 5"):
        mp.unpackb(msgpack_pkg.packb(msgpack_pkg.ExtType(5, b"x" * n)))


def test_truncated_and_trailing_bytes_raise():
    blob = mp.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError, match="ends early"):
        mp.unpackb(blob[:-1])
    with pytest.raises(ValueError, match="after the msgpack value"):
        mp.unpackb(blob + b"\x00")


def _tree(rng):
    return {
        "meta_json": "{\"variant\": \"v2\"}",
        "params": {
            "w": rng.rand(3, 4).astype(np.float32),
            "b": {"x": np.asarray(3, np.int64),
                  "y": np.arange(5, dtype=np.int32),
                  "z": rng.rand(2, 0, 3)},
            "s": np.float32(2.5),
            "flag": np.bool_(True),
        },
        "l": [np.zeros(2, np.float16), np.ones((2, 2), np.uint8)],
    }


def test_flax_reads_the_port_and_the_port_reads_flax():
    tree = _tree(np.random.RandomState(0))
    ours = mp.serialize(tree)
    assert ours == flax_ser.msgpack_serialize(tree)
    for back in (flax_ser.msgpack_restore(ours), mp.restore(ours)):
        a = jax.tree_util.tree_leaves_with_path(back)
        b = jax.tree_util.tree_leaves_with_path(tree)
        assert [p for p, _ in a] == [p for p, _ in b]
        for (_, x), (_, y) in zip(a, b):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            assert np.array_equal(x, y)


def test_chunked_arrays_match_flax(monkeypatch):
    """flax splits a leaf above its chunk size into flat pieces; at a small
    chunk size both packages write and read the same bytes."""
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(mp, "MAX_CHUNK_SIZE", 64)
    tree = {"a": np.arange(100, dtype=np.float32).reshape(4, 25),
            "b": {"c": np.arange(7, dtype=np.float64)}}
    ours = mp.serialize(tree)
    assert ours == flax_ser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in ours
    back = mp.restore(ours)
    assert np.array_equal(back["a"], tree["a"])
    assert np.array_equal(back["b"]["c"], tree["b"]["c"])
    assert np.array_equal(flax_ser.msgpack_restore(ours)["a"], tree["a"])


def _bundle_dir(tmp_path, keep):
    d = tmp_path / "blobDemo"
    d.mkdir()
    for f in os.listdir(BLOB):
        if keep(f):
            shutil.copy(os.path.join(BLOB, f), d / f)
    return str(d)


def test_blob_demo_msgpack_equals_its_tf1_bundle(tmp_path):
    bundle = load_model_dir(BLOB)
    params, hp, variant, mean, std, meta = tckpt.load_native(
        os.path.join(BLOB, tckpt.NATIVE_FILE))
    want = jckpt.load_native(os.path.join(BLOB, tckpt.NATIVE_FILE))
    assert (hp.to_ref_dict(), variant, mean, std) == (
        want[1].to_ref_dict(), want[2], want[3], want[4])
    assert variant == bundle.variant
    from_msgpack = tckpt.params_from_jax(params, hp, variant)
    from_tf1 = tckpt.load_tf1_params(os.path.join(BLOB, "model.ckpt"),
                                     bundle.hp, bundle.variant)
    assert sorted(from_msgpack) == sorted(from_tf1)
    for k, v in from_tf1.items():
        assert torch.equal(from_msgpack[k], v), k
    # a directory with the msgpack file alone loads it, and is ready
    d = _bundle_dir(tmp_path, lambda f: not f.startswith("model.ckpt"))
    got = tckpt.load_params_for_bundle(load_model_dir(d))
    for k, v in from_tf1.items():
        assert torch.equal(got[k], v), k
    assert zoo.available_models(str(tmp_path))["blobDemo"] == "ready (local)"


def test_a_dir_with_both_files_loads_the_native_one(tmp_path):
    """A native file beside a TF1 bundle holding other weights (a
    ``Trainer`` saved without the TF1 export over an exported dir): both
    packages load the native weights."""
    from unmicst_tpu.core.hp import load_model_dir as jax_load_model_dir

    d = _bundle_dir(tmp_path, lambda f: f != tckpt.NATIVE_FILE)
    bundle = load_model_dir(d)
    tf1 = tckpt.load_params_for_bundle(bundle)
    newer = {k: v + 0.25 for k, v in tf1.items()}
    _, hp, variant, mean, std, _ = tckpt.load_native(
        os.path.join(BLOB, tckpt.NATIVE_FILE))
    tckpt.save_native(os.path.join(d, tckpt.NATIVE_FILE),
                      tckpt.params_to_jax(newer, hp, variant), hp, variant,
                      mean, std)
    got = tckpt.load_params_for_bundle(load_model_dir(d))
    jb = jax_load_model_dir(d)
    theirs = tckpt.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jckpt.load_params_for_bundle(jb)),
        jb.hp, jb.variant)
    assert sorted(got) == sorted(newer) == sorted(theirs)
    for k, v in newer.items():
        assert torch.equal(got[k], v) and torch.equal(theirs[k], v), k
        assert not torch.equal(tf1[k], v), k


def test_native_files_cross_both_ways(tmp_path):
    hp = HParams(im_size=32, n_channels=1, n_classes=3, n_out0=4, ks=3,
                 n_extra_convs=1, n_layers=2)
    jhp = JaxHParams.from_ref_dict(hp.to_ref_dict())
    state = init_params(hp, "v2", torch.Generator().manual_seed(1))
    tree = tckpt.params_to_jax(state, hp, "v2")
    path = str(tmp_path / "port.msgpack")
    tckpt.save_native(path, tree, hp, "v2", 0.3, 0.2, extra={"step": 7},
                      extra_arrays={"x": [np.arange(3), {"y": np.ones(2)}]})
    jp, jh, jv, jm, js, jmeta = jckpt.load_native(path)
    assert (jh, jv, jm, js, jmeta["step"]) == (jhp, "v2", 0.3, 0.2, 7)
    assert np.array_equal(jmeta["_extra_arrays"]["x"][0], np.arange(3))
    back = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), hp,
                                 "v2")
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    # and the JAX writer's bytes equal the port's for the same tree
    jpath = str(tmp_path / "jax.msgpack")
    jckpt.save_native(jpath, tree, jhp, "v2", 0.3, 0.2, extra={"step": 7},
                      extra_arrays={"x": [np.arange(3), {"y": np.ones(2)}]})
    assert open(path, "rb").read() == open(jpath, "rb").read()
    with pytest.raises(ValueError, match="reserved"):
        tckpt.save_native(path, tree, hp, "v2", 0.3, 0.2,
                          extra={"variant": "legacy"})


HP = HParams(im_size=32, n_channels=1, n_classes=3, n_out0=4, ks=3,
             n_layers=2, batch_size=4)
JHP = JaxHParams.from_ref_dict(HP.to_ref_dict())


def _corpus(path):
    from unmicst_tpu.io.tiff import TiffWriter

    rng = np.random.RandomState(30)
    os.makedirs(path)
    for i in range(6):
        for kind, arr in (("Img", (rng.rand(32, 32) * 65535).astype(np.uint16)),
                          ("Ant", rng.randint(1, 4, (32, 32)).astype(np.uint8)),
                          ("wt", (rng.rand(32, 32) > .8).astype(np.uint8))):
            with TiffWriter(os.path.join(path, f"I{i:05d}_{kind}.tif"),
                            bigtiff=False) as tw:
                tw.write(arr)
    return path


def _same_slots(port_trainer, jax_opt_state):
    ours = port_trainer.tx.state_dict(port_trainer.opt_state, HP, "v2")
    theirs = flax_ser.to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                           jax_opt_state))
    a = jax.tree_util.tree_flatten_with_path(ours)[0]
    b = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        assert np.array_equal(np.asarray(x), np.asarray(y)), \
            jax.tree_util.keystr(p)


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_trainer_checkpoints_cross_both_ways(tmp_path, optimizer):
    """A port checkpoint resumes in the JAX ``Trainer`` with the same
    step, weights, slots and learning rate, and the other way round; the
    TF1 bundle beside it loads in JAX's ``load_tf1_params``."""
    data = _corpus(str(tmp_path / "data"))
    kw = dict(n_aug=1, lr0=1e-3, seed=0, ckpt_every=1, decay_steps=2,
              optimizer=optimizer, tb_images=False)
    cfg = ttr.TrainConfig.for_variant("v2", **kw)
    jcfg = jtr.TrainConfig.for_variant("v2", **kw)
    # port -> JAX
    t = ttr.Trainer(HP, cfg, str(tmp_path / "mp"), device="cpu")
    corpus = ttr.Corpus(data, 6, HP, cfg)
    t.fit(corpus, corpus, n_steps=3, verbose=False)
    t.close()
    t.restore()  # the port's own view of what it wrote
    j = jtr.Trainer(JHP, jcfg, str(tmp_path / "mp"))
    j.restore()
    assert j.step == t.step == t.opt_state.count
    _same_slots(t, j.opt_state)
    sched = optax.exponential_decay(cfg.lr0, cfg.decay_steps, cfg.decay_rate,
                                    staircase=True)
    assert ttr.learning_rate(cfg, t.opt_state.count) == pytest.approx(
        float(sched(j.opt_state[-1].count)), rel=1e-7)
    jw = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, j.params),
                               HP, "v2")
    tf1 = jckpt.load_tf1_params(str(tmp_path / "mp" / "model.ckpt"), JHP,
                                "v2")
    jt = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, tf1), HP,
                               "v2")
    for k, v in t.params.items():
        assert torch.equal(jw[k], v) and torch.equal(jt[k], v), k
    # JAX -> port
    j2 = jtr.Trainer(JHP, jcfg, str(tmp_path / "mj"))
    jc = jtr.Corpus(data, 6, JHP, jcfg)
    j2.fit(jc, jc, n_steps=3, verbose=False)
    j2.close()
    j2.restore()
    t2 = ttr.Trainer(HP, cfg, str(tmp_path / "mj"), device="cpu")
    t2.restore()
    assert t2.step == j2.step == t2.opt_state.count
    _same_slots(t2, j2.opt_state)
    jw = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, j2.params),
                               HP, "v2")
    for k, v in t2.params.items():
        assert torch.equal(jw[k], v), k
    # and it trains on from there
    t2.fit(ttr.Corpus(data, 6, HP, cfg), ttr.Corpus(data, 6, HP, cfg),
           n_steps=1, verbose=False)
    assert t2.opt_state.count == j2.step + 1


def test_cli_runs_a_msgpack_only_model_dir(tmp_path, capsys):
    """``--listModels`` calls a msgpack-only directory ready, and the CLI
    runs it (the same pages as from the TF1 bundle)."""
    from unmicst_tpu_torch.io.tiff import imread, imwrite

    root = tmp_path / "zoo"
    root.mkdir()
    _bundle_dir(root, lambda f: not f.startswith("model.ckpt"))
    tf1_root = tmp_path / "zoo_tf1"
    tf1_root.mkdir()
    _bundle_dir(tf1_root, lambda f: f != tckpt.NATIVE_FILE)
    assert cli.main(["--listModels", "--modelRoot", str(root)]) == 0
    assert "ready (local)" in capsys.readouterr().out
    img = (np.random.RandomState(31).rand(96, 80) * 65535).astype(np.uint16)
    src = str(tmp_path / "s.tif")
    imwrite(src, img)
    pages = {}
    for name, r in (("msgpack", str(root)), ("tf1", str(tf1_root))):
        out = str(tmp_path / name)
        assert cli.main([src, "--model", "blobDemo", "--modelRoot", r,
                         "--outputPath", out, "--stackOutput"],
                        device="cpu") == 0
        pages[name] = [imread(os.path.join(out, "s_Probabilities_1.tif"), k)
                       for k in range(3)]
    for a, b in zip(pages["msgpack"], pages["tf1"]):
        assert np.array_equal(a, b)
