"""The port's ``Trainer`` (``unmicst_tpu_torch.train``) against the JAX
package's on the CPU: a legacy fit from the same weights, the validation
cadence, async and prefetch equivalences, TensorBoard tags, montages and
the device rule.

A legacy fit has no dropout, so the two packages compute the same steps:
the ``metrics.jsonl`` records agree to 1e-5 relative in the losses and
exactly in the validation errors (a count of pixels; none sits at a tie
at these sizes)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from unmicst_tpu import train as jtr
from unmicst_tpu.core.hp import HParams as JaxHParams
from unmicst_tpu.io.tiff import TiffWriter
from unmicst_tpu_torch import train as ttr
from unmicst_tpu_torch.core.checkpoint import params_from_jax, params_to_jax
from unmicst_tpu_torch.core.hp import HParams
from unmicst_tpu_torch.core.unet import UNet, init_params

HP = HParams(im_size=32, n_channels=1, n_classes=3, n_out0=4, ks=3,
             n_extra_convs=0, n_layers=2, batch_size=4)
JHP = JaxHParams.from_ref_dict(HP.to_ref_dict())


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    """Six samples in the reference layout, two augmentation pages."""
    path = str(tmp_path_factory.mktemp("corpus"))
    rng = np.random.RandomState(20)
    for i in range(6):
        with TiffWriter(os.path.join(path, f"I{i:05d}_Img.tif"),
                        bigtiff=False) as tw:
            for _ in range(2):
                tw.write((rng.rand(32, 32) * 65535).astype(np.uint16))
        with TiffWriter(os.path.join(path, f"I{i:05d}_Ant.tif"),
                        bigtiff=False) as tw:
            tw.write(rng.randint(1, 4, (32, 32)).astype(np.uint8))
        with TiffWriter(os.path.join(path, f"I{i:05d}_wt.tif"),
                        bigtiff=False) as tw:
            tw.write((rng.rand(32, 32) > 0.8).astype(np.uint8))
    return path


def _records(log):
    recs = [json.loads(line) for line in
            open(os.path.join(log, "metrics.jsonl"))]
    for r in recs:
        r.pop("elapsed_s")
    return recs


def _state(variant, seed=0):
    return init_params(HP, variant, torch.Generator().manual_seed(seed))


def _fit(tmp_path, corpus_dir, tag, n_steps, state=None, **overrides):
    cfg = ttr.TrainConfig.for_variant("v2", n_aug=1, lr0=1e-3, seed=0,
                                      **overrides)
    corpus = ttr.Corpus(corpus_dir, 6, HP, cfg)
    log = str(tmp_path / f"log_{tag}")
    t = ttr.Trainer(HP, cfg, str(tmp_path / f"m_{tag}"), log_path=log,
                    params=state, device="cpu")
    best = t.fit(corpus, corpus, n_steps=n_steps, verbose=False)
    t.close()
    return t, best, log


def test_legacy_fit_matches_jax_fit(tmp_path, corpus_dir):
    """Four legacy steps (Momentum, per-step shuffle, no weights) in both
    packages from the same weights: the same metrics and parameters."""
    jcfg = jtr.TrainConfig.for_variant("legacy", seed=0, ckpt_every=1,
                                       tb_images=False, export_tf1=False)
    cfg = ttr.TrainConfig.for_variant("legacy", seed=0, ckpt_every=1,
                                      tb_images=False, export_tf1=False)
    state = _state("legacy", 3)
    tree = params_to_jax(state, HP, "legacy")
    jt = jtr.Trainer(JHP, jcfg, str(tmp_path / "mj"),
                     log_path=str(tmp_path / "lj"),
                     params=jax.tree_util.tree_map(np.asarray, tree))
    jbest = jt.fit(jtr.Corpus(corpus_dir, 6, JHP, jcfg),
                   jtr.Corpus(corpus_dir, 6, JHP, jcfg), 4, verbose=False)
    jt.close()
    t = ttr.Trainer(HP, cfg, str(tmp_path / "mt"),
                    log_path=str(tmp_path / "lt"), params=state, device="cpu")
    best = t.fit(ttr.Corpus(corpus_dir, 6, HP, cfg),
                 ttr.Corpus(corpus_dir, 6, HP, cfg), 4, verbose=False)
    t.close()
    ours, theirs = _records(tmp_path / "lt"), _records(tmp_path / "lj")
    assert [r["step"] for r in ours] == [r["step"] for r in theirs] == [
        0, 1, 2, 3]
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in ("loss", "ce"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), (a["step"], k)
        assert a["reg"] == b["reg"] == 0.0
        assert a["valid_error"] == pytest.approx(b["valid_error"], abs=1e-7)
        np.testing.assert_allclose(a["errors"], b["errors"], atol=1e-7)
    assert best == pytest.approx(jbest, abs=1e-7)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), HP,
                           "legacy")
    for k, v in t.params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_valid_every_cadence(tmp_path, corpus_dir):
    """Validation at steps 0, 3, 6 and the last; the others logged from
    the buffer without valid fields (``tests/test_train.py``)."""
    t, best, log = _fit(tmp_path, corpus_dir, "ve", 8, ckpt_every=1,
                        valid_every=3, export_tf1=False,
                        tb_images=False)
    recs = _records(log)
    assert [r["step"] for r in recs] == list(range(8))
    validated = {r["step"] for r in recs if "valid_error" in r}
    assert validated == {0, 3, 6, 7}
    for r in recs:
        assert np.isfinite(r["loss"])
        assert ("errors" in r) == (r["step"] in validated)
    assert best == min(r["valid_error"] for r in recs if "valid_error" in r)


def test_prefetch_is_bit_identical_to_inline(tmp_path, corpus_dir):
    out = {}
    for prefetch in (0, 2):
        t, _, log = _fit(tmp_path, corpus_dir, f"p{prefetch}", 5,
                         ckpt_every=2, valid_every=2, prefetch=prefetch,
                         export_tf1=False, tb_images=False)
        out[prefetch] = (t.params, _records(log))
    assert out[0][1] == out[2][1]
    for k, v in out[0][0].items():
        assert torch.equal(v, out[2][0][k]), k


def test_prefetch_feed_propagates_errors():
    def boom():
        yield 1
        raise RuntimeError("feed died")

    feed = ttr._PrefetchFeed(boom(), depth=2)
    assert next(feed) == 1
    with pytest.raises(RuntimeError, match="feed died"):
        next(feed)
    feed.close()


def test_async_save_matches_sync_and_resumes(tmp_path, corpus_dir):
    """The async writer's files equal the synchronous one's byte for
    byte; a restored trainer carries the step, weights and slots."""
    dirs = {}
    for async_save in (False, True):
        t, _, _ = _fit(tmp_path, corpus_dir, f"a{async_save}", 4,
                       ckpt_every=2, async_save=async_save, tb_images=False)
        dirs[async_save] = str(tmp_path / f"m_a{async_save}")
    for name in ("model.unmicst-tpu.msgpack", "hp.data", "datasetMean.data",
                 "datasetStDev.data", "model.ckpt.index",
                 "model.ckpt.data-00000-of-00001", "checkpoint"):
        a = open(os.path.join(dirs[False], name), "rb").read()
        b = open(os.path.join(dirs[True], name), "rb").read()
        assert a == b, name
    cfg = ttr.TrainConfig.for_variant("v2", n_aug=1, lr0=1e-3, seed=0)
    r = ttr.Trainer(HP, cfg, dirs[True], device="cpu")
    r.restore()
    assert r.restored and r.step in (1, 3)
    assert r.opt_state.count == r.step
    assert float(r.opt_state.slots["nu"]["top.kernel"].abs().max()) > 0
    corpus = ttr.Corpus(corpus_dir, 6, HP, cfg)
    r.fit(corpus, corpus, n_steps=2, verbose=False)
    assert r.opt_state.count == r.step


def test_async_save_error_surfaces(tmp_path, monkeypatch):
    cfg = ttr.TrainConfig.for_variant("v2", n_aug=1, async_save=True)
    t = ttr.Trainer(HP, cfg, str(tmp_path / "m"), device="cpu")

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(t, "_write_checkpoint", fail)
    t.save()
    with pytest.raises(OSError, match="disk full"):
        t.close()
    t.close()  # the error is consumed; close is idempotent after


def test_tensorboard_tags_and_steps_equal_jax(tmp_path, corpus_dir):
    """Both packages' event files hold the same scalar tags at the same
    steps and the same image tags (the reference's summary layout)."""
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    def tags(log):
        out = {}
        for w in ("Train", "Valid"):
            acc = EventAccumulator(str(log / w), size_guidance={
                "images": 0, "scalars": 0})
            acc.Reload()
            t = acc.Tags()
            out[w] = ({k: [e.step for e in acc.Scalars(k)]
                       for k in t["scalars"]},
                      {k: [e.step for e in acc.Images(k)]
                       for k in t["images"]},
                      {k: acc.Images(k)[0].width for k in t["images"]})
        return out

    kw = dict(n_aug=1, lr0=1e-3, seed=0, valid_every=3, export_tf1=False)
    jcfg = jtr.TrainConfig.for_variant("v2", **kw)
    jt = jtr.Trainer(JHP, jcfg, str(tmp_path / "mj"),
                     log_path=str(tmp_path / "lj"))
    jc = jtr.Corpus(corpus_dir, 6, JHP, jcfg)
    jt.fit(jc, jc, n_steps=22, verbose=False)
    jt.close()
    _fit(tmp_path, corpus_dir, "tb", 22, valid_every=3, export_tf1=False)
    ours, theirs = tags(tmp_path / "log_tb"), tags(tmp_path / "lj")
    assert ours == theirs
    assert ours["Train"][0]["avg_cross_entropy"] == [0, 20]
    assert "impm/3" in ours["Valid"][1] and "impm/4" not in ours["Valid"][1]


def test_panels_equal_jax(tmp_path):
    """The image panels' pixels, v2 and legacy layouts."""
    x = np.random.RandomState(21).normal(0, 1, (5, 32, 32, 1)).astype(
        np.float32)
    for variant in ("v2", "legacy"):
        state = _state(variant, 4)
        jcfg = jtr.TrainConfig.for_variant(variant)
        cfg = ttr.TrainConfig.for_variant(variant)
        want = jtr.make_panel_fn(JHP, jcfg)(
            jax.tree_util.tree_map(np.asarray,
                                   params_to_jax(state, HP, variant)), x)
        got = ttr.make_panel_fn(HP, cfg)(state, x)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_montages_equal_jax(tmp_path, corpus_dir):
    """``render_test_montages`` PNGs against the JAX package's (PIL):
    the image and ground-truth thirds equal, the map third within one
    level (``uint8(255 p)`` truncates)."""
    from PIL import Image

    cfg = ttr.TrainConfig.for_variant("v2", n_aug=2)
    jcfg = jtr.TrainConfig.for_variant("v2", n_aug=2)
    state = _state("v2", 5)
    ttr.render_test_montages(state, HP, cfg,
                             ttr.Corpus(corpus_dir, 2, HP, cfg),
                             str(tmp_path / "t"))
    jtr.render_test_montages(
        jax.tree_util.tree_map(np.asarray, params_to_jax(state, HP, "v2")),
        JHP, jcfg, jtr.Corpus(corpus_dir, 2, JHP, jcfg), str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    assert len(names) == 2 * 2 * 2 and "I00002_1_Nuc.png" in names
    for n in names:
        a = np.asarray(Image.open(tmp_path / "t" / n)).astype(int)
        b = np.asarray(Image.open(tmp_path / "j" / n)).astype(int)
        assert a.shape == b.shape == (32, 96)
        assert np.array_equal(a[:, :32], b[:, :32]), n
        assert np.array_equal(a[:, 64:], b[:, 64:]), n
        assert np.abs(a[:, 32:64] - b[:, 32:64]).max() <= 1, n


def test_trainer_needs_a_card_unless_cpu_is_asked_for(tmp_path, monkeypatch):
    cfg = ttr.TrainConfig.for_variant("legacy")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.Trainer(HP, cfg, str(tmp_path / "m"))
    t = ttr.Trainer(HP, cfg, str(tmp_path / "m"), device="cpu")
    assert t.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in t.params.values())
    from unmicst_tpu_torch.runtime.mesh import make_mesh

    meshed = ttr.Trainer(HP, cfg, str(tmp_path / "m"),
                         mesh=make_mesh(devices=["cpu"] * 2))
    assert meshed.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in meshed.params.values())
    with pytest.raises(ValueError, match="first local rank"):
        ttr.Trainer(HP, cfg, str(tmp_path / "m"),
                    mesh=make_mesh(devices=["cpu"] * 2), device="cuda")


def test_precision_flags_are_restored():
    torch.backends.cuda.matmul.allow_tf32 = True
    before = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)
    for precision, tf32 in (("high", False), ("highest", False),
                            ("default", True)):
        with ttr.precision_flags(ttr.TrainConfig(precision=precision)):
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
            assert torch.backends.cudnn.allow_tf32 is tf32
            assert torch.backends.cudnn.benchmark
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert (torch.backends.cudnn.benchmark,
                torch.backends.cudnn.allow_tf32) == before
    with pytest.raises(ValueError, match="precision"):
        with ttr.precision_flags(ttr.TrainConfig(precision="fast")):
            pass


def test_variant_presets_equal_jax():
    for variant in ("legacy", "v2", "duo", "cyto2"):
        a = ttr.TrainConfig.for_variant(variant)
        b = jtr.TrainConfig.for_variant(variant)
        assert {f: getattr(a, f) for f in a.__dataclass_fields__} == {
            f: getattr(b, f) for f in b.__dataclass_fields__}
    assert UNet(HP, "v2").state_dict().keys() == _state("v2").keys()
