"""The port's int8 post-training quantization (``core/quant.py``,
``quant_conv`` in ``core/unet.py``, the engines' int8 mode) against the
JAX package on the CPU, on the same seeded numpy inputs and weights.

* ``quant_conv``: equal to JAX's ``unet.quant_conv`` (atol 0) at every
  site of the nucleiDAPI net and of a narrow nucleiDAPILAMIN net, with
  and without the bias, and with the tiles cut into im2col groups.
* ``conv_sites``, ``sample_tiles``, ``sample_tiles_raw`` and the
  calibration tiles of every engine path: equal to JAX's.
* ``calibrate`` from the same tiles: scales within rtol 1e-5 (measured
  at most 1.2e-6), ``w8`` at most 1 apart on at most 0.1% of entries
  (measured: one entry), bias within 32 int8 flips' share of the mean
  (``test_calibrate_matches_jax``; measured at most 22.6).
* The engines with one JAX QuantState pinned into both (``quant_from_
  jax``): float32 glue at most 2 levels on at most 0.5% of pixels
  (measured here at most 1 level, on 0.091% at scale 0.5; with another
  calibration of blobDemo, 2 levels on 0.038%), bfloat16 glue at most 2
  levels on at most 5% (measured at most 2 levels on 0.024%); the host
  float path within 2/255 (measured 9.3e-4).  The float glue's
  summation order differs by ulps, which flips a handful of int8 inputs
  at a rounding edge (measured 13 of 5.6 million site inputs on blobDemo
  tiles), so a 1-level bar in float32 does not hold in general.

The JAX int8 path runs on the CPU as ``tests/test_quant.py`` runs it.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmicst_tpu.core import quant as jquant
from unmicst_tpu.core import unet as junet
from unmicst_tpu.core.checkpoint import load_params_for_bundle as jax_bundle_params
from unmicst_tpu.core.checkpoint import load_tf1_params as jax_tf1_params
from unmicst_tpu.core.hp import HParams as JaxHParams
from unmicst_tpu.core.hp import load_model_dir as jax_model_dir
from unmicst_tpu.infer import InferenceEngine as JaxEngine
from unmicst_tpu.runtime.pipeline import StreamingEngine as JaxStream
from unmicst_tpu.utils import flops as jflops
from unmicst_tpu_torch.core import quant, unet
from unmicst_tpu_torch.core.checkpoint import (load_params_for_bundle,
                                               load_tf1_params,
                                               params_from_jax)
from unmicst_tpu_torch.core.hp import HParams, load_model_dir
from unmicst_tpu_torch.infer import InferenceEngine, tile_bytes
from unmicst_tpu_torch.runtime.mesh import make_mesh
from unmicst_tpu_torch.runtime.pipeline import StreamingEngine
from unmicst_tpu_torch.utils import flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "models", "blobDemo")
FIXTURES = os.path.join(REPO, "tests", "fixtures")
ORACLE_MEAN, ORACLE_STD = 0.2, 0.16  # tests/test_torch_infer.py's
DUO_MEAN, DUO_STD = 0.18, 0.17  # nucleiDAPILAMIN's (SURVEY.md 2.4)

# nucleiDAPI's published widths (SURVEY.md 2.4) and nucleiDAPILAMIN's
# with nOut0 36 cut to 4, at a small tile
NUCLEI_DAPI = dict(im_size=32, n_channels=1, n_classes=3, n_out0=16, ks=5,
                   n_extra_convs=1, n_layers=2, std_dev0=0.03)
NARROW_DUO = dict(im_size=64, n_channels=2, n_classes=3, n_out0=4, ks=3,
                  n_extra_convs=0, n_layers=5, std_dev0=0.03)

# (float32 glue, bfloat16 glue): (most levels apart, largest share apart)
BARS = {None: (2, 0.005), torch.bfloat16: (2, 0.05)}

_NETS = {}


def _net(name):
    """(JAX hp, JAX params, port hp, port state, variant, mean, std) of
    blobDemo, the oracle_legacy TF1 net (nucleiDAPI's topology: ks 5, one
    extra conv, 1x1 shortcuts) or the oracle_duo TF1 net."""
    if name not in _NETS:
        if name == "demo":
            jb, tb = jax_model_dir(DEMO), load_model_dir(DEMO)
            _NETS[name] = (jb.hp, jax_bundle_params(jb), tb.hp,
                           load_params_for_bundle(tb), tb.variant, tb.mean,
                           tb.std)
        else:
            d = os.path.join(FIXTURES, f"oracle_{name}")
            with open(os.path.join(d, "hp.json")) as f:
                ref = json.load(f)
            jhp, hp = JaxHParams.from_ref_dict(ref), HParams.from_ref_dict(ref)
            variant = "legacy" if name == "legacy" else "v2"
            prefix = os.path.join(d, "model.ckpt")
            mean, std = ((ORACLE_MEAN, ORACLE_STD) if name == "legacy"
                         else (DUO_MEAN, DUO_STD))
            _NETS[name] = (jhp, jax_tf1_params(prefix, jhp, variant), hp,
                           load_tf1_params(prefix, hp, variant), variant,
                           mean, std)
    return _NETS[name]


def _seeded(kw, variant, seed=0):
    """(JAX hp, JAX params as numpy, port hp, port state) of a seeded
    net."""
    jhp, hp = JaxHParams(**kw), HParams(**kw)
    params = jax.tree_util.tree_map(np.asarray, junet.init_params(
        jax.random.PRNGKey(seed), jhp, variant))
    return jhp, params, hp, params_from_jax(params, hp, variant)


def _plane(shape, seed, top=40000, dtype=np.uint16):
    """Noise with a few bright discs, so the maps are not flat."""
    rng = np.random.RandomState(seed)
    img = rng.rand(*shape) * 0.3 * top
    rr, cc = np.ogrid[: shape[0], : shape[1]]
    for _ in range(6):
        r, c = rng.randint(8, shape[0] - 8), rng.randint(8, shape[1] - 8)
        img[(rr - r) ** 2 + (cc - c) ** 2 < rng.randint(16, 64)] = 0.8 * top
    return img.astype(dtype)


def _assert_maps(a, b, glue):
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    d = np.abs(a.astype(int) - b.astype(int))
    levels, share = BARS[glue]
    assert d.max() <= levels and (d > 0).mean() <= share, (
        d.max(), (d > 0).mean())


def _port_state(jqs):
    return quant.quant_from_jax(jax.tree_util.tree_map(np.asarray, jqs))


# -- quant_conv and the sites ----------------------------------------------------


@pytest.mark.parametrize("net", ["nucleiDAPI", "narrow-duo"])
@pytest.mark.parametrize("mode", ["bias", "no-bias", "grouped"])
def test_quant_conv_matches_jax(monkeypatch, net, mode):
    """Every int8 site of the net: the same input, scales and quantized
    kernel give the same float32 output, bit for bit.  ``grouped`` cuts
    the im2col into one tile a group, the smallest of 16 rows (the card's
    ``_int_mm`` takes more than 16: the buffer pads them)."""
    kw, variant = ((NUCLEI_DAPI, "legacy") if net == "nucleiDAPI"
                   else (NARROW_DUO, "duo"))
    jhp, params, hp, _ = _seeded(kw, variant)
    if mode == "grouped":
        monkeypatch.setattr(unet, "IM2COL_BUDGET", 1)
    rng = np.random.RandomState(1)
    for site, w in jquant.conv_sites(params, jhp).items():
        w = np.asarray(w)
        cin, cout = w.shape[2], w.shape[3]
        side = 4 if mode == "grouped" else 12
        x = (rng.randn(3, side, side, cin) * 2).astype(np.float32)
        a = (np.abs(rng.randn(cin)) * 0.03 + 0.005).astype(np.float32)
        qk = {k: np.asarray(v) for k, v in jquant._quantize_kernel(w, a)
              .items()}
        if mode != "no-bias":
            qk["bias"] = rng.randn(cout).astype(np.float32)
        ref = np.asarray(junet.quant_conv(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in qk.items()},
            jnp.asarray(a)))
        pq = quant.quant_from_jax({"kernels": {site: qk},
                                   "scales": {site: a}})
        got = unet.quant_conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                              pq["kernels"][site], pq["scales"][site])
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref,
                                      err_msg=site)


# the published widths: nucleiDAPI and nucleiDAPILAMIN (SURVEY.md 2.4)
FULL = {"nucleiDAPI": (dict(NUCLEI_DAPI, im_size=128), "legacy"),
        "nucleiDAPILAMIN": (dict(NARROW_DUO, im_size=128, n_out0=36),
                            "duo")}


def _site_shapes(name):
    """(site, OIHW kernel shape) of every int8 site at full width."""
    kw, variant = FULL[name]
    hp = HParams(**kw)
    state = unet.UNet(hp, variant).state_dict()
    return [(site, w.shape) for site, w in quant.conv_sites(state,
                                                            hp).items()]


@pytest.mark.parametrize("name", list(FULL))
def test_int8_sums_are_exact(name):
    """At every site of both published nets, worst-case int8 operands
    (+-127): the int32 sums equal a float64 convolution of the same
    values.  K reaches 7776 on nucleiDAPILAMIN's ``up4.k2``, where a
    float32 sum of int8 products is no longer exact (K * 127^2 > 2^24)."""
    rng = np.random.RandomState(24)
    for site, shape in _site_shapes(name):
        cout, cin, ks, _ = shape
        x8 = torch.from_numpy(rng.choice([-127, 127, 0, 5], (2, cin, 5, 5))
                              .astype(np.int8))
        w8 = torch.from_numpy(rng.choice([-127, 127, -3], shape)
                              .astype(np.int8))
        ref = torch.nn.functional.conv2d(x8.double(), w8.double(),
                                         padding=ks // 2)
        got = unet.quant_conv_sums(x8, w8)
        assert got.dtype == torch.int32
        assert torch.equal(got.long(), ref.long()), site
        assert torch.equal(got.double(), ref), site


@pytest.mark.parametrize("variant,extra,ks", [
    ("legacy", 1, 5), ("legacy", 0, 5), ("v2", 0, 3), ("duo", 0, 3),
    ("legacy", 0, 4)])
def test_conv_sites_match_jax(variant, extra, ks):
    """Names, order and kernels (HWIO against OIHW), fused and unfused
    (an even legacy kernel takes no 1x1 fold)."""
    kw = dict(NUCLEI_DAPI, n_extra_convs=extra, ks=ks, n_layers=3)
    jhp, params, hp, state = _seeded(kw, variant, seed=2)
    ref = jquant.conv_sites(params, jhp)
    got = quant.conv_sites(state, hp)
    assert list(got) == list(ref)
    for site, w in ref.items():
        np.testing.assert_array_equal(
            got[site], np.transpose(np.asarray(w), (3, 2, 0, 1)))


def test_quant_from_jax_and_to_device():
    jhp, params, hp, _ = _seeded(NUCLEI_DAPI, "legacy")
    tiles = np.random.RandomState(3).randn(4, 32, 32, 1).astype(np.float32)
    jqs = jquant.calibrate(params, tiles, jhp, "legacy")
    pqs = _port_state(jqs)
    for site, qk in jqs["kernels"].items():
        w8 = pqs["kernels"][site]["w8"]
        assert w8.dtype == torch.int8 and w8.shape == tuple(
            np.asarray(qk["w8"]).shape[i] for i in (3, 2, 0, 1))
    dev = quant.to_device(pqs, "cpu")
    mat = dev["kernels"]["up0.k2"]["w8_mat"]
    kp, n_pad = mat.shape
    assert kp % 8 == 0 and n_pad % 8 == 0 and mat.stride() == (1, kp)
    assert mat[17 * 25 :].abs().sum() == 0 and mat[:, 16:].abs().sum() == 0


# -- calibration tiles and calibrate ---------------------------------------------


@pytest.mark.parametrize("case", ["2d", "stack", "short", "n10"])
def test_sample_tiles_match_jax(case):
    jhp, hp = JaxHParams(**NARROW_DUO), HParams(**NARROW_DUO)
    rng = np.random.RandomState(4)
    image = {"2d": rng.rand(300, 220), "stack": rng.rand(2, 150, 410),
             "short": rng.rand(40, 500), "n10": rng.rand(200, 200)}[case]
    n = 10 if case == "n10" else 64
    np.testing.assert_array_equal(
        quant.sample_tiles(image, hp, 0.2, 0.1, n=n, seed=3),
        jquant.sample_tiles(image, jhp, 0.2, 0.1, n=n, seed=3))


@pytest.mark.parametrize("kw", [
    {"scale": 65535.0}, {"scale": 65535.0, "outlier": 99.0},
    {"scale": 255.0, "rescale": False},
    {"scale": 65535.0, "in_range": (1000, 30000)},
    {"scale": None, "in_range": [(0.1, 0.5), (0.2, 0.9)]},
], ids=["minmax", "outlier", "no-rescale", "in_range", "unit-stack"])
def test_sample_tiles_raw_match_jax(kw):
    jhp, hp = JaxHParams(**NARROW_DUO), HParams(**NARROW_DUO)
    if kw["scale"] is None:
        planes = np.random.RandomState(5).rand(2, 170, 230).astype(
            np.float32)
    else:
        dtype = np.uint8 if kw["scale"] == 255.0 else np.uint16
        planes = _plane((170, 230), 5, top=250 if dtype == np.uint8
                        else 40000, dtype=dtype)
    np.testing.assert_array_equal(
        quant.sample_tiles_raw(planes, hp, 0.2, 0.1, **kw),
        jquant.sample_tiles_raw(planes, jhp, 0.2, 0.1, **kw))


class _Tiles(Exception):
    """Carries the tiles a calibration was handed, and stops the call."""


def _capture(monkeypatch):
    """Make both packages' calibrate raise with the tiles they get."""
    def grab(params, tiles, *a, **k):
        raise _Tiles(np.asarray(tiles))

    monkeypatch.setattr(jquant, "calibrate", grab)
    monkeypatch.setattr(quant, "calibrate", grab)


def _tiles_of(fn):
    with pytest.raises(_Tiles) as e:
        fn()
    return e.value.args[0]


_PATHS = {
    # name: (net, engine kind, call(engine, planes), planes)
    "infer": ("demo", "whole", lambda e, p: e.infer(p[0] / 65535.0), 1),
    "infer_slide": ("demo", "whole", lambda e, p: e.infer_slide(p[0]), 1),
    "outlier": ("demo", "whole",
                lambda e, p: e.infer_slide(p[0], outlier=99.0), 1),
    "no-rescale": ("demo", "whole",
                   lambda e, p: e.infer_slide(p[0], rescale=False), 1),
    "uint8": ("demo", "whole",
              lambda e, p: e.infer_slide((p[0] // 257).astype(np.uint8)), 1),
    "float32": ("demo", "whole",
                lambda e, p: e.infer_slide(p[0].astype(np.float32)), 1),
    "in_range": ("demo", "whole",
                 lambda e, p: e.infer_slide(p[0], in_range=(900, 31000)), 1),
    "scale-0.5": ("demo", "whole",
                  lambda e, p: e.infer_slide(p[0], scaling_factor=0.5), 1),
    "scale-0.65-in_range": ("demo", "whole", lambda e, p: e.infer_slide(
        p[0], scaling_factor=0.65, in_range=(900, 31000)), 1),
    "stack": ("duo", "whole", lambda e, p: e.infer_slide_stack(p), 2),
    "stack-scale-in_range": ("duo", "whole", lambda e, p: e.infer_slide_stack(
        p, scaling_factor=0.5, in_range=[(900, 31000), (100, 9000)]), 2),
    "stream": ("demo", "stream", lambda e, p: e.infer(p[0]), 1),
    "stream-no-rescale": ("demo", "stream",
                          lambda e, p: e.infer(p[0], rescale=False), 1),
    "stream-stats": ("demo", "stream",
                     lambda e, p: e.infer(p[0], stats=(500.0, 30000.0)), 1),
    "stream-stack": ("duo", "stream", lambda e, p: e.infer_stack(p), 2),
}


@pytest.mark.parametrize("path", list(_PATHS))
def test_calibration_tiles_match_jax(monkeypatch, path):
    """Every engine path hands calibrate the same tiles as JAX's: the
    host float path, the raw slide at scale 1 and at a scale (the
    resized row bands), the pinned range, the stack, and the stream's
    own grid read through its sources with its own global ranges."""
    net, kind, call, n_planes = _PATHS[path]
    jhp, jparams, hp, state, variant, mean, std = _net(net)
    planes = [_plane((260, 210), 6), _plane((260, 210), 7, top=12000)]
    planes = planes[:n_planes]
    if kind == "whole":
        ours = InferenceEngine(hp, state, variant, mean, std, quantized=True,
                               device="cpu")
        theirs = JaxEngine(jhp, jparams, variant, mean, std, quantized=True)
    else:
        ours = StreamingEngine(hp, state, variant, mean, std, quantized=True,
                               stripe_tile_rows=2, device="cpu")
        theirs = JaxStream(jhp, jparams, variant, mean, std, quantized=True,
                           stripe_tile_rows=2)
    _capture(monkeypatch)
    got = _tiles_of(lambda: call(ours, planes))
    ref = _tiles_of(lambda: call(theirs, planes))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("net", ["demo", "legacy", "duo"])
def test_calibrate_matches_jax(net):
    """Scales, weights and bias from the same tiles.  The bias is held in
    units of one int8 input flip's share of the mean, ``127 * w_scale /
    pixels``: JAX's bias pass divides by the captured scales' reciprocal
    (XLA folds the constant), so some of its int8 inputs land one step
    from the port's, and a ``w8`` entry at a rounding edge moves the mean
    of a whole site.  Measured: at most one ``w8`` entry 1 apart (duo
    ``bottom``, 1 of 73728), bias at most 22.6 units apart (the same
    site; 15.0 where ``w8`` is equal)."""
    jhp, jparams, hp, state, variant, mean, std = _net(net)
    planes = [_plane((300, 260), 8), _plane((300, 260), 9, top=12000)]
    image = np.stack(planes[: hp.n_channels]).astype(np.float32) / 65535
    tiles = quant.sample_tiles(image, hp, mean, std)
    ref = jquant.calibrate(jparams, tiles, jhp, variant)
    got = quant.calibrate(state, tiles, hp, variant, chunk=24)
    assert set(got["kernels"]) == set(ref["kernels"])
    for site, qk in ref["kernels"].items():
        ours = got["kernels"][site]
        np.testing.assert_allclose(got["scales"][site].numpy(),
                                   np.asarray(ref["scales"][site]),
                                   rtol=1e-5)
        w8 = np.transpose(np.asarray(qk["w8"]), (3, 2, 0, 1)).astype(int)
        d = np.abs(ours["w8"].numpy().astype(int) - w8)
        assert d.max() <= 1 and (d > 0).mean() <= 0.001, (site, d.max())
        np.testing.assert_allclose(ours["w_scale"].numpy(),
                                   np.asarray(qk["w_scale"]), rtol=1e-5)
        pixels = tiles.shape[0] * (hp.im_size
                                   >> quant.site_level(site, hp)) ** 2
        unit = 127 * np.asarray(qk["w_scale"]) / pixels
        apart = np.abs(ours["bias"].numpy() - np.asarray(qk["bias"])) / unit
        assert apart.max() <= 32, (site, apart.max())


def test_calibrate_without_bias_and_percentile_knob():
    jhp, jparams, hp, state, variant, mean, std = _net("legacy")
    tiles = quant.sample_tiles(_plane((200, 200), 10) / 65535.0, hp, mean,
                               std, n=16)
    for pct in (99.0, 100.0):
        ref = jquant.calibrate(jparams, tiles, jhp, variant, percentile=pct,
                               bias_correct=False)
        got = quant.calibrate(state, tiles, hp, variant, percentile=pct,
                              bias_correct=False)
        for site in ref["scales"]:
            assert "bias" not in got["kernels"][site]
            # at the 99th percentile the interpolation weights a small
            # channel's float32 differences more: measured 3.5e-5 of a
            # 1.4e-4 scale, 5e-9 absolute
            a = np.asarray(ref["scales"][site])
            np.testing.assert_allclose(got["scales"][site].numpy(), a,
                                       rtol=1e-5, atol=1e-5 * a.max())


# -- the engines with one pinned QuantState ------------------------------------

_ENGINES = {}


def _pinned_engines(net, glue, kind="whole"):
    """(JAX engine, port engine) in the int8 mode with one JAX QuantState
    pinned into both; ``glue``: the port's compute dtype."""
    key = (net, glue, kind)
    if key not in _ENGINES:
        jhp, jparams, hp, state, variant, mean, std = _net(net)
        jdt = None if glue is None else jnp.bfloat16
        if kind == "whole":
            j = JaxEngine(jhp, jparams, variant, mean, std, compute_dtype=jdt,
                          quantized=True)
            p = InferenceEngine(hp, state, variant, mean, std,
                                compute_dtype=glue, quantized=True,
                                device="cpu")
        else:
            j = JaxStream(jhp, jparams, variant, mean, std,
                          compute_dtype=jdt, quantized=True,
                          stripe_tile_rows=2)
            p = StreamingEngine(hp, state, variant, mean, std,
                                compute_dtype=glue, quantized=True,
                                stripe_tile_rows=2, device="cpu")
        tiles = jquant.sample_tiles(_plane((300, 260), 11) / 65535.0, jhp,
                                    mean, std)
        if net == "duo":
            tiles = jquant.sample_tiles(np.stack([
                _plane((300, 260), 11), _plane((300, 260), 12, top=12000)])
                / 65535.0, jhp, mean, std)
        j._quant = jquant.calibrate(jparams, tiles, jhp, variant)
        p._quant = _port_state(j._quant)
        _ENGINES[key] = (j, p)
    return _ENGINES[key]


@pytest.mark.parametrize("net,glue,kw", [
    ("demo", None, {}),
    ("demo", None, {"in_range": (900, 31000)}),
    ("demo", None, {"scaling_factor": 0.5}),
    ("legacy", None, {"outlier": 99.0}),
    ("demo", torch.bfloat16, {}),
    ("legacy", torch.bfloat16, {}),
], ids=["demo-f32", "demo-f32-in_range", "demo-f32-scale0.5",
        "legacy-f32-outlier", "demo-bf16", "legacy-bf16"])
def test_int8_slide_matches_jax(net, glue, kw):
    jax_engine, port = _pinned_engines(net, glue)
    raw = _plane((150, 130), 13)
    _assert_maps(port.infer_slide(raw, **kw), jax_engine.infer_slide(raw,
                                                                      **kw),
                 glue)


def test_int8_host_float_path_matches_jax():
    jax_engine, port = _pinned_engines("demo", None)
    img = _plane((150, 130), 14).astype(np.float32) / 65535
    got, ref = port.infer(img), jax_engine.infer(img)
    assert np.abs(got - ref).max() < 2.0 / 255, np.abs(got - ref).max()


def test_int8_stack_matches_jax():
    jax_engine, port = _pinned_engines("duo", None)
    planes = [_plane((130, 150), 15), _plane((130, 150), 16, top=12000)]
    _assert_maps(port.infer_slide_stack(planes),
                 jax_engine.infer_slide_stack(planes), None)


def test_int8_streams_match_jax_and_whole():
    """The stream, its sharded form on three CPU ranks and the stack
    stream, each against JAX's stream on one pinned state; the stream
    against the port's whole engine on it."""
    js, ts = _pinned_engines("demo", None, "stream")
    raw = _plane((170, 150), 17)
    got = ts.infer(raw)
    _assert_maps(got, js.infer(raw), None)
    _assert_maps(ts.infer_sharded(raw, make_mesh(devices=["cpu"] * 3)),
                 got, None)
    _, whole = _pinned_engines("demo", None)
    _assert_maps(whole.infer_slide(raw), got, None)
    js2, ts2 = _pinned_engines("duo", None, "stream")
    planes = [_plane((130, 150), 18), _plane((130, 150), 19, top=12000)]
    _assert_maps(ts2.infer_stack(planes), js2.infer_stack(planes), None)


def test_one_calibration_serves_the_engine():
    _, _, hp, state, variant, mean, std = _net("legacy")
    whole = InferenceEngine(hp, state, variant, mean, std, quantized=True,
                            device="cpu")
    stream = StreamingEngine(hp, state, variant, mean, std, quantized=True,
                             device="cpu")
    for call in (whole.infer_slide, stream.infer):
        call(_plane((90, 80), 20))
        q0 = call.__self__._quant
        assert q0 is not None
        call(_plane((70, 100), 21, top=9000))
        assert call.__self__._quant is q0
    # a float engine never calibrates
    plain = InferenceEngine(hp, state, variant, mean, std, device="cpu")
    plain.infer_slide(_plane((60, 60), 22))
    assert plain._quant is None


def test_quantized_forward_is_inference_only():
    _, _, hp, state = _seeded(NUCLEI_DAPI, "legacy")
    model = unet.UNet(hp, "legacy")
    model.load_state_dict(state)
    tiles = np.random.RandomState(23).randn(2, 32, 32, 1).astype(np.float32)
    qs = quant.to_device(quant.calibrate(state, tiles, hp, "legacy"), "cpu")
    x = torch.from_numpy(tiles).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="inference-only"):
        model.forward_nchw(x, train=True, quant=qs)
    assert model.forward_nchw(x, quant=qs).shape == (2, 3, 32, 32)


# -- operation counts --------------------------------------------------------------


@pytest.mark.parametrize("kw,variant", [
    (NUCLEI_DAPI, "legacy"), (dict(NUCLEI_DAPI, im_size=128), "legacy"),
    (NARROW_DUO, "v2"), (dict(NARROW_DUO, n_out0=36, im_size=128), "duo"),
    (dict(NUCLEI_DAPI, n_extra_convs=0, ks=4), "legacy"),
])
def test_flops_match_jax(kw, variant):
    jhp, hp = JaxHParams(**kw), HParams(**kw)
    for fused in (True, False):
        assert flops.unet_flops_per_tile(hp, variant, fused) == \
            jflops.unet_flops_per_tile(jhp, variant, fused)
    assert flops.slide_flops(hp, 1000, 777, variant) == \
        jflops.slide_flops(jhp, 1000, 777, variant)
    sites = flops.quant_site_ops(hp, variant)
    assert 0 < sum(sites.values()) < flops.unet_flops_per_tile(hp, variant)


def test_int8_site_ops_at_published_widths():
    """The int8 sites' share of a tile (counted by hand: nucleiDAPI's
    ``up0.k2`` is a 5 x 5 conv from 1 + 16 to 16 channels at 128^2)."""
    legacy = HParams(**FULL["nucleiDAPI"][0])
    sites = flops.quant_site_ops(legacy, "legacy")
    assert sites["up0.k2"] == 2 * 128 ** 2 * 25 * 17 * 16
    assert sum(sites.values()) == 1_380_450_304
    duo = flops.quant_site_ops(HParams(**FULL["nucleiDAPILAMIN"][0]), "duo")
    assert duo["bottom"] == 2 * 4 ** 2 * 9 * 576 * 1152
    assert sum(duo.values()) == 3_652_190_208


def test_tile_bytes_counts_the_int8_buffers():
    hp = HParams(**dict(NUCLEI_DAPI, im_size=128))
    assert tile_bytes(hp, quantized=True) > tile_bytes(hp)
