"""Port multi-rank runtime against the JAX package on the CPU.

``unmicst_tpu_torch.runtime.halo.spatial_infer`` (every seam
implementation) against JAX ``spatial_infer`` on the 8-device CPU mesh and
against the port's single-device ``InferenceEngine.infer``; the ring shift
(K3, K4a/K4b) in its plain versions against the Pallas ``ring_shift`` in
interpret mode; K2's fold-only entry against ``tiler.fold``.  The port's
ranks share the CPU (``make_mesh(devices=["cpu"] * n)``), where the
kernels take their plain versions; tests/test_torch_cuda.py holds the
kernels against those on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmicst_tpu.core import tiler as jt
from unmicst_tpu.core import unet as junet
from unmicst_tpu.core.hp import HParams as JaxHParams
from unmicst_tpu.runtime import halo as jhalo
from unmicst_tpu.runtime.mesh import make_mesh as jax_mesh
from unmicst_tpu_torch import kernels
from unmicst_tpu_torch.core import tiler as tt
from unmicst_tpu_torch.core.checkpoint import params_from_jax
from unmicst_tpu_torch.core.hp import HParams
from unmicst_tpu_torch.infer import InferenceEngine
from unmicst_tpu_torch.runtime import halo
from unmicst_tpu_torch.runtime.mesh import Mesh, make_mesh

# the nets of tests/test_parallel.py and tests/test_kernels.py:119-142.  The
# latter draws its weights at std_dev0 0.5 ("kernels_jax"), which saturates
# the maps to 0 and 1: there the port's single-device engine already sits
# 7.5e-5 .. 8.8e-5 from JAX's (summation-order ulps amplified by the net),
# so test_spatial_infer_on_the_jax_kernels_net holds the halo against that
# gap.  "kernels" is the same net at 0.25, where the two frameworks agree
# to 1.1e-6 and the halo is held against JAX at 2e-5 outright.
_KERNELS_NET = dict(im_size=32, n_channels=1, n_classes=3, n_out0=6, ks=3,
                    n_extra_convs=0, n_layers=2, batch_size=8)
_NETS = {
    "parallel": (dict(im_size=32, n_channels=1, n_classes=3, n_out0=4, ks=3,
                      n_extra_convs=0, n_layers=2, batch_size=8), 3),
    "kernels": (dict(_KERNELS_NET, std_dev0=0.25), 3),
    "kernels_jax": (dict(_KERNELS_NET, std_dev0=0.5), 3),
}
_MODELS = {}


def _model(name):
    """(JAX hp, JAX params, port hp, port state) of one test net."""
    if name not in _MODELS:
        kw, seed = _NETS[name]
        jhp = JaxHParams(**kw)
        params = junet.init_params(jax.random.PRNGKey(seed), jhp, "legacy")
        hp = HParams(**kw)
        state = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                hp, "legacy")
        _MODELS[name] = (jhp, params, hp, state)
    return _MODELS[name]


# (net, ranks, shape, mean, std): tests/test_parallel.py:30-92 (the H
# multiples of sub, 144 on 2 and 168 on 4, caught a real bug in JAX; 20 x 40
# on 8 ranks has phantom bands) and tests/test_kernels.py:119-142 (400 rows:
# R = 3 tile rows per band; 150 rows on 8: R = 1)
_CASES = {
    "150x90-2": ("parallel", 2, (150, 90), 0.3, 0.2),
    "150x90-4": ("parallel", 4, (150, 90), 0.3, 0.2),
    "150x90-8": ("parallel", 8, (150, 90), 0.3, 0.2),
    "144x90-2": ("parallel", 2, (144, 90), 0.3, 0.2),
    "168x64-4": ("parallel", 4, (168, 64), 0.3, 0.2),
    "20x40-8": ("parallel", 8, (20, 40), 0.0, 1.0),
    "400x90-8-R3": ("kernels", 8, (400, 90), 0.3, 0.2),
    "150x90-8-R1": ("kernels", 8, (150, 90), 0.3, 0.2),
}
_REFS = {}


def _reference(case):
    """(image, JAX spatial_infer [H, W, K], port engine [K, H, W])."""
    if case not in _REFS:
        net, n, shape, mean, std = _CASES[case]
        jhp, params, hp, state = _model(net)
        image = np.random.RandomState(sum(shape) + n).rand(*shape)
        image = image.astype(np.float32)
        canvas = jhalo.build_canvas(image, jhp, n)
        mesh = jax_mesh(data=n, model=1)
        fn = jax.jit(lambda p, c: jhalo.spatial_infer(
            p, c, shape[0], shape[1], jhp, "legacy", mesh, mean=mean,
            std=std))
        ref = np.asarray(fn(params, jnp.asarray(canvas)))
        single = InferenceEngine(hp, state, "legacy", mean, std,
                                 device="cpu").infer(image)
        _REFS[case] = (image, ref, single)
    return _REFS[case]


@pytest.mark.parametrize("impl", halo.HALO_IMPLS)
@pytest.mark.parametrize("case", list(_CASES))
def test_spatial_infer_matches_jax_and_single_device(case, impl):
    net, n, shape, mean, std = _CASES[case]
    _, _, hp, state = _model(net)
    image, ref, single = _reference(case)
    mesh = make_mesh(devices=["cpu"] * n)
    got = halo.spatial_infer(
        state, halo.build_canvas(image, hp, n), shape[0], shape[1], hp,
        "legacy", mesh, mean=mean, std=std, halo_impl=impl,
    )
    assert got.shape == (shape[0], shape[1], 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), -1, 0), single,
                               atol=2e-5)


_JAX_NET_CASES = {"400x90-8-R3": (8, (400, 90)), "150x90-8-R1": (8, (150, 90))}
_JAX_NET_REFS = {}


def _jax_net_reference(case):
    """On the std_dev0 0.5 net: (image, JAX spatial_infer [H, W, K], JAX
    engine [K, H, W], port engine [K, H, W], port ppermute [H, W, K])."""
    from unmicst_tpu.infer import InferenceEngine as JaxEngine

    if case not in _JAX_NET_REFS:
        n, shape = _JAX_NET_CASES[case]
        jhp, params, hp, state = _model("kernels_jax")
        image = np.random.RandomState(sum(shape) + n).rand(*shape)
        image = image.astype(np.float32)
        mesh = jax_mesh(data=n, model=1)
        fn = jax.jit(lambda p, c: jhalo.spatial_infer(
            p, c, shape[0], shape[1], jhp, "legacy", mesh, mean=0.3, std=0.2))
        ref = np.asarray(fn(params, jnp.asarray(
            jhalo.build_canvas(image, jhp, n))))
        jax_single = np.asarray(JaxEngine(jhp, params, "legacy", 0.3,
                                          0.2).infer(image))
        single = InferenceEngine(hp, state, "legacy", 0.3, 0.2,
                                 device="cpu").infer(image)
        ppermute = halo.spatial_infer(
            state, halo.build_canvas(image, hp, n), shape[0], shape[1], hp,
            "legacy", make_mesh(devices=["cpu"] * n), mean=0.3, std=0.2)
        _JAX_NET_REFS[case] = (image, ref, jax_single, single,
                               ppermute.numpy())
    return _JAX_NET_REFS[case]


@pytest.mark.parametrize("impl", halo.HALO_IMPLS)
@pytest.mark.parametrize("case", list(_JAX_NET_CASES))
def test_spatial_infer_on_the_jax_kernels_net(case, impl):
    """tests/test_kernels.py:119-142 on its own net (std_dev0 0.5): every
    seam implementation within 1e-6 of the port's ppermute, as JAX holds
    its own; within 2e-5 of the port's single-device engine; and within
    2e-5 of JAX's spatial_infer beyond the gap between the two frameworks'
    single-device engines, which this test measures (7.5e-5 .. 8.8e-5 on
    the CPU) and bounds at 1e-4."""
    n, shape = _JAX_NET_CASES[case]
    _, _, hp, state = _model("kernels_jax")
    image, ref, jax_single, single, ppermute = _jax_net_reference(case)
    got = halo.spatial_infer(
        state, halo.build_canvas(image, hp, n), shape[0], shape[1], hp,
        "legacy", make_mesh(devices=["cpu"] * n), mean=0.3, std=0.2,
        halo_impl=impl).numpy()
    np.testing.assert_allclose(got, ppermute, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(np.moveaxis(got, -1, 0), single, atol=2e-5)
    gap = float(np.abs(single - jax_single).max())
    print(f"{case} {impl}: port engine vs JAX engine {gap:.3e}, port halo "
          f"vs JAX halo {np.abs(got - ref).max():.3e}")
    assert gap <= 1e-4, gap
    np.testing.assert_allclose(got, ref, atol=gap + 2e-5)


def _jax_ring(x, shift):
    from jax import shard_map
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as P

    from unmicst_tpu.kernels.halo_rdma import ring_shift

    mesh = JaxMesh(np.array(jax.devices()[:8]), ("d",))
    return np.asarray(shard_map(
        lambda b: ring_shift(b, "d", shift, interpret=True),
        mesh=mesh, in_specs=P("d", None, None),
        out_specs=P("d", None, None), check_vma=False,
    )(jnp.asarray(x)))


@pytest.mark.parametrize("shift", [1, -1])
def test_ring_shift_matches_pallas_ring_shift(shift):
    """Plain K3 and the K4a/K4b pair == the Pallas kernel in interpret
    mode on the 8-device mesh (as tests/test_kernels.py:72-93): exact."""
    x = np.arange(8 * 16 * 128, dtype=np.float32).reshape(8, 16, 128)
    ref = _jax_ring(x, shift)
    xs = [torch.from_numpy(x[i : i + 1].copy()) for i in range(8)]
    for got in (kernels.ring_shift_plain(xs, shift),
                kernels.ring_shift(xs, shift),
                kernels.ring_shift_wait(kernels.ring_shift_start(xs, shift))):
        np.testing.assert_array_equal(torch.cat(got).numpy(), ref)
        assert all(g.data_ptr() != x_.data_ptr() for g, x_ in zip(got, xs))
    # the plain versions are not counted
    assert kernels.ring_shift.launches == 0
    assert kernels.ring_shift_start.launches == 0
    assert kernels.ring_shift_wait.launches == 0


def test_ring_shift_checks_its_ring():
    a, b = torch.zeros(4, 3), torch.zeros(4, 3)
    with pytest.raises(ValueError, match="differ"):
        kernels.ring_shift([a, torch.zeros(4, 2)], 1)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.ring_shift([a.t(), b.t()], 1)
    with pytest.raises(ValueError, match="hop kind"):
        kernels.ring_shift([a, b], 1, kind="sideways")
    with pytest.raises(ValueError, match="at least one"):
        kernels.ring_shift([], 1)
    one = kernels.ring_shift([torch.ones(2, 2)], -1)  # a ring of one
    assert one[0].tolist() == [[1.0, 1.0], [1.0, 1.0]]


def test_fold_strip_plain_matches_jax_fold():
    """K2's fold-only entry (plain version) == the JAX ``tiler.fold`` of
    K1-weighted tiles, and the stride-0 window gives ``count_map``."""
    rng = np.random.RandomState(5)
    for shape, patch, margin in [((100, 120), 64, 8), ((40, 56), 32, 4)]:
        g = tt.make_grid(shape[0], shape[1], patch, margin)
        jg = jt.make_grid(shape[0], shape[1], patch, margin)
        w = rng.rand(g.num_tiles, 3, patch, patch).astype(np.float32)
        ref = np.asarray(jt.fold(jnp.asarray(
            w.reshape(g.npr, g.npc, 3, patch, patch).transpose(0, 1, 3, 4, 2)),
            jg))
        got = kernels.blend_fold_strip(torch.from_numpy(w), g)
        assert got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
        win = tt.ramp_window(patch, margin)
        count = halo.count_map(g, torch.from_numpy(win))
        np.testing.assert_allclose(
            count.numpy(), np.asarray(jt.count_map(jg, win)), atol=1e-6)
    assert kernels.blend_fold_strip.launches == 0


def test_build_canvas_matches_jax_and_validates_channels():
    """As tests/test_parallel.py:200-220, and the same canvas as JAX."""
    kw = dict(im_size=32, n_channels=3, n_classes=3, n_out0=4, ks=3,
              n_extra_convs=0, n_layers=2, batch_size=8)
    hp = HParams(**kw)
    for bad, mode in [((40, 40), "stack"), ((5, 40, 40), "stack"),
                      ((2, 40, 40), "broadcast"), ((1, 1, 40, 40),
                                                   "broadcast")]:
        with pytest.raises(ValueError):
            halo.build_canvas(np.zeros(bad, np.float32), hp, 2,
                              channel_mode=mode)
    got = halo.build_canvas(np.ones((3, 40, 40), np.float32), hp, 2,
                            channel_mode="stack")
    assert got.shape[-1] == 3 and got.max() == 1.0
    img = np.random.RandomState(0).rand(70, 50).astype(np.float32)
    np.testing.assert_array_equal(
        halo.build_canvas(img, hp, 4),
        jhalo.build_canvas(img, JaxHParams(**kw), 4))


def test_make_mesh_and_spatial_infer_arguments():
    mesh = make_mesh(devices=["cpu"] * 8)
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 8, "model": 1}
    assert make_mesh(data=4, devices=["cpu"] * 8).shape["data"] == 4
    with pytest.raises(ValueError, match="exceeds"):
        make_mesh(data=9, devices=["cpu"] * 8)
    tp = make_mesh(model=2, devices=["cpu"] * 8)
    assert tp.shape == {"data": 4, "model": 2}
    assert tp.rank_ids("data", 1) == (1, 3, 5, 7)
    assert tp.rank_ids("model", 2) == (4, 5)
    assert len(mesh.ranks("model")) == 1
    with pytest.raises(ValueError, match="axes"):
        mesh.ranks("rows")
    _, _, hp, state = _model("parallel")
    canvas = halo.build_canvas(np.zeros((50, 40), np.float32), hp, 2)
    mesh2 = make_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="halo_impl"):
        halo.spatial_infer(state, canvas, 50, 40, hp, "legacy", mesh2,
                           mean=0.0, std=1.0, halo_impl="pallas")
    with pytest.raises(ValueError, match="expected"):
        halo.spatial_infer(state, canvas, 50, 40, hp, "legacy", mesh,
                           mean=0.0, std=1.0)


def test_mesh_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
