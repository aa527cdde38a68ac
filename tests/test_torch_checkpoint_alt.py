"""A model directory whose only restorable TF1 bundle is not ``model.ckpt``
(the zoo's ``mousenucleiDAPI``: bundle ``nuclei20x2bin1chan``, 16 wide,
beside an ``hp.data`` that says nOut0 20).  Both packages rebuild the
hyper-parameters from the bundle's shapes and write them back to
``bundle.hp``; the port is held to the JAX package on the derived
``HParams``, the params and the CLI's pages."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from unmicst_tpu import cli as jax_cli
from unmicst_tpu.core import checkpoint as jax_ckpt
from unmicst_tpu.core import hp as jax_hp
from unmicst_tpu.core.tf1_ckpt import TF1Checkpoint as JaxTF1Checkpoint
from unmicst_tpu.io.tiff import imread as jax_imread
from unmicst_tpu.io.tiff import num_pages
from unmicst_tpu_torch import cli
from unmicst_tpu_torch.core import checkpoint
from unmicst_tpu_torch.core.hp import HParams, load_model_dir, save_pickle
from unmicst_tpu_torch.core.tf1_ckpt import TF1Checkpoint
from unmicst_tpu_torch.core.unet import UNet
from unmicst_tpu_torch.io.tiff import TiffWriter
from unmicst_tpu_torch.io.tiff import imread as port_imread

BUNDLE = "nuclei20x2bin1chan"
# the bundle's real widths; hp.data claims n_out0 20
WIDE16 = HParams(im_size=64, n_channels=1, n_classes=3, n_out0=16, ks=3,
                 n_layers=2, n_extra_convs=1, batch_size=16)


def _seeded_state(hp, seed=3):
    """He-scaled kernels and plausible BN statistics (the maps are not
    flat, as they are under the reference's 0.03 initializer)."""
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, p in UNet(hp, "legacy").state_dict().items():
        if name.endswith(("gamma", "moving_variance")):
            v = 0.5 + torch.rand(p.shape, generator=g)
        elif name.endswith(("beta", "moving_mean")):
            v = 0.1 * torch.randn(p.shape, generator=g)
        else:
            v = torch.randn(p.shape, generator=g) * (2.0 / p[0].numel()) ** 0.5
        state[name] = v
    return state


@pytest.fixture(scope="module")
def model_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo")
    d = root / "mousenucleiDAPI"
    d.mkdir()
    state = _seeded_state(WIDE16)
    checkpoint.save_tf1_params(str(d / BUNDLE), state, WIDE16, "legacy")
    stale = dataclasses.replace(WIDE16, n_out0=20)
    save_pickle(stale.to_ref_dict(), str(d / "hp.data"))
    save_pickle(0.2, str(d / "datasetMean.data"))
    save_pickle(0.15, str(d / "datasetStDev.data"))
    return str(root), state


def jax_ckpt_tree(params):
    """The JAX params tree with numpy leaves."""
    if isinstance(params, dict):
        return {k: jax_ckpt_tree(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [jax_ckpt_tree(v) for v in params]
    return np.asarray(params)


def test_alternate_bundle_loads_under_its_own_hparams(model_root):
    root, state = model_root
    d = os.path.join(root, "mousenucleiDAPI")
    ours = load_model_dir(d)
    theirs = jax_hp.load_model_dir(d)
    assert ours.hp.n_out0 == theirs.hp.n_out0 == 20  # what hp.data says
    got = checkpoint.load_params_for_bundle(ours)
    want = jax_ckpt.load_params_for_bundle(theirs)
    # both rewrote bundle.hp from the bundle's shapes, to the same HParams
    assert ours.hp == WIDE16
    assert dataclasses.asdict(ours.hp) == dataclasses.asdict(theirs.hp)
    assert (checkpoint.hp_from_tf1(os.path.join(d, BUNDLE), "legacy")
            == dataclasses.replace(WIDE16, im_size=128))
    ref = checkpoint.params_from_jax(
        jax_ckpt_tree(want), ours.hp, "legacy")
    assert sorted(got) == sorted(ref) == sorted(state)
    for k in got:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)
        torch.testing.assert_close(got[k], state[k].float(), rtol=0, atol=0)


def test_tf1_checkpoint_has_tensor_and_get_shape(model_root):
    """The index answers both without decoding a tensor, as JAX's does."""
    root, _ = model_root
    prefix = os.path.join(root, "mousenucleiDAPI", BUNDLE)
    ours, theirs = TF1Checkpoint(prefix), JaxTF1Checkpoint(prefix)
    assert ours.keys() == theirs.keys()
    for name in ours.keys():
        assert ours.has_tensor(name) and theirs.has_tensor(name)
        assert tuple(ours.get_shape(name)) == tuple(theirs.get_shape(name))
        assert (tuple(ours.get_shape(name))
                == ours.get_tensor(name).shape)
    for name in ("lt/kernel2", "downsampling/ld2/kernel1", ""):
        assert not ours.has_tensor(name) and not theirs.has_tensor(name)
    assert ours.get_shape("downsampling/ld0/kernel1") == (3, 3, 1, 16)


def test_cli_runs_the_alternate_bundle_like_the_jax_cli(model_root,
                                                        tmp_path):
    """The CLI's pages on a small slide within 1 uint8 level of the JAX
    CLI's (the port used to refuse the directory on its widths)."""
    root, _ = model_root
    rng = np.random.RandomState(11)
    src = str(tmp_path / "m.tif")
    with TiffWriter(src, bigtiff=False) as tw:
        tw.write((rng.rand(160, 144) * 60000).astype(np.uint16))
    common = [src, "--tool", "unmicst-legacy", "--model", "mousenucleiDAPI",
              "--modelRoot", root, "--stackOutput"]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main(common + ["--outputPath", out_j]) == 0
    assert cli.main(common + ["--outputPath", out_t], device="cpu") == 0
    name = "m_Probabilities_1.tif"
    a, b = os.path.join(out_j, name), os.path.join(out_t, name)
    assert num_pages(a) == num_pages(b) == 3
    for k in range(3):
        pa, pb = jax_imread(a, k).astype(int), port_imread(b, k).astype(int)
        assert pa.shape == pb.shape == (160, 144)
        assert np.abs(pa - pb).max() <= 1
    assert pb.std() > 0  # the maps are not flat
