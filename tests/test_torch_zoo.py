"""The port's zoo registry (``unmicst_tpu_torch.models.zoo``) and
``--listModels`` against the JAX package's."""

import dataclasses
import os
import shutil

import pytest

from unmicst_tpu import cli as jax_cli
from unmicst_tpu.models import zoo as jax_zoo
from unmicst_tpu_torch import cli
from unmicst_tpu_torch.models import zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")


def test_zoo_entries_equal_jax():
    assert list(zoo.ZOO) == list(jax_zoo.ZOO)
    for name, entry in zoo.ZOO.items():
        assert dataclasses.asdict(entry) == dataclasses.asdict(
            jax_zoo.ZOO[name]), name


def _root_with_a_missing_blob(tmp_path):
    """blobDemo, a zoo entry with its sidecars but no data blob, a ready
    zoo entry, and a directory that is no model."""
    root = tmp_path / "zoo"
    shutil.copytree(os.path.join(MODELS, "blobDemo"), root / "blobDemo")
    shutil.copytree(os.path.join(MODELS, "blobDemo"), root / "nucleiDAPI")
    blobless = root / "nucleiDAPILAMIN"
    blobless.mkdir()
    for f in ("hp.data", "model.ckpt.index"):
        shutil.copy(os.path.join(MODELS, "blobDemo", f), blobless / f)
    (root / "notes").mkdir()
    return str(root)


@pytest.mark.parametrize("where", ["models", "temporary"])
def test_available_models_equal_jax(tmp_path, where):
    root = MODELS if where == "models" else _root_with_a_missing_blob(tmp_path)
    got = zoo.available_models(root)
    assert got == jax_zoo.available_models(root)
    if where == "temporary":
        assert got["nucleiDAPILAMIN"].startswith("needs-blob (https://")
        assert got["nucleiDAPI"] == "ready"
        assert got["blobDemo"] == "ready (local)"


def test_a_msgpack_only_dir_is_not_called_ready(tmp_path):
    """The port reads TF1 bundles only: a dir holding just the JAX
    package's msgpack is listed as such, not as ready."""
    d = tmp_path / "CytoplasmIncell"
    d.mkdir()
    shutil.copy(os.path.join(MODELS, "blobDemo", "model.unmicst-tpu.msgpack"),
                d)
    assert zoo.available_models(str(tmp_path))["CytoplasmIncell"] == (
        zoo.MSGPACK_ONLY)


def test_list_models_prints_what_jax_prints(tmp_path, capsys):
    root = _root_with_a_missing_blob(tmp_path)
    assert jax_cli.main(["--listModels", "--modelRoot", root]) == 0
    want = capsys.readouterr().out
    assert cli.main(["--listModels", "--modelRoot", root]) == 0
    assert capsys.readouterr().out == want
    with pytest.raises(SystemExit, match="no such model root"):
        cli.main(["--listModels", "--modelRoot", str(tmp_path / "none")])
