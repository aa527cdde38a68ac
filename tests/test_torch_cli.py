"""Port CLI (unmicst_tpu_torch.cli) against unmicst_tpu.cli, the port's
import rule, and the rule that entry points never fall back to the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from unmicst_tpu import cli as jax_cli
from unmicst_tpu.io.tiff import TiffWriter, num_pages
from unmicst_tpu.io.tiff import imread as jax_imread
from unmicst_tpu_torch import cli
from unmicst_tpu_torch.io import tiff as port_tiff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")


def _blob_slide(rng, h=200, w=160):
    """The tests/test_demo_model.py recipe."""
    img = rng.rand(h, w).astype(np.float32) * 0.15
    rr, cc = np.ogrid[:h, :w]
    for _ in range(8):
        r, c = rng.randint(20, h - 20), rng.randint(20, w - 20)
        rad = rng.randint(5, 9)
        d2 = (rr - r) ** 2 + (cc - c) ** 2
        img[d2 < rad**2] = 0.7
        img[(d2 < (rad + 2) ** 2) & (d2 >= rad**2)] = 0.4
    return img


def _source(tmp_path):
    img = _blob_slide(np.random.RandomState(42))
    src = tmp_path / "s" / "registration" / "blobs.tif"
    src.parent.mkdir(parents=True)
    with TiffWriter(str(src), bigtiff=False) as tw:
        tw.write((np.clip(img, 0, 1) * 65535).astype(np.uint16))
    return img, str(src)


def _outputs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("tool,extra", [
    ("unmicst-solo", ["--stackOutput"]),
    ("unmicst-solo", []),
    ("unmicst-legacy", ["--stackOutput", "--outlier", "99.5"]),
    ("unmicst-legacy", ["--intensityRange", "1000,40000",
                        "--compressOutput", "--precision", "highest"]),
    ("UnMicstCyto2", ["--classOrder", "3", "2", "1"]),
])
def test_cli_pages_match_jax_cli(tmp_path, tool, extra):
    """The blobDemo recipe through both CLIs: the same files, page for
    page within 1 uint8 level; the tool decides naming and rescale."""
    img, src = _source(tmp_path)
    common = [src, "--tool", tool, "--model", "blobDemo", "--modelRoot",
              MODELS, *extra]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main(common + ["--outputPath", out_j]) == 0
    assert cli.main(common + ["--outputPath", out_t], device="cpu") == 0
    files = _outputs(out_j)
    assert files and files == _outputs(out_t)
    for rel in files:
        a, b = os.path.join(out_j, rel), os.path.join(out_t, rel)
        assert num_pages(a) == num_pages(b)
        for page in range(num_pages(a)):
            pa = jax_imread(a, page)
            pb = port_tiff.imread(b, page)  # the port's own reader
            assert pa.dtype == pb.dtype == np.uint8 and pa.shape == pb.shape
            assert np.abs(pa.astype(int) - pb.astype(int)).max() <= 1, rel
    if tool == "unmicst-solo" and extra:
        nuclei = port_tiff.imread(
            os.path.join(out_t, "blobs_Probabilities_1.tif"), 0) / 255
        assert nuclei[img > 0.6].mean() > 0.8
        assert nuclei[img < 0.2].mean() < 0.3


_OME = (
    '<?xml version="1.0"?><OME xmlns="http://www.openmicroscopy.org/Schemas/'
    'OME/2016-06"><Image ID="Image:0"><Pixels ID="Pixels:0" '
    'DimensionOrder="XYCZT" Type="uint16" SizeX="160" SizeY="200" SizeC="2" '
    'SizeZ="1" SizeT="1"><Channel ID="Channel:0:0" Name="DNA"/>'
    '<Channel ID="Channel:0:1" Name="Lamin"/></Pixels></Image></OME>'
)


def test_cli_ome_channel_name_matches_jax_cli(tmp_path):
    """An OME-TIFF read through the port's reader, the channel picked by
    its OME name (case-folded), against the JAX CLI on the same file."""
    img = _blob_slide(np.random.RandomState(7))
    src = tmp_path / "s" / "registration" / "stack.ome.tif"
    src.parent.mkdir(parents=True)
    noise = np.random.RandomState(8).randint(0, 9000, img.shape)
    with port_tiff.TiffWriter(str(src), bigtiff=True) as tw:
        tw.write(noise.astype(np.uint16), description=_OME)
        tw.write((np.clip(img, 0, 1) * 65535).astype(np.uint16))
    common = [str(src), "--tool", "unmicst-legacy", "--model", "blobDemo",
              "--modelRoot", MODELS, "--channelName", "lamin",
              "--stackOutput"]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main(common + ["--outputPath", out_j]) == 0
    assert cli.main(common + ["--outputPath", out_t], device="cpu") == 0
    prob = "stack_Probabilities_2.tif"
    assert _outputs(out_t) == _outputs(out_j)
    for page in range(3):
        a = jax_imread(os.path.join(out_j, prob), page).astype(int)
        b = port_tiff.imread(os.path.join(out_t, prob), page).astype(int)
        assert np.abs(a - b).max() <= 1
    with pytest.raises(SystemExit, match="no channel named"):
        cli.main(common[:-3] + ["--channelName", "CD3", "--outputPath",
                                out_t], device="cpu")


@pytest.mark.parametrize("flags,item", [
    (["--precision", "int8"], "M11"),
    (["--engine", "streaming", "--precision", "int8"], "M11"),
    (["--pyramidOutput"], "M14"),
])
def test_cli_unported_paths_fail_loudly(tmp_path, flags, item):
    _, src = _source(tmp_path)
    with pytest.raises(SystemExit, match=item):
        cli.main([src, "--model", "blobDemo", "--modelRoot", MODELS,
                  "--outputPath", str(tmp_path / "o"), *flags], device="cpu")


@pytest.mark.parametrize("flag", ["--calibrationPercentile", "--trace",
                                  "--check-numerics", "--listModels",
                                  "--fetchModels"])
def test_cli_takes_every_jax_flag(tmp_path, capsys, flag):
    """Each flag the JAX parser has and the port's lacked: it runs, or it
    refuses with a reason (never argparse's "unrecognized arguments")."""
    _, src = _source(tmp_path)
    out = str(tmp_path / "o")
    common = [src, "--model", "blobDemo", "--modelRoot", MODELS,
              "--outputPath", out, "--stackOutput"]
    if flag == "--calibrationPercentile":
        # it matters only under --precision int8, as in JAX
        assert cli.main(common + [flag, "99.9"], device="cpu") == 0
        with pytest.raises(SystemExit, match="M11"):
            cli.main(common + [flag, "99.9", "--precision", "int8"],
                     device="cpu")
    elif flag == "--trace":
        trace_dir = tmp_path / "trace"
        assert cli.main(common + [flag, str(trace_dir)], device="cpu") == 0
        (path,) = trace_dir.iterdir()
        with open(path) as f:
            assert "traceEvents" in json.load(f)
    elif flag == "--check-numerics":
        assert cli.main(common + [flag], device="cpu") == 0
        assert num_pages(os.path.join(out, "blobs_Probabilities_1.tif")) == 3
    elif flag == "--listModels":
        assert cli.main([flag, "--modelRoot", MODELS]) == 0
        assert "blobDemo: ready (local)" in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit, match="download") as e:
            cli.main([flag, "nucleiDAPI", "--modelRoot", MODELS])
        assert e.value.code not in (0, None)
    with pytest.raises(SystemExit, match="imagePath is required"):
        cli.main(["--model", "blobDemo"], device="cpu")


_IMPORT_ALL = """
import importlib, pkgutil, sys
import unmicst_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    unmicst_tpu_torch.__path__, "unmicst_tpu_torch.")
    if not m.name.endswith("__main__")]
for n in names:
    importlib.import_module(n)
banned = ("jax", "jaxlib", "flax", "ml_dtypes", "PIL", "unmicst_tpu",
          "exhibits", "scripts", "msgpack", "scipy")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(len(names), leaked)
sys.exit(1 if leaked or len(names) < 31 else 0)
"""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cli_needs_a_card_unless_cpu_is_asked_for(tmp_path, monkeypatch):
    import torch

    _, src = _source(tmp_path)
    argv = [src, "--model", "blobDemo", "--modelRoot", MODELS,
            "--outputPath", str(tmp_path / "o")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    assert not os.path.exists(tmp_path / "o")


def test_module_entry_point_needs_a_card(tmp_path):
    """``python -m unmicst_tpu_torch`` on a machine without a GPU fails and
    writes nothing."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry point would run on it")
    _, src = _source(tmp_path)
    r = subprocess.run(
        [sys.executable, "-m", "unmicst_tpu_torch", src, "--model",
         "blobDemo", "--modelRoot", MODELS, "--outputPath",
         str(tmp_path / "o")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not os.path.exists(tmp_path / "o")
