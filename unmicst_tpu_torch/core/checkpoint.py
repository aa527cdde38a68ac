"""Checkpoint ingestion: TF1 tensor bundles and JAX params -> UNet state.

Two producers feed the same :class:`~unmicst_tpu_torch.core.unet.UNet`:

* :func:`load_tf1_params` reads a TF1 ``tf.train.Saver`` bundle under the
  reference's variable names (the schema of
  ``unmicst_tpu/core/checkpoint.py:60-120``, shape-validated);
* :func:`params_from_jax` converts the JAX package's params pytree, given
  as numpy arrays, so both frameworks can run the same weights.

Both return a ``state_dict`` for ``UNet.load_state_dict``.  Layouts:
HWIO conv kernels become OIHW; TF1/JAX transposed-conv kernels
``[ks, ks, out, in]`` become PyTorch's ``[in, out, ks, ks]``.
:func:`save_tf1_params` goes the other way: a state dict back to a TF1
bundle under the reference's names, in TF's layouts.

The JAX package's native msgpack format is not read here (no msgpack on
the GPU host); model directories load from their TF1 files.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from unmicst_tpu_torch.core.hp import HParams, ModelBundle
from unmicst_tpu_torch.core.tf1_ckpt import TF1Checkpoint, write_tf1_checkpoint
from unmicst_tpu_torch.core.unet import get_variant

State = Dict[str, torch.Tensor]

_BN_FIELDS = ("gamma", "beta", "moving_mean", "moving_variance")


def _bn_group(ck: TF1Checkpoint, scope: str) -> Dict[str, np.ndarray]:
    return {f: np.asarray(ck.get_tensor(f"{scope}/{f}")) for f in _BN_FIELDS}


def _read_tf1_tree(prefix: str, hp: HParams, variant: str) -> dict:
    """TF1 bundle -> the JAX-layout params tree (numpy, HWIO kernels)."""
    ck = TF1Checkpoint(prefix)
    legacy = get_variant(variant).legacy
    g = lambda name: np.asarray(ck.get_tensor(name))  # noqa: E731
    nx = hp.n_extra_convs
    params: dict = {"down": [], "up": []}
    for i in range(hp.n_layers):
        if legacy:
            params["down"].append({
                "kernel1": g(f"downsampling/ld{i}/kernel1"),
                "extra": [g(f"downsampling/ld{i}/kernelExtra{j}")
                          for j in range(nx)],
                "shortcut": g(f"downsampling/ld{i}/shortcutWeights"),
                "bn": _bn_group(
                    ck, "batch_normalization" + (f"_{i}" if i else "")
                ),
            })
        else:
            params["down"].append({
                "kernel1": g(f"downsampling/ld{i}/kernelD{i}"),
                "extra": [g(f"ld{i}/kernelExtra{j}") for j in range(nx)],
                "shortcut": g(f"ld{i}/shortcutWeights"),
                "bn": _bn_group(ck, f"ld{i}/batch_normalization"),
            })
    params["bottom"] = {"kernel1": g("lb/kernel1")}
    if not legacy:
        params["bottom"]["bn"] = _bn_group(ck, "conv")
    for i in range(hp.n_layers):
        if legacy:
            layer = {
                "kernel1": g(f"upsampling/lu{i}/kernel1"),
                "kernel2": g(f"upsampling/lu{i}/kernel2"),
                "extra": [g(f"upsampling/lu{i}/kernel2Extra{j}")
                          for j in range(nx)],
            }
        else:
            layer = {
                "kernel1": g(f"lu{i}/kernelU{i}"),
                "kernel2": g(f"lu{i}/kernel2"),
                "extra": [g(f"lu{i}/kernel2Extra{j}") for j in range(nx)],
                "bn": _bn_group(ck, f"lu{i}/conv2"),
            }
        params["up"].append(layer)
    params["top"] = {"kernel": g("lt/kernel")}
    if not legacy:
        params["top"]["bn"] = _bn_group(ck, "batch_normalization")
    return params


def _validate_shapes(params: dict, hp: HParams) -> None:
    """The checks of ``unmicst_tpu/core/checkpoint.py:124-160``."""
    widths, ks = hp.n_out_x, hp.ks
    for i, layer in enumerate(params["down"]):
        expect = (ks, ks, widths[i], widths[i + 1])
        got = tuple(layer["kernel1"].shape)
        if got != expect:
            raise ValueError(f"down[{i}].kernel1 shape {got} != {expect}")
        for j, ke in enumerate(layer["extra"]):
            expect = (ks, ks, widths[i + 1], widths[i + 1])
            if tuple(ke.shape) != expect:
                raise ValueError(
                    f"down[{i}].extra[{j}] shape {tuple(ke.shape)} != {expect}"
                )
        for name in _BN_FIELDS:
            if layer["bn"][name].shape != (widths[i + 1],):
                raise ValueError(
                    f"down[{i}].bn.{name} width "
                    f"{layer['bn'][name].shape} != ({widths[i + 1]},)"
                )
    for i, layer in enumerate(params["up"]):
        # transposed-conv kernel layout is [ks, ks, OUT, in]
        expect = (ks, ks, widths[i + 1], widths[i + 2])
        got = tuple(layer["kernel1"].shape)
        if got != expect:
            raise ValueError(f"up[{i}].kernel1 shape {got} != {expect}")
        expect = (ks, ks, widths[i] + widths[i + 1], widths[i + 1])
        got = tuple(layer["kernel2"].shape)
        if got != expect:
            raise ValueError(f"up[{i}].kernel2 shape {got} != {expect}")
    tk = tuple(params["top"]["kernel"].shape)
    if tk != (1, 1, widths[1], hp.n_classes):
        raise ValueError(
            f"top.kernel shape {tk} != (1, 1, {widths[1]}, {hp.n_classes})"
        )


def _oihw(k) -> torch.Tensor:
    """HWIO conv kernel -> OIHW.  The same permutation takes a
    ``[ks, ks, out, in]`` transposed-conv kernel to PyTorch's
    ``[in, out, ks, ks]``."""
    return torch.from_numpy(np.asarray(k, np.float32).transpose(3, 2, 0, 1).copy())


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.asarray(v, np.float32).copy())


def params_from_jax(params_np: dict, hp: HParams, variant: str) -> State:
    """JAX params pytree (numpy leaves, ``unet.init_params`` layout) ->
    ``UNet`` state dict."""
    _validate_shapes(params_np, hp)
    legacy = get_variant(variant).legacy
    state: State = {}

    def put_bn(prefix: str, bn: dict) -> None:
        for f in _BN_FIELDS:
            state[f"{prefix}.{f}"] = _vec(bn[f])

    for i, layer in enumerate(params_np["down"]):
        state[f"down.{i}.kernel1"] = _oihw(layer["kernel1"])
        for j, ke in enumerate(layer["extra"]):
            state[f"down.{i}.extra.{j}"] = _oihw(ke)
        state[f"down.{i}.shortcut"] = _oihw(layer["shortcut"])
        put_bn(f"down.{i}.bn", layer["bn"])
    state["bottom.kernel1"] = _oihw(params_np["bottom"]["kernel1"])
    if not legacy:
        put_bn("bottom.bn", params_np["bottom"]["bn"])
    for i, layer in enumerate(params_np["up"]):
        state[f"up.{i}.kernel1"] = _oihw(layer["kernel1"])
        state[f"up.{i}.kernel2"] = _oihw(layer["kernel2"])
        for j, ke in enumerate(layer["extra"]):
            state[f"up.{i}.extra.{j}"] = _oihw(ke)
        if not legacy:
            put_bn(f"up.{i}.bn", layer["bn"])
    state["top.kernel"] = _oihw(params_np["top"]["kernel"])
    if not legacy:
        put_bn("top.bn", params_np["top"]["bn"])
    return state


def load_tf1_params(prefix: str, hp: HParams, variant: str) -> State:
    """Read a TF1 checkpoint into a validated ``UNet`` state dict."""
    return params_from_jax(_read_tf1_tree(prefix, hp, variant), hp, variant)


def _hwio(t: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`_oihw`: OIHW (or ``[in, out, ks, ks]``) ->
    HWIO (or ``[ks, ks, out, in]``), float32 numpy."""
    return np.ascontiguousarray(
        t.detach().to("cpu", torch.float32).numpy().transpose(2, 3, 1, 0))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def save_tf1_params(prefix: str, state: State, hp: HParams, variant: str,
                    global_step: int = 0) -> None:
    """Write a ``UNet`` state dict as a TF1 tensor bundle under the
    reference's variable names, the inverse of :func:`load_tf1_params`
    (``unmicst_tpu/core/checkpoint.py:230-293``): kernels back in TF's
    HWIO (transposed: ``[ks, ks, out, in]``), BN statistics as vectors and
    the global step as the int32 ``Variable``.  The reference tool's
    ``Saver.restore`` reads the result (optimizer slots omitted)."""
    legacy = get_variant(variant).legacy
    nx = hp.n_extra_convs
    tensors: Dict[str, np.ndarray] = {}

    def put_bn(scope: str, prefix_: str) -> None:
        for f in _BN_FIELDS:
            tensors[f"{scope}/{f}"] = _np(state[f"{prefix_}.{f}"])

    for i in range(hp.n_layers):
        extra = [_hwio(state[f"down.{i}.extra.{j}"]) for j in range(nx)]
        if legacy:
            tensors[f"downsampling/ld{i}/kernel1"] = _hwio(
                state[f"down.{i}.kernel1"])
            for j, ke in enumerate(extra):
                tensors[f"downsampling/ld{i}/kernelExtra{j}"] = ke
            tensors[f"downsampling/ld{i}/shortcutWeights"] = _hwio(
                state[f"down.{i}.shortcut"])
            put_bn("batch_normalization" + (f"_{i}" if i else ""),
                   f"down.{i}.bn")
        else:
            tensors[f"downsampling/ld{i}/kernelD{i}"] = _hwio(
                state[f"down.{i}.kernel1"])
            for j, ke in enumerate(extra):
                tensors[f"ld{i}/kernelExtra{j}"] = ke
            tensors[f"ld{i}/shortcutWeights"] = _hwio(
                state[f"down.{i}.shortcut"])
            put_bn(f"ld{i}/batch_normalization", f"down.{i}.bn")
    tensors["lb/kernel1"] = _hwio(state["bottom.kernel1"])
    if not legacy:
        put_bn("conv", "bottom.bn")
    for i in range(hp.n_layers):
        k1, k2 = (_hwio(state[f"up.{i}.kernel{n}"]) for n in (1, 2))
        extra = [_hwio(state[f"up.{i}.extra.{j}"]) for j in range(nx)]
        if legacy:
            tensors[f"upsampling/lu{i}/kernel1"] = k1
            tensors[f"upsampling/lu{i}/kernel2"] = k2
            for j, ke in enumerate(extra):
                tensors[f"upsampling/lu{i}/kernel2Extra{j}"] = ke
        else:
            tensors[f"lu{i}/kernelU{i}"] = k1
            tensors[f"lu{i}/kernel2"] = k2
            for j, ke in enumerate(extra):
                tensors[f"lu{i}/kernel2Extra{j}"] = ke
            put_bn(f"lu{i}/conv2", f"up.{i}.bn")
    tensors["lt/kernel"] = _hwio(state["top.kernel"])
    if not legacy:
        put_bn("batch_normalization", "top.bn")
    # the schedule position (the reference's exponential_decay reads it)
    tensors["Variable"] = np.asarray(global_step, np.int32)
    write_tf1_checkpoint(prefix, tensors)


def _find_ckpt_prefix(model_dir: str) -> Optional[str]:
    """A restorable tensor bundle in a model dir: ``model.ckpt`` first,
    then any other ``<prefix>.index`` whose data shard is present."""
    names = sorted(os.listdir(model_dir))
    prefixes = [f[: -len(".index")] for f in names if f.endswith(".index")]
    prefixes.sort(key=lambda p: p != "model.ckpt")
    for p in prefixes:
        if any(f.startswith(p + ".data-") for f in names):
            return os.path.join(model_dir, p)
    return None


def load_params_for_bundle(bundle: ModelBundle) -> State:
    """State dict for a model directory, from its TF1 bundle."""
    prefix = _find_ckpt_prefix(bundle.model_dir)
    if prefix is None:
        raise FileNotFoundError(
            f"no TF1 checkpoint in {bundle.model_dir} (this package reads "
            "model.ckpt.index + data; the msgpack-only loader is not ported)"
        )
    return load_tf1_params(prefix, bundle.hp, bundle.variant)
