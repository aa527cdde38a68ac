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
bundle under the reference's names, in TF's layouts; :func:`params_to_jax`
gives the JAX params tree.

:func:`save_native` / :func:`load_native` write and read the JAX
package's native file, ``model.unmicst-tpu.msgpack``
(``unmicst_tpu/core/checkpoint.py:301-363``), through the standard-library
codec :mod:`unmicst_tpu_torch.core.msgpack`: a ``meta_json`` record, the
params tree, and optional ``extra_arrays`` (a trainer's optimizer state).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from unmicst_tpu_torch.core import msgpack
from unmicst_tpu_torch.core.hp import HParams, ModelBundle
from unmicst_tpu_torch.core.tf1_ckpt import TF1Checkpoint, write_tf1_checkpoint
from unmicst_tpu_torch.core.unet import get_variant

State = Dict[str, torch.Tensor]

NATIVE_FILE = "model.unmicst-tpu.msgpack"

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
    ``UNet`` state dict, shape-validated."""
    _validate_shapes(params_np, hp)
    return state_from_tree(params_np, hp, variant)


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


def param_paths(hp: HParams, variant: str
                ) -> Iterator[Tuple[str, tuple]]:
    """``(state_dict name, path in the JAX params tree)`` for every leaf,
    e.g. ``("down.0.extra.1", ("down", 0, "extra", 1))``."""
    legacy = get_variant(variant).legacy
    nx = hp.n_extra_convs

    def bn(name: str, path: tuple):
        for f in _BN_FIELDS:
            yield f"{name}.{f}", path + ("bn", f)

    for i in range(hp.n_layers):
        yield f"down.{i}.kernel1", ("down", i, "kernel1")
        for j in range(nx):
            yield f"down.{i}.extra.{j}", ("down", i, "extra", j)
        yield f"down.{i}.shortcut", ("down", i, "shortcut")
        yield from bn(f"down.{i}.bn", ("down", i))
    yield "bottom.kernel1", ("bottom", "kernel1")
    if not legacy:
        yield from bn("bottom.bn", ("bottom",))
    for i in range(hp.n_layers):
        yield f"up.{i}.kernel1", ("up", i, "kernel1")
        yield f"up.{i}.kernel2", ("up", i, "kernel2")
        for j in range(nx):
            yield f"up.{i}.extra.{j}", ("up", i, "extra", j)
        if not legacy:
            yield from bn(f"up.{i}.bn", ("up", i))
    yield "top.kernel", ("top", "kernel")
    if not legacy:
        yield from bn("top.bn", ("top",))


def params_to_jax(state: State, hp: HParams, variant: str) -> dict:
    """``UNet`` state dict (or any tensors keyed by its names, such as an
    optimizer slot of each) -> the JAX params tree of float32 numpy
    arrays, the inverse of :func:`params_from_jax`."""
    tree: dict = {
        "down": [{"extra": [None] * hp.n_extra_convs}
                 for _ in range(hp.n_layers)],
        "bottom": {},
        "up": [{"extra": [None] * hp.n_extra_convs}
               for _ in range(hp.n_layers)],
        "top": {},
    }
    for name, path in param_paths(hp, variant):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {}) if isinstance(node, dict) \
                else node[key]
        t = state[name]
        node[path[-1]] = _hwio(t) if t.dim() == 4 else _np(t).copy()
    return tree


def state_from_tree(tree, hp: HParams, variant: str) -> State:
    """The inverse of :func:`params_to_jax`, unvalidated: the leaves of
    a JAX params tree (lists, or the ``"0"``-keyed dicts of flax's
    ``to_state_dict``) by ``state_dict`` name, in PyTorch's layouts."""
    state: State = {}
    for name, path in param_paths(hp, variant):
        leaf = tree
        for key in path:
            leaf = leaf[str(key) if isinstance(leaf, dict)
                        and isinstance(key, int) else key]
        state[name] = _oihw(leaf) if np.ndim(leaf) == 4 else _vec(leaf)
    return state


def _to_msgpack_tree(tree):
    """``_to_numpy`` of ``unmicst_tpu/core/checkpoint.py:385-396``: lists
    become ``{"__list_<i>": ..., "__list_len": n}``, leaves arrays."""
    if isinstance(tree, dict):
        return {k: _to_msgpack_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = {f"__list_{i}": _to_msgpack_tree(v) for i, v in enumerate(tree)}
        out["__list_len"] = np.int64(len(tree))
        return out
    return np.asarray(tree)


def _listify(tree):
    """``_listify`` of ``unmicst_tpu/core/checkpoint.py:399-418``."""
    if isinstance(tree, dict):
        if "__list_len" in tree:
            return [_listify(tree[f"__list_{i}"])
                    for i in range(int(tree["__list_len"]))]
        if tree and all(k.startswith("__list_") for k in tree):
            return [_listify(tree[f"__list_{i}"]) for i in range(len(tree))]
        if not tree:
            return []
        return {k: _listify(v) for k, v in tree.items()}
    return np.asarray(tree)


def save_native(path: str, params: dict, hp: HParams, variant: str,
                mean: float, std: float, extra: Optional[dict] = None,
                extra_arrays: Optional[dict] = None) -> None:
    """Write the native file: ``params`` is the JAX params tree (numpy;
    :func:`params_to_jax` of a state dict); ``extra`` JSON-able scalars for
    the meta record; ``extra_arrays`` an array tree stored beside the params
    (``meta["_extra_arrays"]`` of :func:`load_native`).  Written to
    ``path + ".tmp"`` and renamed, so a reader never sees half a file."""
    meta = {"hp": hp.to_ref_dict(), "variant": variant, "mean": mean,
            "std": std, "format": "unmicst-tpu-v1"}
    if extra:
        reserved = set(meta) & set(extra)
        if reserved:
            raise ValueError(
                f"extra clobbers reserved meta key(s) {sorted(reserved)}")
        meta.update(extra)
    payload = {"meta_json": json.dumps(meta),
               "params": _to_msgpack_tree(params)}
    if extra_arrays is not None:
        payload["extra_arrays"] = _to_msgpack_tree(extra_arrays)
    blob = msgpack.serialize(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def load_native(path: str) -> Tuple[dict, HParams, str, float, float, dict]:
    """``(params tree, hp, variant, mean, std, meta)`` of a native file, as
    the JAX ``load_native`` returns them (the tree in the JAX layout:
    :func:`params_from_jax` makes it a state dict)."""
    with open(path, "rb") as f:
        tree = msgpack.restore(f.read())
    meta = json.loads(tree["meta_json"])
    if "extra_arrays" in tree:
        meta["_extra_arrays"] = _listify(tree["extra_arrays"])
    return (_listify(tree["params"]), HParams.from_ref_dict(meta["hp"]),
            meta["variant"], float(meta["mean"]), float(meta["std"]), meta)


def hp_from_tf1(prefix: str, variant: str,
                base: Optional[HParams] = None) -> HParams:
    """The architecture hyper-parameters a TF1 bundle's shapes imply
    (``unmicst_tpu/core/checkpoint.py:163-200``), read from the index
    alone.  A directory's ``hp.data`` can disagree with its only
    restorable bundle: ``mousenucleiDAPI`` says nOut0 20, its
    ``nuclei20x2bin1chan`` bundle is 16 wide.  ``im_size`` and
    ``batch_size`` do not shape the params and come from ``base``."""
    ck = TF1Checkpoint(prefix)
    legacy = get_variant(variant).legacy

    def down(i):
        return (f"downsampling/ld{i}/kernel1" if legacy
                else f"downsampling/ld{i}/kernelD{i}")

    ks, _, n_channels, n_out0 = ck.get_shape(down(0))
    n_layers = 0
    while ck.has_tensor(down(n_layers)):
        n_layers += 1
    extra = ("downsampling/ld0/kernelExtra{}" if legacy
             else "ld0/kernelExtra{}")
    n_extra = 0
    while ck.has_tensor(extra.format(n_extra)):
        n_extra += 1
    n_classes = ck.get_shape("lt/kernel")[-1]
    bottom = ck.get_shape("lb/kernel1")
    base = base or HParams(im_size=128, n_channels=n_channels,
                           n_classes=n_classes, n_out0=n_out0)
    return dataclasses.replace(
        base, n_channels=int(n_channels), n_classes=int(n_classes),
        n_out0=int(n_out0), ks=int(ks), n_layers=n_layers,
        n_extra_convs=n_extra, feat_maps_fact=int(bottom[-1] // bottom[-2]))


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


def _native_params(path: str, bundle: ModelBundle) -> State:
    """The native file's params, held to the directory's variant and to
    ``hp.data``'s architecture (``unmicst_tpu/core/checkpoint.py:436-
    455``)."""
    params, hp, variant, _, _, _ = load_native(path)
    if variant != bundle.variant:
        raise ValueError(
            f"native checkpoint is variant {variant!r} but the model dir "
            f"resolves to {bundle.variant!r}")
    arch = ("n_channels", "n_classes", "n_out0", "feat_maps_fact",
            "down_samp_fact", "ks", "n_extra_convs", "n_layers")
    bad = [f for f in arch if getattr(hp, f) != getattr(bundle.hp, f)]
    if bad:
        raise ValueError(
            f"native checkpoint hp mismatch with hp.data on architecture "
            f"field(s) {bad}")
    return params_from_jax(params, bundle.hp, bundle.variant)


def load_params_for_bundle(bundle: ModelBundle) -> State:
    """State dict for a model directory: the native msgpack file when it
    is there, else the TF1 bundle, as the JAX package reads a directory
    (``unmicst_tpu/core/checkpoint.py:426-456``): a ``Trainer`` that saves
    without the TF1 export leaves a newer native file beside an older
    bundle."""
    native = os.path.join(bundle.model_dir, NATIVE_FILE)
    if os.path.exists(native):
        return _native_params(native, bundle)
    prefix = _find_ckpt_prefix(bundle.model_dir)
    if prefix is not None:
        if os.path.basename(prefix) != "model.ckpt":
            # an alternate bundle: its shapes win over a stale hp.data,
            # and callers build their engines from bundle.hp after this
            # (unmicst_tpu/core/checkpoint.py:456-463)
            bundle.hp = hp_from_tf1(prefix, bundle.variant, base=bundle.hp)
        return load_tf1_params(prefix, bundle.hp, bundle.variant)
    raise FileNotFoundError(
        f"no restorable checkpoint in {bundle.model_dir} (neither "
        f"model.ckpt.index + data nor {NATIVE_FILE})")
