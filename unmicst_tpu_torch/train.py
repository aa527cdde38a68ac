"""Training: weighted-CE UNet training on the card (ROADMAP M10).

The counterpart of ``unmicst_tpu/train.py``.  Behavioural spec:
``UNet2D.train`` — legacy flavour ``UnMicst.py:189-415`` (plain CE,
Momentum 0.9, lr0 0.01 staircase 1000/0.95) and v2 ``UnMicst1-5.py:
240-579`` (per-class weight maps, Adam lr0 5e-5 staircase 5000/0.98,
nAug 12 baked augmentation pages per sample, brightness/contrast jitter,
validation every step, best-on-valid checkpoint every 50 steps).

* The step is eager PyTorch on the trainer's device (``cuda`` unless the
  caller names ``cpu``): the train-mode forward of
  :class:`~unmicst_tpu_torch.core.unet.UNet` returns the BN moving
  statistics' update, which the step writes after the gradient is taken,
  as JAX's functional update does (``train.py:260-268``); ``remat`` is
  ``torch.utils.checkpoint``, with dropout's generator forked from a seed
  drawn outside it so the recomputed masks are the same.
* The optimizers are optax's ``sgd(momentum)`` and ``adam`` over the
  staircase ``exponential_decay``, written out (``_foreach`` updates on
  the trainable parameters); their state keeps optax's layout, zero slots
  for the BN moving statistics included, so checkpoints cross between
  the two packages both ways.
* cuDNN runs nondeterministic algorithms: two runs on the card agree to
  a tolerance, not bit for bit (on the CPU they agree bit for bit).
* The batch stream draws from numpy's ``RandomState`` in JAX's order, so
  both packages feed the same batches bit for bit; ``prefetch`` uploads
  from pinned memory on a feed thread.
* Checkpoints: the native msgpack file with the optimizer state, the
  reference's pickled sidecars and a TF1 bundle, so a trained model
  directory loads in the zoo loaders of both packages and in the
  reference tool.

The precision strings are JAX's: ``"high"`` and ``"highest"`` run float32
with TF32 off (the parity mode), ``"default"`` lets cuDNN use TF32; the
flags are set around the trainer's own work and restored after.

``Trainer(mesh=...)`` trains over a ``(data, model)`` mesh
(``runtime/mesh.py``, ``train.py:497-515, 550-556`` of the JAX package):
the parameters placed by ``put_params`` (the wide ones split over
``model``), each batch split by ``data_sharding``, the forward of
:func:`~unmicst_tpu_torch.core.unet.train_forward_ranks` with the global
batch's BN statistics and dropout masks, the loss the global mean, the
gradients summed over ``data`` before the optimizer, which makes the same
update on every rank.  The same code runs a mesh in one process and one
across processes (``initialize_distributed``): each process steps its own
ranks.  ``save`` gathers to process 0, which alone writes what a
one-device trainer writes at the same parameters.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import queue as _queue_mod
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from unmicst_tpu_torch.core import unet
from unmicst_tpu_torch.core.checkpoint import (NATIVE_FILE, load_native,
                                               params_from_jax,
                                               params_to_jax, save_native,
                                               save_tf1_params,
                                               state_from_tree)
from unmicst_tpu_torch.core.hp import HParams, save_pickle
from unmicst_tpu_torch.core.unet import UNet
from unmicst_tpu_torch.runtime import collectives
from unmicst_tpu_torch.runtime.devices import Device, resolve_device
from unmicst_tpu_torch.runtime.mesh import (data_sharding, gather_state,
                                            process_allgather, shard_params,
                                            shard_state)

EPS = 1e-7  # log clip (UnMicst1-5.py:369-370)

# v2 class-weight defaults (UnMicst1-5.py:278-281); duo/cyto2 override
# them through TrainConfig
BG_WEIGHT = 1.0
CONTOUR_WEIGHT = 2.0
NUCLEI_WEIGHT = 7.0
INTERSECT_WEIGHT = 15.0

State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Per-variant optimisation hyper-parameters (reference values); the
    fields and presets of ``unmicst_tpu/train.py:53-167``."""

    variant: str = "v2"
    lr0: float = 5e-5  # UnMicst1-5.py:362
    decay_steps: int = 5000
    decay_rate: float = 0.98
    optimizer: str = "adam"  # 'adam' | 'momentum'
    momentum: float = 0.9
    n_aug: int = 12  # UnMicst1-5.py:258
    use_weights: bool = True
    dataset_mean: float = 0.34  # UnMicst1-5.py:276-277
    dataset_std: float = 0.25
    ckpt_every: int = 50  # UnMicst1-5.py:519
    seed: int = 0
    remat: bool = False  # recompute the forward in backward (memory <-> FLOPs)
    # 'high' / 'highest': float32 convolutions with TF32 off (the parity
    # mode); 'default': cuDNN may use TF32
    precision: str = "high"
    # 'bfloat16': bf16 convolutions (each output rounded to bf16, then
    # upcast) with float32 master weights, BN, CE and optimizer state;
    # None keeps the float32 pipeline
    compute_dtype: Optional[str] = None
    export_tf1: bool = True  # also write a Saver-compatible model.ckpt.*
    # brightness/contrast jitter on train batches (UnMicst2.py:447-450,
    # UnMicstCyto2.py:448-449)
    jitter: bool = True
    # channels filled from the corpus; the duo reference loads channel 0
    # only and leaves channel 1 zero (UnMicst2.py:256,295-297)
    fill_channels: Optional[int] = None
    # legacy draws a fresh permutation every step and takes its head
    # (UnMicst.py:346-352) instead of the v2 cursor walk
    per_step_shuffle: bool = False
    # write checkpoints on a thread from an on-device snapshot; writes
    # stay ordered and fit()/close() join them, re-raising a failure
    async_save: bool = False
    # TensorBoard image panels on the scalar cadence (see make_panel_fn)
    tb_images: bool = True
    # host-feed depth: 0 assembles, uploads and steps in turn; N > 0
    # assembles and uploads the next N batches on a thread (the same
    # batches in the same order)
    prefetch: int = 0
    # 1 validates every step (the reference protocol); N > 1 every Nth
    # step and the last, the train metrics held on the device between
    valid_every: int = 1
    # class-weight constants (v2 defaults; duo 1/2/5/10, cyto2 1/3/-/5)
    bg_weight: float = BG_WEIGHT
    contour_weight: float = CONTOUR_WEIGHT
    nuclei_weight: float = NUCLEI_WEIGHT
    intersect_weight: float = INTERSECT_WEIGHT

    @classmethod
    def for_variant(cls, variant: str, **overrides) -> "TrainConfig":
        presets = {
            # UnMicst.py:270-279,346-352,378
            "legacy": dict(
                lr0=0.01, decay_steps=1000, decay_rate=0.95,
                optimizer="momentum", n_aug=1, use_weights=False,
                ckpt_every=100, per_step_shuffle=True,
            ),
            "v2": dict(lr0=5e-5),  # UnMicst1-5.py:362-365,519
            # UnMicst2.py:357-359 (6e-5, 4000, 0.99), :488 (i%10),
            # :273-278 (mean .19/.17, weights 1/2/5/10), :295-297
            "duo": dict(lr0=6e-5, decay_steps=4000, decay_rate=0.99,
                        ckpt_every=10, n_aug=1, fill_channels=1,
                        dataset_mean=0.19, dataset_std=0.17,
                        nuclei_weight=5.0, intersect_weight=10.0),
            # UnMicstCyto2.py:347-349 (1e-3, 2500, 0.97), :488, :270-274
            "cyto2": dict(lr0=1e-3, decay_steps=2500, decay_rate=0.97,
                          ckpt_every=10, n_aug=1,
                          dataset_mean=0.07, dataset_std=0.07,
                          contour_weight=3.0, intersect_weight=5.0),
        }
        kw = dict(presets[variant])
        kw["variant"] = variant
        kw.update(overrides)
        return cls(**kw)


def class_weight_maps(labels_onehot: np.ndarray, wt: np.ndarray,
                      cfg: Optional[TrainConfig] = None) -> np.ndarray:
    """Per-class weight planes from the ``I%05d_wt.tif`` mask.

    3-class (v2/duo, ``UnMicst1-5.py:305-312``): bg = bgW, contours =
    wt * intersectW + contourW, nuclei = nucleiW.  2-class (cyto2,
    ``UnMicstCyto2.py:297-302``): class 0 = wt * intersectW + contourW,
    class 1 = wt * intersectW + bgW."""
    bg = cfg.bg_weight if cfg else BG_WEIGHT
    contour = cfg.contour_weight if cfg else CONTOUR_WEIGHT
    nuclei = cfg.nuclei_weight if cfg else NUCLEI_WEIGHT
    intersect = cfg.intersect_weight if cfg else INTERSECT_WEIGHT
    n_classes = labels_onehot.shape[-1]
    w = np.zeros_like(labels_onehot, dtype=np.float32)
    if n_classes == 2:
        w[..., 0] = wt * intersect + contour
        w[..., 1] = wt * intersect + bg
        return w
    for i in range(n_classes):
        if i == 1:
            w[..., i] = wt * intersect + contour
        elif i == 2:
            w[..., i] = nuclei
        else:
            w[..., i] = bg
    return w


def compute_dataset_stats(im_path: str, n_samples: int) -> tuple:
    """Legacy mean/std: the average of per-image im2double mean/std over
    the corpus (``UnMicst.py:222-231``)."""
    from unmicst_tpu_torch.io.preprocess import im2double
    from unmicst_tpu_torch.io.tiff import imread

    mean = std = 0.0
    for i in range(n_samples):
        im = im2double(imread(os.path.join(im_path, f"I{i:05d}_Img.tif")))
        mean += float(np.mean(im))
        std += float(np.std(im))
    return mean / n_samples, std / n_samples


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """optax's staircase ``exponential_decay`` for the update made after
    ``count`` updates, in float32 as optax computes it."""
    p = np.float32(count // cfg.decay_steps)
    return float(np.float32(cfg.lr0)
                 * np.power(np.float32(cfg.decay_rate), p))


@dataclasses.dataclass
class OptState:
    """optax's state: ``slots`` maps a slot name (``trace`` for Momentum,
    ``mu`` and ``nu`` for Adam) to a tensor per ``state_dict`` name, the
    BN moving statistics' (always zero) included; ``count`` is the number
    of updates made (both of optax's counters)."""

    count: int
    slots: Dict[str, State]

    def clone(self) -> "OptState":
        return OptState(self.count, {k: {n: t.detach().clone()
                                         for n, t in s.items()}
                                     for k, s in self.slots.items()})


def _flax_tree(tree):
    """``flax.serialization.to_state_dict`` of a params tree: lists become
    dicts keyed ``"0"``, ``"1"``, ..."""
    if isinstance(tree, dict):
        return {k: _flax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _flax_tree(v) for i, v in enumerate(tree)}
    return tree


class Optimizer:
    """``make_optimizer`` (``unmicst_tpu/train.py:213-219``): optax's
    ``sgd(schedule, momentum)`` — ``buf = m * buf + g``, ``p -= lr * buf`` —
    or ``adam(schedule)`` — optax's form, ``eps`` outside the square root
    of the bias-corrected second moment — over the staircase schedule."""

    B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8

    def __init__(self, cfg: TrainConfig):
        if cfg.optimizer not in ("adam", "momentum"):
            raise ValueError(f"optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.slot_names = (("trace",) if cfg.optimizer == "momentum"
                           else ("mu", "nu"))

    def init(self, model: UNet) -> OptState:
        return OptState(0, {k: {n: torch.zeros_like(t) for n, t in
                                model.state_dict().items()}
                            for k in self.slot_names})

    @torch.no_grad()
    def update(self, opt_state: OptState, names: List[str],
               params: List[torch.Tensor],
               grads: List[torch.Tensor]) -> None:
        """One update of ``params`` (in place) and ``opt_state``."""
        lr = learning_rate(self.cfg, opt_state.count)
        if self.cfg.optimizer == "momentum":
            trace = [opt_state.slots["trace"][n] for n in names]
            torch._foreach_mul_(trace, self.cfg.momentum)
            torch._foreach_add_(trace, grads)
            torch._foreach_add_(params, trace, alpha=-lr)
        else:
            b1, b2 = self.B1, self.B2
            mu = [opt_state.slots["mu"][n] for n in names]
            nu = [opt_state.slots["nu"][n] for n in names]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            t = np.float32(opt_state.count + 1)
            bc1 = float(np.float32(1) - np.power(np.float32(b1), t))
            bc2 = float(np.float32(1) - np.power(np.float32(b2), t))
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.ADAM_EPS)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, den)
            torch._foreach_add_(params, upd, alpha=-lr)
        opt_state.count += 1

    def state_dict(self, opt_state: OptState, hp: HParams,
                   variant: str) -> dict:
        """The state as ``flax.serialization.to_state_dict`` gives optax's
        ``(TraceState | ScaleByAdamState, ScaleByScheduleState)``, numpy
        leaves in the JAX layout."""
        count = np.asarray(opt_state.count, np.int32)
        trees = {k: _flax_tree(params_to_jax(
            {n: t.detach().cpu() for n, t in s.items()}, hp, variant))
            for k, s in opt_state.slots.items()}
        first = dict(trees)
        if self.cfg.optimizer == "adam":
            first["count"] = count
        return {"0": first, "1": {"count": count.copy()}}

    def load_state_dict(self, saved: dict, model: UNet, hp: HParams,
                        variant: str) -> OptState:
        """The inverse of :meth:`state_dict`, on ``model``'s device; also
        reads what the JAX ``Trainer`` writes."""
        dev = model.top.kernel.device
        slots = {k: {n: t.to(dev) for n, t in
                     state_from_tree(saved["0"][k], hp, variant).items()}
                 for k in self.slot_names}
        return OptState(int(np.asarray(saved["1"]["count"])), slots)


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    return Optimizer(cfg)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def _compute_dtype(cfg: TrainConfig) -> Optional[torch.dtype]:
    if cfg.compute_dtype in (None, "float32"):
        return None
    if cfg.compute_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")


def loss_fn(model: UNet, batch: Dict[str, torch.Tensor], hp: HParams,
            cfg: TrainConfig, generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Tuple[State, Dict[str, torch.Tensor]]]:
    """Weighted softmax CE plus the kernel regularizer
    (``UnMicst1-5.py:367-373``): clip to ``[1e-7, 1 - 1e-7]``, log,
    weighted sum over classes, mean.  ``batch`` holds NCHW tensors on the
    model's device (``image`` [B, C, S, S], ``labels`` and ``weights``
    [B, K, S, S]).  ``generator`` (CPU) seeds this step's dropout; None
    turns dropout off.  Returns ``(loss, (new BN statistics, metrics))``."""
    cdt = _compute_dtype(cfg)
    seed = (None if generator is None else
            int(torch.randint(0, 2 ** 62, (1,), generator=generator)))

    def fwd(x):
        # a generator made here from the seed: a recomputed forward
        # (remat) draws the same masks
        g = None
        if seed is not None:
            g = torch.Generator(device=x.device)
            g.manual_seed(seed)
        return model.forward_nchw(x, train=True, generator=g,
                                  compute_dtype=cdt)

    x = batch["image"]
    if cfg.remat:
        probs, new_stats = torch.utils.checkpoint.checkpoint(
            fwd, x, use_reentrant=False, preserve_rng_state=False)
    else:
        probs, new_stats = fwd(x)
    log_p = torch.log(torch.clamp(probs, EPS, 1 - EPS))
    ce = batch["labels"] * log_p
    if cfg.use_weights:
        ce = batch["weights"] * ce
    data_loss = torch.mean(-torch.sum(ce, dim=1))
    reg = unet.regularization_loss(model)
    loss = data_loss + reg
    return loss, (new_stats, {"loss": loss.detach(), "ce": data_loss.detach(),
                              "reg": reg.detach()})


def per_class_error(probs: torch.Tensor,
                    labels_onehot: torch.Tensor) -> torch.Tensor:
    """``1 - correct / labeled`` per class (``UnMicst1-5.py:386-397``);
    ``probs`` and ``labels_onehot`` [B, S, S, K] (any strides)."""
    n_classes = labels_onehot.shape[-1]
    pred = F.one_hot(torch.argmax(probs, dim=-1), n_classes).to(
        labels_onehot.dtype)
    n_correct = torch.sum(labels_onehot * pred, dim=(0, 1, 2))
    n_labeled = torch.sum(labels_onehot, dim=(0, 1, 2))
    return 1.0 - n_correct / torch.clamp_min(n_labeled, 1.0)


def make_train_step(hp: HParams, cfg: TrainConfig, tx: Optimizer):
    """``train_step(model, opt_state, batch, generator) -> metrics``: the
    gradient at the parameters before the BN update, then the BN update,
    then the optimizer's (``train.py:260-268``); ``model`` and
    ``opt_state`` change in place, under :func:`precision_flags`.  The
    metrics stay on the device."""

    def train_step(model: UNet, opt_state: OptState,
                   batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        names, params = zip(*model.named_parameters())
        with precision_flags(cfg):
            loss, (new_stats, metrics) = loss_fn(model, batch, hp, cfg,
                                                 generator)
            grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for name, value in new_stats.items():
                model.get_buffer(name).copy_(value)
        tx.update(opt_state, list(names), list(params), list(grads))
        return metrics

    return train_step


class _MeshOps:
    """The mesh as :func:`~unmicst_tpu_torch.core.unet.train_forward_ranks`
    sees it: which parameters are split, the global batch and each local
    rank's slices of it, and the collectives."""

    def __init__(self, mesh, spec: Dict[str, Optional[int]],
                 global_batch: int):
        self.mesh, self.spec, self.global_batch = mesh, spec, global_batch
        self.model = mesh.model
        self._local = mesh.local_ranks()
        self._sharding = data_sharding(mesh)
        
    def sharded(self, name: str) -> bool:
        return self.spec.get(name) is not None

    def batch_slice(self, k: int) -> Tuple[int, int]:
        return self._sharding.bounds(self.global_batch, self._local[k])

    def channel_slice(self, k: int, c: int) -> Tuple[int, int]:
        m = self.mesh.coords(self._local[k])[1]
        return m * c // self.model, (m + 1) * c // self.model

    def sum_data(self, xs):
        return collectives.all_reduce_sum(xs, self.mesh, "data")

    def sum_model(self, xs):
        return collectives.all_reduce_sum(xs, self.mesh, "model")

    def gather(self, xs):
        return collectives.all_gather(xs, self.mesh, "model", 1)

    def copy(self, xs):
        return collectives.reduce_grad(xs, self.mesh, "model")


def make_mesh_train_step(hp: HParams, cfg: TrainConfig, tx: Optimizer, mesh,
                         spec: Dict[str, Optional[int]]):
    """``train_step(models, opt_states, batch, generator) -> metrics`` over
    ``mesh``: ``models`` and ``opt_states`` are this process's ranks'
    (``mesh.local_ranks()`` order), ``batch`` the global batch (NCHW, every
    process the same); each rank takes its ``data`` slice.

    Each rank's loss is its slice's share of the global mean plus the
    regularizer over ``data`` ranks; the gradients of all local ranks come
    from one backward (the collectives join them), are summed over
    ``data`` (one flat buffer per rank), and each rank makes the same
    update as a one-device step.  The metrics are the global loss, CE and
    regularizer, on the first local rank's device."""
    if cfg.remat:
        raise ValueError("remat is not supported under a mesh")

    def train_step(models: List[UNet], opt_states: List[OptState],
                   batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        ops = _MeshOps(mesh, spec, batch["image"].shape[0])
        parts = {k: data_sharding(mesh).local(v) for k, v in batch.items()}
        g = None
        if generator is not None:  # the single step's seed and generator
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
            g = torch.Generator(device=parts["image"][0].device)
            g.manual_seed(seed)
        names = [n for n, _ in models[0].named_parameters()]
        params = [[p for _, p in m.named_parameters()] for m in models]
        s = hp.im_size
        n_pix = ops.global_batch * s * s
        with precision_flags(cfg):
            probs, new_stats = unet.train_forward_ranks(
                models, parts["image"], ops, g, _compute_dtype(cfg))
            ce_parts, losses = [], []
            for k, p in enumerate(probs):
                ce = parts["labels"][k] * torch.log(torch.clamp(p, EPS,
                                                                1 - EPS))
                if cfg.use_weights:
                    ce = parts["weights"][k] * ce
                part = torch.sum(-torch.sum(ce, dim=1)) / n_pix
                ce_parts.append(part)
                losses.append(part + unet.regularization_loss(models[k])
                              / mesh.data)
            flat = torch.autograd.grad(losses, [p for ps in params
                                                for p in ps])
        with torch.no_grad():
            grads = [list(flat[k * len(names):(k + 1) * len(names)])
                     for k in range(len(models))]
            if mesh.data > 1:  # the sum over data, one buffer per rank
                summed = collectives.all_reduce_sum(
                    [torch.cat([t.reshape(-1) for t in gs]) for gs in grads],
                    mesh, "data")
                grads = [[t.view_as(g0) for t, g0 in zip(
                    torch.split(buf, [g0.numel() for g0 in gs]), gs)]
                    for buf, gs in zip(summed, grads)]
            for m, stats in zip(models, new_stats):
                for name, value in stats.items():
                    m.get_buffer(name).copy_(value)
            ce = collectives.all_reduce_sum([c.detach() for c in ce_parts],
                                            mesh, "data")
            reg_split = ops.sum_model([unet.regularization_loss(
                m, keep=ops.sharded).detach() for m in models])
            reg = reg_split[0] + unet.regularization_loss(
                models[0], keep=lambda n: not ops.sharded(n)).detach()
        for st, ps, gs in zip(opt_states, params, grads):
            tx.update(st, names, ps, gs)
        return {"loss": ce[0] + reg, "ce": ce[0], "reg": reg}

    return train_step


def make_eval_step(hp: HParams, cfg: TrainConfig):
    """``eval_step(model, batch) -> {"errors", "mean_error"}``: the
    inference forward and :func:`per_class_error`."""

    @torch.no_grad()
    def eval_step(model: UNet, batch: Dict[str, torch.Tensor]):
        with precision_flags(cfg):
            probs = model.forward_nchw(batch["image"])
        errors = per_class_error(probs.permute(0, 2, 3, 1),
                                 batch["labels"].permute(0, 2, 3, 1))
        return {"errors": errors, "mean_error": torch.mean(errors)}

    return eval_step


@contextlib.contextmanager
def precision_flags(cfg: TrainConfig):
    """cuDNN and matmul TF32 for ``cfg.precision`` (``"high"`` and
    ``"highest"``: off; ``"default"``: on), cuDNN autotuning on (a fit has
    few shapes), set around each step's work and restored after.  cuDNN
    stays nondeterministic (its weight-gradient convolutions reduce with
    atomics), so on the card two runs agree to a tolerance, not bit for
    bit."""
    if cfg.precision not in ("default", "high", "highest"):
        raise ValueError(f"precision {cfg.precision!r} not in "
                         "['default', 'high', 'highest']")
    tf32 = cfg.precision == "default"
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = tf32
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                        deterministic=False,
                                        allow_tf32=tf32):
            yield
    finally:
        matmul.allow_tf32 = saved


def _as_model(params, hp: HParams, variant: str) -> UNet:
    """A :class:`UNet` as it is, or a state dict loaded into one on its
    tensors' device."""
    if isinstance(params, UNet):
        return params
    dev = next(iter(params.values())).device
    model = UNet(hp, variant).to(dev)
    model.load_state_dict(params)
    return model


def make_panel_fn(hp: HParams, cfg: TrainConfig):
    """TensorBoard image panels (``train.py:284-316``): returns
    ``run(params, images) -> {tag: float32 [B', S, W, 1] in [0, 1]}`` for
    ``images`` [B, S, S, C] (``params``: a ``UNet`` or a state dict),
    ``B'`` capped at the reference's ``max_outputs`` (4 for the v2 tools'
    ``impm`` = [min-max-normalised input ch0 | PM 1 | PM 2], cyto2 [norm |
    PM 0]; 3 for legacy's separate ``pm0``/``pm1``/``pm2``)."""
    max_out = 3 if cfg.variant == "legacy" else 4

    @torch.no_grad()
    def run(params, images):
        model = _as_model(params, hp, cfg.variant)
        dev = model.top.kernel.device
        x = torch.as_tensor(images[:max_out]).to(dev, torch.float32)
        x = x.permute(0, 3, 1, 2)
        with precision_flags(cfg):
            probs = model.forward_nchw(x)
        if cfg.variant == "legacy":  # UnMicst.py:305-314
            out = {f"pm{k}": probs[:, k:k + 1]
                   for k in range(min(hp.n_classes, 3))}
        else:
            ch0 = x[:, 0:1]
            lo = torch.amin(ch0, dim=(2, 3), keepdim=True)
            hi = torch.amax(ch0, dim=(2, 3), keepdim=True)
            norm = (ch0 - lo) / torch.clamp_min(hi - lo, EPS)
            if cfg.variant == "cyto2":  # UnMicstCyto2.py:394-401
                planes = [norm, probs[:, 0:1]]
            else:  # UnMicst1-5.py:409-427 / UnMicst2.py:401-417
                planes = [norm, probs[:, 1:2], probs[:, 2:3]]
            out = {"impm": torch.cat(planes, dim=3)}
        return {k: v.permute(0, 2, 3, 1).float().cpu().numpy()
                for k, v in out.items()}

    return run


# ---------------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------------


class Corpus:
    """Reference-format training corpus, held in host memory
    (``train.py:324-426``).

    Layout (``UnMicst1-5.py:295-312``): ``I%05d_Img.tif`` with ``nAug *
    nChannels`` pages (page = iAug + nAug * iChan), ``I%05d_Ant.tif``
    labels valued 1..nClasses, ``I%05d_wt.tif`` the contour/nuclei
    intersection mask.  Legacy corpora (``UnMicst.py:236-243``) are
    single-page, without weights."""

    def __init__(self, path: str, n_samples: int, hp: HParams,
                 cfg: TrainConfig, indices: Optional[np.ndarray] = None):
        from unmicst_tpu_torch.io.preprocess import im2double
        from unmicst_tpu_torch.io.tiff import imread

        S, C, K, A = hp.im_size, hp.n_channels, hp.n_classes, cfg.n_aug
        ids = indices if indices is not None else np.arange(n_samples)
        n = len(ids)
        self.images = np.zeros((n, S, S, A, C), np.float32)
        self.labels = np.zeros((n, S, S, K), np.float32)
        self.weights = np.ones((n, S, S, K), np.float32)
        fill_c = C if cfg.fill_channels is None else min(C, cfg.fill_channels)
        for row, idx in enumerate(ids):
            img_path = os.path.join(path, f"I{idx:05d}_Img.tif")
            for c in range(fill_c):
                for a in range(A):
                    im = im2double(imread(img_path, a + A * c))
                    self.images[row, :, :, a, c] = (
                        im - cfg.dataset_mean) / cfg.dataset_std
            # channels >= fill_c stay zero (duo parity, UnMicst2.py:256)
            ant = imread(os.path.join(path, f"I{idx:05d}_Ant.tif"))
            for k in range(K):
                self.labels[row, :, :, k] = ant == k + 1
            if cfg.use_weights:
                wt_path = os.path.join(path, f"I{idx:05d}_wt.tif")
                wt = (imread(wt_path).astype(np.float32)
                      if os.path.exists(wt_path)
                      else np.zeros((S, S), np.float32))
                self.weights[row] = class_weight_maps(self.labels[row], wt,
                                                      cfg)
        self.n = n
        self.cfg = cfg

    def batches(self, batch_size: int, rng: np.random.RandomState,
                augment: bool, jitter: Optional[bool] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Cursor-walk batches with the epoch reshuffle
        (``UnMicst1-5.py:469-489``) and brightness/contrast jitter
        (``:473-477``), drawing from ``rng`` in the JAX package's order;
        ``augment`` picks a random baked page per sample and channel,
        ``jitter`` (default: ``augment``) perturbs; the reference's
        validation draws pages without jitter (``:498-505``)."""
        cfg = self.cfg
        if jitter is None:
            jitter = augment
        max_brig = 1.0 * cfg.dataset_std  # UnMicst1-5.py:464-465
        max_cont = 0.1 * cfg.dataset_std
        perm = rng.permutation(self.n)
        cursor = 0
        while True:
            if cfg.per_step_shuffle:
                # legacy: a fresh permutation each step, its head
                # (UnMicst.py:346-352)
                perm = rng.permutation(self.n)
                take = [perm[j % self.n] for j in range(batch_size)]
            else:
                # the reference resets when the next start would pass
                # nTrain - batchSize - 1, skipping the final exact-fit
                # batch of each epoch (UnMicst1-5.py:485-488)
                if cursor + batch_size > self.n - 1:
                    perm = rng.permutation(self.n)
                    cursor = 0
                take = [perm[(cursor + j) % self.n] for j in range(batch_size)]
                cursor += batch_size
            n_aug = self.images.shape[3]
            imgs = np.empty((batch_size,) + self.images.shape[1:3]
                            + (self.images.shape[4],), np.float32)
            for j, s in enumerate(take):
                if jitter:
                    f_brig = max_brig * (-1.0) ** (rng.rand() < 0.5) * rng.rand()
                    f_cont = 1 + max_cont * (-1.0) ** (rng.rand() < 0.5) * rng.rand()
                else:
                    f_brig, f_cont = 0.0, 1.0
                for c in range(self.images.shape[4]):
                    a = int(n_aug * rng.rand()) if augment else 0
                    imgs[j, :, :, c] = self.images[s, :, :, a, c] * f_cont + f_brig
            yield {"image": imgs, "labels": self.labels[take],
                   "weights": self.weights[take]}


def to_device(batch: Dict[str, np.ndarray], device: torch.device,
              pinned: bool = False) -> Dict[str, torch.Tensor]:
    """A host batch (NHWC numpy) as NCHW tensors on ``device``; with
    ``pinned`` (and a card) through pinned memory and ``non_blocking``
    copies, so a feed thread's upload overlaps the step in flight."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if pinned and device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t.permute(0, 3, 1, 2).contiguous()
    return out


class _PrefetchFeed:
    """The feed thread of ``TrainConfig.prefetch`` (``train.py:429-479``):
    yields the wrapped generator's items in order through a bounded queue;
    a feed exception re-raises at the consuming step; ``close()`` retires
    the thread early."""

    _DONE = object()

    def __init__(self, gen, depth: int):
        self._q = _queue_mod.Queue(maxsize=max(1, int(depth)))
        self._cancelled = threading.Event()
        self._err = None
        self._thread = threading.Thread(target=self._run, args=(gen,),
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._cancelled.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except _queue_mod.Full:
                continue
        return False

    def _run(self, gen) -> None:
        try:
            for item in gen:
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at __next__
            self._err = e
        finally:
            self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        self._cancelled.set()


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------


class Trainer:
    """The training loop with best-on-valid checkpoints and JSONL metrics
    (``train.py:487-852``).

    ``params``: a ``UNet`` state dict to start from (default: drawn by
    ``unet.init_params`` from ``cfg.seed``).  ``device``: ``cuda`` unless
    the caller names ``cpu``; raises without a card.  ``mesh``: train over
    a ``runtime.mesh.Mesh`` (its ranks' devices; ``device``, when given,
    must be this process's first rank's); ``tp_threshold``: the narrowest
    output width split over its ``model`` axis."""

    def __init__(self, hp: HParams, cfg: TrainConfig, model_path: str,
                 log_path: Optional[str] = None,
                 params: Optional[State] = None, mesh=None,
                 device: Device = None, tp_threshold: int = 256):
        self.hp, self.cfg = hp, cfg
        self.model_path, self.log_path = model_path, log_path
        self.mesh = mesh
        if params is None:
            params = unet.init_params(
                hp, cfg.variant, torch.Generator().manual_seed(cfg.seed))
        self.tx = make_optimizer(cfg)
        if mesh is None:
            self.device = resolve_device(device)
            self._model = UNet(hp, cfg.variant).to(self.device)
            self._model.load_state_dict(params)
            self._model.requires_grad_(True)
            self.opt_state = self.tx.init(self._model)
            self.train_step = make_train_step(hp, cfg, self.tx)
        else:
            self.device = mesh.devices[mesh.local_ranks()[0]]
            want = None if device is None else torch.device(device)
            if want is not None and (want.type != self.device.type or (
                    want.index is not None and want != self.device)):
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"local rank's, {self.device}")
            self.spec = shard_params(params, mesh, tp_threshold)
            self.rank_models = [
                unet.module_from_state(hp, cfg.variant, part).requires_grad_(
                    True)
                for part in shard_state(params, self.spec, mesh)]
            self.opt_state = [self.tx.init(m) for m in self.rank_models]
            self.train_step = make_mesh_train_step(hp, cfg, self.tx, mesh,
                                                   self.spec)
        self.eval_step = make_eval_step(hp, cfg)
        self.lowest_error = np.inf
        self.step = 0
        self.restored = False
        self._save_thread = None  # in-flight async checkpoint write
        self._save_error = None
        self._metrics_file = None
        self._tb_train = self._tb_valid = None
        self._panel_fn = None
        if log_path:
            os.makedirs(log_path, exist_ok=True)
            self._metrics_file = open(os.path.join(log_path, "metrics.jsonl"),
                                      "a")
            # TensorBoard Train/Valid writers (UnMicst1-5.py:403-443);
            # skipped when tensorboard is not installed
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb_train = SummaryWriter(os.path.join(log_path, "Train"))
                self._tb_valid = SummaryWriter(os.path.join(log_path, "Valid"))
                if cfg.tb_images:
                    self._panel_fn = make_panel_fn(hp, cfg)
            except ImportError:
                pass

    @property
    def model(self) -> UNet:
        """The trained ``UNet``; under a mesh, the whole model gathered on
        this process's first rank's device (a collective)."""
        if self.mesh is None:
            return self._model
        model = UNet(self.hp, self.cfg.variant).to(self.device)
        model.load_state_dict(self.params)
        return model

    @property
    def params(self) -> State:
        """The model's state dict (live tensors; under a mesh, the whole
        state gathered on this process's first rank's device, a
        collective)."""
        if self.mesh is None:
            return self._model.state_dict()
        return gather_state([m.state_dict() for m in self.rank_models],
                            self.spec, self.mesh, self.device)

    def _full_opt_state(self) -> OptState:
        """The optimizer state of the whole model (gathered under a
        mesh)."""
        if self.mesh is None:
            return self.opt_state
        return OptState(self.opt_state[0].count, {
            k: gather_state([st.slots[k] for st in self.opt_state],
                            self.spec, self.mesh, self.device)
            for k in self.opt_state[0].slots})

    def _agreed(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as process 0 computed it (a collective across processes),
        so every process takes the same checkpoint decisions."""
        if self.mesh is None or not self.mesh.multi_process:
            return t
        return process_allgather(t[None], tiled=True)[0]

    def _log(self, record: dict) -> None:
        if self._metrics_file:
            self._metrics_file.write(json.dumps(record) + "\n")
            self._metrics_file.flush()

    def fit(self, train_corpus: Corpus, valid_corpus: Corpus, n_steps: int,
            batch_size: Optional[int] = None, verbose: bool = True) -> float:
        """Run ``n_steps``, one train step and (every ``valid_every``-th
        step and the last) one valid step each (``UnMicst1-5.py:469-521``).
        Returns the best validation error."""
        cfg = self.cfg
        bs = batch_size or self.hp.batch_size
        rng_np = np.random.RandomState(cfg.seed + 1)
        train_iter = train_corpus.batches(bs, rng_np, augment=cfg.n_aug > 1,
                                          jitter=cfg.jitter)
        # reference validation: a random baked page, no jitter
        valid_iter = valid_corpus.batches(bs, rng_np, augment=cfg.n_aug > 1,
                                          jitter=False)
        gen = torch.Generator().manual_seed(cfg.seed + 2)
        t0 = time.time()
        ve = max(1, int(cfg.valid_every))
        pending = []  # (step, device metrics, elapsed) between validations
        dev = self.device

        def _host_feed():
            # the valid batch is drawn only on steps that validate, so the
            # shared RNG advances as in the inline loop
            for i in range(n_steps):
                tb = to_device(next(train_iter), dev, cfg.prefetch > 0)
                vb = (to_device(next(valid_iter), dev, cfg.prefetch > 0)
                      if (i % ve == 0 or i == n_steps - 1) else None)
                yield tb, vb

        feed = _host_feed()
        if cfg.prefetch > 0:
            feed = _PrefetchFeed(feed, cfg.prefetch)
        try:
            self._fit_loop(feed, gen, t0, pending, verbose)
        finally:
            if isinstance(feed, _PrefetchFeed):
                feed.close()
            self._join_save()  # checkpoints are on disk when fit returns
        return self.lowest_error

    def _fit_loop(self, feed, gen, t0, pending, verbose: bool) -> None:
        cfg = self.cfg
        for i, (batch, vbatch) in enumerate(feed):
            metrics = self.train_step(
                self._model if self.mesh is None else self.rank_models,
                self.opt_state, batch, gen)
            pending.append((self.step, metrics, time.time() - t0))
            if vbatch is None:
                self.step += 1
                continue
            model = self.model
            vmetrics = self.eval_step(model, vbatch)
            e = float(self._agreed(vmetrics["mean_error"]))
            if i == 0 and self.restored:
                # restoreVariables: the first validation error of a resumed
                # run seeds the best so far (UnMicst1-5.py:513-517)
                self.lowest_error = e
            errors = [float(x) for x in self._agreed(vmetrics["errors"]).cpu()]
            for s, m, el in pending:
                rec = {"step": s, "loss": float(m["loss"]),
                       "ce": float(m["ce"]), "reg": float(m["reg"]),
                       "elapsed_s": el}
                if s == self.step:
                    rec["valid_error"] = e
                    rec["errors"] = errors
                self._log(rec)
            if self._tb_train:
                # train scalars at their own steps (every 20, :490,507)
                for s, m, _ in pending:
                    if s % 20 == 0:
                        self._tb_train.add_scalar(
                            "avg_cross_entropy", float(m["loss"]), s)
                        self._tb_train.add_scalar(
                            "learning_rate",
                            cfg.lr0 * cfg.decay_rate ** (s // cfg.decay_steps),
                            s)
                if self.step % 20 == 0 or cfg.valid_every > 20:
                    for k, err in enumerate(errors):
                        self._tb_valid.add_scalar(
                            f"avg_pixel_error_{k}", float(err), self.step)
                    self._tb_valid.add_scalar("mean_error", e, self.step)
                    if self._panel_fn is not None:
                        for w, b in ((self._tb_train, batch),
                                     (self._tb_valid, vbatch)):
                            for tag, arr in self._panel_fn(
                                    model,
                                    b["image"].permute(0, 2, 3, 1)).items():
                                for j in range(arr.shape[0]):
                                    w.add_image(f"{tag}/{j}", arr[j],
                                                self.step, dataformats="HWC")
            pending.clear()
            if verbose:
                print(f"step {self.step:05d}, e: {e:f}")
            if self.step % cfg.ckpt_every == 0 and e < self.lowest_error:
                self.lowest_error = e
                self.save()
            self.step += 1

    def save(self) -> None:
        """The native checkpoint and the reference's sidecars
        (``UnMicst1-5.py:289-290,527``).  With ``cfg.async_save`` a thread
        writes it from an on-device snapshot while training goes on;
        writes are ordered, and a failure re-raises at the next save,
        :meth:`close` or the end of :meth:`fit`."""
        params, opt_state = self.params, self._full_opt_state()
        if self.mesh is not None and self.mesh.process != 0:
            return  # process 0 alone writes
        if not self.cfg.async_save:
            self._write_checkpoint(params, opt_state, self.step,
                                   self.lowest_error)
            return
        state = ({k: v.detach().clone() for k, v in params.items()},
                 opt_state.clone(), self.step, self.lowest_error)
        self._join_save()

        def _worker():
            try:
                self._write_checkpoint(*state)
            except BaseException as e:  # noqa: BLE001 — re-raised at join
                self._save_error = e

        self._save_thread = threading.Thread(target=_worker, daemon=True)
        self._save_thread.start()

    def _join_save(self) -> None:
        """Wait for an in-flight async save; re-raise its failure."""
        t = self._save_thread
        if t is not None:
            t.join()
            self._save_thread = None
        if self._save_error is not None:
            e, self._save_error = self._save_error, None
            raise e

    def _write_checkpoint(self, params: State, opt_state: OptState,
                          step: int, lowest_error: float) -> None:
        hp, cfg = self.hp, self.cfg
        os.makedirs(self.model_path, exist_ok=True)
        host = {k: v.detach().cpu() for k, v in params.items()}
        # step + 1: the step a resumed run continues at (the save comes
        # before the loop's increment); the optimizer state rides along
        # (the reference Saver restores the slots, UnMicst1-5.py:445-447)
        save_native(os.path.join(self.model_path, NATIVE_FILE),
                    params_to_jax(host, hp, cfg.variant), hp, cfg.variant,
                    cfg.dataset_mean, cfg.dataset_std,
                    extra={"step": step + 1, "valid_error": lowest_error},
                    extra_arrays={"opt_state": self.tx.state_dict(
                        opt_state, hp, cfg.variant)})
        save_pickle(hp.to_ref_dict(), os.path.join(self.model_path, "hp.data"))
        save_pickle(cfg.dataset_mean,
                    os.path.join(self.model_path, "datasetMean.data"))
        save_pickle(cfg.dataset_std,
                    os.path.join(self.model_path, "datasetStDev.data"))
        if cfg.export_tf1:
            # a bundle the reference tool restores, and the Saver's file
            save_tf1_params(os.path.join(self.model_path, "model.ckpt"), host,
                            hp, cfg.variant, global_step=step + 1)
            with open(os.path.join(self.model_path, "checkpoint"), "w") as f:
                f.write('model_checkpoint_path: "model.ckpt"\n')
                f.write('all_model_checkpoint_paths: "model.ckpt"\n')

    def close(self) -> None:
        """Join any in-flight save, then flush and close the metrics and
        TensorBoard sinks (``UnMicst1-5.py:530-532``)."""
        self._join_save()
        if self._metrics_file:
            self._metrics_file.close()
            self._metrics_file = None
        for w in (self._tb_train, self._tb_valid):
            if w is not None:
                w.flush()
                w.close()
        self._tb_train = self._tb_valid = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def restore(self, path: Optional[str] = None) -> None:
        """Resume from a native checkpoint of either package
        (``restoreVariables``, ``UnMicst1-5.py:445-447``): params, step,
        and the optimizer slots with the schedule's count."""
        self._join_save()  # never read a checkpoint mid-write
        path = path or os.path.join(self.model_path, NATIVE_FILE)
        params, hp, variant, _, _, meta = load_native(path)
        if hp != self.hp or variant != self.cfg.variant:
            raise ValueError("checkpoint hp/variant mismatch")
        state = params_from_jax(params, hp, variant)
        self.step = int(meta.get("step", 0))
        saved = meta.get("_extra_arrays", {}).get("opt_state")
        if self.mesh is None:
            self._model.load_state_dict(state)
            if saved is not None:
                self.opt_state = self.tx.load_state_dict(saved, self._model,
                                                         hp, variant)
            else:
                # an old checkpoint without slots: the schedule goes on
                self.opt_state = self.tx.init(self._model)
                self.opt_state.count = self.step
        else:  # re-placed on the mesh, as __init__ placed them
            parts = shard_state(state, self.spec, self.mesh)
            with torch.no_grad():
                for m, part in zip(self.rank_models, parts):
                    for name, t in m.state_dict().items():
                        t.copy_(part[name])
            if saved is not None:
                full = self.tx.load_state_dict(saved, UNet(hp, variant), hp,
                                               variant)
                slots = {k: shard_state(v, self.spec, self.mesh)
                         for k, v in full.slots.items()}
                self.opt_state = [OptState(full.count,
                                           {k: slots[k][r] for k in slots})
                                  for r in range(len(self.rank_models))]
            else:
                self.opt_state = [self.tx.init(m) for m in self.rank_models]
                for st in self.opt_state:
                    st.count = self.step
        self.restored = True


def render_test_montages(params, hp: HParams, cfg: TrainConfig,
                         corpus: Corpus, pm_path: str,
                         classes: Optional[Dict[str, int]] = None) -> None:
    """Post-train test rendering (``UnMicst1-5.py:553-579``): per
    augmentation page, PNGs ``I%05d_%d_{Nuc,Con}.png`` of
    ``[sqrt(normalised image) | probability map | ground truth]``; legacy
    naming (``UnMicst.py:400-405``) with ``classes={'': index}``.
    ``params``: a ``UNet`` or a state dict, on the device to run on."""
    from unmicst_tpu_torch.io.png import write_png

    if classes is None:
        classes = {"Nuc": 2, "Con": 1}
    os.makedirs(pm_path, exist_ok=True)
    model = _as_model(params, hp, cfg.variant)
    dev = model.top.kernel.device
    for a in range(corpus.images.shape[3]):
        x = corpus.images[:, :, :, a, :]  # (n, S, S, C)
        with torch.no_grad(), precision_flags(cfg):
            probs = model(torch.from_numpy(np.ascontiguousarray(x)).to(dev))
        probs = probs.cpu().numpy()
        for i in range(corpus.n):
            im = x[i, :, :, 0]
            lo, hi = im.min(), im.max()
            norm = np.sqrt((im - lo) / (hi - lo)) if hi > lo else im * 0
            for suffix, cls in classes.items():
                montage = np.concatenate(
                    [norm, probs[i, :, :, cls], corpus.labels[i, :, :, cls]],
                    axis=1)
                name = (f"I{i + 1:05d}_{a}_{suffix}.png" if suffix
                        else f"I{i + 1:05d}.png")
                write_png(os.path.join(pm_path, name),
                          np.uint8(255 * np.clip(montage, 0, 1)))
