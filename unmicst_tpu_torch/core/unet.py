"""Inference residual UNet2D in PyTorch — both reference generations.

The counterpart of ``unmicst_tpu/core/unet.py`` (``apply`` at
``unet.py:397-559``), written as an ``nn.Module`` over NCHW activations.
The public :meth:`UNet.forward` keeps the JAX layout, NHWC in and NHWC
out, so the two packages compare like with like; the engine calls
:meth:`UNet.forward_nchw` on tiles it already holds in NCHW.

Topology (``UnMicst.py:120-187``)::

    for i in 0..nLayers-1:              # down_samp_layer
        c = conv_ks(x); for extras: c = conv_ks(act(c))
        s = conv(x)                     # 1x1 (legacy) | ks x ks (v2)
        y = legacy: BN(act(c+s)) | v2: act(BN(c+s))
        skip[i] = x;  x = maxpool2(y)
    b = legacy: act(conv_ks(x)) | v2: act(BN(conv_ks(x)))
    for i = nLayers-1..0:               # up_samp_layer
        u  = act(conv_transpose_ks(b, stride 2))
        b  = legacy: act(conv_ks([skip[i], u])) | v2: act(BN(conv_ks(...)))
        for extras: b = act(conv_ks(b))
    t = conv_1x1(b); v2: t = BN(t)
    out = softmax(t, channel)

BN runs in inference mode with TF's epsilon.  Legacy BN comes after the
activation and before the max-pool (``unet.py:499-500``), so it cannot be
folded into the conv weights (a negative gamma does not commute with the
max); only the v2 BN, which precedes the activation, could be.  The
inference residual fold (``_fuse_residual``, ``unet.py:379-394``) is
applied exactly where the JAX package applies it: no extra convs.

Training mode (``train=True``, ``unet.py:242-277,397-559``) normalises
with the batch statistics and returns the moving statistics' update
beside the output instead of writing it, so a recomputed forward
(``torch.utils.checkpoint``) cannot apply it twice; inverted dropout
draws from an explicit ``torch.Generator`` (none: dropout off, BN still
in batch mode, the contract of the trajectory oracles); the residual
fold is not applied (the two kernels keep separate gradients and
regularizers).  :func:`regularization_loss` and :func:`init_params` are
the JAX module's, over ``state_dict`` names and a ``torch.Generator``.

Weights live in PyTorch's layouts: conv kernels OIHW, transposed-conv
kernels ``[in, out, ks, ks]``.  The BN moving statistics are buffers, so
``UNet.parameters()`` is exactly the set the optimizer trains.
:func:`unmicst_tpu_torch.core.checkpoint.params_from_jax` converts the JAX
params pytree into this module's state.

:func:`train_forward_ranks` is the training forward over the ranks of a
``(data, model)`` mesh that one process holds (``unmicst_tpu/core/unet.py``
under a mesh): each rank's batch slice, the layers whose output channels
are split over ``model`` computed slice by slice and gathered before the
next layer that reads every channel, BN statistics of the global batch.

Inference takes a calibration ``tap(site, h)`` and an int8 ``quant`` state
(``core/quant.py``) at every plain conv site, as ``apply``'s
``site_conv`` does (``unet.py:405-463``): a site in the state runs
:func:`quant_conv`, an exact s8 x s8 -> s32 ``torch._int_mm`` over an
im2col.  The site names are the contract with ``quant.conv_sites``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from unmicst_tpu_torch.core.hp import HParams

BN_EPS = 1e-3  # tf.layers.batch_normalization default
BN_MOMENTUM = 0.99
LEAKY_ALPHA = 0.2  # tf.nn.leaky_relu default


@dataclasses.dataclass(frozen=True)
class VariantConfig:
    """Per-tool architecture and training deltas
    (``unmicst_tpu/core/unet.py:61-102``): the four tools share two
    inference graphs; dropout and regularizers are training-only."""

    name: str
    legacy: bool
    dropout_bottom: float = 0.0
    dropout_down_per_layer: float = 0.0  # rate = c * layer_index
    dropout_up_base: float = 0.0  # rate = base - c * layer_index
    dropout_up_per_layer: float = 0.0
    reg_kind: str = "none"  # 'none' | 'l1' | 'l2'
    reg_down: float = 0.0
    reg_up: float = 0.0  # also top


VARIANTS = {
    # UnMicst.py / batch*.py
    "legacy": VariantConfig("legacy", legacy=True),
    # UnMicst1-5.py (:84 L1 8e-5, :139 dropout .35)
    "v2": VariantConfig("v2", legacy=False, dropout_bottom=0.35,
                        reg_kind="l1", reg_down=8e-5, reg_up=8e-5),
    # UnMicst2.py (:82 L2 .01, :114 dropout .05*i, :137 dropout .3,
    #             :158 L2 .005, :203 dropout .25-.05*i)
    "duo": VariantConfig("duo", legacy=False, dropout_bottom=0.3,
                         dropout_down_per_layer=0.05, dropout_up_base=0.25,
                         dropout_up_per_layer=0.05, reg_kind="l2",
                         reg_down=0.01, reg_up=0.005),
    # UnMicstCyto2.py (:79,155 L2 1e-5, :134 dropout .2)
    "cyto2": VariantConfig("cyto2", legacy=False, dropout_bottom=0.2,
                           reg_kind="l2", reg_down=1e-5, reg_up=1e-5),
}


def get_variant(name: str) -> VariantConfig:
    return VARIANTS[name]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (``tf.layers.dropout``, ``unet.py:269-275``): keep
    with probability ``1 - rate`` (uniform draws from ``generator`` on
    ``x``'s device), scale the kept by ``1 / (1 - rate)``; off when the
    rate is 0 or there is no generator."""
    if rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


# bytes of int8 im2col one ``torch._int_mm`` call takes: quant_conv cuts
# the tiles of a batch into groups whose im2col stays under it
IM2COL_BUDGET = 1 << 28


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def weight_matrix(w8: torch.Tensor) -> torch.Tensor:
    """OIHW int8 kernel -> the ``[Kp, Np]`` second operand of
    ``torch._int_mm``: the kernel flattened to ``[cout, cin * kh * kw]``
    (K in ``(cin, kh, kw)`` order, the im2col's), zero-padded to multiples
    of 8 in both dimensions (zero rows and columns add nothing to a sum),
    and viewed transposed, so the operand is column-major: the layout
    cuBLASLt's int8 product takes."""
    n, k = w8.shape[0], w8[0].numel()
    mat = torch.zeros((_round8(n), _round8(k)), dtype=torch.int8,
                      device=w8.device)
    mat[:n, :k] = w8.reshape(n, k)
    return mat.t()


def quantize_input(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """NCHW activations -> int8 ``clamp(round(x / a[cin]), -127, 127)``.
    It divides as the JAX engine does (the state is a jit argument there,
    so XLA divides) and rounds half to even, as XLA does."""
    x8 = torch.clamp(torch.round(x.float() / a[:, None, None]), -127, 127)
    return x8.to(torch.int8)


def int8_conv(x8: torch.Tensor, mat: torch.Tensor, ks: int, emit) -> None:
    """The exact s8 x s8 -> s32 SAME conv of int8 NCHW ``x8`` with the
    kernel ``mat`` (:func:`weight_matrix`), tiles in groups: for each group
    of tiles ``[b0, b0 + g)`` calls ``emit(b0, s32)`` with its int32 sums
    ``[g, H, W, Np]`` (a view into a buffer the next group reuses).

    The im2col is ``Tensor.unfold`` of the zero-padded int8 tensor, rows
    ``(b, h, w)`` and K ``(cin, kh, kw)`` padded to a multiple of 8, the
    product ``torch._int_mm``: its int32 sums are exact for any K (at
    most 127^2 a term), like XLA's int8 convolution.  A group's im2col
    stays under ``IM2COL_BUDGET`` bytes.  On a CUDA tensor the product is
    ``_int_mm`` or an error: there is no float fallback."""
    b, c, h, w = x8.shape
    kp, n_pad = mat.shape
    k = c * ks * ks
    p = ks // 2
    xp = F.pad(x8, (p, p, p, p))
    # [B, H, W, C, kh, kw] strided view of the padded tensor, no copy
    cols = xp.unfold(2, ks, 1).unfold(3, ks, 1).permute(0, 2, 3, 1, 4, 5)
    group = max(1, min(b, IM2COL_BUDGET // (h * w * kp)))
    # one buffer for every group; its K padding stays zero.  _int_mm on
    # the card takes more than 16 rows: the rows past a group's are
    # computed and dropped
    buf = (torch.empty if kp == k else torch.zeros)(
        (max(group * h * w, 17), kp), dtype=torch.int8, device=x8.device)
    for b0 in range(0, b, group):
        g = min(b, b0 + group) - b0
        m = g * h * w
        buf[:m].view(g, h, w, kp)[..., :k].view(g, h, w, c, ks, ks).copy_(
            cols[b0 : b0 + g])
        s32 = torch._int_mm(buf[: max(m, 17)], mat)
        emit(b0, s32[:m].view(g, h, w, n_pad))


def quant_conv(x: torch.Tensor, qk: Dict[str, torch.Tensor],
               a: torch.Tensor) -> torch.Tensor:
    """int8 SAME conv of NCHW ``x``, dequantized to float32 NCHW
    (``unet.quant_conv``, ``unet.py:192-224``).

    ``a``: the site's per-input-channel activation scales; ``qk["w8"]``
    (OIHW int8) quantizes ``a[cin] * W`` per output channel with scales
    ``qk["w_scale"]``, so the int32 sums of :func:`int8_conv` approximate
    ``conv(x, W)`` after one multiply per output channel, then
    ``qk["bias"]`` when there is one.  ``qk["w8_mat"]``, when present, is
    ``weight_matrix(qk["w8"])`` made once (``quant.to_device``)."""
    w8 = qk["w8"]
    mat = qk.get("w8_mat")
    if mat is None:
        mat = weight_matrix(w8)
    b, _, h, w = x.shape
    n = w8.shape[0]
    y = torch.empty((b, n, h, w), dtype=torch.float32, device=x.device)
    scale = qk["w_scale"][:, None, None]
    bias = qk.get("bias")

    def dequantize(b0, s32):
        out = y[b0 : b0 + s32.shape[0]]
        torch.mul(s32[..., :n].permute(0, 3, 1, 2), scale, out=out)
        if bias is not None:
            out.add_(bias[:, None, None])

    int8_conv(quantize_input(x, a), mat, w8.shape[-1], dequantize)
    return y


def quant_conv_sums(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """The int32 sums ``[B, cout, H, W]`` of :func:`int8_conv` for int8
    NCHW ``x8`` and OIHW ``w8``: what ``quant_conv`` dequantizes, for
    holding the product against an exact reference."""
    b, _, h, w = x8.shape
    n = w8.shape[0]
    out = torch.empty((b, n, h, w), dtype=torch.int32, device=x8.device)

    def keep(b0, s32):
        out[b0 : b0 + s32.shape[0]].copy_(s32[..., :n].permute(0, 3, 1, 2))

    int8_conv(x8, weight_matrix(w8), w8.shape[-1], keep)
    return out


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


class BatchNorm(nn.Module):
    """Inference batch norm with moving statistics (TF epsilon), applied
    as the folded ``x * scale + bias`` of ``unet.py:235-239``; the moving
    statistics are buffers (no gradient, no optimizer slot in use)."""

    def __init__(self, width: int):
        super().__init__()
        self.gamma = _param(width)
        self.beta = _param(width)
        self.register_buffer("moving_mean", torch.zeros(width))
        self.register_buffer("moving_variance", torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.gamma * torch.rsqrt(self.moving_variance + BN_EPS)
        bias = self.beta - self.moving_mean * scale
        return x.float() * scale[:, None, None] + bias[:, None, None]

    def train_forward(self, x: torch.Tensor):
        """``bn_train`` (``unet.py:242-266``): normalise with the *biased*
        batch variance; the moving variance takes the Bessel-corrected
        one.  Returns ``(y, (moving_mean, moving_variance))``, the new
        statistics computed, not stored."""
        x = x.float()
        y = F.batch_norm(x, None, None, self.gamma, self.beta, training=True,
                         eps=BN_EPS)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            n = x.shape[0] * x.shape[2] * x.shape[3]
            uvar = var * (n / max(n - 1, 1))
            new = (self.moving_mean * BN_MOMENTUM + mean * (1 - BN_MOMENTUM),
                   self.moving_variance * BN_MOMENTUM
                   + uvar * (1 - BN_MOMENTUM))
        return y, new


class DownLayer(nn.Module):
    def __init__(self, cin: int, cout: int, ks: int, n_extra: int,
                 legacy: bool):
        super().__init__()
        self.kernel1 = _param(cout, cin, ks, ks)
        self.extra = nn.ParameterList(
            [_param(cout, cout, ks, ks) for _ in range(n_extra)]
        )
        sk = 1 if legacy else ks
        self.shortcut = _param(cout, cin, sk, sk)
        self.bn = BatchNorm(cout)


class Bottom(nn.Module):
    def __init__(self, cin: int, cout: int, ks: int, legacy: bool):
        super().__init__()
        self.kernel1 = _param(cout, cin, ks, ks)
        self.bn = None if legacy else BatchNorm(cout)


class UpLayer(nn.Module):
    def __init__(self, w_skip: int, w_out: int, w_in: int, ks: int,
                 n_extra: int, legacy: bool):
        super().__init__()
        self.kernel1 = _param(w_in, w_out, ks, ks)  # transposed conv
        self.kernel2 = _param(w_out, w_skip + w_out, ks, ks)
        self.extra = nn.ParameterList(
            [_param(w_out, w_out, ks, ks) for _ in range(n_extra)]
        )
        self.bn = None if legacy else BatchNorm(w_out)


class Top(nn.Module):
    def __init__(self, cin: int, n_classes: int, legacy: bool):
        super().__init__()
        self.kernel = _param(n_classes, cin, 1, 1)
        self.bn = None if legacy else BatchNorm(n_classes)


class UNet(nn.Module):
    """Inference UNet for one (hp, variant).

    ``compute_dtype=torch.bfloat16`` runs every convolution on bf16
    inputs and weights with float32 accumulation and output; BN,
    activations and the logits stay float32 (the JAX bf16 mode,
    ``unet.py:421-422``).  ``None`` runs float32.
    """

    def __init__(self, hp: HParams, variant: str = "legacy",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg = get_variant(variant)
        self.hp, self.variant, self.legacy = hp, variant, cfg.legacy
        self.compute_dtype = compute_dtype
        w, ks, nx = hp.n_out_x, hp.ks, hp.n_extra_convs
        self.down = nn.ModuleList(
            [DownLayer(w[i], w[i + 1], ks, nx, cfg.legacy)
             for i in range(hp.n_layers)]
        )
        self.bottom = Bottom(w[hp.n_layers], w[hp.n_layers + 1], ks,
                             cfg.legacy)
        # up[i] is the reference's lu{i} (stored by index, run in reverse)
        self.up = nn.ModuleList(
            [UpLayer(w[i], w[i + 1], w[i + 2], ks, nx, cfg.legacy)
             for i in range(hp.n_layers)]
        )
        self.top = Top(w[1], hp.n_classes, cfg.legacy)

    # -- primitives ---------------------------------------------------------

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        if self.legacy:
            return F.relu(x)
        return F.leaky_relu(x, LEAKY_ALPHA)

    def _operands(self, x: torch.Tensor, k: torch.Tensor):
        """Conv operands as float32; in bfloat16 mode rounded to bfloat16
        first.  A product of two bfloat16 values is exact in float32, so a
        float32 conv of the rounded operands is the JAX mode's bf16 inputs
        with float32 accumulation and a float32 output
        (``preferred_element_type``, ``unet.py:158-161,185-189``).  A bf16
        conv in PyTorch would round its output to bf16 as well."""
        dt = self.compute_dtype
        if dt is None:
            return x.float(), k
        return x.to(dt).float(), k.to(dt).float()

    def _conv(self, x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """SAME conv, stride 1 (odd kernels: symmetric padding)."""
        x, k = self._operands(x, k)
        return F.conv2d(x, k, padding=k.shape[-1] // 2)

    def _conv_transpose(self, x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """``tf.nn.conv2d_transpose`` with SAME padding, stride
        ``down_samp_fact``: the full transposed output cropped from
        ``max(ks - stride, 0) // 2`` to ``in * stride``."""
        x, k = self._operands(x, k)
        s = self.hp.down_samp_fact
        before = max(k.shape[-1] - s, 0) // 2
        y = F.conv_transpose2d(x, k, stride=s, padding=before)
        return y[:, :, : x.shape[2] * s, : x.shape[3] * s]

    @staticmethod
    def _fused_residual(layer: DownLayer) -> Optional[torch.Tensor]:
        """``_fuse_residual`` (``unet.py:379-394``): with no extra convs,
        ``conv(h, K1) + conv(h, Ks) == conv(h, K1 + Ks)``; a 1x1 legacy
        shortcut embeds at the centre tap of the odd kernel."""
        if len(layer.extra):
            return None
        k1, ks = layer.kernel1, layer.shortcut
        if k1.shape == ks.shape:
            return k1 + ks
        kh, kw = k1.shape[-2:]
        if ks.shape[-2:] == (1, 1) and kh % 2 and kw % 2:
            fused = k1.clone()
            fused[:, :, kh // 2, kw // 2] += ks[:, :, 0, 0]
            return fused
        return None

    def _train_conv(self, x: torch.Tensor, k: torch.Tensor,
                    dtype: Optional[torch.dtype]) -> torch.Tensor:
        """The training conv (``grad_safe``, ``unet.py:137-161``): in
        bfloat16 a bf16 convolution whose bf16 output is upcast, so its
        gradient flows back in bf16 too; float32 as is."""
        if dtype is None:
            return F.conv2d(x, k, padding=k.shape[-1] // 2)
        return F.conv2d(x.to(dtype), k.to(dtype),
                        padding=k.shape[-1] // 2).float()

    def _train_conv_transpose(self, x: torch.Tensor, k: torch.Tensor,
                              dtype: Optional[torch.dtype]) -> torch.Tensor:
        s = self.hp.down_samp_fact
        before = max(k.shape[-1] - s, 0) // 2
        if dtype is not None:
            x, k = x.to(dtype), k.to(dtype)
        y = F.conv_transpose2d(x, k, stride=s, padding=before)
        return y[:, :, : x.shape[2] * s, : x.shape[3] * s].float()

    # -- forward ------------------------------------------------------------

    def forward_nchw(self, x: torch.Tensor, return_logits: bool = False,
                     train: bool = False,
                     generator: Optional[torch.Generator] = None,
                     compute_dtype: Optional[torch.dtype] = None,
                     tap=None, quant=None, level0=None):
        """``x``: [B, C, S, S] float -> [B, K, S, S] float32 softmax (or
        logits with ``return_logits``).

        ``tap``: ``tap(site, h)`` is called with each plain conv's input
        (calibration).  ``quant``: a ``core.quant`` QuantState; a conv whose
        site is in ``quant["kernels"]`` runs :func:`quant_conv`; inference
        only.

        ``train=True`` returns ``(out, new_stats)``: BN in batch mode,
        ``new_stats`` the moving statistics' update as ``{state_dict
        name: tensor}`` (the module is left unchanged); dropout draws from
        ``generator`` (on ``x``'s device), off when it is None;
        ``compute_dtype`` (bfloat16 or None) is the training convs' dtype.
        Inference ignores ``generator`` and ``compute_dtype`` and runs in
        the module's own ``compute_dtype``.

        ``level0``: inference only, another form of the full-resolution
        level (``core/s2d.py``'s packed one): ``level0.down(x)`` gives
        level 1's input, ``level0.up(h)`` the top conv's input from what
        level 1 gives back; the inner levels, the bottom and the top run
        as they do here."""
        if quant is not None and train:
            raise ValueError("quantized forward is inference-only")
        if level0 is not None and (train or quant is not None
                                  or tap is not None):
            raise ValueError("a replaced level 0 is plain inference only")
        hp = self.hp
        s = x.shape[-1]
        for _ in range(hp.n_layers):
            if s % hp.down_samp_fact:
                raise NotImplementedError(
                    f"spatial size {x.shape[-1]} not divisible by "
                    f"down_samp_fact^n_layers "
                    f"({hp.down_samp_fact}^{hp.n_layers})"
                )
            s //= hp.down_samp_fact
        cfg = get_variant(self.variant)
        act = self._act
        new_stats: Dict[str, torch.Tensor] = {}
        if train:
            def conv(h, k):
                return self._train_conv(h, k, compute_dtype)

            def conv_t(h, k):
                return self._train_conv_transpose(h, k, compute_dtype)

            def bn(h, mod: BatchNorm, name: str):
                h, (mean, var) = mod.train_forward(h)
                new_stats[f"{name}.moving_mean"] = mean
                new_stats[f"{name}.moving_variance"] = var
                return h

            def drop(h, rate):
                return dropout(h, rate, generator)
        else:
            conv, conv_t = self._conv, self._conv_transpose

            def bn(h, mod: BatchNorm, name: str):
                return mod(h)

            def drop(h, rate):
                return h

        def site_conv(h, site, k):
            """A plain conv with the calibration tap and int8 execution."""
            if tap is not None:
                tap(site, h)
            if quant is not None and site in quant["kernels"]:
                return quant_conv(h, quant["kernels"][site],
                                  quant["scales"][site])
            return conv(h, k)

        skips = []
        h = x
        for i, layer in enumerate(self.down):
            skips.append(h)
            if i == 0 and level0 is not None:
                h = level0.down(h)
                continue
            fused = None if train else self._fused_residual(layer)
            if fused is not None:
                pre = site_conv(h, f"down{i}", fused)
            else:
                c = site_conv(h, f"down{i}.k1", layer.kernel1)
                for j, ke in enumerate(layer.extra):
                    c = site_conv(act(c), f"down{i}.extra{j}", ke)
                pre = c + site_conv(h, f"down{i}.short", layer.shortcut)
            if self.legacy:
                y = bn(act(pre), layer.bn, f"down.{i}.bn")  # UnMicst.py:99
            else:
                y = act(bn(pre, layer.bn, f"down.{i}.bn"))  # UnMicst1-5.py:114
                y = drop(y, cfg.dropout_down_per_layer * i)
            h = F.max_pool2d(y, hp.down_samp_fact)

        b = site_conv(h, "bottom", self.bottom.kernel1)
        if self.legacy:
            h = act(b)
        else:
            h = drop(act(bn(b, self.bottom.bn, "bottom.bn")),
                     cfg.dropout_bottom)
        for i in reversed(range(hp.n_layers)):
            if i == 0 and level0 is not None:
                h = level0.up(h)
                continue
            layer = self.up[i]
            u = act(conv_t(h, layer.kernel1))
            # skip FIRST (UnMicst.py:156)
            cv = site_conv(torch.cat([skips[i].to(u.dtype), u], dim=1),
                           f"up{i}.k2", layer.kernel2)
            cv = act(cv) if self.legacy else act(bn(cv, layer.bn,
                                                    f"up.{i}.bn"))
            for j, ke in enumerate(layer.extra):
                cv = act(site_conv(cv, f"up{i}.extra{j}", ke))
            if not self.legacy and cfg.dropout_up_base > 0:
                cv = drop(cv, cfg.dropout_up_base
                          - cfg.dropout_up_per_layer * i)
            h = cv

        t = conv(h, self.top.kernel)
        if not self.legacy:
            t = bn(t, self.top.bn, "top.bn")
        t = t.float()
        out = t if return_logits else torch.softmax(t, dim=1)
        return (out, new_stats) if train else out

    def forward(self, x: torch.Tensor, return_logits: bool = False,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                compute_dtype: Optional[torch.dtype] = None,
                tap=None, quant=None):
        """``x``: [B, S, S, C] -> [B, S, S, K] (the JAX ``apply`` layout);
        with ``train=True``, ``(probs, new_stats)`` as in
        :meth:`forward_nchw`.  ``tap`` sees NCHW site inputs."""
        y = self.forward_nchw(x.permute(0, 3, 1, 2), return_logits, train,
                              generator, compute_dtype, tap, quant)
        if train:
            return y[0].permute(0, 2, 3, 1), y[1]
        return y.permute(0, 2, 3, 1)


def module_from_state(hp: HParams, variant: str, state: Dict[str,
                      torch.Tensor]) -> UNet:
    """A :class:`UNet` whose parameters and buffers are ``state``'s
    tensors as they are, of any shapes: a mesh rank's module, holding its
    shards of the split parameters."""
    model = UNet(hp, variant)
    for name, t in state.items():
        path, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(path)
        if leaf in mod._parameters:
            mod._parameters[leaf] = nn.Parameter(t)
        elif leaf in mod._buffers:
            mod._buffers[leaf] = t
        else:
            raise KeyError(f"{name} is no parameter or buffer of the UNet")
    return model


def regularization_loss(model: UNet, keep=None) -> torch.Tensor:
    """Kernel regularization (``unet.py:562-586``): L1 for v2, L2 for duo
    and cyto2, none for legacy, on the reference's ``tf.get_variable``
    kernels only (shortcut, bottom, up, top; the main down kernel and the
    extra convs carry none, ``UnMicst1-5.py:84,94-97,171-174``).
    ``keep(name)``: only the kernels whose ``state_dict`` name it accepts."""
    cfg = get_variant(model.variant)
    dev = model.top.kernel.device
    if cfg.reg_kind == "none":
        return torch.zeros((), device=dev)
    f = (lambda k: k.abs().sum()) if cfg.reg_kind == "l1" else (
        lambda k: k.square().sum())
    terms = [(f"down.{i}.shortcut", cfg.reg_down, layer.shortcut)
             for i, layer in enumerate(model.down)]
    terms.append(("bottom.kernel1", cfg.reg_down, model.bottom.kernel1))
    for i, layer in enumerate(model.up):
        terms.append((f"up.{i}.kernel1", cfg.reg_up, layer.kernel1))
        terms.append((f"up.{i}.kernel2", cfg.reg_up, layer.kernel2))
    terms.append(("top.kernel", cfg.reg_up, model.top.kernel))
    total = torch.zeros((), device=dev)
    for name, c, k in terms:
        if keep is None or keep(name):
            total = total + c * f(k)
    return total


def train_forward_ranks(models, xs, ops, generator=None, compute_dtype=None):
    """The training forward of this process's ranks of a mesh: ``models[k]``
    holds local rank ``k``'s parameters (its shards of the split ones),
    ``xs[k]`` its NCHW batch slice.  Returns ``(probs, new_stats)``, one
    ``[B_k, K, S, S]`` softmax and one moving-statistics update (its
    shards' names) per rank.

    ``ops`` carries the mesh: ``sharded(name)`` (a parameter split over
    ``model``), ``global_batch``, ``batch_slice(k)`` and
    ``channel_slice(k, c)`` (rank ``k``'s rows of the global batch and its
    share of ``c`` channels), and the collectives ``sum_data`` (the
    differentiable sum over ``data``), ``gather`` (the slices over
    ``model``, concatenated on channels; backward: the own slice) and
    ``copy`` (the identity; backward: the sum over ``model``).

    A layer whose output channels are split runs its convs on each rank's
    slice of them, after ``copy`` of its input; BN, the activation,
    dropout and max-pool run on the slice; ``gather`` then restores every
    channel.  BN normalises with the global batch's statistics: the sum,
    then the centred sum of squares, each reduced over ``data`` (two
    passes, as ``torch.var_mean``); the moving variance takes the
    Bessel-corrected one.  Dropout draws one mask of the global batch per
    site from ``generator`` (on its device, in the single forward's order)
    and gives each rank its slice, so the masks are the single step's."""
    m0 = models[0]
    hp, cfg, legacy = m0.hp, get_variant(m0.variant), m0.legacy
    act = m0._act
    n = len(models)
    new_stats = [dict() for _ in range(n)]

    def each(fn, *lists):
        return [fn(*args) for args in zip(*lists)]

    def conv(hs, ks):
        return [m0._train_conv(h, k, compute_dtype) for h, k in zip(hs, ks)]

    def conv_t(hs, ks):
        return [m0._train_conv_transpose(h, k, compute_dtype)
                for h, k in zip(hs, ks)]

    def bn(hs, mods, name):
        xs32 = [h.float() for h in hs]
        count = ops.global_batch * xs32[0].shape[2] * xs32[0].shape[3]
        sums = ops.sum_data([x.sum(dim=(0, 2, 3)) for x in xs32])
        means = [t / count for t in sums]
        sq = ops.sum_data([(x - mu[:, None, None]).square().sum(dim=(0, 2, 3))
                           for x, mu in zip(xs32, means)])
        out = []
        for k, (x, mu, q, mod) in enumerate(zip(xs32, means, sq, mods)):
            var = q / count
            y = ((x - mu[:, None, None]) * torch.rsqrt(var + BN_EPS)[
                :, None, None] * mod.gamma[:, None, None]
                 + mod.beta[:, None, None])
            with torch.no_grad():
                uvar = var * (count / max(count - 1, 1))
                new_stats[k][f"{name}.moving_mean"] = (
                    mod.moving_mean * BN_MOMENTUM + mu * (1 - BN_MOMENTUM))
                new_stats[k][f"{name}.moving_variance"] = (
                    mod.moving_variance * BN_MOMENTUM
                    + uvar * (1 - BN_MOMENTUM))
            out.append(y)
        return out

    def drop(hs, rate, split):
        if rate <= 0.0 or generator is None:
            return hs
        keep = 1.0 - rate
        c = hs[0].shape[1] * (ops.model if split else 1)
        shape = (ops.global_batch, c) + tuple(hs[0].shape[2:])
        mask = torch.rand(shape, generator=generator,
                          device=generator.device) < keep
        out = []
        for k, h in enumerate(hs):
            a, b = ops.batch_slice(k)
            ca, cb = ops.channel_slice(k, c) if split else (0, c)
            out.append(torch.where(mask[a:b, ca:cb].to(h.device), h / keep,
                                   0.0))
        return out

    def split_in(hs, split):
        return ops.copy(hs) if split else hs

    def joined(hs, split):
        return ops.gather(hs) if split else hs

    skips = []
    h = list(xs)
    for i in range(hp.n_layers):
        layers = [m.down[i] for m in models]
        split = ops.sharded(f"down.{i}.kernel1")
        skips.append(h)
        hin = split_in(h, split)
        c = conv(hin, [la.kernel1 for la in layers])
        for j in range(hp.n_extra_convs):
            a = split_in(joined(each(act, c), split), split)
            c = conv(a, [la.extra[j] for la in layers])
        pre = each(torch.add, c, conv(hin, [la.shortcut for la in layers]))
        bns = [la.bn for la in layers]
        if legacy:
            y = bn(each(act, pre), bns, f"down.{i}.bn")
        else:
            y = drop(each(act, bn(pre, bns, f"down.{i}.bn")),
                     cfg.dropout_down_per_layer * i, split)
        h = joined([F.max_pool2d(t, hp.down_samp_fact) for t in y], split)

    split = ops.sharded("bottom.kernel1")
    b = conv(split_in(h, split), [m.bottom.kernel1 for m in models])
    if legacy:
        h = each(act, b)
    else:
        h = drop(each(act, bn(b, [m.bottom.bn for m in models], "bottom.bn")),
                 cfg.dropout_bottom, split)
    h = joined(h, split)
    for i in reversed(range(hp.n_layers)):
        layers = [m.up[i] for m in models]
        split = ops.sharded(f"up.{i}.kernel1")
        u = joined(each(act, conv_t(split_in(h, split),
                                    [la.kernel1 for la in layers])), split)
        cat = [torch.cat([s.to(t.dtype), t], dim=1) for s, t in zip(skips[i],
                                                                  u)]
        split = ops.sharded(f"up.{i}.kernel2")
        cv = conv(split_in(cat, split), [la.kernel2 for la in layers])
        cv = each(act, cv) if legacy else each(
            act, bn(cv, [la.bn for la in layers], f"up.{i}.bn"))
        for j in range(hp.n_extra_convs):
            cv = split_in(joined(cv, split), split)
            cv = each(act, conv(cv, [la.extra[j] for la in layers]))
        if not legacy and cfg.dropout_up_base > 0:
            cv = drop(cv, cfg.dropout_up_base - cfg.dropout_up_per_layer * i,
                      split)
        h = joined(cv, split)

    split = ops.sharded("top.kernel")
    t = conv(split_in(h, split), [m.top.kernel for m in models])
    if not legacy:
        t = bn(t, [m.top.bn for m in models], "top.bn")
    t = joined(t, split)
    return [torch.softmax(x.float(), dim=1) for x in t], new_stats


# ``jax.nn.initializers.variance_scaling(1, "fan_in", "truncated_normal")``
# divides by the standard deviation of a unit normal truncated at +-2
_TRUNC_STD = 0.87962566103423978


def init_params(hp: HParams, variant: str = "legacy",
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` drawn like the reference initializers
    (``unet.py:283-371``): legacy kernels ``truncated_normal(stddev=
    stdDev0)`` at +-2 sigma (``UnMicst.py:82-84``); v2 keeps that for the
    main down kernel and gives every ``tf.get_variable`` kernel
    VarianceScaling fan-in (``UnMicst1-5.py:86-97``), whose fan-in is taken
    on the TF layout (``[ks, ks, out, in]`` for the transposed kernels,
    as JAX reads them); BN ``(gamma, beta, mean, var) = (1, 0, 0, 1)``.
    JAX's random stream is not reproduced, only its law."""
    legacy = get_variant(variant).legacy
    state = {}
    for name, t in UNet(hp, variant).state_dict().items():
        field = name.rsplit(".", 1)[-1]
        if field in ("gamma", "moving_variance"):
            state[name] = torch.ones(t.shape)
            continue
        if field in ("beta", "moving_mean"):
            state[name] = torch.zeros(t.shape)
            continue
        # OIHW, or [in, out, ks, ks] for a transposed kernel: the TF
        # layout's input axis is dim 1 either way
        std = hp.std_dev0
        if not legacy and not (name.startswith("down.")
                               and name.endswith(".kernel1")):
            std = math.sqrt(1.0 / (t.shape[1] * t.shape[2] * t.shape[3]))
            std /= _TRUNC_STD
        state[name] = nn.init.trunc_normal_(
            torch.empty(t.shape), 0.0, std, -2.0 * std, 2.0 * std,
            generator=generator)
    return state
