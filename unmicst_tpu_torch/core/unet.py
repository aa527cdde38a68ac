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

Weights live in PyTorch's layouts: conv kernels OIHW, transposed-conv
kernels ``[in, out, ks, ks]``.  :func:`unmicst_tpu_torch.core.checkpoint.
params_from_jax` converts the JAX params pytree into this module's state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from unmicst_tpu_torch.core.hp import HParams

BN_EPS = 1e-3  # tf.layers.batch_normalization default
LEAKY_ALPHA = 0.2  # tf.nn.leaky_relu default


@dataclasses.dataclass(frozen=True)
class VariantConfig:
    """The inference-relevant part of the per-tool variant table
    (``unmicst_tpu/core/unet.py:61-102``): the four tools share two
    inference graphs; dropout and regularizers are training-only."""

    name: str
    legacy: bool


VARIANTS = {
    "legacy": VariantConfig("legacy", legacy=True),
    "v2": VariantConfig("v2", legacy=False),
    "duo": VariantConfig("duo", legacy=False),
    "cyto2": VariantConfig("cyto2", legacy=False),
}


def get_variant(name: str) -> VariantConfig:
    return VARIANTS[name]


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


class BatchNorm(nn.Module):
    """Inference batch norm with moving statistics (TF epsilon), applied
    as the folded ``x * scale + bias`` of ``unet.py:235-239``."""

    def __init__(self, width: int):
        super().__init__()
        self.gamma = _param(width)
        self.beta = _param(width)
        self.moving_mean = _param(width)
        self.moving_variance = _param(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.gamma * torch.rsqrt(self.moving_variance + BN_EPS)
        bias = self.beta - self.moving_mean * scale
        return x.float() * scale[:, None, None] + bias[:, None, None]


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

    # -- forward ------------------------------------------------------------

    def forward_nchw(self, x: torch.Tensor,
                     return_logits: bool = False) -> torch.Tensor:
        """``x``: [B, C, S, S] float -> [B, K, S, S] float32 softmax (or
        logits with ``return_logits``)."""
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
        act, conv = self._act, self._conv
        skips = []
        h = x
        for layer in self.down:
            skips.append(h)
            fused = self._fused_residual(layer)
            if fused is not None:
                pre = conv(h, fused)
            else:
                c = conv(h, layer.kernel1)
                for ke in layer.extra:
                    c = conv(act(c), ke)
                pre = c + conv(h, layer.shortcut)
            if self.legacy:
                y = layer.bn(act(pre))  # UnMicst.py:99
            else:
                y = act(layer.bn(pre))  # UnMicst1-5.py:114
            h = F.max_pool2d(y, hp.down_samp_fact)

        b = conv(h, self.bottom.kernel1)
        h = act(b) if self.legacy else act(self.bottom.bn(b))
        for i in reversed(range(hp.n_layers)):
            layer = self.up[i]
            u = act(self._conv_transpose(h, layer.kernel1))
            # skip FIRST (UnMicst.py:156)
            cv = conv(torch.cat([skips[i].to(u.dtype), u], dim=1),
                      layer.kernel2)
            cv = act(cv) if self.legacy else act(layer.bn(cv))
            for ke in layer.extra:
                cv = act(conv(cv, ke))
            h = cv

        t = conv(h, self.top.kernel)
        if not self.legacy:
            t = self.top.bn(t)
        t = t.float()
        return t if return_logits else torch.softmax(t, dim=1)

    def forward(self, x: torch.Tensor,
                return_logits: bool = False) -> torch.Tensor:
        """``x``: [B, S, S, C] -> [B, S, S, K] (the JAX ``apply`` layout)."""
        y = self.forward_nchw(x.permute(0, 3, 1, 2), return_logits)
        return y.permute(0, 2, 3, 1)
