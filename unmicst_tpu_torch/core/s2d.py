"""Space-to-depth refold of the full-resolution UNet level, exact
(``unmicst_tpu/core/s2d.py``).

The legacy nets are narrow where they are big: level 0 runs at full
resolution with 1-17 input and 16 output channels (nucleiDAPI: ks 5,
widths 1, 16, 32, 64).  A 2x2 space-to-depth packs that level so the
same arithmetic runs at half resolution with four times the channels:

* a stride-1 SAME ``ks x ks`` conv of the full plane is exactly a
  stride-1 SAME conv of the packed half plane with a
  ``2 * ((ks // 2 + 1) // 2) + 1`` kernel whose taps are a parity split of
  the original (ks 5 becomes 3: 1.44x the nominal FLOPs at 4x the
  channels);
* the 2x2 stride-2 max-pool that ends the level is a max over the four
  phase groups of the packed tensor;
* the stride-2 SAME transposed conv that re-enters the level is a
  stride-1 conv whose output channels are the four output phases;
* 1x1 convs (the legacy shortcut) become block-diagonal 1x1 convs; the
  activations are elementwise, and the inference batch norm is a
  per-channel affine, so its vectors tile four times.

The inner levels and the bottom are left as they are.  The refold is a
transformation of the loaded weights (:func:`refold_params`) and an
inference-only forward (:func:`forward_nchw`); the sums are the standard
forward's, reordered.  The channel packing is JAX's: packed channel
``(qy * 2 + qx) * C + c`` holds pixel ``(2i + qy, 2j + qx)`` of channel
``c`` (not ``F.pixel_unshuffle``'s ``c * 4 + qy * 2 + qx``), so the
refolded kernels are JAX's, in the port's layouts: OIHW convolutions,
the transposed kernel refolding from ``[in, out, ks, ks]``.

JAX's ``apply`` ends in a softmax; :func:`apply` and
:func:`forward_nchw` end in the logits, which the engine hands to K1.
Scope: inference, ``down_samp_fact == 2``, odd ``ks``, even tile size.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from unmicst_tpu_torch.core.unet import BatchNorm, UNet


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NCHW ``[B, C, H, W]`` -> ``[B, 4C, H/2, W/2]``; packed channel
    ``(qy * 2 + qx) * C + c`` holds pixel ``(2i + qy, 2j + qx, c)``."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`space_to_depth`."""
    b, c4, h, w = x.shape
    c = c4 // 4
    x = x.reshape(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c, 2 * h, 2 * w)


def refold_conv(k: np.ndarray) -> np.ndarray:
    """A stride-1 SAME HWIO ``[ks, ks, Cin, Cout]`` kernel -> the packed
    ``[ks', ks', 4 Cin, 4 Cout]`` kernel with ``s2d(conv(x, k)) ==
    conv(s2d(x), k')``, SAME boundaries included (``s2d.py:96-136``).

    Output pixel ``2i + py`` reads input ``2i + py + dy - r``; written as
    ``2(i + m) + qy`` that is ``dy = 2m + qy - py + r``, so each phase
    pair and offset ``m`` takes at most one original tap."""
    kh, kw, cin, cout = k.shape
    if kh != kw or kh % 2 == 0:
        raise ValueError(f"refold_conv needs a square odd kernel, got "
                         f"{k.shape}")
    r = kh // 2
    mmax = (r + 1) // 2
    n = 2 * mmax + 1
    kp = np.zeros((n, n, 4 * cin, 4 * cout), np.float32)
    k = np.asarray(k, np.float32)
    for py in range(2):
        for qy in range(2):
            for dy in range(kh):
                ny = dy - r - qy + py
                if ny % 2:
                    continue
                for px in range(2):
                    for qx in range(2):
                        for dx in range(kw):
                            nx = dx - r - qx + px
                            if nx % 2:
                                continue
                            q, p = qy * 2 + qx, py * 2 + px
                            kp[ny // 2 + mmax, nx // 2 + mmax,
                               q * cin:(q + 1) * cin,
                               p * cout:(p + 1) * cout] = k[dy, dx]
    return kp


def refold_conv_transpose(k: np.ndarray) -> np.ndarray:
    """A stride-2 SAME transposed-conv kernel in TF's layout
    ``[ks, ks, Cout, Cin]`` -> the packed stride-1 SAME HWIO kernel
    ``[T', T', Cin, 4 Cout]`` with ``s2d(conv_transpose(h, k)) ==
    conv(h, k')`` (``s2d.py:139-183``): output pixel ``2i + py`` collects
    ``h[i - t] * k[2t + py + pl]`` with ``pl = (ks - 2) // 2``."""
    kh, kw, cout, cin = k.shape
    if kh != kw or kh % 2 == 0 or kh < 3:
        raise ValueError(f"refold_conv_transpose needs a square odd kernel "
                         f">= 3, got {k.shape}")
    pl = (kh - 2) // 2
    tmax = max(abs((dy - py - pl) // 2) for py in range(2)
               for dy in range(kh) if (dy - py - pl) % 2 == 0)
    n = 2 * tmax + 1
    kp = np.zeros((n, n, cin, 4 * cout), np.float32)
    k = np.asarray(k, np.float32)
    for py in range(2):
        for dy in range(kh):
            ny = dy - py - pl
            if ny % 2:
                continue
            for px in range(2):
                for dx in range(kw):
                    nx = dx - px - pl
                    if nx % 2:
                        continue
                    p = py * 2 + px
                    # U[i] += h[i - t] * k[dy]: conv tap index T - t
                    kp[tmax - ny // 2, tmax - nx // 2, :,
                       p * cout:(p + 1) * cout] = k[dy, dx].T
    return kp


def _hwio(t: torch.Tensor) -> np.ndarray:
    """OIHW (or ``[in, out, ks, ks]``) -> HWIO (or TF's ``[ks, ks, out,
    in]``), float32 numpy."""
    return t.detach().to("cpu", torch.float32).numpy().transpose(2, 3, 1, 0)


def _oihw(k: np.ndarray) -> nn.Parameter:
    return nn.Parameter(torch.from_numpy(np.ascontiguousarray(
        k.transpose(3, 2, 0, 1))), requires_grad=False)


def _tile_bn(bn: BatchNorm) -> BatchNorm:
    """Per-channel inference BN ``[C]`` -> packed ``[4C]`` (packed channel
    ``p * C + c`` normalises with channel ``c``'s statistics)."""
    out = BatchNorm(4 * bn.gamma.shape[0])
    out.load_state_dict({n: t.detach().to("cpu").repeat(4)
                         for n, t in bn.state_dict().items()})
    return out


class Packed(nn.Module):
    """Level 0's refolded kernels and tiled BN: ``down0`` (``fused``, or
    ``kernel1``, ``extra`` and ``shortcut``; ``bn``) and ``up0``
    (``kernel1``, ``kernel2``, ``extra``; v2's ``bn``), OIHW."""

    def __init__(self):
        super().__init__()
        self.down0 = nn.Module()
        self.up0 = nn.Module()


def refold_params(model: UNet) -> Packed:
    """Pack level 0's kernels and BN of ``model`` for :func:`forward_nchw`
    (``s2d.py:192-227``), on the CPU; the model stays as it is."""
    hp = model.hp
    if hp.down_samp_fact != 2:
        raise ValueError("s2d refold requires down_samp_fact == 2")
    if hp.ks % 2 == 0:
        raise ValueError("s2d refold requires an odd kernel size")
    packed = Packed()
    d0, u0 = packed.down0, packed.up0
    layer = model.down[0]
    fused = UNet._fused_residual(layer)
    if fused is not None:
        d0.fused = _oihw(refold_conv(_hwio(fused)))
    else:
        d0.kernel1 = _oihw(refold_conv(_hwio(layer.kernel1)))
        d0.extra = nn.ParameterList(
            [_oihw(refold_conv(_hwio(k))) for k in layer.extra])
        # the legacy 1x1 shortcut refolds to a block-diagonal 1x1 (ks 1),
        # v2's ks x ks shortcut as any conv
        d0.shortcut = _oihw(refold_conv(_hwio(layer.shortcut)))
    d0.bn = _tile_bn(layer.bn)
    up = model.up[0]
    u0.kernel1 = _oihw(refold_conv_transpose(_hwio(up.kernel1)))
    u0.kernel2 = _oihw(refold_conv(_hwio(up.kernel2)))
    u0.extra = nn.ParameterList(
        [_oihw(refold_conv(_hwio(k))) for k in up.extra])
    if not model.legacy:
        u0.bn = _tile_bn(up.bn)
    return packed


class _Level0:
    """Level 0 packed at half resolution, for one forward
    (``UNet.forward_nchw(level0=)``; ``s2d.py:230-342``): ``down`` packs
    the input and keeps it as ``up``'s skip."""

    def __init__(self, model: UNet, packed: Packed):
        self.model, self.packed = model, packed
        self.xp = None

    def _bn_act(self, pre, bn):
        act = self.model._act
        return bn(act(pre)) if self.model.legacy else act(bn(pre))

    def down(self, x: torch.Tensor) -> torch.Tensor:
        """The packed level: residual, BN and the 2x2 max-pool, which is
        the max over the phases."""
        model, d0 = self.model, self.packed.down0
        conv, act = model._conv, model._act
        self.xp = xp = space_to_depth(x)
        fused = getattr(d0, "fused", None)
        if fused is not None:
            pre = conv(xp, fused)
        else:
            c = conv(xp, d0.kernel1)
            for ke in d0.extra:
                c = conv(act(c), ke)
            pre = c + conv(xp, d0.shortcut)
        y = self._bn_act(pre, d0.bn)
        b, _, hh, ww = y.shape
        return y.reshape(b, 4, model.hp.n_out_x[1], hh, ww).amax(dim=1)

    def up(self, h: torch.Tensor) -> torch.Tensor:
        """The packed re-entry: each phase's skip channels, then its u
        channels; back to full resolution for the top 1x1."""
        model, u0, xp = self.model, self.packed.up0, self.xp
        conv, act = model._conv, model._act
        u = act(conv(h, u0.kernel1))  # [B, 4 c1, S/2, S/2]
        b, _, hh, ww = u.shape
        c0, c1 = xp.shape[1] // 4, model.hp.n_out_x[1]
        cat = torch.cat([xp.reshape(b, 4, c0, hh, ww).to(u.dtype),
                         u.reshape(b, 4, c1, hh, ww)], dim=2)
        cv = conv(cat.reshape(b, 4 * (c0 + c1), hh, ww), u0.kernel2)
        cv = act(cv) if model.legacy else act(u0.bn(cv))
        for ke in u0.extra:
            cv = act(conv(cv, ke))
        return depth_to_space(cv)


def forward_nchw(model: UNet, packed: Packed, x: torch.Tensor
                 ) -> torch.Tensor:
    """Inference ``[B, C, S, S]`` -> logits ``[B, K, S, S]``, equal to
    ``model.forward_nchw(x, return_logits=True)`` with level 0 packed at
    half resolution; ``S`` even, in the module's own compute dtype."""
    if x.shape[-2] % 2 or x.shape[-1] % 2:
        raise ValueError(f"s2d needs even spatial dims, got "
                         f"{tuple(x.shape)}")
    return model.forward_nchw(x, return_logits=True,
                              level0=_Level0(model, packed))


def apply(model: UNet, packed: Packed, x: torch.Tensor) -> torch.Tensor:
    """:func:`forward_nchw` in JAX's layout: ``[B, S, S, C]`` -> logits
    ``[B, S, S, K]``."""
    return forward_nchw(model, packed, x.permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1)
