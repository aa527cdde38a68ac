"""Analytic operation counts of the UNet2D inference forward.

``unmicst_tpu/utils/flops.py``: a multiply-add is two operations, in
every convolution; elementwise work, BN and softmax are not counted.
Geometry follows ``core/unet.py``.  :func:`quant_site_ops` gives the
int8 sites' share (``core/quant.py``), integer operations on the card.
"""

from __future__ import annotations

from typing import Dict

from unmicst_tpu_torch.core.hp import HParams
from unmicst_tpu_torch.core.unet import get_variant


def unet_flops_per_tile(hp: HParams, variant: str = "legacy",
                        fused_residual: bool = True) -> int:
    """Operations of one inference forward over an ``im_size`` square tile.

    ``fused_residual``: with no extra convs the down layer's shortcut folds
    into ``kernel1`` at inference and costs nothing; False counts the
    training graph's separate shortcut conv."""
    widths = hp.n_out_x
    ks2 = hp.ks * hp.ks
    legacy = get_variant(variant).legacy
    # UNet._fused_residual: a legacy 1x1 shortcut folds only into an odd
    # kernel
    fused = (fused_residual and hp.n_extra_convs == 0
             and (not legacy or hp.ks % 2 == 1))
    res = hp.im_size
    total = 0
    for i in range(hp.n_layers):
        hw = res * res
        total += 2 * hw * ks2 * widths[i] * widths[i + 1]
        total += 2 * hw * ks2 * widths[i + 1] ** 2 * hp.n_extra_convs
        if not fused:
            sc_k2 = 1 if legacy else ks2
            total += 2 * hw * sc_k2 * widths[i] * widths[i + 1]
        res //= hp.down_samp_fact
    total += 2 * res * res * ks2 * widths[hp.n_layers] * widths[hp.n_layers + 1]
    # the transposed conv's multiply-adds are counted per input pixel
    for i in range(hp.n_layers - 1, -1, -1):
        in_hw = res * res
        res *= hp.down_samp_fact
        hw = res * res
        total += 2 * in_hw * ks2 * widths[i + 1] * widths[i + 2]
        total += 2 * hw * ks2 * (widths[i] + widths[i + 1]) * widths[i + 1]
        total += 2 * hw * ks2 * widths[i + 1] ** 2 * hp.n_extra_convs
    total += 2 * res * res * widths[1] * hp.n_classes
    return total


def slide_flops(hp: HParams, height: int, width: int,
                variant: str = "legacy") -> int:
    """Forward operations of a tiled slide, the tiles' overlap included."""
    from unmicst_tpu_torch.core import tiler

    grid = tiler.make_grid(height, width, hp.im_size, hp.margin)
    return grid.num_tiles * unet_flops_per_tile(hp, variant)


def quant_site_ops(hp: HParams, variant: str = "legacy") -> Dict[str, int]:
    """Site name -> operations of one tile at each int8 site of
    ``quant.conv_sites`` (two per multiply-add of the unpadded K)."""
    from unmicst_tpu_torch.core import quant
    from unmicst_tpu_torch.core.unet import UNet

    sites = quant.conv_sites(UNet(hp, variant).state_dict(), hp)
    return {site: 2 * w.size * (hp.im_size >> quant.site_level(site, hp)) ** 2
            for site, w in sites.items()}
