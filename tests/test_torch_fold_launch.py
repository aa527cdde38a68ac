"""K2's region launch, without a card.

``kernels.blend_fold.fold_launch`` decides, from the tile layout, the
region and the base addresses, whether ``blend_fold_region`` runs its
vector path (four output columns per thread, 16-byte loads) or its scalar
lanes, and the block and grid; ``class_table`` packs the class subset the
kernel takes by value.  These tests pin both at the main path's shapes and
at the layouts that must fall to the scalar lanes.
"""

import ctypes
import importlib

import pytest
import torch

from unmicst_tpu_torch import kernels
from unmicst_tpu_torch.core import tiler as tt

# the module (the package exports its function blend_fold under that name)
bf = importlib.import_module("unmicst_tpu_torch.kernels.blend_fold")

_BASE = 0x7F0000000000  # a 256-byte aligned device address
_P, _M = 128, 16  # the legacy net's tile: sub 96


def _strides(npc, k=3, p=_P):
    """Element strides (tile row, tile column, class, y, x) of contiguous
    ``[T, K, P, P]`` tiles, as the wrapper passes them."""
    st = k * p * p
    return (npc * st, st, p * p, p, 1)


# (h, c0, w, npc): the stripe (S 11, 8192^2), the strip of a 4-rank 4096^2
# band, and the 4096^2 slide epilogue
_MAIN = {"stripe": (1056, 16, 8192, 86), "strip": (1088, 0, 4160, 43),
         "slide": (4096, 16, 4096, 43)}


def _cover(r, sub, n, patch):
    """The kernel's ``cover``: (hi, y_hi, lo or -1, y_lo)."""
    hi = min(r // sub, n - 1)
    lo = hi - 1
    y_lo = r - lo * sub
    if lo < 0 or y_lo >= patch:
        lo = -1
    return hi, r - hi * sub, lo, y_lo


def _assert_covers_once(plan, h, w):
    """Every column of a row is computed by exactly one thread, every row
    by one thread row, and no block lies wholly outside the region."""
    bx, by = plan.block
    gx, gy = plan.grid
    seen = [0] * w
    for t in range(gx * bx):
        for c in range(t * plan.cols, min((t + 1) * plan.cols, w)):
            seen[c] += 1
    assert seen == [1] * w
    assert (gx - 1) * bx * plan.cols < w <= gx * bx * plan.cols
    assert (gy - 1) * by < h <= gy * by


@pytest.mark.parametrize("entry", sorted(_MAIN))
def test_main_path_takes_the_vector_path(entry):
    h, c0, w, npc = _MAIN[entry]
    plan = bf.fold_launch(h, c0, w, _strides(npc), _P - 2 * _M, _P,
                          [_BASE, _BASE + 4096 * 1024])
    assert plan.cols == bf.VEC == 4
    assert plan.tail == 0  # no ragged quad: every thread a full quad
    assert plan.block == bf.BLOCK == (32, 8)
    _assert_covers_once(plan, h, w)
    # the kernel's premise: the four columns of a quad share their
    # covering tile columns and lie at consecutive offsets in them
    sub = _P - 2 * _M
    for c in range(c0, c0 + w, plan.cols):
        hi, x, lo, x_lo = _cover(c, sub, npc, _P)
        assert x % 4 == 0 and x_lo % 4 == 0  # 16-byte aligned rows
        for u in range(1, plan.cols):
            assert _cover(c + u, sub, npc, _P) == (hi, x + u, lo, x_lo + u)


@pytest.mark.parametrize("case", ["base 4 bytes off", "window 4 bytes off",
                                  "odd c0", "x stride 3", "class stride 2"])
def test_layouts_the_vector_path_cannot_take_run_the_scalar_lanes(case):
    h, c0, w, npc = _MAIN["stripe"]
    strides, addresses = list(_strides(npc)), [_BASE, _BASE + 65536]
    if case == "base 4 bytes off":
        addresses[0] += 4
    elif case == "window 4 bytes off":
        addresses[1] += 4
    elif case == "odd c0":
        c0, w = 5, w - 5
    elif case == "x stride 3":  # [npr, npc, P, P, K] read as [T, K, P, P]
        strides = [npc * 3 * _P * _P, 3 * _P * _P, 1, 3 * _P, 3]
    else:
        strides[2] = 2
    plan = bf.fold_launch(h, c0, w, strides, _P - 2 * _M, _P, addresses)
    assert plan.cols == 1 and plan.tail == w
    _assert_covers_once(plan, h, w)


def test_ragged_last_quad_takes_the_scalar_lanes():
    """A width that is not a multiple of 4 keeps the vector path; each
    row's last w % 4 columns go to the scalar lanes of their thread."""
    for w in (8190, 4097, 3):
        plan = bf.fold_launch(40, 16, w, _strides(86), 96, _P, [_BASE])
        assert plan.cols == 4 and plan.tail == w % 4
        _assert_covers_once(plan, 40, w)


def test_stride_zero_window_count_takes_the_vector_path():
    """runtime.halo.count_map folds the window broadcast by stride 0."""
    plan = bf.fold_launch(1088, 0, 4160, (0, 0, 0, _P, 1), 96, _P, [_BASE])
    assert plan.cols == 4


def test_class_table_keeps_the_order():
    table = bf.class_table([2, 0, 1])
    assert ctypes.sizeof(bf._Classes) == 4 * (1 + bf.MAX_CLASSES)
    assert table.n == 3 and list(table.idx)[:3] == [2, 0, 1]
    full = bf.class_table([1] * bf.MAX_CLASSES)
    assert full.n == bf.MAX_CLASSES


@pytest.mark.parametrize("classes", [list(range(9)), [], [0, 3], [-1]])
def test_class_table_refuses_what_the_kernel_does_not_take(classes):
    """Above 8 classes (the table's size), none, or an index out of range:
    the wrapper raises on the CPU as on the card."""
    g = tt.make_grid(60, 60, 32, 4)
    k = max(3, len(classes))
    x = torch.rand(g.num_tiles, k, 32, 32)
    w = torch.from_numpy(tt.ramp_window(32, 4))
    with pytest.raises(ValueError):
        kernels.blend_fold_epilogue(x, w, g, classes=classes)
    if len(classes) > bf.MAX_CLASSES or not classes:
        with pytest.raises(ValueError):
            bf.class_table(classes)
