"""K2's region launch, without a card.

``kernels.blend_fold.fold_launch`` decides, from the tile layout, the
region and the base addresses, whether ``blend_fold_region`` runs its
vector path (one canvas-aligned quad of four columns per thread, 16-byte
loads, the quad's columns in the region stored) or its scalar lanes, and the block
and grid; ``class_table`` packs the class subset the kernel takes by value.
These tests pin both at the main path's shapes, at every column origin and
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


def _assert_covers_once(plan, h, c0, w):
    """Every output column of a row is stored by exactly one thread, every
    row by one thread row, and no block lies wholly outside the region.
    On the vector path thread ``x`` of a grid row takes the canvas quad
    ``c0 // 4 + x`` and stores those of its four columns that lie in the
    region; on the scalar lanes it takes output column ``x``."""
    bx, by = plan.block
    gx, gy = plan.grid
    seen = [0] * w
    for x in range(gx * bx):
        if plan.cols == 1:
            cols = [x] if x < w else []
        else:
            q = c0 // 4 + x
            cols = [c - c0 for c in range(4 * q, 4 * q + 4)
                    if c0 <= c < c0 + w]
        for c in cols:
            seen[c] += 1
    assert seen == [1] * w
    across = w if plan.cols == 1 else (c0 + w - 1) // 4 - c0 // 4 + 1
    assert (gx - 1) * bx < across <= gx * bx
    assert (gy - 1) * by < h <= gy * by


def _assert_quads_share_tiles(c0, w, npc, sub=_P - 2 * _M):
    """The kernel's premise on the vector path: the four columns of every
    canvas-aligned quad it loads share their covering tile columns, at
    consecutive offsets that start on a 16-byte boundary."""
    for q in range(c0 // 4, (c0 + w - 1) // 4 + 1):
        hi, x, lo, x_lo = _cover(4 * q, sub, npc, _P)
        assert x % 4 == 0 and x_lo % 4 == 0
        for u in range(1, 4):
            assert _cover(4 * q + u, sub, npc, _P) == (hi, x + u, lo, x_lo + u)


@pytest.mark.parametrize("entry", sorted(_MAIN))
def test_main_path_takes_the_vector_path(entry):
    h, c0, w, npc = _MAIN[entry]
    plan = bf.fold_launch(h, c0, w, _strides(npc), _P - 2 * _M, _P,
                          [_BASE, _BASE + 4096 * 1024])
    assert plan.cols == bf.VEC == 4
    assert plan.block == bf.BLOCK == (32, 8)
    _assert_covers_once(plan, h, c0, w)
    _assert_quads_share_tiles(c0, w, npc)


# the canvas column origins of a pan's 1024^2 window in its 1536^2 band
# (npc 27), one for each c0 % 4; 155 is phase 11's seeded pan (band start
# 1440, trim column 139, margin 16)
_ORIGINS = (156, 17, 1538, 155)


@pytest.mark.parametrize("c0", _ORIGINS)
@pytest.mark.parametrize("w", [1024, 1023, 3, 1])
def test_any_column_origin_and_width_takes_the_vector_path(c0, w):
    """Threads load canvas-aligned quads and store the columns of them
    that lie in the region, so its origin and width do not matter to the
    vector path."""
    npc = 27
    plan = bf.fold_launch(1024, c0, w, _strides(npc), _P - 2 * _M, _P,
                          [_BASE, _BASE + 65536])
    assert plan.cols == bf.VEC
    _assert_covers_once(plan, 1024, c0, w)
    _assert_quads_share_tiles(c0, w, npc)


@pytest.mark.parametrize("case", ["base 4 bytes off", "window 4 bytes off",
                                  "x stride 3", "class stride 2"])
def test_layouts_the_vector_path_cannot_take_run_the_scalar_lanes(case):
    h, c0, w, npc = _MAIN["stripe"]
    strides, addresses = list(_strides(npc)), [_BASE, _BASE + 65536]
    if case == "base 4 bytes off":
        addresses[0] += 4
    elif case == "window 4 bytes off":
        addresses[1] += 4
    elif case == "x stride 3":  # [npr, npc, P, P, K] read as [T, K, P, P]
        strides = [npc * 3 * _P * _P, 3 * _P * _P, 1, 3 * _P, 3]
    else:
        strides[2] = 2
    plan = bf.fold_launch(h, c0, w, strides, _P - 2 * _M, _P, addresses)
    assert plan.cols == 1
    _assert_covers_once(plan, h, c0, w)


def test_ragged_last_quad_takes_the_scalar_lanes():
    """A width that is not a multiple of 4 keeps the vector path; each
    row's ragged last quad is a masked store of its thread, not the scalar
    lanes."""
    for w in (8190, 4097, 3):
        plan = bf.fold_launch(40, 16, w, _strides(86), 96, _P, [_BASE])
        assert plan.cols == 4
        _assert_covers_once(plan, 40, 16, w)


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
