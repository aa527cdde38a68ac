"""Pillow 12's two quantizers, as ``Image.fromarray(image).save(path)``
runs them for a GIF of an RGB or RGBA image (``GifImagePlugin.
_normalize_mode``: ``convert("P", palette=ADAPTIVE)``, which is
``Image.quantize`` at its defaults): the median cut of ``Quant.c`` for
RGB, the fast octree of ``QuantOctree.c`` for RGBA.

Median cut (:func:`median_cut_py`):

* the pixels are counted in ``QuantHash.c``'s hash table by
  ``PIXEL_HASH`` of their r, g, b; where it holds more than 65 536 colours
  the colours are coarsened a bit at a time (``r >> scale`` ...) and the
  entries merged, until it holds at most 65 536 (the hash is one-to-one
  on colours, so this is the smallest scale with at most 65 536 coarse
  colours).  The table's chains keep their keys in ascending hash order,
  and it grows (or shrinks) to Pillow's "primes" after each new key, so
  the entries come out in order of ``(hash % length, hash)``;
* each of three lists holds the entries sorted by one channel, largest
  first, ties in the table's order; boxes split from the heap of
  ``QuantHeap.c`` (most pixels first, its own tie order), along the
  channel of the largest weighted range (77, 150, 29), past half their
  pixels and on through the run of the split value; a box of one colour
  (volume 1) leaves the heap, until 256 boxes;
* the palette is each box's mean colour, rounded; each colour maps to the
  nearest entry (squared distance) among those its own box's entry
  reaches within twice its distance, ties to its own box, then to the
  entry nearer its own (by index among equals).

Fast octree (:func:`octree_py`): pixels of alpha 0 take the colour of
the first of them; a fine cube (4, 4, 4 bits of r, g, b, or 3, 4, 3, 3 of
r, g, b, a) and a coarse one (2 bits an axis) count them; the coarse
cubes in use (at most 256) each take an entry, the most used fine
buckets the rest, each subtracted from its coarse bucket (a coarse
bucket left empty gives its entry to one more fine bucket); entries are
bucket means in float32, truncated; a pixel maps to its fine bucket's
entry, else its coarse bucket's.  Bucket sorts are glibc's ``qsort``, a
merge sort, on ``(int)(b->count - a->count)``.

The loops run in the port's native host library (``native/quant.cpp``):
:func:`median_cut` and :func:`octree` raise where it did not build or
load.  :func:`median_cut_py` and :func:`octree_py` are the same
algorithms in numpy and Python, the plain versions the tests hold the
library to.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from unmicst_tpu_torch.io import _native

MAX_HASH_ENTRIES = 65536
_MIN_LENGTH = 11
_UNIT = (0, 1, 0, 1, 0, 0, 0, 1, 0, 1, 0, 1, 0, 1, 0, 0)
_WEIGHTS = (77, 150, 29)
CUBE_LEVELS = (4, 4, 4, 0, 2, 2, 2, 0)
CUBE_LEVELS_ALPHA = (3, 4, 3, 3, 2, 2, 2, 2)


def pixels(image: np.ndarray) -> np.ndarray:
    """An RGB or RGBA uint8 image as Pillow holds it: n x 4 bytes, alpha
    255 for RGB."""
    h, w, c = image.shape
    px = np.full((h * w, 4), 255, np.uint8)
    px[:, :c] = image.reshape(-1, c)
    return px


def median_cut(px: np.ndarray, colors: int = 256
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``Quant.c``'s median cut of ``px`` (n x 4 uint8) in the native
    library: (indices, palette ``[entries, 3]``)."""
    return _native.quant_median_cut(px, colors)


def octree(px: np.ndarray, colors: int = 256, with_alpha: bool = True
           ) -> Tuple[np.ndarray, np.ndarray]:
    """``QuantOctree.c``'s fast octree of ``px`` (n x 4 uint8) in the
    native library: (indices, palette ``[colors, 4]``)."""
    return _native.quant_octree(px, colors, with_alpha)


# -- the median cut, plain ----------------------------------------------------


def _find_prime(start: int, step: int) -> int:
    """``_findPrime`` as it runs: its divisor test never fires."""
    while start > 1 and not _UNIT[start & 15]:
        start += step
    return start


def _hash(rgb: np.ndarray) -> np.ndarray:
    """``PIXEL_HASH`` of ``[n, 3]`` channel values, in uint32."""
    v = rgb.astype(np.uint32)
    return ((v[:, 0] * np.uint32(463))
            ^ ((v[:, 1] << np.uint32(8)) * np.uint32(10069))
            ^ ((v[:, 2] << np.uint32(16)) * np.uint32(64997)))


def _table(px: np.ndarray) -> Tuple[int, int]:
    """The hash table's final scale and length after counting ``px``:
    each new key grows or shrinks it one step, a count past 65 536
    coarsens it (the length kept) until it fits."""
    rgb = px[:, :3].astype(np.uint32)

    def keys(upto: int, scale: int) -> np.ndarray:
        v = rgb[:upto] >> np.uint32(scale)
        return v[:, 0] | v[:, 1] << 8 | v[:, 2] << 16

    scale, length, count, start = 0, _MIN_LENGTH, 0, 0
    while True:
        _, first = np.unique(keys(len(rgb), scale), return_index=True)
        stop = None
        for pos in np.sort(first[first >= start]).tolist():
            count += 1
            if count * 3 < length:
                new = _find_prime(length // 2 - 1, -1)
            elif length * 3 < count:
                new = _find_prime(length * 2 + 1, 1)
            else:
                new = length
            if new >= _MIN_LENGTH:
                length = new
            if count > MAX_HASH_ENTRIES:
                stop = pos
                break
        if stop is None:
            return scale, length
        while count > MAX_HASH_ENTRIES:
            scale += 1
            count = len(np.unique(keys(stop + 1, scale)))
        start = stop + 1


class _Heap:
    """``QuantHeap.c``: a max-heap by pixel count, slots from 1."""

    def __init__(self, counts: List[int]):
        self.slot = [None]
        self.counts = counts

    def _cmp(self, a: int, b: int) -> int:
        return self.counts[a] - self.counts[b]

    def add(self, v: int) -> None:
        self.slot.append(None)
        k = len(self.slot) - 1
        while k != 1 and self._cmp(v, self.slot[k // 2]) > 0:
            self.slot[k] = self.slot[k // 2]
            k >>= 1
        self.slot[k] = v

    def remove(self):
        if len(self.slot) <= 1:
            return None
        r = self.slot[1]
        v = self.slot.pop()
        count = len(self.slot) - 1
        k = 1
        while k * 2 <= count:
            c = k * 2
            if c < count and self._cmp(self.slot[c], self.slot[c + 1]) < 0:
                c += 1
            if self._cmp(v, self.slot[c]) > 0:
                break
            self.slot[k] = self.slot[c]
            k = c
        if count:
            self.slot[k] = v
        return r


def _split(vals: np.ndarray, counts: np.ndarray, box: List[np.ndarray],
           total: int) -> Tuple[List[np.ndarray], List[np.ndarray], int, int]:
    """``split`` / ``splitlists`` of a box held as its three sorted lists
    (entry numbers): the two boxes' lists and pixel counts."""
    ranges = [int(vals[box[i][0], i]) - int(vals[box[i][-1], i])
              for i in range(3)]
    f = [r * w for r, w in zip(ranges, _WEIGHTS)]
    axis = 0
    for i in (1, 2):
        if f[axis] < f[i]:
            axis = i
    lst = box[axis]
    v = vals[lst, axis]
    cum = np.cumsum(counts[lst], dtype=np.int64)
    past = np.flatnonzero(cum * 2 > total)
    k = int(past[0]) + 1 if len(past) else len(lst)
    if k < len(lst):
        k += int(np.argmax(np.append(v[k:] != v[k - 1], True)))
    if k == len(lst):  # nothing right: the run of the tail's value
        k = len(lst) - int(np.argmax(np.append(v[::-1] != v[-1], True)))
    right = np.zeros(len(vals), bool)
    right[lst[k:]] = True
    lefts = [b[~right[b]] for b in box]
    rights = [b[right[b]] for b in box]
    n_left = int(counts[lefts[0]].sum())
    return lefts, rights, n_left, total - n_left


def median_cut_py(px: np.ndarray, colors: int = 256
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of :func:`median_cut`."""
    px = np.ascontiguousarray(px, np.uint8).reshape(-1, 4)
    n = len(px)
    scale, length = _table(px)
    rgb = px[:, :3].astype(np.int64)
    scaled = rgb >> scale
    keys = scaled[:, 0] | scaled[:, 1] << 8 | scaled[:, 2] << 16
    uniq, inverse = np.unique(keys, return_inverse=True)
    inverse = inverse.ravel()
    vals = np.stack([uniq & 255, (uniq >> 8) & 255, uniq >> 16], 1)
    h = _hash(vals).astype(np.int64)
    order = np.lexsort((h, h % length))  # the table's walk
    vals, counts = vals[order], np.bincount(inverse, minlength=len(uniq))[
        order]
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    entry_of = rank[inverse]  # each pixel's entry in walk order
    walk = np.arange(len(vals))
    root = [walk[np.lexsort((walk, -vals[:, i]))] for i in range(3)]
    boxes: List[List[np.ndarray]] = [root]
    totals = [n]
    kids: List[Tuple[int, int]] = [None]
    volumes: List[int] = [-1]
    heap = _Heap(totals)
    heap.add(0)
    for _ in range(colors - 1):
        while True:
            node = heap.remove()
            if node is None:
                break
            if volumes[node] < 0:
                b = boxes[node]
                volumes[node] = int(np.prod([
                    int(vals[b[i][0], i]) - int(vals[b[i][-1], i]) + 1
                    for i in range(3)]))
            if volumes[node] != 1:
                break
        if node is None:
            break
        lefts, rights, nl, nr = _split(vals, counts, boxes[node],
                                       totals[node])
        for lists, total in ((lefts, nl), (rights, nr)):
            boxes.append(lists)
            totals.append(total)
            kids.append(None)
            volumes.append(-1)
        kids[node] = (len(boxes) - 2, len(boxes) - 1)
        boxes[node] = None
        heap.add(len(boxes) - 2)
        heap.add(len(boxes) - 1)
    # annotate_hash_table: leaves numbered depth first, left first
    box_of_entry = np.zeros(len(vals), np.int64)
    n_entries = 0
    stack = [0]
    while stack:
        node = stack.pop()
        if kids[node] is not None:
            stack += [kids[node][1], kids[node][0]]
            continue
        box_of_entry[boxes[node][0]] = n_entries
        n_entries += 1
    box_of = box_of_entry[entry_of]
    cnt = np.bincount(box_of, minlength=n_entries)
    sums = np.stack([np.bincount(box_of, weights=rgb[:, c],
                                 minlength=n_entries) for c in range(3)], 1)
    sums = sums.astype(np.int64) % (1 << 32)  # Pillow's uint32 sums
    palette = np.floor(.5 + sums / cnt[:, None]).astype(np.uint8)
    return _nearest(rgb, box_of, palette), palette


def _nearest(rgb: np.ndarray, box_of: np.ndarray,
             palette: np.ndarray) -> np.ndarray:
    """``map_image_pixels_from_median_box`` for every pixel, by colour."""
    pal = palette.astype(np.int64)
    dist = ((pal[:, None, :] - pal[None, :, :]) ** 2).sum(2)
    rank = np.empty_like(dist)
    rows = np.arange(len(pal))
    rank[rows[:, None], np.argsort(dist, 1, kind="stable")] = rows[None, :]
    colours, first, inverse = np.unique(
        rgb[:, 0] << 16 | rgb[:, 1] << 8 | rgb[:, 2], return_index=True,
        return_inverse=True)
    out = np.empty(len(colours), np.int64)
    for lo in range(0, len(colours), 4096):
        c = rgb[first[lo : lo + 4096]]
        own = box_of[first[lo : lo + 4096]]
        dd = ((c[:, None, :] - pal[None, :, :]) ** 2).sum(2)
        initial = dd[np.arange(len(c)), own]
        reach = dist[own] <= 4 * initial[:, None]
        better = reach & (dd < initial[:, None])
        key = np.where(better, dd * (len(pal) + 1) + rank[own], -1)
        key = np.where(key < 0, np.iinfo(np.int64).max, key)
        best = np.argmin(key, 1)
        out[lo : lo + 4096] = np.where(better.any(1), best, own)
    return out[inverse.ravel()].astype(np.uint8)


# -- the fast octree, plain ---------------------------------------------------


def _bucket_ids(px: np.ndarray, bits) -> np.ndarray:
    r, g, b, a = bits
    p = px.astype(np.int64)
    return ((p[:, 0] >> (8 - r)) << (g + b + a) | (p[:, 1] >> (8 - g))
            << (b + a) | (p[:, 2] >> (8 - b)) << a | (p[:, 3] >> (8 - a)))


def _cube(px: np.ndarray, bits) -> np.ndarray:
    """A colour cube: per bucket its count (uint32) and its r, g, b, a
    sums (uint64), as one ``[size, 5]`` uint64 array."""
    ids = _bucket_ids(px, bits)
    size = 1 << sum(bits)
    out = np.zeros((size, 5), np.uint64)
    out[:, 0] = np.bincount(ids, minlength=size)
    for c in range(4):
        out[:, c + 1] = np.bincount(ids, weights=px[:, c].astype(np.float64),
                                    minlength=size).astype(np.uint64)
    return out


def _shrunk(cube: np.ndarray, src, dst) -> np.ndarray:
    """``copy_color_cube`` to fewer bits an axis: the sum of the source
    buckets under each."""
    idx = np.arange(len(cube))
    coords, shift = [], sum(src)
    for s, d in zip(src, dst):
        shift -= s
        coords.append(((idx >> shift) & ((1 << s) - 1)) >> (s - d))
    ids = (coords[0] << (dst[1] + dst[2] + dst[3]) | coords[1]
           << (dst[2] + dst[3]) | coords[2] << dst[3] | coords[3])
    out = np.zeros((1 << sum(dst), 5), np.uint64)
    np.add.at(out, ids, cube)
    out[:, 0] &= np.uint64(0xFFFFFFFF)
    return out


def _mean(cube: np.ndarray) -> np.ndarray:
    """``avg_color_from_color_bucket`` of each bucket: the float32 means,
    truncated and clipped (0 for an empty bucket)."""
    count = cube[:, 0].astype(np.uint32).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        v = cube[:, 1:].astype(np.float32) / count[:, None]
        bad = ~(np.abs(v) < 2.0**31)  # C's cast gives INT_MIN
        iv = np.where(bad, -(2**31), np.trunc(np.where(bad, 0, v))).astype(
            np.int64)
    out = np.clip(iv, 0, 255).astype(np.uint8)
    out[count == 0] = 0
    return out


def _msort(keys: np.ndarray) -> np.ndarray:
    """glibc's ``qsort`` (a merge sort) of bucket numbers by
    ``(int)(b->count - a->count)``, ``keys`` the uint32 counts."""
    if (keys < 2**31).all():  # a total order: the merge sort is stable
        return np.argsort(-keys.astype(np.int64), kind="stable")
    k = [int(x) for x in keys]

    def cmp(a: int, b: int) -> int:
        d = (k[b] - k[a]) & 0xFFFFFFFF
        return d - (1 << 32) if d >= 1 << 31 else d

    def sort(b: List[int]) -> List[int]:
        if len(b) <= 1:
            return b
        n1 = len(b) // 2
        x, y = sort(b[:n1]), sort(b[n1:])
        out, i, j = [], 0, 0
        while i < len(x) and j < len(y):
            if cmp(x[i], y[j]) <= 0:
                out.append(x[i])
                i += 1
            else:
                out.append(y[j])
                j += 1
        return out + x[i:] + y[j:]

    return np.asarray(sort(list(range(len(k)))), np.int64)


def _subtract(coarse: np.ndarray, buckets: np.ndarray, cbits) -> None:
    """``subtract_color_buckets``: each bucket off the coarse bucket of
    its mean (uint32 counts and uint64 sums wrap)."""
    live = buckets[buckets[:, 0] != 0]
    if not len(live):
        return
    ids = _bucket_ids(_mean(live).astype(np.int64), cbits)
    for i, b in zip(ids.tolist(), live):
        coarse[i] = coarse[i] - b
        coarse[i, 0] &= np.uint64(0xFFFFFFFF)


def octree_py(px: np.ndarray, colors: int = 256, with_alpha: bool = True
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of :func:`octree`."""
    px = np.array(px, np.uint8).reshape(-1, 4)
    lv = CUBE_LEVELS_ALPHA if with_alpha else CUBE_LEVELS
    fbits, cbits = lv[:4], lv[4:]
    if with_alpha:
        clear = np.flatnonzero(px[:, 3] == 0)
        if len(clear):
            px[clear, :3] = px[clear[0], :3]
    fine = _cube(px, fbits)
    coarse = _shrunk(fine, fbits, cbits)
    with np.errstate(over="ignore"):
        n_coarse = min(int((coarse[:, 0] > 0).sum()), colors)
        n_fine = colors - n_coarse
        fine_sorted = fine[_msort(fine[:, 0])]
        _subtract(coarse, fine_sorted[:n_fine], cbits)
        while n_coarse > int((coarse[:, 0] > 0).sum()):
            done = n_fine
            n_coarse = int((coarse[:, 0] > 0).sum())
            n_fine = colors - n_coarse
            _subtract(coarse, fine_sorted[done:n_fine], cbits)
    coarse_sorted = coarse[_msort(coarse[:, 0])]
    palette = np.concatenate([coarse_sorted[:n_coarse],
                              fine_sorted[:n_fine]])
    means = _mean(palette).astype(np.int64)
    # the lookup cubes: coarse entries, then fine ones over them; lower
    # entries written last win
    clook = np.zeros(1 << sum(cbits), np.int64)
    ids = _bucket_ids(means[:n_coarse], cbits)
    for i in range(n_coarse - 1, -1, -1):
        clook[ids[i]] = i
    look = clook[_bucket_ids(_cube_centres(fbits), cbits)]
    ids = _bucket_ids(means[n_coarse:], fbits)
    for i in range(n_fine - 1, -1, -1):
        look[ids[i]] = n_coarse + i
    idx = look[_bucket_ids(px, fbits)].astype(np.uint8)
    return idx, means.astype(np.uint8)


def _cube_centres(bits) -> np.ndarray:
    """A colour in each bucket of a cube of ``bits``, in bucket order."""
    idx = np.arange(1 << sum(bits))
    out, shift = np.zeros((len(idx), 4), np.int64), sum(bits)
    for c, s in enumerate(bits):
        shift -= s
        out[:, c] = ((idx >> shift) & ((1 << s) - 1)) << (8 - s)
    return out
