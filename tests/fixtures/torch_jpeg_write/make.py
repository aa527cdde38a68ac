"""Write the fixtures of the JPEG writer and of the JPEG frames read since
the fourth part of ROADMAP M17 (``unmicst_tpu_torch/io/jpegenc.py``,
``io/jpeg.py``).

    python tests/fixtures/torch_jpeg_write/make.py

Needs numpy and PIL; run from the repository root's Python path (it
builds the streams with ``chip_smoke.lossless_jpeg`` and
``sampled_jpeg``).  Writes, beside this script:

* ``write_<kind>.npy`` and ``write_<kind>.jpg``: seeded bool, uint8 and
  RGB arrays at sizes that are no multiples of 8 or 16 (smooth and
  noisy), and PIL's JPEG file of each at its defaults;
* ``lossless_<kind>.jpg``: lossless (SOF3) streams built here: gray and
  RGB, predictors 1-7, point transforms 0 and 2, with and without
  restart intervals;
* ``sampled_<kind>.jpg``: baseline colour streams sampled h1v2, h4v1,
  h1v4, h4v2 and mixed (luma 2x2, Cb 1x2, Cr 2x1);
* beside each ``lossless_`` and ``sampled_`` stream, PIL's read of it as
  ``.npy``.

The card's machine has no PIL, so ``chip_smoke.py`` compares the port
with these files.
"""

import io
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

import chip_smoke  # noqa: E402


def _smooth(rng, h, w, c=None):
    yy, xx = np.mgrid[:h, :w]
    shape = (h, w) if c is None else (h, w, c)
    base = 128 + 70 * np.sin(yy / 4.0)[..., None] * np.cos(xx / 6.0)[
        ..., None] if c else 128 + 70 * np.sin(yy / 4.0) * np.cos(xx / 6.0)
    return np.clip(base + rng.randint(-12, 12, shape), 0, 255).astype(
        np.uint8)


def writes(rng):
    return {"bool_13x17": rng.randint(0, 2, (13, 17)).astype(bool),
            "gray_13x17": rng.randint(0, 256, (13, 17)).astype(np.uint8),
            "gray_37x45": _smooth(rng, 37, 45),
            "rgb_13x17": rng.randint(0, 256, (13, 17, 3)).astype(np.uint8),
            "rgb_37x45": _smooth(rng, 37, 45, 3),
            "rgb_1x1": rng.randint(0, 256, (1, 1, 3)).astype(np.uint8)}


def streams(rng):
    out = {}
    gray, rgb = _smooth(rng, 21, 30), _smooth(rng, 19, 23, 3)
    for p in range(1, 8):
        out[f"lossless_gray_p{p}"] = chip_smoke.lossless_jpeg(gray, p)
    out["lossless_gray_p4_pt2_restart"] = chip_smoke.lossless_jpeg(
        gray, 4, 2, restart_rows=4)
    out["lossless_gray_p7_pt2"] = chip_smoke.lossless_jpeg(gray, 7, 2)
    out["lossless_rgb_p6"] = chip_smoke.lossless_jpeg(rgb, 6)
    out["lossless_rgb_p1_pt1_restart"] = chip_smoke.lossless_jpeg(
        rgb, 1, 1, restart_rows=3)
    h, w = 21, 30
    for name, hv in (("h1v2", [(1, 2), (1, 1), (1, 1)]),
                     ("h4v1", [(4, 1), (1, 1), (1, 1)]),
                     ("h1v4", [(1, 4), (1, 1), (1, 1)]),
                     ("h4v2", [(4, 2), (1, 1), (1, 1)]),
                     ("mixed", [(2, 2), (1, 2), (2, 1)])):
        hmax, vmax = max(a for a, _ in hv), max(b for _, b in hv)
        planes = [_smooth(rng, -(-h * v // vmax), -(-w * a // hmax))
                  for a, v in hv]
        out[f"sampled_{name}"] = chip_smoke.sampled_jpeg(h, w, planes, hv)
    return out


def main():
    rng = np.random.RandomState(18)
    for name, x in writes(rng).items():
        np.save(os.path.join(HERE, f"write_{name}.npy"), x)
        Image.fromarray(x).save(os.path.join(HERE, f"write_{name}.jpg"))
    for name, data in streams(rng).items():
        with open(os.path.join(HERE, f"{name}.jpg"), "wb") as f:
            f.write(data)
        with Image.open(io.BytesIO(data)) as im:
            np.save(os.path.join(HERE, f"{name}.npy"), np.asarray(im))


if __name__ == "__main__":
    main()
