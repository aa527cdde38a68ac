"""Write the JPEG fixtures of ``unmicst_tpu_torch/io/jpeg.py``.

    python tests/fixtures/torch_jpeg/make.py

Needs numpy and PIL (Pillow over libjpeg-turbo).  Writes, beside this
script, seeded gray planes encoded by PIL and PIL's own decode of each as
``.npy``:

* ``blob_{baseline,progressive,optimize,restart}.jpg``: one 512^2 tile of
  fluorescent-like blobs at quality 95, as baseline, progressive, baseline
  with optimized Huffman tables and baseline with a restart marker every 7
  blocks;
* ``odd_{baseline,progressive}.jpg``: a 100 x 130 plane (neither side a
  multiple of 8) at quality 90.

The card's machine has no PIL, so ``chip_smoke.py`` and the tests compare
the port's decoder with these ``.npy`` files.
"""

import io
import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))


def blob_plane(rng, h: int, w: int, n: int) -> np.ndarray:
    """Gaussian blobs of random size and brightness on a dim, noisy
    background, as uint8."""
    yy, xx = np.mgrid[:h, :w]
    img = np.full((h, w), 0.08)
    for _ in range(n):
        cy, cx = rng.rand(2) * (h, w)
        s = 3 + rng.rand() * 9
        img += (0.3 + 0.7 * rng.rand()) * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img += rng.randn(h, w) * 0.03
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def write(name: str, plane: np.ndarray, **kwargs) -> None:
    buf = io.BytesIO()
    Image.fromarray(plane, "L").save(buf, "JPEG", **kwargs)
    data = buf.getvalue()
    with open(os.path.join(HERE, name + ".jpg"), "wb") as f:
        f.write(data)
    decoded = np.asarray(Image.open(io.BytesIO(data)))
    np.save(os.path.join(HERE, name + ".npy"), decoded)


def main() -> None:
    rng = np.random.RandomState(13)
    tile = blob_plane(rng, 512, 512, 120)
    write("blob_baseline", tile, quality=95)
    write("blob_progressive", tile, quality=95, progressive=True)
    write("blob_optimize", tile, quality=95, optimize=True)
    write("blob_restart", tile, quality=95, restart_marker_blocks=7)
    odd = blob_plane(rng, 100, 130, 12)
    write("odd_baseline", odd, quality=90)
    write("odd_progressive", odd, quality=90, progressive=True)


if __name__ == "__main__":
    main()
