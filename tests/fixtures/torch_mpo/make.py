"""Write the MPO fixtures (``unmicst_tpu_torch/io/mpo.py``): multi-frame
JPEG files and PIL's read of every frame.

    python tests/fixtures/torch_mpo/make.py

Needs numpy and PIL; run from the repository root's Python path (it
builds two files with ``chip_smoke.mpo_file``).  Writes, beside this
script:

* ``pil_gray3.mpo`` and ``pil_rgb3.mpo``: Pillow's own ``save_all``
  writes of three seeded frames, gray 16 x 24 and RGB 24 x 40;
* ``hand_le.mpo`` and ``hand_be.mpo``: three JPEGs of different sizes
  and kinds (gray 16 x 24 and 13 x 17, RGB 30 x 20) joined by
  ``chip_smoke.mpo_file`` with a little- and a big-endian MP index;
* ``<name>.npz``: PIL's ``np.asarray`` after ``seek(k)`` of every frame,
  as ``frame0``, ``frame1``, ...

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


def _jpeg(img) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG")
    return buf.getvalue()


def files(rng):
    """name -> MPO bytes."""
    out = {}
    for name, shape in (("pil_gray3", (16, 24)), ("pil_rgb3", (24, 40, 3))):
        ims = [Image.fromarray(rng.randint(0, 256, shape).astype(np.uint8))
               for _ in range(3)]
        buf = io.BytesIO()
        ims[0].save(buf, "MPO", save_all=True, append_images=ims[1:])
        out[name] = buf.getvalue()
    streams = [_jpeg(rng.randint(0, 256, shape).astype(np.uint8))
               for shape in ((16, 24), (13, 17), (30, 20, 3))]
    out["hand_le"] = chip_smoke.mpo_file(streams, "<")
    out["hand_be"] = chip_smoke.mpo_file(streams, ">")
    return out


def main() -> None:
    for name, data in files(np.random.RandomState(19)).items():
        frames = {}
        with Image.open(io.BytesIO(data)) as im:
            for k in range(im.n_frames):
                im.seek(k)
                frames[f"frame{k}"] = np.asarray(im)
        with open(os.path.join(HERE, name + ".mpo"), "wb") as f:
            f.write(data)
        np.savez_compressed(os.path.join(HERE, name + ".npz"), **frames)


if __name__ == "__main__":
    main()
