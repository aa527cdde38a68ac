"""Write the GIF fixtures (``unmicst_tpu_torch/io/gif.py``): files of
every kind the reader takes, each with PIL's read of every frame, and
PIL's GIF writes of each dtype ``imwrite`` takes.

    python tests/fixtures/torch_gif/make.py

Needs numpy and PIL; run from the repository root's Python path (it
builds the files with ``chip_smoke.gif_file``).  Writes, beside this
script:

* ``<kind>.gif``: seeded GIFs built here, 2 to 4 frames at 13 x 17 to
  40 x 33: no colour table (gray), the identity gray table, a global
  table with interlaced frames, local tables with frames offset within
  the screen, a transparent index under disposals 1, 2 and 3, GIF87a,
  comment and application extensions; and one of Pillow's own multi-frame
  writes (``save_all`` with per-frame disposal and a transparent index);
* ``<kind>.npz``: PIL's ``np.asarray`` after ``seek(k)`` of every frame,
  as ``frame0``, ``frame1``, ...;
* ``write_<dtype>.npy`` and ``write_<dtype>.gif``: a seeded 2-D array of
  each dtype (bool, uint8 with few levels and with all 256, uint16,
  int16, int32, float32, float64) and PIL's GIF file of it.

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


def _pal(rng, n):
    return rng.randint(0, 256, 3 * n).astype(np.uint8).tobytes()


def readers(rng):
    """name -> GIF bytes."""
    h, w = 33, 40
    gray = bytes(i // 3 for i in range(768))
    out = {}
    out["gray"] = chip_smoke.gif_file(w, h, [
        dict(pixels=rng.randint(0, 256, (h, w))),
        dict(pixels=rng.randint(0, 256, (10, 12)), x=5, y=7,
             transparency=3)])
    out["identity_palette"] = chip_smoke.gif_file(w, h, [
        dict(pixels=rng.randint(0, 256, (h, w))),
        dict(pixels=rng.randint(0, 256, (h, w)), interlace=True)],
        palette=gray)
    out["interlaced"] = chip_smoke.gif_file(w, h, [
        dict(pixels=rng.randint(0, 16, (h, w)), interlace=True, bits=4),
        dict(pixels=rng.randint(0, 16, (20, 30)), x=3, y=2, interlace=True,
             bits=4)], palette=_pal(rng, 16), background=2)
    out["local_palettes"] = chip_smoke.gif_file(w, h, [
        dict(pixels=rng.randint(0, 4, (15, 20)), x=4, y=9,
             palette=_pal(rng, 4), bits=2),
        dict(pixels=rng.randint(0, 256, (12, 31)), x=9, y=1,
             palette=_pal(rng, 256)),
        dict(pixels=rng.randint(0, 8, (h, w)), bits=3)],
        palette=_pal(rng, 8))
    for disposal in (1, 2, 3):
        out[f"transparency_disposal{disposal}"] = chip_smoke.gif_file(w, h, [
            dict(pixels=rng.randint(0, 16, (h, w)), transparency=5,
                 disposal=disposal),
            dict(pixels=rng.randint(0, 16, (14, 18)), x=6, y=4,
                 transparency=2, disposal=disposal),
            dict(pixels=rng.randint(0, 16, (9, 25)), x=10, y=20),
            dict(pixels=rng.randint(0, 16, (5, 5)), x=1, y=1,
                 transparency=0)], palette=_pal(rng, 16), background=7)
    out["disposal2_background"] = chip_smoke.gif_file(w, h, [
        dict(pixels=rng.randint(0, 16, (20, 20)), x=3, y=3, disposal=2),
        dict(pixels=rng.randint(0, 16, (10, 10)), x=20, y=15)],
        palette=_pal(rng, 16), background=9)
    out["gif87a"] = chip_smoke.gif_file(17, 13, [
        dict(pixels=rng.randint(0, 4, (13, 17)), bits=2),
        dict(pixels=rng.randint(0, 4, (6, 7)), x=2, y=3, bits=2)],
        palette=_pal(rng, 4), version=b"87a")
    out["extensions"] = chip_smoke.gif_file(17, 13, [
        dict(pixels=rng.randint(0, 256, (13, 17)), comment=b"made here"),
        dict(pixels=rng.randint(0, 256, (13, 17)), comment=b"again")],
        palette=_pal(rng, 256))
    frames = [Image.fromarray(rng.randint(0, 4, (h, w)).astype(np.uint8),
                              "P") for _ in range(3)]
    for f in frames:
        f.putpalette(_pal(rng, 4))
    b = io.BytesIO()
    frames[0].save(b, "GIF", save_all=True, append_images=frames[1:],
                   disposal=[1, 2, 3], transparency=1, duration=40)
    out["pil_save_all"] = b.getvalue()
    return out


WRITES = {"bool": lambda r: r.randint(0, 2, (13, 17)).astype(bool),
          "uint8_few": lambda r: (r.randint(0, 5, (31, 29)) * 37).astype(
              np.uint8),
          "uint8": lambda r: r.randint(0, 256, (40, 33)).astype(np.uint8),
          "uint16": lambda r: r.randint(0, 400, (17, 13)).astype(np.uint16),
          "int16": lambda r: r.randint(-300, 400, (13, 17)).astype(np.int16),
          "int32": lambda r: r.randint(-300, 400, (13, 17)).astype(np.int32),
          "float32": lambda r: (r.rand(16, 20) * 300 - 20).astype(
              np.float32),
          "float64": lambda r: r.rand(20, 16) * 300 - 20}


def main():
    rng = np.random.RandomState(18)
    for name, data in readers(rng).items():
        with open(os.path.join(HERE, f"{name}.gif"), "wb") as f:
            f.write(data)
        frames = {}
        with Image.open(io.BytesIO(data)) as im:
            for k in range(im.n_frames):
                im.seek(k)
                frames[f"frame{k}"] = np.asarray(im)
        np.savez(os.path.join(HERE, f"{name}.npz"), **frames)
    for name, make in WRITES.items():
        x = make(rng)
        np.save(os.path.join(HERE, f"write_{name}.npy"), x)
        Image.fromarray(x).save(os.path.join(HERE, f"write_{name}.gif"))


if __name__ == "__main__":
    main()
