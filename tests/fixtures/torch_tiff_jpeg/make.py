"""Write the fixtures of the port's PIL-free TIFF fallback and colour JPEG
decode (``unmicst_tpu_torch/io/tiff.py`` ``read_page_fallback``,
``unmicst_tpu_torch/io/jpeg.py``).

    python tests/fixtures/torch_tiff_jpeg/make.py

Needs numpy and PIL (Pillow over libtiff and libjpeg-turbo).  Writes,
beside this script, seeded planes and PIL's own decode of each as
``.npy``:

* ``pil_strips.tif``: a 100 x 150 gray plane saved by PIL with
  ``compression="jpeg"`` in strips of 32 rows (the last 4), with a
  ``JPEGTables`` tag;
* hand-assembled gray JPEG TIFFs of the same plane, each 32 x 48 tile or
  strip a stream PIL encoded (``chip_smoke.write_segment_tiff``):
  ``tiles_tables.tif`` (abbreviated tiles after a ``JPEGTables`` tag, edge
  tiles coded whole), ``tiles_restart.tif`` (the same with a restart
  marker every 2 blocks), ``tiles_complete.tif`` (every tile a complete
  stream, no tag 347), ``tiles_progressive.tif`` (complete progressive
  streams), ``strips_tall_last.tif`` (strips of 32 rows, the last coded
  at 32 rows for the 4 left, as libtiff accepts) and
  ``strips_miniswhite.tif`` (photometric 0, which PIL inverts);
* ``colour_{444,422,420}_{baseline,progressive}.jpg``: a 45 x 70 RGB
  plane at PIL's ``subsampling`` 0, 1 and 2, quality 90.

The card's machine has no PIL, so ``chip_smoke.py`` and the tests compare
the port with these ``.npy`` files.
"""

import io
import os
import sys

import numpy as np
from PIL import Image, TiffImagePlugin

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
from chip_smoke import gray_jpeg_tags, jpeg_split, write_segment_tiff  # noqa: E402

TILE = (32, 48)


def plane(rng, h: int, w: int, channels: int = 0) -> np.ndarray:
    """Smooth waves and noise, uint8 ``[h, w]`` (or ``[h, w, channels]``)."""
    yy, xx = np.mgrid[:h, :w]
    layers = [120 + 90 * np.sin(yy / 4.0 + c) * np.cos(xx / 6.0 - c)
              + rng.randn(h, w) * 18 for c in range(max(channels, 1))]
    out = np.clip(np.stack(layers, -1), 0, 255).astype(np.uint8)
    return out if channels else out[..., 0]


def encode(block: np.ndarray, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(block).save(buf, "JPEG", **kwargs)
    return buf.getvalue()


def save_decode(name: str) -> None:
    path = os.path.join(HERE, name)
    with Image.open(path) as im:
        np.save(path.rsplit(".", 1)[0] + ".npy", np.asarray(im))


def tiled(name: str, img: np.ndarray, abbreviated: bool, **kwargs) -> None:
    th, tw = TILE
    h, w = img.shape
    segments, tables = [], None
    for r0 in range(0, h, th):
        for c0 in range(0, w, tw):
            # an edge tile is coded whole, its outside the edge repeated
            blk = np.pad(img[r0:r0 + th, c0:c0 + tw],
                         ((0, max(0, r0 + th - h)), (0, max(0, c0 + tw - w))),
                         mode="edge")
            data = encode(blk, **kwargs)
            if abbreviated:
                tables, data = jpeg_split(data)
            segments.append(data)
    write_segment_tiff(os.path.join(HERE, name),
                       [(gray_jpeg_tags(h, w, TILE, tables), segments)])
    save_decode(name)


def strips(name: str, img: np.ndarray, rows: int, photometric: int) -> None:
    h, w = img.shape
    segments = []
    for r0 in range(0, h, rows):
        blk = img[r0:r0 + rows]
        if len(blk) < rows:  # the last strip coded at the full strip height
            blk = np.pad(blk, ((0, rows - len(blk)), (0, 0)), mode="edge")
        tables, data = jpeg_split(encode(blk, quality=85))
        segments.append(data)
    tags = gray_jpeg_tags(h, w, None, tables, rows, photometric)
    write_segment_tiff(os.path.join(HERE, name), [(tags, segments)])
    save_decode(name)


def main() -> None:
    rng = np.random.RandomState(15)
    gray = plane(rng, 100, 150)
    size = TiffImagePlugin.STRIP_SIZE
    TiffImagePlugin.STRIP_SIZE = 4096  # several strips, the last shorter
    try:
        Image.fromarray(gray).save(os.path.join(HERE, "pil_strips.tif"),
                                   compression="jpeg", quality=90)
    finally:
        TiffImagePlugin.STRIP_SIZE = size
    save_decode("pil_strips.tif")
    tiled("tiles_tables.tif", gray, True, quality=90)
    tiled("tiles_restart.tif", gray, True, quality=90,
          restart_marker_blocks=2)
    tiled("tiles_complete.tif", gray, False, quality=80, optimize=True)
    tiled("tiles_progressive.tif", gray, False, quality=90, progressive=True)
    strips("strips_tall_last.tif", gray, 32, 1)
    strips("strips_miniswhite.tif", gray, 32, 0)
    colour = plane(rng, 45, 70, 3)
    for sub, name in ((0, "444"), (1, "422"), (2, "420")):
        for kind in ("baseline", "progressive"):
            fname = f"colour_{name}_{kind}.jpg"
            with open(os.path.join(HERE, fname), "wb") as f:
                f.write(encode(colour, quality=90, subsampling=sub,
                               progressive=kind == "progressive"))
            save_decode(fname)


if __name__ == "__main__":
    main()
