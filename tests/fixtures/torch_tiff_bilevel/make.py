"""Write the fixtures of the port's PIL-free TIFF fallback for bilevel,
packed, old-style JPEG and colour pages, and non-TIFF files under a TIFF
name (``unmicst_tpu_torch/io/tiff.py`` ``read_page_fallback``).

    python tests/fixtures/torch_tiff_bilevel/make.py

Needs numpy and PIL (Pillow over libtiff and libjpeg-turbo).  Writes,
beside this script, each file and PIL's own read of it as ``.npy``:

* ``pil_*.tif``: a 40 x 56 bilevel plane saved by PIL in strips of 16
  rows (the last 8), uncompressed, PackBits, LZW and Deflate, as CCITT
  run lengths (2), Group 3 (3) at T4Options 0, 1 (2D), 4 (fill bits) and
  5, and Group 4 (4); FillOrder 2 and WhiteIsZero variants;
* ``tiles_*.tif``: the plane in 16 x 24 tiles (edge tiles coded whole),
  each tile a stream PIL coded, assembled without PIL; one without a
  Photometric tag;
* ``ojpeg_*.tif``: old-style JPEG pages (compression 6), one 64 x 80
  JFIF stream PIL encoded, pointed at by the strip and by
  JPEGInterchangeFormat (513/514): gray (BlackIsZero, WhiteIsZero, the
  strip alone) and colour at h1v1, h2v1 and h2v2 (YCbCr, and RGB);
* ``jpeg_*.tif``: colour JPEG pages (compression 7): PIL's own RGB save
  (photometric 2), and YCbCr strips and tiles at h1v1, h2v1 and h2v2,
  one without the YCbCrSubsampling tag;
* ``planar_*.tif``: 8-bit RGB planes stored one after another
  (PlanarConfiguration 2), LZW with predictor 2 in strips, Deflate in
  tiles;
* ``slide_g4.tif``, ``slide_12bit_lzw.tif`` and ``png_as.tif``: a
  128 x 160 blob slide as Group 4 bilevel, as 12-bit LZW samples and as
  a PNG under a TIFF name (the CLI tests, which compare with the JAX
  package's reads, so without ``.npy``), and ``jpeg_as.tif``, a JPEG
  under a TIFF name;
* ``blob_strip_g4.tif``: one 4096 x 64 bilevel blob strip in Group 4,
  the strip ``chip_smoke.py`` repeats into a 4096^2 slide (its ``.npy``
  holds PIL's read packed, ``np.packbits(axis=1)``).

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
from chip_smoke import (ccitt_tags, packed_tiff, segment_encoder,  # noqa: E402
                        write_segment_tiff)

TILE = (16, 24)


def blobs(rng, h: int, w: int, n: int) -> np.ndarray:
    """uint8 ``[h, w]``: bright discs on a dark ground, with noise."""
    img = np.full((h, w), 20.0)
    rr, cc = np.ogrid[:h, :w]
    for _ in range(n):
        r, c = rng.randint(0, h), rng.randint(0, w)
        img[(rr - r) ** 2 + (cc - c) ** 2 < rng.randint(25, 120)] = 200
    return np.clip(img + rng.randn(h, w) * 6, 0, 255).astype(np.uint8)


def waves(rng, h: int, w: int, channels: int = 0) -> np.ndarray:
    yy, xx = np.mgrid[:h, :w]
    layers = [120 + 90 * np.sin(yy / 4.0 + c) * np.cos(xx / 6.0 - c)
              + rng.randn(h, w) * 18 for c in range(max(channels, 1))]
    out = np.clip(np.stack(layers, -1), 0, 255).astype(np.uint8)
    return out if channels else out[..., 0]


def save_read(name: str, packed: bool = False) -> None:
    path = os.path.join(HERE, name)
    with Image.open(path) as im:
        arr = np.asarray(im)
    np.save(path.rsplit(".", 1)[0] + ".npy",
            np.packbits(arr, axis=1) if packed else arr)


def pil_tiff(img, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "TIFF", **kwargs)
    return buf.getvalue()


def pil_strips(data: bytes) -> list:
    """The strips of a one-page TIFF PIL wrote."""
    with Image.open(io.BytesIO(data)) as im:
        return [data[o:o + n] for o, n in zip(im.tag_v2[273],
                                              im.tag_v2[279])]


def jpeg_stream(block, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(block).save(buf, "JPEG", **kwargs)
    return buf.getvalue()


def blocks(img, tile):
    """``img``'s tiles, row by row, edge tiles padded by repetition."""
    th, tw = tile
    h, w = img.shape[:2]
    for r0 in range(0, h, th):
        for c0 in range(0, w, tw):
            pad = ((0, max(0, r0 + th - h)), (0, max(0, c0 + tw - w)))
            yield np.pad(img[r0:r0 + th, c0:c0 + tw],
                         pad + ((0, 0),) * (img.ndim - 2), mode="edge")


def bilevel(rng) -> None:
    plane = blobs(rng, 40, 56, 5) > 100
    plane[::7] ^= rng.rand(*plane[::7].shape) > 0.7  # busy rows too
    size = TiffImagePlugin.STRIP_SIZE
    TiffImagePlugin.STRIP_SIZE = 16 * 7  # strips of 16 rows of 7 bytes
    try:
        for name, comp, info in (
                ("none", None, {}), ("packbits", "packbits", {}),
                ("lzw", "tiff_lzw", {}), ("deflate", "tiff_adobe_deflate", {}),
                ("rle", "tiff_ccitt", {}), ("rle_fill2", "tiff_ccitt",
                                            {266: 2}),
                ("g3_1d", "group3", {292: 0}), ("g3_2d", "group3", {292: 1}),
                ("g3_1d_eolalign", "group3", {292: 4}),
                ("g3_2d_eolalign", "group3", {292: 5}),
                ("g3_2d_fill2", "group3", {292: 1, 266: 2}),
                ("g4", "group4", {}), ("g4_fill2", "group4", {266: 2}),
                ("g4_miniswhite", "group4", {262: 0}),
                ("lzw_miniswhite", "tiff_lzw", {262: 0})):
            with open(os.path.join(HERE, f"pil_{name}.tif"), "wb") as f:
                f.write(pil_tiff(plane, compression=comp, tiffinfo=info))
            save_read(f"pil_{name}.tif")
    finally:
        TiffImagePlugin.STRIP_SIZE = size
    h, w = plane.shape
    for name, comp, code, options, photometric in (
            ("g4", "group4", 4, None, 1), ("g3_2d", "group3", 3, 1, 1),
            ("rle", "tiff_ccitt", 2, None, 1),
            ("g4_nophotometric", "group4", 4, None, None)):
        info = {292: options} if options is not None else {}
        segs = [pil_strips(pil_tiff(b, compression=comp, tiffinfo=info))[0]
                for b in blocks(plane, TILE)]
        tags = ccitt_tags(h, w, code, tile=TILE, photometric=photometric,
                          t4_options=options)
        write_segment_tiff(os.path.join(HERE, f"tiles_{name}.tif"),
                           [(tags, segs)])
        save_read(f"tiles_{name}.tif")


def ojpeg_tiff(path: str, stream: bytes, h: int, w: int, photometric: int,
               samples: int, pointer: bool = True) -> None:
    """A one-strip old-style JPEG page (compression 6) of ``stream``, with
    JPEGInterchangeFormat (513/514) pointing at the strip where
    ``pointer``."""
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * samples),
            259: (3, [6]), 262: (3, [photometric]), 277: (3, [samples]),
            278: (4, [h]), 284: (3, [1])}
    write_segment_tiff(path, [(tags, [stream])])
    if pointer:  # the strip's offset and length, as tags 513/514 too
        with Image.open(path) as im:
            off, n = im.tag_v2[273][0], im.tag_v2[279][0]
        write_segment_tiff(path, [({**tags, 513: (4, [off]),
                                    514: (4, [n])}, [stream])])
        with Image.open(path) as im:  # two more entries moved nothing
            assert im.tag_v2[273][0] == off


def old_jpeg(rng) -> None:
    gray, colour = waves(rng, 64, 80), waves(rng, 64, 80, 3)
    s = jpeg_stream(gray, quality=90)
    for name, photometric, pointer in (("gray", 1, True),
                                       ("gray_miniswhite", 0, True),
                                       ("gray_strip_only", 1, False)):
        ojpeg_tiff(os.path.join(HERE, f"ojpeg_{name}.tif"), s, 64, 80,
                   photometric, 1, pointer)
        save_read(f"ojpeg_{name}.tif")
    for sub, tag in ((0, "444"), (1, "422"), (2, "420")):
        s = jpeg_stream(colour, quality=90, subsampling=sub)
        ojpeg_tiff(os.path.join(HERE, f"ojpeg_ycbcr_{tag}.tif"), s, 64, 80,
                   6, 3)
        save_read(f"ojpeg_ycbcr_{tag}.tif")
    ojpeg_tiff(os.path.join(HERE, "ojpeg_rgb_420.tif"), s, 64, 80, 2, 3)
    save_read("ojpeg_rgb_420.tif")


def colour(rng) -> None:
    rgb = waves(rng, 45, 70, 3)
    with open(os.path.join(HERE, "jpeg_rgb_pil.tif"), "wb") as f:
        f.write(pil_tiff(rgb, compression="jpeg", quality=90))
    save_read("jpeg_rgb_pil.tif")
    h, w = rgb.shape[:2]
    base = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]),
            259: (3, [7]), 262: (3, [6]), 277: (3, [3]), 284: (3, [1])}
    for sub, hv in ((0, (1, 1)), (1, (2, 1)), (2, (2, 2))):
        name = f"jpeg_ycbcr_h{hv[0]}v{hv[1]}"
        segs = [jpeg_stream(b, quality=90, subsampling=sub)
                for b in blocks(rgb, (16, w))]  # strips, the last coded taller
        tags = {**base, 278: (4, [16]), 530: (3, list(hv))}
        write_segment_tiff(os.path.join(HERE, name + "_strips.tif"),
                           [(tags, segs)])
        save_read(name + "_strips.tif")
    segs = [jpeg_stream(b, quality=85, subsampling=2)
            for b in blocks(rgb, (32, 48))]
    tags = {**base, 322: (4, [48]), 323: (4, [32]), 530: (3, [2, 2])}
    write_segment_tiff(os.path.join(HERE, "jpeg_ycbcr_h2v2_tiles.tif"),
                       [(tags, segs)])
    save_read("jpeg_ycbcr_h2v2_tiles.tif")
    segs = [jpeg_stream(b, quality=90, subsampling=1)
            for b in blocks(rgb, (16, w))]
    write_segment_tiff(os.path.join(HERE, "jpeg_ycbcr_notag.tif"),
                       [({**base, 278: (4, [16])}, segs)])
    save_read("jpeg_ycbcr_notag.tif")
    for name, comp, tile, pred in (("lzw_pred2", 5, None, 2),
                                   ("deflate_tiles", 8, (16, 32), 1)):
        enc = segment_encoder(comp)
        segs = []
        for c in range(3):
            for b in (blocks(rgb[..., c], tile) if tile else
                      (rgb[r:r + 16, :, c] for r in range(0, h, 16))):
                b = b.copy()
                if pred == 2:
                    b[:, 1:] = np.diff(b, axis=1)
                segs.append(enc(b.tobytes()))
        tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]),
                259: (3, [comp]), 262: (3, [2]), 277: (3, [3]),
                284: (3, [2]), 317: (3, [pred])}
        if tile:
            tags[322], tags[323] = (4, [tile[1]]), (4, [tile[0]])
        else:
            tags[278] = (4, [16])
        write_segment_tiff(os.path.join(HERE, f"planar_{name}.tif"),
                           [(tags, segs)])
        save_read(f"planar_{name}.tif")


def slides(rng) -> None:
    img = blobs(rng, 128, 160, 8)
    with open(os.path.join(HERE, "slide_g4.tif"), "wb") as f:
        f.write(pil_tiff(img > 100, compression="group4"))
    deep = img.astype(np.uint16) * 16 + (img & 15)
    packed_tiff(os.path.join(HERE, "slide_12bit_lzw.tif"), deep, 12, 5, 32)
    Image.fromarray(img).save(os.path.join(HERE, "png_as.tif"), "PNG")
    with open(os.path.join(HERE, "jpeg_as.tif"), "wb") as f:
        f.write(jpeg_stream(waves(rng, 64, 80), quality=90))
    save_read("jpeg_as.tif")
    strip = blobs(rng, 64, 4096, 120) > 100
    with open(os.path.join(HERE, "blob_strip_g4.tif"), "wb") as f:
        f.write(pil_tiff(strip, compression="group4"))
    save_read("blob_strip_g4.tif", packed=True)


def main() -> None:
    rng = np.random.RandomState(16)
    bilevel(rng)
    old_jpeg(rng)
    colour(rng)
    slides(rng)


if __name__ == "__main__":
    main()
