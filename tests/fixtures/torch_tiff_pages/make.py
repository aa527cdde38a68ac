"""Write the fixtures of the TIFF pages the port's fallback reads as PIL
does (``unmicst_tpu_torch/io/tiff.py`` ``read_page_fallback``): old-style
JPEG in the table form and in several strips or tiles, with its own YCbCr
coefficients, subsampled and planar YCbCr, planar RGBA and JPEG, and
1/2/4-bit palette pages.

    python tests/fixtures/torch_tiff_pages/make.py

Needs numpy and PIL (Pillow over libtiff and libjpeg-turbo).  Writes,
beside this script, each file and PIL's own read of it as ``.npy``:

* ``ojpeg_table_*.tif``: old-style JPEG (compression 6) pages in the
  table form (JPEGQTables, JPEGDCTables, JPEGACTables, bare scans), from
  64 x 80 streams PIL encoded with a restart marker every strip: gray in
  one strip, in strips of 16 rows, in one column of tiles and with
  JPEGProc 14 (which libtiff does not read); YCbCr at h1v1, h2v1 and
  h2v2 in strips; h2v2 under photometric RGB, which libtiff takes for
  YCbCr, without the YCbCrSubsampling tag (2x2 by default);
* ``ojpeg_jif_*.tif``: JPEGInterchangeFormat pointing at the stream's
  header, the scans in strips of 16 rows (gray and YCbCr h2v1), or at
  the whole stream while the strips hold its pieces (gray);
* ``ojpeg_coeffs_*.tif``: YCbCr pages with their own YCbCrCoefficients
  (Rec. 709) and ReferenceBlackWhite (16-235/240), in the table form and
  as one complete stream;
* ``ycbcr_*.tif``: interleaved subsampled YCbCr (2x1, 2x2, 4x1, 4x2, 4x4
  and 1x2) under LZW, Deflate and PackBits, in strips and tiles, with
  predictor 2, and with the coefficients above;
* ``planar_*.tif``: YCbCr planes uncompressed (PIL's own reader: the
  stored planes as RGB) and LZW-compressed at 1x1 (libtiff converts
  them); RGBA planes uncompressed, LZW with unassociated alpha and
  Deflate without ExtraSamples (premultiplied to libtiff); JPEG planes of
  RGB, YCbCr 1x1 and RGBA;
* ``palette_*.tif``: 1-, 2- and 4-bit palette pages, uncompressed, LZW
  and Deflate, in strips and tiles, and a 1-bit one under Group 4;
* ``slide_ojpeg_table.tif``, ``slide_ojpeg_jif.tif`` and
  ``slide_palette4.tif``: 96 x 128 blob slides for the CLI tests (which
  compare with the JAX package's CLI, so without ``.npy``), and
  ``blob_strip_ojpeg.tif``, one 4096 x 16 gray table-form strip that
  ``chip_smoke.py`` repeats into a 4096^2 slide.

The card's machine has no PIL, so ``chip_smoke.py`` compares the port
with these ``.npy`` files.
"""

import io
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
from chip_smoke import (jpeg_parts, ojpeg_tiff, pack_samples,  # noqa: E402
                        segment_encoder, write_segment_tiff)

LZW, DEFLATE, PACKBITS = 5, 8, 32773
REC709 = (5, [2125, 10000, 7154, 10000, 721, 10000])  # YCbCrCoefficients
STUDIO = (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])  # RefBW


def waves(rng, h: int, w: int, channels: int = 0) -> np.ndarray:
    yy, xx = np.mgrid[:h, :w]
    layers = [120 + 90 * np.sin(yy / 4.0 + c) * np.cos(xx / 6.0 - c)
              + rng.randn(h, w) * 18 for c in range(max(channels, 1))]
    out = np.clip(np.stack(layers, -1), 0, 255).astype(np.uint8)
    return out if channels else out[..., 0]


def blobs(rng, h: int, w: int, n: int) -> np.ndarray:
    img = np.full((h, w), 20.0)
    rr, cc = np.ogrid[:h, :w]
    for _ in range(n):
        r, c = rng.randint(0, h), rng.randint(0, w)
        img[(rr - r) ** 2 + (cc - c) ** 2 < rng.randint(25, 120)] = 200
    return np.clip(img + rng.randn(h, w) * 6, 0, 255).astype(np.uint8)


def save_read(name: str) -> None:
    path = os.path.join(HERE, name)
    with Image.open(path) as im:
        np.save(path[:-4] + ".npy", np.asarray(im))


def jpeg_stream(img, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kwargs)
    return buf.getvalue()


def old_jpeg(rng) -> None:
    gray, colour = waves(rng, 64, 80), waves(rng, 64, 80, 3)
    one = jpeg_parts(jpeg_stream(gray, quality=90))
    ojpeg_tiff(os.path.join(HERE, "ojpeg_table_gray_one.tif"), 64, 80, one,
               one["intervals"])
    strips = jpeg_parts(jpeg_stream(gray, quality=90, restart_marker_rows=2))
    for name, kwargs in (("gray_strips", dict(rows_per_strip=16)),
                         ("gray_tiles", dict(tile=(16, 80))),
                         ("gray_proc14", dict(rows_per_strip=16,
                                              tags={512: (3, [14])})),
                         ("gray_miniswhite", dict(rows_per_strip=16,
                                                  photometric=0))):
        ojpeg_tiff(os.path.join(HERE, f"ojpeg_table_{name}.tif"), 64, 80,
                   strips, strips["intervals"], **kwargs)
    ojpeg_tiff(os.path.join(HERE, "ojpeg_jif_gray_strips.tif"), 64, 80,
               strips, strips["intervals"], rows_per_strip=16, form="jif")
    whole = jpeg_stream(gray, quality=90, restart_marker_rows=2)
    ojpeg_tiff(os.path.join(HERE, "ojpeg_jif_gray_whole.tif"), 64, 80,
               {**strips, "header": whole}, strips["intervals"],
               rows_per_strip=16, form="jif")
    for sub, hv in ((0, (1, 1)), (1, (2, 1)), (2, (2, 2))):
        parts = jpeg_parts(jpeg_stream(colour, quality=90, subsampling=sub,
                                       restart_marker_rows=1))
        rows = 8 * hv[1]
        ojpeg_tiff(os.path.join(HERE, f"ojpeg_table_ycbcr_h{hv[0]}v{hv[1]}"
                                ".tif"), 64, 80, parts, parts["intervals"],
                   photometric=6, rows_per_strip=rows,
                   tags={530: (3, list(hv))})
        if hv == (2, 1):
            ojpeg_tiff(os.path.join(HERE, "ojpeg_jif_ycbcr_h2v1.tif"), 64,
                       80, parts, parts["intervals"], photometric=6,
                       rows_per_strip=rows, form="jif")
        if hv == (2, 2):
            ojpeg_tiff(os.path.join(HERE, "ojpeg_table_rgb_notag.tif"), 64,
                       80, parts, parts["intervals"], photometric=2,
                       rows_per_strip=rows)
            ojpeg_tiff(os.path.join(HERE, "ojpeg_coeffs_table.tif"), 64, 80,
                       parts, parts["intervals"], photometric=6,
                       rows_per_strip=rows,
                       tags={529: REC709, 532: STUDIO})
    stream = jpeg_stream(colour, quality=90, subsampling=1)
    write_segment_tiff(os.path.join(HERE, "ojpeg_coeffs_stream.tif"), [(
        {256: (4, [80]), 257: (4, [64]), 258: (3, [8] * 3), 259: (3, [6]),
         262: (3, [6]), 277: (3, [3]), 278: (4, [64]), 284: (3, [1]),
         529: REC709, 532: STUDIO}, [stream])])


def data_units(y, cb, cr, hs: int, vs: int) -> np.ndarray:
    """Interleaved subsampled YCbCr as TIFF stores it: per block of hs x
    vs luma samples (row by row), then its Cb and Cr."""
    bh, bw = cb.shape
    yp = np.pad(y, ((0, bh * vs - y.shape[0]), (0, bw * hs - y.shape[1])),
                mode="edge")
    lum = yp.reshape(bh, vs, bw, hs).transpose(0, 2, 1, 3).reshape(
        bh, bw, vs * hs)
    return np.concatenate([lum, cb[..., None], cr[..., None]], -1).astype(
        np.uint8).reshape(-1)


def ycbcr(rng) -> None:
    h, w = 23, 29
    for hs, vs, comp, layout, pred, coeffs in (
            (2, 1, LZW, "strips", 1, False), (2, 2, LZW, "strips", 1, False),
            (4, 1, DEFLATE, "strips", 1, False),
            (4, 2, PACKBITS, "strips", 1, False),
            (4, 4, LZW, "tiles", 1, False), (1, 2, DEFLATE, "tiles", 1, False),
            (2, 2, LZW, "tiles", 2, False), (2, 1, LZW, "strips", 2, False),
            (2, 2, DEFLATE, "strips", 1, True)):
        y = rng.randint(0, 256, (h, w))
        tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * 3),
                259: (3, [comp]), 262: (3, [6]), 277: (3, [3]),
                284: (3, [1]), 530: (3, [hs, vs]), 317: (3, [pred])}
        if coeffs:
            tags[529], tags[532] = REC709, STUDIO
        enc = segment_encoder(comp)

        def segment(block):
            bh, bw = -(-block.shape[0] // vs), -(-block.shape[1] // hs)
            cb = rng.randint(0, 256, (bh, bw))
            cr = rng.randint(0, 256, (bh, bw))
            units = data_units(block, cb, cr, hs, vs)
            if pred == 2:  # libtiff's rows: a tile's width, or a strip's
                line = 3 * block.shape[1] if layout == "tiles" else (
                    bw * (hs * vs + 2) // vs)
                r = units.reshape(-1, line // 3, 3).astype(np.int16)
                r[:, 1:] = r[:, 1:] - r[:, :-1].copy()
                units = (r & 255).astype(np.uint8).reshape(-1)
            return enc(units.tobytes())

        if layout == "strips":
            tags[278] = (4, [8])
            segs = [segment(y[r:r + 8]) for r in range(0, h, 8)]
        else:
            tags[322], tags[323] = (4, [16]), (4, [16])
            segs = [segment(np.pad(y[r:r + 16, c:c + 16],
                                   ((0, max(0, r + 16 - h)),
                                    (0, max(0, c + 16 - w)))))
                    for r in range(0, h, 16) for c in range(0, w, 16)]
        name = (f"ycbcr_{hs}x{vs}_{layout}_{comp}"
                + ("_pred2" if pred == 2 else "")
                + ("_coeffs" if coeffs else "") + ".tif")
        write_segment_tiff(os.path.join(HERE, name), [(tags, segs)])
        save_read(name)


def planar(rng) -> None:
    h, w = 45, 70
    img = waves(rng, h, w, 4)
    img[0, :6, 3], img[1, :6, 3] = 0, 255  # transparent and opaque pixels
    for name, photometric, samples, comp, extra, sub in (
            ("ycbcr_none", 6, 3, 1, None, None),
            ("ycbcr_lzw_1x1", 6, 3, LZW, None, (1, 1)),
            ("rgba_none", 2, 4, 1, None, None),
            ("rgba_lzw_unassociated", 2, 4, LZW, [2], None),
            ("rgba_deflate_noextra", 2, 4, DEFLATE, None, None),
            ("jpeg_rgb", 2, 3, 7, None, None),
            ("jpeg_ycbcr_1x1", 6, 3, 7, None, (1, 1)),
            ("jpeg_rgba", 2, 4, 7, [2], None)):
        segs = []
        for c in range(samples):
            for r in range(0, h, 16):
                block = np.ascontiguousarray(img[r:r + 16, :, c])
                segs.append(jpeg_stream(block, quality=90) if comp == 7
                            else segment_encoder(comp)(block.tobytes()))
        tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * samples),
                259: (3, [comp]), 262: (3, [photometric]),
                277: (3, [samples]), 278: (4, [16]), 284: (3, [2])}
        if extra:
            tags[338] = (3, extra)
        if sub:
            tags[530] = (3, list(sub))
        write_segment_tiff(os.path.join(HERE, f"planar_{name}.tif"),
                           [(tags, segs)])
        save_read(f"planar_{name}.tif")


def palette(rng) -> None:
    h, w = 23, 29
    for bits, comp, layout in ((1, 1, "strips"), (2, LZW, "strips"),
                               (4, DEFLATE, "strips"), (1, LZW, "tiles"),
                               (2, 1, "tiles"), (4, LZW, "tiles")):
        idx = rng.randint(0, 1 << bits, (h, w))
        enc = segment_encoder(comp)
        tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits]),
                259: (3, [comp]), 262: (3, [3]), 277: (3, [1]),
                320: (3, list(rng.randint(0, 65536, 3 << bits)))}
        if layout == "strips":
            tags[278] = (4, [8])
            segs = [enc(pack_samples(idx[r:r + 8], bits).tobytes())
                    for r in range(0, h, 8)]
        else:
            tags[322], tags[323] = (4, [16]), (4, [16])
            segs = [enc(pack_samples(np.pad(
                idx[r:r + 16, c:c + 16], ((0, max(0, r + 16 - h)),
                                          (0, max(0, c + 16 - w)))),
                bits).tobytes())
                for r in range(0, h, 16) for c in range(0, w, 16)]
        name = f"palette_{bits}bit_{comp}_{layout}.tif"
        write_segment_tiff(os.path.join(HERE, name), [(tags, segs)])
        save_read(name)
    buf = io.BytesIO()
    Image.fromarray(rng.rand(h, w) > 0.5).save(buf, "TIFF",
                                                compression="group4")
    with Image.open(io.BytesIO(buf.getvalue())) as im:
        off, n = im.tag_v2[273][0], im.tag_v2[279][0]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [1]), 259: (3, [4]),
            262: (3, [3]), 277: (3, [1]), 278: (4, [h]),
            320: (3, [0, 65535, 0, 65535, 0, 65535])}
    write_segment_tiff(os.path.join(HERE, "palette_1bit_g4.tif"), [(
        tags, [buf.getvalue()[off:off + n]])])
    save_read("palette_1bit_g4.tif")


def slides(rng) -> None:
    img = blobs(rng, 96, 128, 8)
    parts = jpeg_parts(jpeg_stream(img, quality=92, restart_marker_rows=2))
    ojpeg_tiff(os.path.join(HERE, "slide_ojpeg_table.tif"), 96, 128, parts,
               parts["intervals"], rows_per_strip=16)
    ojpeg_tiff(os.path.join(HERE, "slide_ojpeg_jif.tif"), 96, 128, parts,
               parts["intervals"], rows_per_strip=16, form="jif")
    idx = (img // 16).astype(np.uint8)
    write_segment_tiff(os.path.join(HERE, "slide_palette4.tif"), [(
        {256: (4, [128]), 257: (4, [96]), 258: (3, [4]), 259: (3, [LZW]),
         262: (3, [3]), 277: (3, [1]), 278: (4, [32]),
         320: (3, [v * 4369 for v in range(16)] * 3)},
        [segment_encoder(LZW)(pack_samples(idx[r:r + 32], 4).tobytes())
         for r in range(0, 96, 32)])])
    strip = blobs(rng, 16, 4096, 60)
    parts = jpeg_parts(jpeg_stream(strip, quality=85))
    ojpeg_tiff(os.path.join(HERE, "blob_strip_ojpeg.tif"), 16, 4096, parts,
               parts["intervals"])
    save_read("blob_strip_ojpeg.tif")


def main() -> None:
    rng = np.random.RandomState(17)
    old_jpeg(rng)
    for name in sorted(os.listdir(HERE)):
        if name.startswith("ojpeg_") and name.endswith(".tif"):
            save_read(name)
    ycbcr(rng)
    planar(rng)
    palette(rng)
    slides(rng)


if __name__ == "__main__":
    main()
