"""Write the fixtures of the raster formats PIL 12.1 decodes itself
(``unmicst_tpu_torch/io/spider.py``, ``fits.py``, ``mcidas.py``,
``psd.py``, ``sun.py``, ``pixar.py``, ``xvthumb.py``, ``xpm.py``,
``imt.py``, ``gbr.py``, ``iptc.py``, ``pcd.py``): small files of each
layout, PIL's read of each, and three 4096^2 slides' digests.

    python tests/fixtures/torch_rasters/make.py

PIL saves none of these formats but SPIDER, so the writers are here; they
need numpy only (the card's machine has no PIL, and ``chip_smoke.py``
loads this file by path for :func:`slide_files`).  :func:`main` needs
PIL and writes, beside this script:

* ``<name>.<ext>``: each case of :func:`small_cases` (each at most three
  FITS blocks, 8640 bytes);
* ``reads.npz``: PIL's ``np.asarray`` of each file after ``Image.open``
  and after every ``seek(k)`` that succeeds, keyed ``<file>`` (no seek)
  and ``<file>@<k>``, and ``errors.json``: the exception class of each
  read that fails;
* ``slides.json``: for each of :func:`slide_files`' three 4096^2 slides
  (a big-endian float32 SPIDER stack of 3, a 16-bit FITS, a gray PackBits
  PSD with two layers), the sha256 of the file and, at each channel the
  card reads, the dtype, shape and sha256 of PIL's read there.
"""

import gzip
import hashlib
import io
import json
import os
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SLIDE = 4096


# -- SPIDER -------------------------------------------------------------------


def spider_header(h: int, w: int, order: str = ">", istack: int = 0,
                  maxim: int = 0, imgnum: int = 0, **extra) -> bytes:
    """A SPIDER label: ``labrec`` records of ``w * 4`` bytes, at least
    1024 bytes, its 1-based words set as ``SpiderImagePlugin`` reads
    them; ``extra`` sets other words by number (``w5=3.0``)."""
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    words = [0.0] * (labbyt // 4)
    for k, v in {1: 1.0, 2: h, 5: 1.0, 12: w, 13: labrec, 22: labbyt,
                 23: lenbyt, 24: istack, 26: maxim, 27: imgnum}.items():
        words[k - 1] = float(v)
    for k, v in extra.items():
        words[int(k[1:]) - 1] = float(v)
    return struct.pack(f"{order}{len(words)}f", *words)


def spider(frames, order: str = ">", stack: bool = False) -> bytes:
    """A SPIDER image (one float32 plane) or stack (``frames``, one
    header each after the stack's own)."""
    dt = np.dtype("f4").newbyteorder(order)
    if not stack:
        (x,) = frames
        return spider_header(*x.shape, order) + x.astype(dt).tobytes()
    h, w = frames[0].shape
    out = [spider_header(h, w, order, istack=2, maxim=len(frames))]
    for k, x in enumerate(frames):
        out.append(spider_header(h, w, order, imgnum=k + 1))
        out.append(x.astype(dt).tobytes())
    return b"".join(out)


# -- FITS ---------------------------------------------------------------------


def card(key: str, value=None) -> bytes:
    if value is None:
        return key.ljust(80).encode()
    return f"{key:<8}= {value:>20}".ljust(80).encode()


def _block(cards) -> bytes:
    s = b"".join(cards) + card("END")
    return s + b" " * (-len(s) % 2880)


_FITS_DTYPE = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}


def fits(x: np.ndarray, bitpix: int, empty_primary: bool = False) -> bytes:
    """A FITS file of the plane ``x`` (its first row the file's last, as
    FITS stores images bottom-up), big-endian at ``bitpix``; after an
    empty primary HDU where ``empty_primary``."""
    h, w = x.shape
    data = x[::-1].astype(_FITS_DTYPE[bitpix]).tobytes()
    head = [card("SIMPLE", "T")]
    if empty_primary:
        head = _block(head + [card("BITPIX", 8), card("NAXIS", 0),
                              card("EXTEND", "T")])
        head = [head, card("XTENSION", "'IMAGE   '")]
    else:
        head = [b""] + head
    return head[0] + _block(head[1:] + [
        card("BITPIX", bitpix), card("NAXIS", 2), card("NAXIS1", w),
        card("NAXIS2", h)]) + data + bytes(-len(data) % 2880)


def fits_gzip(x: np.ndarray, zbitpix: int, rows: int = 1,
              rowbytes: int = 8) -> bytes:
    """The tile-compressed form PIL reads: an empty primary HDU, then a
    ``BINTABLE`` with ``ZIMAGE = T`` and ``ZCMPTYPE = 'GZIP_1  '``, its
    ``rows`` x ``rowbytes`` table, then one gzip stream of every pixel in
    4 big-endian bytes."""
    h, w = x.shape
    table = bytes(range(rows * rowbytes))
    body = gzip.compress(x.astype(">i4").tobytes(), mtime=0)
    return _block([card("SIMPLE", "T"), card("BITPIX", 8), card("NAXIS", 0),
                   card("EXTEND", "T")]) + _block([
        card("XTENSION", "'BINTABLE'"), card("BITPIX", 8), card("NAXIS", 2),
        card("NAXIS1", rowbytes), card("NAXIS2", rows),
        card("ZIMAGE", "T"), card("ZCMPTYPE", "'GZIP_1  '"),
        card("ZBITPIX", zbitpix), card("ZNAXIS", 2), card("ZNAXIS1", w),
        card("ZNAXIS2", h)]) + table + body


# -- McIDAS -------------------------------------------------------------------


def mcidas(x: np.ndarray, prefix: int = 0, data_at: int = 256) -> bytes:
    """A McIDAS area file of ``x`` (uint8, uint16 or int32: 1, 2 or 4
    bytes a sample, big-endian) from ``data_at`` on, ``prefix`` bytes of
    row prefix before each row (PIL skips them)."""
    h, w = x.shape
    words = [0] * 64
    words[1], words[8], words[9], words[10] = 4, h, w, x.dtype.itemsize
    words[13], words[14], words[33] = 1, prefix, data_at
    rows = x.astype(x.dtype.newbyteorder(">")).view(np.uint8).reshape(h, -1)
    rows = np.concatenate([np.full((h, prefix), 7, np.uint8), rows], 1)
    head = struct.pack(">64i", *words)
    return head + bytes(data_at - len(head)) + rows.tobytes()


# -- PSD ----------------------------------------------------------------------


def packbits_row(row: bytes) -> bytes:
    """PackBits of one row: runs of 3-128 equal bytes, literals between."""
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j < n and j - i < 128 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), row[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and row[j] == row[j + 1] == row[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + row[i:j]
        i = j
    return bytes(out)


def packbits_rows(plane: np.ndarray):
    """Each row of ``plane`` coded by :func:`packbits_row`; rows whose
    width is a multiple of 128 are cut into 128-byte chunks instead, a
    chunk of one value a run and any other a literal (fast at 4096^2)."""
    h, w = plane.shape
    if w % 128:
        return [packbits_row(r.tobytes()) for r in plane]
    chunks = plane.reshape(h, w // 128, 128)
    run = (chunks == chunks[..., :1]).all(-1)
    out = np.zeros((h, w // 128, 129), np.uint8)
    out[..., 0] = np.where(run, 0x81, 0x7F)
    out[..., 1:] = chunks
    keep = np.ones(out.shape, bool)
    keep[..., 2:] = ~run[..., None]
    lengths = keep.sum((1, 2))
    flat = out[keep].tobytes()
    ends = np.concatenate([[0], np.cumsum(lengths)])
    return [flat[ends[k] : ends[k + 1]] for k in range(h)]


def psd_channels(planes, compression: int) -> bytes:
    """The image data of ``planes`` (each ``[h, row_bytes]`` uint8) under
    one compression word: raw, or PackBits with every row's count first."""
    out = [struct.pack(">H", compression)]
    if compression == 0:
        out += [p.tobytes() for p in planes]
    else:
        coded = [packbits_rows(p) for p in planes]
        out += [struct.pack(f">{len(c)}H", *map(len, c)) for c in coded]
        out += [b"".join(c) for c in coded]
    return b"".join(out)


def psd(planes, mode: int, depth: int = 8, compression: int = 1,
        layers=(), palette: bytes = b"", resources: bytes = b"") -> bytes:
    """A PSD of the composite ``planes`` (``[h, row_bytes]`` uint8 each:
    1-bit rows packed MSB first) in Photoshop colour ``mode`` (0 bitmap,
    1 gray, 2 indexed, 3 RGB, 4 CMYK, 7 multichannel, 8 duotone, 9 Lab),
    and ``layers``: ``(top, left, channel ids, planes, name)``, each
    channel coded on its own at ``compression`` as Photoshop writes it."""
    h = planes[0].shape[0]
    w = planes[0].shape[1] * (8 if depth == 1 else 1)
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, len(planes), h, w, depth,
                                 mode)
    colour = struct.pack(">I", len(palette)) + palette
    res = struct.pack(">I", len(resources)) + resources
    if layers:
        records, data = [], []
        for top, left, ids, lplanes, name in layers:
            lh, lw = lplanes[0].shape
            coded = [psd_channels([p], compression) for p in lplanes]
            rec = struct.pack(">iiiiH", top, left, top + lh, left + lw,
                              len(ids))
            rec += b"".join(struct.pack(">hI", i, len(c))
                            for i, c in zip(ids, coded))
            pname = bytes([len(name)]) + name
            pname += bytes(-len(pname) % 4)
            extra = struct.pack(">II", 0, 0) + pname
            rec += b"8BIMnorm" + bytes([255, 0, 0, 0])
            rec += struct.pack(">I", len(extra)) + extra
            records.append(rec)
            data.append(b"".join(coded))
        info = struct.pack(">h", len(layers)) + b"".join(records) + \
            b"".join(data)
        info += bytes(len(info) & 1)
        block = struct.pack(">I", len(info)) + info + struct.pack(">I", 0)
        lm = struct.pack(">I", len(block)) + block
    else:
        lm = struct.pack(">I", 0)
    return head + colour + res + lm + psd_channels(planes, compression)


def psd_resource(rid: int, name: bytes, body: bytes) -> bytes:
    pname = bytes([len(name)]) + name
    pname += bytes(len(pname) & 1)
    return b"8BIM" + struct.pack(">H", rid) + pname + struct.pack(
        ">I", len(body)) + body + bytes(len(body) & 1)


# -- Sun raster ---------------------------------------------------------------


def sun_rle(data: bytes) -> bytes:
    """Sun's byte-level RLE: a run of 3-256 bytes as 0x80, count-1,
    value; a single 0x80 as 0x80 0x00; other bytes as they are."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 256 and data[j] == data[i]:
            j += 1
        if j - i >= 3 or (data[i] == 0x80 and j - i >= 2):
            out += bytes([0x80, j - i - 1, data[i]])
        elif data[i] == 0x80:
            out += b"\x80\x00"
            j = i + 1
        else:
            out += data[i:j]
        i = j
    return bytes(out)


def sun(rows: np.ndarray, w: int, depth: int, ftype: int = 1,
        palette: bytes = b"", rle_data: bytes = None) -> bytes:
    """A Sun raster file: ``rows`` (``[h, row_bytes]`` uint8, already in
    the file's sample layout) padded to 16 bits, or ``rle_data`` for type
    2 (the coded bytes as given)."""
    h = rows.shape[0]
    stride = ((w * depth + 15) // 16) * 2
    body = np.zeros((h, stride), np.uint8)
    body[:, : rows.shape[1]] = rows
    data = body.tobytes()
    if ftype == 2:
        data = sun_rle(data) if rle_data is None else rle_data
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), ftype,
                       1 if palette else 0, len(palette)) + palette + data


# -- the small formats --------------------------------------------------------


def pixar(x: np.ndarray, mode=(14, 2)) -> bytes:
    h, w = x.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\200\350\000\000"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, *mode)
    return bytes(head) + x.astype(np.uint8).tobytes()


def xvthumb(x: np.ndarray, comments=(b"#IMGINFO:x",)) -> bytes:
    h, w = x.shape
    return (b"P7 332\n" + b"".join(c + b"\n" for c in comments)
            + b"#END_OF_COMMENTS\n" + f"{w} {h} 255\n".encode()
            + x.astype(np.uint8).tobytes())


def xpm(idx: np.ndarray, colours, cpp: int = 1,
        pixels_comment: bool = True) -> bytes:
    """An XPM of the indices ``idx`` into ``colours`` (``#rrggbb`` or
    ``None``), ``cpp`` characters a pixel."""
    h, w = idx.shape
    chars = [bytes([33 + (k // 90 ** j) % 90 + (1 if (33 + (k // 90 ** j)
                                                       % 90) >= 34 else 0)
                    for j in range(cpp)]) for k in range(len(colours))]
    out = [b"/* XPM */\n", b"static char *x[] = {\n",
           b'"%d %d %d %d",\n' % (w, h, len(colours), cpp)]
    for ch, c in zip(chars, colours):
        out.append(b'"' + ch + b" c " + c.encode() + b'",\n')
    if pixels_comment:
        out.append(b"/* pixels */\n")
    for r in idx:
        out.append(b'"' + b"".join(chars[v] for v in r) + b'",\n')
    out.append(b"};\n")
    return b"".join(out)


def imt(x: np.ndarray, extra=b"") -> bytes:
    h, w = x.shape
    return (b"* IM Tools\n" + extra + b"width %d\nheight %d\npixel n8\n"
            % (w, h) + b"\x0c" + x.astype(np.uint8).tobytes())


def gbr(x: np.ndarray, version: int = 2, comment: bytes = b"brush") -> bytes:
    h, w = x.shape[:2]
    depth = 1 if x.ndim == 2 else 4
    name = comment + b"\0"
    if version == 1:
        head = struct.pack(">5I", 20 + len(name), 1, w, h, depth)
    else:
        head = struct.pack(">5I", 28 + len(name), 2, w, h, depth) + \
            b"GIMP" + struct.pack(">I", 25)
    return head + name + x.astype(np.uint8).tobytes()


def iptc_field(rec: int, tag: int, data: bytes) -> bytes:
    if len(data) < 0x8000:
        return struct.pack(">BBBH", 0x1C, rec, tag, len(data)) + data
    return struct.pack(">BBBHI", 0x1C, rec, tag, 0x8004, len(data)) + data


def iptc(body: bytes, w: int, h: int, layers: int = 1,
         component: int = 0, band=None, compression: int = 1,
         chunk: int = 0) -> bytes:
    """An IPTC/NAA record: the image fields, then ``body`` in one (8, 10)
    field, or in fields of ``chunk`` bytes."""
    out = [iptc_field(2, 0, b"\0\4"), iptc_field(3, 20, struct.pack(">I", w)),
           iptc_field(3, 30, struct.pack(">I", h)),
           iptc_field(3, 60, bytes([layers, component])),
           iptc_field(3, 120, bytes([compression]))]
    if band is not None:
        out.append(iptc_field(3, 65, bytes([band])))
    step = chunk or max(len(body), 1)
    for k in range(0, max(len(body), 1), step):
        out.append(iptc_field(8, 10, body[k : k + step]))
    return b"".join(out)


def pcd(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
        orientation: int = 0) -> bytes:
    """A PhotoCD file's base image as PIL reads it: ``PCD_`` at 2048, the
    orientation byte at 2048 + 1538, then from 96 * 2048 each pair of
    768-sample luma rows followed by its 384 Cb and 384 Cr samples."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    pairs = [np.concatenate([y[2 * k], y[2 * k + 1], cb[k], cr[k]])
             for k in range(y.shape[0] // 2)]
    return bytes(head) + np.concatenate(pairs).astype(np.uint8).tobytes()


# -- the slides of chip_smoke.py's phase 25 -----------------------------------


def blob_slide(rng, h: int, w: int, n_blobs: int,
               background=None) -> np.ndarray:
    """float32 noise (or a flat ``background``) with ringed blobs, as
    ``chip_smoke.blob_slide``."""
    img = (rng.rand(h, w).astype(np.float32) * 0.15 if background is None
           else np.full((h, w), background, np.float32))
    for _ in range(n_blobs):
        r, c = rng.randint(20, h - 20), rng.randint(20, w - 20)
        rad = rng.randint(5, 9)
        r0, c0 = r - rad - 2, c - rad - 2
        rr, cc = np.ogrid[r0 : r + rad + 3, c0 : c + rad + 3]
        d2 = (rr - r) ** 2 + (cc - c) ** 2
        win = img[r0 : r + rad + 3, c0 : c + rad + 3]
        win[d2 < rad ** 2] = 0.7
        win[(d2 < (rad + 2) ** 2) & (d2 >= rad ** 2)] = 0.4
    return img


def _even_packbits(plane: np.ndarray):
    """``[h]`` coded rows of ``plane`` whose lengths sum to an even count
    (a 0x80, which PackBits skips, ends the last row where needed): PIL
    pads a layer channel that ends at an odd offset."""
    coded = packbits_rows(plane)
    if sum(map(len, coded)) & 1:
        coded[-1] += b"\x80"
    return coded


def psd_layered_slide(composite: np.ndarray, layer: np.ndarray) -> bytes:
    """A gray PackBits PSD: the ``composite``, a small first layer and a
    full-canvas second layer ``layer``, as Photoshop lays them out, plus
    an image resource that holds the second layer's coded rows at the
    file offset equal to their offset inside the layer section: PIL reads
    a layer's channels at their section offsets taken as file offsets,
    so this is the layout where PIL's ``seek(2)`` gives ``layer``."""
    h, w = composite.shape
    small = np.full((8, 8), 200, np.uint8)
    records, chans, at = [], [], []
    for plane in (small, layer):
        coded = _even_packbits(plane)
        head = struct.pack(">H", 1) + struct.pack(
            f">{len(coded)}H", *map(len, coded))
        chans.append((head, b"".join(coded)))
        lh, lw = plane.shape
        extra = struct.pack(">II", 0, 0) + b"\x01a\0\0"
        records.append(struct.pack(">iiiiHhI", 0, 0, lh, lw, 1, 0,
                                   len(head) + len(chans[-1][1]))
                       + b"8BIMnorm" + bytes([255, 0, 0, 0])
                       + struct.pack(">I", len(extra)) + extra)
    pos = 2 + sum(map(len, records))
    for head, body in chans:
        at.append(pos + len(head))
        pos += len(head) + len(body)
    info = struct.pack(">h", 2) + b"".join(records) + b"".join(
        h_ + b_ for h_, b_ in chans)
    block = struct.pack(">I", len(info)) + info + struct.pack(">I", 0)
    lm = struct.pack(">I", len(block)) + block
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, 1, h, w, 8, 1) + \
        struct.pack(">I", 0)
    start = len(head) + 4 + 12  # the resource's body
    assert at[1] >= start, at
    body = bytes(at[1] - start) + chans[1][1]
    res = psd_resource(1000, b"", body)
    return head + struct.pack(">I", len(res)) + res + lm + psd_channels(
        [composite], 1)


def slide_files(seed: int = 23, side: int = SLIDE):
    """name -> (file bytes, the seeks chip_smoke reads): a big-endian
    float32 SPIDER stack of 3 (seek 1: its second image), a 16-bit FITS
    (no seek) and a gray PackBits PSD with two layers (seek 1: the
    composite; seek 2: PIL's second layer)."""
    rng = np.random.RandomState(seed)
    n = 350 * (side // SLIDE) ** 2 or 20
    stack = [blob_slide(rng, side, side, n) for _ in range(3)]
    gray = (blob_slide(rng, side, side, n, 0.1) * 255).astype(np.uint8)
    layer = (blob_slide(rng, side, side, n, 0.05) * 255).astype(np.uint8)
    u16 = (blob_slide(rng, side, side, n) * 65535).astype(np.uint16)
    return {"spider_stack.tif": (spider(stack, ">", stack=True), [1]),
            "fits16.tif": (fits(u16.view(np.int16), 16), [0]),
            "psd_layers.tif": (psd_layered_slide(gray, layer), [1, 2])}


# -- the small fixtures -------------------------------------------------------


def small_cases():
    """name -> file bytes of every layout the readers take, and some they
    refuse (each at most 8640 bytes)."""
    rng = np.random.RandomState(230)
    c = {}
    f32 = rng.standard_normal((9, 11)).astype(np.float32)
    for order, tag in ((">", "be"), ("<", "le")):
        c[f"spider_{tag}.spi"] = spider([f32], order)
        c[f"spider_stack_{tag}.spi"] = spider(
            [rng.standard_normal((6, 7)).astype(np.float32) for _ in range(3)],
            order, stack=True)
    c["spider_cut.spi"] = c["spider_be.spi"][:-10]
    i16 = rng.randint(-3000, 3000, (7, 9))
    for bp in (8, 16, 32, -32, -64):
        x = rng.randint(0, 256, (7, 9)) if bp == 8 else (
            rng.standard_normal((7, 9)) * 100 if bp < 0 else i16)
        tag = f"m{-bp}" if bp < 0 else str(bp)
        c[f"fits_{tag}.fits"] = fits(x, bp)
        c[f"fits_{tag}_gzip.fits"] = fits_gzip(i16, bp)
    c["fits_16_ext.fits"] = fits(i16, 16, empty_primary=True)
    c["fits_16_cut.fits"] = c["fits_16.fits"][:2880 + 50]
    c["fits_32_cut.fits"] = c["fits_32.fits"][:2880 + 50]
    for dt in (np.uint8, np.uint16, np.int32):
        x = rng.randint(0, 250, (6, 7)).astype(dt)
        c[f"mcidas_{np.dtype(dt).name}.area"] = mcidas(x, prefix=4,
                                                       data_at=300)
    c["mcidas_uint8_cut.area"] = c["mcidas_uint8.area"][:-5]
    g = rng.randint(0, 256, (10, 12)).astype(np.uint8)
    for comp in (0, 1):
        t = "rle" if comp else "raw"
        c[f"psd_gray_{t}.psd"] = psd([g], 1, compression=comp)
        c[f"psd_rgb_{t}.psd"] = psd([g, g[::-1], g.T[:10, :12] ^ 7], 3,
                                    compression=comp)
        c[f"psd_rgba_{t}.psd"] = psd([g, g[::-1], g ^ 5, g // 2], 3,
                                     compression=comp)
        c[f"psd_cmyk_{t}.psd"] = psd([g, g ^ 1, g ^ 2, g ^ 3], 4,
                                     compression=comp)
        c[f"psd_lab_{t}.psd"] = psd([g, g ^ 9, g[::-1]], 9,
                                    compression=comp)
        c[f"psd_p_{t}.psd"] = psd([g % 17], 2, compression=comp,
                                  palette=bytes(range(256)) * 3)
        c[f"psd_bitmap_{t}.psd"] = psd([g[:, :2]], 0, depth=1,
                                       compression=comp)
        c[f"psd_duotone_{t}.psd"] = psd([g], 8, compression=comp)
        c[f"psd_multi_{t}.psd"] = psd([g, g ^ 3], 7, compression=comp)
        c[f"psd_layers_{t}.psd"] = psd(
            [g], 1, compression=comp, resources=psd_resource(
                1005, b"res", bytes(range(16))), layers=[
                (1, 2, [0], [g[:4, :5]], b"one"),
                (0, 0, [0], [g[:3, :3] ^ 1], b"two"),
                (2, 1, [0], [g[:5, :6] ^ 2], b"three")])
        c[f"psd_rgba_layers_{t}.psd"] = psd(
            [g, g, g], 3, compression=comp, layers=[
                (0, 0, [0, 1, 2], [g[:3, :4]] * 3, b"rgb"),
                (1, 1, [-1, 0, 1, 2], [g[:2, :3], g[:2, :3] ^ 1,
                                       g[:2, :3] ^ 2, g[:2, :3] ^ 3], b"a")])
    c["psd_gray_rle_cut.psd"] = c["psd_gray_rle.psd"][:-6]
    small = np.full((8, 8), 77, np.uint8)
    c["psd_readable_layer.psd"] = psd_layered_slide(g[:8, :8], small ^ g[:8,
                                                                      :8])
    for depth in (1, 4, 8, 24, 32):
        w = 7
        rows = rng.randint(0, 256, (5, (w * depth + 7) // 8)).astype(np.uint8)
        if depth <= 8:
            rows[2] = rows[2, 0]  # a run for the RLE
        for ftype, t in ((1, "raw"), (2, "rle"), (3, "rgb")):
            if ftype == 3 and depth < 24:
                continue
            c[f"sun_{depth}_{t}.ras"] = sun(rows, w, depth, ftype)
        if depth in (4, 8):
            c[f"sun_{depth}_palette.ras"] = sun(rows, w, depth, 2,
                                                palette=bytes(range(48)))
    c["sun_8_rle_cut.ras"] = c["sun_8_rle.ras"][:-2]
    c["sun_1_palette.ras"] = sun(rows[:, :1], 7, 1, 1,
                                 palette=bytes(range(6)))
    c["sun_8_rle_runs.ras"] = sun(np.zeros((4, 9), np.uint8), 9, 8, 2,
                                  rle_data=b"\x80\x00\x80\x0b\x05\x07\x80"
                                  b"\x13\x09")
    c["pixar.pxr"] = pixar(rng.randint(0, 256, (5, 6, 3)))
    c["pixar_cut.pxr"] = c["pixar.pxr"][:-4]
    c["xvthumb.xv"] = xvthumb(rng.randint(0, 256, (6, 8)))
    c["xvthumb_cut.xv"] = c["xvthumb.xv"][:-3]
    cols = ["#%06x" % v for v in rng.randint(0, 1 << 24, 6)]
    c["xpm_p.xpm"] = xpm(rng.randint(0, 6, (5, 7)), cols)
    c["xpm_p_none.xpm"] = xpm(rng.randint(0, 2, (5, 7)), cols[:2] + ["None"])
    many = ["#%06x" % v for v in rng.randint(0, 1 << 24, 300)]
    c["xpm_rgb.xpm"] = xpm(rng.randint(0, 300, (4, 6)), many, cpp=2,
                           pixels_comment=False)
    c["imt.imt"] = imt(rng.randint(0, 256, (6, 7)), b"* comment\n")
    c["imt_cut.imt"] = c["imt.imt"][:-5]
    c["gbr_v1.gbr"] = gbr(rng.randint(0, 256, (5, 6)), 1)
    c["gbr_v2_rgba.gbr"] = gbr(rng.randint(0, 256, (5, 6, 4)), 2)
    c["gbr_cut.gbr"] = c["gbr_v1.gbr"][:-3]
    gi = rng.randint(0, 256, (6, 7)).astype(np.uint8)
    c["iptc_gray.iim"] = iptc(gi.tobytes(), 7, 6)
    c["iptc_gray_fields.iim"] = iptc(gi.tobytes(), 7, 6, chunk=10)
    c["iptc_rgb_band.iim"] = iptc(gi.tobytes(), 7, 6, layers=3, component=1,
                                  band=2)
    c["iptc_cmyk.iim"] = iptc(gi.tobytes(), 7, 6, layers=4, component=1)
    c["iptc_cut.iim"] = iptc(gi.tobytes()[:-4], 7, 6)
    # a gray baseline JPEG of the JPEG fixtures, as the record's data
    with open(os.path.join(os.path.dirname(HERE), "torch_jpeg",
                           "odd_baseline.jpg"), "rb") as f:
        jpg = f.read()
    h, w = struct.unpack(">HH", jpg[jpg.index(b"\xff\xc0") + 5 :][:4])
    c["iptc_jpeg.iim"] = iptc(jpg, w, h, compression=5, chunk=4000)
    c["iptc_jpeg_cmyk_band.iim"] = iptc(jpg, w, h, layers=4, component=1,
                                        band=2, compression=5)
    return c


def pcd_case():
    """A PhotoCD base image of seeded samples, orientation 1 (about 590
    KB, so it is made at test time, not committed)."""
    rng = np.random.RandomState(231)
    return pcd(rng.randint(0, 256, (512, 768)),
               rng.randint(0, 256, (256, 384)),
               rng.randint(0, 256, (256, 384)), 1)


SEEKS = (None, 0, 1, 2, 3, 4)


def pil_read(path: str, k):
    """PIL's ``np.asarray`` of ``path`` after ``seek(k)`` (None: none),
    or the exception's class name."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            if k is not None:
                im.seek(k)
            return np.asarray(im)
    except Exception as e:  # noqa: BLE001 -- recorded by class
        return type(e).__name__


def main() -> None:
    import tempfile

    reads, errors = {}, {}
    for name, data in sorted(small_cases().items()):
        assert len(data) <= 3 * 2880, (name, len(data))
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        for k in SEEKS:
            key = name if k is None else f"{name}@{k}"
            got = pil_read(path, k)
            if isinstance(got, str):
                errors[key] = got
            else:
                reads[key] = got
    np.savez_compressed(os.path.join(HERE, "reads.npz"), **reads)
    with open(os.path.join(HERE, "errors.json"), "w") as f:
        json.dump(errors, f, indent=1, sort_keys=True)
        f.write("\n")
    slides = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (data, seeks) in slide_files().items():
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(data)
            entry = {"file_sha256": hashlib.sha256(data).hexdigest()}
            for k in seeks:
                px = pil_read(path, k)
                assert not isinstance(px, str), (name, k, px)
                entry[f"seek{k}"] = {
                    "dtype": str(px.dtype), "shape": list(px.shape),
                    "sha256": hashlib.sha256(px.tobytes()).hexdigest()}
            slides[name] = entry
    with open(os.path.join(HERE, "slides.json"), "w") as f:
        json.dump(slides, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
