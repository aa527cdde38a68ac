"""Write the fixtures of the icon, animation and texture formats PIL 12.1
reads itself (``unmicst_tpu_torch/io/ico.py``, ``icns.py``, ``blp.py``,
``ftex.py``, ``fli.py``, and ``dds.py`` through ``bcn.py``): small files
of each layout, PIL's read of each, and the digests of the files
``chip_smoke.py`` reads on the card.

    python tests/fixtures/torch_icons/make.py

PIL saves none of these formats as they are written here, so the writers
are here; they need numpy and the standard library only (the card's
machine has no PIL, and ``chip_smoke.py`` loads this file by path for
:func:`slide_files`).  :func:`main` needs PIL and writes, beside this
script:

* ``<name>.<ext>``: each case of :func:`small_cases`;
* ``reads.npz``: PIL's ``np.asarray`` of each file after ``Image.open``
  and after every ``seek(k)`` that succeeds, keyed ``<file>`` (no seek)
  and ``<file>@<k>``, and ``errors.json``: the exception class of each
  read that fails;
* ``slides.json``: for each of :func:`slide_files`' files (4096^2 DDS in
  BC1, BC7, BC6H and BC4, BLP2 DXT5, FTEX DXT1 and a two-frame FLC; a
  1024^2 ICNS ``ic10`` PNG; 256^2 ICOs of a 24-bit BMP and its AND mask
  and of a gray PNG), the sha256 of the file and, at each frame the card
  reads, the dtype, shape and sha256 of PIL's read there.
"""

import hashlib
import json
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.dirname(HERE)
SLIDE = 4096

# -- PNG and BMP entries ------------------------------------------------------


def png(px: np.ndarray, palette: bytes = b"") -> bytes:
    """A PNG of ``px``: uint8 ``[h, w]`` gray (or palette indices with
    ``palette``), ``[h, w, 2]`` gray and alpha, ``[h, w, 3]`` RGB or
    ``[h, w, 4]`` RGBA; filter 0 rows."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape[:2]
    bands = 1 if px.ndim == 2 else px.shape[2]
    colour = 3 if palette else {1: 0, 2: 4, 3: 2, 4: 6}[bands]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           px.reshape(h, w * bands)], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
    if palette:
        out += chunk(b"PLTE", palette)
    return out + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(
        b"IEND", b"")


def dib(px: np.ndarray, bits: int, palette: bytes = b"",
        mask: np.ndarray = None, height_factor: int = 2,
        top_down: bool = False) -> bytes:
    """A DIB (40-byte header) of ``px`` at ``bits`` bits (1-8: indices
    into ``palette``, BGRX entries; 24: RGB stored BGR; 32: RGBA stored
    BGRA), rows bottom-up, then the AND mask (``mask``, 1 where
    transparent) where given; the header's height is ``height_factor``
    times the image's, as icons store it."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    if bits <= 8:
        v = px.astype(np.uint8)
        packed = np.packbits(np.unpackbits(v[..., None], axis=2)[
            ..., 8 - bits :].reshape(h, w * bits), axis=1)
    elif bits == 24:
        packed = px[..., 2::-1].reshape(h, 3 * w)
    else:
        packed = px[..., [2, 1, 0, 3]].reshape(h, 4 * w)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : packed.shape[1]] = packed
    if not top_down:
        rows = rows[::-1]
    colours = len(palette) // 4
    hh = h * height_factor
    head = struct.pack("<IiiHHIIiiII", 40, w, -hh if top_down else hh, 1,
                       bits, 0, stride * h, 0, 0, colours, 0)
    body = head + palette + rows.tobytes()
    if mask is not None:
        mstride = ((w + 31) >> 3) & ~3
        m = np.zeros((h, mstride), np.uint8)
        bits_ = np.packbits(np.asarray(mask, np.uint8), axis=1)
        m[:, : bits_.shape[1]] = bits_
        body += m[::-1].tobytes()
    return body


def ico(entries, kind: int = 1, directory=None) -> bytes:
    """An ICO (``kind`` 1) or CUR (2) of ``entries``, each ``(data, w, h,
    colours, bpp)``; ``directory`` overrides the 16-byte entries' fields
    (a list of dicts by name)."""
    head = struct.pack("<HHH", 0, kind, len(entries))
    pos = 6 + 16 * len(entries)
    dirs, bodies = [], []
    for k, (data, w, h, colours, bpp) in enumerate(entries):
        f = dict(w=w & 255, h=h & 255, colours=colours, planes=1, bpp=bpp,
                 size=len(data), offset=pos)
        if directory and k < len(directory):
            f.update(directory[k])
        dirs.append(struct.pack("<BBBBHHII", f["w"], f["h"], f["colours"], 0,
                                f["planes"], f["bpp"], f["size"],
                                f["offset"]))
        bodies.append(data)
        pos += len(data)
    return head + b"".join(dirs) + b"".join(bodies)


def palette_bgrx(rng, n: int) -> bytes:
    p = rng.randint(0, 256, (n, 4)).astype(np.uint8)
    p[:, 3] = 0
    return p.tobytes()


# -- ICNS ---------------------------------------------------------------------


def icns_rle(plane: np.ndarray) -> bytes:
    """PIL's ICNS plane coding of ``plane``: runs of 3-130 equal bytes as
    ``n + 125`` and the byte, other bytes in literal packets of up to 128."""
    v = plane.ravel().tobytes()
    out, lit, i = bytearray(), bytearray(), 0
    while i < len(v):
        j = i
        while j < len(v) and j - i < 130 and v[j] == v[i]:
            j += 1
        if j - i >= 3:
            while lit:
                out += bytes([min(len(lit), 128) - 1]) + lit[:128]
                lit = lit[128:]
            out += bytes([j - i + 125, v[i]])
            i = j
        else:
            lit.append(v[i])
            i += 1
    while lit:
        out += bytes([min(len(lit), 128) - 1]) + lit[:128]
        lit = lit[128:]
    return bytes(out)


def icns(blocks, filesize=None) -> bytes:
    """An ICNS file of ``blocks`` (``(type, body)``)."""
    body = b"".join(t + struct.pack(">I", len(b) + 8) + b for t, b in blocks)
    return b"icns" + struct.pack(">I", filesize if filesize is not None
                                 else 8 + len(body)) + body


def icns_rgb(px: np.ndarray, rle: bool = True) -> bytes:
    if not rle:
        return np.ascontiguousarray(px, np.uint8).tobytes()
    return b"".join(icns_rle(px[..., c]) for c in range(3))


# -- BLP ----------------------------------------------------------------------


def blp(magic: bytes, w: int, h: int, payload: bytes, compression: int = 1,
        encoding: int = 1, alpha: int = 0, alpha_encoding: int = 0,
        offsets=None, lengths=None, palette: bytes = None,
        jpeg_header: bytes = None) -> bytes:
    """A BLP1 or BLP2 file whose first mipmap is ``payload``."""
    if magic == b"BLP1":
        head = magic + struct.pack("<iIIIii", compression, alpha, w, h,
                                   encoding, 0)
    else:
        head = magic + struct.pack("<ibbbbII", compression, encoding, alpha,
                                   alpha_encoding, 0, w, h)
    table_at = len(head)
    after = table_at + 128
    extra = b""
    if palette is not None:
        extra += palette
    if jpeg_header is not None:
        extra += struct.pack("<I", len(jpeg_header)) + jpeg_header
    start = after + len(extra)
    offs = list(offsets or [start]) + [0] * 15
    lens = list(lengths or [len(payload)]) + [0] * 15
    return (head + struct.pack("<16I", *offs[:16])
            + struct.pack("<16I", *lens[:16]) + extra + payload)


# -- FTEX and DDS -------------------------------------------------------------


def ftex(w: int, h: int, fmt: int, payload: bytes, formats: int = 1,
         size=None) -> bytes:
    head = b"FTEX" + struct.pack("<iiiiiii", 1, w, h, 1, formats, fmt, 32)
    return head + struct.pack("<i", len(payload) if size is None else size) \
        + payload


_FOURCC = {1: b"DXT1", 2: b"DXT3", 3: b"DXT5", 4: b"BC4U", 5: b"BC5U"}


def dds(w: int, h: int, payload: bytes, fourcc: bytes = None,
        dxgi: int = None) -> bytes:
    """A DDS file of block-compressed ``payload``: by ``fourcc``, or by a
    DX10 header's ``dxgi`` format."""
    code = struct.unpack("<I", fourcc if fourcc else b"DX10")[0]
    pf = struct.pack("<4I", 32, 4, code, 0) + bytes(16)
    head = (b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 0)
            + bytes(44) + pf + bytes(20))
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + payload


# -- FLI and FLC --------------------------------------------------------------


def fli_header(w: int, h: int, frames: int, magic: int = 0xAF12,
               flags: int = 3) -> bytes:
    s = bytearray(128)
    struct.pack_into("<IHHHHHH", s, 0, 0, magic, frames, w, h, 8, flags)
    return bytes(s)


def fli_sub(kind: int, payload: bytes) -> bytes:
    return struct.pack("<IH", 6 + len(payload), kind) + payload


def fli_frame(subs, kind: int = 0xF1FA) -> bytes:
    body = b"".join(subs)
    return struct.pack("<IHH", 16 + len(body), kind, len(subs)) + bytes(8) \
        + body


def brun(img: np.ndarray, rng) -> bytes:
    """A BRUN chunk of ``img``: runs and literal packets of random
    lengths (``img`` is changed to what a run repeats)."""
    out = bytearray()
    for row in img:
        out.append(0)
        x = 0
        while x < len(row):
            n = min(int(rng.randint(1, 20)), len(row) - x)
            if rng.rand() < 0.5:
                out += bytes([n, row[x]])
                row[x : x + n] = row[x]
            else:
                out += bytes([256 - n]) + row[x : x + n].tobytes()
            x += n
    return bytes(out)


def lc(h: int, w: int, rng) -> bytes:
    """An LC (byte delta) chunk of random packets."""
    y0 = int(rng.randint(0, h))
    n = int(rng.randint(0, h - y0 + 1))
    out = bytearray(struct.pack("<HH", y0, n))
    for _ in range(n):
        pk, x = [], 0
        while x < w and len(pk) < 6:
            skip = int(rng.randint(0, 4))
            x += skip
            if x >= w:
                break
            c = min(int(rng.randint(1, 8)), w - x)
            if rng.rand() < 0.5:
                pk.append(bytes([skip, 256 - c, int(rng.randint(256))]))
            else:
                pk.append(bytes([skip, c]) + rng.randint(0, 256, c).astype(
                    np.uint8).tobytes())
            x += c
        out += bytes([len(pk)]) + b"".join(pk)
    return bytes(out)


def ss2(h: int, w: int, rng) -> bytes:
    """An SS2 (word delta) chunk of random lines, skips and last-byte
    words."""
    lines, y = [], 0
    while y < h:
        words = b""
        if rng.rand() < 0.3 and y + 2 < h:
            sk = int(rng.randint(1, 3))
            words += struct.pack("<H", 65536 - sk)
            y += sk
        if rng.rand() < 0.3:
            words += struct.pack("<H", 0x8000 | int(rng.randint(256)))
        pk, x = [], 0
        while x < w - 1 and len(pk) < 5:
            skip = int(rng.randint(0, 3))
            x += skip
            c = min(int(rng.randint(1, 4)), (w - x) // 2)
            if c <= 0:
                break
            if rng.rand() < 0.5:
                pk.append(bytes([skip, 256 - c]) + rng.randint(
                    0, 256, 2).astype(np.uint8).tobytes())
            else:
                pk.append(bytes([skip, c]) + rng.randint(
                    0, 256, 2 * c).astype(np.uint8).tobytes())
            x += 2 * c
        lines.append(words + struct.pack("<H", len(pk)) + b"".join(pk))
        y += 1
        if rng.rand() < 0.2:
            break
    return struct.pack("<H", len(lines)) + b"".join(lines)


def fli_palette(rng, shift: bool = False) -> bytes:
    n = int(rng.randint(1, 3))
    out = struct.pack("<H", n)
    for _ in range(n):
        c = int(rng.randint(0, 5))
        out += bytes([int(rng.randint(0, 10)), c]) + rng.randint(
            0, 64 if shift else 256, 3 * (c or 256)).astype(np.uint8).tobytes()
    return out


def fli_random(rng) -> bytes:
    """A small FLI or FLC of 1-4 random frames of every chunk type (an
    unknown one now and then), cut short or with bytes changed now and
    then."""
    w, h = int(rng.randint(1, 12)), int(rng.randint(1, 10))
    img = rng.randint(0, 256, (h, w)).astype(np.uint8)
    frames = []
    nf = int(rng.randint(1, 5))
    for _ in range(nf):
        subs = []
        for _ in range(int(rng.randint(1, 4))):
            k = int(rng.choice([4, 7, 11, 12, 13, 15, 16, 18, 99]))
            if k in (4, 11):
                subs.append(fli_sub(k, fli_palette(rng, k == 11)))
            elif k == 7:
                subs.append(fli_sub(7, ss2(h, w, rng)))
            elif k == 12:
                subs.append(fli_sub(12, lc(h, w, rng)))
            elif k == 13:
                subs.append(fli_sub(13, b""))
            elif k == 15:
                subs.append(fli_sub(15, brun(img.copy(), rng)))
            elif k == 16:
                subs.append(fli_sub(16, rng.randint(0, 256, w * h).astype(
                    np.uint8).tobytes()))
            elif k == 18:
                subs.append(fli_sub(18, bytes(10)))
            else:
                subs.append(fli_sub(int(rng.randint(0, 30)), bytes(4)))
        frames.append(fli_frame(subs))
    data = fli_header(w, h, nf + int(rng.randint(0, 2)),
                      int(rng.choice([0xAF11, 0xAF12]))) + b"".join(frames)
    r = rng.rand()
    if r < 0.15:
        data = data[: int(rng.randint(100, len(data) + 1))]
    elif r < 0.3:
        b = bytearray(data)
        for _ in range(3):
            b[int(rng.randint(128, len(b)))] = int(rng.randint(256))
        data = bytes(b)
    elif r < 0.35:
        data = data[:128] + fli_sub(0xF100, bytes(10)) + data[128:]
    return data


# -- the files of chip_smoke.py's phase 24 ------------------------------------


def blob_slide(rng, h: int, w: int, n_blobs: int) -> np.ndarray:
    """uint8 noise with ringed blobs, as ``chip_smoke.blob_slide``."""
    img = rng.randint(0, 40, (h, w)).astype(np.uint8)
    for _ in range(n_blobs):
        r, c = rng.randint(20, h - 20), rng.randint(20, w - 20)
        rad = rng.randint(5, 9)
        rr, cc = np.ogrid[r - rad - 2 : r + rad + 3, c - rad - 2 : c + rad + 3]
        d2 = (rr - r) ** 2 + (cc - c) ** 2
        win = img[r - rad - 2 : r + rad + 3, c - rad - 2 : c + rad + 3]
        win[d2 < rad ** 2] = 180
        win[(d2 < (rad + 2) ** 2) & (d2 >= rad ** 2)] = 100
    return img


def flc_slide(img: np.ndarray) -> bytes:
    """A two-frame FLC of ``img`` (``[h, w]`` uint8, w at least 512):
    frame 0 a BRUN chunk (each row a run of its first byte over 64
    pixels, then literal packets of at most 128), frame 1 an SS2 chunk
    that rewrites columns 0-127 of every line with ``img``'s columns
    128-255 and sets columns 328-391 to the word (7, 200)."""
    h, w = img.shape
    img = img.copy()
    img[:, :64] = img[:, :1]
    pieces = [np.full((h, 1), 0, np.uint8), np.full((h, 1), 64, np.uint8),
              img[:, :1]]
    packets = 1
    for x in range(64, w, 128):
        n = min(128, w - x)
        pieces += [np.full((h, 1), 256 - n, np.uint8), img[:, x : x + n]]
        packets += 1
    pieces[0][:] = packets & 255  # the count PIL's decoder skips
    frame0 = fli_frame([fli_sub(15, np.concatenate(pieces, 1).tobytes())])
    line = np.concatenate([
        np.broadcast_to(np.array([2, 0, 0, 64], np.uint8), (h, 4)),
        img[:, 128:256],
        np.broadcast_to(np.array([200, 256 - 32, 7, 200], np.uint8),
                        (h, 4))], 1)
    frame1 = fli_frame([fli_sub(7, struct.pack("<H", h) + line.tobytes())])
    return fli_header(w, h, 2) + frame0 + frame1


def slide_files(seed: int = 24, side: int = SLIDE):
    """name -> (file bytes, the frames chip_smoke reads): DDS in BC1, BC7
    and BC6H, BLP2 DXT5 and FTEX DXT1 of seeded blocks at ``side``^2, an
    FLC at ``side``^2 (frames 0 and 1), a 1024^2 ICNS ``ic10`` PNG and a
    256^2 ICO (a 24-bit BMP and its AND mask), each named ``.tif``; and
    the files whose read is one plane, which the CLIs take (they refuse
    colour planes): a ``side``^2 DDS in BC4 (PIL's ``L``) of a blob
    slide's interpolated blocks, and a 256^2 ICO of a gray PNG."""
    rng = np.random.RandomState(seed)
    blocks = (side // 4) ** 2
    out = {}
    for name, dxgi in (("dds_bc1", None), ("dds_bc7", 98), ("dds_bc6h", 95)):
        size = 8 if dxgi is None else 16
        payload = rng.randint(0, 256, blocks * size).astype(np.uint8)
        if dxgi == 95:  # modes 11-14 read as images more than noise
            payload[::16] = 0x03 | (payload[::16] & 0x0C)
        out[f"{name}.tif"] = (dds(side, side, payload.tobytes(),
                                  b"DXT1" if dxgi is None else None, dxgi),
                              [0])
    payload = rng.randint(0, 256, blocks * 16).astype(np.uint8).tobytes()
    out["blp2_dxt5.tif"] = (blp(b"BLP2", side, side, payload, encoding=2,
                                alpha=8, alpha_encoding=7,
                                palette=bytes(1024)), [0])
    payload = rng.randint(0, 256, blocks * 8).astype(np.uint8).tobytes()
    out["ftex_dxt1.tif"] = (ftex(side, side, 0, payload), [0])
    n = max(20, 350 * (side // SLIDE) ** 2)
    out["flc.tif"] = (flc_slide(blob_slide(rng, side, side, n)), [0, 1])
    icon = np.stack([blob_slide(rng, 1024, 1024, 30) for _ in range(4)], 2)
    icon[..., 3] |= 0x80
    out["icns_ic10.tif"] = (icns([(b"ic10", png(icon))]), [0])
    rgb = np.stack([blob_slide(rng, 256, 256, 8) for _ in range(3)], 2)
    mask = rng.randint(0, 2, (256, 256))
    out["ico_bmp24.tif"] = (ico([(dib(rgb, 24, mask=mask), 256, 256, 0,
                                  24)]), [0])
    out["dds_bc4.tif"] = (dds(side, side, bc4_blocks(blob_slide(
        rng, side, side, n)), b"BC4U"), [0])
    out["ico_png_gray.tif"] = (ico([(png(blob_slide(rng, 256, 256, 8)),
                                     256, 256, 0, 8)]), [0])
    return out


def bc4_blocks(img: np.ndarray) -> bytes:
    """BC4 blocks of ``img`` (``[h, w]`` uint8, sides multiples of 4):
    each block's maximum and minimum as the endpoints (six interpolated
    steps), each pixel the nearest of the eight values."""
    h, w = img.shape
    b = img.reshape(h // 4, 4, w // 4, 4).transpose(0, 2, 1, 3).reshape(
        -1, 16).astype(np.int64)
    a0, a1 = b.max(1), b.min(1)
    vals = np.stack([a0, a1] + [((6 - k) * a0 + (k + 1) * a1) // 7
                                for k in range(6)], 1)
    flat = a0 == a1
    vals[flat, 1] = np.maximum(a0[flat] - 1, 0)  # a0 > a1 wherever
    idx = np.abs(b[:, :, None] - vals[:, None, :]).argmin(2)
    bits = (idx << (3 * np.arange(16))).sum(1)
    out = np.zeros((len(b), 8), np.uint8)
    out[:, 0], out[:, 1] = vals[:, 0], vals[:, 1]
    for k in range(6):
        out[:, 2 + k] = (bits >> (8 * k)) & 255
    return out.tobytes()


# -- the small fixtures -------------------------------------------------------


def small_cases():
    """name -> file bytes of every layout the readers take, and some they
    refuse."""
    rng = np.random.RandomState(240)
    c = {}
    # ICO: BMP entries of every depth, with masks, and PNG entries
    for bits in (1, 4, 8, 24, 32):
        w, h = 7 + bits % 5, 5 + bits % 3
        if bits <= 8:
            pal = palette_bgrx(rng, 1 << bits)
            px = rng.randint(0, 1 << bits, (h, w))
        else:
            pal = b""
            px = rng.randint(0, 256, (h, w, bits // 8))
        mask = rng.randint(0, 2, (h, w))
        data = dib(px, bits, pal, mask)
        c[f"ico_bmp{bits}.ico"] = ico([(data, w, h, 0, bits)])
        c[f"ico_bmp{bits}_cut.ico"] = c[f"ico_bmp{bits}.ico"][:-3]
    gray = np.arange(256, dtype=np.uint8).repeat(4).reshape(256, 4)
    gray[:, 3] = 0
    c["ico_bmp8_gray.ico"] = ico([(dib(rng.randint(0, 256, (6, 9)), 8,
                                       gray.tobytes(),
                                       rng.randint(0, 2, (6, 9))), 9, 6, 0,
                                   8)])
    c["ico_bmp4_short_palette.ico"] = ico([(dib(
        rng.randint(0, 16, (5, 6)), 4, palette_bgrx(rng, 3),
        rng.randint(0, 2, (5, 6))), 6, 5, 3, 4)])
    c["ico_bmp32_dir24.ico"] = ico([(dib(rng.randint(0, 256, (4, 5, 4)), 32,
                                         mask=rng.randint(0, 2, (4, 5))), 5,
                                     4, 0, 24)])
    c["ico_bmp24_dir32.ico"] = ico([(dib(rng.randint(0, 256, (4, 5, 3)), 24,
                                         mask=rng.randint(0, 2, (4, 5))), 5,
                                     4, 0, 32)])
    c["ico_bmp24_top_down.ico"] = ico([(dib(
        rng.randint(0, 256, (4, 6, 3)), 24, mask=rng.randint(0, 2, (4, 6)),
        top_down=True), 6, 4, 0, 24)])
    c["ico_png_rgba.ico"] = ico([(png(rng.randint(0, 256, (6, 7, 4))), 7, 6,
                                  0, 32)])
    c["ico_png_gray.ico"] = ico([(png(rng.randint(0, 256, (5, 5))), 5, 5, 0,
                                  8)])
    c["ico_png_palette.ico"] = ico([(png(rng.randint(0, 4, (4, 6)),
                                         bytes(range(12))), 6, 4, 4, 0)])
    c["ico_png_size_mismatch.ico"] = ico([(png(rng.randint(
        0, 256, (8, 8, 3))), 6, 6, 0, 24)])
    small = dib(rng.randint(0, 256, (3, 4, 3)), 24,
                mask=rng.randint(0, 2, (3, 4)))
    big = png(rng.randint(0, 256, (9, 9, 4)))
    mid = dib(rng.randint(0, 16, (5, 5)), 4, palette_bgrx(rng, 16),
              rng.randint(0, 2, (5, 5)))
    same = dib(rng.randint(0, 256, (5, 5, 4)), 32,
               mask=rng.randint(0, 2, (5, 5)))
    c["ico_sizes.ico"] = ico([(small, 4, 3, 0, 24), (big, 9, 9, 0, 32),
                              (mid, 5, 5, 16, 4)])
    c["ico_depths.ico"] = ico([(mid, 5, 5, 16, 4), (same, 5, 5, 0, 32)])
    c["ico_no_entries.ico"] = ico([])
    c["ico_mask_before_start.ico"] = ico([(small, 4, 3, 0, 24)],
                                         directory=[dict(size=4)])
    c["ico_dir_size_short.ico"] = ico([(small, 4, 3, 0, 24)],
                                      directory=[dict(size=len(small) + 40)])
    # CUR
    for bits in (8, 24):
        w, h = 6, 5
        pal = palette_bgrx(rng, 256) if bits == 8 else b""
        px = rng.randint(0, 256, (h, w) if bits == 8 else (h, w, 3))
        c[f"cur_bmp{bits}.cur"] = ico([(dib(px, bits, pal,
                                            rng.randint(0, 2, (h, w))), w,
                                        h, 0, bits)], kind=2)
    c["cur_two.cur"] = ico([(small, 4, 3, 0, 24), (mid, 5, 5, 0, 4)],
                           kind=2)
    c["cur_cut.cur"] = c["cur_bmp24.cur"][:-40]
    # ICNS
    for code, side in ((b"is32", 16), (b"il32", 32), (b"ih32", 48),
                       (b"it32", 128)):
        px = rng.randint(0, 4, (side, side, 3)).astype(np.uint8) * 60
        px[side // 2 :] = 7
        body = (bytes(4) if code == b"it32" else b"") + icns_rgb(px)
        mk = {b"is32": b"s8mk", b"il32": b"l8mk", b"ih32": b"h8mk",
              b"it32": b"t8mk"}[code]
        name = code.decode()
        c[f"icns_{name}.icns"] = icns([(code, body)])
        c[f"icns_{name}_mask.icns"] = icns([
            (code, body), (mk, rng.randint(0, 256, side * side).astype(
                np.uint8).tobytes())])
    px = rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)
    c["icns_is32_raw.icns"] = icns([(b"is32", icns_rgb(px, rle=False))])
    c["icns_is32_overrun.icns"] = icns([(b"is32", b"\xff\x01" * 3)])
    c["icns_is32_short.icns"] = icns([(b"is32", b"\x85\x01")])
    c["icns_it32_badsig.icns"] = icns([(b"it32", b"\x00\x00\x00\x01"
                                        + icns_rgb(px))])
    c["icns_mask_only.icns"] = icns([(b"s8mk", bytes(256))])
    c["icns_ic07_png.icns"] = icns([(b"ic07", png(rng.randint(
        0, 256, (128, 128, 4))))])
    c["icns_icp4_gray_png.icns"] = icns([(b"icp4", png(rng.randint(
        0, 256, (16, 16))))])
    c["icns_ic08_png_half.icns"] = icns([(b"ic08", png(rng.randint(
        0, 256, (128, 128, 3))))])
    c["icns_ic08_png_odd.icns"] = icns([(b"ic08", png(rng.randint(
        0, 256, (100, 100, 3))))])
    c["icns_png_and_rgb.icns"] = icns([
        (b"ic07", png(rng.randint(0, 256, (128, 128, 3)))),
        (b"it32", bytes(4) + icns_rgb(np.full((128, 128, 3), 9, np.uint8))),
        (b"t8mk", bytes(128 * 128))])
    for jp2 in ("l_lrcp.jp2", "rgb_53_mct_layers.jp2", "la_offsets.jp2",
                "rgba_cprl_97_mct.jp2", "l_tiny.j2k"):
        with open(os.path.join(FIXTURES, "torch_j2k", jp2), "rb") as f:
            c[f"icns_ic09_{jp2.split('.')[0]}.icns"] = icns([(b"ic09",
                                                              f.read())])
    c["icns_unknown_entry.icns"] = icns([(b"icp5", b"not a png at all")])
    c["icns_bad_block.icns"] = icns([(b"is32", b"")])[:12] + bytes(4)
    c["icns_filesize_short.icns"] = icns([(b"is32", icns_rgb(px))],
                                         filesize=4)
    c["icns_cut_header.icns"] = icns([(b"is32", icns_rgb(px))])[:12]
    # BLP
    pal = rng.randint(0, 256, 1024).astype(np.uint8).tobytes()
    for alpha in (0, 8):
        idx = rng.randint(0, 256, 6 * 7).astype(np.uint8).tobytes()
        c[f"blp1_palette_a{alpha}.blp"] = blp(b"BLP1", 7, 6, idx, 1, 4,
                                              alpha, palette=pal)
        c[f"blp2_palette_a{alpha}.blp"] = blp(b"BLP2", 7, 6, idx, 1, 1,
                                              alpha, palette=pal)
        for ae, size in ((0, 8), (1, 16), (7, 16)):
            for w, h in ((8, 8), (7, 6)):
                nb = ((w + 3) // 4) * ((h + 3) // 4)
                blocks = rng.randint(0, 256, (nb, size)).astype(np.uint8)
                if ae == 0:
                    blocks[::2, :2], blocks[::2, 2:4] = (
                        blocks[::2, 2:4].copy(), blocks[::2, :2].copy())
                c[f"blp2_dxt{ {0: 1, 1: 3, 7: 5}[ae]}_a{alpha}_{w}x{h}.blp"] \
                    = blp(b"BLP2", w, h, blocks.tobytes(), 1, 2, alpha, ae,
                          palette=pal)
    c["blp1_palette_short.blp"] = blp(b"BLP1", 7, 6, bytes(20), 1, 5, 0,
                                      palette=pal)
    c["blp1_encoding3.blp"] = blp(b"BLP1", 4, 4, bytes(16), 1, 3, 0,
                                  palette=pal)
    c["blp1_compression2.blp"] = blp(b"BLP1", 4, 4, bytes(16), 2, 4, 0,
                                     palette=pal)
    c["blp2_raw_bgra.blp"] = blp(b"BLP2", 4, 4, bytes(64), 1, 3, 8,
                                 palette=pal)
    c["blp2_compression0.blp"] = blp(b"BLP2", 4, 4, bytes(64), 0, 1, 0,
                                     palette=pal)
    c["blp2_alpha_encoding2.blp"] = blp(b"BLP2", 4, 4, bytes(16), 1, 2, 0, 2,
                                        palette=pal)
    c["blp2_no_palette.blp"] = blp(b"BLP2", 4, 4, bytes(16), 1, 1, 0)
    c["blp2_dxt1_cut.blp"] = c["blp2_dxt1_a0_8x8.blp"][:-5]
    c["blp_cut_header.blp"] = c["blp2_dxt1_a0_8x8.blp"][:15]
    with open(os.path.join(FIXTURES, "torch_jpeg", "odd_baseline.jpg"),
              "rb") as f:
        jpg = f.read()
    sos = jpg.index(b"\xff\xda")
    jh, jw = struct.unpack(">HH", jpg[jpg.index(b"\xff\xc0") + 5 :][:4])
    for alpha in (0, 8):
        c[f"blp1_jpeg_a{alpha}.blp"] = blp(b"BLP1", jw, jh, jpg[sos:], 0, 0,
                                           alpha, jpeg_header=jpg[:sos])
    c["blp1_jpeg_not_jpeg.blp"] = blp(b"BLP1", 4, 4, b"xx", 0, 0, 0,
                                      jpeg_header=b"notjpeg")
    # FTEX
    for w, h in ((8, 8), (7, 5)):
        nb = ((w + 3) // 4) * ((h + 3) // 4)
        c[f"ftex_dxt1_{w}x{h}.ftc"] = ftex(w, h, 0, rng.randint(
            0, 256, nb * 8).astype(np.uint8).tobytes())
        c[f"ftex_rgb_{w}x{h}.ftu"] = ftex(w, h, 1, rng.randint(
            0, 256, w * h * 3).astype(np.uint8).tobytes())
    c["ftex_rgb_cut.ftu"] = c["ftex_rgb_8x8.ftu"][:-7]
    c["ftex_dxt1_cut.ftc"] = c["ftex_dxt1_8x8.ftc"][:-3]
    c["ftex_two_formats.ftc"] = ftex(4, 4, 0, bytes(8), formats=2)
    c["ftex_format2.ftc"] = ftex(4, 4, 2, bytes(8))
    c["ftex_size_negative.ftu"] = ftex(2, 2, 1, bytes(12), size=-1)
    # DDS in each block format, by fourcc and by DX10 name
    for n in (1, 2, 3, 4, 5):
        size = 8 if n in (1, 4) else 16
        blocks = rng.randint(0, 256, (6, size)).astype(np.uint8).tobytes()
        c[f"dds_{_FOURCC[n].decode().lower()}.dds"] = dds(11, 7, blocks,
                                                          _FOURCC[n])
    blocks16 = rng.randint(0, 256, (6, 16)).astype(np.uint8).tobytes()
    for fourcc in (b"ATI1", b"ATI2", b"BC5S", b"BC4S"):
        c[f"dds_{fourcc.decode().lower()}.dds"] = dds(
            11, 7, blocks16 if fourcc != b"ATI1" else blocks16[:48], fourcc)
    for dxgi, name in ((71, "bc1"), (74, "bc2"), (77, "bc3"), (80, "bc4"),
                       (83, "bc5"), (84, "bc5s"), (95, "bc6h"),
                       (96, "bc6hs"), (98, "bc7"), (99, "bc7_srgb"),
                       (72, "bc1_srgb")):
        size = 8 if name.startswith(("bc1", "bc4")) else 16
        blocks = rng.randint(0, 256, (6, size)).astype(np.uint8)
        if name == "bc7":
            blocks[0, 0] = 0
        c[f"dds_dx10_{name}.dds"] = dds(11, 7, blocks.tobytes(), dxgi=dxgi)
    c["dds_dx10_bc7_cut.dds"] = c["dds_dx10_bc7.dds"][:-20]
    c["dds_dxt1_cut.dds"] = c["dds_dxt1.dds"][:-1]
    # FLI and FLC: every chunk type
    w, h = 9, 6
    img = rng.randint(0, 256, (h, w)).astype(np.uint8)
    frames = [fli_frame([fli_sub(4, fli_palette(rng)),
                         fli_sub(15, brun(img.copy(), rng))]),
              fli_frame([fli_sub(7, ss2(h, w, rng)), fli_sub(18, bytes(8))]),
              fli_frame([fli_sub(12, lc(h, w, rng))]),
              fli_frame([fli_sub(16, rng.randint(0, 256, w * h).astype(
                  np.uint8).tobytes())]),
              fli_frame([fli_sub(11, fli_palette(rng, True)),
                         fli_sub(13, b"")])]
    c["fli_chunks.flc"] = fli_header(w, h, 5) + b"".join(frames)
    c["fli_chunks.fli"] = fli_header(w, h, 5, 0xAF11) + b"".join(frames)
    c["fli_unknown_chunk.flc"] = fli_header(w, h, 2) + frames[0] + fli_frame(
        [fli_sub(5, bytes(4))])
    c["fli_prefix.flc"] = (fli_header(w, h, 2) + fli_sub(0xF100, bytes(10))
                           + frames[0] + frames[1])
    c["fli_missing_frame.flc"] = fli_header(w, h, 4) + frames[0] + frames[1]
    c["fli_cut.flc"] = c["fli_chunks.flc"][:-30]
    c["fli_no_frames.flc"] = fli_header(w, h, 0) + frames[0]
    c["fli_bad_palette.flc"] = fli_header(w, h, 1) + fli_frame(
        [fli_sub(4, b"\x01\x00\xff\x02\x00\x00\x00\x00\x00\x00")])
    # EPS, as far as PIL's _open: opened (the read stays refused), handed
    # on, or refused
    c["eps_ok.eps"] = (b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 5 4\n"
                       b"%%EndComments\nshowpage\n")
    c["eps_imagedata.eps"] = (b"%!PS-Adobe-3.0\n%%BoundingBox: 0 0 5 4\n"
                              b"%%EndComments\n%ImageData: 3 2 8 3 0 1 1 "
                              b"\"beginimage\"\n")
    c["eps_no_bbox.eps"] = b"%!PS-Adobe-3.0\n%%EndComments\n"
    c["eps_atend.eps"] = (b"%!PS-Adobe-3.0\n%%BoundingBox: (atend)\n"
                          b"%%EndComments\n%%Trailer\n"
                          b"%%BoundingBox: 1 2 8 9\n%%EOF\n")
    c["eps_bad_header.eps"] = b"%!PS-Adobe-3.0\nnot a comment\n"
    c["eps_dos.eps"] = (struct.pack("<III", 0xC6D3D0C5, 12, 60) + bytes(18)
                        + b"%!PS-Adobe-3.0\n%%BoundingBox: 0 0 3 3\n"
                        b"%%EndComments\n")
    return c


SEEKS = (None, 0, 1, 2, 3, 4, 5)


def pil_read(path: str, k):
    """PIL's ``np.asarray`` of ``path`` after ``seek(k)`` (None: none),
    or the exception's class name."""
    import warnings

    from PIL import Image

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
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
