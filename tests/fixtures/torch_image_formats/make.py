"""Write the fixtures of the toolbox's ``imread`` / ``imwrite`` formats
(``unmicst_tpu_torch/io/png.py``, ``io/bmp.py``): every PNG kind, BMPs of
every depth and coding PIL reads, and PIL's writes of each dtype.

    python tests/fixtures/torch_image_formats/make.py

Needs numpy and PIL.  Writes, beside this script:

* ``png_*.png``: 13 x 17 PNGs written here (PIL writes few of these
  kinds): gray at 1, 2, 4, 8 and 16 bits, RGB and RGBA at 8 and 16, gray
  with alpha at 8 and 16, palette at 1, 2, 4 and 8 (one with ``tRNS``,
  one without ``PLTE``), each also Adam7-interlaced, rows filtered with
  every filter type in turn;
* ``bmp_*.bmp``: 13 x 7 BMPs written here: 1-, 4- and 8-bit palette
  images (colour, black/white and the gray ramp, bottom-up and top-down,
  one with the OS/2 core header), RLE8 and RLE4, 16-bit (5-5-5, and 5-6-5
  by BITFIELDS), 24-bit and 32-bit (BGRX, and RGBA by BITFIELDS in a v5
  header);
* each file's read by PIL, ``np.asarray(Image.open(path))``, as
  ``.npy``;
* ``write_*.npy``: seeded arrays of each dtype the writers take (bool,
  uint8 gray, gray+alpha, RGB and RGBA, uint16, int8, int16, int32,
  uint32), and ``write_*_png.npy`` / ``write_*_bmp.npy``: PIL's read of
  ``Image.fromarray(x).save(...)`` of each, where PIL writes it.

The card's machine has no PIL, so ``chip_smoke.py`` compares the port
with these ``.npy`` files.
"""

import io
import os
import struct
import warnings
import zlib

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
WRITES = {"bool": (np.bool_, 0), "gray": (np.uint8, 0),
          "la": (np.uint8, 2), "rgb": (np.uint8, 3), "rgba": (np.uint8, 4),
          "uint16": (np.uint16, 0), "int8": (np.int8, 0),
          "int16": (np.int16, 0), "int32": (np.int32, 0),
          "uint32": (np.uint32, 0)}


def chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def packed_rows(samples, depth: int) -> np.ndarray:
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    shifts = np.arange(depth - 1, -1, -1, dtype=np.uint8)
    v = samples.reshape(h, -1).astype(np.uint8)
    return np.packbits(((v[:, :, None] >> shifts) & 1).reshape(h, -1), 1)


def filtered(rows: np.ndarray, bpp: int, first: int) -> bytes:
    """Each row filtered with type ``(first + y) % 5``."""
    out, prior = [], np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        kind = (first + y) % 5
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        out.append(bytes([kind]) + ((row - pred) & 255).astype(
            np.uint8).tobytes())
        prior = row
    return b"".join(out)


def png(samples, depth: int, colour: int, interlace: int, plte=None,
        trns=None) -> bytes:
    h, w = samples.shape[:2]
    bpp = max(1, CHANNELS[colour] * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for k, (x0, y0, dx, dy) in enumerate(passes):
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            raw += filtered(packed_rows(sub, depth), bpp, k)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if plte is not None:
        out += chunk(b"PLTE", plte)
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def save(name: str, data: bytes) -> None:
    path = os.path.join(HERE, name)
    with open(path, "wb") as f:
        f.write(data)
    with Image.open(path) as im:
        np.save(path.rsplit(".", 1)[0] + ".npy", np.asarray(im))


def pngs(rng) -> None:
    h, w = 13, 17
    for colour, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                           (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16))):
        for depth in depths:
            shape = (h, w) + ((CHANNELS[colour],) if colour not in (0, 3)
                              else ())
            samples = rng.randint(0, 1 << depth, shape)
            plte = (bytes(rng.randint(0, 256, 3 << depth).astype(np.uint8))
                    if colour == 3 else None)
            for interlace in (0, 1):
                tag = "_adam7" if interlace else ""
                save(f"png_c{colour}_{depth}{tag}.png",
                     png(samples, depth, colour, interlace, plte))
    samples = rng.randint(0, 256, (h, w))
    save("png_c3_8_trns.png", png(samples, 8, 3, 1, bytes(768),
                                  bytes([0, 128, 255])))
    save("png_c3_8_noplte.png", png(samples, 8, 3, 0))
    save("png_c0_8_trns.png", png(samples, 8, 0, 0, trns=b"\x00\x07"))


def bmp(w, h, bits, data, palette=b"", compression=0, header=40,
        masks=None, topdown=False) -> bytes:
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        colours = len(palette) // 4
        info = struct.pack("<IIIHHIIiiII", header, w,
                           (2**32 - h) if topdown else h, 1, bits,
                           compression, len(data), 2835, 2835, colours, 0)
        if header > 40:
            info += struct.pack("<4I", *(list(masks) + [0] * 4)[:4])
            info = (info + bytes(header))[:header]
    extra = (struct.pack("<3I", *masks[:3])
             if header == 40 and compression == 3 else b"")
    off = 14 + len(info) + len(extra) + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + info
            + extra + palette + data)


def bmp_rows(rows, topdown=False) -> bytes:
    rows = [bytes(r) + bytes((-len(r)) % 4) for r in rows]
    return b"".join(rows if topdown else rows[::-1])


def rle8(px) -> bytes:
    """RLE8 of ``px`` (rows in file order): runs of 2 or more as encoded
    runs, the rest as absolute runs (or single encoded pixels)."""
    out = bytearray()
    for row in px:
        i, n = 0, len(row)
        while i < n:
            j = i
            while j < n and j - i < 255 and row[j] == row[i]:
                j += 1
            if j - i >= 2 or n - i < 3:
                out += bytes((j - i, row[i]))
                i = j
                continue
            k = i + 1
            while k < n and k - i < 255 and row[k] != row[k - 1]:
                k += 1
            lit = bytes(row[i:k])
            if len(lit) < 3:
                out += b"".join(bytes((1, v)) for v in lit)
            else:
                out += bytes((0, len(lit))) + lit + bytes(len(lit) % 2)
            i = k
        out += b"\0\0"
    return bytes(out + b"\0\1")


def rle4(px) -> bytes:
    """RLE4: absolute runs of 4 pixels, and encoded runs of two
    alternating nibbles."""
    out = bytearray()
    for row in px:
        i, n = 0, len(row)
        while i < n:
            if n - i >= 6 and i % 3 == 0:
                a = row[i:i + 4]
                out += bytes((0, 4, (a[0] << 4) | a[1], (a[2] << 4) | a[3]))
                i += 4
                continue
            j = i + 1
            while j < n and j - i < 40 and row[j] == row[i + (j - i) % 2]:
                j += 1
            second = row[i + 1] if i + 1 < n else 0
            out += bytes((j - i, (row[i] << 4) | second))
            i = j
        out += b"\0\0"
    return bytes(out + b"\0\1")


def palette(rng, n: int, kind: str, entry: int = 4) -> bytes:
    if kind == "bw":
        rgb = np.array([[0] * 3, [255] * 3])
    elif kind == "ramp":
        rgb = np.repeat(np.arange(n)[:, None], 3, 1)
    else:
        rgb = rng.randint(0, 256, (n, 3))
    return b"".join(bytes((b, g, r)) + bytes(entry - 3) for r, g, b in rgb)


def bmps(rng) -> None:
    w, h = 13, 7
    for bits, kinds in ((1, ("colour", "bw")), (4, ("colour",)),
                        (8, ("colour", "ramp"))):
        idx = rng.randint(0, 1 << bits, (h, w)).astype(np.uint8)
        shifts = np.arange(bits - 1, -1, -1, dtype=np.uint8)
        packed = np.packbits(((idx[:, :, None] >> shifts) & 1).reshape(
            h, -1), 1)
        for kind in kinds:
            pal = palette(rng, 1 << bits, kind)
            save(f"bmp_{bits}bit_{kind}.bmp", bmp(w, h, bits,
                                                  bmp_rows(packed), pal))
            save(f"bmp_{bits}bit_{kind}_topdown.bmp",
                 bmp(w, h, bits, bmp_rows(packed, True), pal, topdown=True))
        save(f"bmp_{bits}bit_core.bmp", bmp(
            w, h, bits, bmp_rows(packed), palette(rng, 1 << bits, "colour",
                                                  3), header=12))
        if bits == 8:
            for kind in ("colour", "ramp"):
                save(f"bmp_rle8_{kind}.bmp", bmp(
                    w, h, 8, rle8(idx[::-1]), palette(rng, 256, kind), 1))
        if bits == 4:
            save("bmp_rle4.bmp", bmp(w, h, 4, rle4(idx[::-1]),
                                     palette(rng, 16, "colour"), 2))
    v = rng.randint(0, 65536, (h, w)).astype("<u2")
    save("bmp_16bit_555.bmp", bmp(w, h, 16, bmp_rows(r.tobytes() for r in v)))
    save("bmp_16bit_565.bmp", bmp(w, h, 16, bmp_rows(r.tobytes() for r in v),
                                  compression=3, masks=(0xF800, 0x7E0, 0x1F)))
    px = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
    save("bmp_24bit.bmp", bmp(w, h, 24, bmp_rows(r[:, :3].tobytes()
                                                 for r in px)))
    save("bmp_24bit_topdown.bmp", bmp(w, h, 24, bmp_rows(
        [r[:, :3].tobytes() for r in px], True), topdown=True))
    save("bmp_32bit.bmp", bmp(w, h, 32, bmp_rows(r.tobytes() for r in px)))
    save("bmp_32bit_rgba_v5.bmp", bmp(
        w, h, 32, bmp_rows(r.tobytes() for r in px), compression=3,
        header=124, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)))


def write_inputs(rng) -> dict:
    """The seeded arrays the writers are held to, 9 x 11."""
    out = {}
    for name, (dtype, channels) in WRITES.items():
        shape = (9, 11) + ((channels,) if channels else ())
        if dtype == np.bool_:
            x = rng.rand(*shape) < 0.5
        else:
            info = np.iinfo(dtype)
            x = rng.randint(info.min, int(info.max) + 1, shape,
                            dtype=np.int64).astype(dtype)
        out[name] = x
    return out


def writes(rng) -> None:
    for name, x in write_inputs(rng).items():
        np.save(os.path.join(HERE, f"write_{name}.npy"), x)
        for ext in ("png", "bmp"):
            buf = io.BytesIO()
            try:
                with warnings.catch_warnings():  # PIL 12: mode I as PNG
                    warnings.simplefilter("ignore", DeprecationWarning)
                    Image.fromarray(x).save(buf, ext.upper())
            except OSError:
                continue  # PIL writes no such file; the tests pin its error
            with Image.open(io.BytesIO(buf.getvalue())) as im:
                np.save(os.path.join(HERE, f"write_{name}_{ext}.npy"),
                        np.asarray(im))


def main() -> None:
    rng = np.random.RandomState(17)
    pngs(rng)
    bmps(rng)
    writes(rng)


if __name__ == "__main__":
    main()
