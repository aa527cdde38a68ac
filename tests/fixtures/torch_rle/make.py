"""Write the TGA, SGI, PCX and DCX fixtures (``unmicst_tpu_torch/io/tga.py``,
``io/sgi.py``, ``io/pcx.py``): files of the kinds PIL reads, with PIL's
read of each, and PIL's writes of each dtype ``imwrite`` takes.

    python tests/fixtures/torch_rle/make.py

The file functions (:func:`tga`, :func:`tga_rle`, :func:`sgi`, :func:`pcx`,
:func:`dcx`) and :func:`read_cases` / :func:`write_arrays` need numpy
only; :func:`main` needs PIL and writes, beside this script:

* ``<name>.<tga|sgi|pcx|dcx>``: every case of :func:`read_cases`;
* ``<name>.npz``: PIL's ``np.asarray`` after ``seek(k)`` of each frame
  it reads, as ``frame0``, ``frame1``, ...;
* ``write_<name>.npy`` and ``write_<name>.<ext>``: a seeded array and the
  file ``Image.fromarray(x).save`` writes for it.

The card's machine has no PIL, so ``chip_smoke.py`` compares the port
with these files, and makes its slides with these functions.
"""

import os
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FOOTER = b"\0" * 8 + b"TRUEVISION-XFILE.\0"


# -- TGA ----------------------------------------------------------------------


def tga(imagetype: int, depth: int, w: int, h: int, body: bytes,
        flags: int = 0, idsec: bytes = b"", cmap: bytes = b"",
        cmap_depth: int = 0, cmap_first: int = 0,
        footer: bool = True) -> bytes:
    """A TGA file: the 18-byte header, the id section, the colour map
    (``cmap``, ``len // (cmap_depth // 8)`` entries from ``cmap_first``;
    empty: none) and ``body``."""
    entries = len(cmap) // (cmap_depth // 8) if cmap else 0
    head = struct.pack("<BBBHHBHHHHBB", len(idsec), 1 if cmap else 0,
                       imagetype, cmap_first, entries,
                       cmap_depth if cmap else 0, 0, 0, w, h, depth, flags)
    return head + idsec + cmap + body + (FOOTER if footer else b"")


def tga_rle(pixels: np.ndarray) -> bytes:
    """TGA RLE of ``pixels`` (``[h, w, bytes]`` uint8, rows in file order):
    a run packet for each run of two or more equal pixels within a row (at
    most 128), the other pixels in raw packets of at most 128 that run on
    across rows, as Pillow's decoder takes them."""
    h, w, d = pixels.shape
    out, lit = [], []

    def flush():
        while lit:
            chunk = lit[:128]
            del lit[:128]
            out.append(bytes([len(chunk) - 1]) + b"".join(chunk))

    for row in pixels:
        change = np.flatnonzero((row[1:] != row[:-1]).any(1)) + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [w]])
        for s, e in zip(starts.tolist(), ends.tolist()):
            px = row[s].tobytes()
            if e - s == 1:
                lit.append(px)
                if len(lit) == 128:
                    flush()
                continue
            flush()
            n = e - s
            while n:
                k = min(n, 128)
                out.append(bytes([0x80 | (k - 1)]) + px)
                n -= k
    flush()
    return b"".join(out)


# -- SGI ----------------------------------------------------------------------


def sgi_rle_row(samples: np.ndarray, bpc: int) -> bytes:
    """One row of one channel in SGI RLE: runs of three or more equal
    samples as repeat packets, the samples between them as copy packets
    (at most 127 samples a packet), then the end packet."""
    n = len(samples)
    raw = np.ascontiguousarray(samples, ">u2" if bpc == 2 else np.uint8)
    change = np.flatnonzero(samples[1:] != samples[:-1]) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    long = (ends - starts) >= 3
    out = []

    def word(count):
        return bytes([0, count]) if bpc == 2 else bytes([count])

    def copy(a, b):
        for k in range(a, b, 127):
            m = min(127, b - k)
            out.append(word(0x80 | m) + raw[k : k + m].tobytes())

    pos = 0
    for s, e in zip(starts[long].tolist(), ends[long].tolist()):
        copy(pos, s)
        for k in range(s, e, 127):
            out.append(word(min(127, e - k)) + raw[s : s + 1].tobytes())
        pos = e
    copy(pos, n)
    out.append(word(0))
    return b"".join(out)


def sgi(samples: np.ndarray, bpc: int = 1, rle: bool = False,
        dimension: int = None, name: bytes = b"") -> bytes:
    """An SGI file of ``samples`` (``[h, w]`` or ``[h, w, z]``, top row
    first; stored bottom-up, channel by channel), ``bpc`` bytes a sample,
    verbatim or RLE (start and length tables, lengths in bytes)."""
    x = np.asarray(samples)
    if x.ndim == 2:
        x = x[:, :, None]
    h, w, z = x.shape
    dim = dimension or (3 if z > 1 else (1 if h == 1 else 2))
    head = struct.pack(">hBBHHHHll4s79ss", 474, int(rle), bpc, dim, w, h, z,
                       0, 255 if bpc == 1 else 65535, b"", name, b"")
    head += struct.pack(">l404s", 0, b"")
    planes = x[::-1].transpose(2, 0, 1)  # [z, h, w], bottom row first
    if not rle:
        return head + planes.astype(">u2" if bpc == 2 else np.uint8).tobytes()
    rows = [sgi_rle_row(planes[c, y], bpc) for c in range(z) for y in range(h)]
    starts, pos = [], 512 + 8 * h * z
    for r in rows:
        starts.append(pos)
        pos += len(r)
    tables = struct.pack(f">{2 * h * z}I", *starts, *(len(r) for r in rows))
    return head + tables + b"".join(rows)


# -- PCX and DCX --------------------------------------------------------------


def pcx_rle(rows: np.ndarray) -> bytes:
    """PCX RLE of ``rows`` (``[h, row_bytes]``), each row on its own: runs
    of equal bytes (at most 63) and any byte of 0xC0 or above as a run,
    the rest as themselves."""
    out = bytearray()
    for row in rows.tolist():
        i = 0
        while i < len(row):
            j = i
            while j + 1 < len(row) and row[j + 1] == row[i] and j - i < 62:
                j += 1
            n = j - i + 1
            if n > 1 or row[i] >= 0xC0:
                out += bytes([0xC0 | n, row[i]])
            else:
                out.append(row[i])
            i = j + 1
    return bytes(out)


def pcx(rows: np.ndarray, w: int, h: int, bits: int, planes: int,
        version: int = 5, stride: int = None, tail: bytes = b"") -> bytes:
    """A PCX file: the 128-byte header (``stride`` bytes a plane's row, as
    the header gives it), the RLE of ``rows`` (``[h, planes *
    row_stride]``) and ``tail`` (a 0x0C byte and a 768-byte palette)."""
    stride = stride if stride is not None else rows.shape[1] // planes
    head = (struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1,
                        h - 1, 72, 72) + bytes(48) + b"\0"
            + struct.pack("<BHHHH", planes, stride, 1, w, h) + bytes(54))
    return head + pcx_rle(rows) + tail


def dcx(frames) -> bytes:
    """A DCX file of the PCX files ``frames``: the magic, the offset
    table ended by a zero, then the frames."""
    pos = 4 + 4 * (len(frames) + 1)
    offsets = []
    for f in frames:
        offsets.append(pos)
        pos += len(f)
    return (struct.pack(f"<I{len(frames) + 1}I", 0x3ADE68B1, *offsets, 0)
            + b"".join(frames))


def _planes(img: np.ndarray, bits: int, planes: int,
            stride: int) -> np.ndarray:
    """``[h, planes * stride]`` rows of a PCX image: 8-bit planes
    (``[h, w]`` or ``[h, w, 3]``) or bit planes of the indices."""
    h, w = img.shape[:2]
    out = np.zeros((h, planes, stride), np.uint8)
    if bits == 8:
        px = img if img.ndim == 3 else img[:, :, None]
        out[:, :, :w] = px.transpose(0, 2, 1)
    else:
        for p in range(planes):
            packed = np.packbits((img >> p) & 1, axis=1)
            out[:, p, : packed.shape[1]] = packed
    return out.reshape(h, planes * stride)


GRAY_TAIL = b"\x0c" + bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))


# -- the cases ----------------------------------------------------------------


def read_cases():
    """name -> (extension, bytes): the files PIL reads, each kind of each
    format at odd sizes (13 x 17 unless named)."""
    rng = np.random.RandomState(20)
    h, w = 13, 17
    g = rng.randint(0, 256, (h, w)).astype(np.uint8)
    flat = np.repeat(np.repeat(rng.randint(0, 4, (4, 5)) * 70, 4, 0), 4,
                     1)[:h, :w].astype(np.uint8)
    rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    rgba = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
    c = {}
    # TGA
    c["tga_gray_raw"] = tga(3, 8, w, h, g[::-1].tobytes())
    c["tga_gray_top"] = tga(3, 8, w, h, g.tobytes(), flags=0x20)
    c["tga_gray_mirrored"] = tga(3, 8, w, h, g.tobytes(), flags=0x30)
    c["tga_gray_rle"] = tga(11, 8, w, h, tga_rle(flat[::-1, :, None]))
    c["tga_gray_rle_top_mirrored"] = tga(11, 8, w, h, tga_rle(g[:, :, None]),
                                         flags=0x30)
    c["tga_bilevel"] = tga(3, 1, w, h, np.packbits(g > 127, axis=1).tobytes(),
                           flags=0x20)
    c["tga_la"] = tga(3, 16, w, h, rgba[::-1, :, :2].tobytes(), flags=0x08)
    c["tga_la_rle"] = tga(11, 16, w, h, tga_rle(np.ascontiguousarray(
        np.repeat(rgba[:, ::4, :2], 4, 1)[:, :w])), flags=0x28)
    c["tga_rgb"] = tga(2, 24, w, h, rgb[::-1].tobytes())
    c["tga_rgb_rle"] = tga(10, 24, w, h, tga_rle(np.ascontiguousarray(
        np.repeat(rgb[:, ::3], 3, 1)[:, :w])))
    c["tga_rgba"] = tga(2, 32, w, h, rgba[::-1].tobytes(), flags=0x08)
    c["tga_rgba_rle"] = tga(10, 32, w, h, tga_rle(rgba), flags=0x28)
    c["tga_rgb15"] = tga(2, 16, w, h, rng.randint(0, 256, 2 * w * h).astype(
        np.uint8).tobytes())
    c["tga_rgb15_rle"] = tga(10, 16, w, h, tga_rle(np.repeat(rng.randint(
        0, 256, (h, 6, 2)), 3, 1)[:, :w].astype(np.uint8)))
    idx = rng.randint(0, 16, (h, w)).astype(np.uint8)
    for d in (16, 24):
        cmap = rng.randint(0, 256, 16 * d // 8).astype(np.uint8).tobytes()
        c[f"tga_palette{d}"] = tga(1, 8, w, h, idx[::-1].tobytes(), cmap=cmap,
                                   cmap_depth=d)
        c[f"tga_palette{d}_rle"] = tga(9, 8, w, h, tga_rle(idx[:, :, None]),
                                       flags=0x20, cmap=cmap, cmap_depth=d,
                                       cmap_first=5)
    c["tga_id_section"] = tga(3, 8, w, h, g[::-1].tobytes(),
                              idsec=b"made for the port's tests",
                              footer=False)
    # SGI
    g16 = rng.randint(0, 65536, (h, w)).astype(np.uint16)
    c["sgi_gray"] = sgi(g, name=b"gray")
    c["sgi_gray_rle"] = sgi(flat, rle=True)
    c["sgi_gray16"] = sgi(g16, bpc=2)
    c["sgi_gray16_rle"] = sgi(np.repeat(g16[:, ::3], 3, 1)[:, :w], bpc=2,
                              rle=True)
    c["sgi_row"] = sgi(g[:1])
    c["sgi_rgb"] = sgi(rgb)
    c["sgi_rgb_rle"] = sgi(np.repeat(rgb[:, ::4], 4, 1)[:, :w], rle=True)
    c["sgi_rgba16_rle"] = sgi(np.repeat(rng.randint(0, 65536, (h, 5, 4)), 4,
                                        1)[:, :w].astype(np.uint16), bpc=2,
                              rle=True)
    # PCX
    c["pcx_gray"] = pcx(_planes(g, 8, 1, 18), w, h, 8, 1, tail=GRAY_TAIL)
    c["pcx_gray_runs"] = pcx(_planes(flat, 8, 1, 18), w, h, 8, 1,
                             tail=GRAY_TAIL)
    pal = rng.randint(0, 256, 768).astype(np.uint8).tobytes()
    c["pcx_palette8"] = pcx(_planes(g, 8, 1, 18), w, h, 8, 1,
                            tail=b"\x0c" + pal)
    c["pcx_rgb"] = pcx(_planes(rgb, 8, 3, 18), w, h, 8, 3)
    c["pcx_rgb_odd_stride"] = pcx(_planes(rgb, 8, 3, 18), w, h, 8, 3,
                                  stride=17)
    c["pcx_bilevel"] = pcx(_planes((g > 127).astype(np.uint8), 1, 1, 4), w, h,
                           1, 1, version=2)
    c["pcx_2bit_planes"] = pcx(_planes(idx & 3, 1, 2, 4), w, h, 1, 2,
                               version=3)
    c["pcx_4bit_planes"] = pcx(_planes(idx, 1, 4, 4), w, h, 1, 4, version=0)
    # DCX: three gray frames; and frame 0 a 4-plane palette image, which
    # PIL puts on frame 1 (L: taken) and frame 2 (RGB: refused)
    frames = [pcx(_planes(x, 8, 1, 18), w, h, 8, 1, tail=GRAY_TAIL)
              for x in (g, flat, 255 - g)]
    c["dcx_gray3"] = dcx(frames)
    c["dcx_mixed"] = dcx([c["pcx_4bit_planes"], frames[1], c["pcx_rgb"]])
    return {k: ("dcx" if k.startswith("dcx") else k[:3], v)
            for k, v in c.items()}


WRITE_EXTENSIONS = {"tga": (".tga", ".vst"), "sgi": (".sgi", ".bw", ".rgb"),
                    "pcx": (".pcx",)}


def write_arrays():
    """name -> (array, extension): each dtype ``fromarray`` gives that a
    format writes, at odd sizes."""
    rng = np.random.RandomState(21)
    h, w = 13, 17
    arrays = {
        "bool": rng.rand(h, w) < 0.5,
        "uint8": rng.randint(0, 256, (h, w)).astype(np.uint8),
        "uint8_runs": np.repeat(rng.randint(0, 256, (h, 3)), 6, 1)[
            :, :w].astype(np.uint8),
        "la": rng.randint(0, 256, (h, w, 2)).astype(np.uint8),
        "rgb": rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
        "rgba": rng.randint(0, 256, (h, w, 4)).astype(np.uint8),
        "row": rng.randint(0, 256, (1, w)).astype(np.uint8),
    }
    takes = {"tga": ("bool", "uint8", "uint8_runs", "la", "rgb", "rgba"),
             "sgi": ("uint8", "uint8_runs", "rgb", "rgba", "row"),
             "pcx": ("bool", "uint8", "uint8_runs", "rgb", "row")}
    out = {}
    for fmt, names in takes.items():
        for i, name in enumerate(names):
            ext = WRITE_EXTENSIONS[fmt][i % len(WRITE_EXTENSIONS[fmt])]
            out[f"{fmt}_{name}"] = (arrays[name], ext)
    return out


def main():
    import warnings

    from PIL import Image

    for name, (ext, data) in read_cases().items():
        path = os.path.join(HERE, f"{name}.{ext}")
        with open(path, "wb") as f:
            f.write(data)
        frames = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for k in range(3):
                try:
                    with Image.open(path) as im:
                        im.seek(k)
                        frames[f"frame{k}"] = np.asarray(im)
                except (EOFError, ValueError):
                    continue
        np.savez_compressed(os.path.join(HERE, f"{name}.npz"), **frames)
    for name, (x, ext) in write_arrays().items():
        np.save(os.path.join(HERE, f"write_{name}.npy"), x)
        Image.fromarray(x).save(os.path.join(HERE, f"write_{name}{ext}"))


if __name__ == "__main__":
    main()
