"""Write the fixtures of the toolbox's remaining PIL writes and reads
(``unmicst_tpu_torch/io/quant.py``, ``io/gif.py``'s RGB and RGBA GIFs,
``io/bmp.py``'s DIB, ``io/im.py``, ``io/msp.py``, ``io/palm.py``,
``io/xbm.py``, ``io/qoi.py``, ``io/eps.py``, ``io/dds.py``): PIL's file
for each seeded array of :func:`write_arrays`, and PIL's read of each
file of a format it reads.

    python tests/fixtures/torch_write/make.py

:func:`write_arrays` and the file functions of :func:`read_cases` need
numpy only (the arrays are made again from their seeds, and are not
stored); :func:`main` needs PIL and writes, beside this script:

* ``write_<name>.<ext>``: ``Image.fromarray(x).save`` of each array;
* ``read_<name>.<ext>``: every case of :func:`read_cases`, files of
  layouts PIL reads that its writers do not write;
* ``reads.npz``: PIL's ``np.asarray(Image.open(f))`` of each of these
  files that PIL reads, keyed by file name.

The card's machine has no PIL, so ``chip_smoke.py`` compares the port
with these files.
"""

import os
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
READABLE = (".dib", ".im", ".msp", ".xbm", ".qoi", ".dds")


def _gradient(h: int, w: int, seed: int) -> np.ndarray:
    """An RGB image of ``h * w`` smooth colours (more than 65 536 at 257
    x 257) with a little seeded noise in blue."""
    y, x = np.mgrid[:h, :w]
    rng = np.random.RandomState(seed)
    b = (x // 2 + y // 3 + rng.randint(0, 3, (h, w))) % 256
    return np.stack([x % 256, y % 256, b], -1).astype(np.uint8)


def write_arrays():
    """name -> (array, extension): the images whose writes are held to
    PIL's, at odd sizes."""
    rng = np.random.RandomState(31)
    h, w = 13, 17
    few = rng.randint(0, 256, (7, 3)).astype(np.uint8)
    rgba = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
    clear = rgba.copy()
    clear[..., 3] = 0
    mixed = rgba.copy()
    mixed[..., 3] = np.where(rng.rand(h, w) < 0.3, 0, 255)
    arrays = {
        "gif_rgb_few": (few[rng.randint(0, 7, (h, w))], ".gif"),
        "gif_rgb_noise": (rng.randint(0, 256, (40, 52, 3)).astype(np.uint8),
                          ".gif"),
        "gif_rgb_many": (_gradient(257, 257, 5), ".gif"),
        "gif_rgba_noise": (rgba, ".gif"),
        "gif_rgba_clear": (clear, ".gif"),
        "gif_rgba_mixed": (mixed, ".gif"),
        "gif_rgba_gradient": (np.concatenate([_gradient(40, 60, 6), np.full(
            (40, 60, 1), 200, np.uint8)], -1), ".gif"),
    }
    plain = {
        "bool": rng.rand(h, w) < 0.5,
        "uint8": rng.randint(0, 256, (h, w)).astype(np.uint8),
        "uint16": rng.randint(0, 65536, (h, w)).astype(np.uint16),
        "float32": rng.standard_normal((h, w)).astype(np.float32),
        "int32": rng.randint(-2**31, 2**31, (h, w)).astype(np.int32),
        "la": rng.randint(0, 256, (h, w, 2)).astype(np.uint8),
        "rgb": rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
        "rgba": rng.randint(0, 256, (h, w, 4)).astype(np.uint8),
    }
    takes = {".dib": ("bool", "uint8", "rgb", "rgba"),
             ".apng": ("uint8", "rgb"), ".mpo": ("uint8", "rgb"),
             ".im": ("bool", "uint8", "uint16", "float32", "int32", "la",
                     "rgb", "rgba"),
             ".msp": ("bool",), ".palm": ("bool",), ".xbm": ("bool",),
             ".qoi": ("rgb", "rgba"), ".eps": ("uint8", "rgb"),
             ".ps": ("uint8",), ".dds": ("uint8", "la", "rgb", "rgba")}
    for ext, names in takes.items():
        for name in names:
            arrays[f"{ext[1:]}_{name}"] = (plain[name], ext)
    return arrays


def msp_v2(rows) -> bytes:
    """A version 2 (``LinS``) MSP file of ``rows``, each a list of
    ``(count, byte)`` runs (count 0: the byte is a literal string)."""
    coded = []
    for runs in rows:
        out = bytearray()
        for count, value in runs:
            if count:
                out += bytes((0, count)) + value
            else:
                out += bytes((len(value),)) + value
        coded.append(bytes(out))
    w = 8 * max(1, max((sum(c or len(v) for c, v in r) for r in rows),
                       default=1))
    words = [0x694C, 0x536E, w, len(rows), 1, 1, 1, 1, w, len(rows)] + [0] * 6
    check = 0
    for v in words:
        check ^= v
    words[12] = check
    return (struct.pack("<16H", *words)
            + struct.pack(f"<{len(rows)}H", *map(len, coded))
            + b"".join(coded))


def im_file(kind: str, w: int, h: int, body: bytes, lut: bytes = b"",
            frames: int = 1) -> bytes:
    """An IM file: the header of ``kind`` (an ``Image type``), a
    ``Lut`` key and its 768 bytes where given, then ``body``."""
    lines = [f"Image type: {kind} image", f"Image size (x*y): {w}*{h}",
             f"File size (no of images): {frames}"] + (
                 ["Lut: 1"] if lut else [])
    head = ("\r\n".join(lines) + "\r\n").encode("ascii")
    return head + b"\0" * (511 - len(head)) + b"\x1a" + lut + body


def dds_file(w: int, h: int, flags: int, bitcount: int, masks, body: bytes,
             fourcc: int = 0, extra: bytes = b"") -> bytes:
    """A DDS file: the header with the pixel format's flags, bit count,
    masks and FourCC, ``extra`` (a DX10 header, a palette), ``body``."""
    return (b"DDS " + struct.pack("<7I", 124, 0x100F, h, w, 0, 0, 0)
            + bytes(44) + struct.pack("<4I", 32, flags, fourcc, bitcount)
            + struct.pack("<4I", *masks) + struct.pack("<5I", 0x1000, 0, 0,
                                                       0, 0) + extra + body)


def read_cases():
    """name -> (extension, bytes): layouts PIL reads beyond what its
    writers write."""
    rng = np.random.RandomState(32)
    h, w = 5, 11
    b = lambda n: rng.randint(0, 256, n).astype(np.uint8).tobytes()  # noqa
    grey_lut = bytes(range(256)) * 3
    colour_lut = b(768)
    return {
        "msp_v2": (".msp", msp_v2([[(2, b"\x0f")], [], [(0, b"\xaa\x55")],
                                   [(1, b"\x81"), (0, b"\x00")]])),
        "im_lut_colour": (".im", im_file("Greyscale", w, h, b(w * h),
                                         colour_lut)),
        "im_lut_grey": (".im", im_file("Greyscale", w, h, b(w * h),
                                       grey_lut)),
        "im_f12": (".im", im_file("L*12", w, h, b(w * h * 2))),
        "im_rgb3": (".im", im_file("RGB3", w, h, b(3 * w * h))),
        "im_b4": (".im", im_file("B4", w, h, b(6 * h))),
        "im_two_frames": (".im", im_file("Greyscale", w, h, b(2 * w * h),
                                         frames=2)),
        "dds_565": (".dds", dds_file(w, h, 0x40, 16, (0xF800, 0x7E0, 0x1F,
                                                      0), b(2 * w * h))),
        "dds_argb4": (".dds", dds_file(w, h, 0x41, 16, (0xF00, 0xF0, 0xF,
                                                        0xF000),
                                       b(2 * w * h))),
        "dds_dx10_rgba": (".dds", dds_file(
            w, h, 0x4, 32, (0, 0, 0, 0), b(4 * w * h), fourcc=0x30315844,
            extra=struct.pack("<5I", 28, 3, 0, 0, 1))),
        "dds_palette": (".dds", dds_file(w, h, 0x20, 8, (0, 0, 0, 0),
                                         b(w * h), extra=b(1024))),
        "xbm_hotspot": (".xbm", b"#define a_width 11\n#define a_height 3\n"
                        b"#define a_x_hot 1\n#define a_y_hot 2\n"
                        b"static unsigned char a_bits[] = {\n0x01, 0xFF,"
                        b" 0x7e,0x80,\n 0x00, 0x3c };\n"),
        "dib_os2": (".dib", struct.pack("<IHHHH", 12, w, h, 1, 24)
                    + b(4 * ((3 * w + 3) // 4) * h)),
    }


def main():
    import warnings

    from PIL import Image

    reads = {}
    files = []
    for name, (x, ext) in write_arrays().items():
        path = os.path.join(HERE, f"write_{name}{ext}")
        Image.fromarray(x).save(path)
        files.append(path)
    for name, (ext, data) in read_cases().items():
        path = os.path.join(HERE, f"read_{name}{ext}")
        with open(path, "wb") as f:
            f.write(data)
        files.append(path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for path in files:
            if path.endswith(READABLE):
                with Image.open(path) as im:
                    reads[os.path.basename(path)] = np.asarray(im)
        with Image.open(os.path.join(HERE, "read_im_two_frames.im")) as im:
            im.seek(1)
            reads["read_im_two_frames.im#1"] = np.asarray(im)
    np.savez_compressed(os.path.join(HERE, "reads.npz"), **reads)


if __name__ == "__main__":
    main()
