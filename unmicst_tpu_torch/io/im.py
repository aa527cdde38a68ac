"""IM files (the IFUNC / LabEye image format) read and written as PIL 12
reads and writes them for the JAX package (``PIL/ImImagePlugin.py``): its
TIFF fallback's ``Image.open`` and ``seek(channel)`` of a file under a
TIFF name, the toolbox's ``imread`` and its ``Image.fromarray(image)
.save(path)`` of an ``.im`` name.

Reading (:func:`open_header`, :func:`read_frame`): a text header of
``key: value`` lines (each under 101 bytes, at least one key PIL knows)
ended by a NUL or 0x1A byte, then the data from the 0x1A byte on; a
``Lut`` key puts a 768-byte palette (three planes) first, which turns a
gray mode whose palette is not gray into ``P`` (``PA``); "Image type"
names the mode and the raw layout (``OPEN``).  The port reads the layouts
PIL's ``raw`` decoder reads here: ``1`` (MSB first, rows padded to a
byte), 8-bit ``L``/``P``, the line-interleaved ``LA``, ``RGB``, ``RGBA``,
``RGBX``, ``CMYK`` and ``YCbCr`` (each row one plane after the other),
pixel-interleaved ``RGB``, the three planes (G, R, B) of ``RGB3`` and
``RYB3``, 2- and 4-bit ``P``, ``I;16`` in either byte order, 32-bit
signed ``I``, and the ``F`` layouts: 8, 16 and 32 bits (integers, signed
or not, or IEEE floats) raw, any other width through ``BitDecode.c``'s
bit buffer (:func:`_bit_decode`); the rows are stored bottom-up (PIL's
``ystep`` -1).  Frame ``k`` starts ``k`` frames of ``ceil(w * bits / 8)
* h`` bytes on, ``bits`` being 1 for mode ``1`` and 8 times the length of
the mode's name otherwise (as PIL's ``seek`` counts, ``I;16`` as 32).
Data that ends early raises ``OSError`` (``ValueError`` for the modes PIL maps from
the file: ``L``, ``P`` and ``I;16``).  ``RLB``, a later frame of the
planar or bit layouts, and an "Image type" PIL does not know but for
``L`` and ``P`` (whose default layout is ``L``) raise PIL's
``ValueError`` (no such raw mode, or no such image mode).
A header PIL refuses raises ``SyntaxError``, on which ``Image.open``
tries its next plugin.

Writing (:func:`encode_im`): PIL's ``SAVE`` modes (``1``, ``L``, ``LA``,
``I``, ``I;16``, ``I;16B``, ``F``, ``RGB``, ``RGBA``) under the header
``Image type``, ``Name`` (the file's base name, cut to 92 characters
with its extension), ``Image size`` and ``File size``, NULs to byte 511
and 0x1A, then the rows bottom-up in the raw layout.  Any other mode
raises PIL's ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import io
import os
import re
from typing import Optional

import numpy as np

from unmicst_tpu_torch.io import _pil
from unmicst_tpu_torch.io.png import array_mode

_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_TAGS = ("Comment", "Date", "Digitalization equipment",
         "File size (no of images)", "Lut", "Name", "Scale (x,y)",
         "Image size (x*y)", "Image type")
OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = ("F", f"F;{_i}")
    OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = (f"I;{_i}", f"I;{_i}")
    OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
# mode -> (image type, the layout written)
_SAVE = {"1": ("0 1", "1"), "L": ("Greyscale", "L"), "LA": ("LA", "LA;L"),
         "I": ("L 32S", "I;32S"), "I;16": ("L 16", "I;16"),
         "I;16B": ("L 16B", "I;16B"), "F": ("L 32F", "F;32F"),
         "RGB": ("RGB", "RGB;L"), "RGBA": ("RGBA", "RGBA;L")}
# raw layout -> numpy dtype of its samples (the 8-bit planar ones: u1)
_SAMPLES = {"I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I;32": "<i4",
            "I;32S": "<i4", "F;8": "u1", "F;8S": "i1", "F;16": "<u2",
            "F;16S": "<i2", "F;32": "<i4", "F;32F": "<f4"}
# np.asarray's dtype of the modes above
_MODE_DTYPE = {"I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I": "<i4",
               "F": "<f4"}
_PLANES = {"LA;L": 2, "PA;L": 2, "RGB;L": 3, "RGBA;L": 4, "RGBX;L": 4,
           "CMYK;L": 4, "YCbCr;L": 3}
_MAPPED = ("L", "P", "I;16", "I;16L", "I;16B")  # mmap'd: raw mode == mode
# (mode, layout) pairs PIL decodes: OPEN's but PA's (no LA from PA;L), a
# mode named as it is with the default layout, and the palette modes a Lut
# gives
_PAIRS = (set(OPEN.values()) - {("LA", "PA;L")}) | {
    ("L", "L"), ("P", "L"), ("P", "P"), ("PA", "PA;L")}


@dataclasses.dataclass
class ImHeader:
    """What ``ImImageFile._open`` finds."""

    width: int
    height: int
    mode: str
    rawmode: str
    frames: object
    offset: int  # the first frame's data


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def open_header(data: bytes) -> ImHeader:
    """``ImImageFile._open`` over the file ``data``: ``SyntaxError`` (or
    PIL's ``IndexError``, ``TypeError``) where it refuses the file."""
    fp = io.BytesIO(data)
    if b"\n" not in fp.read(100):
        raise SyntaxError("not an IM file")
    fp.seek(0)
    info = {"Image type": "L", "Image size (x*y)": (512, 512),
            "File size (no of images)": 1}
    rawmode = "L"
    n = 0
    while True:
        s = fp.read(1)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        s = s + fp.readline()
        if len(s) > 100:
            raise SyntaxError("not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _SPLIT.match(s)
        if not m:
            raise SyntaxError("Syntax error in IM header: "
                              + s.decode("ascii", "replace"))
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)",
                 "Image size (x*y)"):
            v = tuple(_number(t) for t in v.replace("*", ",").split(","))
            if len(v) == 1:
                v = v[0]
        elif k == "Image type" and v in OPEN:
            v, rawmode = OPEN[v]
        info[k] = v
        n += k in _TAGS
    if not n:
        raise SyntaxError("Not an IM file")
    size, mode = info["Image size (x*y)"], info["Image type"]
    while s and not s.startswith(b"\x1a"):
        s = fp.read(1)
    if not s:
        raise SyntaxError("File truncated")
    if "Lut" in info:
        palette = fp.read(768)
        if len(palette) < 768:  # PIL's loop over it runs off its end
            raise IndexError("index out of range")
        grey = all(palette[i] == palette[i + 256] == palette[i + 512]
                   for i in range(256))
        if mode in ("L", "LA", "P", "PA") and not grey:
            mode, rawmode = (("P", "P") if mode in ("L", "P")
                             else ("PA", "PA;L"))
    w, h = size[0], size[1]  # a single number: PIL's TypeError
    if not mode or w <= 0 or h <= 0:
        raise SyntaxError("not identified by this driver")
    return ImHeader(w, h, mode, rawmode, info["File size (no of images)"],
                    fp.tell())


def _frame_bytes(hdr: ImHeader) -> int:
    bits = 1 if hdr.mode == "1" else 8 * len(hdr.mode)
    return ((hdr.width * bits + 7) // 8) * hdr.height


def read_frame(data: bytes, index: int = 0) -> np.ndarray:
    """Frame ``index`` of an IM file's bytes as ``Image.open``, ``seek``
    and ``np.asarray`` give it (see the module docstring)."""
    hdr = open_header(data)
    _pil.bomb_check(hdr.width, hdr.height)
    if index != 0 and not 0 <= index < hdr.frames:
        raise EOFError("attempt to seek outside sequence")
    w, h, raw = hdr.width, hdr.height, hdr.rawmode
    offset = hdr.offset + index * _frame_bytes(hdr)
    bits = _bit_layout(raw)
    if (hdr.mode, raw) not in _PAIRS or raw == "RLB" or (
            index and (bits or raw in ("RGB;T", "RYB;T"))):
        raise ValueError("unknown raw mode for given image mode")
    if bits:
        return _bit_decode(data[offset:], w, h, bits)
    if raw in ("RGB;T", "RYB;T"):  # three planes: G, R, B
        size = w * h
        planes = [_rows(data, offset + k * size, w, h, "RGB")
                  for k in range(3)]
        return np.stack([planes[1], planes[0], planes[2]], -1)
    if raw == "1":
        row = (w + 7) // 8
    elif raw in ("L", "P"):
        row = w
    elif raw in ("P;2", "P;4"):
        row = (w * int(raw[2]) + 7) // 8
    elif raw in _PLANES:
        row = w * _PLANES[raw]
    elif raw == "RGB":
        row = 3 * w
    elif raw in _SAMPLES:
        row = w * np.dtype(_SAMPLES[raw]).itemsize
    else:
        raise NotImplementedError(
            f"IM layout {raw!r} ({hdr.mode}) is not read by "
            "unmicst_tpu_torch (ROADMAP M17)")
    mapped = hdr.mode if hdr.mode == raw else ""
    if mapped not in _MAPPED:
        _pil.setimage_check(w, 8 * row // w if raw != "1" else 1)
    rows = _rows(data, offset, row, h, mapped)
    if raw == "1":
        return np.unpackbits(rows, axis=1)[:, :w].astype(bool)
    if raw in ("L", "P"):
        return np.ascontiguousarray(rows)
    if raw in ("P;2", "P;4"):
        n = int(raw[2])
        flat = np.unpackbits(rows, axis=1)[:, : w * n].reshape(h, w, n)
        weights = (1 << np.arange(n - 1, -1, -1)).astype(np.uint8)
        return (flat * weights).sum(2, dtype=np.uint8)
    if raw in _PLANES:
        px = rows.reshape(h, _PLANES[raw], w).transpose(0, 2, 1)
        return np.ascontiguousarray(px[..., :3] if raw == "RGBX;L" else px)
    if raw == "RGB":
        return np.ascontiguousarray(rows).reshape(h, w, 3)
    px = np.ascontiguousarray(rows).view(_SAMPLES[raw]).reshape(h, w)
    return px.astype(_MODE_DTYPE[hdr.mode])


def _bit_layout(raw: str) -> int:
    """The sample width of an ``F;n`` layout PIL reads with its ``bit``
    decoder (n other than 8, 16 and 32), else 0."""
    if raw.startswith("F;") and raw[2:].isdigit():
        n = int(raw[2:])
        return 0 if n in (8, 16, 32) else n
    return 0


def _rows(data: bytes, offset: int, row: int, h: int,
          mapped: str) -> np.ndarray:
    """``h`` rows of ``row`` bytes from ``offset``, top row first (the
    file holds them bottom-up); PIL's error where the data ends first
    (``ValueError`` for a mode it maps from the file)."""
    body = data[offset : offset + row * h]
    if len(body) < row * h:
        if mapped in _MAPPED:
            raise ValueError(_pil.NOT_LARGE_ENOUGH)
        raise _pil.truncated(len(body) % row if row else 0)
    return np.frombuffer(body, np.uint8).reshape(h, row)[::-1]


def _bit_decode(data: bytes, w: int, h: int, bits: int) -> np.ndarray:
    """``BitDecode.c`` as ``ImImageFile`` sets it up (``bits``, pad 8,
    fill 3, unsigned, bottom-up): each byte ORed into the bit buffer above
    the bits it holds, each sample taken from the bottom; a new row clears
    the count of bits held but not the buffer."""
    out = np.zeros((h, w), np.float32)
    mask = (1 << bits) - 1
    buf = count = x = 0
    y = h - 1
    for byte in data:
        buf = (buf | byte << count) & 0xFFFFFFFFFFFFFFFF
        count += 8
        while count >= bits:
            value = buf & mask
            if count > 32:
                buf = byte >> (8 - (count - bits))
            else:
                buf >>= bits
            count -= bits
            out[y, x] = value
            x += 1
            if x >= w:
                y -= 1
                if y < 0:
                    return out
                x, count = 0, 0
    raise _pil.truncated(0)


def encode_im(image: np.ndarray, path: Optional[str]) -> bytes:
    """The bytes ``Image.fromarray(image).save(path)`` writes for an IM
    name (see the module docstring)."""
    mode, img = array_mode(image)
    if mode not in _SAVE:
        raise ValueError(f"Cannot save {mode} images as IM")
    kind, raw = _SAVE[mode]
    h, w = img.shape[:2]
    head = f"Image type: {kind} image\r\n"
    if path:
        name, ext = os.path.splitext(os.path.basename(path))
        head += f"Name: {name[: 92 - len(ext)]}{ext}\r\n"
    head += (f"Image size (x*y): {w}*{h}\r\n"
             "File size (no of images): 1\r\n")
    head = head.encode("ascii")
    head += b"\0" * (511 - len(head)) + b"\x1a"
    if 0 in img.shape:
        raise SystemError("tile cannot extend outside image")
    rows = img[::-1]
    if raw == "1":
        body = np.packbits(rows, axis=1)
    elif raw in _PLANES:
        body = rows.transpose(0, 2, 1)
    elif raw == "I;32S":
        body = rows.astype("<i4")
    elif raw == "I;16":
        body = rows.astype("<u2")
    elif raw == "I;16B":
        body = rows.astype(">u2")
    elif raw == "F;32F":
        body = rows.astype("<f4")
    else:
        body = rows
    return head + np.ascontiguousarray(body).tobytes()


def write_im(path: str, image: np.ndarray) -> None:
    """Write ``image`` as ``Image.fromarray(image).save(path)`` writes an
    IM file (:func:`encode_im`)."""
    data = encode_im(image, path)
    with open(path, "wb") as f:
        f.write(data)

