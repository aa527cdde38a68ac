"""GIF files in numpy and the standard library, as PIL 12's
``GifImagePlugin`` reads and writes them (the JAX package reaches GIF
through PIL: the toolbox's ``imread`` / ``imwrite``, and the TIFF
fallback, which opens a file the TIFF reader refuses by content, page ==
frame).

:func:`read_frame` returns PIL's ``np.asarray`` after ``seek(index)``:

* GIF87a and GIF89a; the global and local colour tables, the graphic
  control extension (transparency, disposal), comment and application
  extensions (skipped), interlaced frames, frames at an offset, also
  past the logical screen (below);
* frame 0 as PIL loads it: the palette indices (mode ``P``), or, where
  neither table is needed (none, or the identity gray ramp), the values
  (mode ``L``); pixels outside the frame are 0, or the transparent index;
* later frames under Pillow's ``RGB_AFTER_FIRST`` strategy: the screen
  becomes RGB (RGBA where frame 0 has a transparent index), each frame is
  composited onto it (a transparent index keeps what is there) under the
  disposal of the frame before it (2: background or transparent fill of
  its extent; 3 and up: its extent restored; a method stays in force
  until a frame names another), ``[H, W, 3]`` or ``[H, W, 4]`` uint8.  A
  screen that stays ``L`` (no table anywhere) keeps its values.

Past the last frame it raises ``EOFError``.  The LZW decode is Pillow's
``GifDecode.c``: codes LSB first, ``bits + 1`` wide after each clear, one
wider after the code ``2**width - 1`` is added, the table full at 4096
(no clear needed); the frame ends at its last pixel, an end code before
that is passed over while the file has bytes beyond those read so far
(PIL reads 64 KiB at a time) and is the end of the data otherwise.  Data
that ends early or holds a code not yet defined raises :class:`GifError`
(an ``OSError``, as PIL's).

A frame reaching past the logical screen grows the image to hold it, as
PIL's ``_seek`` and ``load_prepare`` / ``load_end`` do (with the
decompression-bomb check on the new size): frame 0 is decoded on the
grown screen; a later ``L`` or ``P`` screen grows with zeros below and to
the right; an RGB screen under a frame without transparency grows in its
table's first colour (``ValueError`` where the frame has no table, as
PIL's ``getpalette``), an RGBA screen under a transparent frame in
transparent black.  A disposal to the previous contents restores them as
they were before the frame grew the image, zeros past their edges.  An
RGBA screen under an opaque frame becomes RGB, and ``np.asarray``, which
packs with the mode before the load, gives the RGBA bytes (the old
alpha in the fourth) cut to ``[h, w, 3]``; an RGB screen under a
transparent frame becomes RGBA, where PIL's array reads past the end of
its RGB bytes: that raises ``NotImplementedError`` naming ROADMAP M17.

:func:`write_gif` writes ``Image.fromarray(image).save(path)``'s bytes
for 2-D images: mode ``1`` (bool) as 0/255 under the full gray palette;
``L``, and ``LA``, ``I;16``, ``I`` and ``F`` brought to ``L`` as
``convert("L")``
brings them (clipped to 0..255, floats truncated, NaN to 0), then
Pillow's palette optimisation (the gray levels used, in order, the pixels
their ranks); interlaced unless a side is under 16 pixels; Pillow's LZW
encoder (``GifEncode.c``: 8-bit codes, a clear when the table is full)
in sub-blocks of 255 bytes but where ``ImageFile._save``'s buffer of
``max(65536, 4 * width)`` bytes ends.  RGB goes through Pillow's median
cut and RGBA through its fast octree (:mod:`unmicst_tpu_torch.io.quant`)
to a ``P`` image, whose palette is optimised as Pillow's
``_get_optimize`` decides (under 512 x 512 pixels, where an index past
the count of those used is used or the table would halve) and whose
RGBA palette's first entry of alpha 0 is the transparent index (a
GIF89a with a graphic control extension).  A dtype PIL has no mode for
raises its ``TypeError``.

Both LZW coders run in the port's native host library
(``native/gifcodec.cpp``) when it loads, and otherwise in
:func:`lzw_decode_py` / :func:`lzw_encode_py`, the plain versions the
tests hold them to, bit for bit and failure for failure.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple, Union

import numpy as np

from unmicst_tpu_torch.io import _native
from unmicst_tpu_torch.io import _pil, quant
from unmicst_tpu_torch.io.png import array_mode

MAGICS = (b"GIF87a", b"GIF89a")
# PIL's ImageFile reads a frame's data this many bytes at a time
READ_CHUNK = 1 << 16
_TABLE = 4096  # GIFTABLE: codes 0..4095
_BROKEN, _TRUNCATED, _CONFIG = -2, -20, -8
# PIL's messages for its decoder's error codes (ImageFile._get_oserror)
_MESSAGES = {_BROKEN: "decoding error", _CONFIG: "bad configuration",
             _TRUNCATED: "image file is truncated"}


class GifError(OSError):
    """A GIF file this reader cannot read (corrupt or truncated), where
    PIL raises too."""


@dataclasses.dataclass
class FrameDesc:
    """One image descriptor and the extensions before it."""

    x0: int
    y0: int
    x1: int
    y1: int
    interlace: bool
    palette: Union[bytes, bool, None]  # local table; False: identity ramp
    transparency: Optional[int]
    disposal: int  # the GCE's disposal field, 0 where none or unspecified
    bits: int  # the LZW minimum code size
    offset: int  # the first sub-block's length byte


class _File:
    """``fp.read`` over the file's bytes: short at the end, never past."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        self.pos += len(out)
        return out

    def block(self) -> Optional[bytes]:
        """One data sub-block, None at its terminator (``data()``)."""
        s = self.read(1)
        return self.read(s[0]) if s and s[0] else None


def _palette_needed(p: bytes) -> bool:
    """False where the table is the identity gray ramp (PIL then opens
    the frame as mode ``L``)."""
    if len(p) % 3:
        raise GifError("truncated GIF colour table")
    return any(not (i == p[3 * i] == p[3 * i + 1] == p[3 * i + 2])
               for i in range(len(p) // 3))


def _u16(s: bytes, o: int) -> int:
    if len(s) < o + 2:
        raise GifError("truncated GIF block")
    return s[o] | (s[o + 1] << 8)


class Screen:
    """The logical screen descriptor and the global colour table."""

    def __init__(self, data: bytes):
        if data[:6] not in MAGICS or len(data) < 13:
            raise GifError("not a GIF file")
        self.width, self.height = _u16(data, 6), _u16(data, 8)
        flags = data[10]
        self.background = 0
        self.palette: Optional[bytes] = None
        pos = 13
        if flags & 128:
            self.background = data[11]
            p = data[pos : pos + (3 << ((flags & 7) + 1))]
            pos += len(p)
            if _palette_needed(p):
                self.palette = p
        self.first = pos  # the first frame's blocks start here


def next_frame(data: bytes, pos: int, frame: int) -> Tuple[FrameDesc, int]:
    """The next image descriptor from ``pos``, as ``GifImageFile._seek``
    walks to it: ``(desc, end)`` with ``end`` past its data sub-blocks.
    ``EOFError`` where the file has no further image."""
    f = _File(data, pos)
    s = f.read(1)
    if not s or s == b";":
        raise EOFError("no more images in GIF file")
    transparency, disposal = None, 0
    while True:
        if not s:
            s = f.read(1)
        if not s or s == b";":
            break
        if s == b"!":
            label = f.read(1)
            if not label:
                raise GifError("truncated GIF extension")
            block = f.block()
            if label[0] == 249 and block is not None:
                if len(block) < 3 or (block[0] & 1 and len(block) < 4):
                    raise GifError("truncated GIF graphic control extension")
                if block[0] & 1:
                    transparency = block[3]
                if (block[0] >> 2) & 7:
                    disposal = (block[0] >> 2) & 7
            elif label[0] == 254:
                while block:
                    block = f.block()
                s = b""
                continue
            elif label[0] == 255 and frame == 0 and block is not None:
                if block.startswith(b"NETSCAPE2.0"):
                    f.block()
            while f.block():
                pass
        elif s == b",":
            d = f.read(9)
            if len(d) < 9:
                raise GifError("truncated GIF image descriptor")
            x0, y0 = _u16(d, 0), _u16(d, 2)
            x1, y1 = x0 + _u16(d, 4), y0 + _u16(d, 6)
            flags = d[8]
            palette: Union[bytes, bool, None] = None
            if flags & 128:
                p = f.read(3 << ((flags & 7) + 1))
                palette = p if _palette_needed(p) else False
            b = f.read(1)
            if not b:
                raise GifError("truncated GIF image descriptor")
            desc = FrameDesc(x0, y0, x1, y1, bool(flags & 64), palette,
                             transparency, disposal, b[0], f.pos)
            while f.block():  # the frame's data, up to its terminator
                pass
            return desc, f.pos
        s = b""
    raise EOFError("image not found in GIF frame")


# -- the LZW decode (Pillow's GifDecode.c), the plain version -----------------


def lzw_decode_py(data: bytes, offset: int, bits: int, out: np.ndarray,
                  interlace: bool, transparency: int) -> int:
    """Decode the frame whose sub-blocks start at ``data[offset]`` into
    ``out`` (``[ysize, xsize]`` uint8, a view of the screen), skipping
    pixels equal to ``transparency`` (-1: none), as PIL's decoder under
    ``ImageFile.load`` does: 0 once the last pixel is written, else a
    negative error code.  The plain version of the native decoder."""
    if bits > 12:
        return _CONFIG
    ysize, xsize = out.shape
    clear = 1 << bits
    end = clear + 1
    step, ipass = (8, 1) if interlace else (1, 0)
    x = y = 0
    row = out[0]
    n = len(data)
    loaded = min(n, offset + READ_CHUNK)  # what PIL has read so far
    ptr, blocksize = offset, 0
    bitbuf = bitcount = 0
    link = [0] * _TABLE
    suffix = [0] * _TABLE
    state = 1
    nxt = codesize = codemask = 0
    lastcode = lastdata = 0
    while True:
        if state == 1:
            nxt = clear + 2
            codesize = bits + 1
            codemask = (1 << codesize) - 1
            state = 2
        while bitcount < codesize:
            if blocksize > 0:
                bitbuf |= data[ptr] << bitcount
                ptr += 1
                blocksize -= 1
                bitcount += 8
                continue
            # a whole sub-block must be loaded before it is read
            while ptr >= loaded or ptr + 1 + data[ptr] > loaded:
                if loaded >= n:
                    return _TRUNCATED
                loaded = min(n, loaded + READ_CHUNK)
            blocksize = data[ptr]
            ptr += 1
        c = bitbuf & codemask
        bitbuf >>= codesize
        bitcount -= codesize
        if c == clear:
            if state != 2:
                state = 1
            continue
        if c == end:  # PIL reads on, or finds the file ends
            if loaded >= n:
                return _TRUNCATED
            loaded = min(n, loaded + READ_CHUNK)
            continue
        if state == 2:
            if c > clear:
                return _BROKEN
            lastdata = lastcode = c
            state = 3
            string = [c]
        else:
            thiscode = c
            if c > nxt:
                return _BROKEN
            tail = []
            if c == nxt:
                tail.append(lastdata)
                c = lastcode
            while c >= clear:
                if c >= _TABLE:
                    return _BROKEN
                tail.append(suffix[c])
                c = link[c]
            lastdata = c
            if nxt < _TABLE:
                suffix[nxt] = c
                link[nxt] = lastcode
                if nxt == codemask and codesize < 12:
                    codesize += 1
                    codemask = (1 << codesize) - 1
                nxt += 1
            lastcode = thiscode
            tail.append(c)
            string = tail[::-1]
        for v in string:
            v &= 0xFF  # Pillow keeps a string's bytes as UINT8
            if v != transparency:
                row[x] = v
            x += 1
            if x >= xsize:
                x = 0
                y += step
                while y >= ysize:
                    if ipass == 1:
                        y, ipass = 4, 2
                    elif ipass == 2:
                        step, y, ipass = 4, 2, 3
                    elif ipass == 3:
                        step, y, ipass = 2, 1, 0
                    else:
                        return 0
                row = out[y]


def _decode(data: bytes, desc: FrameDesc, out: np.ndarray,
            transparency: int) -> None:
    """One frame's pixels into ``out``: native when the library loads."""
    rc = _native.gif_lzw_decode(data, desc.offset, desc.bits, out,
                                desc.interlace, transparency, READ_CHUNK)
    if rc is None:
        rc = lzw_decode_py(data, desc.offset, desc.bits, out, desc.interlace,
                           transparency)
    if rc < 0:
        raise GifError(_MESSAGES.get(rc, f"GIF decoder error {rc}"))


# -- the screen, as Pillow's loader keeps it ----------------------------------


def _lut(palette: Optional[bytes]) -> np.ndarray:
    """The 256 RGBA entries a conversion to RGB reads, opaque: a colour
    table's entries, then black; without a table (a gray image) the
    ramp."""
    lut = np.zeros((256, 4), np.uint8)
    lut[:, 3] = 255
    if palette:
        k = min(256, len(palette) // 3)
        lut[:k, :3] = np.frombuffer(palette, np.uint8, 3 * k).reshape(k, 3)
    else:
        lut[:, :3] = np.arange(256, dtype=np.uint8)[:, None]
    return lut


def _rgb(palette: Optional[bytes], color: int) -> Tuple[int, int, int]:
    """``GifImageFile._seek``'s ``_rgb``: entry 0 past the table."""
    if palette:
        if color * 3 + 3 > len(palette):
            color = 0
        return tuple(palette[3 * color : 3 * color + 3])
    return (color, color, color)


def read_frame(data: bytes, index: int) -> np.ndarray:
    """Frame ``index`` of the GIF ``data`` as PIL gives it after
    ``seek(index)`` (see the module docstring)."""
    if index < 0:
        raise EOFError("attempt to seek outside sequence")
    screen = Screen(data)
    h, w = screen.height, screen.width
    gpal = screen.palette
    pos = screen.first
    mode = None  # "L", "P" (2-D im) or "RGB", "RGBA" (im [h, w, 4])
    core_l = False  # a "P" screen whose pixels Pillow keeps as "L"
    im: Optional[np.ndarray] = None
    lut: Optional[np.ndarray] = None  # the P screen's palette
    info_trans: Optional[int] = None
    method = 0
    dispose = None
    for f in range(index + 1):
        to_p = False  # this frame's load turns mode L into P
        to_rgb = False  # this frame's load turns mode RGBA into RGB
        try:
            desc, pos = next_frame(data, pos, f)
        except EOFError:
            if f == 0:  # Image.open finds no image: not a GIF it reads
                raise GifError("cannot identify image file") from None
            raise
        if desc.x1 > w or desc.y1 > h:  # PIL grows the image to hold it
            w, h = max(desc.x1, w), max(desc.y1, h)
            _pil.bomb_check(w, h)
        if desc.x1 <= desc.x0 or desc.y1 <= desc.y0:
            raise GifError("tile cannot extend outside image")
        ext = (slice(desc.y0, desc.y1), slice(desc.x0, desc.x1))
        if dispose is not None:
            im[dispose[0]] = dispose[1]
        fpal = desc.palette if desc.palette is not None else gpal
        if f == 0:
            mode = "P" if fpal else "L"
            lut = _lut(desc.palette or gpal)
        elif mode == "P":
            if core_l:
                core_l = False
                if info_trans is not None:  # putpalettealpha on "L"
                    raise ValueError("image has no palette")
                rgba = np.repeat(im[..., None], 4, -1)
                rgba[..., 3] = 255
                im, mode = rgba, "RGB"
            elif info_trans is not None:
                lut = lut.copy()
                lut[info_trans, 3] = 0
                im, mode, info_trans = lut[im], "RGBA", None
            else:
                im, mode = lut[im], "RGB"
        if desc.disposal:
            method = desc.disposal
        dispose = None
        rgb_mode = mode in ("RGB", "RGBA")
        if method == 2:
            color = info_trans if info_trans is not None else \
                desc.transparency
            if color is not None:
                fill = (_rgb(fpal, color) + (0,)) if rgb_mode else color
            else:
                color = screen.background
                fill = (_rgb(fpal, color) + (255,)) if rgb_mode else color
            dispose = (ext, np.asarray(fill, np.uint8))
        elif method >= 3:
            if im is not None:  # the image before this frame grows it
                dispose = (ext, _crop(im, desc))
            elif desc.transparency is not None:
                t = desc.transparency
                fill = (_rgb(fpal, t) + (0,)) if rgb_mode else t
                dispose = (ext, np.asarray(fill, np.uint8))
        trans = -1
        if desc.transparency is not None:
            if f == 0:
                info_trans = desc.transparency
            elif not rgb_mode:
                trans = desc.transparency
        # load_prepare, the decode, load_end
        if f == 0:
            im = np.full((h, w), desc.transparency or 0, np.uint8)
            _decode(data, desc, im[ext], trans)
            continue
        if not rgb_mode:
            if fpal and mode == "L":
                mode, to_p = "P", True
                if im.shape == (h, w):
                    core_l = True
                else:  # the grown "L" core takes the frame's table: "P"
                    lut, core_l = _lut(fpal), False
            im = _grown(im, h, w, 0)
            _decode(data, desc, im[ext], trans)
            continue
        canvas = np.full((h, w), (desc.transparency or 0) if fpal else 0,
                         np.uint8)
        _decode(data, desc, canvas[ext], trans)
        if im.shape[:2] != (h, w):  # load_end grows the screen
            if desc.transparency is not None:
                if mode == "RGB":
                    raise NotImplementedError(
                        f"GIF frame {f} grows an RGB screen into RGBA, where "
                        "PIL's array reads past the end of its RGB bytes: "
                        "ROADMAP M17")
                im = _grown(im, h, w, 0)
            else:
                if not fpal:  # the frame's "L" canvas has no palette
                    raise ValueError("image has no palette")
                # the table's first colour; an RGBA screen keeps its alpha
                # bytes in the grown RGB image's fourth
                fill = np.frombuffer(fpal[:3], np.uint8).tolist() + [255]
                im = _grown(im, h, w, fill)
                to_rgb, mode = mode == "RGBA", "RGB"
        frame_lut = _lut(fpal if fpal else None)
        px = canvas[ext]
        if desc.transparency is not None:
            frame_lut[desc.transparency, 3] = 0
            keep = frame_lut[px, 3] == 0
            im[ext] = np.where(keep[..., None], im[ext], frame_lut[px])
        else:
            im[ext] = frame_lut[px]
    if to_p:  # np.asarray packs with the mode before the load: L
        raise ValueError("No packer found from P to L")
    if to_rgb:  # ... here RGBA: four bytes a pixel, cut to RGB's count
        return np.frombuffer(im.tobytes()[: 3 * h * w], np.uint8).reshape(
            h, w, 3)
    if mode == "RGB":
        return np.ascontiguousarray(im[..., :3])
    return im


def _crop(im: np.ndarray, desc: FrameDesc) -> np.ndarray:
    """``im`` over the frame's extent, zeros past its edges (PIL's
    crop)."""
    out = np.zeros((desc.y1 - desc.y0, desc.x1 - desc.x0) + im.shape[2:],
                   np.uint8)
    part = im[desc.y0 : desc.y1, desc.x0 : desc.x1]
    out[: part.shape[0], : part.shape[1]] = part
    return out


def _grown(im: np.ndarray, h: int, w: int, fill) -> np.ndarray:
    """``im`` at the top left of an ``h`` x ``w`` image of ``fill``."""
    if im.shape[:2] == (h, w):
        return im
    out = np.empty((h, w) + im.shape[2:], np.uint8)
    out[...] = fill
    out[: im.shape[0], : im.shape[1]] = im
    return out


def read_gif(path: str) -> np.ndarray:
    """Frame 0 of the GIF file at ``path``, as ``Image.open`` gives it."""
    with open(path, "rb") as f:
        return read_frame(f.read(), 0)


# -- the writer ---------------------------------------------------------------


def lzw_encode_py(pixels: bytes, bits: int = 8) -> bytes:
    """Pillow's GIF LZW encoder (``GifEncode.c``) over ``pixels``: a clear
    code first, greedy longest matches, a clear instead of the 4097th
    table entry, the last match and the end code, the codes packed LSB
    first.  The plain version of the native encoder."""
    clear, end = 1 << bits, (1 << bits) + 1
    out = bytearray()
    acc = nacc = 0

    def put(code: int, width: int) -> None:
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def reset():
        return {}, end + 1, 2 * clear - 1, bits + 1

    codes, nxt, maxcode, width = reset()
    put(clear, width)
    if not pixels:
        put(end, width)
    else:
        head = pixels[0]
        for tail in pixels[1:]:
            key = (head << 8) | tail
            code = codes.get(key)
            if code is not None:
                head = code
                continue
            put(head, width)
            if nxt < _TABLE:
                codes[key] = nxt
                if nxt > maxcode:
                    maxcode = 2 * maxcode + 1
                    width += 1
                nxt += 1
            else:
                put(clear, width)
                codes, nxt, maxcode, width = reset()
            head = tail
        put(head, width)
        put(end, width)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def lzw_codes(pixels: bytes, bits: int = 8) -> bytes:
    """Pillow's LZW code stream for ``pixels``: native when the library
    loads, else :func:`lzw_encode_py`."""
    codes = _native.gif_lzw_encode(pixels, bits)
    return lzw_encode_py(pixels, bits) if codes is None else codes


def sub_blocks(codes: bytes, width: int) -> bytes:
    """A frame's code stream in data sub-blocks as Pillow writes them:
    ``ImageFile._save`` hands the encoder buffers of ``max(65536, 4 *
    width)`` bytes, and the encoder fills each with sub-blocks of 255
    bytes, the last one in a buffer what is left of it.  Without the
    terminator."""
    bufsize = max(1 << 16, 4 * width)
    caps = [255] * (bufsize // 256) + (
        [bufsize % 256 - 1] if bufsize % 256 >= 2 else [])
    out = bytearray()
    i = k = 0
    while i < len(codes):
        part = codes[i : i + caps[k % len(caps)]]
        out.append(len(part))
        out += part
        i, k = i + len(part), k + 1
    return bytes(out)


def _interlaced(img: np.ndarray) -> np.ndarray:
    return np.concatenate([img[0::8], img[4::8], img[2::4], img[1::2]])


def _to_l(mode: str, img: np.ndarray) -> np.ndarray:
    """``convert("L")`` of a ``1``, ``L``, ``I;16``, ``I`` or ``F`` image
    (:func:`png.array_mode`'s pixels): 0/255, as is, clipped, or (``F``,
    float32) clipped and truncated with NaN to 0."""
    if mode == "1":
        return img * np.uint8(255)
    if mode == "L":
        return img
    if mode == "F":
        v = img.astype(np.float32)
        with np.errstate(invalid="ignore"):
            out = np.where(v >= 255, 255, 0).astype(np.uint8)
            inside = (v > 0) & (v < 255)
        out[inside] = v[inside].astype(np.uint8)
        return out
    return np.clip(img.astype(np.int64), 0, 255).astype(np.uint8)


def _table_size(n: int) -> int:
    """``_get_color_table_size`` for ``n`` palette entries."""
    return 1 if n < 3 else (n - 1).bit_length() - 1


def _optimised(px: np.ndarray, entries: int) -> Optional[np.ndarray]:
    """``_get_optimize`` of a ``P`` image with ``entries`` palette
    entries: the indices in use where Pillow remaps to them, else None."""
    if px.size >= 512 * 512:
        return None
    used = np.flatnonzero(np.bincount(px.ravel(), minlength=256))
    if used[-1] >= len(used):
        return used
    current = 1 << (entries - 1).bit_length()
    if len(used) <= current // 2 and current > 2:
        return used
    return None


def _quantized(mode: str, img: np.ndarray):
    """``convert("P", palette=ADAPTIVE)`` and ``_normalize_palette`` of an
    RGB or RGBA image: (indices, the RGB palette bytes, the transparent
    index or None)."""
    px = quant.pixels(img)
    if mode == "RGB":
        idx, pal = quant.median_cut(px)
        trans = None
    else:
        idx, pal = quant.octree(px)
        clear = np.flatnonzero(pal[:, 3] == 0)
        trans = int(clear[0]) if len(clear) else None
    idx = idx.reshape(img.shape[:2])
    used = _optimised(idx, len(pal))
    if used is not None:
        rank = np.zeros(256, np.uint8)
        rank[used] = np.arange(len(used), dtype=np.uint8)
        idx, pal = rank[idx], pal[used]
        if trans is not None:
            trans = int(rank[trans]) if trans in used else None
    return idx, np.ascontiguousarray(pal[:, :3]).tobytes(), trans


def encode_gif(image: np.ndarray) -> bytes:
    """The bytes of ``Image.fromarray(image).save(f, "GIF")`` for a 2-D
    image, or an RGB or RGBA one (see the module docstring)."""
    mode, img = array_mode(image)
    if mode == "LA":  # convert("L") drops the alpha
        mode, img = "L", np.ascontiguousarray(img[..., 0])
    h, w = img.shape[:2]
    if (h == 0 or w == 0) and mode in ("RGB", "RGBA"):  # _get_optimize
        raise ValueError("max() iterable argument is empty")
    if h == 0 or w == 0:
        raise SystemError("tile cannot extend outside image")
    trans = None
    if mode in ("RGB", "RGBA"):
        px, palette, trans = _quantized(mode, img)
    elif mode == "1":  # kept as is: no palette optimisation
        px = _to_l(mode, img)
        palette = bytes(i // 3 for i in range(768))
    else:
        lum = _to_l(mode, img)
        used = np.flatnonzero(np.bincount(lum.ravel(), minlength=256))
        rank = np.zeros(256, np.uint8)
        rank[used] = np.arange(len(used), dtype=np.uint8)
        px = rank[lum]
        palette = np.repeat(used.astype(np.uint8), 3).tobytes()
    size = _table_size(len(palette) // 3)
    palette += b"\0" * (3 * ((2 << size) - len(palette) // 3))
    interlace = min(h, w) >= 16
    if interlace:
        px = _interlaced(px)
    blocks = sub_blocks(lzw_codes(np.ascontiguousarray(px).tobytes(), 8), w)
    version = b"GIF87a" if trans is None else b"GIF89a"
    head = version + struct.pack("<HHBBB", w, h, 128 + size, 0, 0)
    control = b"" if trans is None else struct.pack("<3sBHBB", b"!\xf9\x04",
                                                    1, 0, trans, 0)
    desc = b"," + struct.pack("<HHHHB", 0, 0, w, h, 64 if interlace else 0)
    return head + palette + control + desc + b"\x08" + blocks + b"\0;"


def write_gif(path: str, image: np.ndarray) -> None:
    """Write ``image`` as ``Image.fromarray(image).save(path)`` writes a
    GIF (:func:`encode_gif`)."""
    data = encode_gif(image)
    with open(path, "wb") as f:
        f.write(data)
