"""MPO files (CIPA DC-007, the Multi-Picture Format) and plain JPEG files
by frame, as PIL opens them for the JAX package: ``Image.open`` and
``seek(k)`` in its TIFF fallback (``unmicst_tpu/io/slides.py:74-79``,
``unmicst_tpu/io/tiff.py:1286-1291``) and the toolbox's ``imread``.

PIL's ``jpeg_factory`` (``PIL/JpegImagePlugin.py``) takes a JPEG as an
MPO where its header, up to the first SOS, holds an APP2 segment that
starts ``MPF\\0``: a TIFF header (either byte order) and an IFD with
``NumberOfImages`` (0xB001) above 1 and ``MPEntry`` (0xB002), 16 bytes
an image, and no APP1 segment naming an Ultra HDR gain map.  Frame k is
the JPEG at entry k's ``DataOffset``, counted from the TIFF header
(entry 0's counts as 0), decoded by :mod:`unmicst_tpu_torch.io.jpeg` as
PIL decodes a file from there (in reads of ``jpeg.PIL_FEED`` bytes).  An
MP index PIL cannot read (``_getmp``'s ``SyntaxError``, a non-JPEG entry,
a count that is no integer) leaves a plain JPEG of one frame; entries
shorter than their count make a file PIL cannot identify
(:class:`MpoError`).  Past the last frame ``EOFError``; a frame whose
offset lies at the file's end ``ValueError`` and one that holds no JPEG
``SyntaxError``, as PIL's ``seek`` raises them.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from unmicst_tpu_torch.io import jpeg


class MpoError(OSError):
    """A file PIL cannot identify (``UnidentifiedImageError``: no JPEG
    signature, or an MP index whose entries run short of its image
    count), or a frame libjpeg cannot decode (PIL's ``OSError``)."""


# TIFF field types PIL loads, by size; other types are skipped unread
_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 13: 4, 16: 8}
_INTEGER_TYPES = {3: "H", 4: "L", 8: "h", 9: "l"}
# the TIFF headers PIL's ImageFileDirectory_v2 accepts
_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
             b"MM\x00\x2b", b"II\x2b\x00")
# JPEG markers PIL's header walk takes without a length
_NO_LENGTH = {0xC8} | set(range(0xD0, 0xDA)) | set(range(0xF0, 0xFE))
_HDR_GAIN_MAP = b' hdrgm:Version="'


def _mp_segment(data: bytes):
    """PIL's marker walk of the first frame's header, to its first SOS:
    the payload of the last APP2 ``MPF`` segment after its 4-byte tag and
    that payload's offset in the file, or None; and whether an APP1
    segment names an Ultra HDR gain map."""
    mp, hdr, pos = None, False, 2
    while pos + 1 < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
        elif m == 0x00 or m in _NO_LENGTH:
            pos += 2
        elif m < 0xC0:
            break  # PIL: "no marker found"
        else:
            if pos + 4 > len(data):
                break
            n = (data[pos + 2] << 8) | data[pos + 3]
            body = data[pos + 4 : pos + 2 + n]
            if m == 0xE2 and body.startswith(b"MPF\0"):
                mp = (body[4:], pos + 8)
            elif m == 0xE1 and _HDR_GAIN_MAP in body:
                hdr = True
            if m == 0xDA:
                break
            pos += 2 + n
    return mp, hdr


def _ifd_tags(mp: bytes, order: str, at: int) -> dict:
    """The tags of the IFD at ``at`` as PIL's ``ImageFileDirectory_v2
    .load`` keeps them, ``{tag: (type, count, data)}``: types it does not
    know skipped, a field whose data run past the segment ending the
    load there (PIL warns and keeps what it read)."""
    tags = {}
    if at + 2 > len(mp):
        return tags
    (n,) = struct.unpack_from(order + "H", mp, at)
    for k in range(n):
        p = at + 2 + 12 * k
        if p + 12 > len(mp):
            break
        tag, typ, count = struct.unpack_from(order + "HHL", mp, p)
        if typ not in _TYPE_SIZES:
            continue
        size = count * _TYPE_SIZES[typ]
        if size > 4:
            (off,) = struct.unpack_from(order + "L", mp, p + 8)
            if off + size > len(mp):
                break
            raw = mp[off : off + size]
        else:
            raw = mp[p + 8 : p + 8 + size]
        if raw:
            tags[tag] = (typ, count, raw)
    return tags


def frame_offsets(data: bytes) -> List[int]:
    """Where each frame's JPEG starts: ``[0]`` for a plain JPEG, and an
    MPO's offsets as PIL computes them."""
    seg, hdr = _mp_segment(data)
    if seg is None:
        return [0]
    mp, base = seg
    head = mp[:8]
    if len(head) < 8 or head[:4] not in _PREFIXES or head[2] == 0x2B:
        return [0]  # PIL: "malformed MP Index" (BigTIFF: no 8-byte offset)
    ifd_order = ">" if head[:2] == b"MM" else "<"
    entry_order = ">" if head.startswith(b"MM\x00\x2a") else "<"
    tags = _ifd_tags(mp, ifd_order, struct.unpack_from(ifd_order + "L",
                                                       head, 4)[0])
    count, entries = tags.get(0xB001), tags.get(0xB002)
    if count is None or count[0] not in _INTEGER_TYPES or count[1] != 1 \
            or entries is None or entries[0] not in (1, 7):
        return [0]  # PIL: "malformed MP Index", or a count it cannot use
    (n,) = struct.unpack_from(ifd_order + _INTEGER_TYPES[count[0]], count[2])
    raw, offsets = entries[2], []
    for k in range(n):
        if len(raw) < 16 * (k + 1):
            raise MpoError("cannot identify image file: its MP index lists "
                           f"{n} images in {len(raw)} bytes of entries")
        attr, _, offset, _, _ = struct.unpack_from(entry_order + "LLLHH",
                                                   raw, 16 * k)
        if (attr >> 24) & 7:
            return [0]  # PIL: "unsupported picture format in MPO"
        offsets.append(offset + base)
    if n <= 1 or hdr:
        return [0]  # one image, or an Ultra HDR image: a plain JPEG
    offsets[0] = 0
    return offsets


def read_frame(data: bytes, index: int) -> np.ndarray:
    """Frame ``index`` of a JPEG or MPO file's bytes, as PIL's ``seek``
    and ``np.asarray`` give it: ``[H, W]`` or ``[H, W, 3]`` uint8."""
    offsets = frame_offsets(data)
    if not 0 <= index < len(offsets):
        raise EOFError("attempt to seek outside sequence")
    at = offsets[index]
    if index and at + 2 >= len(data):
        raise ValueError("No data found for frame")
    if not data[at : at + 3] == b"\xff\xd8\xff":
        if not index:
            raise MpoError("cannot identify image file: no JPEG signature")
        raise SyntaxError("not a JPEG file")
    try:
        return jpeg.decode(data[at:], feed=jpeg.PIL_FEED)
    except ValueError as e:  # the decoder's JpegError, or the native one's
        raise MpoError(str(e)) from None


def read_mpo(path: str, index: int = 0) -> np.ndarray:
    """:func:`read_frame` of the file at ``path``."""
    with open(path, "rb") as f:
        return read_frame(f.read(), index)

