"""Palm bitmaps written as PIL 12 writes them for the JAX package's
toolbox (``PIL/PalmImagePlugin.py``, ``Image.fromarray(image).save(path)``
of a ``.palm`` name); PIL has no reader for them.

:func:`encode_palm` writes mode ``1`` (bool) only: a 16-byte big-endian
header (width, height, the row bytes rounded up to whole 16-bit words, no
flags, 1 bit a pixel, version 0, no next offset, transparent index 0, no
compression), then the rows with a set bit black (``False``), zero
padded.  A uint8 image raises PIL's ``OSError`` (PIL writes ``L`` only
where a ``bpp`` option or info is given, which ``fromarray`` never
gives), as does every other mode.
"""

from __future__ import annotations

import struct

import numpy as np

from unmicst_tpu_torch.io.png import array_mode

_NO_COMPRESSION = 0xFF


def encode_palm(image: np.ndarray) -> bytes:
    """The bytes ``Image.fromarray(image).save(path)`` writes for a Palm
    name (see the module docstring)."""
    mode, img = array_mode(image)
    if mode != "1":
        raise OSError(f"cannot write mode {mode} as Palm")
    h, w = img.shape
    rowbytes = (w + 15) // 16 * 2
    head = struct.pack(">HHHHBBHBBH", w, h, rowbytes, 0, 1, 0, 0, 0,
                       _NO_COMPRESSION, 0)
    if 0 in img.shape:
        raise SystemError("tile cannot extend outside image")
    body = np.zeros((h, rowbytes), np.uint8)
    packed = np.packbits(img == 0, axis=1)
    body[:, : packed.shape[1]] = packed
    return head + body.tobytes()


def write_palm(path: str, image: np.ndarray) -> None:
    """Write ``image`` as ``Image.fromarray(image).save(path)`` writes a
    Palm bitmap (:func:`encode_palm`)."""
    data = encode_palm(image)
    with open(path, "wb") as f:
        f.write(data)
