"""Write the digests of PIL's ICO, ICNS and PDF files for the seeded
planes ``chip_smoke.py`` writes through the port's toolbox on the card
(``unmicst_tpu_torch/io/ico.py``, ``io/icns.py``, ``io/pdf.py``).

    python tests/fixtures/torch_write25/make.py

:func:`planes`, :func:`split` and :func:`fixed_gmtime` need numpy and the
standard library only (the card's machine has no PIL, and
``chip_smoke.py`` loads this file by path).  :func:`main` needs PIL and
writes ``writes.json`` beside this script: for each plane of
:func:`planes` at 4096^2 (uint8, bool, RGBA, uint16) and each of
``.ico``, ``.icns`` and ``.pdf``, what ``Image.fromarray(x).save`` of
``<plane><ext>`` gives with ``time.gmtime`` fixed to :data:`FIXED_DATE`:

* an ICO or ICNS file: the sha256 of its skeleton (:func:`split`: every
  byte outside the PNG entries, with the lengths and offsets that depend
  on them zeroed, and each entry's signature and IHDR chunk), and for
  each entry the dtype, shape and sha256 of PIL's read of its PNG (the
  port's PNG bytes are its own deflate, its pixels PIL's);
* a PDF: the sha256 of the whole file;
* where PIL raises: the exception's class and message.
"""

import contextlib
import hashlib
import json
import os
import struct
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SLIDE = 4096
EXTS = (".ico", ".icns", ".pdf")
# the date both packages' PDFs carry where the tests and the card fix it
FIXED_DATE = (2024, 3, 5, 7, 8, 9, 1, 65, 0)
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def blob_slide(rng, h: int, w: int, n_blobs: int) -> np.ndarray:
    """uint8 noise with ringed blobs (integer arithmetic only, so the
    same on every machine)."""
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


def planes(seed: int = 25, side: int = SLIDE) -> dict:
    """name -> array: seeded ``side``^2 planes of the four kinds the card
    writes (uint8, bool, RGBA with a varying alpha, uint16)."""
    rng = np.random.RandomState(seed)
    n = max(20, 350 * side * side // SLIDE ** 2)
    gray = blob_slide(rng, side, side, n)
    rgba = np.stack([blob_slide(rng, side, side, n) for _ in range(3)]
                    + [255 - blob_slide(rng, side, side, n)], -1)
    wide = (gray.astype(np.uint16) << 8) | rng.randint(
        0, 256, gray.shape).astype(np.uint16)
    return {"uint8": gray, "bool": gray > 90, "rgba": rgba, "uint16": wide}


@contextlib.contextmanager
def fixed_gmtime():
    """``time.gmtime`` returning :data:`FIXED_DATE` (the PDF's
    ``CreationDate`` and ``ModDate``) inside the block."""
    gmtime = time.gmtime
    time.gmtime = lambda *a: time.struct_time(FIXED_DATE)
    try:
        yield
    finally:
        time.gmtime = gmtime


def split(data: bytes, ext: str):
    """``(skeleton, streams)`` of an ICO or ICNS file of PNG entries:
    the PNG streams in the file's order, and the file's other bytes with
    each length and offset that depends on them zeroed and each stream's
    first 33 bytes (signature and IHDR) in its place.  Raises
    ``ValueError`` where the lengths and offsets do not describe the
    streams as they lie, back to back, to the file's end."""
    streams, skel = [], bytearray()

    def need(cond, what):
        if not cond:
            raise ValueError(f"{ext}: {what}")

    if ext == ".ico":
        need(data[:4] == b"\0\0\1\0", "magic")
        n = struct.unpack_from("<H", data, 4)[0]
        skel += data[:6]
        at = 6 + 16 * n
        for i in range(n):
            e = data[6 + 16 * i : 22 + 16 * i]
            size, offset = struct.unpack_from("<II", e, 8)
            need(offset == at, f"entry {i}'s offset")
            streams.append(data[offset : offset + size])
            need(len(streams[-1]) == size, f"entry {i}'s size")
            skel += e[:8] + bytes(8)
            at += size
        need(at == len(data), "the file's length")
    else:
        need(data[:4] == b"icns", "magic")
        need(struct.unpack_from(">i", data, 4)[0] == len(data),
             "the file's length")
        toc = struct.unpack_from(">i", data, 12)[0]
        need(data[8:12] == b"TOC " and toc % 8 == 0, "TOC")
        skel += data[:4] + bytes(4) + data[8:16]
        codes = [data[8 + k : 12 + k] for k in range(8, toc, 8)]
        sizes = [struct.unpack_from(">i", data, 12 + k)[0]
                 for k in range(8, toc, 8)]
        at = 8 + toc
        for code, size in zip(codes, sizes):
            need(data[at : at + 4] == code and struct.unpack_from(
                ">i", data, at + 4)[0] == size, f"block {code!r}")
            streams.append(data[at + 8 : at + size])
            need(len(streams[-1]) == size - 8, f"block {code!r}'s size")
            skel += code + bytes(4)
            at += size
        need(at == len(data), "the file's length")
    for s in streams:
        need(s.startswith(PNG_MAGIC), "an entry that is not a PNG")
        skel += s[:33]
    return bytes(skel), streams


def digest(px: np.ndarray) -> dict:
    """dtype, shape and sha256 of an array (bool values as bytes 0 and
    1: PIL's arrays of mode ``1`` hold 0 and 255)."""
    if px.dtype == bool:
        px = px != 0
    return {"dtype": str(px.dtype), "shape": list(px.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(px).tobytes())
            .hexdigest()}


def record(data: bytes, ext: str, decode) -> dict:
    """What ``writes.json`` keeps of a written file, its PNG entries
    read by ``decode(png bytes) -> array``."""
    if ext == ".pdf":
        return {"file_sha256": hashlib.sha256(data).hexdigest()}
    skel, streams = split(data, ext)
    return {"skeleton_sha256": hashlib.sha256(skel).hexdigest(),
            "entries": [digest(decode(s)) for s in streams]}


def main() -> None:
    import io
    import tempfile
    import warnings

    from PIL import Image

    def decode(png):
        return np.asarray(Image.open(io.BytesIO(png)))

    out = {}
    tmp = tempfile.mkdtemp()
    for name, x in planes().items():
        for ext in EXTS:
            path = os.path.join(tmp, name + ext)
            try:
                with fixed_gmtime(), warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    Image.fromarray(x).save(path)
            except Exception as e:  # noqa: BLE001 -- recorded as PIL's
                out[name + ext] = {"error": f"{type(e).__name__}: {e}"}
                continue
            with open(path, "rb") as f:
                out[name + ext] = record(f.read(), ext, decode)
            os.remove(path)
    os.rmdir(tmp)
    with open(os.path.join(HERE, "writes.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
