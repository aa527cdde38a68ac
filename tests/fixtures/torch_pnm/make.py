"""Write the Netpbm fixtures (``unmicst_tpu_torch/io/pnm.py``): files of
every kind PIL reads, with PIL's read of each, and PIL's writes of each
dtype ``imwrite`` takes.

    python tests/fixtures/torch_pnm/make.py

:func:`pnm` builds a file (no PIL); :func:`main` needs PIL and writes,
beside this script:

* ``<kind>_<maxval>.pnm``: seeded 13 x 17 files, plain (P1-P3) and binary
  (P4-P6), at maxvals 1, 100, 255, 1000 and 65535, binary samples above
  maxval among them; ``Pf`` in both byte orders; PIL's own ``P0CMYK``,
  ``PyP`` and ``PyRGBA``; a header with comments, one inside a token;
* ``<name>.npy``: PIL's ``np.asarray`` of each;
* ``write_<dtype>.npy`` and ``write_<dtype>.<ext>``: a seeded array of
  each dtype (bool, uint8, int8, uint16, int16, int32, uint32, float32,
  float64, RGB and RGBA uint8) and the file ``Image.fromarray(x).save``
  writes for it.

The card's machine has no PIL, so ``chip_smoke.py`` compares the port
with these files.
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# magic -> samples a pixel
BANDS = {b"P1": 1, b"P2": 1, b"P3": 3, b"P4": 1, b"P5": 1, b"P6": 3,
         b"P0CMYK": 4, b"PyP": 1, b"PyRGBA": 4, b"Pf": 1}


def pnm(magic: bytes, samples, maxval=None, header=None) -> bytes:
    """A Netpbm file of ``samples`` (``[h, w]`` or ``[h, w, bands]``):
    P1-P3 as ASCII tokens, P4 packed bits (1 is black), P5/P6 and PIL's
    kinds one byte a sample up to maxval 255 and two (big-endian) above,
    ``Pf`` float32 rows bottom-up, little-endian where ``maxval`` (the
    scale) is negative.  ``header`` replaces the text after the magic."""
    x = np.asarray(samples)
    h, w = x.shape[:2]
    head = header if header is not None else (
        b"\n%d %d\n" % (w, h) + (b"" if magic in (b"P1", b"P4")
                                 else str(maxval).encode() + b"\n"))
    if magic in (b"P1", b"P2", b"P3"):
        rows = x.reshape(h, -1)
        body = b"\n".join(b" ".join(b"%d" % v for v in row) for row in rows)
        return magic + head + body + b"\n"
    if magic == b"P4":
        return magic + head + np.packbits(x.astype(bool), axis=1).tobytes()
    if magic == b"Pf":
        order = "<f4" if maxval < 0 else ">f4"
        return magic + head + np.ascontiguousarray(
            x[::-1], order).tobytes()
    return magic + head + x.astype(">u2" if maxval > 255 else np.uint8
                                   ).tobytes()


def samples(rng, magic: bytes, maxval, h: int = 13, w: int = 17):
    """Seeded samples for ``magic`` at ``maxval``: 0..maxval, and for the
    binary kinds some above maxval, up to what the sample width holds."""
    bands = BANDS[magic]
    shape = (h, w) if bands == 1 else (h, w, bands)
    if magic in (b"P1", b"P4"):
        return rng.randint(0, 2, shape)
    if magic == b"Pf":
        return (rng.randn(*shape) * 100).astype(np.float32)
    top = maxval if magic in (b"P2", b"P3") else (
        255 if maxval <= 255 else 65535)
    return np.minimum(rng.randint(0, maxval + 1, shape)
                      + (rng.rand(*shape) < 0.1) * rng.randint(
                          0, top + 1, shape), top)


def read_cases():
    """name -> file bytes of every read fixture."""
    rng = np.random.RandomState(19)
    out = {}
    for magic in (b"P2", b"P3", b"P5", b"P6"):
        for maxval in (1, 100, 255, 1000, 65535):
            out[f"{magic.decode()}_{maxval}".lower()] = pnm(
                magic, samples(rng, magic, maxval), maxval)
    for magic in (b"P1", b"P4"):
        out[magic.decode().lower()] = pnm(magic, samples(rng, magic, None))
    for scale in (-1.0, 2.5):
        out[f"pf_{'le' if scale < 0 else 'be'}"] = pnm(
            b"Pf", samples(rng, b"Pf", None), scale)
    for magic, maxval in ((b"P0CMYK", 255), (b"PyP", 255), (b"PyRGBA", 77)):
        out[magic.decode().lower()] = pnm(magic, samples(rng, magic, maxval),
                                          maxval)
    out["comments"] = pnm(b"P5", samples(rng, b"P5", 200), 200, header=(
        b" # a comment\n17\t13 #\r200\n"))
    out["comment_in_a_token"] = pnm(b"P2", samples(rng, b"P2", 255), 255,
                                    header=b"\n1#x\n7 13\n255\n")
    return out


def write_arrays():
    """name -> seeded array of every write fixture."""
    rng = np.random.RandomState(20)
    out = {"bool": rng.rand(13, 17) < 0.5}
    for dt in ("uint8", "int8", "uint16", "int16", "int32", "uint32"):
        info = np.iinfo(dt)
        out[dt] = rng.randint(max(info.min, -70000), min(info.max, 70000),
                              (13, 17)).astype(dt)
    for dt in ("float32", "float64"):
        out[dt] = (rng.randn(13, 17) * 1000).astype(dt)
    out["rgb"] = rng.randint(0, 256, (13, 17, 3)).astype(np.uint8)
    out["rgba"] = rng.randint(0, 256, (13, 17, 4)).astype(np.uint8)
    return out


# the extension each write fixture is saved under (the mode picks the kind)
WRITE_EXTENSIONS = {"bool": "pbm", "rgb": "ppm", "rgba": "pnm",
                    "float32": "pfm", "float64": "pfm"}


def main() -> None:
    from PIL import Image

    for name, data in read_cases().items():
        path = os.path.join(HERE, name + ".pnm")
        with open(path, "wb") as f:
            f.write(data)
        with Image.open(path) as im:
            np.save(os.path.join(HERE, name + ".npy"), np.asarray(im))
    for name, x in write_arrays().items():
        np.save(os.path.join(HERE, f"write_{name}.npy"), x)
        ext = WRITE_EXTENSIONS.get(name, "pgm")
        Image.fromarray(x).save(os.path.join(HERE, f"write_{name}.{ext}"))


if __name__ == "__main__":
    main()
