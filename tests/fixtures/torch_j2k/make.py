"""Write the JPEG 2000 fixtures of ``unmicst_tpu_torch/io/jpeg2000.py``:
small J2K codestreams and JP2 files PIL 12.1 (openjpeg 2.5) writes, some
of them wrapped in JP2 boxes or edited here, PIL's read of each, and two
4096^2 slides with the sha256 of PIL's read.

    python tests/fixtures/torch_j2k/make.py

The box and marker helpers and :func:`blob_slide` need numpy only (the
card's machine has no PIL); :func:`small_cases`, :func:`big_cases` and
:func:`main` need PIL.  :func:`main` writes, beside this script:

* ``<name>.jp2`` / ``<name>.j2k``: each case of :func:`small_cases`
  (each at most 8 KB): every progression order, tiles and image offsets,
  precincts, quality layers, code-block sizes, the component transform
  on and off, signed samples, 5/3 and 9/7, modes L, I;16, LA, RGB and
  RGBA, a ``pclr``/``cmap`` palette, CMYK, tile-parts, COC/QCC, TLM, PLT
  and unknown markers, a 12-bit component;
* ``reads.npz``: PIL's ``np.asarray(Image.open(f))`` of each, keyed by
  file name;
* ``slide_lossy.jp2`` (a seeded 4096^2 slide with noise at
  ``irreversible=True, quality_layers=[40]`` in 1024^2 tiles) and
  ``slide_lossless.j2k`` (the same recipe without noise, reversible),
  and ``slides.json``: the dtype, shape and sha256 of PIL's read of
  each.
"""

import hashlib
import io
import json
import os
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SLIDE = 4096


# -- JP2 boxes and codestream markers -----------------------------------------


def box(typ: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), typ) + body


def ihdr(h: int, w: int, nc: int, bpc: int) -> bytes:
    return box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))


def colr(enumcs: int) -> bytes:
    return box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))


def pclr(entries, depths) -> bytes:
    """A palette box of ``entries`` (tuples of one value per column) and
    the columns' depth bytes."""
    body = struct.pack(">HB", len(entries), len(depths)) + bytes(depths)
    for e in entries:
        for v, d in zip(e, depths):
            n = ((d & 0x7F) + 8) >> 3
            body += (int(v) % (1 << (8 * n))).to_bytes(n, "big")
    return box(b"pclr", body)


def cmap(n: int) -> bytes:
    return box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k)
                                 for k in range(n)))


def jp2(cs: bytes, header: bytes) -> bytes:
    """A JP2 file around the codestream ``cs``: signature, ``ftyp``, a
    ``jp2h`` of ``header``'s boxes, ``jp2c``."""
    return (b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
            + box(b"ftyp", b"jp2 \0\0\0\0jp2 ") + box(b"jp2h", header)
            + box(b"jp2c", cs))


def markers(cs: bytes):
    """The main header's marker segments ``[(marker, body)]`` and the
    rest of the codestream from its first SOT."""
    pos, out = 2, []
    while True:
        m = struct.unpack_from(">H", cs, pos)[0]
        if m == 0xFF90:
            return out, cs[pos:]
        n = struct.unpack_from(">H", cs, pos + 2)[0]
        out.append((m, cs[pos + 4 : pos + 2 + n]))
        pos += 2 + n


def join(segs, rest: bytes) -> bytes:
    return b"\xff\x4f" + b"".join(struct.pack(">HH", m, len(b) + 2) + b
                                  for m, b in segs) + rest


def split_tile_part(cs: bytes, at: int) -> bytes:
    """``cs`` (one tile-part first) with its first tile-part's data cut
    into two tile-parts after ``at`` bytes."""
    segs, rest = markers(cs)
    _, isot, psot, _, _ = struct.unpack_from(">HHIBB", rest, 2)
    sod = rest.index(b"\xff\x93")
    data = rest[sod + 2 : psot]
    head = rest[:4] + struct.pack(">HIBB", isot, sod + 2 + at, 0, 2) \
        + rest[12:sod] + b"\xff\x93" + data[:at]
    tail = struct.pack(">HHHIBB", 0xFF90, 10, isot, 14 + len(data) - at, 1,
                       2) + b"\xff\x93" + data[at:]
    return join(segs, head + tail + rest[psot:])


def set_precision(cs: bytes, ssiz: int) -> bytes:
    """``cs`` with every component's Ssiz byte set to ``ssiz``."""
    i = cs.index(b"\xff\x51")
    nc = struct.unpack_from(">H", cs, i + 38)[0]
    out = bytearray(cs)
    for k in range(nc):
        out[i + 40 + 3 * k] = ssiz
    return bytes(out)


# -- images -------------------------------------------------------------------


def blob_slide(rng, h: int, w: int, n_blobs: int, background=None):
    """chip_smoke.py's blob recipe: nuclei on seeded noise, or on a flat
    ``background`` level."""
    img = (rng.rand(h, w).astype(np.float32) * 0.15 if background is None
           else np.full((h, w), background, np.float32))
    for _ in range(n_blobs):
        r, c = rng.randint(20, h - 20), rng.randint(20, w - 20)
        rad = rng.randint(5, 9)
        r0, c0 = r - rad - 2, c - rad - 2
        rr, cc = np.ogrid[r0 : r + rad + 3, c0 : c + rad + 3]
        d2 = (rr - r) ** 2 + (cc - c) ** 2
        win = img[r0 : r + rad + 3, c0 : c + rad + 3]
        win[d2 < rad ** 2] = 0.7
        win[(d2 < (rad + 2) ** 2) & (d2 >= rad ** 2)] = 0.4
    return img


def _smooth(rng, h: int, w: int, bands: int = 0) -> np.ndarray:
    """Seeded smooth content with a little noise: uint8 ``(h, w)`` or
    ``(h, w, bands)``."""
    y, x = np.mgrid[:h, :w]
    planes = []
    for k in range(max(bands, 1)):
        a, b = rng.uniform(0.05, 0.4, 2)
        v = 128 + 90 * np.sin(a * x + k) * np.cos(b * y) + rng.randint(
            -6, 7, (h, w))
        planes.append(np.clip(v, 0, 255))
    out = np.stack(planes, -1) if bands else planes[0]
    return out.astype(np.uint8)


def _encode(x: np.ndarray, **kw) -> bytes:
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(x).save(b, "JPEG2000", **kw)
    return b.getvalue()


def small_cases():
    """name -> (extension, bytes) of the small fixtures."""
    rng = np.random.RandomState(22)
    g = _smooth(rng, 37, 29)
    rgb = _smooth(rng, 40, 36, 3)
    rgba = _smooth(rng, 33, 27, 4)
    la = _smooth(rng, 30, 26, 2)
    wide = (_smooth(rng, 31, 23).astype(np.uint16) * 257
            + rng.randint(0, 257, (31, 23))).astype(np.uint16)
    j2k = dict(no_jp2=True)
    c = {
        "l_lrcp": (".jp2", _encode(g)),
        "l_rlcp_layers": (".j2k", _encode(g, progression="RLCP",
                                          quality_layers=[40, 20, 10],
                                          **j2k)),
        "l_rpcl_precincts": (".j2k", _encode(
            _smooth(rng, 64, 48), progression="RPCL", num_resolutions=3,
            precinct_size=(32, 32), codeblock_size=(8, 8), **j2k)),
        "rgb_pcrl_tiles_mct": (".jp2", _encode(
            rgb, progression="PCRL", tile_size=(16, 16), num_resolutions=3,
            mct=1)),
        "rgba_cprl_97_mct": (".jp2", _encode(
            rgba, progression="CPRL", irreversible=True, mct=1,
            quality_layers=[30, 10])),
        "la_offsets": (".jp2", _encode(
            la, offset=(5, 3), tile_offset=(2, 1), tile_size=(16, 12),
            num_resolutions=3)),
        "la_offsets_97": (".j2k", _encode(
            la, offset=(7, 2), tile_offset=(3, 1), tile_size=(13, 17),
            num_resolutions=2, irreversible=True, **j2k)),
        "i16_97_layers": (".jp2", _encode(wide, irreversible=True,
                                          quality_layers=[60, 20])),
        "i16_53_tiles": (".j2k", _encode(wide, tile_size=(16, 16),
                                         num_resolutions=3, **j2k)),
        "l_signed_97": (".j2k", _encode(g, signed=True, irreversible=True,
                                        **j2k)),
        "i16_signed": (".j2k", _encode(wide, signed=True, **j2k)),
        "rgb_97_nomct": (".j2k", _encode(rgb, irreversible=True, mct=0,
                                         **j2k)),
        "rgb_53_mct_layers": (".jp2", _encode(
            rgb, mct=1, quality_layers=[50, 25, 12],
            progression="RLCP")),
        "l_codeblocks_4x64": (".j2k", _encode(
            g, codeblock_size=(4, 64), num_resolutions=2, **j2k)),
        "l_codeblocks_64x4_97": (".j2k", _encode(
            g, codeblock_size=(64, 4), irreversible=True, **j2k)),
        "l_plt_comment": (".jp2", _encode(g, plt=True, comment="unmicst",
                                          tile_size=(16, 16),
                                          num_resolutions=2)),
        "l_tiny": (".j2k", _encode(np.array([[7, 200]], np.uint8), **j2k)),
        "l_tiny_97": (".j2k", _encode(np.array([[7], [200], [90]],
                                               np.uint8),
                                      irreversible=True, **j2k)),
    }
    # a 12-bit component: the L codestream's samples as 12-bit values
    c["l_prec12"] = (".j2k", set_precision(c["l_rlcp_layers"][1], 11))
    # a palette (pclr and cmap) and a CMYK JP2 around PIL's codestreams
    idx = _encode(rng.randint(0, 40, (21, 19)).astype(np.uint8), **j2k)
    entries = [(k * 6, 255 - k * 6, (k * 37) % 256) for k in range(40)]
    c["p_palette"] = (".jp2", jp2(idx, ihdr(21, 19, 1, 7) + colr(16)
                                  + pclr(entries, [7, 7, 7]) + cmap(3)))
    c["pa_palette"] = (".jp2", jp2(_encode(la, **j2k), ihdr(30, 26, 2, 7)
                                   + colr(16) + pclr(entries, [7, 7, 7])
                                   + cmap(3)))
    c["cmyk"] = (".jp2", jp2(_encode(rgba, mct=0, **j2k),
                             ihdr(33, 27, 4, 7) + colr(12)))
    c["rgba_gray_colr"] = (".jp2", jp2(_encode(rgba, **j2k),
                                       ihdr(33, 27, 4, 7) + colr(17)))
    c["rgb_from_gray"] = (".jp2", jp2(_encode(g, **j2k), ihdr(37, 29, 3, 7)
                                      + colr(17)))
    # one tile's data in two tile-parts; the last tile-part to the end
    lay = _encode(g, quality_layers=[40, 10], **j2k)
    c["l_tile_parts"] = (".j2k", split_tile_part(lay, 40))
    segs, rest = markers(lay)
    c["l_psot0"] = (".j2k", join(segs, rest[:6] + bytes(4) + rest[10:]))
    # COC (fewer resolutions for component 1) and QCC (other step sizes
    # for component 2) after COD and QCD; TLM, CRG and an unknown marker
    rgb97 = _encode(rgb, irreversible=True, num_resolutions=4, **j2k)
    segs, rest = markers(rgb97)
    cod = dict(segs)[0xFF52]
    qcd = bytearray(dict(segs)[0xFF5C])
    for k in range(1, len(qcd) - 1, 2):
        qcd[k + 1] ^= 0x40
    k = [m for m, _ in segs].index(0xFF5C) + 1
    segs[k:k] = [(0xFF53, bytes([1, 0, cod[5] - 1]) + cod[6:]),
                 (0xFF5D, bytes([2]) + bytes(qcd)),
                 (0xFF55, bytes([0, 0x50]) + struct.pack(">HI", 0, 999)),
                 (0xFF63, bytes(12)), (0xFF30, b"")]
    c["rgb_coc_qcc_tlm"] = (".j2k", join(segs, rest))
    return c


def big_cases():
    """name -> (extension, bytes) of the two 4096^2 slides."""
    rng = np.random.RandomState(22)
    noisy = (blob_slide(rng, SLIDE, SLIDE, 350) * 255).astype(np.uint8)
    flat = (blob_slide(rng, SLIDE, SLIDE, 350, 0.1) * 255).astype(np.uint8)
    return {"slide_lossy": (".jp2", _encode(
                noisy, irreversible=True, quality_layers=[40],
                tile_size=(1024, 1024))),
            "slide_lossless": (".j2k", _encode(flat, no_jp2=True))}


def main() -> None:
    from PIL import Image

    reads = {}
    for name, (ext, data) in sorted(small_cases().items()):
        fname = name + ext
        assert len(data) <= 8192, (fname, len(data))
        with open(os.path.join(HERE, fname), "wb") as f:
            f.write(data)
        reads[fname] = np.asarray(Image.open(io.BytesIO(data)))
    np.savez_compressed(os.path.join(HERE, "reads.npz"), **reads)
    slides = {}
    for name, (ext, data) in big_cases().items():
        fname = name + ext
        with open(os.path.join(HERE, fname), "wb") as f:
            f.write(data)
        px = np.asarray(Image.open(io.BytesIO(data)))
        slides[fname] = {"dtype": str(px.dtype), "shape": list(px.shape),
                         "sha256": hashlib.sha256(px.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "slides.json"), "w") as f:
        json.dump(slides, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
