"""PDF files written as PIL 12 writes them for the JAX package: the
toolbox's ``Image.fromarray(image).save(path)`` of a ``.pdf`` name
(``PIL/PdfImagePlugin.py`` ``_save`` and ``_write_image``, with
``PdfParser``'s writer of a new file), byte for byte.

One page of the image at 72 dpi:

* ``%PDF-1.4`` and the ``% created by Pillow PDF driver`` comment;
* the catalog (object 4) and the page tree (5), then the image XObject
  (1), the page (2) with its resources and media box, the page's
  contents stream (3, ``q W 0 0 H 0 0 cm /image Do Q``), the ``/Info``
  dictionary (6: ``Title``, the file's base name without its extension,
  where it is not empty; ``CreationDate`` and ``ModDate``, each from its
  own call of ``time.gmtime()`` as PIL makes them), the cross-reference
  table and the trailer;
* mode ``L`` and ``RGB`` images as ``DCTDecode`` streams
  (:func:`unmicst_tpu_torch.io.jpegenc.encode_jpeg`, PIL's JPEG save
  byte for byte); mode ``1`` as ``CCITTFaxDecode``: the TIFF PIL's
  libtiff save writes with ``compression="group4"`` in one strip
  (:func:`unmicst_tpu_torch.io.ccitt.g4_tiff`), less its 8-byte header,
  so the TIFF's IFD after the strip is part of the stream, with PIL's
  ``DecodeParms`` (``K -1``, ``BlackIs1``, the columns and rows).

``I;16``, ``I;16B``, ``I`` and ``F`` images raise PIL's ``ValueError``
("cannot save mode ..."), after the bytes PIL writes before it, and the
file goes where ``Image.save`` removes it; so do an empty image's errors
(the JPEG encoder's ``ValueError``, the TIFF and JPEG 2000 encoders'
``SystemError``).  ``LA`` and ``RGBA`` images, which PIL writes as
``JPXDecode`` streams through its JPEG 2000 encoder, raise
``NotImplementedError`` naming ROADMAP M17 at the same point.
"""

from __future__ import annotations

import codecs
import os
import time
from typing import Any

import numpy as np

from unmicst_tpu_torch.io import _pil, ccitt, jpegenc, png


class Name(bytes):
    """A PDF name (``PdfParser.PdfName``)."""


class Ref(tuple):
    """An indirect reference ``n 0 R`` (``IndirectReference``)."""


def _repr(x: Any) -> bytes:
    """``PdfParser.pdf_repr`` of the values this writer makes (its names
    need no escapes)."""
    if x is True:
        return b"true"
    if isinstance(x, Name):
        return b"/" + x
    if isinstance(x, Ref):
        return b"%d %d R" % x
    if isinstance(x, (int, float)):
        return str(x).encode("us-ascii")
    if isinstance(x, time.struct_time):
        return (b"(D:" + time.strftime("%Y%m%d%H%M%SZ", x).encode("us-ascii")
                + b")")
    if isinstance(x, dict):
        out = b"<<"
        for key, value in x.items():
            if value is not None:
                out += b"\n" + _repr(Name(key.encode("us-ascii"))) + b" " \
                    + _repr(value)
        return out + b"\n>>"
    if isinstance(x, list):
        return b"[ " + b" ".join(_repr(v) for v in x) + b" ]"
    if isinstance(x, str):
        return _repr(codecs.BOM_UTF16_BE + x.encode("utf_16_be"))
    x = x.replace(b"\\", b"\\\\").replace(b"(", b"\\(").replace(b")", b"\\)")
    return b"(" + x + b")"


class _Writer:
    """``PdfParser``'s writer of a new file: objects numbered as its
    ``next_object_id`` numbers them, their offsets for the xref."""

    def __init__(self, f):
        self.f = f
        self.offsets = {}

    def new_ref(self, offset: int = 0) -> Ref:
        ref = Ref((max(self.offsets, default=0) + 1, 0))
        self.offsets[ref[0]] = offset
        return ref

    def write_obj(self, ref: Ref, *objs, stream: bytes = None, **d) -> None:
        self.offsets[ref[0]] = self.f.tell()
        self.f.write(b"%d %d obj" % ref)
        if stream is not None:
            d["Length"] = len(stream)
        if d:
            self.f.write(_repr(d))
        for obj in objs:
            self.f.write(_repr(obj))
        if stream is not None:
            self.f.write(b"stream\n" + stream + b"\nendstream\n")
        self.f.write(b"endobj\n")


def _image(mode: str, px: np.ndarray, image: np.ndarray):
    """``_write_image``'s filter, stream and dictionary entries, and the
    page's procset, for an image in ``mode``."""
    h, w = px.shape[:2]
    entries = {"BitsPerComponent": 8}
    if mode in ("1", "LA", "RGBA") and 0 in (h, w):  # the encoder's setimage
        raise SystemError("tile cannot extend outside image")
    if mode == "1":
        entries["BitsPerComponent"] = 1
        params = [{"K": -1, "BlackIs1": True, "Columns": w, "Rows": h}]
        entries["ColorSpace"] = Name(b"DeviceGray")
        stream = ccitt.g4_tiff(px)[8:]
        return [Name(b"CCITTFaxDecode")], params, stream, entries, "ImageB"
    if mode in ("L", "RGB"):
        entries["ColorSpace"] = Name(b"DeviceGray" if mode == "L"
                                     else b"DeviceRGB")
        return (Name(b"DCTDecode"), None, jpegenc.encode_jpeg(image), entries,
                "ImageB" if mode == "L" else "ImageC")
    if mode in ("LA", "RGBA"):
        raise NotImplementedError(
            f"a PDF of a {mode} image is not written by unmicst_tpu_torch "
            "(PIL writes it as a JPXDecode stream through its JPEG 2000 "
            "encoder: ROADMAP M17)")
    raise ValueError(f"cannot save mode {mode}")


def _save(f, image: np.ndarray, path: str) -> None:
    """``PdfImagePlugin._save`` of ``Image.fromarray(image)`` onto ``f``
    (see the module docstring)."""
    mode, px = png.array_mode(image)
    h, w = px.shape[:2]
    title = os.path.splitext(os.path.basename(path))[0]
    info = {"Title": title or None, "CreationDate": time.gmtime(),
            "ModDate": time.gmtime()}
    pdf = _Writer(f)
    f.write(b"%PDF-1.4\n")
    f.write(b"% created by Pillow PDF driver\n")
    image_ref, page_ref, contents_ref = (pdf.new_ref() for _ in range(3))
    root_ref = pdf.new_ref(f.tell())
    pages_ref = pdf.new_ref()
    pdf.write_obj(root_ref, Type=Name(b"Catalog"), Pages=pages_ref)
    pdf.write_obj(pages_ref, Type=Name(b"Pages"), Count=1, Kids=[page_ref])
    filt, params, stream, entries, procset = _image(mode, px, image)
    pdf.write_obj(image_ref, stream=stream, Type=Name(b"XObject"),
                  Subtype=Name(b"Image"), Width=w, Height=h, Filter=filt,
                  Decode=None, DecodeParms=params, **entries)
    width, height = w * 72.0 / 72.0, h * 72.0 / 72.0
    pdf.write_obj(page_ref, Resources={
        "ProcSet": [Name(b"PDF"), Name(procset.encode())],
        "XObject": {"image": image_ref}},
        MediaBox=[0, 0, width, height], Contents=contents_ref,
        Type=Name(b"Page"), Parent=pages_ref)
    pdf.write_obj(contents_ref, stream=b"q %f 0 0 %f 0 0 cm /image Do Q\n"
                  % (width, height))
    info = {k: v for k, v in info.items() if v}
    info_ref = pdf.new_ref(f.tell())
    pdf.write_obj(info_ref, info)
    start = f.tell()
    n = max(pdf.offsets) + 1
    f.write(b"xref\n0 %d\n%010d %05d f \n" % (n, 0, 65536))
    for k in range(1, n):
        f.write(b"%010d %05d n \n" % (pdf.offsets[k], 0))
    f.write(b"trailer\n" + _repr({"Root": root_ref, "Size": n,
                                  "Info": info_ref})
            + b"\nstartxref\n%d\n%%%%EOF" % start)


def write_pdf(path: str, image: np.ndarray) -> None:
    """Write ``image`` as ``Image.fromarray(image).save(path)`` writes a
    PDF (see the module docstring)."""
    png.array_mode(image)  # fromarray's TypeError before the file opens
    _pil.save_file(path, lambda f: _save(f, image, path))
