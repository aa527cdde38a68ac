"""JPEG XR (HD Photo) CZI sub-blocks: refused.

The JAX package decodes them only when the optional ``imagecodecs``
package imports (``unmicst_tpu/io/jxr.py:1-60``), the reference tool's
own route (``czifile`` + ``imagecodecs``).  The port's import rule leaves
``imagecodecs`` out, and no JPEG XR decoder ships here, so a plane made of
such sub-blocks raises ``NotImplementedError`` when it is opened; it never
comes back blank or partial.
"""

from __future__ import annotations


def refuse(context: str = "") -> NotImplementedError:
    """The error for a JPEG XR sub-block, naming the file and block."""
    return NotImplementedError(
        f"{context or 'CZI'}: sub-block is JPEG XR-compressed "
        "(compression=4); unmicst_tpu_torch has no JPEG XR decoder (its "
        "import rule leaves out the optional 'imagecodecs' package, the "
        "reference tool's own JXR path, czifile + imagecodecs); decode it "
        "with unmicst_tpu and imagecodecs, or convert the slide"
    )
