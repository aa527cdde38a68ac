"""OME-XML plane selection for OME-TIFF inputs.

The reference reads OME-TIFF channels as bare page indexes
(``tifffile.imread(imagePath, key=args.channel)``, ``UnMicst1-5.py:795-797``)
— correct for the MCMICRO registration stacks it targets (C is the only
non-XY dimension), but silently wrong for OME-TIFFs carrying Z or T stacks,
where page order is dictated by the OME ``DimensionOrder``.

Here the first page's ImageDescription is parsed (stdlib ElementTree,
namespace-agnostic); when it is well-formed OME-XML whose C*Z*T matches the
page count, ``--channel c`` selects the page of plane (C=c, Z=0, T=0).  For
SizeZ == SizeT == 1 this is exactly the reference's page index; for real
Z/T stacks it is a documented deliberate divergence (PARITY.md) — the
reference would read an arbitrary mid-stack plane.  Malformed or
inconsistent metadata falls back to page == channel.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Optional, Tuple


def parse_pixels(description: str) -> Optional[Tuple[str, dict]]:
    """OME-XML ImageDescription -> (DimensionOrder, {C/Z/T: size}) or None.

    Only the first Image's Pixels element is considered (multi-Image OME
    companions are out of scope, as they are for the reference)."""
    if not description or (
        "<OME" not in description and ":OME" not in description
    ):
        # cheap sniff; ":OME" admits namespace-prefixed roots (<ome:OME>)
        return None
    try:
        root = ET.fromstring(description)
    except ET.ParseError:
        return None
    pixels = next(
        (el for el in root.iter()
         if el.tag == "Pixels" or el.tag.endswith("}Pixels")),
        None,
    )
    if pixels is None:
        return None
    order = pixels.get("DimensionOrder", "XYCZT")
    # the OME spec's DimensionOrder enum always leads with XY; anything
    # else (malformed writer) falls back to page==channel rather than
    # crashing the stride walk below
    if sorted(order) != sorted("XYCZT") or not order.startswith("XY"):
        return None
    try:
        sizes = {d: int(pixels.get("Size" + d) or 1) for d in "CZT"}
    except ValueError:
        return None
    if any(s < 1 for s in sizes.values()):
        return None
    return order, sizes


def _consistent_pixels(description: str, n_pages: int):
    """(order, sizes) when the OME metadata matches the page chain, else
    None."""
    meta = parse_pixels(description)
    if meta is None:
        return None
    order, sizes = meta
    if sizes["C"] * sizes["Z"] * sizes["T"] != n_pages:
        return None  # metadata inconsistent with the actual page chain
    return order, sizes


def _tiffdata_map(description: str):
    """Explicit TiffData plane->IFD mappings (authoritative per the
    OME-TIFF spec when present): {(C, Z, T): IFD} or None."""
    try:
        root = ET.fromstring(description)
    except ET.ParseError:
        return None
    mapping = {}
    for el in root.iter():
        if not (el.tag == "TiffData" or el.tag.endswith("}TiffData")):
            continue
        ifd = el.get("IFD")
        if ifd is None:
            # bare <TiffData/> means "default order" — no explicit map
            continue
        try:
            key = (int(el.get("FirstC") or 0), int(el.get("FirstZ") or 0),
                   int(el.get("FirstT") or 0))
            n = int(el.get("PlaneCount") or 1)
            if n != 1:
                return None  # multi-plane runs: fall back to the order walk
            mapping[key] = int(ifd)
        except ValueError:
            return None
    return mapping or None


def plane_index(description: str, channel: int, n_pages: int) -> int:
    """IFD page index of plane (C=channel, Z=0, T=0).

    Explicit ``TiffData`` mappings win (spec: DimensionOrder only defines
    the default when TiffData is absent); otherwise the DimensionOrder
    stride walk.  Falls back to ``channel`` (the reference's
    page==channel read) when the description isn't consistent OME-XML.
    Raises IndexError when the OME metadata says the channel doesn't
    exist."""
    gated = _consistent_pixels(description, n_pages)
    if gated is None:
        return channel
    order, sizes = gated
    if not 0 <= channel < sizes["C"]:
        raise IndexError(
            f"channel {channel} not present (OME SizeC={sizes['C']})"
        )
    explicit = _tiffdata_map(description)
    if explicit is not None:
        ifd = explicit.get((channel, 0, 0))
        if ifd is not None and 0 <= ifd < n_pages:
            return ifd
        return channel  # partial/odd mapping: reference fallback
    stride = 1
    for d in order[2:]:  # post-XY dims, fastest-varying first
        if d == "C":
            break
        stride *= sizes[d]
    return channel * stride


def channel_names(description: str):
    """Ordered ``<Channel Name=...>`` list under the first Pixels, or
    None when the description isn't OME-XML or carries no Channel
    elements.  Missing Name attributes become None placeholders (Name is
    optional in the OME schema).  The reference has no name-addressed
    channel selection at all — this backs the framework's
    ``--channelName`` / ``channel_name=`` extension."""
    if not description or (
        "<OME" not in description and ":OME" not in description
    ):
        return None
    try:
        root = ET.fromstring(description)
    except ET.ParseError:
        return None
    pixels = next(
        (el for el in root.iter()
         if el.tag == "Pixels" or el.tag.endswith("}Pixels")),
        None,
    )
    if pixels is None:
        return None
    names = [
        el.get("Name")
        for el in pixels
        if el.tag == "Channel" or el.tag.endswith("}Channel")
    ]
    return names or None


def resolve_name(names, name: str) -> int:
    """Channel *name* -> its index in ``names``.

    Exact match wins; otherwise a case-folded match is accepted when it
    is unique.  Raises ValueError naming the available channels (no
    silent fallbacks — a typo must not infer the wrong marker)."""
    if name in names:
        return names.index(name)
    folded = [
        i for i, n in enumerate(names)
        if n is not None and n.casefold() == name.casefold()
    ]
    if len(folded) == 1:
        return folded[0]
    avail = ", ".join(repr(n) for n in names)
    if len(folded) > 1:
        raise ValueError(
            f"channel name {name!r} is ambiguous case-insensitively "
            f"(channels: {avail})"
        )
    raise ValueError(
        f"no channel named {name!r} (channels: {avail})"
    )
