"""The model zoo registry: the seven shipped model directories
(``unmicst_tpu/models/zoo.py``, SURVEY section 2.4) and which of them a
model root can load.

Two checkpoints come from S3 at the reference's Docker build
(``Dockerfile:4-5``); the rest ship in the reference checkout, some with
their data blob missing upstream.  Downloading them (``fetch_model``,
``stage_sidecars`` in the JAX package) is not part of this package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from unmicst_tpu_torch.core.checkpoint import NATIVE_FILE, _find_ckpt_prefix

S3_BASE = "https://mcmicro.s3.amazonaws.com/models"


@dataclasses.dataclass(frozen=True)
class ZooEntry:
    name: str
    tool: str  # the CLI tool that defaults to or uses it
    variant: str  # architecture generation
    im_size: int
    n_classes: int
    n_channels: int
    ckpt_url: Optional[str] = None  # the S3 blob when not shipped
    notes: str = ""


ZOO = {
    "nucleiDAPI": ZooEntry(
        "nucleiDAPI", "unmicst-legacy", "legacy", 128, 3, 1,
        notes="default legacy model; checkpoint ships in-repo",
    ),
    "nucleiDAPI1-5": ZooEntry(
        "nucleiDAPI1-5", "unmicst-solo", "v2", 64, 3, 1,
        # the S3 key is "unmicst1-5", not the model-dir name (Dockerfile:5)
        ckpt_url=f"{S3_BASE}/unmicst1-5/model.ckpt.data-00000-of-00001",
        notes="default solo model; blob fetched from S3 (Dockerfile:5)",
    ),
    "nucleiDAPILAMIN": ZooEntry(
        "nucleiDAPILAMIN", "unmicst-duo", "v2", 128, 3, 2,
        # the S3 key is "unmicst2", not the model-dir name (Dockerfile:4)
        ckpt_url=f"{S3_BASE}/unmicst2/model.ckpt.data-00000-of-00001",
        notes="default duo model; blob fetched from S3 (Dockerfile:4)",
    ),
    "CytoplasmIncell2": ZooEntry(
        "CytoplasmIncell2", "UnMicstCyto2", "v2", 256, 2, 1,
        notes="data blob missing upstream (.MISSING_LARGE_BLOBS)",
    ),
    "CytoplasmIncell": ZooEntry(
        "CytoplasmIncell", "UnMicstCyto2", "legacy", 128, 2, 1,
        notes="checkpoint ships in-repo",
    ),
    "CytoplasmZeissNikon": ZooEntry(
        "CytoplasmZeissNikon", "UnMicstCyto2", "legacy", 256, 2, 1,
        notes="data blob missing upstream",
    ),
    "mousenucleiDAPI": ZooEntry(
        "mousenucleiDAPI", "unmicst-legacy", "legacy", 256, 3, 1,
        notes="model.ckpt data missing upstream; alternate bundle "
        "nuclei20x2bin1chan is auto-discovered by the loader",
    ),
}

def _ready(d: str) -> bool:
    """A restorable TF1 bundle or the native msgpack file."""
    return bool(_find_ckpt_prefix(d)) or os.path.exists(
        os.path.join(d, NATIVE_FILE))


def available_models(model_root: str) -> dict:
    """Zoo entry -> 'ready', 'absent' or 'needs-blob (<url>)' under
    ``model_root``, plus the model dirs outside the registry that carry an
    ``hp.data`` ('ready (local)' or 'needs-blob')."""
    out = {}
    for name, entry in ZOO.items():
        d = os.path.join(model_root, name)
        if not os.path.isdir(d):
            out[name] = "absent"
        else:
            out[name] = "ready" if _ready(d) else "needs-blob" + (
                f" ({entry.ckpt_url})" if entry.ckpt_url else "")
    # locally trained model dirs
    if os.path.isdir(model_root):
        for name in sorted(os.listdir(model_root)):
            d = os.path.join(model_root, name)
            if name not in ZOO and os.path.isdir(d) and os.path.exists(
                    os.path.join(d, "hp.data")):
                out[name] = "ready (local)" if _ready(d) else "needs-blob"
    return out
