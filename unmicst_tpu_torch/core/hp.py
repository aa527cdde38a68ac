"""Hyper-parameter schema and model-directory loading.

The reference stores per-model hyper-parameters as a pickled dict ``hp.data``
with keys ``imSize, nClasses, nChannels, nExtraConvs, nLayers, featMapsFact,
downSampFact, ks, nOut0, stdDev0, batchSize`` (reference ``UnMicst.py:53-63``),
plus pickled scalar sidecars ``datasetMean.data`` / ``datasetStDev.data``
written by ``toolbox/ftools.py:32-40``.  We keep that on-disk schema verbatim
for drop-in model-zoo compatibility and expose it as a typed dataclass.

Two architecture generations exist (see ``core/unet.py``):

* ``legacy`` — ``UnMicst.py`` and the ``batch*.py`` scripts
* ``v2``     — ``UnMicst1-5.py`` / ``UnMicst2.py`` / ``UnMicstCyto2.py``
  (identical inference graphs; they differ only in training-time dropout
  rates and kernel regularizers, see ``core/unet.py:VariantConfig``)
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import re
from typing import Optional

# Reference hp.data key order (UnMicst.py:38-49 setupWithHP).
_REF_KEYS = {
    "imSize": "im_size",
    "nChannels": "n_channels",
    "nClasses": "n_classes",
    "nOut0": "n_out0",
    "featMapsFact": "feat_maps_fact",
    "downSampFact": "down_samp_fact",
    "ks": "ks",
    "nExtraConvs": "n_extra_convs",
    "stdDev0": "std_dev0",
    "nLayers": "n_layers",
    "batchSize": "batch_size",
}


@dataclasses.dataclass(frozen=True)
class HParams:
    """UNet2D hyper-parameters (schema parity: ``UnMicst.py:53-63``)."""

    im_size: int
    n_channels: int
    n_classes: int
    n_out0: int
    feat_maps_fact: int = 2
    down_samp_fact: int = 2
    ks: int = 3
    n_extra_convs: int = 0
    std_dev0: float = 0.03
    n_layers: int = 3
    batch_size: int = 16

    @property
    def n_out_x(self) -> list[int]:
        """Channel-width schedule ``nOutX`` (``UnMicst.py:65-69``).

        ``[nChannels, nOut0, nOut0*f, nOut0*f^2, ...]`` with
        ``len == n_layers + 2``.
        """
        widths = [self.n_channels, self.n_out0]
        for _ in range(self.n_layers):
            widths.append(widths[-1] * self.feat_maps_fact)
        return widths

    @property
    def margin(self) -> int:
        """Inference tile margin: ``imSize // 8`` (``UnMicst.py:527``)."""
        return self.im_size // 8

    @classmethod
    def from_ref_dict(cls, d: dict) -> "HParams":
        kwargs = {ours: d[ref] for ref, ours in _REF_KEYS.items() if ref in d}
        return cls(**kwargs)


def load_pickle(path: str):
    """Read a reference sidecar pickle (``toolbox/ftools.py:37-40``)."""
    with open(path, "rb") as f:
        return pickle.load(f)


# Model-zoo variant registry: which architecture generation each shipped model
# directory uses.  Derived from which script defaults to it:
#   nucleiDAPI       -> UnMicst.py:547  (legacy)
#   mousenucleiDAPI  -> legacy mouse model (SURVEY #2.4)
#   CytoplasmIncell  / CytoplasmZeissNikon -> legacy-era cytoplasm models
#   nucleiDAPI1-5    -> UnMicst1-5.py:716 (v2)
#   nucleiDAPILAMIN  -> UnMicst2.py:695  (v2)
#   CytoplasmIncell2 -> UnMicstCyto2.py  (v2)
ZOO_VARIANTS = {
    "nucleiDAPI": "legacy",
    "mousenucleiDAPI": "legacy",
    "CytoplasmIncell": "legacy",
    "CytoplasmZeissNikon": "legacy",
    "nucleiDAPI1-5": "v2",
    "nucleiDAPILAMIN": "v2",
    "CytoplasmIncell2": "v2",
}


@dataclasses.dataclass
class ModelBundle:
    """A loaded model directory: hp + normalization sidecars + ckpt location."""

    hp: HParams
    mean: float
    std: float
    model_dir: str
    variant: str  # 'legacy' | 'v2'


def _sniff_variant(model_dir: str) -> Optional[str]:
    """Infer the architecture generation from the checkpoints present.

    Native msgpack bundles embed their variant in the ``meta_json`` header
    (serialized first — a 64 KB head read suffices).  TF1 checkpoints are
    distinguished by variable names: legacy contains
    ``downsampling/ld0/kernel1``, v2 ``downsampling/ld0/kernelD0``
    (SURVEY #2.5).  Reads only headers/index, cheaply.
    """
    native_path = os.path.join(model_dir, "model.unmicst-tpu.msgpack")
    if os.path.exists(native_path):
        try:
            with open(native_path, "rb") as f:
                head = f.read(65536)
            m = re.search(rb'\\?"variant\\?":\s*\\?"(\w+)\\?"', head)
            if m:
                return m.group(1).decode("ascii")
        except OSError:
            pass
    index_path = os.path.join(model_dir, "model.ckpt.index")
    if not os.path.exists(index_path):
        return None
    try:
        with open(index_path, "rb") as f:
            blob = f.read()
        if b"kernelD0" in blob:
            return "v2"
        if b"ld0/kernel1" in blob or b"downsampling/ld0" in blob:
            return "legacy"
    except OSError:
        return None
    return None


def load_model_dir(
    model_dir: str,
    mean: float = -1,
    std: float = -1,
    variant: Optional[str] = None,
) -> ModelBundle:
    """Load hp + mean/std sidecars from a reference-format model directory.

    ``mean``/``std`` of ``-1`` mean "use the model sidecars", matching the
    CLI contract (``UnMicst.py:494-502``).
    """
    hp = HParams.from_ref_dict(load_pickle(os.path.join(model_dir, "hp.data")))
    if mean == -1:
        mean = float(load_pickle(os.path.join(model_dir, "datasetMean.data")))
    if std == -1:
        std = float(load_pickle(os.path.join(model_dir, "datasetStDev.data")))
    if variant is None:
        name = os.path.basename(os.path.normpath(model_dir))
        variant = ZOO_VARIANTS.get(name) or _sniff_variant(model_dir) or "v2"
    return ModelBundle(hp=hp, mean=mean, std=std, model_dir=model_dir, variant=variant)
