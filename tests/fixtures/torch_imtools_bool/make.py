"""Write the fixture of the toolbox's Gaussian filters on a bool image:
scipy's results, which ``chip_smoke.py`` holds the port's on the card to
byte for byte (the card's machine has no scipy).

    python tests/fixtures/torch_imtools_bool/make.py

Needs numpy and scipy (through ``unmicst_tpu.utils.imtools``).  Writes
``bool_filters.npz`` beside this script: the seeded 32 x 32 bool image
(a block and 10% random pixels) as ``image``, and, for each call of
``CALLS``, the JAX toolbox's result under the call's name (bool results
as their stored bytes, uint8).
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

# name -> (function, positional arguments after the image, keywords)
CALLS = {
    "gauss_0.7_order02": ("imgaussfilt", (0.7,), {"order": [0, 2]}),
    "gauss_1.0_order1_cval3": ("imgaussfilt", (1.0,), {
        "order": 1, "mode": "constant", "cval": 3.0}),
    "gauss_0.5_order2": ("imgaussfilt", (0.5,), {"order": 2}),
    "gauss_1.0": ("imgaussfilt", (1.0,), {}),
    "gradmag_1.0": ("imgradmag", (1.0,), {}),
    "derivatives_0.7": ("imderivatives", ([0.7],), {}),
}


def bool_image() -> np.ndarray:
    rng = np.random.RandomState(17)
    img = np.zeros((32, 32), bool)
    img[5:17, 8:22] = True
    return img | (rng.rand(32, 32) < 0.1)


def stored(x: np.ndarray) -> np.ndarray:
    return x.view(np.uint8) if x.dtype == np.bool_ else x


def main() -> None:
    from unmicst_tpu.utils import imtools

    img = bool_image()
    out = {"image": img}
    for name, (fn, args, kwargs) in CALLS.items():
        out[name] = stored(getattr(imtools, fn)(img, *args, **kwargs))
    np.savez(os.path.join(HERE, "bool_filters.npz"), **out)


if __name__ == "__main__":
    main()
