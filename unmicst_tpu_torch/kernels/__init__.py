"""Hand-written Hopper kernels and their plain PyTorch versions.

* K1 :func:`softmax_blend` — ``exhibits/pallas/fused_tail.py`` on the TPU;
* K2 :func:`blend_fold` / :func:`blend_fold_epilogue` /
  :func:`blend_fold_strip` / :func:`blend_fold_stripe` —
  ``exhibits/pallas/blend.py`` on the TPU;
* K3 :func:`ring_shift`, K4a :func:`ring_shift_start`, K4b
  :func:`ring_shift_wait` — ``unmicst_tpu/kernels/halo_rdma.py`` on the TPU.

Each wrapper counts its kernel launches in a ``launches`` attribute; the
plain versions (CPU tensors) are not counted.
"""

from unmicst_tpu_torch.kernels.blend_fold import (  # noqa: F401
    blend_fold, blend_fold_epilogue, blend_fold_epilogue_plain,
    blend_fold_plain, blend_fold_strip, blend_fold_stripe, check_trim,
    fold_region_plain,
)
from unmicst_tpu_torch.kernels.halo_ring import (  # noqa: F401
    RingShiftHandle, ring_shift, ring_shift_plain, ring_shift_start,
    ring_shift_wait,
)
from unmicst_tpu_torch.kernels.softmax_blend import (  # noqa: F401
    softmax_blend, softmax_blend_plain,
)

WRAPPERS = (softmax_blend, blend_fold, blend_fold_epilogue, blend_fold_strip,
            blend_fold_stripe, ring_shift, ring_shift_start, ring_shift_wait)


def launch_counts() -> dict:
    """Launches per wrapper, and ``blend_fold_epilogue_trim``: those of
    K2's slide epilogue that wrote a trimmed window."""
    counts = {w.__name__: w.launches for w in WRAPPERS}
    counts["blend_fold_epilogue_trim"] = blend_fold_epilogue.trim_launches
    return counts


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
    blend_fold_epilogue.trim_launches = 0
