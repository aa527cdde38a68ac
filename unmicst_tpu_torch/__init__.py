"""unmicst_tpu_torch — the PyTorch/CUDA port of unmicst_tpu for NVIDIA GPUs.

UnMICST probability maps from a slide (one channel, or the duo tool's
two) at any ``--scalingFactor``: the TIFF reader, the residual UNet (both
generations), tiled inference with hand-written CUDA kernels
(``kernels/``: K1 softmax x blend window, K2 gather overlap-add with the
uint8 epilogue, K3/K4 the ring halo hops), the streaming engine, the
CLI's output contract and its host float path, the batch sweep
(``python -m unmicst_tpu_torch.batch``), and training (``train.py``, with
the native msgpack checkpoint through ``core/msgpack.py``).  It imports
PyTorch, numpy and the standard library only.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; with no GPU and no device named they raise.
"""

from unmicst_tpu_torch.core.hp import HParams, ModelBundle, load_model_dir  # noqa: F401
