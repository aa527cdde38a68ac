"""K1: softmax over classes x blend window x phantom-tile mask.

The port of the TPU kernel ``exhibits/pallas/fused_tail.py:44``
(``softmax_blend_weights``, ``_tail_kernel`` at ``:34``):
``[T, K, P, P]`` logits, a ``[P, P]`` window and a ``[T]`` mask ->
``softmax(logits, K) * (window * mask)``, float32.  CUDA source:
``unmicst_tpu_torch/csrc/softmax_blend.cu``.

:func:`softmax_blend` launches the kernel for CUDA tensors (or raises)
and takes :func:`softmax_blend_plain` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from unmicst_tpu_torch.kernels import _build

MAX_CLASSES = 3  # the models have 2 or 3 classes
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {"softmax_blend_f32": [_P, _P, _P, _P, _LL, _I, _I, _P]}


def softmax_blend_plain(logits: torch.Tensor, window: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, in the kernel's order:
    ``e = exp(x - max); p = e / sum(e); p * (window * mask)``."""
    e = torch.exp(logits - logits.amax(dim=1, keepdim=True))
    p = e / e.sum(dim=1, keepdim=True)
    return p * (window[None] * mask[:, None, None])[:, None]


def _check(logits, window, mask, out) -> None:
    if logits.dim() != 4 or logits.shape[2] != logits.shape[3]:
        raise ValueError(f"logits must be [T, K, P, P], got {tuple(logits.shape)}")
    t, k, p, _ = logits.shape
    if not 1 <= k <= MAX_CLASSES:
        raise ValueError(f"K1 takes 1..{MAX_CLASSES} classes, got {k}")
    if (p * p) % 4:
        raise ValueError(f"K1 reads four pixels at a time: P*P = {p * p} "
                         "is not a multiple of 4")
    want = {"window": (window, (p, p)), "mask": (mask, (t,))}
    if out is not None:
        want["out"] = (out, tuple(logits.shape))
    for name, (x, shape) in {"logits": (logits, tuple(logits.shape)),
                             **want}.items():
        if x.device != logits.device:
            raise ValueError(f"{name} on {x.device}, logits on {logits.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "mask" and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def softmax_blend(logits: torch.Tensor, window: torch.Tensor,
                  mask: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[T, K, P, P] x [P, P] x [T] -> [T, K, P, P]`` float32.

    ``out``: optional contiguous destination (e.g. a slice of a larger
    buffer).  CUDA tensors run the kernel; CPU tensors the plain version.
    """
    _check(logits, window, mask, out)
    if not logits.is_cuda:
        res = softmax_blend_plain(logits, window, mask)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(logits)
    t, k, p, _ = logits.shape
    lib = _build.load("softmax_blend", _SIGNATURES)
    with torch.cuda.device(logits.device):
        rc = lib.softmax_blend_f32(
            logits.data_ptr(), window.data_ptr(), mask.data_ptr(),
            out.data_ptr(), t, k, p,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc:
        raise RuntimeError(f"softmax_blend launch failed: cudaError {rc}")
    softmax_blend.launches += 1
    return out


softmax_blend.launches = 0
