"""CUDA device selection — the ``toolbox/GPUselect.py`` analogue.

The reference picks the GPU with the most free memory (``GPUselect.py:
4-22``, ``UnMicst.py:577-595``).  Here ``--GPU N`` selects ``cuda:N`` and
``-1`` picks the card with the most free memory.  The port runs on the
card: the CPU is used only when a caller names it, and a request for CUDA
on a machine without one raises instead of falling back.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

Device = Union[str, torch.device, None]


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: unmicst_tpu_torch runs on an NVIDIA "
            "GPU; pass device='cpu' explicitly to run on the CPU"
        )


def pick_device_most_free_memory() -> torch.device:
    _require_cuda()
    free = [torch.cuda.mem_get_info(i)[0]
            for i in range(torch.cuda.device_count())]
    return torch.device("cuda", max(range(len(free)), key=free.__getitem__))


def select_device(index: int = -1) -> torch.device:
    """``--GPU`` semantics: explicit CUDA index, or auto-pick with -1."""
    _require_cuda()
    if index < 0:
        return pick_device_most_free_memory()
    n = torch.cuda.device_count()
    if index >= n:
        raise ValueError(f"GPU {index} requested; {n} available")
    return torch.device("cuda", index)


def resolve_device(device: Device = None) -> torch.device:
    """The device an entry point runs on: ``None`` and ``"cuda"`` mean the
    card (raising when there is none); ``"cpu"`` only when asked for."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        _require_cuda()
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def describe(device: Optional[torch.device] = None) -> str:
    device = torch.device(device or "cuda")
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)
