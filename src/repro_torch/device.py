"""Device resolution for the port's entry points.

``None`` means the card.  There is no silent fallback: asking for CUDA on
a machine without it raises, and the CPU runs only when named.
"""
from __future__ import annotations

import functools
from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (the kernels' wrappers
    size their grids by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


__all__ = ["resolve_device", "sm_count", "DeviceLike"]
