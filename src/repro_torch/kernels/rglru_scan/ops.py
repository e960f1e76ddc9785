"""Public entry for the RG-LRU's prefill recurrence, in the profiler range
``rglru.scan``."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.rglru_scan.ref import rglru_ref
from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan

#: tensor device type -> implementation: CUDA launches the kernel (or
#: raises), the CPU takes the plain version; nothing falls back
_BY_DEVICE = {"cuda": rglru_scan, "cpu": rglru_ref}


def linear_recurrence(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + b_t over [B, T, W]; returns (h, h_T)."""
    fn = _BY_DEVICE.get(a.device.type)
    if fn is None:
        raise ValueError(f"linear_recurrence: unsupported device {a.device}")
    with torch.profiler.record_function("rglru.scan"):
        return fn(a, b, h0)


__all__ = ["linear_recurrence"]
