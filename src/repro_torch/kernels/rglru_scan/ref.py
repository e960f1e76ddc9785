"""Plain PyTorch version of the RG-LRU scan kernel: the Pallas kernel's
sequential recurrence ``h = a * h + b`` in float32, each step one fused
multiply-add rounded once.  That is what the Pallas kernel computes
(XLA contracts its ``a * h + b`` into an FMA; interpret mode on the CPU
shows it bitwise) and what the CUDA kernel's ``__fmaf_rn`` computes, so
all three agree bitwise.  The reference's ``rglru_ref`` takes an
associative scan instead: the same recurrence summed in another order.
"""
from __future__ import annotations

from typing import Tuple

import torch


def fma_f32(a: torch.Tensor, h: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """``a * h + b`` for float32 tensors, rounded once to float32 (an
    exact FMA): the float64 product of two float32 values is exact, the
    float64 sum's rounding error comes out of TwoSum, and rounding the sum
    to odd before the cast to float32 removes double rounding."""
    p = a.to(torch.float64) * h.to(torch.float64)
    b64 = b.to(torch.float64)
    s = p + b64
    bv = s - p
    err = (p - (s - bv)) + (b64 - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def rglru_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: [B, T, W]; h0: [B, W] -> (h [B, T, W] in ``a.dtype``,
    hT [B, W] in ``h0.dtype``)."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    h = h0.to(torch.float32)
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    for t in range(a.shape[1]):
        h = fma_f32(a32[:, t], h, b32[:, t])
        out[:, t] = h.to(a.dtype)
    return out, h.to(h0.dtype)


__all__ = ["fma_f32", "rglru_ref"]
