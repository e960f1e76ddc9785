"""Plain PyTorch version of the RG-LRU scan kernel: the Pallas kernel's
sequential recurrence ``h = a * h + b`` in float32, each step one fused
multiply-add rounded once.  That is what the Pallas kernel computes
(XLA contracts its ``a * h + b`` into an FMA; interpret mode on the CPU
shows it bitwise) and what the CUDA kernel's ``__fmaf_rn`` computes, so
all three agree bitwise.  The reference's ``rglru_ref`` takes an
associative scan instead: the same recurrence summed in another order.

``rglru_bwd_ref`` is the plain version of the backward kernel: the
adjoint recurrence run backwards in time, each step one FMA rounded once
(``fma_f32``), in the CUDA kernel's order, so the two agree bitwise.
The forward's float64 steps are not differentiable, so the CPU training
path takes this backward too, not autograd of ``rglru_ref``.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def rglru_bwd_ref(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                  dh: torch.Tensor, dhT: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``h_t = a_t h_{t-1} + b_t``: a, h (the forward's
    output), dh [B, T, W]; h0, dhT (None: zeros) [B, W] -> (da, db in
    ``a.dtype``, dh0 in ``h0.dtype``).  In float32, for t = T-1 .. 0:
    lambda_{T-1} = dh[T-1] + dhT, lambda_t = fma(a[t+1], lambda_{t+1},
    dh[t]); db[t] = lambda_t, da[t] = lambda_t h[t-1] (h[-1] = h0);
    dh0 = a[0] lambda_0 (dhT when T = 0)."""
    a32, h32, dh32 = (t.to(torch.float32) for t in (a, h, dh))
    lam = torch.zeros(h0.shape, dtype=torch.float32, device=h0.device) \
        if dhT is None else dhT.to(torch.float32)
    da = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    db = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    steps = a.shape[1]
    for t in range(steps - 1, -1, -1):
        lam = dh32[:, t] + lam if t == steps - 1 else \
            fma_f32(a32[:, t + 1], lam, dh32[:, t])
        db[:, t] = lam.to(a.dtype)
        prev = h32[:, t - 1] if t > 0 else h0.to(torch.float32)
        da[:, t] = (lam * prev).to(a.dtype)
    dh0 = a32[:, 0] * lam if steps else lam
    return da, db, dh0.to(h0.dtype)


__all__ = ["fma_f32", "rglru_bwd_ref", "rglru_ref"]
