"""Public entry for prefill attention: the model's ``[B, S, H, D]``
layout in and out, the kernel's ``[B, H, S, D]`` inside.

The head-major operands are transposed views of the model's tensors (no
copy): the CUDA kernel reads any strides over (B, heads, S) with the
head dimension contiguous.  The call runs in the profiler range
``attention.flash``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

#: tensor device type -> implementation: CUDA launches the kernel (or
#: raises), the CPU takes the plain version; nothing falls back
_BY_DEVICE = {"cuda": flash_attention, "cpu": attention_ref}


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0,
        cap: float = 0.0) -> torch.Tensor:
    """q [B,Sq,H,D]; k/v [B,Sk,KV,D] -> [B,Sq,H,D] (positions are
    indices: causal and window masks need Sk = Sq; without them the keys
    may be of any length, as for cross-attention)."""
    fn = _BY_DEVICE.get(q.device.type)
    if fn is None:
        raise ValueError(f"mha: unsupported device {q.device}")
    with torch.profiler.record_function("attention.flash"):
        out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=causal, window=window, cap=cap)
    return out.transpose(1, 2)


__all__ = ["mha"]
